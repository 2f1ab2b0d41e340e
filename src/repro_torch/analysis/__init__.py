"""Static-analysis subsystem of the port: lint rules + kernel-contract auditor.

Port of ``repro.analysis``.  Two engines, one finding type, one CLI
(``python -m repro_torch.analysis``):

* :mod:`repro_torch.analysis.lint` — AST rules over the tracked tree
  (thin-CLI shape, retired names, kernel containment, wall-clock seams,
  registration-site declarations); needs no device;
* :mod:`repro_torch.analysis.kernel_audit` — holds every registered
  kernel path at each bucket of its ladder against the plan its wrapper
  launches and, on the card, the build's registers, shared memory,
  spills, SASS and launch counts.

Per-rule allowlists live in this package's ``analysis.toml``.
"""

from repro_torch.analysis.config import AnalysisConfig
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.lint import LintContext, run_lint

__all__ = ["AnalysisConfig", "Finding", "LintContext", "run_lint"]
