"""Rule ``wall-clock``: serving code reads time only through clock seams.

Port of ``repro.analysis.rules.wall_clock``.  The fault-injection
harness and the deadline batcher tests depend on every latency decision
being driven through an injectable clock (``clock=time.monotonic``
default arguments, ``self._clock`` fields).  A direct ``time.time()`` /
``time.perf_counter()`` CALL buried in a serving module is untestable
wall-clock coupling — the harness can't freeze it.

Bare ATTRIBUTE references (``clock=time.monotonic`` as a default) are
exactly the seam pattern and stay legal; only call sites are findings.
The modules that OWN the seam are sanctioned in ``analysis.toml`` under
``[rules.wall-clock] allow``; the ``prefix`` option moves the scope.
"""

from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.config import AnalysisConfig
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.lint import LintContext

SERVING_PREFIX = "src/repro_torch/serving/"

CLOCK_NAMES = ("time", "monotonic", "perf_counter", "monotonic_ns",
               "perf_counter_ns", "process_time")


def _clock_calls(tree: ast.AST):
    """Yield (lineno, rendered) for direct wall-clock call sites: both
    ``time.X()`` attribute calls and bare ``X()`` calls on names
    imported via ``from time import X``."""
    from_time: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == "time":
            for a in node.names:
                if a.name in CLOCK_NAMES:
                    from_time.add(a.asname or a.name)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if (isinstance(fn, ast.Attribute) and fn.attr in CLOCK_NAMES
                and isinstance(fn.value, ast.Name) and fn.value.id == "time"):
            yield node.lineno, f"time.{fn.attr}()"
        elif isinstance(fn, ast.Name) and fn.id in from_time:
            yield node.lineno, f"{fn.id}()"


class WallClockRule:
    name = "wall-clock"
    description = ("no direct wall-clock calls in serving/ outside the "
                   "sanctioned clock-seam owners")

    def check(self, ctx: LintContext,
              config: AnalysisConfig) -> Iterable[Finding]:
        prefix = config.options.get(self.name, {}).get(
            "prefix", SERVING_PREFIX)
        for rel in ctx.python_files(prefix):
            tree, err = ctx.try_tree(rel)
            if err is not None:
                yield err
                continue
            for lineno, rendered in _clock_calls(tree):
                yield Finding(
                    self.name, rel, lineno,
                    f"direct {rendered} in serving code — read time through "
                    "the injectable clock seam (clock=time.monotonic "
                    "default / self._clock) so the fault harness can freeze "
                    "it, or sanction this module in analysis.toml")
