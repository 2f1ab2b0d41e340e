"""Rule ``retired-names``: retired forward-path surfaces stay dead.

Port of ``repro.analysis.rules.retired_names``.  The pre-registry
surfaces (the flat forward-fn mapping on ``interaction_net`` and the lazy
path-name snapshots on the serving package) must not creep back in via
copy-paste from old branches: the registry (``repro_torch.core.paths``)
is the one forward-path API.  The sanctioned mentions (PR history, the
issue text, the ruff ban list and the rules that encode the guard) live
in ``analysis.toml`` under ``[rules.retired-names] allow``.
"""

from __future__ import annotations

import re
from typing import Iterable

from repro_torch.analysis.config import AnalysisConfig
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.lint import LintContext

# Built by concatenation so this module does not match its own guard.
RETIRED_NAMES = ("FORWARD" + "_FNS", "PALLAS" + "_PATHS")


class RetiredNamesRule:
    name = "retired-names"
    description = ("no tracked text file mentions the retired pre-registry "
                   "forward-path surface names")

    def check(self, ctx: LintContext,
              config: AnalysisConfig) -> Iterable[Finding]:
        names = tuple(config.options.get(self.name, {}).get(
            "names", RETIRED_NAMES))
        pattern = re.compile("|".join(map(re.escape, names)))
        for rel in ctx.files():
            try:
                text = ctx.source(rel)
            except (OSError, UnicodeDecodeError):
                continue
            for i, line in enumerate(text.splitlines(), 1):
                if pattern.search(line):
                    yield Finding(
                        self.name, rel, i,
                        "retired forward-path surface name resurfaced "
                        "(use the repro_torch.core.paths registry instead): "
                        f"{line.strip()!r}")
