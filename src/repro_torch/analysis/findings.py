"""The one currency of the static-analysis subsystem: a Finding.

Port of ``repro.analysis.findings``.  Both engines — the AST lint
framework (:mod:`repro_torch.analysis.lint`) and the kernel-contract
auditor (:mod:`repro_torch.analysis.kernel_audit`) — report through this
type, so the CLI and the tests consume one shape regardless of which
engine spoke.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Finding:
    """One violated invariant.

    ``rule``     — stable rule/check identifier (kebab-case), the key the
                   ``analysis.toml`` allowlist and ``--rules`` filter use.
    ``location`` — repo-relative file path for lint findings; a
                   ``path=... bucket=...`` coordinate for audit findings.
    ``line``     — 1-based source line when known, 0 otherwise.
    ``message``  — actionable: states the invariant, the observed value,
                   and what to change.
    """

    rule: str
    location: str
    line: int
    message: str

    def as_dict(self) -> dict:
        return {"rule": self.rule, "location": self.location,
                "line": self.line, "message": self.message}

    def render(self) -> str:
        where = f"{self.location}:{self.line}" if self.line else self.location
        return f"[{self.rule}] {where}: {self.message}"
