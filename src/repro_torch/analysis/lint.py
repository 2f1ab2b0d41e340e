"""AST lint engine: pluggable rules over the repo's tracked sources.

Port of ``repro.analysis.lint``.  One ``LintContext`` walks the tree
once (sources and parsed ASTs are cached per run); each :class:`Rule`
inspects what it cares about and yields
:class:`~repro_torch.analysis.findings.Finding`s.  The per-rule
allowlist from ``analysis.toml`` is applied HERE, after the rule speaks
— rules stay exception-free, the config is the one audited place where
sanctioned violations live.

Adding a rule: write a module under ``analysis/rules/`` exposing a
class with ``name``, ``description`` and ``check(ctx, config)``, then
list it in ``rules/__init__.ALL_RULES``.
"""

from __future__ import annotations

import ast
import os
import subprocess
from pathlib import Path
from typing import Iterable, Protocol

from repro_torch.analysis.config import AnalysisConfig
from repro_torch.analysis.findings import Finding

_SKIP_DIRS = {".git", "__pycache__", ".ruff_cache", ".pytest_cache",
              "node_modules", ".venv", "venv"}


class Rule(Protocol):
    """The lint-rule protocol (structural — no base class to inherit)."""

    name: str
    description: str

    def check(self, ctx: "LintContext",
              config: AnalysisConfig) -> Iterable[Finding]: ...


class LintContext:
    """One repo snapshot shared by every rule in a run."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self._files: list[str] | None = None
        self._sources: dict[str, str] = {}
        self._trees: dict[str, ast.AST] = {}

    def files(self) -> list[str]:
        """Repo-relative tracked files (git index; os.walk fallback so
        the engine still runs on an export without .git)."""
        if self._files is None:
            self._files = self._git_files() or self._walk_files()
        return self._files

    def _git_files(self) -> list[str]:
        try:
            out = subprocess.run(
                ["git", "ls-files"], cwd=self.root, capture_output=True,
                text=True, timeout=30)
        except (OSError, subprocess.TimeoutExpired):
            return []
        if out.returncode != 0:
            return []
        return [f for f in out.stdout.splitlines()
                if f and (self.root / f).is_file()]

    def _walk_files(self) -> list[str]:
        found = []
        for dirpath, dirnames, filenames in os.walk(self.root):
            dirnames[:] = [d for d in dirnames if d not in _SKIP_DIRS]
            for fn in filenames:
                rel = os.path.relpath(os.path.join(dirpath, fn), self.root)
                found.append(rel.replace(os.sep, "/"))
        return sorted(found)

    def python_files(self, prefix: str = "") -> list[str]:
        return [f for f in self.files()
                if f.endswith(".py") and f.startswith(prefix)]

    def source(self, rel: str) -> str:
        if rel not in self._sources:
            self._sources[rel] = (self.root / rel).read_text(
                encoding="utf-8", errors="replace")
        return self._sources[rel]

    def tree(self, rel: str) -> ast.AST:
        """Parsed AST, cached; syntax errors surface as a finding via
        :meth:`try_tree` rather than crashing the whole pass."""
        if rel not in self._trees:
            self._trees[rel] = ast.parse(self.source(rel), filename=rel)
        return self._trees[rel]

    def try_tree(self, rel: str):
        try:
            return self.tree(rel), None
        except SyntaxError as exc:
            return None, Finding(
                rule="syntax", location=rel, line=exc.lineno or 0,
                message=f"file does not parse: {exc.msg}")


def run_lint(root: Path, rules: Iterable[Rule],
             config: AnalysisConfig | None = None) -> list[Finding]:
    """Run ``rules`` over the repo at ``root``; allowlisted findings are
    dropped here so every rule reports unconditionally.  ``config``
    defaults to the port's ``analysis.toml``."""
    if config is None:
        config = AnalysisConfig.load()
    ctx = LintContext(root)
    findings: list[Finding] = []
    for rule in rules:
        for f in rule.check(ctx, config):
            if not config.allowed(f.rule, f.location):
                findings.append(f)
    findings.sort(key=lambda f: (f.location, f.line, f.rule))
    return findings
