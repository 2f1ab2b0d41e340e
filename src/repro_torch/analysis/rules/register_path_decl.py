"""Rule ``register-path-decl``: registration sites declare their ladder.

Port of ``repro.analysis.rules.register_path_decl``.  Every path
registration — a ``@register_path(...)`` decorator or a
``paths.register(paths.PathSpec(...))`` call under ``src/repro_torch/``
(the ``prefix`` option) — must state ``complexity`` (the aggregation
class the roofline and codesign reason about) and ``fallback`` (the
degradation rung, ``None`` explicitly for a terminal path) AT THE CALL
SITE, instead of inheriting the dataclass defaults unconsidered.
"""

from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.config import AnalysisConfig
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.lint import LintContext

SRC_PREFIX = "src/repro_torch/"
REQUIRED_KEYWORDS = ("complexity", "fallback")


def _call_name(node: ast.Call) -> str:
    fn = node.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return ""


def _registration_sites(tree: ast.AST):
    """Yield (kind, call) for every path-registration call site:
    ``register_path(...)`` and the ``PathSpec(...)`` argument of a
    ``register(...)`` call (bare PathSpec constructions elsewhere are
    not registrations and stay out of scope)."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node)
        if name == "register_path":
            yield "@register_path", node
        elif name == "register":
            for arg in node.args:
                if isinstance(arg, ast.Call) and _call_name(arg) == "PathSpec":
                    yield "register(PathSpec)", arg


class RegisterPathDeclRule:
    name = "register-path-decl"
    description = ("every path registration site declares complexity and "
                   "fallback explicitly")

    def check(self, ctx: LintContext,
              config: AnalysisConfig) -> Iterable[Finding]:
        prefix = config.options.get(self.name, {}).get("prefix", SRC_PREFIX)
        for rel in ctx.python_files(prefix):
            tree, err = ctx.try_tree(rel)
            if err is not None:
                yield err
                continue
            for kind, call in _registration_sites(tree):
                if any(kw.arg is None for kw in call.keywords):
                    # **fields forwarding (register_path's own body): the
                    # declaration is checked at the decorator call site
                    continue
                given = {kw.arg for kw in call.keywords if kw.arg}
                missing = [k for k in REQUIRED_KEYWORDS if k not in given]
                if missing:
                    yield Finding(
                        self.name, rel, call.lineno,
                        f"{kind} site omits {', '.join(missing)} — declare "
                        "the aggregation class and the degradation rung "
                        "(fallback=None for a terminal path) at the call "
                        "site instead of inheriting dataclass defaults")
