"""Rule ``thin-cli``: launch CLIs stay thin shells over the serving package.

Port of ``repro.analysis.rules.thin_cli``.  A thin CLI module may
contain ONLY: a docstring, imports, simple constant assignments, a
``main`` function, and the ``if __name__ == "__main__"`` block; ``main``
itself may only build an argparse parser and delegate into
``repro_torch.serving`` — no loops, branches, nested defs, or numerics
imports.  Logic that needs any of those belongs behind the serving
package where the event loop and the tests can reuse it.

Options (``[rules.thin-cli]``): ``paths`` (the CLI modules),
``forbidden`` (import roots a shell may not touch) and
``allowed_prefix`` (the one package of the framework it may reach).
"""

from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.config import AnalysisConfig
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.lint import LintContext

THIN_CLIS = ("src/repro_torch/launch/trigger_serve.py",
             "src/repro_torch/launch/serve.py")

# engine/batching logic needs numerics; a thin shell must not
FORBIDDEN_IMPORTS = ("torch", "numpy", "jax")
# the only package of the framework a thin CLI may reach into (stdlib is
# free)
ALLOWED_PREFIX = "repro_torch.serving"


def _imported_modules(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, node.lineno
        elif isinstance(node, ast.ImportFrom):
            yield node.module or "", node.lineno


class ThinCliRule:
    name = "thin-cli"
    description = ("launch CLIs hold only imports, constants, main() and "
                   "the __main__ guard, importing repro_torch.serving alone")

    def check(self, ctx: LintContext,
              config: AnalysisConfig) -> Iterable[Finding]:
        opts = config.options.get(self.name, {})
        clis = tuple(opts.get("paths", THIN_CLIS))
        forbidden = tuple(opts.get("forbidden", FORBIDDEN_IMPORTS))
        allowed = opts.get("allowed_prefix", ALLOWED_PREFIX)
        for rel in clis:
            if not (ctx.root / rel).is_file():
                yield Finding(self.name, rel, 0,
                              "declared thin CLI module is missing")
                continue
            tree, err = ctx.try_tree(rel)
            if err is not None:
                yield err
                continue
            yield from self._check_top_level(rel, tree, allowed)
            yield from self._check_main(rel, tree, allowed)
            yield from self._check_imports(rel, tree, forbidden, allowed)

    def _check_top_level(self, rel, tree, allowed):
        main_defs = 0
        has_guard = False
        for i, node in enumerate(tree.body):
            if i == 0 and isinstance(node, ast.Expr):
                continue                    # module docstring
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                continue
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue                    # simple module constants
            if isinstance(node, ast.FunctionDef):
                if node.name == "main":
                    main_defs += 1
                    continue
                yield Finding(
                    self.name, rel, node.lineno,
                    f"top-level def {node.name}() — thin CLIs define only "
                    f"main(); move logic into {allowed}")
                continue
            if isinstance(node, ast.If):    # if __name__ == "__main__": main()
                cond = ast.unparse(node.test)
                if "__name__" in cond:
                    has_guard = True
                    continue
                yield Finding(
                    self.name, rel, node.lineno,
                    f"top-level `if {cond}` — only the __main__ guard is "
                    "allowed")
                continue
            yield Finding(
                self.name, rel, node.lineno,
                f"top-level {type(node).__name__} — thin CLI modules hold "
                "only imports, constants, main() and the __main__ guard; "
                f"move logic into {allowed}")
        if main_defs != 1:
            yield Finding(
                self.name, rel, 0,
                f"expected exactly one main() definition, found {main_defs}")
        if not has_guard:
            yield Finding(
                self.name, rel, 0,
                'missing the `if __name__ == "__main__"` guard — the shell '
                "must stay runnable")

    def _check_main(self, rel, tree, allowed):
        main = next((n for n in tree.body
                     if isinstance(n, ast.FunctionDef) and n.name == "main"),
                    None)
        if main is None:
            return
        for node in ast.walk(main):
            if node is main:
                continue
            if isinstance(node, (ast.For, ast.While, ast.FunctionDef,
                                 ast.AsyncFunctionDef, ast.ClassDef,
                                 ast.Try, ast.With)):
                yield Finding(
                    self.name, rel, node.lineno,
                    f"{type(node).__name__} inside main() — batching/serving "
                    f"logic belongs in {allowed}")
            elif isinstance(node, ast.If):
                yield Finding(
                    self.name, rel, node.lineno,
                    f"branch inside main() — routing decisions belong in "
                    f"{allowed}")

    def _check_imports(self, rel, tree, forbidden, allowed):
        package = allowed.split(".")[0]
        for mod, lineno in _imported_modules(tree):
            root = mod.split(".")[0]
            if root in forbidden:
                yield Finding(
                    self.name, rel, lineno,
                    f"imports {mod!r} — a thin CLI has no numerics")
            elif root == package and not (
                    mod == allowed or mod.startswith(allowed + ".")):
                yield Finding(
                    self.name, rel, lineno,
                    f"imports {mod!r} — thin CLIs reach the framework only "
                    f"through {allowed}")
