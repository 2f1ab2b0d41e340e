"""Rule ``kernel-containment``: hand-written kernels live only in kernels/.

The port's counterpart of ``pallas-containment``.  Every CUDA source
sits under ``src/repro_torch/kernels/csrc/`` and every binding of a
kernel — a ``ctypes`` library load, a ``triton.jit`` function, a
``torch.utils.cpp_extension`` build — under ``src/repro_torch/kernels/``,
where the build (``kernels/build.py``), the launch counters, the plain
versions and the kernel-contract auditor
(:mod:`repro_torch.analysis.kernel_audit`) see it.  A kernel loaded from
core/, serving/ or a script dodges all of them.  Calls into the kernels
package's API (``build.build_library``) are not bindings.

Findings: a tracked ``.cu`` / ``.cuh`` file outside the ``csrc/``
directory, and in a tracked ``.py`` file outside the kernels package a
call of ``ctypes.CDLL`` / ``ctypes.cdll.LoadLibrary``, ``triton.jit``
(called or as a decorator), or ``torch.utils.cpp_extension.load`` /
``load_inline``, under any import alias.  The ``prefix`` option moves
the kernels package.
"""

from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.config import AnalysisConfig
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.lint import LintContext

KERNELS_PREFIX = "src/repro_torch/kernels/"
CUDA_SUFFIXES = (".cu", ".cuh")

#: Fully qualified callables that bind a kernel.
BINDINGS = ("ctypes.CDLL", "ctypes.cdll.LoadLibrary", "triton.jit",
            "torch.utils.cpp_extension.load",
            "torch.utils.cpp_extension.load_inline")


def _aliases(tree: ast.AST) -> dict[str, str]:
    """Local name -> the module path it stands for, from the imports
    (``import ctypes as ct`` -> ``ct: ctypes``; ``from ctypes import
    CDLL`` -> ``CDLL: ctypes.CDLL``)."""
    names: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    names[a.asname] = a.name
                else:
                    root = a.name.split(".")[0]
                    names[root] = root
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            for a in node.names:
                names[a.asname or a.name] = f"{node.module}.{a.name}"
    return names


def _dotted(node: ast.AST, aliases: dict[str, str]) -> str | None:
    """``a.b.c`` of a Name / Attribute chain with its head resolved
    through ``aliases``; None for anything else."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(aliases.get(node.id, node.id))
    return ".".join(reversed(parts))


def _binding_sites(tree: ast.AST):
    """Yield (lineno, name) for every call or decorator that binds a
    kernel (:data:`BINDINGS`)."""
    aliases = _aliases(tree)
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            name = _dotted(node.func, aliases)
            if name in BINDINGS:
                yield node.lineno, name
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for deco in node.decorator_list:
                if isinstance(deco, ast.Call):
                    continue                # reached as a Call above
                name = _dotted(deco, aliases)
                if name in BINDINGS:
                    yield deco.lineno, name


class KernelContainmentRule:
    name = "kernel-containment"
    description = ("CUDA sources only under src/repro_torch/kernels/csrc/, "
                   "kernel bindings only under src/repro_torch/kernels/")

    def check(self, ctx: LintContext,
              config: AnalysisConfig) -> Iterable[Finding]:
        prefix = config.options.get(self.name, {}).get(
            "prefix", KERNELS_PREFIX)
        for rel in ctx.files():
            if rel.endswith(CUDA_SUFFIXES) \
                    and not rel.startswith(prefix + "csrc/"):
                yield Finding(
                    self.name, rel, 0,
                    f"CUDA source outside {prefix}csrc/ — kernel sources "
                    "live where kernels/build.py compiles them and the "
                    "kernel-contract auditor reads their constants")
        for rel in ctx.python_files():
            if rel.startswith(prefix):
                continue
            tree, err = ctx.try_tree(rel)
            if err is not None:
                yield err
                continue
            for lineno, name in _binding_sites(tree):
                yield Finding(
                    self.name, rel, lineno,
                    f"{name} outside {prefix} — kernels are built and "
                    "bound behind the kernels package (call its wrappers, "
                    "or kernels.build.build_library), so the launch "
                    "counters, the plain versions and the kernel-contract "
                    "auditor cover them")
