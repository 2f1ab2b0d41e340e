"""Architecture registry: ``get_arch("<id>")`` -> ArchSpec.

Counterpart of ``repro.configs.registry`` over the archs whose port
config exists (each module exports an ``ARCH``); the LM, GNN and
JEDI-net ids join as their slices bring an ``ARCH``.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchSpec

ARCH_MODULES = {
    # RecSys
    "fm": "repro_torch.configs.fm",
}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCH_MODULES)}")
    mod = importlib.import_module(ARCH_MODULES[arch_id])
    return mod.ARCH
