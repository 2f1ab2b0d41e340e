"""Architecture registry: ``get_arch("<id>")`` -> ArchSpec.

Counterpart of ``repro.configs.registry`` over the archs whose port
config exists (each module exports an ``ARCH``); the GNN ids join as
their slice brings an ``ARCH``.  Until then :data:`PENDING_ARCHS` names
each such id of the reference with its family, so an entry point can say
which slice it waits for.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchSpec

ARCH_MODULES = {
    # LM family (MoE)
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    # LM family (dense)
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1_8b",
    "minicpm-2b": "repro_torch.configs.minicpm_2b",
    "phi3-medium-14b": "repro_torch.configs.phi3_medium_14b",
    # RecSys
    "fm": "repro_torch.configs.fm",
    # the paper's own models
    "jedinet-30p": "repro_torch.configs.jedi_30p",
    "jedinet-50p": "repro_torch.configs.jedi_50p",
    "jedinet-tracks-128": "repro_torch.configs.jedi_tracks_128",
}

#: the reference's archs that the port has no config for yet -> family
PENDING_ARCHS = {
    "gcn-cora": "gnn",
    "pna": "gnn",
    "meshgraphnet": "gnn",
    "equiformer-v2": "gnn",
}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCH_MODULES)}")
    mod = importlib.import_module(ARCH_MODULES[arch_id])
    return mod.ARCH
