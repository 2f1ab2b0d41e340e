"""Architecture registry: ``get_arch("<id>")`` -> ArchSpec.

Counterpart of ``repro.configs.registry``: every arch of the reference
has a port config (each module exports an ``ARCH``); the dry run
(``launch/dryrun.py``) walks its cells with :func:`iter_cells`.
:data:`ARCH_MODULES` mirrors the reference's table; archs the reference
lacks are in :data:`PORT_ONLY_MODULES`, which :func:`get_arch` also reads
and the dry run does not walk.
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
    # GNN family
    "gcn-cora": "repro_torch.configs.gcn_cora",
    "pna": "repro_torch.configs.pna",
    "meshgraphnet": "repro_torch.configs.meshgraphnet",
    "equiformer-v2": "repro_torch.configs.equiformer_v2",
    # RecSys
    "fm": "repro_torch.configs.fm",
    # the paper's own models
    "jedinet-30p": "repro_torch.configs.jedi_30p",
    "jedinet-50p": "repro_torch.configs.jedi_50p",
    "jedinet-tracks-128": "repro_torch.configs.jedi_tracks_128",
}

#: Archs of the port alone (no JAX counterpart).
PORT_ONLY_MODULES = {
    "moonlight-16b-a3b": "repro_torch.configs.moonlight_16b_a3b",
}

ASSIGNED_ARCHS = [a for a in ARCH_MODULES if not a.startswith("jedinet")]
ALL_ARCHS = list(ARCH_MODULES)


def get_arch(arch_id: str) -> ArchSpec:
    modules = {**ARCH_MODULES, **PORT_ONLY_MODULES}
    if arch_id not in modules:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(modules)}")
    mod = importlib.import_module(modules[arch_id])
    return mod.ARCH


def iter_cells(archs=None, include_skipped: bool = False):
    """Yield (arch_spec, shape_spec) for every dry-run cell."""
    for arch_id in (archs or ASSIGNED_ARCHS):
        spec = get_arch(arch_id)
        shapes = spec.shapes if include_skipped else spec.runnable_shapes()
        for shape in shapes.values():
            yield spec, shape
