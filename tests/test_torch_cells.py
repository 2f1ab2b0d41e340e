"""The port's cell programs (``repro_torch.launch.steps``) against the
reference's (``repro.launch.steps``), one cell per builder.

Each case builds a reduced arch (``tiny_config`` for the LMs, narrow
GNNs, a small FM table; JEDI-net at its own width) and a reduced
``ShapeSpec`` in both packages, runs the reference's ``build_cell`` step
under ``jax.jit`` on a 1-device mesh, and the port's ``build_cell`` step
on ``DTensor``s placed by its own ``make_abstract`` shardings
(``steps.place``) over a (1, 1) ``DeviceMesh`` of an in-process
world-size-1 ``gloo`` group, inside ``axis_rules``.  The inputs are the
same numpy arrays; the weights are the reference's, bridged.

Bars: a train step's loss and grad norm within 2e-4 of their size and
the updated params within 2e-4 of their scale (at step 1 of the warmup,
lr 1e-5 or 2e-5: AdamW's and Adafactor's first update is ~lr x sign(g),
so an entry whose gradient sits at the noise level may step either way,
which is why params are never the only check); a serve step's outputs
within 2e-4 of their scale (``PathSpec.tolerance`` of the plain paths).
The port's abstract args are also held to the real ones, leaf for leaf.
"""

import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor

from repro.configs.registry import get_arch as jget_arch
from repro.launch import steps as jsteps
from repro.parallel import sharding as jshd
from repro.serving.lm import tiny_config as jtiny
from repro.training import make_optimizer as j_make_optimizer
from repro.training.schedule import warmup_cosine as jwarmup_cosine
from repro_torch import bridge
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.registry import get_arch
from repro_torch.launch import steps
from repro_torch.parallel import sharding as shd
from repro_torch.serving.lm import tiny_config as ttiny

TOL = 2e-4


@pytest.fixture(scope="module")
def mesh():
    """A (1, 1) ("data", "model") mesh over a world-size-1 gloo group."""
    tmp = tempfile.mkdtemp(prefix="cells_pg_")
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1, 1),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def _shrink(arch_id, jax_side: bool):
    arch = (jget_arch if jax_side else get_arch)(arch_id)
    m = arch.model
    if arch.family == "lm":
        m = (jtiny if jax_side else ttiny)(m)
    elif arch.family == "gnn":
        m = dataclasses.replace(m, n_layers=2, d_hidden=16)
    elif arch.family == "recsys":
        m = dataclasses.replace(m, vocab_sizes=(64,) * m.n_sparse)
    return dataclasses.replace(arch, model=m)


def _shape(jax_side: bool, name, kind, **dims):
    if jax_side:
        from repro.configs.base import ShapeSpec as JShape
        return JShape(name, kind, dims)
    return ShapeSpec(name, kind, dims)


# (arch, shape name, kind, dims, the optimizer the builder uses)
CASES = {
    "lm_train": ("h2o-danube-1.8b", "train_4k", "train",
                 dict(seq_len=16, global_batch=2), "adafactor"),
    "lm_prefill": ("h2o-danube-1.8b", "prefill_32k", "prefill",
                   dict(seq_len=16, global_batch=2), None),
    "lm_decode": ("moonshot-v1-16b-a3b", "decode_32k", "decode",
                  dict(seq_len=16, global_batch=2), None),
    "gnn_fullgraph": ("pna", "full_graph_sm", "full_graph",
                      dict(n_nodes=500, n_edges=1000, d_feat=8), "adamw"),
    "gnn_minibatch": ("gcn-cora", "minibatch_lg", "minibatch",
                      dict(n_nodes=5000, n_edges=20000, batch_nodes=8,
                           fanout=(3, 2), d_feat=8), "adamw"),
    "gnn_molecule": ("meshgraphnet", "molecule", "batched_graphs",
                     dict(n_nodes=6, n_edges=10, batch=4, d_feat=8),
                     "adamw"),
    "fm_train": ("fm", "train_batch", "recsys_train", dict(batch=32),
                 "adamw_fm"),
    "fm_serve": ("fm", "serve_p99", "recsys_serve", dict(batch=32), None),
    "fm_retrieval": ("fm", "retrieval_cand", "retrieval",
                     dict(batch=1, n_candidates=700), None),
    "jedi_infer": ("jedinet-30p", "stream_1k", "jedi_infer",
                   dict(batch=1000), None),
    "jedi_train": ("jedinet-30p", "train_jets", "jedi_train",
                   dict(batch=64), "adamw_jedi"),
}


def _j_optimizer(kind):
    if kind == "adafactor":
        return j_make_optimizer("adafactor", jwarmup_cosine(1e-3, 100, 10000))
    if kind == "adamw_fm":
        return j_make_optimizer("adamw", jwarmup_cosine(1e-3, 100, 10000),
                                weight_decay=0.0)
    lr = 2e-3 if kind == "adamw_jedi" else 1e-3
    return j_make_optimizer("adamw", jwarmup_cosine(lr, 100, 10000))


def _inputs(case, arch, shape, a_args, rng):
    """The step's non-param inputs as numpy arrays, shaped as the port's
    abstract args (the padded counts included)."""
    fam, cfg = arch.family, arch.model
    tail = a_args[1:]
    if case in ("lm_train",):
        b, s = tuple(a_args[1]["tokens"].shape)
        t = rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32)
        return [{"tokens": t, "labels": np.roll(t, -1, 1)}]
    if case == "lm_prefill":
        return [rng.randint(0, cfg.vocab_size,
                            tuple(tail[0].shape)).astype(np.int32)]
    if case == "lm_decode":
        return [None, rng.randint(0, cfg.vocab_size,
                                  tuple(tail[1].shape)).astype(np.int32)]
    if fam == "gnn":
        out = {}
        for k, a in tail[0].items():
            shp = tuple(a.shape)
            if k in ("senders", "receivers"):
                n = (tail[0]["x"].shape[1] if case == "gnn_molecule"
                     else tail[0]["x"].shape[0])
                out[k] = rng.randint(0, n, shp).astype(np.int32)
            elif k == "y" and a.dtype == torch.int32:
                out[k] = rng.randint(0, cfg.n_classes, shp).astype(np.int32)
            elif a.dtype == torch.bool:
                out[k] = rng.rand(*shp) < 0.8
            else:
                out[k] = rng.randn(*shp).astype(np.float32)
        return [out]
    if case == "fm_train" or case == "fm_serve":
        b = tail[0]["ids"].shape[0] if case == "fm_train" else \
            tail[0].shape[0]
        ids = np.stack([rng.randint(0, v, b) for v in cfg.vocab_sizes],
                       1).astype(np.int32)
        if case == "fm_serve":
            return [ids]
        return [{"ids": ids, "y": rng.randint(0, 2, b).astype(np.int32)}]
    if case == "fm_retrieval":
        user = np.array([rng.randint(0, v) for v in cfg.vocab_sizes[:-1]],
                        np.int32)
        cand = rng.randint(0, cfg.vocab_sizes[-1],
                           tuple(tail[1].shape)).astype(np.int32)
        return [user, cand]
    x = rng.randn(*tuple(tail[0]["x"].shape if case == "jedi_train"
                         else tail[0].shape)).astype(np.float32)
    if case == "jedi_infer":
        return [x]
    return [{"x": x, "y": rng.randint(0, cfg.n_targets,
                                      x.shape[0]).astype(np.int32)}]


def _jax_params(arch, case):
    from repro.core import interaction_net as jinet
    from repro.models import recsys as jrec
    from repro.models import transformer as jtfm
    from repro.models.gnn import GNN_MODULES
    cfg, key = arch.model, jax.random.PRNGKey(0)
    if arch.family == "lm":
        return jtfm.init(key, cfg)
    if arch.family == "recsys":
        p = jrec.init(key, cfg)
        # rows at the init's scale are ~1e-3: give the products some size
        return dict(p, tables={"rows": p["tables"]["rows"] * 100.0})
    if arch.family == "jedi":
        return jinet.init(key, cfg)
    shape = CASES[case][3]
    return GNN_MODULES[cfg.kind].init(key, cfg, int(shape.get("d_feat", 16)),
                                      cfg.n_classes)


def _err(got, want) -> float:
    got = got.full_tensor() if isinstance(got, DTensor) else got
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    return float(np.abs(got.detach().float().numpy() - want).max()) / scale


@pytest.mark.parametrize("case", list(CASES))
def test_cell_step_matches_the_reference(case, mesh):
    arch_id, name, kind, dims, opt_kind = CASES[case]
    jarch, tarch = _shrink(arch_id, True), _shrink(arch_id, False)
    jshape, tshape = _shape(True, name, kind, **dims), \
        _shape(False, name, kind, **dims)

    prog = steps.build_cell(tarch, tshape, mesh)
    a_args, in_sh, _ = prog.make_abstract()
    assert prog.kind == ("train" if opt_kind else "serve")
    rng = np.random.RandomState(0)
    data = _inputs(case, tarch, tshape, a_args, rng)
    jp = jax.tree_util.tree_map(np.asarray, _jax_params(jarch, case))

    # the reference's step on real arrays
    jmesh = jax.make_mesh((1, 1), ("data", "model"),
                          axis_types=(jax.sharding.AxisType.Auto,) * 2)
    jprog = jsteps.build_cell(jarch, jshape, jmesh)
    if opt_kind:
        jopt = _j_optimizer(opt_kind)
        jstate = {"params": jp, "opt": jopt.init(jp),
                  "step": jnp.asarray(1, jnp.int32)}
        jargs = (jstate, data[0])
    elif case == "lm_decode":
        from repro.models import transformer as jtfm
        jcache = jtfm.init_cache(jarch.model, dims["global_batch"],
                                 dims["seq_len"])
        jargs = (jp, jcache, data[1])
    else:
        jargs = (jp, *data)
    with jmesh, jshd.axis_rules(jmesh):
        jout = jax.jit(jprog.step_fn)(*jargs)
    jout = jax.tree_util.tree_map(np.asarray, jout)

    # the port's step on the same inputs, placed by its own shardings
    tp = bridge.params_from_jax(jp, device="cpu")
    if opt_kind:
        targs = ({"params": tp, "opt": prog.optimizer.init(tp),
                  "step": torch.tensor(1, dtype=torch.int32)},
                 tree_map(torch.from_numpy, data[0]))
    elif case == "lm_decode":
        from repro_torch.models import transformer as tfm
        targs = (tp, tfm.init_cache(tarch.model, dims["global_batch"],
                                    dims["seq_len"], device="cpu"),
                 torch.from_numpy(data[1]))
    else:
        targs = (tp, *[torch.from_numpy(d) for d in data])
    for a, t in zip(tree_leaves(a_args), tree_leaves(targs)):
        assert tuple(a.shape) == tuple(t.shape) and a.dtype == t.dtype
    with shd.axis_rules(mesh):
        tout = prog.step_fn(*steps.place(targs, in_sh))

    if opt_kind:
        (tstate, tm), (jnew, jm) = tout, jout
        for k in ("loss", "grad_norm"):
            got = tm[k].full_tensor() if isinstance(tm[k], DTensor) \
                else tm[k]
            assert abs(float(got) - float(jm[k])) <= TOL * max(
                1.0, abs(float(jm[k]))), k
        assert max(_err(g, w) for g, w in zip(
            tree_leaves(tstate["params"]),
            jax.tree_util.tree_leaves(jnew["params"]))) <= TOL
        assert int(tstate["step"].full_tensor()) == 2
    else:
        got, want = tree_leaves(tout), jax.tree_util.tree_leaves(jout)
        assert len(got) == len(want)
        assert max(_err(g, w) for g, w in zip(got, want)) <= TOL
