"""Per-(architecture x shape) step functions + abstract input specs.

Port of ``repro.launch.steps``.  Every dry-run cell resolves to a
``CellProgram``:

    step_fn      : the step to run (a train step or a serve function)
    make_abstract: () -> (args tuple of shape-only trees,
                          in_shardings tuple, out_shardings)
    describe     : metadata for the roofline report

The abstract args are ``meta`` tensors (the reference's
``ShapeDtypeStruct``s): each builder makes them by running the family's
own ``init`` under a ``FakeTensorMode`` (``jax.eval_shape``), so nothing
is allocated at any width.  The shardings are
:class:`repro_torch.parallel.sharding.NamedSharding`s from the same
rules as the reference's.  :func:`place` turns an abstract tree and its
shardings into ``DTensor``s: fake local shards under a ``FakeTensorMode``
(the dry run; no scatter is dispatched) or, given real tensors,
``distribute``.  The step runs under ``axis_rules(mesh)``.

LM ``decode_*`` / ``long_*`` cells run ``decode_step`` (one token against
a KV cache; on the card each layer's attention is one B5 launch over the
rank's local shard of the cache, ``models/transformer.py``);
``prefill_*`` runs a full-sequence forward returning last-token logits +
the built cache; ``train_*`` runs loss+grad+optimizer-update.  GNN cells
run family-specific train steps; recsys cells train / bulk-score /
retrieval programs.  Encoder-only archs have no decode cells in the
assignment, so no special-casing is needed.

The optimizer for LM train cells is Adafactor (AdamW's fp32 moments for
arctic-480b would need ~3.8 TB — see configs/arctic_480b.py); GNN/recsys/
JEDI train cells use AdamW.  A train cell's ``optimizer`` makes the
state of a real run (``optimizer.init(params)``).

The module also keeps the GNN family's helpers that the train program
uses: the feature width of a shape, which kinds need node positions, and
the family's loss on a model's output.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor

from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.configs.base import ArchSpec, ShapeSpec
from repro_torch.core import interaction_net as inet
from repro_torch.data.neighbor_sampler import static_budget
from repro_torch.models import recsys as fm_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.gnn import GNN_MODULES
from repro_torch.models.gnn import segment_ops as seg
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import P, NamedSharding
from repro_torch.training import Optimizer, make_optimizer, make_train_step
from repro_torch.training.schedule import warmup_cosine


@dataclasses.dataclass
class CellProgram:
    arch_id: str
    shape_name: str
    kind: str                    # train | serve
    step_fn: Callable
    make_abstract: Callable      # () -> (args, in_shardings, out_shardings)
    notes: str = ""
    optimizer: Optional[Optimizer] = None     # train cells


def sds(shape, dtype) -> torch.Tensor:
    """A shape-only tensor (``jax.ShapeDtypeStruct``): ``meta``."""
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype,
                       device="meta")


def pad512(n: int) -> int:
    """Round node/edge/candidate counts up to a 512 multiple so the flat
    set axes shard over the full 512-chip mesh.  The data pipeline pads
    with inert elements (features 0, edges into a sink node, labels -1)."""
    return -(-int(n) // 512) * 512


def _meta(t: torch.Tensor) -> torch.Tensor:
    return torch.empty_strided(tuple(t.shape), tuple(t.stride()),
                               dtype=t.dtype, device="meta")


def abstract(fn: Callable):
    """``jax.eval_shape``: ``fn()`` under a ``FakeTensorMode`` (the
    family's init with an int seed on the CPU, allocating nothing), its
    tensors returned as ``meta``."""
    with FakeTensorMode(allow_non_fake_inputs=True):
        out = fn()
    return tree_map(_meta, out)


def place(args, shardings, fake_mode=None):
    """Each tensor leaf of ``args`` as a ``DTensor`` on its sharding's mesh
    and placements.  With ``fake_mode`` the leaves are shape-only and each
    becomes ``DTensor.from_local`` of a fake local shard of rank 0's
    shape on the mesh's device type (``run_check=False``: nothing is
    scattered or checked); without, the leaves are real tensors and are
    ``distribute``d (rank 0's values), or on a mesh of one rank wrapped as
    they are (each is its own shard: no copy, so the DTensor step writes
    where the caller's tensors live)."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    if fake_mode is None:
        if all(sh.mesh.size() == 1 for sh in tree_leaves(shardings)):
            return tree_map(lambda t, sh: DTensor.from_local(
                t, sh.mesh, sh.placements, run_check=False), args,
                shardings)
        return shd.distribute(args, shardings)

    def one(t, sh):
        local, _ = compute_local_shape_and_global_offset(
            tuple(t.shape), sh.mesh, sh.placements)
        with fake_mode:
            loc = torch.empty(tuple(local), dtype=t.dtype,
                              device=sh.mesh.device_type)
        return DTensor.from_local(loc, sh.mesh, sh.placements,
                                  run_check=False, shape=tuple(t.shape),
                                  stride=tuple(t.stride()))
    return tree_map(one, args, shardings)


def _state(params_fn: Callable, opt: Optimizer) -> dict:
    """A train state's abstract tree: params, the optimizer's state, the
    int32 step."""
    def build():
        params = params_fn()
        return {"params": params, "opt": opt.init(params),
                "step": torch.zeros((), dtype=torch.int32)}
    return abstract(build)


def _replicated(mesh, tree):
    return tree_map(lambda _: NamedSharding(mesh, P()), tree)


# ===========================================================================
# LM family
# ===========================================================================

def _lm_abstract_params(cfg):
    return abstract(lambda: tfm.init(0, cfg, device="cpu"))


def _lm_loss_kw(cfg, seq_len: int) -> dict:
    """The reference's production chunking (its ``unroll_scans`` cost
    variant has no counterpart: ``launch/dryrun.py``)."""
    v = tfm.padded_vocab(cfg)
    return dict(
        kv_chunk=min(2048, seq_len),
        q_chunk=(2048 if seq_len > 8192 else None),
        logit_chunk=(512 if v >= 32768 and seq_len >= 2048 else None),
    )


def lm_train_cell(arch: ArchSpec, shape: ShapeSpec, mesh) -> CellProgram:
    cfg = arch.model
    b = shape.dim("global_batch")
    s = shape.dim("seq_len")
    opt = make_optimizer("adafactor", warmup_cosine(1e-3, 100, 10000))
    kw = _lm_loss_kw(cfg, s)
    step = make_train_step(
        lambda p, batch: tfm.loss_fn(p, cfg, batch, **kw), opt)

    def make_abstract():
        a_state = _state(lambda: tfm.init(0, cfg, device="cpu"), opt)
        a_batch = {"tokens": sds((b, s), torch.int32),
                   "labels": sds((b, s), torch.int32)}
        st_sh = shd.train_state_shardings(a_state, mesh)
        b_sh = shd.batch_shardings(
            a_batch, mesh, {"tokens": ("batch", None),
                            "labels": ("batch", None)})
        out_sh = (st_sh, None)
        return (a_state, a_batch), (st_sh, b_sh), out_sh

    return CellProgram(arch.arch_id, shape.name, "train", step,
                       make_abstract, optimizer=opt)


def lm_prefill_cell(arch: ArchSpec, shape: ShapeSpec, mesh) -> CellProgram:
    cfg = arch.model
    b = shape.dim("global_batch")
    s = shape.dim("seq_len")
    pf_kw = dict(kv_chunk=2048, q_chunk=(2048 if s > 8192 else None))

    def prefill(params, tokens):
        logits, _, cache = tfm.forward(
            params, cfg, tokens, return_cache=True, **pf_kw)
        return logits[:, -1, :], cache

    def make_abstract():
        a_params = _lm_abstract_params(cfg)
        a_tokens = sds((b, s), torch.int32)
        p_sh = shd.param_shardings(a_params, mesh)
        t_sh = shd.batch_shardings({"t": a_tokens}, mesh,
                                   {"t": ("batch", None)})["t"]
        return (a_params, a_tokens), (p_sh, t_sh), None

    return CellProgram(arch.arch_id, shape.name, "serve", prefill,
                       make_abstract)


def lm_decode_cell(arch: ArchSpec, shape: ShapeSpec, mesh) -> CellProgram:
    cfg = arch.model
    b = shape.dim("global_batch")
    s = shape.dim("seq_len")
    t = tfm.cache_len(cfg, s)

    def decode(params, cache, tokens):
        return tfm.decode_step(params, cfg, cache, tokens)

    def make_abstract():
        a_params = _lm_abstract_params(cfg)
        a_cache = abstract(lambda: tfm.init_cache(cfg, b, s, device="cpu"))
        a_tokens = sds((b,), torch.int32)
        p_sh = shd.param_shardings(a_params, mesh)
        c_sh = shd.kv_cache_shardings(a_cache, mesh)
        t_sh = shd.batch_shardings({"t": a_tokens}, mesh,
                                   {"t": ("batch",)})["t"]
        return ((a_params, a_cache, a_tokens), (p_sh, c_sh, t_sh),
                (None, c_sh))

    notes = ""
    if cfg.sliding_window is not None and t < s:
        notes = (f"rolling SWA cache: window {t} << context {s} "
                 "(the sub-quadratic long-decode path)")
    return CellProgram(arch.arch_id, shape.name, "serve", decode,
                       make_abstract, notes=notes)


# ===========================================================================
# GNN family
# ===========================================================================

def _gnn_feat_dim(shape: ShapeSpec) -> int:
    return int(shape.dim("d_feat", 16))


def _needs_pos(kind: str) -> bool:
    return kind in ("meshgraphnet", "equiformer_v2")


def _gnn_loss(kind: str, cfg, out, graph):
    """Family-appropriate loss on model output: masked cross-entropy and
    accuracy over labels ``y >= 0`` for gcn / pna, mean squared error
    (over ``seed_mask``'s nodes where the graph has one) for the
    regression heads.  ``argmax`` takes the first of tied maxima, as
    ``jnp.argmax`` does."""
    if kind in ("gcn", "pna"):
        y = graph["y"]
        mask = (y >= 0).float()
        logp = torch.log_softmax(out.float(), -1)
        nll = -logp.gather(-1, y.clamp_min(0).long()[:, None])[:, 0]
        count = mask.sum().clamp_min(1.0)
        loss = (nll * mask).sum() / count
        acc = ((out.argmax(-1) == y).float() * mask).sum() / count
        return loss, {"accuracy": acc}
    # regression heads
    y = graph["y"].float()
    if y.ndim == 1:
        y = y[:, None]
    mask = graph.get("seed_mask")
    err = (out.float() - y).square()
    if mask is not None:
        m = mask.float()[:, None]
        loss = (err * m).sum() / (m.sum() * err.shape[-1]).clamp_min(1.0)
    else:
        loss = err.mean()
    return loss, {"mse": loss}


def _gnn_batch_axes(keys) -> dict:
    ax = {
        "x": ("nodes", None), "pos": ("nodes", None),
        "senders": ("edges",), "receivers": ("edges",),
        "edge_mask": ("edges",), "seed_mask": ("nodes",),
        "y": ("nodes",), "n_nodes": None,
    }
    return {k: ax.get(k) for k in keys}


def _gnn_opt():
    return make_optimizer("adamw", warmup_cosine(1e-3, 100, 10000))


def gnn_fullgraph_cell(arch: ArchSpec, shape: ShapeSpec, mesh,
                       *, minibatch: bool = False) -> CellProgram:
    cfg = arch.model
    kind = cfg.kind
    mod = GNN_MODULES[kind]
    d_in = _gnn_feat_dim(shape)

    if minibatch:
        n, e = static_budget(int(shape.dim("batch_nodes")),
                             tuple(shape.dim("fanout")))
    else:
        n = int(shape.dim("n_nodes"))
        e = int(shape.dim("n_edges"))
    n, e = pad512(n), pad512(e)

    n_out = cfg.n_classes
    opt = _gnn_opt()

    def loss_fn(params, graph):
        out = mod.apply(params, cfg, graph)
        return _gnn_loss(kind, cfg, out, graph)

    step = make_train_step(loss_fn, opt)

    def make_abstract():
        a_state = _state(
            lambda: mod.init(0, cfg, d_in, n_out, device="cpu"), opt)
        g = {
            "x": sds((n, d_in), torch.float32),
            "senders": sds((e,), torch.int32),
            "receivers": sds((e,), torch.int32),
        }
        if _needs_pos(kind):
            g["pos"] = sds((n, 3), torch.float32)
        if kind in ("gcn", "pna"):
            g["y"] = sds((n,), torch.int32)
        elif kind == "meshgraphnet":
            g["y"] = sds((n, 3), torch.float32)
        else:
            g["y"] = sds((n,), torch.float32)
        if minibatch:
            g["edge_mask"] = sds((e,), torch.bool)
            g["seed_mask"] = sds((n,), torch.bool)
        st_sh = shd.train_state_shardings(a_state, mesh)
        g_sh = shd.batch_shardings(g, mesh, _gnn_batch_axes(g.keys()))
        return (a_state, g), (st_sh, g_sh), (st_sh, None)

    return CellProgram(arch.arch_id, shape.name, "train", step,
                       make_abstract,
                       notes=("sampled-subgraph (padded static shapes)"
                              if minibatch else "full-batch"),
                       optimizer=opt)


def gnn_molecule_cell(arch: ArchSpec, shape: ShapeSpec, mesh) -> CellProgram:
    cfg = arch.model
    kind = cfg.kind
    mod = GNN_MODULES[kind]
    b = int(shape.dim("batch"))
    n = int(shape.dim("n_nodes"))
    e = int(shape.dim("n_edges"))
    d_in = _gnn_feat_dim(shape)
    n_out = cfg.n_classes
    opt = _gnn_opt()

    def loss_fn(params, batch):
        x, s, r, gids = seg.flatten_batched_graphs(
            batch["x"], batch["senders"], batch["receivers"])
        g = {"x": x, "senders": s, "receivers": r}
        if "pos" in batch:
            g["pos"] = batch["pos"].reshape(-1, 3)
        out = mod.apply(params, cfg, g)                    # (B*N, n_out)
        per_graph = seg.scatter_mean(out, gids, b)         # (B, n_out)
        y = batch["y"]
        logp = torch.log_softmax(per_graph.float(), -1)
        nll = -logp.gather(-1, y.long()[:, None])[:, 0]
        acc = (per_graph.argmax(-1) == y).float().mean()
        return nll.mean(), {"accuracy": acc}

    step = make_train_step(loss_fn, opt)

    def make_abstract():
        a_state = _state(
            lambda: mod.init(0, cfg, d_in, n_out, device="cpu"), opt)
        batch = {
            "x": sds((b, n, d_in), torch.float32),
            "senders": sds((b, e), torch.int32),
            "receivers": sds((b, e), torch.int32),
            "y": sds((b,), torch.int32),
        }
        if _needs_pos(kind):
            batch["pos"] = sds((b, n, 3), torch.float32)
        st_sh = shd.train_state_shardings(a_state, mesh)
        b_sh = shd.batch_shardings(batch, mesh, {
            "x": ("batch", None, None), "pos": ("batch", None, None),
            "senders": ("batch", None), "receivers": ("batch", None),
            "y": ("batch",)})
        return (a_state, batch), (st_sh, b_sh), (st_sh, None)

    return CellProgram(arch.arch_id, shape.name, "train", step,
                       make_abstract, notes="batched small graphs",
                       optimizer=opt)


# ===========================================================================
# recsys (FM)
# ===========================================================================

def _fm_abstract_params(cfg):
    return abstract(lambda: fm_lib.init(0, cfg, device="cpu"))


def fm_train_cell(arch: ArchSpec, shape: ShapeSpec, mesh) -> CellProgram:
    cfg = arch.model
    b = int(shape.dim("batch"))
    opt = make_optimizer("adamw", warmup_cosine(1e-3, 100, 10000),
                         weight_decay=0.0)
    step = make_train_step(
        lambda p, batch: fm_lib.loss_fn(p, cfg, batch), opt)

    def make_abstract():
        a_state = _state(lambda: fm_lib.init(0, cfg, device="cpu"), opt)
        batch = {"ids": sds((b, cfg.n_sparse), torch.int32),
                 "y": sds((b,), torch.int32)}
        st_sh = shd.train_state_shardings(a_state, mesh)
        b_sh = shd.batch_shardings(batch, mesh, {
            "ids": ("batch", None), "y": ("batch",)})
        return (a_state, batch), (st_sh, b_sh), (st_sh, None)

    return CellProgram(arch.arch_id, shape.name, "train", step,
                       make_abstract, optimizer=opt)


def fm_serve_cell(arch: ArchSpec, shape: ShapeSpec, mesh) -> CellProgram:
    cfg = arch.model
    b = int(shape.dim("batch"))

    def score(params, ids):
        return fm_lib.forward(params, cfg, ids)

    def make_abstract():
        a_params = _fm_abstract_params(cfg)
        a_ids = sds((b, cfg.n_sparse), torch.int32)
        p_sh = shd.param_shardings(a_params, mesh)
        i_sh = NamedSharding(mesh, shd.logical_to_spec(
            ("batch", None), mesh, shd.DEFAULT_RULES))
        return (a_params, a_ids), (p_sh, i_sh), None

    return CellProgram(arch.arch_id, shape.name, "serve", score,
                       make_abstract)


def fm_retrieval_cell(arch: ArchSpec, shape: ShapeSpec, mesh) -> CellProgram:
    cfg = arch.model
    n_cand = pad512(shape.dim("n_candidates"))

    def score(params, user_ids, cand_ids):
        return fm_lib.retrieval_score(params, cfg, user_ids, cand_ids)

    def make_abstract():
        a_params = _fm_abstract_params(cfg)
        a_user = sds((cfg.n_sparse - 1,), torch.int32)
        a_cand = sds((n_cand,), torch.int32)
        p_sh = shd.param_shardings(a_params, mesh)
        u_sh = NamedSharding(mesh, P())
        c_sh = NamedSharding(mesh, shd.logical_to_spec(
            ("candidates",), mesh, shd.DEFAULT_RULES))
        return (a_params, a_user, a_cand), (p_sh, u_sh, c_sh), None

    return CellProgram(arch.arch_id, shape.name, "serve", score,
                       make_abstract, notes="1 query x 1M candidates GEMV")


# ===========================================================================
# JEDI-net (the paper's own model)
# ===========================================================================

def _jedi_abstract_params(cfg):
    return abstract(lambda: inet.init(0, cfg, device="cpu"))


def jedi_infer_cell(arch: ArchSpec, shape: ShapeSpec, mesh) -> CellProgram:
    cfg = arch.model
    # §Perf cell A: batch 1000 doesn't divide the 16-way data axis and
    # would replicate onto every chip (a 15.6x memory-term regression);
    # serving pads the request batch to 1024.  The bilinear-split forward
    # is the optimized production path (paper-faithful forward_sr is the
    # baseline, measured in experiments/hillclimb_jedi.py).
    b = -(-int(shape.dim("batch")) // 1024) * 1024

    def infer(params, x):
        return inet.forward_sr_split(params, cfg, x, grid=False)

    def make_abstract():
        a_params = _jedi_abstract_params(cfg)
        a_x = sds((b, cfg.n_objects, cfg.n_features), torch.float32)
        p_sh = _replicated(mesh, a_params)
        x_sh = shd.batch_shardings({"x": a_x}, mesh,
                                   {"x": ("batch", None, None)})["x"]
        return (a_params, a_x), (p_sh, x_sh), None

    return CellProgram(arch.arch_id, shape.name, "serve", infer,
                       make_abstract, notes="paper Table 3 inference path")


def jedi_train_cell(arch: ArchSpec, shape: ShapeSpec, mesh) -> CellProgram:
    cfg = arch.model
    b = int(shape.dim("batch"))
    opt = make_optimizer("adamw", warmup_cosine(2e-3, 100, 10000))
    step = make_train_step(
        lambda p, batch: inet.loss_fn(p, cfg, batch), opt)

    def make_abstract():
        a_state = _state(lambda: inet.init(0, cfg, device="cpu"), opt)
        batch = {"x": sds((b, cfg.n_objects, cfg.n_features),
                          torch.float32),
                 "y": sds((b,), torch.int32)}
        st_sh = shd.train_state_shardings(a_state, mesh)
        b_sh = shd.batch_shardings(batch, mesh, {
            "x": ("batch", None, None), "y": ("batch",)})
        return (a_state, batch), (st_sh, b_sh), (st_sh, None)

    return CellProgram(arch.arch_id, shape.name, "train", step,
                       make_abstract, optimizer=opt)


# ===========================================================================
# dispatch
# ===========================================================================

def build_cell(arch: ArchSpec, shape: ShapeSpec, mesh) -> CellProgram:
    fam, kind = arch.family, shape.kind
    if fam == "lm":
        if kind == "train":
            return lm_train_cell(arch, shape, mesh)
        if kind == "prefill":
            return lm_prefill_cell(arch, shape, mesh)
        if kind == "decode":
            return lm_decode_cell(arch, shape, mesh)
    if fam == "gnn":
        if kind == "full_graph":
            return gnn_fullgraph_cell(arch, shape, mesh)
        if kind == "minibatch":
            return gnn_fullgraph_cell(arch, shape, mesh, minibatch=True)
        if kind == "batched_graphs":
            return gnn_molecule_cell(arch, shape, mesh)
    if fam == "recsys":
        if kind == "recsys_train":
            return fm_train_cell(arch, shape, mesh)
        if kind == "recsys_serve":
            return fm_serve_cell(arch, shape, mesh)
        if kind == "retrieval":
            return fm_retrieval_cell(arch, shape, mesh)
    if fam == "jedi":
        if kind == "jedi_infer":
            return jedi_infer_cell(arch, shape, mesh)
        if kind == "jedi_train":
            return jedi_train_cell(arch, shape, mesh)
    raise ValueError(f"no step builder for {arch.arch_id} x {shape.name}")
