"""The port's explicitly sharded ops across ranks, against the same ops
unsharded: 4 ``gloo`` ranks on a 2 x 2 ``("data", "model")`` mesh
(``tests/torch_ranks.py``).

* the GNN substrate's gather and segment sum (each rank's own rows; the
  sums partial over the mesh dims that shard the edges, reduced at
  once) and its max (``on_whole``), through gcn-cora's, pna's and
  equiformer-v2's loss and its grads (equiformer-v2's views by rows,
  and its edges in two chunks);
* ``models.recsys.take_rows`` from a row-sharded table (the ids whole,
  each rank's own block, partial sums reduced onto the ids' placements),
  through the FM loss and its table grads;
* the decode step on a DTensor KV cache (``_sharded_decode``): kv heads
  sharded over ``model``, and the sequence sharded (the ``kvlen``
  fallback, 1 kv head on a 2-way ``model`` axis) where each rank writes
  its block and the sequence is gathered for B5's plain version.

Sums over ranks run in another order than on one process: the bar is
the reference's for sharded against unsharded (``tests/test_multidevice.py``),
1e-4 of scale, for forward values and grads (pna's std aggregator and
degree scalers take its grads to ~2.5e-5).
"""

import dataclasses

import torch

from repro_torch.common.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.configs.registry import get_arch
from repro_torch.data.graphs import community_graph
from repro_torch.launch import steps
from repro_torch.models import recsys as fm_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.gnn import GNN_MODULES
from repro_torch.parallel import sharding as shd
from repro_torch.serving.lm import tiny_config
from torch_ranks import run_ranks

TOL = 1e-4


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _loss_and_grads(loss_fn, params, batch, mesh=None, p_sh=None,
                    b_sh=None):
    if mesh is not None:
        params = shd.distribute(params, p_sh)
        batch = shd.distribute(batch, b_sh)
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    if mesh is None:
        loss = loss_fn(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), [g.detach() for g in grads]
    with shd.axis_rules(mesh):
        loss = loss_fn(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    return _full(loss.detach()), [_full(g.detach()) for g in grads]


def _rank_body(rank, world, out):
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    res = {}

    # -- GNN: gather, segment sum, segment max; equiformer-v2's views and
    # its chunked edge sum ----------------------------------------------------
    for arch_id in ("gcn-cora", "pna", "equiformer-v2"):
        cfg = dataclasses.replace(get_arch(arch_id).model, n_layers=2,
                                  d_hidden=8)
        if cfg.kind == "equiformer_v2":
            cfg = dataclasses.replace(cfg, n_layers=1, l_max=2, m_max=1,
                                      n_heads=2, edge_chunk=128)
        mod = GNN_MODULES[cfg.kind]
        params = mod.init(0, cfg, 8, cfg.n_classes, device="cpu")
        graph = {k: torch.from_numpy(v) for k, v in community_graph(
            0, 64, 256, 8, n_classes=cfg.n_classes).items()}
        if cfg.kind == "equiformer_v2":
            graph["pos"] = torch.randn(64, 3, generator=torch.Generator()
                                       .manual_seed(2))
            graph["y"] = graph["pos"].tanh().sum(-1)

        def loss_fn(p, g, cfg=cfg, mod=mod):
            return steps._gnn_loss(cfg.kind, cfg, mod.apply(p, cfg, g), g)[0]

        res[arch_id] = (
            _loss_and_grads(loss_fn, params, graph),
            _loss_and_grads(loss_fn, params, graph, mesh,
                            shd.param_shardings(params, mesh),
                            shd.batch_shardings(graph, mesh,
                                                steps._gnn_batch_axes(graph))))

    # -- FM: rows of a row-sharded table --------------------------------------
    cfg = dataclasses.replace(get_arch("fm").model,
                              vocab_sizes=(64,) * 39)
    params = fm_lib.init(0, cfg, device="cpu")
    params["tables"]["rows"].mul_(100.0)
    gen = torch.Generator().manual_seed(1)
    batch = {"ids": torch.randint(0, 64, (32, 39), generator=gen,
                                  dtype=torch.int32),
             "y": torch.randint(0, 2, (32,), generator=gen,
                                dtype=torch.int32)}
    res["fm"] = (
        _loss_and_grads(lambda p, b: fm_lib.loss_fn(p, cfg, b)[0], params,
                        batch),
        _loss_and_grads(lambda p, b: fm_lib.loss_fn(p, cfg, b)[0], params,
                        batch, mesh, shd.param_shardings(params, mesh),
                        shd.batch_shardings(batch, mesh, {
                            "ids": ("batch", None), "y": ("batch",)})))

    # -- decode on a sharded cache: kv heads sharded, then the sequence -------
    for n_kv in (2, 1):
        cfg = dataclasses.replace(tiny_config(
            get_arch("h2o-danube-1.8b").model), n_kv_heads=n_kv,
            sliding_window=None)
        params = tfm.init(0, cfg, device="cpu")
        b, t = 4, 16
        cache = tfm.init_cache(cfg, b, t, device="cpu")
        cache["k"].normal_(generator=gen)
        cache["v"].normal_(generator=gen)
        # rows 0-1 full (the step overwrites slot pos % T), rows 2-3 half
        pos = torch.tensor([16, 21, 8, 5], dtype=torch.int32)
        for i in range(b):
            p = int(pos[i])
            for s in range(max(0, p - t), p):
                cache["slot_pos"][i, s % t] = s
        cache["pos"] = pos
        tokens = torch.randint(0, cfg.vocab_size, (b,), generator=gen)
        ref_cache = tree_map(torch.clone, cache)
        want, ref_cache = tfm.decode_step(params, cfg, ref_cache, tokens)
        c_sh = shd.kv_cache_shardings(cache, mesh)
        dcache = shd.distribute(cache, c_sh)
        with shd.axis_rules(mesh):
            got, dcache = tfm.decode_step(
                shd.distribute(params, shd.param_shardings(params, mesh)),
                cfg, dcache,
                shd.distribute({"t": tokens}, shd.batch_shardings(
                    {"t": tokens}, mesh, {"t": ("batch",)}))["t"])
        res[f"decode_kv{n_kv}"] = (
            [want] + [ref_cache[k] for k in ("k", "v", "slot_pos", "pos")],
            [_full(got)] + [_full(dcache[k]) for k in ("k", "v", "slot_pos",
                                                      "pos")],
            tuple(c_sh["k"].spec))
    if rank == 0:
        torch.save(res, out)


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()) / max(
        1.0, float(want.float().abs().max()))


def test_sharded_ops_match_unsharded_on_4_ranks(tmp_path):
    run_ranks(_rank_body, 4, tmp_path, tmp_path / "out.pt")
    res = torch.load(tmp_path / "out.pt", weights_only=False)
    for name in ("gcn-cora", "pna", "equiformer-v2", "fm"):
        (loss, grads), (s_loss, s_grads) = res[name]
        assert _rel(s_loss, loss) <= TOL, name
        assert len(grads) == len(s_grads)
        assert max(_rel(g, w) for g, w in zip(s_grads, grads)) <= TOL, (
            name, [_rel(g, w) for g, w in zip(s_grads, grads)])
        assert max(float(g.abs().max()) for g in grads) > 0
    # 2 kv heads divide the model axis; 1 does not: the sequence shards
    assert res["decode_kv2"][2] == (None, "data", None, "model", None)
    assert res["decode_kv1"][2] == (None, "data", "model", None, None)
    for n_kv in (2, 1):
        want, got, _ = res[f"decode_kv{n_kv}"]
        for w, g in zip(want, got):
            assert g.shape == w.shape
            assert _rel(g, w) <= TOL, n_kv
