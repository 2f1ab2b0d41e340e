"""Training state across ranks, on multi-process CPU ``gloo`` groups.

Counterparts of ``tests/test_multidevice.py``'s
``test_ef_compressed_psum_convergence`` and
``test_elastic_checkpoint_restore_across_meshes``: the int8
error-feedback all-reduce (``training/grad_compression.py``) on 4 ranks,
against the reference with its axis bound by ``vmap`` and on the
reference's quadratic problem; and a checkpoint saved from a 2 x 2
``DeviceMesh`` restored onto a 2-shard mesh
(``checkpoint.CheckpointManager.restore(shardings=...)``).

Each test runs one group of 4 ranks (``torch_ranks``): the inputs are
made here from seeds and written under ``tmp_path``, the ranks write
their results back, and the comparisons run here.
"""

import jax
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard

from repro.training import grad_compression as jgc
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import checkpoint as ckpt_mod
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.parallel import sharding as shd
from repro_torch.training import grad_compression as tgc
from torch_ranks import run_ranks


# --- the int8 error-feedback all-reduce --------------------------------------

def _rank_ef_psum(rank, world, inp, out_dir):
    grads = torch.load(inp)                   # [step][rank] trees
    resid = tree_map(torch.zeros_like, grads[0][rank])
    outs = []
    for g in grads:
        mean, resid = tgc.ef_compressed_psum(g[rank], resid)
        outs.append((mean, resid))
    torch.save(outs, out_dir / f"rank{rank}.pt")


def test_ef_compressed_psum_matches_the_reference_on_4_ranks(tmp_path):
    """Per-rank grads and residuals over 3 steps give the reference's
    result with its axis bound by ``vmap`` over 4, at 1e-6 of each leaf's
    largest magnitude."""
    world, rng = 4, np.random.RandomState(8)
    grads = [[{"w": rng.normal(0, 1, (33, 7)).astype(np.float32),
               "b": [rng.normal(0, 1e-3, (5,)).astype(np.float32)]}
              for _ in range(world)] for _ in range(3)]
    torch.save([[tree_map(torch.from_numpy, g) for g in step]
                for step in grads], tmp_path / "in.pt")
    run_ranks(_rank_ef_psum, world, tmp_path, tmp_path / "in.pt", tmp_path)

    jfn = jax.jit(jax.vmap(lambda g, r: jgc.ef_compressed_psum(g, r, "d"),
                           axis_name="d"))
    jr = jax.tree_util.tree_map(
        lambda a: np.zeros((world,) + a.shape, np.float32), grads[0][0])
    got = [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]
    for i, step in enumerate(grads):
        stacked = jax.tree_util.tree_map(lambda *a: np.stack(a), *step)
        jm, jr = jfn(stacked, jr)
        for rank in range(world):
            for mine, want in zip(got[rank][i], (jm, jr)):
                for a, w, g in zip(tree_leaves(mine),
                                   jax.tree_util.tree_leaves(want),
                                   jax.tree_util.tree_leaves(stacked)):
                    np.testing.assert_allclose(
                        a.numpy(), np.asarray(w)[rank], rtol=0,
                        atol=1e-6 * float(np.abs(g).max()))


def _rank_ef_converge(rank, world, inp, out):
    target, xs_all = torch.load(inp)
    xs = xs_all.chunk(world)[rank]

    def local_grad(w):
        w = w.detach().requires_grad_(True)
        loss = ((xs @ w - xs @ target) ** 2).mean()
        return torch.autograd.grad(loss, w)[0]

    wq, we = torch.zeros(32), torch.zeros(32)
    resid = {"g": torch.zeros(32)}
    for _ in range(80):
        ge = local_grad(we)
        dist.all_reduce(ge)
        we = we - 0.1 * ge / world
        gq, resid = tgc.ef_compressed_psum({"g": local_grad(wq)}, resid)
        wq = wq - 0.1 * gq["g"]
    if rank == 0:
        torch.save({"exact": float((we - target).norm()),
                    "quant": float((wq - target).norm())}, out)


def test_ef_compressed_psum_converges_on_4_ranks(tmp_path):
    """The reference's quadratic test with 4 shards: int8 data-parallel
    training with error feedback tracks exact data-parallel training."""
    rng = np.random.RandomState(0)
    target = torch.from_numpy(rng.normal(size=(32,)).astype(np.float32))
    xs = torch.from_numpy(rng.normal(size=(64, 32)).astype(np.float32))
    torch.save((target, xs), tmp_path / "in.pt")
    run_ranks(_rank_ef_converge, 4, tmp_path, tmp_path / "in.pt",
              tmp_path / "out.pt")
    r = torch.load(tmp_path / "out.pt")
    assert r["exact"] < 1.0
    assert r["quant"] < 2.0 * r["exact"] + 0.1


# --- elastic restore ---------------------------------------------------------

def _rank_elastic(rank, world, ckpt_dir, out):
    counts = {"host": 0, "write": 0}
    to_host, write = ckpt_mod._to_host, CheckpointManager._write

    def counted_to_host(leaf):
        counts["host"] += 1
        return to_host(leaf)

    def counted_write(self, *a):
        counts["write"] += 1
        return write(self, *a)

    ckpt_mod._to_host = counted_to_host
    CheckpointManager._write = counted_write
    w = torch.arange(4 * 64 * 64, dtype=torch.float32).reshape(4, 64, 64)
    params = {"layers": {"attn": {"wq": {"w": w}}}}
    from torch.distributed.device_mesh import init_device_mesh
    mesh_a = init_device_mesh("cpu", (2, 2),
                              mesh_dim_names=("data", "model"))
    p_a = shd.distribute(params, shd.param_shardings(params, mesh_a))
    cm = CheckpointManager(str(ckpt_dir))
    cm.save(3, {"params": p_a, "step": torch.tensor(3)})
    saved_counts = dict(counts)
    # "lose the model axis": restore onto the 1-D data sub-mesh
    mesh_b = mesh_a["data"]
    sh_b = shd.param_shardings(params, mesh_b)
    restored, step = cm.restore(device="cpu",
                                shardings={"params": sh_b, "step": None})
    got = restored["params"]["layers"]["attn"]["wq"]["w"]
    try:
        cm.save_async(4, {"params": restored["params"]})
        refused = False
    except ValueError:
        refused = True
    res = {"step": step, "ok": torch.equal(got.full_tensor(), w),
           "async_refused": refused,
           "placements_a": tuple(
               p_a["layers"]["attn"]["wq"]["w"].placements),
           "placements": tuple(got.placements),
           "mesh_size": got.device_mesh.size(),
           "local": tuple(got.to_local().shape),
           "step_leaf": int(restored["step"])}
    torch.save(saved_counts, out.parent / f"counts{rank}.pt")
    if rank == 0:
        torch.save(res, out)


def test_elastic_restore_from_a_2x2_mesh_onto_a_2_shard_mesh(tmp_path):
    """Saved sharded on a 2 x 2 mesh, restored onto the 1-D ``data``
    sub-mesh (2 shards): the values equal, the step restored, the leaf
    sharded over the 2 ranks; only rank 0 copied the leaves to host
    memory and wrote them; ``save_async`` refuses a sharded tree."""
    run_ranks(_rank_elastic, 4, tmp_path, tmp_path / "ckpt",
              tmp_path / "out.pt")
    r = torch.load(tmp_path / "out.pt")
    assert r["placements_a"] == (Shard(1), Shard(2))
    assert r["step"] == 3 and r["step_leaf"] == 3
    assert r["ok"] and r["async_refused"]
    assert r["mesh_size"] == 2
    assert r["placements"] == (Shard(1),)
    assert r["local"] == (4, 32, 64)
    counts = [torch.load(tmp_path / f"counts{k}.pt") for k in range(4)]
    assert counts[0] == {"host": 2, "write": 1}
    assert all(c == {"host": 0, "write": 0} for c in counts[1:])
