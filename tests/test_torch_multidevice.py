"""Sharded train steps of the port on a multi-process CPU ``gloo`` group.

Counterpart of ``tests/test_multidevice.py::
test_sharded_train_step_matches_single_device``: one step of
``make_train_step`` on a state placed by ``train_state_shardings`` over a
2 x 2 ``("data", "model")`` ``DeviceMesh`` with the batch placed by
``batch_shardings`` and an ``axis_rules`` context active — JEDI-net
(AdamW; every param replicated, the batch sharded) and a tiny
h2o-danube-1.8b (Adafactor; its weights sharded over both axes by
``param_shardings``, the model's ``constrain`` calls active) — against
the unsharded step of the same state on each rank.

One group of 4 ranks (``torch_ranks``) runs both models: the inputs are
made here, from the reference's init through ``bridge`` or from a seed,
and written under a temporary directory; rank 0 writes its results back;
the comparisons run here.  Sums over 4 ranks run in another order than
on one process, so the sharded results are held against the unsharded
ones at the reference's own bar, 1e-4, never bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.core import interaction_net as jinet
from repro.training import init_state as j_init_state
from repro.training import make_optimizer as j_make_optimizer
from repro.training import make_train_step as j_make_train_step
from repro.training.schedule import constant as jconstant
from repro_torch import bridge
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.configs.registry import get_arch
from repro_torch.core import interaction_net as inet
from repro_torch.models import transformer as tfm
from repro_torch.parallel import sharding as shd
from repro_torch.serving.lm import tiny_config
from repro_torch.training import init_state, make_optimizer, make_train_step
from repro_torch.training.schedule import constant
from torch_ranks import run_ranks

#: The reference's bar for sharded against unsharded
#: (``tests/test_multidevice.py``).
TOL = 1e-4

JEDI_CFG = inet.JediNetConfig(n_objects=8, n_features=4, fr_hidden=(8,),
                              fo_hidden=(8,), phi_hidden=(8,))


def _full(tree):
    """Every DTensor leaf gathered whole (a collective on every rank)."""
    return tree_map(lambda t: t.full_tensor() if hasattr(t, "full_tensor")
                    else t, tree)


def _max_err(a, b) -> float:
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _steps(loss_fn, opt, state, batch, batch_axes, mesh):
    """The unsharded step on a copy of ``state``, and the sharded step."""
    step = make_train_step(loss_fn, opt)
    ref_state, ref_m = step(tree_map(torch.clone, state), batch)
    st = shd.distribute(state, shd.train_state_shardings(state, mesh))
    b = shd.distribute(batch, shd.batch_shardings(batch, mesh, batch_axes))
    with shd.axis_rules(mesh):
        new, m = step(st, b)
    res = {"params": _full(new["params"]), "step": _full(new["step"]),
           "loss": m["loss"].full_tensor(),
           "grad_norm": m["grad_norm"].full_tensor(),
           "ref_params": ref_state["params"], "ref_loss": ref_m["loss"],
           "ref_grad_norm": ref_m["grad_norm"]}
    return st, b, new, res


def _rank_steps(rank, world, inp, out):
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    (jedi_state, jedi_batch), (cfg, lm_state, lm_batch) = torch.load(
        inp, weights_only=False)

    st, b, _, jedi = _steps(
        lambda p, bt: inet.loss_fn(p, JEDI_CFG, bt),
        make_optimizer("adamw", constant(1e-3)), jedi_state, jedi_batch,
        {"x": ("batch", None, None), "y": ("batch",)}, mesh)
    jedi["x_placements"] = tuple(b["x"].placements)
    jedi["p_placements"] = {tuple(t.placements)
                            for t in tree_leaves(st["params"])}

    st, b, new, lm = _steps(
        lambda p, bt: tfm.loss_fn(p, cfg, bt),
        make_optimizer("adafactor", constant(1e-3)), lm_state, lm_batch,
        {"tokens": ("batch", None), "labels": ("batch", None)}, mesh)
    with shd.axis_rules(mesh):
        h, _ = tfm.forward_hidden(new["params"], cfg, b["tokens"])
    lm.update(
        wq=tuple(st["params"]["layers"]["attn"]["wq"]["w"].placements),
        embed=tuple(st["params"]["embed"]["w"].placements),
        acc_r=tuple(st["opt"]["acc"]["layers"]["attn"]["wq"]["w"]["r"]
                    .placements),
        h=tuple(h.placements))
    if rank == 0:
        torch.save({"jedi": jedi, "lm": lm}, out)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """Both models' sharded and unsharded steps, from one 4-rank group;
    and the reference's jitted JEDI-net step from the same state."""
    tmp = tmp_path_factory.mktemp("steps")
    jcfg = jinet.JediNetConfig(n_objects=8, n_features=4, fr_hidden=(8,),
                               fo_hidden=(8,), phi_hidden=(8,))
    jopt = j_make_optimizer("adamw", jconstant(1e-3))
    jstate = j_init_state(jax.random.PRNGKey(0),
                          lambda k: jinet.init(k, jcfg), jopt)
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (16, 8, 4)))
    y = np.zeros((16,), np.int32)
    jnew, jm = jax.jit(j_make_train_step(
        lambda p, b: jinet.loss_fn(p, jcfg, b), jopt))(
        jstate, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    jedi = (bridge.state_from_jax(jstate, device="cpu"),
            {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})

    cfg = tiny_config(get_arch("h2o-danube-1.8b").model)
    lm_state = init_state(0, lambda s: tfm.init(s, cfg, device="cpu"),
                          make_optimizer("adafactor", constant(1e-3)))
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (4, 16)).astype(np.int32))
    lm = (cfg, lm_state, {"tokens": toks, "labels": torch.roll(toks, -1, 1)})

    torch.save((jedi, lm), tmp / "in.pt")
    run_ranks(_rank_steps, 4, tmp, tmp / "in.pt", tmp / "out.pt")
    res = torch.load(tmp / "out.pt")
    res["jax"] = (bridge.params_from_jax(jnew["params"], device="cpu"),
                  float(jm["loss"]))
    return res


def test_sharded_jedinet_train_step_matches_unsharded(steps):
    """An AdamW step on a 2 x 2 mesh == the unsharded step, which == the
    reference's jitted step from the same (bridged) state."""
    r = steps["jedi"]
    want_params, want_loss = steps["jax"]
    # the unsharded step against the reference's
    assert _max_err(r["ref_params"], want_params) < TOL
    assert abs(float(r["ref_loss"]) - want_loss) < TOL
    # the sharded step against the unsharded one
    assert r["x_placements"] == (Shard(0), Replicate())
    assert r["p_placements"] == {(Replicate(), Replicate())}
    assert _max_err(r["params"], r["ref_params"]) < TOL
    assert abs(float(r["loss"]) - float(r["ref_loss"])) < TOL
    assert abs(float(r["grad_norm"]) - float(r["ref_grad_norm"])) \
        < TOL * float(r["ref_grad_norm"])
    assert int(r["step"]) == 1


def test_sharded_transformer_train_step_matches_unsharded(steps):
    """tiny h2o-danube-1.8b, an Adafactor step on a 2 x 2 mesh with its
    weights sharded over both axes and ``constrain`` active, against the
    unsharded step."""
    r = steps["lm"]
    assert r["wq"] == (Shard(1), Shard(2))          # (L, fsdp, w_model)
    assert r["embed"] == (Shard(1), Shard(0))       # (vocab, fsdp)
    assert r["acc_r"] == (Shard(1), Replicate())    # the param spec[:-1]
    assert r["h"] == (Shard(0), Shard(1))           # ("batch", "seq")
    assert _max_err(r["params"], r["ref_params"]) < TOL
    assert abs(float(r["loss"]) - float(r["ref_loss"])) \
        < TOL * float(r["ref_loss"])
    assert abs(float(r["grad_norm"]) - float(r["ref_grad_norm"])) \
        < TOL * float(r["ref_grad_norm"])
    assert int(r["step"]) == 1
