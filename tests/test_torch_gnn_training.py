"""GNN training in the port on the CPU: the ``gnn`` program of
``launch/train.py`` against the reference's ``make_program`` from one
state, the train CLI at gcn-cora's full width, and a GNN state through a
checkpoint that the reference restores too.

The program comparison runs each arch at ``test_gnn_smoke``'s reduction
(2 layers, width 16, l_max <= 2, m_max <= 1, heads <= 2) on the
program's own 4,096-node, 16,384-edge, 64-feature graph: the test swaps
each arch module's ``ARCH`` for the narrow one in both packages, so both
``make_program``s build what they build at full width, only narrower.

Bars: the program's graph exactly; the losses of 4 AdamW steps from one
state within 1e-5 of their size (the forward's fp32 gap is ~1e-7; AdamW's
first updates are ~lr x sign(g), so an entry whose gradient is at the
noise level, such as the attention MLP's last bias that the segment
softmax ignores, may step the other way and moves the loss only at
second order); the learning rates within 1e-6.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.launch import train as jtrain
from repro.training import init_state as j_init_state
from repro_torch import bridge
from repro_torch.checkpoint import CheckpointManager
from repro_torch.common.tree import tree_leaves
from repro_torch.launch import train as ttrain

MODULES = {"gcn-cora": "gcn_cora", "pna": "pna",
           "meshgraphnet": "meshgraphnet", "equiformer-v2": "equiformer_v2"}
CPU = torch.device("cpu")


def _narrow(cfg):
    return dataclasses.replace(cfg, n_layers=2, d_hidden=16,
                               l_max=min(cfg.l_max, 2),
                               m_max=min(cfg.m_max, 1),
                               n_heads=min(cfg.n_heads, 2) or 1)


@pytest.fixture
def narrow(monkeypatch):
    """Swap the named arch's ``ARCH`` for its narrow version in both
    packages."""
    def swap(arch_id):
        for pkg in ("repro", "repro_torch"):
            mod = importlib.import_module(
                f"{pkg}.configs.{MODULES[arch_id]}")
            monkeypatch.setattr(mod, "ARCH", dataclasses.replace(
                mod.ARCH, model=_narrow(mod.ARCH.model)))
    return swap


@pytest.mark.parametrize("arch_id", list(MODULES))
def test_gnn_program_steps_match_the_reference(arch_id, narrow):
    """Both ``make_program``s at lr 0.05 (the warmup makes it 0, 1e-3,
    2e-3, 3e-3 over the 4 steps), from the reference's initial state
    carried across: the same graph every step, the same optimizer and
    schedule, losses and metrics within the bar; and the port's
    ``init_fn(0)`` is the reference's init at ``PRNGKey(0)``."""
    narrow(arch_id)
    j_init, j_step, j_batches, j_opt = jtrain.make_program(arch_id, 256,
                                                           0.05)
    t_init, t_step, t_batches, t_opt = ttrain.make_program(arch_id, 256,
                                                           0.05, "cpu")
    assert t_opt.name == "adamw" == j_opt.name
    js = j_init_state(jax.random.PRNGKey(0), j_init, j_opt)
    for a, b in zip(jax.tree_util.tree_leaves(js["params"]),
                    tree_leaves(t_init(0))):
        a = np.asarray(a)
        ulps = np.abs(a.view(np.int32).astype(np.int64)
                      - b.numpy().view(np.int32).astype(np.int64)).max()
        assert ulps <= 4
    ts = bridge.state_from_jax(jax.tree_util.tree_map(np.asarray, js),
                               device="cpu")
    j_step = jax.jit(j_step)
    jl, tl = [], []
    for _ in range(4):
        jb, tb = next(j_batches), next(t_batches)
        assert sorted(jb) == sorted(tb)
        for k in jb:
            np.testing.assert_array_equal(jb[k], tb[k])
        js, jm = j_step(js, {k: jnp.asarray(v) for k, v in jb.items()})
        ts, tm = t_step(ts, ttrain.to_device(tb, CPU))
        assert sorted(tm) == sorted(jm)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        metric = "accuracy" if "accuracy" in jm else "mse"
        assert abs(float(tm[metric]) - float(jm[metric])) <= 1e-5 * max(
            1.0, abs(float(jm[metric])))
    assert float(tm["lr"]) > 0
    for a, b in zip(jl, tl):
        assert abs(a - b) <= 1e-5 * abs(a), (jl, tl)
    assert tl[-1] < tl[0]
    assert int(ts["step"]) == 4


def test_program_graphs_equal_the_references():
    """The graph each arch trains on: ``community_graph(0, 4096, 16384,
    64)`` with the arch's classes, and ``pos`` / regression targets from
    ``RandomState(1)`` for meshgraphnet and equiformer-v2."""
    for arch_id in MODULES:
        jb = next(jtrain.make_program(arch_id, 256, 1e-3)[2])
        tb = next(ttrain.make_program(arch_id, 256, 1e-3, "cpu")[2])
        assert sorted(jb) == sorted(tb)
        for k in jb:
            assert jb[k].dtype == tb[k].dtype
            np.testing.assert_array_equal(jb[k], tb[k])
        assert tb["x"].shape == (4096, 64)
        assert tb["senders"].shape == (16384,)
        assert ("pos" in tb) == (arch_id in ("meshgraphnet", "equiformer-v2"))


def test_train_cli_trains_gcn_cora_at_full_width(tmp_path):
    """``python -m repro_torch.launch.train --arch gcn-cora --device cpu
    --steps 5`` at the config's full width (2 x 16): its first loss is the
    reference's at ``PRNGKey(0)`` within 1e-5, the losses fall, and its
    final checkpoint restores the state bitwise in the port and equal in
    the reference."""
    res = ttrain.main(["--arch", "gcn-cora", "--device", "cpu", "--steps",
                       "5", "--log-every", "1", "--ckpt-dir", str(tmp_path)])
    hist = [m for _, m in res["history"]]
    assert res["steps"] == 5 and len(hist) == 5
    assert all(np.isfinite(m["loss"]) for m in hist)
    assert hist[-1]["loss"] < hist[0]["loss"]
    j_init, j_step, j_batches, j_opt = jtrain.make_program("gcn-cora", 256,
                                                           1e-3)
    js = j_init_state(jax.random.PRNGKey(0), j_init, j_opt)
    _, jm = jax.jit(j_step)(js, {k: jnp.asarray(v)
                                 for k, v in next(j_batches).items()})
    assert abs(hist[0]["loss"] - float(jm["loss"])) <= 1e-5 * float(jm["loss"])

    state, step = CheckpointManager(str(tmp_path)).restore(device="cpu")
    assert step == 5
    a, b = tree_leaves(state), tree_leaves(res["state"])
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    jstate, jstep = JaxCheckpointManager(str(tmp_path)).restore()
    assert jstep == 5
    assert jax.tree_util.tree_structure(jax.tree_util.tree_map(
        np.asarray, jstate)) == jax.tree_util.tree_structure(
        bridge.state_to_numpy(res["state"]))
    for x, y in zip(jax.tree_util.tree_leaves(jstate), b):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


@pytest.mark.parametrize("arch_id", ["gcn-cora", "equiformer-v2"])
def test_train_cli_refuses_cuda_without_a_card_for_a_gnn(arch_id):
    """Without ``--device cpu`` the GNN program runs on the card, and
    raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.main(["--arch", arch_id, "--steps", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.make_program(arch_id, 256, 1e-3)


def test_equiformer_state_round_trips_through_a_checkpoint(tmp_path):
    """A narrow equiformer-v2 train state (nested lists of dicts, the
    (l_max+1, C, C) per-l leaves, AdamW's moments) saved by the port is
    restored bitwise by the port and by the reference."""
    from repro_torch.configs.base import GNNConfig
    from repro_torch.models.gnn import equiformer_v2 as teq
    from repro_torch.training import init_state, make_optimizer
    from repro_torch.common import prng
    cfg = GNNConfig(name="eq", kind="equiformer_v2", n_layers=2,
                    d_hidden=8, n_classes=1, l_max=6, m_max=2, n_heads=2,
                    activation="silu")
    opt = make_optimizer("adamw", 1e-3)
    state = init_state(0, lambda s: teq.init(prng.key(s), cfg, 5, 1,
                                             device="cpu"), opt)
    CheckpointManager(str(tmp_path)).save(3, state)
    restored, step = CheckpointManager(str(tmp_path)).restore(device="cpu")
    assert step == 3
    a, b = tree_leaves(restored), tree_leaves(state)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    assert restored["params"]["gnn_layers"][1]["proj"]["w"].shape == (7, 8, 8)
    jstate, _ = JaxCheckpointManager(str(tmp_path)).restore()
    for x, y in zip(jax.tree_util.tree_leaves(jstate), b):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
