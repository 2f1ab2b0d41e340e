"""The port's checkpoints: atomicity, retention, async, and the layout
shared with the JAX reference.

A checkpoint written by ``repro.checkpoint`` is restored by the port and
one written by the port is restored by ``repro.checkpoint``; each leaf
must come back with its dtype and shape and bitwise equal values (a bf16
leaf as the reference's ``.npy`` holds it, raw 2-byte words).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.training import init_state as j_init_state
from repro.training import make_optimizer as j_make_optimizer
from repro.training import schedule as jsched
from repro.core import interaction_net as jinet
from repro_torch import bridge
from repro_torch.checkpoint import CheckpointManager
from repro_torch.common.tree import tree_leaves


def _jax_state(opt_name):
    opt = j_make_optimizer(opt_name, jsched.constant(1e-3))
    cfg = jinet.JediNetConfig(fr_hidden=(8,), fo_hidden=(8,),
                              phi_hidden=(8,))
    state = j_init_state(jax.random.PRNGKey(0),
                         lambda k: jinet.init(k, cfg), opt)
    # non-zero optimizer state, so a mixed-up leaf cannot pass as zeros
    return jax.tree_util.tree_map(
        lambda a: a + 0.25 if jnp.issubdtype(a.dtype, jnp.floating) else a + 7,
        state)


def _same_leaves(torch_tree, jax_tree):
    t = tree_leaves(torch_tree)
    j = jax.tree_util.tree_leaves(jax_tree)
    assert len(t) == len(j)
    for a, b in zip(t, j):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
        np.testing.assert_array_equal(a.float().numpy() if a.dtype ==
                                      torch.bfloat16 else a.numpy(),
                                      b.astype(np.float32) if b.dtype.name
                                      == "bfloat16" else b)


def test_checkpoint_atomicity_and_retention(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep_last=2)
    tree = {"a": torch.arange(10), "b": [torch.ones((2, 2)),
                                         {"c": torch.zeros(3)}]}
    for s in (1, 2, 3, 4):
        cm.save(s, tree)
    assert cm.all_steps() == [3, 4]
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]
    # a stale tmp dir of a save that died is not a checkpoint, and the
    # next save of that step replaces it
    os.makedirs(tmp_path / "step_00000005.tmp")
    assert cm.latest_step() == 4
    cm.save(5, tree)
    assert cm.all_steps() == [4, 5]
    restored, step = cm.restore(device="cpu")
    assert step == 5
    np.testing.assert_array_equal(restored["a"].numpy(), np.arange(10))
    np.testing.assert_array_equal(restored["b"][1]["c"].numpy(), np.zeros(3))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(device="cpu")


def test_checkpoint_async_then_sync(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    tree = {"w": torch.ones((128, 128))}
    cm.save_async(10, tree)
    cm.wait()
    r, s = cm.restore(device="cpu")
    assert s == 10
    assert float(r["w"].sum()) == 128 * 128


def test_save_async_snapshots_before_it_returns(tmp_path):
    """The optimizer updates params in place: what ``save_async`` writes
    is the tree as it was when the call returned."""
    cm = CheckpointManager(str(tmp_path))
    w = torch.ones((512, 512))
    cm.save_async(1, {"w": w})
    w.mul_(3.0)                       # an in-place update right after
    cm.wait()
    r, _ = cm.restore(device="cpu")
    assert float(r["w"].max()) == 1.0


def test_restore_to_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, {"w": torch.ones(2)})
    with pytest.raises(RuntimeError, match="cuda"):
        cm.restore()


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_jax_written_checkpoint_restores_in_the_port(tmp_path, opt_name):
    state = _jax_state(opt_name)
    JaxCheckpointManager(str(tmp_path)).save(3, state)
    restored, step = CheckpointManager(str(tmp_path)).restore(device="cpu")
    assert step == 3
    assert set(restored) == {"params", "opt", "step"}
    assert restored["step"].dtype == torch.int32
    assert restored["step"].dim() == 0
    _same_leaves(restored, state)
    # the same state through the bridge, leaf for leaf
    _same_leaves(bridge.state_from_jax(
        jax.tree_util.tree_map(np.asarray, state), device="cpu"), state)


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_port_written_checkpoint_restores_in_the_reference(tmp_path,
                                                           opt_name):
    state = _jax_state(opt_name)
    port_state = bridge.state_from_jax(
        jax.tree_util.tree_map(np.asarray, state), device="cpu")
    CheckpointManager(str(tmp_path)).save(7, port_state)
    restored, step = JaxCheckpointManager(str(tmp_path)).restore()
    assert step == 7
    _same_leaves(port_state, restored)
    _same_leaves(port_state, state)
    np.testing.assert_array_equal(
        np.asarray(jax.tree_util.tree_leaves(bridge.state_to_numpy(
            port_state))[0]), np.asarray(jax.tree_util.tree_leaves(state)[0]))


def test_bf16_leaves_keep_the_reference_layout(tmp_path):
    """bf16 travels as raw 2-byte words with "bfloat16" in the manifest,
    as the reference writes it; each side reads the other's bits."""
    vals = np.asarray([0.0, 1.5, -3.25, 65504.0, 1e-3], np.float32)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    JaxCheckpointManager(str(jdir)).save(1, {"h": jnp.asarray(vals,
                                                              jnp.bfloat16)})
    r, _ = CheckpointManager(str(jdir)).restore(device="cpu")
    want = torch.from_numpy(vals).to(torch.bfloat16)
    assert r["h"].dtype == torch.bfloat16 and torch.equal(r["h"], want)

    CheckpointManager(str(tdir)).save(1, {"h": want})
    with open(tdir / "step_00000001" / "manifest.json") as f:
        meta = json.load(f)["leaves"]["h"]
    assert meta["dtype"] == "bfloat16"
    ours = np.load(tdir / "step_00000001" / "h.npy")
    theirs = np.load(jdir / "step_00000001" / "h.npy")
    assert ours.dtype.kind == theirs.dtype.kind == "V"
    assert ours.tobytes() == theirs.tobytes()
    jr, _ = JaxCheckpointManager(str(tdir)).restore()
    np.testing.assert_array_equal(
        np.asarray(jr["h"]).view(np.uint16),
        want.view(torch.int16).numpy().view(np.uint16))
