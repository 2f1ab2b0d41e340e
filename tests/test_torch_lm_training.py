"""LM training in the port on the CPU: ``data/lm_data.py`` against the
reference's arrays, the ``lm`` program of ``launch/train.py`` against
the reference's ``make_program`` (Adafactor; WSD for minicpm-2b,
warmup-cosine otherwise) from one state, the train CLI at a tiny width
and an ``lm`` state through a checkpoint.

The archs run at ``tiny_config`` (2 layers, d_model 128, fp32 compute,
the arch's own MoE): the test swaps each arch module's ``ARCH`` for its
tiny version in both packages, so both ``make_program``s build what they
build at full width, only narrower.

Bars: ``lm_batches`` arrays exactly; the losses of 4 train steps from
one state within 1e-5 of their size for the dense LMs (the forward's
fp32 gap is ~1e-7; Adafactor's first update is ~lr x sign(g), so an
entry whose gradient is at the noise level may step the other way,
which moves the loss only at second order) and 1e-4 for moonshot (such
an entry of the router may also move one token's top-k choice where its
margin is that thin, and that token's share of the mean loss with it).
Measured: every gap within 1.6e-7 of the loss.
"""

import dataclasses
import importlib

import jax
import numpy as np
import pytest
import torch

from repro.data import lm_data as jdata
from repro.launch import train as jtrain
from repro.serving.lm import tiny_config as jtiny
from repro.training import init_state as j_init_state
from repro_torch import bridge
from repro_torch.checkpoint import CheckpointManager
from repro_torch.common.tree import tree_leaves
from repro_torch.data import lm_data as tdata
from repro_torch.launch import train as ttrain
from repro_torch.serving.lm import tiny_config as ttiny

MODULES = {"h2o-danube-1.8b": "h2o_danube_1_8b", "minicpm-2b": "minicpm_2b",
           "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b"}
TOL = {"h2o-danube-1.8b": 1e-5, "minicpm-2b": 1e-5,
       "moonshot-v1-16b-a3b": 1e-4}


@pytest.fixture
def tiny(monkeypatch):
    """Swap the named archs' ``ARCH`` for their ``tiny_config`` in both
    packages."""
    def swap(arch_id):
        for pkg, shrink in (("repro", jtiny), ("repro_torch", ttiny)):
            mod = importlib.import_module(
                f"{pkg}.configs.{MODULES[arch_id]}")
            monkeypatch.setattr(mod, "ARCH", dataclasses.replace(
                mod.ARCH, model=shrink(mod.ARCH.model)))
    return swap


@pytest.mark.parametrize("seed,batch,seq,vocab", [
    (0, 2, 256, 512), (3, 5, 17, 32000), (7, 1, 64, 163840)])
def test_lm_batches_equal_the_reference(seed, batch, seq, vocab):
    gj = jdata.lm_batches(seed, batch, seq, vocab)
    gt = tdata.lm_batches(seed, batch, seq, vocab)
    for _ in range(3):
        a, b = next(gj), next(gt)
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(jdata._bigram_table(vocab),
                                  tdata._bigram_table(vocab))


@pytest.mark.parametrize("arch_id", list(MODULES))
def test_lm_program_steps_match_the_reference(arch_id, tiny):
    """Both ``make_program``s at batch 2 x 256 tokens, lr 0.05 (the
    warmup makes it 0, 1e-3, 2e-3, 3e-3 over the 4 steps), from the
    reference's initial state carried across: the same optimizer and
    schedule, the same batches, and losses within the bar."""
    tiny(arch_id)
    j_init, j_step, j_batches, j_opt = jtrain.make_program(arch_id, 2, 0.05)
    t_init, t_step, t_batches, t_opt = ttrain.make_program(arch_id, 2, 0.05,
                                                           "cpu")
    assert t_opt.name == "adafactor" == j_opt.name
    js = j_init_state(jax.random.PRNGKey(0), j_init, j_opt)
    ts = bridge.state_from_jax(jax.tree_util.tree_map(np.asarray, js),
                               device="cpu")
    j_step = jax.jit(j_step)
    jl, tl, lrs = [], [], []
    for _ in range(4):
        jb, tb = next(j_batches), next(t_batches)
        np.testing.assert_array_equal(jb["tokens"], tb["tokens"])
        js, jm = j_step(js, jax.tree_util.tree_map(jax.numpy.asarray, jb))
        ts, tm = t_step(ts, ttrain.to_device(tb, torch.device("cpu")))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        lrs.append((float(jm["lr"]), float(tm["lr"])))
        assert float(tm["aux"]) == pytest.approx(float(jm["aux"]), rel=TOL[
            arch_id], abs=1e-7)
    for a, b in lrs:
        assert b == pytest.approx(a, rel=1e-6)
    assert lrs[-1][1] > 0
    for a, b in zip(jl, tl):
        assert abs(a - b) <= TOL[arch_id] * abs(a), (jl, tl)
    assert int(ts["step"]) == 4
    if arch_id == "moonshot-v1-16b-a3b":
        assert float(tm["aux"]) > 0


def test_minicpm_trains_on_wsd_and_the_others_on_warmup_cosine(tiny):
    from repro_torch.training.schedule import warmup_cosine, wsd
    for arch_id, sched in (("minicpm-2b", wsd), ("h2o-danube-1.8b",
                                                 warmup_cosine)):
        tiny(arch_id)
        opt = ttrain.make_program(arch_id, 2, 1e-3, "cpu")[3]
        want = sched(1e-3, 50, 5000)
        params = {"w": torch.zeros((2, 2))}
        for step in (0, 49, 4950, 4999):
            lr = opt.update({"w": torch.ones((2, 2))}, opt.init(params),
                            params, torch.tensor(step))[2]["lr"]
            assert float(lr) == float(want(step))
    assert float(wsd(1e-3, 50, 5000)(4999)) \
        != float(warmup_cosine(1e-3, 50, 5000)(4999))


def test_train_cli_trains_an_lm_and_checkpoints_it(tiny, tmp_path):
    """``python -m repro_torch.launch.train --arch h2o-danube-1.8b
    --device cpu`` at the tiny width: finite losses, and its final
    checkpoint restores the state bitwise."""
    tiny("h2o-danube-1.8b")
    res = ttrain.main(["--arch", "h2o-danube-1.8b", "--device", "cpu",
                       "--steps", "3", "--batch", "2", "--log-every", "1",
                       "--ckpt-dir", str(tmp_path)])
    assert res["steps"] == 3 and len(res["history"]) == 3
    assert all(np.isfinite(m["loss"]) for _, m in res["history"])
    state, step = CheckpointManager(str(tmp_path)).restore(device="cpu")
    assert step == 3
    a, b = tree_leaves(state), tree_leaves(res["state"])
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
