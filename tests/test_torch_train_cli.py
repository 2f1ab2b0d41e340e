"""The port's train CLI and training examples on the CPU.

``python -m repro_torch.launch.train --device cpu`` survives an injected
crash and resumes from its checkpoint (the reference's
``tests/test_multidevice.py`` case at its sizes), checkpoints on
SIGTERM, and refuses ``cuda`` without a card; the GNN family names the
ROADMAP item it waits for (the LM family's program is held against the
reference in ``tests/test_torch_lm_training.py``).  The examples run at a handful of
steps; a checkpoint written by the reference's train CLI continues in
the port's example.
"""

import os
import pathlib
import signal
import subprocess
import sys

import pytest
import torch

from repro_torch.launch import train as ttrain

REPO = pathlib.Path(__file__).resolve().parent.parent


def _env():
    # two threads: the runs are small, and the suite runs beside tests
    # whose collectives wait on every core (tests/test_multidevice.py)
    return dict(os.environ, PYTHONPATH=str(REPO / "src"),
                CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")


def _cli(*args):
    return [sys.executable, "-m", "repro_torch.launch.train", "--device",
            "cpu", "--arch", "jedinet-30p", *args]


def test_train_cli_crash_restart(tmp_path):
    """Injected crash at step 30; the restart resumes from the step-25
    checkpoint and finishes."""
    cmd = _cli("--steps", "60", "--batch", "32", "--ckpt-dir",
               str(tmp_path), "--ckpt-every", "25")
    r1 = subprocess.run(cmd + ["--fail-at-step", "30"], capture_output=True,
                        text=True, timeout=300, cwd=REPO, env=_env())
    assert r1.returncode != 0
    assert "injected failure" in r1.stderr
    assert "step_00000025" in os.listdir(tmp_path)
    r2 = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                        cwd=REPO, env=_env())
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "restored checkpoint at step 25" in r2.stdout
    assert "final checkpoint at step 60" in r2.stdout
    assert "ms/step" in r2.stdout and "host clock" in r2.stdout


def test_train_cli_checkpoints_on_sigterm(tmp_path):
    proc = subprocess.Popen(
        _cli("--steps", "100000", "--batch", "16", "--log-every", "1",
             "--ckpt-dir", str(tmp_path), "--ckpt-every", "100000"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env=_env())
    try:
        for line in proc.stdout:
            if line.startswith("[train] step 2 "):
                break
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        proc.kill()
    assert proc.returncode == 143, err[-2000:]
    assert "preempted; checkpointing step" in out
    steps = [d for d in os.listdir(tmp_path) if d.startswith("step_")]
    assert len(steps) == 1 and not steps[0].endswith(".tmp")


def test_train_cli_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.main(["--arch", "jedinet-30p", "--steps", "1"])


@pytest.mark.parametrize("arch,item", [
    ("gcn-cora", "item 10"), ("equiformer-v2", "item 10")])
def test_lm_and_gnn_families_wait_for_their_roadmap_items(arch, item):
    with pytest.raises(NotImplementedError, match=item):
        ttrain.make_program(arch, 8, 1e-3, "cpu")
    with pytest.raises(KeyError, match="unknown arch"):
        ttrain.make_program("no-such-arch", 8, 1e-3, "cpu")


def test_fm_program_trains_a_narrow_table(monkeypatch):
    """The recsys program's pieces at a narrow width: AdamW without
    decay over ``ctr_batches``; the loss is finite and the table moves."""
    import dataclasses
    from repro_torch.configs import fm
    from repro_torch.training import init_state

    monkeypatch.setattr(fm, "ARCH", dataclasses.replace(
        fm.ARCH, model=dataclasses.replace(
            fm.MODEL, vocab_sizes=tuple(min(s, 100)
                                        for s in fm.MODEL.vocab_sizes))))
    init_fn, step_fn, batches, opt = ttrain.make_program("fm", 64, 1e-2,
                                                         "cpu")
    assert opt.name == "adamw"
    state = init_state(0, init_fn, opt)
    before = state["params"]["tables"]["rows"].clone()
    for _ in range(3):
        state, m = step_fn(state, ttrain.to_device(next(batches),
                                                   torch.device("cpu")))
    assert torch.isfinite(m["loss"]) and int(state["step"]) == 3
    assert not torch.equal(before, state["params"]["tables"]["rows"])


def test_prefetch_stops_its_thread_when_closed():
    import itertools
    import threading
    it = ttrain.prefetch(itertools.count(), depth=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    before = threading.active_count()
    it.close()
    for _ in range(50):
        if threading.active_count() < before:
            break
        threading.Event().wait(0.05)
    assert threading.active_count() < before


def test_codesign_search_trains_three_designs_on_the_cpu(capsys):
    from repro.core import codesign as jcodesign
    from repro.core import interaction_net as jinet
    from repro_torch.examples import codesign_search

    out = codesign_search.main(["--steps", "3", "--device", "cpu"])
    assert list(out) == ["J1-baseline", "Opt-Latn", "Opt-Acc"]
    ref = jcodesign.explore(jinet.JediNetConfig(n_objects=30, n_features=16),
                            latency_budget_us=1.0, alpha=2.0)
    for name, key in (("Opt-Latn", "opt_latn"), ("Opt-Acc", "opt_acc")):
        assert tuple(out[name]["fr_hidden"]) == tuple(ref[key].cfg.fr_hidden)
        assert out[name]["latency_us"] == ref[key].fpga["latency_us"]
    for row in out.values():
        assert 0.0 <= row["accuracy"] <= 1.0
    assert "Opt-Acc" in capsys.readouterr().out


def test_jax_checkpoint_continues_in_the_port_example(tmp_path, capsys):
    from repro.launch import train as jtrain
    from repro_torch.examples import train_jedinet

    jtrain.main(["--arch", "jedinet-30p", "--steps", "6", "--batch", "16",
                 "--lr", "2e-3", "--ckpt-dir", str(tmp_path)])
    out = train_jedinet.main(["--steps", "8", "--batch", "16", "--device",
                              "cpu", "--ckpt-dir", str(tmp_path)])
    printed = capsys.readouterr().out
    assert "restored checkpoint at step 6" in printed
    assert "final checkpoint at step 8" in printed
    assert "held-out accuracy at step 8" in printed
    assert int(out["state"]["step"]) == 8
    assert 0.0 <= out["accuracy"] <= 1.0


def test_jedi_program_starts_from_the_references_init():
    """The train program's JEDI-net init at seed 0 is the reference's
    ``init(jax.random.PRNGKey(0), cfg)`` within 4 ulps (``common/prng``),
    so a run is comparable to the reference's at the same seed."""
    import jax
    import numpy as np
    from repro.configs import jedi_30p
    from repro.core import interaction_net as jinet
    from repro_torch.common.tree import tree_leaves

    init_fn, *_ = ttrain.make_program("jedinet-30p", 8, 1e-3, "cpu")
    got = tree_leaves(init_fn(0))
    want = jax.tree_util.tree_leaves(
        jinet.init(jax.random.PRNGKey(0), jedi_30p.MODEL))
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        ulps = np.abs(a.numpy().view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max()
        assert ulps <= 4
