"""End-to-end training CLI with fault tolerance (port of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch jedinet-30p \\
        --steps 300 --batch 512 --ckpt-dir <dir>

Runs on the CUDA card unless ``--device cpu`` is given; asking for
``cuda`` without a card raises.

* **Checkpoint/restart** — async checkpoint every ``--ckpt-every`` steps;
  on start, the latest checkpoint under ``--ckpt-dir`` is restored.
* **Preemption safety** — SIGTERM triggers a final synchronous
  checkpoint before exit.
* **Failure injection** — ``--fail-at-step N`` raises mid-run to
  demonstrate restart-from-checkpoint.
* **Input overlap** — a prefetch thread makes the numpy batches into a
  bounded queue; the main thread copies each to the card from pinned
  memory, without blocking, so the copy queues behind the step before.

The metrics stay on the device and become floats on log steps only;
``main`` returns the final state, the logged metrics and the loop's time
per step (CUDA events on the card, the host clock on the CPU).
"""

from __future__ import annotations

import argparse
import queue
import signal
import sys
import threading
import time

import numpy as np
import torch

from repro_torch import resolve_device


def prefetch(it, depth: int = 2):
    """Bounded-queue background prefetch: the thread draws from ``it``
    (numpy batches) while the caller's steps run."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def worker():
        for item in it:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    pass
            if stop.is_set():
                return

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()


def to_device(batch: dict, device: torch.device) -> dict:
    """numpy batch -> tensors on ``device``; to a card through pinned
    memory with a non-blocking copy."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def make_program(arch_id: str, batch: int, lr: float, device="cuda"):
    """(init_fn, step_fn, batch_iter, optimizer) for a trainable arch;
    ``init_fn(seed)`` draws the params on ``device``: for a JEDI-net and
    a GNN the reference's initial weights at the same seed
    (``common/prng.py``), for ``fm`` and the LMs the port's own draw on
    the device (replaying an LM's billions of normals in numpy would take
    hours)."""
    from repro_torch.common import prng
    from repro_torch.configs.registry import get_arch
    from repro_torch.training import make_optimizer, make_train_step
    from repro_torch.training.schedule import warmup_cosine, wsd

    arch = get_arch(arch_id)
    family = arch.family
    dev = resolve_device(device)

    if family == "jedi":
        from repro_torch.core import interaction_net as inet
        from repro_torch.data.jets import jet_batches
        cfg = arch.model
        opt = make_optimizer("adamw", warmup_cosine(lr, 50, 5000))
        return (
            lambda seed: inet.init(prng.key(seed), cfg, device=dev),
            make_train_step(lambda p, b: inet.loss_fn(p, cfg, b), opt),
            jet_batches(0, batch, cfg.n_objects, cfg.n_features),
            opt,
        )
    if family == "lm":
        from repro_torch.data.lm_data import lm_batches
        from repro_torch.models import transformer as tfm
        cfg = arch.model
        # schedule: minicpm uses its signature WSD schedule
        sched = (wsd(lr, 50, 5000) if arch.arch_id == "minicpm-2b"
                 else warmup_cosine(lr, 50, 5000))
        opt = make_optimizer("adafactor", sched)
        return (
            lambda seed: tfm.init(seed, cfg, device=dev),
            make_train_step(
                lambda p, b: tfm.loss_fn(p, cfg, b, logit_chunk=None), opt),
            lm_batches(0, batch, 256, cfg.vocab_size),
            opt,
        )
    if family == "recsys":
        from repro_torch.models import recsys as fm_lib
        from repro_torch.data.recsys_data import ctr_batches
        cfg = arch.model
        opt = make_optimizer("adamw", warmup_cosine(lr, 50, 5000),
                             weight_decay=0.0)
        return (
            lambda seed: fm_lib.init(seed, cfg, device=dev),
            make_train_step(lambda p, b: fm_lib.loss_fn(p, cfg, b), opt),
            ctr_batches(0, batch, cfg.vocab_sizes),
            opt,
        )
    if family == "gnn":
        from repro_torch.data.graphs import community_graph
        from repro_torch.launch.steps import _gnn_loss
        from repro_torch.models.gnn import GNN_MODULES
        cfg = arch.model
        mod = GNN_MODULES[cfg.kind]
        g = community_graph(0, 4096, 16384, 64, n_classes=cfg.n_classes)
        if cfg.kind in ("meshgraphnet", "equiformer_v2"):
            rngp = np.random.RandomState(1)
            g["pos"] = rngp.normal(0, 1, (4096, 3)).astype(np.float32)
            if cfg.kind == "meshgraphnet":
                g["y"] = np.tanh(g["pos"]).astype(np.float32)
            else:
                g["y"] = np.tanh(g["pos"]).sum(-1).astype(np.float32)
        opt = make_optimizer("adamw", warmup_cosine(lr, 50, 5000))

        def loss_fn(p, batch):
            out = mod.apply(p, cfg, batch)
            return _gnn_loss(cfg.kind, cfg, out, batch)

        def rep(d):
            while True:
                yield d

        return (
            lambda seed: mod.init(prng.key(seed), cfg, 64, cfg.n_classes,
                                  device=dev),
            make_train_step(loss_fn, opt),
            rep(g),
            opt,
        )
    raise ValueError(f"no train program for {arch_id}")


class _LoopClock:
    """Time of the step loop: CUDA events on the card, else the host."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.t0 = torch.cuda.Event(enable_timing=True)
            self.t1 = torch.cuda.Event(enable_timing=True)
            self.t0.record()
        self.h0 = time.perf_counter()

    def elapsed_ms(self) -> float:
        if self.cuda:
            self.t1.record()
            self.t1.synchronize()
            return self.t0.elapsed_time(self.t1)
        return (time.perf_counter() - self.h0) * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--fail-at-step", type=int, default=None,
                    help="inject a crash (fault-tolerance demo)")
    args = ap.parse_args(argv)

    from repro_torch.training import init_state

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    init_fn, step_fn, batches, opt = make_program(
        args.arch, args.batch, args.lr, dev)

    cm = None
    state = None
    start_step = 0
    if args.ckpt_dir:
        from repro_torch.checkpoint import CheckpointManager
        cm = CheckpointManager(args.ckpt_dir)
        if cm.latest_step() is not None:
            state, start_step = cm.restore(device=dev)
            print(f"[train] restored checkpoint at step {start_step}")
    if state is None:
        state = init_state(0, init_fn, opt)

    # preemption: final sync checkpoint on SIGTERM
    def _on_term(signum, frame):
        if cm is not None:
            s = int(state["step"])
            print(f"[train] preempted; checkpointing step {s}", flush=True)
            cm.wait()
            cm.save(s, state)
        sys.exit(143)

    previous = signal.signal(signal.SIGTERM, _on_term)
    history = []
    it = prefetch(batches)
    try:
        clock = _LoopClock(dev)
        for i in range(start_step, args.steps):
            batch = to_device(next(it), dev)
            if args.fail_at_step is not None and i == args.fail_at_step:
                raise RuntimeError(f"injected failure at step {i}")
            state, metrics = step_fn(state, batch)
            if i % args.log_every == 0 or i == args.steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                history.append((i, m))
                rate = (i - start_step + 1) / (clock.elapsed_ms() / 1e3)
                print(f"[train] step {i} " +
                      " ".join(f"{k}={v:.4g}" for k, v in sorted(m.items()))
                      + f" ({rate:.1f} it/s)", flush=True)
            if cm is not None and i > start_step and i % args.ckpt_every == 0:
                cm.save_async(i, state)
        n = max(args.steps - start_step, 0)
        elapsed = clock.elapsed_ms()
        ms = elapsed / n if n and elapsed else float("nan")
        print(f"[train] {n} steps: {ms:.3f} ms/step ({1e3 / ms:.1f} it/s, "
              f"{'CUDA events' if dev.type == 'cuda' else 'host clock'})",
              flush=True)
        if cm is not None:
            cm.wait()
            cm.save(args.steps, state)
            print(f"[train] final checkpoint at step {args.steps}")
    finally:
        it.close()
        if cm is not None:
            cm.wait()         # a crash still finishes the save in flight
        signal.signal(signal.SIGTERM, previous)
    return {"state": state, "history": history, "ms_per_step": ms,
            "steps": n}


if __name__ == "__main__":
    main()
