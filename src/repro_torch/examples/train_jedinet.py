"""End-to-end training run: JEDI-net-30p on synthetic jets, a few
hundred steps with async checkpointing and restart (port of
``examples/train_jedinet.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_jedinet [--steps 300]

The paper's application trained through the port's stack: data pipeline
(prefetch thread) -> strength-reduced forward -> AdamW + warmup-cosine
-> async checkpoints, then the held-out accuracy of the last checkpoint.
Runs on the CUDA card unless ``--device cpu`` is given.  Accuracy on the
5-class synthetic surrogate rises well above the 20% chance level within
~200 steps.

The checkpoint directory may hold a checkpoint of the JAX reference
(``python -m repro.launch.train --arch jedinet-30p ...``): the port
restores it (the layout is shared), trains on from it and evaluates it.
"""

import argparse
import os
import tempfile

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import jedi_30p
from repro_torch.core import interaction_net as inet
from repro_torch.data.jets import jet_batches
from repro_torch.launch import train as train_cli


def held_out_accuracy(params, cfg, device) -> float:
    """Accuracy of ``forward_sr`` on the held-out batch: the first 2048
    events of ``jet_batches(999, ...)``, as the co-design example
    evaluates."""
    b = train_cli.to_device(
        next(jet_batches(999, 2048, cfg.n_objects, cfg.n_features)), device)
    with torch.no_grad():
        logits = inet.forward_sr(params, cfg, b["x"])
    return float((logits.argmax(-1) == b["y"].long()).float().mean())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "jedinet_ckpt"))
    args = ap.parse_args(argv)
    out = train_cli.main([
        "--arch", "jedinet-30p",
        "--steps", str(args.steps),
        "--batch", str(args.batch),
        "--lr", "2e-3",
        "--device", args.device,
        "--ckpt-dir", args.ckpt_dir,
        "--ckpt-every", "100",
        "--log-every", "25",
    ])
    dev = resolve_device(args.device)
    state, step = CheckpointManager(args.ckpt_dir).restore(device=dev)
    acc = held_out_accuracy(state["params"], jedi_30p.MODEL, dev)
    print(f"[train_jedinet] held-out accuracy at step {step}: {acc:.4f} "
          "(2048 events of jet_batches(999); chance 0.2)")
    return dict(out, accuracy=acc)


if __name__ == "__main__":
    main()
