"""Algorithm-hardware co-design DSE (paper Sec 4.4 / Fig 11), closed loop
(port of ``examples/codesign_search.py``):

1. enumerate the (f_R, f_O, N_fR) space, prune by eq.(1) DSPs and
   eq.(2) latency (alpha x 1us budget) — no training needed for pruned
   points (the paper's GPU-hours saving);
2. pick Opt-Latn and Opt-Acc candidates by the capacity proxy;
3. THEN actually train both picks (plus the J1 baseline) briefly on the
   synthetic jet surrogate and report real accuracies, validating that
   the co-design trade (small f_R, big f_O) holds under training.

    PYTHONPATH=src python -m repro_torch.examples.codesign_search [--steps 150]

Trains on the CUDA card unless ``--device cpu`` is given, each design
from the reference's initial weights at seed 0 (``common/prng.py``).
"""

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.common import prng
from repro_torch.core import codesign, interaction_net as inet
from repro_torch.data.jets import jet_batches
from repro_torch.examples.train_jedinet import held_out_accuracy
from repro_torch.launch.train import to_device
from repro_torch.training import init_state, make_optimizer, make_train_step
from repro_torch.training.schedule import warmup_cosine


def train_and_eval(cfg, steps: int, batch: int = 256,
                   device="cuda") -> float:
    dev = resolve_device(device)
    opt = make_optimizer("adamw", warmup_cosine(2e-3, 20, steps))
    state = init_state(0, lambda seed: inet.init(prng.key(seed), cfg,
                                                 device=dev), opt)
    step = make_train_step(lambda p, b: inet.loss_fn(p, cfg, b), opt)
    it = jet_batches(0, batch, cfg.n_objects, cfg.n_features)
    for _ in range(steps):
        state, _ = step(state, to_device(next(it), dev))
    return held_out_accuracy(state["params"], cfg, dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False

    base = inet.JediNetConfig(n_objects=30, n_features=16)
    res = codesign.explore(base, latency_budget_us=1.0, alpha=2.0)
    print(f"DSE: {res['n_total']} candidates, "
          f"{res['training_runs_saved']} pruned without training "
          f"({res['training_runs_saved']/res['n_total']*100:.0f}% of "
          "GPU-hours saved)")

    picks = {
        "J1-baseline": (base, None),
        "Opt-Latn": (res["opt_latn"].cfg, res["opt_latn"]),
        "Opt-Acc": (res["opt_acc"].cfg, res["opt_acc"]),
    }
    print(f"\n{'design':<12} {'f_R':<16} {'f_O':<16} "
          f"{'latency_us':<11} {'trained acc'}")
    out = {}
    for name, (cfg, cand) in picks.items():
        lat = (cand.fpga["latency_us"] if cand else
               codesign.FPGAModel.evaluate(
                   codesign.FPGADesignPoint(cfg=cfg, n_fr=1))["latency_us"])
        acc = train_and_eval(cfg, args.steps, device=dev)
        out[name] = {"fr_hidden": cfg.fr_hidden, "fo_hidden": cfg.fo_hidden,
                     "latency_us": lat, "accuracy": acc}
        print(f"{name:<12} {str(cfg.fr_hidden):<16} "
              f"{str(cfg.fo_hidden):<16} {lat:<11.2f} {acc*100:.1f}%")
    print("\nThe co-design claim: Opt-Latn shrinks f_R (many-iteration "
          "unit) >10x in latency at small accuracy cost; Opt-Acc buys "
          "accuracy back with a bigger f_O within the 1us budget.")
    return out


if __name__ == "__main__":
    main()
