"""Quickstart: the paper's technique in 60 seconds (port of
``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

1. Build JEDI-net-30p and enumerate the forward-path registry
   (``repro_torch.core.paths``) — every optimization tier of the paper is
   one registered ``PathSpec``, from the dense-MMM baseline of [5] to the
   int8-quantized whole-network kernel.
2. Run each registered path against its own declared reference fn at its
   declared tolerance (on the CUDA card the kernel paths launch their
   hand-written kernels; on the CPU they run the kernels' plain
   versions).
3. Print the Fig-8 op-count reduction and a wall-clock comparison of the
   plain-PyTorch paths on the device.
4. The large-graph regime: jedinet-tracks-128's 16,256 edges an event
   through the whole-network kernel's sender-tiled layout.

Runs on the CUDA card unless ``--device cpu`` is given; without a card
it raises rather than fall back.  Exits 1 if a path misses its
tolerance.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import adjacency, interaction_net as inet, paths
from repro_torch.data.jets import make_jets, make_tracks


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card; raises without one) or cpu (the "
                         "kernels' plain PyTorch versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "CPU")

    cfg = inet.JediNetConfig(n_objects=30, n_features=16)
    params = inet.init(0, cfg, scale="lecun", device=dev)
    x = torch.from_numpy(
        make_jets(np.random.RandomState(1), 256, 30)[0]).to(dev)

    print("registered forward paths:\n" + paths.describe() + "\n")

    # every path vs its own spec-declared reference
    xs = x[:8]
    failed = []
    for name in paths.available():
        spec = paths.get(name)
        p = spec.prepare_params(params)
        out = spec.forward(p, cfg, xs)
        err = float((out - spec.ref(p, cfg, xs)).abs().max())
        ok = "ok" if err < spec.tolerance else "FAIL"
        if ok != "ok":
            failed.append(name)
        kind = "kernel" if spec.cuda else "torch"
        print(f"{name:>22} vs ref: max err {err:.2e} "
              f"(tol {spec.tolerance:.0e}, {kind}) {ok}")

    c = adjacency.mmm_op_counts(30, 16, 8)
    print(f"\nFig 8 (30p): MMM1/2 mults {c['mmm12_baseline_mults']:,} -> 0, "
          f"MMM3 adds {c['mmm3_baseline_adds']:,} -> {c['mmm3_sr_adds']:,} "
          f"({c['mmm3_sr_adds'] / c['mmm3_baseline_adds'] * 100:.1f}%), "
          f"iterations {c['iterations_baseline']} -> {c['iterations_sr']}")

    # wall-clock of the plain-PyTorch paths (the kernels' times are in
    # chip_smoke.py's phase 4)
    print()
    with torch.no_grad():
        for name in paths.available(cuda=False):
            spec = paths.get(name)
            pp = spec.prepare_params(params)
            spec.forward(pp, cfg, x)
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(10):
                spec.forward(pp, cfg, x)
            _sync(dev)
            print(f"{name:>22}: {(time.perf_counter() - t0) / 10 * 1e3:.2f} "
                  f"ms / 256-jet batch ({where})")

    # the large-graph regime: N_o=128 track-level events through the
    # whole-network kernel, whose plan tiles the senders
    from repro_torch.configs.jedi_tracks_128 import MODEL as tcfg
    from repro_torch.kernels.fused_jedinet import autotune as fj_autotune
    tparams = inet.init(0, tcfg, scale="lecun", device=dev)
    lay = fj_autotune.full_layout_for(tcfg, tparams)
    xt = torch.from_numpy(make_tracks(np.random.RandomState(0), 4)[0]).to(dev)
    spec = paths.get("fused_full")
    logits = spec.forward(tparams, tcfg, xt)
    err = float((logits - spec.ref(tparams, tcfg, xt)).abs().max())
    scale = max(1.0, float(logits.abs().max()))
    ok = "ok" if err <= spec.tolerance * scale else "FAIL"
    if ok != "ok":
        failed.append("fused_full tracks_128")
    print(f"\ntracks128 (N_o={tcfg.n_objects}): the whole-network kernel runs "
          f"the {lay.design} design, sender tile {lay.block_s}, "
          f"{lay.smem_bytes} B of shared memory a block; max err vs ref "
          f"{err:.1e} (tol {spec.tolerance:.0e} of logits up to "
          f"{scale:.1e}) {ok}")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
