"""Set-up shared by the trigger runners: the model, weights, events and
the program's serving engine, and what the check after the window needs.

The system under test is the port's trigger server,
``repro_torch.serving.resilient.ResilientEngine`` on the configuration's
path (``fused_full``: kernel B1, falling back to ``sr_split``).  From the
program the benchmark takes only that engine, the registry's model to
check its widths against, and the engine's counters.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bench_port.data import jedinet_weights
from bench_port.data.jets import make_jets
from bench_port.judge import GapMeter

#: Keys of a JEDI-net configuration file's ``model`` that must equal the
#: program's registry entry.
MODEL_KEYS = ("n_objects", "n_features", "d_e", "d_o", "n_targets",
              "fr_hidden", "fo_hidden", "phi_hidden", "activation")

#: Counters of the engine that count a batch or request not served by
#: its base rung: a fallback rung, the last resort, a shed.
FAILURE_COUNTERS = ("fallback_batches", "failed_requests", "shed_requests")


def model_config(config: dict, control: str | None):
    """The program's model config for ``config``, its widths checked
    against the registry; the ``bf16`` control serves in bfloat16."""
    from repro_torch.configs.registry import get_arch
    model = get_arch(config["arch_id"]).model
    for key in MODEL_KEYS:
        have = getattr(model, key)
        want = config["model"][key]
        if (list(have) if isinstance(have, (list, tuple)) else have) != want:
            raise ValueError(
                f"{config['name']}: {key} is {want!r} in the benchmark's "
                f"file but {have!r} in the program's registry")
    dtype = "bfloat16" if control == "bf16" else config["compute_dtype"]
    return model.with_(compute_dtype=dtype)


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return gen


@dataclasses.dataclass
class Setup:
    cfg: object                  # the program's JediNetConfig
    engine: object               # ResilientEngine
    events_host: np.ndarray      # (pool, N_o, P): what the program is given
    events_dev: torch.Tensor     # the same on the device: the reference's
    ref_params: dict             # the reference's own copy of the weights
    path: str                    # the configuration's path
    base_path: str               # the rung the engine built as its base


def build(run, *, max_batch: int, pool_events: int) -> Setup:
    """Weights and the event pool from ``run.seed`` on the device, and the
    engine over them (nothing warmed yet)."""
    from repro_torch.serving.resilient import ResilientEngine
    config = run.cell.config
    cfg = model_config(config, run.control)
    gen = generator(run.seed, run.device)
    params = jedinet_weights.make_params(config["model"], gen)
    ref_params = jedinet_weights.clone(params)
    events, _ = make_jets(gen, pool_events, cfg.n_objects, cfg.n_features)
    engine = ResilientEngine(params, cfg, forward=config["path"],
                             device=run.device, max_batch=max_batch)
    base = engine.health()["base_path"]
    if base != config["path"]:
        run.log(f"the engine could not build {config['path']!r} and serves "
                f"from {base!r}: every answer of the run counts as failed")
    return Setup(cfg=cfg, engine=engine, events_host=events.cpu().numpy(),
                 events_dev=events, ref_params=ref_params,
                 path=config["path"], base_path=base)


def delta(before: dict, after: dict) -> dict:
    return {k: after.get(k, 0) - before.get(k, 0)
            for k in set(before) | set(after)
            if after.get(k, 0) != before.get(k, 0)}


def failures(setup: Setup, window_counters: dict, attempted: int) -> int:
    """Batches or requests of the window not served by the configuration's
    path: all ``attempted`` where the engine could not build that path
    and made another rung its base; else the window's fallback,
    last-resort and shed counts, and one more for each bucket the window
    leaves on another rung."""
    if setup.base_path != setup.path:
        return attempted
    off = sum(path != setup.path
              for path in served_paths(setup.engine).values())
    return off + sum(window_counters.get(k, 0) for k in FAILURE_COUNTERS)


def served_paths(engine) -> dict:
    """{bucket: path} of every bucket the engine served."""
    return {int(b): d["path"] for b, d in engine.health()["buckets"].items()}


def memory_peak(device) -> int:
    if device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def release(setup: Setup) -> None:
    """Free the program's state before the reference runs on the card."""
    setup.engine = None
    if setup.events_dev.is_cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def reference(run, setup: Setup, products: str = "fp32") -> np.ndarray:
    """The reference's logits of the whole event pool."""
    from bench_port.harness import family_module
    ref = family_module("reference", run.cell.config["family"])
    return ref.logits(setup.ref_params, run.cell.config["model"],
                      setup.events_dev, products=products)


def judge(run, setup: Setup, served) -> float:
    """The widest gap of ``served`` ([(start, stop, logits), ...] over the
    pool's events) against the reference; under the ``tf32`` control the
    reference in TF32 stands in the program's place."""
    ref = reference(run, setup)
    if run.control == "tf32":
        stand_in = reference(run, setup, products="tf32")
        served = [(s, e, stand_in[s:e]) for s, e, _ in served]
    meter = GapMeter()
    for start, stop, logits in served:
        meter.add(logits, ref[start:stop])
    run.log(f"compared {meter.events} served events against the reference "
            f"({len(served)} answers); widest gap {meter.gap:.6e} of scale "
            f"{meter.scale:.4f}")
    return meter.gap if meter.events else float("inf")
