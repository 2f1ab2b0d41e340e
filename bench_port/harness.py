"""The harness: find a cell's files by name, run it, assemble the result.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own, found by the name ``BENCHMARK.json``
gives it:

* ``configs/<config>.json`` (the file named in ``configs``): the model's
  widths, its registry id, family, path and precision, and the limit of
  the comparison that decides ``correct``;
* ``traffic/<traffic>.json``: the mix's parameters and its ``runner``;
* ``runners/<runner>.py``: drives the program and returns an
  :class:`Outcome`;
* ``metrics/<metric>.py``: a ``read(rec)`` over the traced run's
  :class:`MetricInput`; ``None`` leaves the metric out of the line;
* per family, ``reference/<family>.py``, ``work/<family>.py`` and the
  data makers under ``data/``.

A later change adds a cell, a mix, a configuration or a metric as new
files and entries; it edits none of these.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import os
import pathlib
import sys
import time

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent

#: Top-level module names that may not be loaded in a run: JAX and the
#: JAX package this port replaces (compared whole: ``repro_torch`` is not
#: ``repro``).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with its configuration and mix loaded."""

    name: str
    chips: int
    config: dict            # configs/<config>.json
    mix: dict               # traffic/<traffic>.json
    end_to_end: list        # BENCHMARK.json entries this cell reports
    per_layer: list


def _applies(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def resolve(bench: dict, name: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``name`` of ``bench`` with its files; raises ``KeyError``
    for an unknown cell."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"unknown workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    mix = load_json(BENCH / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, names)]
    return Cell(name=name, chips=int(w["chips"]), config=config, mix=mix,
                end_to_end=e2e, per_layer=per_layer)


def family_module(kind: str, family: str):
    """``bench_port.<kind>.<family>`` (``reference``, ``work``)."""
    return importlib.import_module(f"bench_port.{kind}.{family}")


def runner_module(name: str):
    return importlib.import_module(f"bench_port.runners.{name}")


def metric_reader(name: str):
    """The ``read`` function of ``metrics/<name>.py`` (metric names hold
    dots, so the file is loaded by path)."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_port_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def peaks(kind: str) -> dict | None:
    """The data-sheet peaks of the card named ``kind``, or None."""
    return load_json(BENCH / "peaks.json").get(kind)


def process_age_s() -> float:
    """Seconds since this process started (``/proc``; the import of this
    module where that is not readable)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def steady_heap() -> None:
    """Collect, then freeze every object set-up made (torch's and the
    program's modules among them), so that the interpreter's full
    collections in the window walk only what the window makes: a full
    walk of the set-up's ~250,000 objects stalls the host for ~0.13 s,
    which in an open loop lands on every request due meanwhile."""
    gc.collect()
    gc.freeze()


def forbidden_loaded() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN_MODULES))


@dataclasses.dataclass
class Run:
    """What a runner gets: the cell, the run's arguments, the device, the
    tracer, and the set-up clock."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object                      # torch.device
    tracer: object                      # tracing.Tracer
    control: str | None = None          # None | "tf32" | "bf16"
    t_process: float = 0.0              # perf_counter at process start
    t_window: float | None = None

    def log(self, msg: str) -> None:
        print(f"[bench] {msg}", flush=True)

    def window_opens(self) -> None:
        steady_heap()
        self.t_window = time.perf_counter()

    @property
    def setup_s(self) -> float:
        return self.t_window - self.t_process

    def trace_slice(self) -> tuple[float, float]:
        """(start, stop) of the traced slice, seconds into the window: a
        steady few seconds from 30% of it."""
        start = 0.3 * self.seconds
        return start, start + min(3.0, 0.3 * self.seconds)


@dataclasses.dataclass
class Outcome:
    """What a runner returns."""

    attempted: int
    failed: int
    metrics: dict                       # end-to-end name -> value
    checks: dict                        # name -> (value, limit)
    memory_peak_bytes: int
    counters: dict                      # the program's counters over the window
    window_events: int = 0              # valid events served in the window


@dataclasses.dataclass
class MetricInput:
    """What a per-layer reader gets."""

    trace: object                       # tracing.TraceRecord
    outcome: Outcome
    config: dict
    mix: dict
    work: object                        # bench_port.work.<family>
    peaks: dict | None


def _value(v):
    """A JSON number: ints stay ints, floats keep every digit."""
    if isinstance(v, bool):
        return v
    if isinstance(v, int):
        return v
    return float(v)


def result(run: Run, outcome: Outcome, device_info: dict) -> dict:
    """The last line's object (see the benchmark contract)."""
    cell = run.cell
    metrics = {}
    breakdown = None
    if run.trace:
        from bench_port import tracing
        rec = run.tracer.record
        inp = MetricInput(trace=rec, outcome=outcome, config=cell.config,
                          mix=cell.mix,
                          work=family_module("work", cell.config["family"]),
                          peaks=peaks(device_info["kind"]))
        for m in cell.per_layer:
            value = metric_reader(m["name"])(inp)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": _value(value),
                                      "unit": m["unit"]}
        device_info = dict(device_info, busy_s=rec.busy_s,
                           window_s=rec.window_s)
        breakdown = tracing.breakdown(rec)
    else:
        values = dict(outcome.metrics, setup_s=run.setup_s)
        for m in cell.end_to_end:
            if m["name"] not in values:
                raise RuntimeError(
                    f"runner gave no {m['name']!r} for {cell.name}")
            metrics[m["name"]] = {"value": _value(values[m["name"]]),
                                  "unit": m["unit"]}
    correct = all(v <= lim for v, lim in outcome.checks.values())
    line = {"correct": bool(correct), "attempted": int(outcome.attempted),
            "failed": int(outcome.failed), "metrics": metrics,
            "device": device_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {name: {"value": _value(v), "limit": _value(lim)}
                      for name, (v, lim) in outcome.checks.items()}
    return line


def execute(run: Run) -> dict:
    """Run the cell's runner and return the result line's object (the
    device block filled from the card the run used)."""
    import torch
    outcome = runner_module(run.cell.mix["runner"]).run(run)
    if run.device.type == "cuda":
        kind = torch.cuda.get_device_name(run.device)
        platform = "gpu"
    else:
        kind, platform = "cpu", "cpu"
    info = {"platform": platform, "kind": kind, "count": run.cell.chips,
            "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    return result(run, outcome, info)
