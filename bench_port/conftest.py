"""Fixtures of the benchmark's CPU tests: cells cut to a size a test holds.

A tiny run drives the harness exactly as ``run.py`` does, past its look
for a card, on the CPU (where the program's kernel paths run their plain
versions) with the cell's mix cut down.
"""

import time

import pytest
import torch

from bench_port import harness, tracing

#: Each cell's mix cut to a test's size (the widths stay as published).
TINY = {
    "stream": dict(batch=16, pool_batches=4, max_batch=16, warm_batches=2,
                   keep_max=20),
    "live": dict(rate_per_s=40, size_max=20, pool_events=512, max_batch=32,
                 warm_requests=4),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (the port's hand-written kernels); skips "
        "without one")


@pytest.fixture
def tiny_run():
    """``tiny_run(cell, seed=..., seconds=..., trace=..., control=...)``:
    the result line's object of a CPU run of ``cell`` at test size."""
    torch.set_num_threads(1)

    def make(cell_name, *, seed=7, seconds=0.5, trace=False, control=None):
        cell = harness.resolve(harness.benchmark(), cell_name)
        cell.mix.update(TINY[cell.mix["runner"]])
        dev = torch.device("cpu")
        run = harness.Run(cell=cell, seed=seed, seconds=seconds, trace=trace,
                          device=dev, tracer=tracing.Tracer(trace, dev),
                          control=control, t_process=time.perf_counter())
        return harness.execute(run)
    return make
