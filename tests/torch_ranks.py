"""Run a function on N ``gloo`` ranks for the port's multi-process tests.

Each rank is a spawned process with one intra-op thread, joined into a
process group through a file under the test's ``tmp_path`` (no TCP port,
so concurrent test workers cannot collide), with a 60 s collective
timeout.  The whole run has a wall limit: past it every rank is
terminated and the test fails instead of hanging.  A rank body passes
results back by writing them under ``tmp_path``.
"""

from __future__ import annotations

import time
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

#: Collective timeout of each rank's group.
COLLECTIVE_TIMEOUT_S = 60
#: Wall limit of one multi-process run, spawn and imports included.
WALL_LIMIT_S = 150


def _rank_main(rank, world, store, fn, args):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", world_size=world, rank=rank,
        timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, tmp_path, *args,
              wall_limit_s: float = WALL_LIMIT_S) -> None:
    """``fn(rank, world, *args)`` on ``world`` gloo ranks; raises if a rank
    fails or the run outlasts ``wall_limit_s``."""
    ctx = mp.start_processes(
        _rank_main, args=(world, tmp_path / "store", fn, args),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + wall_limit_s
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(5)
            raise TimeoutError(
                f"{world} ranks of {fn.__name__} still running after "
                f"{wall_limit_s} s")
