"""One short run of each cell on the card, as the check makes it.

Marked ``cuda``: skips where there is no card.  On a machine with one:
``PYTHONPATH=src python -m pytest -q bench_port -m cuda``.
"""

import json
import subprocess
import sys

import pytest

from bench_port import harness

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark runs only on one")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell):
    proc = subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload", cell,
         "--seed", str(2 ** 31 + 101), "--seconds", "2", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["failed"] == 0
