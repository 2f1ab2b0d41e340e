"""The readers of the program's spans: each one's mean from the counter
pair, and whole traced runs on the CPU at test size that fill them."""

import pytest
import torch

from bench_port import harness

READERS = {
    "engine.stage_us.stream": "core.stage",
    "engine.h2d_us.stream": "core.h2d",
    "engine.launch_us.stream": "core.launch",
    "engine.wait_us.stream": "core.wait",
    "engine.d2h_us.stream": "core.d2h",
    "front.queued_us.live": "loop.queued",
    "front.blocked_us.live": "loop.blocked",
    "front.inflight_us.live": "loop.inflight",
}
CELLS = {"stream": ["jedinet-30p.stream_1k", "jedinet-50p.stream_1k"],
         "live": ["jedinet-30p.live", "jedinet-50p.live"]}


def _input(counters):
    outcome = harness.Outcome(attempted=1, failed=0, metrics={}, checks={},
                              memory_peak_bytes=0, counters=counters)
    return harness.MetricInput(trace=None, outcome=outcome, config={},
                               mix={}, work=None, peaks=None)


@pytest.mark.parametrize("name,pair", READERS.items())
def test_reader_is_the_mean_of_its_pair_in_us(name, pair):
    read = harness.metric_reader(name)
    got = read(_input({pair + ".ns": 7_500_000, pair + ".n": 3,
                       "loop_plans": 9}))
    assert got == pytest.approx(2500.0)
    assert read(_input({"loop_plans": 9})) is None
    assert read(_input({pair + ".n": 2})) == 0.0


def test_every_reader_has_its_entry():
    layers = {m["name"]: m for m in harness.benchmark()["per_layer"]}
    for name in READERS:
        m = layers[name]
        assert m["source"] == "program_span" and m["unit"] == "us"
        assert m["workloads"] == CELLS[name.rsplit(".", 1)[1]]


@pytest.mark.parametrize("cell,seconds,kind", [
    ("jedinet-30p.stream_1k", 1.0, "engine."),
    ("jedinet-30p.live", 2.0, "front."),
])
def test_traced_run_reports_the_program_spans(tiny_run, cell, seconds, kind):
    line = tiny_run(cell, seed=2 ** 31 + 17, seconds=seconds, trace=True)
    torch.set_num_threads(1)
    assert line["correct"], line["checks"]
    want = {n for n in READERS if n.startswith(kind)}
    assert want <= set(line["metrics"])
    for name in want:
        assert line["metrics"][name]["unit"] == "us"
        assert line["metrics"][name]["value"] >= 0
    others = set(READERS) - want
    assert not others & set(line["metrics"])

