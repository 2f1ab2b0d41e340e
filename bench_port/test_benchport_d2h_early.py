"""The reader of the engine's D2H counters, ``engine.d2h_early.stream``."""

import pytest

from bench_port import harness

NAME = "engine.d2h_early.stream"


def _input(counters):
    outcome = harness.Outcome(attempted=1, failed=0, metrics={}, checks={},
                              memory_peak_bytes=0, counters=counters)
    return harness.MetricInput(trace=None, outcome=outcome, config={},
                               mix={}, work=None, peaks=None)


@pytest.mark.parametrize("counters,want", [
    ({"core.d2h_early": 1000}, 100.0),
    ({"core.d2h_early": 3, "core.d2h_late": 1}, 75.0),
    ({"core.d2h_late": 4}, 0.0),
    ({"core.d2h_early": 2, "core.d2h_grown": 2, "core.d2h.n": 9}, 100.0),
])
def test_reader_is_the_early_share_in_percent(counters, want):
    assert harness.metric_reader(NAME)(_input(counters)) == pytest.approx(want)


def test_reader_leaves_the_metric_out_without_the_counters():
    assert harness.metric_reader(NAME)(_input({"core.d2h.n": 3})) is None


def test_entry_reads_the_program_counter_in_both_stream_cells():
    m = {m["name"]: m for m in harness.benchmark()["per_layer"]}[NAME]
    assert (m["source"], m["unit"], m["layer"], m["moves"]) == (
        "program_counter", "%", "engine", "events_per_s")
    assert m["workloads"] == ["jedinet-30p.stream_1k",
                              "jedinet-50p.stream_1k"]


def test_traced_cpu_run_leaves_it_out(tiny_run):
    """The CPU's outputs are already in host memory: no chunk counts."""
    line = tiny_run("jedinet-30p.stream_1k", seed=2 ** 31 + 31, seconds=0.5,
                    trace=True)
    assert line["correct"], line["checks"]
    assert NAME not in line["metrics"]
