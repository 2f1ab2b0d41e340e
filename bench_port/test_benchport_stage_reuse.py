"""The reader of the engine's staging counters, ``engine.stage_reuse.stream``."""

import pytest

from bench_port import harness

NAME = "engine.stage_reuse.stream"


def _input(counters):
    outcome = harness.Outcome(attempted=1, failed=0, metrics={}, checks={},
                              memory_peak_bytes=0, counters=counters)
    return harness.MetricInput(trace=None, outcome=outcome, config={},
                               mix={}, work=None, peaks=None)


@pytest.mark.parametrize("counters,want", [
    ({"core.stage_reused": 999, "core.stage_grown": 1}, 99.9),
    ({"core.stage_reused": 6, "core.stage_grown": 1,
      "core.stage_waited": 1}, 75.0),
    ({"core.stage_grown": 4}, 0.0),
    ({"core.stage_reused": 3, "core.stage.n": 9}, 100.0),
])
def test_reader_is_the_reused_share_in_percent(counters, want):
    assert harness.metric_reader(NAME)(_input(counters)) == pytest.approx(want)


def test_reader_leaves_the_metric_out_without_the_counters():
    assert harness.metric_reader(NAME)(_input({"core.stage.n": 3})) is None


def test_entry_reads_the_program_counter_in_both_stream_cells():
    m = {m["name"]: m for m in harness.benchmark()["per_layer"]}[NAME]
    assert (m["source"], m["unit"], m["layer"], m["moves"]) == (
        "program_counter", "%", "engine", "events_per_s")
    assert m["workloads"] == ["jedinet-30p.stream_1k",
                              "jedinet-50p.stream_1k"]


def test_traced_cpu_run_leaves_it_out(tiny_run):
    """The CPU serves through the pad path, which stages no slot."""
    line = tiny_run("jedinet-30p.stream_1k", seed=2 ** 31 + 29, seconds=0.5,
                    trace=True)
    assert line["correct"], line["checks"]
    assert NAME not in line["metrics"]
