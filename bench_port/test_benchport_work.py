"""The frozen counts of a JEDI-net event."""

import pytest

from bench_port import harness
from bench_port.work import jedinet as work

COUNTS = {"jedinet-30p": (1_859_640, 1_940, 870),
          "jedinet-50p": (27_638_700, 3_220, 2_450)}


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_frozen_counts(name):
    config = harness.load_json(harness.BENCH / "configs" / f"{name}.json")
    ops, nbytes, edges = COUNTS[name]
    model = config["model"]
    assert work.ops_per_event(model) == ops == config["ops_per_event"]
    assert work.io_bytes_per_event(model) == nbytes
    assert model["n_objects"] * (model["n_objects"] - 1) == edges \
        == config["edges"]


def test_fifty_particles_cost_about_fifteen_times_thirty():
    load = lambda n: harness.load_json(  # noqa: E731
        harness.BENCH / "configs" / f"{n}.json")["model"]
    ratio = work.ops_per_event(load("jedinet-50p")) \
        / work.ops_per_event(load("jedinet-30p"))
    assert 14.8 < ratio < 15.0


def test_launch_work_counts_valid_events_and_weights_once():
    model = harness.load_json(
        harness.BENCH / "configs" / "jedinet-30p.json")["model"]
    ops, nbytes = work.launch_work(model, 1000)
    assert ops == 1000 * 1_859_640
    assert nbytes == 1000 * 1_940 + work.weight_bytes(model)
