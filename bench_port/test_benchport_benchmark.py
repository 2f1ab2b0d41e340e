"""``BENCHMARK.json``: its schema, and every cell and metric resolving to
its files by name."""

import math
import re

import pytest

from bench_port import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "bench_port/run.py"]
    assert BENCH["paths"] == ["bench_port"]
    assert all(PATH.match(p) for p in BENCH["paths"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_full_check_fits_its_time_with_24_cells():
    s = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry_resolves(config):
    assert set(config) == CONFIG_KEYS
    assert NAME.match(config["name"]) and _line(config["source"])
    assert _line(config["why"]) and config["reduced"] == []
    path = harness.ROOT / config["file"]
    assert config["file"].startswith("bench_port/") and path.is_file()
    data = harness.load_json(path)
    assert data["name"] == config["name"]
    assert data["reduced"] == config["reduced"]
    for kind in ("reference", "work"):
        assert (harness.BENCH / kind / f"{data['family']}.py").is_file()
    assert 0 < float(data["logit_gap_limit"]) < 1e-3
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves_and_reports_enough(cell):
    assert set(cell) == CELL_KEYS
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] == 1 and _line(cell["why"])
    c = harness.resolve(BENCH, cell["name"])
    assert (harness.BENCH / "runners" / f"{c.mix['runner']}.py").is_file()
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names


def test_cells_and_pairs_are_unique():
    cells = BENCH["workloads"]
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)


def test_metrics_are_well_formed():
    e2e, layers = BENCH["end_to_end"], BENCH["per_layer"]
    names = [m["name"] for m in e2e + layers]
    assert len(set(names)) == len(names)
    assert "setup_s" in names
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == E2E_KEYS
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    assert next(m for m in e2e if m["name"] == "setup_s")["bound"] <= 0.25
    for m in layers:
        assert set(m) - {"workloads"} == LAYER_KEYS
        assert m["moves"] in {x["name"] for x in e2e}
        assert _line(m["layer"]) and set(m["workloads"]) <= cells
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert callable(harness.metric_reader(m["name"]))
    for m in e2e + layers:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    roof = [m for m in layers if m["name"].endswith("_roofline")
            or "roofline" in m["name"] or "mfu" in m["name"]]
    assert all(m["unit"] == "%" for m in roof)


def test_every_file_under_paths_has_a_plain_name():
    for p in harness.BENCH.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(harness.ROOT).as_posix()
        assert PATH.match(rel), rel


def test_peaks_hold_the_fp32_peak_the_shares_use():
    peak = harness.peaks("NVIDIA H100 80GB HBM3")
    assert peak["flops_per_s"]["float32"] == 67e12
    assert peak["bytes_per_s"] == 3.35e12
    assert harness.peaks("no such card") is None
    assert math.isfinite(peak["memory_bytes"])
