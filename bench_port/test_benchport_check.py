"""The check that decides ``correct``, driven through whole runs on the CPU
at test size: sound runs pass, the controls fail, and so does a run whose
timed path alters an answer where it is produced."""

import pytest
import torch

CELLS = ["jedinet-30p.stream_1k", "jedinet-50p.stream_1k",
         "jedinet-30p.live", "jedinet-50p.live"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_run, cell):
    line = tiny_run(cell, seed=2 ** 31 + 3)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    gap = line["checks"]["logit_gap"]
    assert gap["value"] < gap["limit"] / 10


@pytest.mark.parametrize("control", ["tf32", "bf16"])
@pytest.mark.parametrize("cell", ["jedinet-30p.stream_1k", "jedinet-50p.live"])
def test_control_is_not_correct(tiny_run, cell, control):
    line = tiny_run(cell, seed=11, control=control)
    assert not line["correct"]
    gap = line["checks"]["logit_gap"]
    assert gap["value"] > 3 * gap["limit"]


@pytest.fixture
def altered_answers(monkeypatch):
    """B1's entry point with one logit of every launch moved by a
    thousandth of the logits' scale."""
    from repro_torch.kernels.fused_jedinet import ops
    real = ops.fused_forward_full

    def altered(*args, **kw):
        out = real(*args, **kw).clone()
        out[0, 0] += 1e-3 * max(1.0, float(out.abs().max()))
        return out
    monkeypatch.setattr(ops, "fused_forward_full", altered)


@pytest.mark.parametrize("cell", ["jedinet-30p.stream_1k", "jedinet-30p.live"])
def test_altered_answer_is_not_correct(tiny_run, altered_answers, cell):
    line = tiny_run(cell, seed=5)
    assert not line["correct"]
    assert line["checks"]["logit_gap"]["value"] \
        > line["checks"]["logit_gap"]["limit"]


def test_answer_served_off_the_path_is_a_failure(tiny_run, monkeypatch):
    """A launch that raises demotes the bucket to ``sr_split``: the logits
    are right, but the batch was not served by the configuration's path."""
    from repro_torch.kernels.fused_jedinet import ops
    calls = {"n": 0}
    real = ops.fused_forward_full

    def flaky(*args, **kw):
        calls["n"] += 1
        if calls["n"] == 6:
            raise RuntimeError("launch refused")
        return real(*args, **kw)
    monkeypatch.setattr(ops, "fused_forward_full", flaky)
    line = tiny_run("jedinet-30p.stream_1k", seed=6)
    assert line["failed"] > 0 and not line["correct"]
    assert line["checks"]["failed"]["value"] == line["failed"]


@pytest.fixture
def fused_full_unbuildable(monkeypatch):
    """The engine's ``fused_full`` rung refuses to build, so the engine
    makes ``sr_split`` its base: right logits, off the configured path."""
    from repro_torch.serving import resilient
    real = resilient.ServingEngine

    def engine(*args, forward, **kw):
        if forward == "fused_full":
            raise RuntimeError("fused_full cannot be built")
        return real(*args, forward=forward, **kw)
    monkeypatch.setattr(resilient, "ServingEngine", engine)


@pytest.mark.parametrize("cell", ["jedinet-30p.stream_1k", "jedinet-30p.live"])
def test_path_that_cannot_be_built_fails_every_answer(
        tiny_run, fused_full_unbuildable, cell):
    line = tiny_run(cell, seed=12)
    assert not line["correct"]
    assert line["failed"] == line["attempted"] > 0
    gap = line["checks"]["logit_gap"]
    assert gap["value"] < gap["limit"]


def test_trace_run_line(tiny_run):
    line = tiny_run("jedinet-30p.stream_1k", seed=8, seconds=1.0, trace=True)
    assert set(line) == {"correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"}
    assert list(line)[-1] == "checks"
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert "engine.dispatch_us.stream" in line["metrics"]
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert line["correct"]
    torch.set_num_threads(1)


@pytest.mark.parametrize("cell", ["jedinet-30p.stream_1k", "jedinet-30p.live"])
def test_result_line_holds_only_the_contracts_keys(tiny_run, cell):
    line = tiny_run(cell, seed=9)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    from bench_port import harness
    want = {m["name"] for m in
            harness.resolve(harness.benchmark(), cell).end_to_end}
    assert set(line["metrics"]) == want and "setup_s" in want
    assert want & {"events_per_s", "request_p50_us"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
