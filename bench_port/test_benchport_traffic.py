"""The traffic generators: deterministic from the seed, of their
documented sizes, and the same work for every seed."""

import numpy as np
import pytest
import torch

from bench_port import harness
from bench_port.data import jedinet_weights
from bench_port.data.jets import make_jets
from bench_port.runners import live, stream


def _mix(name):
    return harness.load_json(harness.BENCH / "traffic" / f"{name}.json")


def _jets(seed, n=64, n_o=30):
    gen = torch.Generator().manual_seed(seed)
    return make_jets(gen, n, n_o)


def test_jets_are_deterministic_from_the_seed():
    x1, y1 = _jets(2 ** 31 + 5)
    x2, y2 = _jets(2 ** 31 + 5)
    x3, _ = _jets(2 ** 31 + 6)
    assert torch.equal(x1, x2) and torch.equal(y1, y2)
    assert not torch.equal(x1, x3)


@pytest.mark.parametrize("n_o", [30, 50])
def test_jets_have_the_documented_shape_and_scale(n_o):
    x, y = _jets(1, n=256, n_o=n_o)
    assert x.shape == (256, n_o, 16) and x.dtype == torch.float32
    assert y.min() >= 0 and y.max() < 5
    assert abs(float(x.mean())) < 1e-4
    assert abs(float(x.std(correction=0)) - 1.0) < 1e-2
    assert torch.isfinite(x).all()


def test_weights_are_deterministic_and_at_lecun_scale():
    model = harness.load_json(
        harness.BENCH / "configs" / "jedinet-50p.json")["model"]
    a = jedinet_weights.make_params(model, torch.Generator().manual_seed(9))
    b = jedinet_weights.make_params(model, torch.Generator().manual_seed(9))
    w = a["fr"]["layers"][1]["w"]
    assert w.shape == (50, 50)
    assert torch.equal(w, b["fr"]["layers"][1]["w"])
    assert abs(float(w.std()) - 50 ** -0.5) < 0.02
    assert [lp["w"].shape[1] for lp in a["phi"]["layers"]] == [50, 50, 50, 5]
    c = jedinet_weights.clone(a)
    c["fr"]["layers"][0]["w"].zero_()
    assert a["fr"]["layers"][0]["w"].abs().sum() > 0


@pytest.mark.parametrize("mix", ["live_30p", "live_50p"])
def test_live_schedule_is_the_same_work_for_every_seed(mix):
    m = _mix(mix)
    rate, seconds, pool = float(m["rate_per_s"]), 2.0, int(m["pool_events"])
    a = live.schedule(m, rate, seconds, 11, pool)
    b = live.schedule(m, rate, seconds, 11, pool)
    c = live.schedule(m, rate, seconds, 2 ** 31 + 12, pool)
    assert len(a.due) == round(rate * seconds)
    np.testing.assert_array_equal(a.due, b.due)
    np.testing.assert_array_equal(a.offsets, b.offsets)
    assert not np.array_equal(a.sizes, c.sizes)
    np.testing.assert_array_equal(np.sort(a.sizes), np.sort(c.sizes))
    np.testing.assert_allclose(np.sort(np.diff(a.due, prepend=0.0)),
                               np.sort(np.diff(c.due, prepend=0.0)),
                               atol=1e-12)
    assert a.sizes.min() >= m["size_min"] and a.sizes.max() <= m["size_max"]
    assert (np.diff(a.due) >= 0).all() and a.due[-1] <= seconds
    assert (a.offsets >= 0).all() and (a.offsets + a.sizes <= pool).all()
    assert abs(a.sizes.mean() - 150.5) < 10


def test_stream_mix_is_the_registrys_stream_shape():
    from repro_torch.configs.registry import get_arch
    m = _mix("stream_1k")
    shape = get_arch("jedinet-30p").shapes["stream_1k"]
    assert m["batch"] == shape.dims["batch"] == 1000
    assert m["pool_batches"] == 64 and m["inflight"] == 2
    assert m["max_batch"] == 1024


def _kept(seed, n, cap):
    keep = stream.Keep(seed, cap)
    for i in range(n):
        keep.offer(i, None)
    return sorted(i for i, _ in keep.kept)


def test_stream_sample_is_from_the_seed_and_spans_the_window():
    kept = _kept(2 ** 31 + 7, 20_000, 640)
    assert kept == _kept(2 ** 31 + 7, 20_000, 640)
    assert kept != _kept(2 ** 31 + 8, 20_000, 640)
    assert len(kept) == len(set(kept)) == 640
    quarters = np.histogram(kept, bins=4, range=(0, 20_000))[0]
    assert quarters.min() > 120
    assert _kept(3, 100, 640) == list(range(100))
