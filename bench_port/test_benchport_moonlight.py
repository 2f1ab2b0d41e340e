"""The LM decode cell (moonlight-16b-a3b.decode_8k) and the small live
mix (jedinet-30p.live_small) on the CPU at test size: the frozen
reference, the frozen work counts, the LM trace's kernel attribution,
both runners end to end, and the controls the check must fail.

The LM cell runs the model at ``tiny_config`` (fp32: one dense and two
MoE layers of the published kind, cut to widths a test holds) in place of
the registry's full widths, with its mix cut to 4 slots."""

import dataclasses
import filecmp
import time
import types

import numpy as np
import pytest
import torch

from bench_port import harness, lm_trace, tracing
from bench_port.runners import live_small, lm_decode
from bench_port.work import deepseek_v3 as work

LM_CELL = "moonlight-16b-a3b.decode_8k"
TINY_MIX = dict(slots=4, max_seq=64, prompt_min=6, prompt_max=20, new_min=4,
                new_max=24, requests=400, warm_steps=1, keep_rows=8,
                ref_q_block=16)


def _config():
    return harness.load_json(harness.BENCH / "configs"
                             / "moonlight-16b-a3b.json")


def _tiny_model():
    from repro_torch.configs.registry import get_arch
    from repro_torch.serving.lm import tiny_config
    return tiny_config(get_arch("moonlight-16b-a3b").model)


def _tiny_config_dict(model):
    config = dict(_config(), logit_gap_limit=1e-4, cache_gap_limit=1e-5,
                  route_tie_band=1e-6)
    for key, attr in lm_decode.KEYS.items():
        value = model
        for part in attr.split("."):
            value = getattr(value, part)
        config[key] = value
    config["intermediate_size"] = model.dense_d_ff
    return config


@pytest.fixture
def lm_run(monkeypatch):
    torch.set_num_threads(1)
    model = _tiny_model()
    monkeypatch.setattr(lm_decode, "model_config", lambda config: model)

    def make(*, seed=2 ** 31 + 3, seconds=0.6, trace=False, control=None):
        cell = harness.resolve(harness.benchmark(), LM_CELL)
        cell.config = _tiny_config_dict(model)
        cell.mix.update(TINY_MIX)
        dev = torch.device("cpu")
        run = harness.Run(cell=cell, seed=seed, seconds=seconds, trace=trace,
                          device=dev, tracer=tracing.Tracer(trace, dev),
                          control=control, t_process=time.perf_counter())
        return harness.execute(run)
    return make


def test_the_frozen_reference_is_the_programs():
    assert filecmp.cmp(harness.BENCH / "reference" / "deepseek_v3.py",
                       harness.ROOT / "src" / "repro_torch" / "models"
                       / "plain_deepseek_v3.py", shallow=False)


def test_work_counts_match_hand_counts_at_one_context():
    c = _config()
    d, h, r, dr, f, fs = 2048, 16, 512, 64, 1408, 2816
    proj = 2 * d * h * 192 + 2 * d * 576 + 2 * h * 128 * d
    absorbed = proj + 2 * h * 128 * r + 2 * h * r * 128
    moe = 2 * d * 64 + 6 * 6 * d * f + 6 * d * fs
    token = 27 * absorbed + 6 * d * 11264 + 26 * moe + 2 * d * 163840
    per_pos = 2 * h * (r + dr) + 2 * h * r
    # 96 tokens decoded at a context of 3,700 positions each
    assert work.decode_ops(c, 96, 96 * 3700) == 96 * token \
        + 96 * 3700 * 27 * per_pos
    ops, nbytes = work.mla_decode_work(c, 96, 96 * 3700)
    assert ops == 96 * 3700 * 27 * per_pos
    assert nbytes == 27 * (96 * 3700 * 1152 + 96 * 2 * (576 + h * 576
                                                         + h * r))
    prefill = 4096 * (27 * (proj + 2 * h * 256 * r) + 6 * d * 11264
                      + 26 * moe + 2 * d * 163840) \
        + 4096 * 4097 // 2 * 27 * (2 * h * 192 + 2 * h * 128)
    assert work.prefill_ops(c, 4096) == prefill
    mops, mbytes = work.moe_decode_work(c, 1, 96)
    assert mops == 26 * 96 * moe
    touched = 64 * (1 - (1 - 6 / 64) ** 96)
    assert mbytes == pytest.approx(26 * (touched * 3 * d * f * 2
                                         + 3 * d * fs * 2 + d * 64 * 2
                                         + 64 * 4 + 96 * 2 * d * 2))
    assert work.parameters(c) == 15_960_110_208
    assert work.cache_bytes_per_position(c) == 31_104


def _event(name, start, dur, *, cuda=False, corr=0, activity=""):
    return types.SimpleNamespace(
        name=lambda: name, start_ns=lambda: start, duration_ns=lambda: dur,
        device_type=lambda: (torch.autograd.DeviceType.CUDA if cuda
                             else torch.autograd.DeviceType.CPU),
        correlation_id=lambda: corr, activity_type=lambda: activity)


def _prof(events):
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))


@pytest.mark.parametrize("linked", [True, False])
def test_lm_trace_attributes_kernels_to_the_programs_ranges(linked):
    """Kernels launched inside ``lm.mla`` / ``lm.moe`` count under them,
    by the launch's correlation id or, without one, by the device range;
    the device ranges themselves are not busy time."""
    ev = [_event("bench.window", 0, 1000),
          _event("lm.decode", 100, 600), _event("lm.mla", 120, 100),
          _event("lm.moe", 300, 200),
          _event("lm.mla", 150, 150, cuda=True),
          _event("lm.moe", 400, 300, cuda=True),
          _event("k_attn", 150, 150, cuda=True, corr=7 if linked else 0),
          _event("k_expert", 400, 100, cuda=True, corr=8 if linked else 0),
          _event("k_expert", 600, 100, cuda=True, corr=9 if linked else 0),
          _event("k_head", 800, 50, cuda=True, corr=10 if linked else 0)]
    if linked:
        ev += [_event("cudaLaunchKernel", 130, 5, corr=7),
               _event("cudaLaunchKernel", 310, 5, corr=8),
               _event("cudaLaunchKernel", 320, 5, corr=9),
               _event("cudaLaunchKernel", 750, 5, corr=10)]
    rec = lm_trace.reduce(_prof(ev), {}, {})
    assert rec.under["lm.mla"] == [1, pytest.approx(150e-9)]
    assert rec.under["lm.moe"] == [2, pytest.approx(200e-9)]
    assert rec.busy_s == pytest.approx(400e-9)
    assert set(rec.device_ops) == {"k_attn", "k_expert", "k_head"}
    if linked:
        assert rec.under["lm.decode"][0] == 3
    assert rec.idle_by_span["other"] > 0


def test_lm_decode_runs_correct_and_reports_its_metrics(lm_run):
    line = lm_run()
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"events_per_s", "batch_p99_us",
                                    "setup_s"}
    checks = {k: v["value"] for k, v in line["checks"].items()}
    assert checks["routing_off_tie"] == checks["token_off_tie"] == 0
    assert checks["logit_gap"] < 1e-5
    assert checks["cache_gap"] < 1e-6


def test_lm_decode_traced_run_reads_the_program_spans(lm_run):
    line = lm_run(trace=True, seconds=1.5)
    assert line["correct"], line["checks"]
    m = line["metrics"]
    assert m["lm.decode_us.decode"]["value"] > 0
    assert "device.idle_share.decode" in m
    # no card, no peaks: the rooflines and the mfu have nothing to read
    assert not {"mla_roofline.decode", "moe_roofline.decode",
                "mfu.decode"} & set(m)


@pytest.mark.parametrize("control,check", [
    ("fp8_weights", "logit_gap"), ("fp8_cache", "cache_gap"),
    ("no_shared", "logit_gap"), ("scale1", "logit_gap")])
def test_the_check_fails_each_control(lm_run, control, check):
    assert {control} <= set(lm_decode.CONTROLS)
    line = lm_run(control=control, seconds=0.4)
    assert not line["correct"]
    assert line["checks"][check]["value"] \
        > 10 * line["checks"][check]["limit"]


@pytest.mark.parametrize("fault", ["kv_norm", "attn_norm", "ffn_norm",
                                   "final_norm"])
def test_the_check_fails_a_norm_scale_the_program_drops(lm_run, monkeypatch,
                                                        fault):
    """The program served with one RMSNorm scale replaced by ones, as if
    it never applied it: the benchmark's own draw puts every scale away
    from 1, so the reference sees the difference."""
    from bench_port.data import deepseek_v3_weights as weights
    draw = weights.program_params

    def dropped(w, config):
        p = draw(w, config)
        node = p if fault == "final_norm" else p["layers"]
        node = node["attn"] if fault == "kv_norm" else node
        node[fault] = {"scale": torch.ones_like(node[fault]["scale"])}
        return p
    monkeypatch.setattr(weights, "program_params", dropped)
    line = lm_run(seconds=0.4)
    assert not line["correct"]
    assert line["checks"]["logit_gap"]["value"] \
        > 10 * line["checks"]["logit_gap"]["limit"]


def test_the_benchmarks_weights_fill_the_programs_tree():
    """Every path and shape of the program's own MLA parameters, the norm
    scales away from 1, the same seed the same weights; the reference's
    layers read the same tensors."""
    from bench_port.data import deepseek_v3_weights as weights
    from repro_torch.models import transformer as tfm
    from repro_torch.common.tree import path_map
    model = _tiny_model()
    config = _tiny_config_dict(model)
    w = weights.draw(config, 2 ** 40 + 9, "cpu")
    got = {}
    path_map(lambda path, t: got.setdefault(path, tuple(t.shape)),
             weights.program_params(w, config))
    want = {path: tuple(shape)
            for path, (shape, _, _) in tfm.mla_shapes(model).items()}
    assert got == want
    for name in ("attn_norm", "ffn_norm", "kv_norm", "final_norm"):
        assert 0.05 < float((w[name] - 1).std()) < 0.2
    assert w["router_bias"].dtype == torch.float32
    again = weights.draw(config, 2 ** 40 + 9, "cpu")
    assert all(torch.equal(w[n], again[n]) for n in w)
    outer, layer = weights.reference_weights(w, config)
    assert torch.equal(layer(2)["experts_w_in"], w["experts_w_in"][1])
    assert torch.equal(outer()["embed"], w["embed"])


def test_requests_are_the_same_work_for_every_seed():
    from bench_port.data import lm_tokens
    mix = harness.load_json(harness.BENCH / "traffic" / "lm_decode_8k.json")
    mix = dict(mix, requests=300)
    a = lm_tokens.requests(mix, 2 ** 31 + 1, 163840)
    b = lm_tokens.requests(mix, 2 ** 31 + 1, 163840)
    c = lm_tokens.requests(mix, 2 ** 31 + 2, 163840)
    assert all(np.array_equal(x[0], y[0]) and x[1:] == y[1:]
               for x, y in zip(a, b))

    def shapes(reqs):   # (prompt, max_new) as first drawn
        return sorted((len(t) - d, m + d) for t, m, d in reqs)
    assert shapes(a) == shapes(c) and a[0][0].tolist() != c[0][0].tolist()
    for toks, max_new, pre in a:
        assert 1024 <= len(toks) - pre <= 4096
        assert 512 <= max_new + pre <= 4096 and max_new >= 1
        assert len(toks) + max_new <= 8192
        assert toks.dtype == np.int32 and 0 <= toks.min() \
            and toks.max() < 163840
    assert all(pre == 0 for _, _, pre in a[96:])
    assert sum(pre > 0 for _, _, pre in a[:96]) > 80
    # the same mid-flight states for every seed, stratified: one first
    # request's share of its max_new in each 96th
    assert sorted((len(t), m, d) for t, m, d in a[:96]) \
        == sorted((len(t), m, d) for t, m, d in c[:96])
    share = sorted(pre / (max_new + pre) for _, max_new, pre in a[:96])
    assert all(i / 96 - 1 / 512 <= x < (i + 1) / 96
               for i, x in enumerate(share))


def test_live_small_sizes_are_one_plus_poisson():
    mix = harness.load_json(harness.BENCH / "traffic" / "live_small.json")
    a = live_small.schedule(mix, 4000, 10.0, 2 ** 31 + 3, 65536)
    b = live_small.schedule(mix, 4000, 10.0, 2 ** 31 + 4, 65536)
    assert a.sizes.min() == 1 and abs(a.sizes.mean() - 4.0) < 0.05
    np.testing.assert_array_equal(np.sort(a.sizes), np.sort(b.sizes))
    assert len(a.due) == 40000 and a.due[-1] <= 10.0
    assert (a.offsets + a.sizes <= 65536).all()


def test_live_small_runs_correct_and_packs_requests():
    torch.set_num_threads(1)
    cell = harness.resolve(harness.benchmark(), "jedinet-30p.live_small")
    cell.mix.update(rate_per_s=200, pool_events=512, max_batch=32,
                    warm_requests=8)
    dev = torch.device("cpu")
    run = harness.Run(cell=cell, seed=2 ** 31 + 5, seconds=1.0, trace=True,
                      device=dev, tracer=tracing.Tracer(True, dev),
                      t_process=time.perf_counter())
    line = harness.execute(run)
    assert line["correct"], line["checks"]
    assert line["metrics"]["front.events_per_plan.live"]["value"] > 2
    assert "device.idle_share.live" in line["metrics"]


def test_the_lm_cell_has_its_metrics_and_no_others():
    cell = harness.resolve(harness.benchmark(), LM_CELL)
    assert {m["name"] for m in cell.end_to_end} == {
        "events_per_s", "batch_p99_us", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "lm.decode_us.decode", "lm.admit_us.decode", "mla_roofline.decode",
        "moe_roofline.decode", "mfu.decode", "device.idle_share.decode"}
    assert dataclasses.is_dataclass(lm_trace.LMTraceRecord)
