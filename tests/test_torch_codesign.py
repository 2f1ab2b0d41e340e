"""The port's co-design models against the reference's.

``FPGAModel`` and the DSE are backend-free and must reproduce the
reference exactly; ``H100Model`` keeps the reference ``TPUModel``'s work
counts (FLOPs, HBM bytes) and divides by the H100 datasheet's peaks,
the fp32 one for 4-byte operands and the bf16 tensor-core one for 2.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import codesign as jcs
from repro.core import interaction_net as jinet
from repro.core import paths as jpaths
from repro_torch.core import codesign as tcs
from repro_torch.core import interaction_net as tinet
from repro_torch.core import paths
from repro_torch.launch import trigger_serve
from repro_torch.serving import ResilientEngine, ServingEngine


def _port_cfg(jcfg):
    return tinet.JediNetConfig(**{f.name: getattr(jcfg, f.name)
                                  for f in dataclasses.fields(jcfg)})


def _cfg_key(cfg):
    return dataclasses.astuple(cfg)


# -- FPGA model and DSE: exactly the reference -----------------------------


def test_fpga_model_equals_reference_on_paper_table2():
    want = jcs.paper_table2_points()
    got = tcs.paper_table2_points()
    assert [p["name"] for p in got] == [p["name"] for p in want]
    assert len(got) == 10
    for g, w in zip(got, want):
        assert _cfg_key(g["cfg"]) == _cfg_key(w["cfg"])
        assert (g["paper_ii_cycles"], g["paper_latency_cycles"]) == \
            (w["paper_ii_cycles"], w["paper_latency_cycles"])
        pt_g = tcs.FPGADesignPoint(cfg=g["cfg"], n_fr=g["n_fr"],
                                   r_fo=g["r_fo"])
        pt_w = jcs.FPGADesignPoint(cfg=w["cfg"], n_fr=w["n_fr"],
                                   r_fo=w["r_fo"])
        assert tcs.FPGAModel.evaluate(pt_g) == jcs.FPGAModel.evaluate(pt_w)


def test_explore_equals_reference_on_jedi_30p():
    jbase = jinet.JediNetConfig(n_objects=30, n_features=16)
    want = jcs.explore(jbase, latency_budget_us=1.0, alpha=2.0)
    got = tcs.explore(_port_cfg(jbase), latency_budget_us=1.0, alpha=2.0)
    for k in ("n_total", "n_pruned_dsp", "n_pruned_latency", "n_survivors",
              "training_runs_saved"):
        assert got[k] == want[k], k
    assert got["n_survivors"] > 0 and got["training_runs_saved"] > 0
    for g, w in zip(got["survivors"], want["survivors"]):
        assert (_cfg_key(g.cfg), g.n_fr, g.r_fo) == \
            (_cfg_key(w.cfg), w.n_fr, w.r_fo)
        assert g.fpga == w.fpga and g.accuracy == w.accuracy
        assert g.gpu["flops"] == w.tpu["flops"]
        assert g.gpu["hbm_bytes"] == w.tpu["hbm_bytes"]
    for pick in ("opt_latn", "opt_acc"):
        g, w = got[pick], want[pick]
        assert (_cfg_key(g.cfg), g.n_fr, g.r_fo) == \
            (_cfg_key(w.cfg), w.n_fr, w.r_fo), pick
    assert not hasattr(got["survivors"][0], "tpu")


def test_accuracy_proxy_and_linear_flops_equal_reference():
    for w in jcs.paper_table2_points():
        cfg = w["cfg"]
        assert tcs.capacity_accuracy_proxy(cfg) == \
            jcs.capacity_accuracy_proxy(cfg)
        assert tcs.jedi_linear_flops(cfg, 7) == jcs.jedi_linear_flops(cfg, 7)


@pytest.mark.parametrize("n_objects", [8, 30, 50])
def test_flops_for_equals_reference_for_every_registered_path(n_objects):
    jcfg = jinet.JediNetConfig(n_objects=n_objects, n_features=16)
    cfg = _port_cfg(jcfg)
    names = paths.available()
    assert set(names) <= set(jpaths.available())
    for name in names:
        assert paths.get(name).flops_for(cfg, 256) == \
            jpaths.get(name).flops_for(jcfg, 256), name


@pytest.mark.parametrize("level", ["none", "edge", "full"])
def test_work_counts_equal_the_reference_tpu_model(level):
    jcfg = jinet.JediNetConfig(n_objects=30, n_features=16)
    cfg = _port_cfg(jcfg)
    for wb in (None, 1):
        for cb in (2, 4):
            assert tcs.H100Model.hbm_bytes(cfg, 64, cb, level,
                                           weight_bytes=wb) == \
                jcs.TPUModel.hbm_bytes(jcfg, 64, cb, level, weight_bytes=wb)
    assert tcs.H100Model.flops(cfg, 64) == jcs.TPUModel.flops(jcfg, 64)
    with pytest.raises(ValueError, match="fused level"):
        tcs.H100Model.hbm_bytes(cfg, 64, 4, False)


# -- the H100 model -----------------------------------------------------------


def test_h100_model_picks_the_peak_by_operand_width():
    assert tcs.H100_FP32_FLOPS == 67e12 and tcs.H100_BF16_FLOPS == 989e12
    assert tcs.H100_HBM_BPS == 3.35e12 and tcs.H100_NVLINK_BPS == 900e9
    cfg = tinet.JediNetConfig()
    for cb, peak in ((4, 67e12), (2, 989e12)):
        m = tcs.H100Model.evaluate(
            tcs.H100DesignPoint(cfg=cfg, batch=4096, compute_bytes=cb),
            "full")
        assert m["peak_flops"] == peak and m["compute_bytes"] == cb
        assert m["compute_s"] == m["flops"] / peak
        assert m["memory_s"] == m["hbm_bytes"] / 3.35e12
        assert m["step_us"] == max(m["compute_s"], m["memory_s"]) * 1e6
    with pytest.raises(ValueError, match="compute peak"):
        tcs.H100Model.evaluate(tcs.H100DesignPoint(cfg=cfg, compute_bytes=1))
    assert not [n for n in dir(tcs) if "TPU" in n]


def test_bucket_roofline_goes_compute_bound_with_the_bucket():
    """A one-event bucket pays the weights' HBM bill; a large one
    amortizes it.  At the fp32 peak the dense edge grid is compute-bound
    from one event on, 15x slower than at the bf16 peak."""
    cfg = tinet.JediNetConfig()
    for cb, flops_fn in ((2, None), (4, tcs.jedi_linear_flops)):
        r = tcs.bucket_roofline(cfg, [1, 4096], compute_bytes=cb,
                                flops_fn=flops_fn)
        assert r[1]["bound"] == "memory" and r[4096]["bound"] == "compute"
        assert r[4096]["per_event_us"] < r[1]["per_event_us"]
    fp32 = tcs.bucket_roofline(cfg, [1, 4096], compute_bytes=4)
    bf16 = tcs.bucket_roofline(cfg, [4096], compute_bytes=2)
    assert fp32[1]["bound"] == "compute"
    assert fp32[4096]["compute_s"] == pytest.approx(
        bf16[4096]["compute_s"] * 989 / 67)


def test_roofline_for_threads_the_flops_hook_and_weight_bytes():
    cfg = tinet.JediNetConfig(n_objects=50)
    lin = paths.get("jedi_linear_full").roofline_for(cfg, [1024])[1024]
    dense = paths.get("fused_full").roofline_for(cfg, [1024])[1024]
    assert lin["flops"] < dense["flops"] / 10
    int8 = paths.get("int8_fused_full").roofline_for(cfg, [8])[8]
    fp = paths.get("fused_full").roofline_for(cfg, [8])[8]
    assert int8["weight_bytes"] == 1 and int8["hbm_bytes"] < fp["hbm_bytes"]


def test_path_bucket_policy_resolves_the_engine_ladder():
    cfg = tinet.JediNetConfig(n_objects=8)
    params = tinet.init(0, cfg, device="cpu")
    spec = paths.get("int8_fused_full")
    pol = tcs.path_bucket_policy(spec, cfg, params, max_batch=64,
                                 compute_bytes=4)
    eng = ServingEngine(params, cfg, forward=spec.name, device="cpu",
                        max_batch=64)
    assert pol["bucket_ladder"] == eng.bucket_sizes
    assert sorted(pol["roofline"]) == eng.bucket_sizes
    assert pol["weight_bytes"] == 1 and pol["reserved_smem_bytes"] > 0


@pytest.mark.parametrize("forward,dtype,width,peak", [
    ("jedi_linear_full", "float32", 4, 67e12),
    ("fused_full", "bfloat16", 2, 989e12)])
def test_engines_report_the_base_rung_roofline(forward, dtype, width, peak):
    """Both engines bill the base rung at their compute dtype's width:
    fp32 at the CUDA-core peak, bf16 at the tensor-core peak."""
    cfg = tinet.JediNetConfig(n_objects=8, compute_dtype=dtype)
    params = tinet.init(0, cfg, device="cpu")
    eng = ResilientEngine(params, cfg, forward=forward, device="cpu",
                          max_batch=16)
    r = eng.roofline([16])
    assert r == paths.get(forward).roofline_for(cfg, [16],
                                                compute_bytes=width)
    assert r[16]["peak_flops"] == peak and r[16]["compute_bytes"] == width
    base = eng._engines[0].roofline()
    assert sorted(base) == eng.bucket_sizes
    assert np.isfinite([m["step_us"] for m in base.values()]).all()


# -- the CLI's roofline line ---------------------------------------------------


@pytest.mark.parametrize("dtype,peak,width", [("float32", "67", 4),
                                              ("bfloat16", "989", 2)])
def test_cli_prints_the_roofline_at_the_compute_dtype_peak(capsys, dtype,
                                                           peak, width):
    trigger_serve.main(["--device", "cpu", "--n-objects", "8",
                        "--batch", "8", "--batches", "4",
                        "--compute-dtype", dtype])
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if "roofline" in ln)
    cfg = tinet.JediNetConfig(n_objects=8, compute_dtype=dtype)
    want = paths.get("fused_full").roofline_for(
        cfg, [8], compute_bytes=width)[8]
    assert f"modeled {want['step_us']:.1f} us/step" in line
    assert f"level=full, H100 peak {peak} TFLOP/s at {width} B/operand" \
        in line
