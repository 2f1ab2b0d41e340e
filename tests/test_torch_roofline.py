"""The port's roofline (``repro_torch.launch.roofline``): H100 datasheet
peaks from ``core/codesign.py`` and stated link rates (no TPU constant),
the reference's record keys, what ``StepCounter`` counts for single ops
(FLOPs by dtype, bytes, views, gathers, in-place ops, live storage),
collectives billed by the link their group spans, and ``model_flops_lm``
against the reference's on tiny configs."""

import dataclasses
import inspect

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs.registry import get_arch as jget_arch
from repro.launch import roofline as jroof
from repro.serving.lm import tiny_config as jtiny
from repro_torch.configs.registry import get_arch
from repro_torch.core import codesign
from repro_torch.launch import roofline
from repro_torch.serving.lm import tiny_config as ttiny


def test_peaks_are_the_h100_datasheet_figures():
    assert roofline.PEAK_FLOPS[torch.float32] == codesign.H100_FP32_FLOPS \
        == 67e12
    assert roofline.PEAK_FLOPS[torch.bfloat16] == codesign.H100_BF16_FLOPS \
        == 989e12
    assert roofline.NVLINK_BPS * 2 == codesign.H100_NVLINK_BPS == 900e9
    assert roofline.NETWORK_BPS == 50e9 and roofline.NODE_GPUS == 8
    src = inspect.getsource(roofline)
    for tpu in ("197e12", "819e9", "v5e peak", "ICI_BW", "HBM_BW ="):
        assert tpu not in src.replace("TPU v5e's peaks", "")
    rates = roofline.RATES
    assert rates["fp32_flops"] == 67e12 and rates["hbm_Bps"] == 3.35e12
    assert rates["nvlink_Bps"] == 450e9 and rates["network_Bps"] == 50e9


def test_terms_sum_compute_over_dtypes_and_keep_the_reference_keys():
    t = roofline.RooflineTerms(
        flops_by_dtype={"float32": 67e12, "bfloat16": 989e12},
        hbm_bytes=3.35e12 * 3, coll_bytes=1e9, coll_s=0.5, chips=256)
    assert t.flops == 67e12 + 989e12
    assert t.compute_s == pytest.approx(2.0)
    assert t.memory_s == pytest.approx(3.0)
    assert t.collective_s == 0.5
    assert t.bound == "memory" and t.step_s == pytest.approx(3.0)
    ref_keys = set(jroof.RooflineTerms(1.0, 1.0, 1.0, 1).to_dict())
    d = t.to_dict()
    assert ref_keys <= set(d) and d["rates"] is roofline.RATES
    assert d["flops_by_dtype"] == {"float32": 67e12, "bfloat16": 989e12}


def test_counter_counts_products_by_dtype_and_bytes_once():
    a, b = torch.randn(64, 32), torch.randn(32, 16)
    c = roofline.StepCounter()
    with c:
        a @ b                                   # 2 * 64 * 32 * 16 fp32
        a.bfloat16() @ b.bfloat16()
        a.view(32, 64).t()                      # views move nothing
    assert c.flops[torch.float32] == 2 * 64 * 32 * 16
    assert c.flops[torch.bfloat16] == 2 * 64 * 32 * 16
    mm32 = (64 * 32 + 32 * 16 + 64 * 16) * 4
    casts = (64 * 32 + 32 * 16) * (4 + 2)
    mm16 = (64 * 32 + 32 * 16 + 64 * 16) * 2
    assert c.hbm_bytes == mm32 + casts + mm16


def test_gathers_and_scatters_count_the_rows_they_touch():
    table = torch.randn(1000, 8)
    idx = torch.tensor([1, 5, 7])
    c = roofline.StepCounter()
    with c:
        table.index_select(0, idx)
    assert c.hbm_bytes == 2 * 3 * 8 * 4 + 3 * 8
    c = roofline.StepCounter()
    with c:
        table.index_add_(0, idx, torch.ones(3, 8))
    # the constructor of the source, then the scatter's rows read and
    # written and its source and index read
    assert c.hbm_bytes == 3 * 8 * 4 + (3 * 8 * 4 + 3 * 8) + 2 * 3 * 8 * 4


def test_live_storage_gives_peak_and_temporaries():
    x = torch.randn(256, 256)
    c = roofline.StepCounter()
    c.track_args((x,))
    with c:
        y = torch.relu(x @ x)                   # x@x freed after relu
        out = y.sum(0)
    mem = c.memory(out, (x,))
    n = 256 * 256 * 4
    assert mem["argument_bytes"] == n
    assert mem["output_bytes"] == 256 * 4
    assert mem["peak_bytes"] == n + 2 * n       # x, x @ x, relu's output
    assert mem["temp_bytes"] == mem["peak_bytes"] - n - 256 * 4
    del y


@pytest.mark.parametrize("world,shape,link", [
    (8, (8,), "nvlink"), (16, (16,), "network"), (16, (2, 8), None)])
def test_collectives_are_billed_by_the_link_their_group_spans(world, shape,
                                                              link):
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        names = ("data", "model")[-len(shape):]
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        fm = FakeTensorMode()
        with fm:
            loc = torch.empty(4, 32)
        n = mesh.size(0)
        placements = (Shard(0),) + (Replicate(),) * (len(shape) - 1)
        x = DTensor.from_local(loc, mesh, placements, run_check=False,
                               shape=(4 * n, 32), stride=(32, 1))
        c = roofline.StepCounter(fm, mesh)
        with fm, c:
            x.redistribute(mesh, (Replicate(),) * len(shape))
        got = c.collectives()
        nbytes = 4 * n * 32 * 4
        assert got["bytes_by_op"]["all-gather"] == nbytes
        assert got["counts_by_op"]["all-gather"] == 1
        assert set(got["bytes_by_op"]) == set(jroof._COLLECTIVE_OPS)
        # the mesh's first dim: 8 ranks of stride 1 in one node; 16
        # ranks, or 2 of stride 8, span nodes
        link = link or "network"
        assert got["bytes_by_link"][link] == nbytes
        rate = roofline.NVLINK_BPS if link == "nvlink" \
            else roofline.NETWORK_BPS
        assert c.terms(world).collective_s == pytest.approx(nbytes / rate)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch_id", ["h2o-danube-1.8b", "moonshot-v1-16b-a3b",
                                     "minicpm-2b"])
@pytest.mark.parametrize("train", [True, False])
def test_model_flops_lm_equals_the_reference(arch_id, train):
    jcfg = jtiny(jget_arch(arch_id).model)
    tcfg = ttiny(get_arch(arch_id).model)
    want = jroof.model_flops_lm(jcfg, 4096, train=train)
    assert roofline.model_flops_lm(tcfg, 4096, train=train) == want
    wide = dataclasses.replace(tcfg, n_layers=3)
    assert roofline.model_flops_lm(wide, 10, train=train) == \
        jroof.model_flops_lm(dataclasses.replace(jcfg, n_layers=3), 10,
                             train=train)
