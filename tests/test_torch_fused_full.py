"""Port parity of the whole-network fused path (kernel B1's module).

On the CPU the port's wrapper runs the kernel's plain PyTorch version;
it is held against the JAX ``forward_fused_full`` run the way the JAX
tests run it on the CPU (Pallas interpret mode), on the same numpy
inputs and bridged weights, at the reference's tolerance of 5e-4.
The kernel's launch plumbing that the CPU can reach — the shared-memory
layout, the packed weights, the header order shared with the CUDA
source — is checked here too; the kernel itself runs in
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` on the card.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import int8_path as jint8
from repro.core import interaction_net as jinet
from repro.data.jets import make_jets
from repro_torch import bridge
from repro_torch.core import int8_path as tint8
from repro_torch.core import interaction_net as tinet
from repro_torch.kernels import autotune as shared
from repro_torch.kernels import build
from repro_torch.kernels.fused_jedinet import autotune, ops
from repro_torch.kernels.fused_jedinet import full_kernel as FK

REPO = pathlib.Path(__file__).resolve().parent.parent

CFGS = {
    "30p": dict(n_objects=30),
    "13p-narrow": dict(n_objects=13, fr_hidden=(16, 12), fo_hidden=(10,),
                       phi_hidden=(12,)),
}


def _setup(name, batch, **kw):
    cfg_kw = dict(CFGS[name], **kw)
    jcfg = jinet.JediNetConfig(**cfg_kw)
    tcfg = tinet.JediNetConfig(**cfg_kw)
    jp = jax.tree_util.tree_map(
        np.asarray, jinet.init(jax.random.PRNGKey(0), jcfg, scale="lecun"))
    x, _ = make_jets(np.random.RandomState(1), batch, jcfg.n_objects)
    return jcfg, tcfg, jp, bridge.params_from_jax(jp, device="cpu"), x


@pytest.mark.parametrize("cfg,batch", [("30p", 4), ("30p", 3),
                                       ("13p-narrow", 1),
                                       ("13p-narrow", 7)])
def test_fused_full_matches_jax_interpret(cfg, batch):
    jcfg, tcfg, jp, tp, x = _setup(cfg, batch)
    want = np.asarray(jinet.forward_fused_full(jp, jcfg, jnp.asarray(x),
                                               interpret=True))
    got = tinet.forward_fused_full(tp, tcfg, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-4)


def test_int8_fused_full_matches_jax_int8_path():
    jcfg, tcfg, jp, tp, x = _setup("30p", 3)
    jq = jax.tree_util.tree_map(np.asarray, jint8.quantize_params_int8(jp))
    tq = tint8.quantize_params_int8(tp)
    want = np.asarray(jint8.forward_int8_fused_full(
        jq, jcfg, jnp.asarray(x), interpret=True))
    got = tint8.forward_int8_fused_full(tq, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-4)
    ref = tint8._ref_int8(tq, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=5e-4)


def test_fused_full_bf16_matches_jax_bf16():
    """bf16 against JAX bf16: the same operands are rounded to bf16 before
    every product and summed in fp32 in both, in another order; a sum on
    the other side of a bf16 rounding boundary moves that operand by one
    bf16 ulp (2^-8 relative).  Bound: 2e-2 of the logit scale."""
    jcfg, tcfg, jp, tp, x = _setup("30p", 2, compute_dtype="bfloat16")
    want = np.asarray(jinet.forward_fused_full(jp, jcfg, jnp.asarray(x),
                                               interpret=True))
    got = tinet.forward_fused_full(tp, tcfg, torch.from_numpy(x)).numpy()
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= 2e-2 * scale
    fp32 = tinet.forward_fused_full(tp, tcfg.with_(compute_dtype="float32"),
                                    torch.from_numpy(x)).numpy()
    assert np.abs(got - fp32).max() > 0.0        # the bf16 path is live


@pytest.mark.parametrize("block_s", [1, 4, 5, 13])
def test_plain_sender_tiling_is_exact_to_rounding(block_s):
    _, tcfg, _, tp, x = _setup("13p-narrow", 5)
    base = ops.fused_forward_full(tp, tcfg, torch.from_numpy(x))
    out = ops.fused_forward_full(tp, tcfg, torch.from_numpy(x),
                                 block_s=block_s)
    np.testing.assert_allclose(out.numpy(), base.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_partially_quantized_params_are_rejected():
    _, tcfg, _, tp, _ = _setup("13p-narrow", 1)
    tq = tint8.quantize_params_int8(tp)
    mixed = {"fr": tq["fr"], "fo": tp["fo"], "phi": tp["phi"]}
    with pytest.raises(ValueError, match="partially quantized"):
        ops.bind_full(mixed, tcfg)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    _, tcfg, _, tp, x = _setup("13p-narrow", 2)
    bound = ops.bind_full(tp, tcfg)
    kw = dict(activation="relu", n_targets=tcfg.n_targets)
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError, match="x must be"):
        FK.fused_forward_full_kernel_call(xt[:, :, :8], bound, **kw)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        FK.fused_forward_full_kernel_call(xt.double(), bound, **kw)
    with pytest.raises(ValueError, match="activation"):
        FK.fused_forward_full_kernel_call(xt, bound, activation="swish",
                                          n_targets=tcfg.n_targets)
    with pytest.raises(ValueError, match="is on"):
        FK.fused_forward_full_kernel_call(xt.to("meta"), bound, **kw)


def test_cpu_tensors_never_touch_the_kernel():
    _, tcfg, _, tp, x = _setup("13p-narrow", 2)
    before = FK.fused_forward_full_kernel_call.launches
    tinet.forward_fused_full(tp, tcfg, torch.from_numpy(x))
    assert FK.fused_forward_full_kernel_call.launches == before


def test_header_fields_match_the_cuda_source():
    src = (REPO / "src/repro_torch/kernels/csrc/fused_jedinet_full.cu"
           ).read_text()
    block = src[src.index("HEADER-FIELDS-BEGIN"):
                src.index("HEADER-FIELDS-END")]
    fields = re.findall(r"F\((\w+)\)", block)
    assert tuple(fields) == FK.HEADER_FIELDS
    acts = re.findall(r"case (\d+):", src)
    assert [int(a) for a in acts] == list(range(len(FK.ACT_CODES) - 1))


@pytest.mark.parametrize("name", ["30p", "13p-narrow"])
def test_packed_weights_follow_the_layout(name):
    """Every weight and bias can be read back from the packed buffers at
    the offsets the kernel is given, with zero padding columns."""
    _, tcfg, _, tp, _ = _setup(name, 1)
    bound = ops.bind_full(tp, tcfg).pack()
    entries = autotune.kernel_entries(tcfg.n_features, *bound.widths())
    for (w, b), e in zip(bound.weights_and_biases(), entries):
        blk = bound.wpack[e.w_off:e.w_off + e.in_dim * e.out_p]
        blk = blk.reshape(e.in_dim, e.out_p)
        assert torch.equal(blk[:, :e.out_dim], w)
        assert torch.all(blk[:, e.out_dim:] == 0)
        if b is None:
            assert e.b_off == -1
        else:
            assert torch.equal(bound.bpack[e.b_off:e.b_off + e.out_dim], b)
    assert bound.bpack.numel() % 4 == 0


def test_int8_pack_keeps_int8_and_shares_w1_scale():
    _, tcfg, _, tp, _ = _setup("13p-narrow", 1)
    tq = tint8.quantize_params_int8(tp)
    bound = ops.bind_full(tq, tcfg).pack()
    assert bound.wpack.dtype == torch.int8
    assert bound.scales[0] is bound.scales[1]
    assert len(bound.scales) == len(bound.weights_and_biases())


@pytest.mark.parametrize("n_o,fr,fo,phi,block_s", [
    (30, [20, 20, 20, 8], [20, 20, 20, 24], [20, 20, 20, 5], None),
    (50, [50, 50, 50, 8], [50, 50, 50, 24], [50, 50, 50, 5], None),
    (128, [128, 128, 8], [64, 64, 24], [32, 32, 5], None),
    (128, [128, 128, 8], [64, 64, 24], [32, 32, 5], 48),
    (13, [16, 12], [10], [12, 5], 5),
])
def test_layout_fits_and_is_aligned(n_o, fr, fo, phi, block_s):
    lay = autotune.plan_launch(n_o, 16, fr, fo, phi, block_s=block_s)
    assert lay.smem_bytes <= shared.SMEM_BLOCK_BYTES
    assert lay.threads % 32 == 0 and lay.threads % lay.team == 0
    assert lay.threads <= shared.MAX_THREADS_PER_BLOCK
    assert lay.team in (1, 2, 4, 8, 16, 32)
    assert lay.slot_stride % 2 == 1
    offs = [lay.offsets[k] for k in ("w", "b", "x", "ebar", "part", "us",
                                     "obuf", "osum", "slot")]
    assert offs == sorted(offs) and all(o % 4 == 0 for o in offs)
    if block_s is not None:
        assert lay.block_s == block_s


def test_layout_raises_when_nothing_fits():
    with pytest.raises(ValueError, match="no launch"):
        autotune.plan_launch(30, 16, [20, 8], [20, 24], [20, 5],
                             budget_bytes=1024)


def test_bucket_ladder_pads_never_degrades():
    assert shared.bucket_ladder(256, 15936, reserved_bytes=90736) == \
        [8, 16, 32, 64, 128, 256]
    ladder = shared.bucket_ladder(1009, 4096)
    assert ladder[-1] >= 1009 and ladder == sorted(ladder)
    assert shared.bucket_for(ladder, 9) == 16
    assert shared.pick_block_b(1009, 4096, 40960) == 10
    x = torch.ones(5, 3)
    assert shared.pad_batch(x, 4).shape == (8, 3)
    assert shared.pad_batch(x, 5) is x


def test_build_names_library_by_source_hash_and_needs_nvcc(monkeypatch):
    lib = build.library_path(FK.LIB_NAME, FK.SOURCES)
    assert lib.parent == REPO / "build" / "kernels"
    assert lib.name.startswith("libfused_jedinet_full_")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.delenv("CUDA_PATH", raising=False)
    if pathlib.Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("a CUDA toolkit is installed here")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
