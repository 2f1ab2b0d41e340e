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
    "50p": dict(n_objects=50, fr_hidden=(50, 50, 50), fo_hidden=(50, 50, 50),
                phi_hidden=(50, 50, 50)),
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


def _warp_design_emulation(x, bound, act):
    """B1's warp design step for step in numpy fp32: u_r and u_s per node;
    for receiver r the lane of sender s runs f_R's other layers on
    act(u_r + u_s + b1); the self-edge lane adds zero; lane l sums its
    senders l, l + 32, ... in ascending order, then the lanes by the xor
    tree (16, 8, 4, 2, 1); f_O per node on [x_r || Ebar_r], the node sum
    in node order, phi_O."""
    f = ACT_NP[act]
    fr = [t.numpy().astype(np.float32) for t in bound.fr]
    fo = [t.numpy().astype(np.float32) for t in bound.fo]
    phi = [t.numpy().astype(np.float32) for t in bound.phi]
    sc = [np.float32(1.0)] * 64 if bound.scales is None else \
        [np.float32(float(v)) for v in bound.scales]

    def mlp(h, arrays, scales):
        n = len(arrays) // 2
        for i in range(n):
            h = (h @ arrays[2 * i]) * scales[i] + arrays[2 * i + 1]
            if i < n - 1:
                h = f(h)
        return h

    n_fr_w = 2 + (len(fr) - 3) // 2
    n_fo = len(fo) // 2
    out = []
    for xe in x.astype(np.float32):
        n_o = xe.shape[0]
        u_r, u_s = (xe @ fr[0]) * sc[0], (xe @ fr[1]) * sc[1]
        h = f((u_r[:, None, :] + u_s[None, :, :]) + fr[2])  # (recv, send, H1)
        e = mlp(h, fr[3:], sc[2:n_fr_w])
        e = np.where(np.eye(n_o, dtype=bool)[:, :, None], np.float32(0), e)
        tiles = -(-n_o // 32)
        e = np.concatenate([e, np.zeros((n_o, tiles * 32 - n_o, e.shape[2]),
                                        np.float32)], 1)
        lanes = e[:, 0:32]
        for t in range(1, tiles):
            lanes = lanes + e[:, 32 * t:32 * t + 32]
        width = 32
        while width > 1:
            width //= 2
            lanes = lanes[:, :width] + lanes[:, width:2 * width]
        ebar = lanes[:, 0]
        node = mlp(np.concatenate([xe, ebar], 1), fo,
                   sc[n_fr_w:n_fr_w + n_fo])
        osum = np.zeros(node.shape[1], np.float32)
        for r in range(n_o):
            osum = osum + node[r]
        out.append(mlp(osum, phi, sc[n_fr_w + n_fo:]))
    return np.stack(out)


ACT_NP = {"relu": lambda v: np.maximum(v, np.float32(0))}


def _tile_design_emulation(x, bound, act, tile):
    """B1's tile design step for step in numpy fp32: u_r and u_s per node;
    the event's edges receiver-major over s != r, ``tile`` at a time;
    f_R on act((u_r + u_s) + b1) for the tile's edges; each receiver's
    running sum, started from zero at its first edge and carried across
    tiles, adds its senders in ascending order; f_O per node on [x_r ||
    Ebar_r], the node sum in node order, phi_O."""
    f = ACT_NP[act]
    fr = [t.numpy().astype(np.float32) for t in bound.fr]
    fo = [t.numpy().astype(np.float32) for t in bound.fo]
    phi = [t.numpy().astype(np.float32) for t in bound.phi]
    sc = [np.float32(1.0)] * 64 if bound.scales is None else \
        [np.float32(float(v)) for v in bound.scales]

    def mlp(h, arrays, scales):
        n = len(arrays) // 2
        for i in range(n):
            h = (h @ arrays[2 * i]) * scales[i] + arrays[2 * i + 1]
            if i < n - 1:
                h = f(h)
        return h

    n_fr_w = 2 + (len(fr) - 3) // 2
    n_fo = len(fo) // 2
    out = []
    for xe in x.astype(np.float32):
        n_o = xe.shape[0]
        n_s = n_o - 1
        u_r, u_s = (xe @ fr[0]) * sc[0], (xe @ fr[1]) * sc[1]
        recv = np.repeat(np.arange(n_o), n_s)
        j = np.tile(np.arange(n_s), n_o)
        send = j + (j >= recv)
        ebar = np.zeros((n_o, fr[-2].shape[1]), np.float32)
        for g0 in range(0, n_o * n_s, tile):
            r, s = recv[g0:g0 + tile], send[g0:g0 + tile]
            h = f((u_r[r] + u_s[s]) + fr[2])
            e = mlp(h, fr[3:], sc[2:n_fr_w])
            for t in range(len(r)):
                first = (g0 + t) % n_s == 0
                ebar[r[t]] = (np.float32(0) if first else ebar[r[t]]) + e[t]
        node = mlp(np.concatenate([xe, ebar], 1), fo,
                   sc[n_fr_w:n_fr_w + n_fo])
        osum = np.zeros(node.shape[1], np.float32)
        for r in range(n_o):
            osum = osum + node[r]
        out.append(mlp(osum, phi, sc[n_fr_w + n_fo:]))
    return np.stack(out)


def _held_against_plain_and_jax(cfg, quant, design, emulate):
    """``emulate(x, bound, lay, activation)`` on 2 events of ``cfg``, where B1's plan
    is ``design``, against the plain version (2e-6 of scale: it sums in
    the same order) and JAX's fused_full (5e-4)."""
    jcfg, tcfg, jp, tp, x = _setup(cfg, 2)
    lay = autotune.plan_full(
        tcfg.n_objects, tcfg.n_features, *[
            shared.mlp_widths(tp[k]) for k in ("fr", "fo", "phi")])
    assert lay.design == design
    if quant:
        jp = jax.tree_util.tree_map(np.asarray, jint8.quantize_params_int8(jp))
        tp = tint8.quantize_params_int8(tp)
    bound = ops.bind_full(tp, tcfg)
    emu = emulate(x, bound, lay, tcfg.activation)
    plain = FK.fused_forward_full_plain(
        torch.from_numpy(x), bound.fr, bound.fo, bound.phi,
        activation=tcfg.activation, scales=bound.scales).numpy()
    scale = max(1.0, float(np.abs(plain).max()))
    assert np.abs(emu - plain).max() <= 2e-6 * scale
    forward = jint8.forward_int8_fused_full if quant \
        else jinet.forward_fused_full
    want = np.asarray(forward(jp, jcfg, jnp.asarray(x), interpret=True))
    np.testing.assert_allclose(emu, want, rtol=0, atol=5e-4 * scale)


@pytest.mark.parametrize("cfg,quant", [("30p", False), ("30p", True)])
def test_warp_design_sender_order_matches_plain_and_jax(cfg, quant):
    """B1's warp-per-receiver design (one lane per sender, the xor-tree
    sender sum), emulated in numpy, against the plain version (which sums
    in the same order) and the JAX fused_full."""
    _held_against_plain_and_jax(
        cfg, quant, "warp",
        lambda x, bound, lay, act: _warp_design_emulation(x, bound, act))


@pytest.mark.parametrize("cfg,quant", [("50p", False), ("50p", True)])
def test_tile_design_sender_order_matches_plain_and_jax(cfg, quant):
    """B1's tile design at 50p (tiles of the plan's edges, each
    receiver's running sum in sender order across tiles), emulated in
    numpy, against the plain version (which sums in the same order) and
    the JAX fused_full."""
    _held_against_plain_and_jax(
        cfg, quant, "tile",
        lambda x, bound, lay, act: _tile_design_emulation(x, bound, act,
                                                          lay.block_s))


def test_tree_sender_sum_is_the_xor_butterfly():
    """The plain version's sender sum follows the lanes' xor tree exactly
    (bitwise), at one tile and at several."""
    rng = np.random.RandomState(3)
    for n_s in (13, 30, 50, 64):
        h = torch.from_numpy(rng.normal(0, 1, (2, 3, n_s, 5))
                             .astype(np.float32))
        lanes = [torch.zeros(2, 3, 5) for _ in range(32)]
        for s in range(n_s):
            lanes[s % 32] = h[:, :, s] if s < 32 else lanes[s % 32] + \
                h[:, :, s]
        for off in (16, 8, 4, 2, 1):
            lanes = [lanes[i] + lanes[i ^ off] for i in range(32)]
        assert torch.equal(FK.tree_sender_sum(h), lanes[0])
        assert all(torch.equal(lanes[0], v) for v in lanes)


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
    """B1's source and the device code it includes (the header fields and
    the activation codes live in ``jedi_common.cuh``, shared with B2/B3)."""
    csrc = REPO / "src/repro_torch/kernels/csrc"
    src = (csrc / "fused_jedinet_full.cu").read_text()
    assert '#include "jedi_common.cuh"' in src
    src += (csrc / "jedi_common.cuh").read_text()
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


@pytest.mark.parametrize("n_o,fr,fo,phi,block_s,design", [
    (30, [20, 20, 20, 8], [20, 20, 20, 24], [20, 20, 20, 5], None, "warp"),
    (50, [50, 50, 50, 8], [50, 50, 50, 24], [50, 50, 50, 5], None, "tile"),
    (128, [128, 128, 8], [64, 64, 24], [32, 32, 5], None, "team"),
    (128, [128, 128, 8], [64, 64, 24], [32, 32, 5], 48, "team"),
    (13, [16, 12], [10], [12, 5], 5, "team"),
])
def test_layout_fits_and_is_aligned(n_o, fr, fo, phi, block_s, design):
    """B1's plan: where f_R fits a lane's registers and no sender tile is
    pinned, the warp design up to width 32 and the tile design above it,
    else the team layout; each fits the opt-in shared memory (227 KB)
    with every region 16-byte aligned."""
    lay = autotune.plan_full(n_o, 16, fr, fo, phi, block_s=block_s)
    assert lay.design == design
    assert lay.smem_bytes <= shared.SMEM_BLOCK_BYTES == 227 * 1024
    assert lay.threads % 32 == 0 and lay.threads % lay.team == 0
    assert lay.threads <= shared.MAX_THREADS_PER_BLOCK
    offs = [lay.offsets[k] for k in lay.offsets]
    assert offs == sorted(offs) and all(o % 4 == 0 for o in offs)
    if design == "warp":
        rw = lay.mw
        assert rw in autotune.WARP_REG_WIDTHS and max(fr) <= rw
        assert lay.threads <= autotune.WARP_REG_WIDTHS[rw]
        assert (lay.threads // 32 - 1) * lay.ks >= n_o   # + readout warp
        assert lay.ks % autotune.WARP_RPL[rw] == 0
        assert lay.team == 1 and lay.events_per_block == 1
        assert lay.slot_stride % 2 == 0
        assert lay.slot_stride // 2 >= max(fo[-1], *phi)
        assert set(lay.offsets) == {"w", "b", "x", "part", "us", "ebar",
                                    "obuf", "slot", "pool"}
        fst = max(autotune.pad4(16 + fr[-1]), *map(autotune.pad4, fo)) | 1
        assert lay.offsets["obuf"] - lay.offsets["ebar"] \
            == autotune.pad4(2 * n_o * fst)
        pool = (len(fr) - 2) * (rw * rw + rw) + rw * 8 + 8
        assert lay.smem_words - lay.offsets["pool"] == autotune.pad4(pool)
        ust = autotune.pad4(fr[0]) | 1
        assert lay.offsets["us"] - lay.offsets["part"] >= n_o * ust
        return
    if design == "tile":
        m, rows = lay.mw, max(map(autotune.pad4, fr[:-1]))
        assert m == autotune.TILE_M and lay.block_s % m == 0
        assert lay.block_s <= -(-n_o * (n_o - 1) // m) * m
        assert lay.ks in (lay.block_s, lay.block_s + 4) and lay.ks % 8 == 4
        # one output group of the widest layer per compute thread
        compute, groups = lay.threads - 32, lay.block_s // m
        assert groups % autotune.TILE_LANES == 0
        assert groups * (rows // 4) <= compute
        assert compute - groups * (rows // 4) < 32
        assert lay.threads <= autotune.TILE_THREADS
        assert lay.team == 1 and lay.events_per_block == 1
        assert lay.batch_bytes == 0
        assert lay.slot_stride // 2 >= max(fo[-1], *phi)
        assert set(lay.offsets) == {"w", "b", "x", "part", "us", "ebar",
                                    "obuf", "slot", "osum", "pool"}
        ust = autotune.pad4(fr[0]) | 1
        assert lay.offsets["us"] - lay.offsets["part"] >= n_o * ust
        assert lay.offsets["obuf"] - lay.offsets["ebar"] \
            >= n_o * autotune.pad4(fr[-1])
        assert lay.offsets["pool"] - lay.offsets["osum"] \
            >= lay.block_s * autotune.pad4(fr[-1])
        fst = max(autotune.pad4(16 + fr[-1]), *map(autotune.pad4, fo)) | 1
        pool = lay.smem_words - lay.offsets["pool"]
        assert pool >= rows * lay.ks and pool >= 2 * n_o * fst
        return
    assert lay == autotune.plan_launch(n_o, 16, fr, fo, phi, block_s=block_s)
    assert lay.team in (1, 2, 4, 8, 16, 32)
    assert lay.slot_stride % 2 == 1
    offs = [lay.offsets[k] for k in ("w", "b", "x", "ebar", "part", "us",
                                     "obuf", "osum", "slot")]
    assert offs == sorted(offs)
    if block_s is not None:
        assert lay.block_s == block_s


@pytest.mark.parametrize("plan,n_o,fr,design", [
    ("full", 30, [20, 20, 20, 8], "warp"),
    ("full", 50, [50, 50, 50, 8], "tile"),
    ("full", 50, [20, 20, 20, 8], "warp"),
    ("full", 128, [128, 128, 8], "team"),
    ("edge", 30, [20, 20, 20, 8], "warp"),
    ("edge", 50, [50, 50, 50, 8], "warp"),
])
def test_tile_design_takes_only_b1_above_width_32(plan, n_o, fr, design):
    """The tile design is B1's alone, and only where f_R is wider than 32
    and fits the warp design's test: B1 at 30p (and at 50 nodes of 30p's
    widths) keeps the warp design, tracks_128 the team layout, and B3
    (``plan_edge``, which B2's and B3's CPU tests share) the warp design
    at 50p."""
    if plan == "full":
        lay = autotune.plan_full(n_o, 16, fr, [50, 24], [50, 5])
    else:
        lay = autotune.plan_edge(n_o, 16, fr)
    assert lay.design == design
    assert autotune.full_design(fr) == ("team" if max(fr) > 64 else "warp")


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
