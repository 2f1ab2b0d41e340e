"""Port parity of the edge-block fused path (kernel B3's module).

On the CPU the port's wrapper runs the kernel's plain version; it is held
against the JAX edge kernel run in Pallas interpret mode, and the
``fused`` path against the JAX ``forward_fused``, on the same numpy
inputs and bridged weights at the reference's 5e-4 (results scaled to at
least 1).  The reference sums the whole grid and subtracts the diagonal;
the port masks the self-edge before the sum.  The kernel itself runs in
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` on the card.
"""

import functools
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import interaction_net as jinet
from repro.data.jets import make_jets
from repro.kernels.fused_jedinet import ops as jops
from repro_torch import bridge
from repro_torch.configs import jedi_50p, jedi_tracks_128
from repro_torch.core import int8_path as tint8
from repro_torch.core import interaction_net as tinet
from repro_torch.core import paths as tpaths
from repro_torch.kernels import autotune as shared
from repro_torch.kernels.fused_jedinet import autotune, ops
from repro_torch.kernels.fused_jedinet import full_kernel as FK
from repro_torch.kernels.fused_jedinet import kernel as EK
from repro_torch.serving import ResilientEngine

REPO = pathlib.Path(__file__).resolve().parent.parent

CFGS = {
    "30p": dict(n_objects=30),
    "50p": dict(n_objects=50, fr_hidden=(50, 50, 50), fo_hidden=(50, 50, 50),
                phi_hidden=(50, 50, 50)),
    "13p-narrow": dict(n_objects=13, fr_hidden=(16, 12), fo_hidden=(10,),
                       phi_hidden=(12,)),
    "128p-narrow": dict(n_objects=128, fr_hidden=(12,), fo_hidden=(8,),
                        phi_hidden=(8,)),
}


@functools.lru_cache(maxsize=None)
def _jax_init(jcfg):
    """The JAX init as one compiled call (op by op it compiles for
    seconds per config)."""
    return jax.jit(lambda key: jinet.init(key, jcfg, scale="lecun"))(
        jax.random.PRNGKey(0))


def _setup(name, batch, **kw):
    cfg_kw = dict(CFGS[name], **kw)
    jcfg = jinet.JediNetConfig(**cfg_kw)
    tcfg = tinet.JediNetConfig(**cfg_kw)
    jp = jax.tree_util.tree_map(np.asarray, _jax_init(jcfg))
    x, _ = make_jets(np.random.RandomState(1), batch, jcfg.n_objects)
    return jcfg, tcfg, jp, bridge.params_from_jax(jp, device="cpu"), x


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


@pytest.mark.parametrize("cfg,batch", [("30p", 4), ("30p", 13),
                                       ("13p-narrow", 7),
                                       ("128p-narrow", 2)])
def test_edge_block_matches_jax_interpret(cfg, batch):
    jcfg, tcfg, jp, tp, x = _setup(cfg, batch)
    want = jops.fused_edge_block(jp["fr"], jcfg, jnp.asarray(x),
                                 interpret=True)
    got = ops.fused_edge_block(tp["fr"], tcfg, torch.from_numpy(x))
    _close(got.numpy(), want, 5e-4)


@pytest.mark.parametrize("cfg", ["30p", "13p-narrow"])
def test_fused_path_matches_jax_forward_fused(cfg):
    jcfg, tcfg, jp, tp, x = _setup(cfg, 3)
    want = jinet.forward_fused(jp, jcfg, jnp.asarray(x), interpret=True)
    got = tinet.forward_fused(tp, tcfg, torch.from_numpy(x))
    _close(got.numpy(), want, 5e-4)


def test_edge_block_bf16_matches_jax_bf16():
    """bf16 against the JAX edge kernel in bf16: the same operands are
    rounded to bf16 before every product and summed in fp32, the JAX
    kernel over the whole grid minus its diagonal, the port without the
    self-edge; a sum on the other side of a bf16 rounding boundary moves
    one operand by one bf16 ulp (2^-8 relative).  Bound: 1e-3 of the
    Ebar scale."""
    jcfg, tcfg, jp, tp, x = _setup("30p", 4, compute_dtype="bfloat16")
    want = jops.fused_edge_block(jp["fr"], jcfg, jnp.asarray(x),
                                 interpret=True)
    got = ops.fused_edge_block(tp["fr"], tcfg, torch.from_numpy(x))
    _close(got.numpy(), want, 1e-3)
    fp32 = ops.fused_edge_block(tp["fr"], tcfg.with_(compute_dtype="float32"),
                                torch.from_numpy(x))
    assert float((got - fp32).abs().max()) > 0.0     # the bf16 path is live


@pytest.mark.parametrize("block_s", [1, 4, 13])
def test_plain_sender_tiling_is_exact_to_rounding(block_s):
    _, tcfg, _, tp, x = _setup("13p-narrow", 5)
    base = ops.fused_edge_block(tp["fr"], tcfg, torch.from_numpy(x))
    out = ops.fused_edge_block(tp["fr"], tcfg, torch.from_numpy(x),
                               block_s=block_s)
    np.testing.assert_allclose(out.numpy(), base.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_int8_is_rejected():
    _, tcfg, _, tp, x = _setup("13p-narrow", 2)
    tq = tint8.quantize_params_int8(tp)
    with pytest.raises(ValueError, match="int8"):
        ops.fused_edge_block(tq["fr"], tcfg, torch.from_numpy(x))
    bound = ops.bind_full(tq, tcfg)
    bound.fo, bound.phi = [], []
    with pytest.raises(ValueError, match="no int8"):
        EK.fused_edge_block_kernel_call(torch.from_numpy(x), bound,
                                        activation="relu")


def test_wrapper_takes_f_r_alone():
    _, tcfg, _, tp, x = _setup("13p-narrow", 2)
    with pytest.raises(ValueError, match="alone"):
        EK.fused_edge_block_kernel_call(torch.from_numpy(x),
                                        ops.bind_full(tp, tcfg),
                                        activation="relu")


def test_cpu_tensors_never_touch_the_kernel():
    _, tcfg, _, tp, x = _setup("13p-narrow", 2)
    before = EK.fused_edge_block_kernel_call.launches
    tinet.forward_fused(tp, tcfg, torch.from_numpy(x))
    assert EK.fused_edge_block_kernel_call.launches == before


def test_fused_path_registration_and_engine():
    jcfg, tcfg, jp, tp, x = _setup("13p-narrow", 5)
    spec = tpaths.get("fused")
    assert (spec.cuda, spec.fused_level, spec.tolerance, spec.fallback) \
        == (True, "edge", 5e-4, "sr")
    assert tpaths.fallback_chain("fused") == ["fused", "sr"]
    want = jinet.forward_sr(jp, jcfg, jnp.asarray(x))
    eng = ResilientEngine(tp, tcfg, forward="fused", device="cpu",
                          max_batch=8)
    res = eng.run_stream([x, x, x], warmup=1)
    assert res["events"] == 10
    _close(eng.infer(x), want, 5e-4)
    assert eng.active_path(res["bucket"]) == "fused"
    assert not eng.health()["counters"]
    bound = spec.bind(tp, tcfg)                   # f_R packed, f_O kept
    assert isinstance(bound["fr"], FK.KernelWeights)
    assert bound["fo"] is tp["fo"] and bound["phi"] is tp["phi"]


def test_header_fields_and_launch_symbols_match_the_cuda_source():
    csrc = REPO / "src/repro_torch/kernels/csrc"
    src = (csrc / EK.SOURCES[0]).read_text()
    assert '#include "jedi_common.cuh"' in src
    common = (csrc / "jedi_common.cuh").read_text()
    block = common[common.index("HEADER-FIELDS-BEGIN"):
                   common.index("HEADER-FIELDS-END")]
    assert tuple(re.findall(r"F\((\w+)\)", block)) == FK.HEADER_FIELDS
    assert '#include "jedi_warp.cuh"' in src
    # both designs' entry points, under the names the wrapper builds
    for symbol in ("jedi_edge_block", "jedi_edge_block_warp"):
        for sym in (f"{symbol}_launch", f"{symbol}_header_len"):
            assert f"int {sym}(" in src
    full = (csrc / "fused_jedinet_full.cu").read_text()
    assert "edge_block(a, smem, t);" in src     # B1's edge stage, shared:
    assert "edge_block(a, smem, t);" in full    # the team layout's
    # and the warp design's, defined once in jedi_warp.cuh
    warp = (csrc / "jedi_warp.cuh").read_text()
    for name in ("edge_sums", "node_halves", "stage_fr_padded",
                 "launch_resident"):
        assert re.search(rf"\b{name}\(", warp)
        for text in (src, full):
            assert re.search(rf"\b{name}(<[^>]*>)?\(", text), name
    # Ebar leaves the warp design from shared memory, one coalesced pass
    assert "dst[i] = EB[i];" in src


@pytest.mark.parametrize("n_o,fr,block_s", [
    (30, [20, 20, 20, 8], None),
    (50, [50, 50, 50, 8], None),
    (128, [128, 128, 8], None),
    (128, [128, 128, 8], 48),
    (13, [16, 12], 5),
])
def test_edge_layout_fits_and_is_aligned(n_o, fr, block_s):
    lay = autotune.plan_launch(n_o, 16, fr, block_s=block_s)
    assert lay.smem_bytes <= shared.SMEM_BLOCK_BYTES
    assert lay.threads % 32 == 0 and lay.threads % lay.team == 0
    assert lay.team in (1, 2, 4, 8, 16, 32)
    assert lay.slot_stride % 2 == 1
    offs = [lay.offsets[k] for k in ("w", "b", "x", "ebar", "part", "us",
                                     "obuf", "osum", "slot")]
    assert offs == sorted(offs) and all(o % 4 == 0 for o in offs)
    assert lay.offsets["obuf"] == lay.offsets["osum"] == lay.offsets["slot"]
    full = autotune.plan_launch(n_o, 16, fr, [20, 24], [20, 5],
                                block_s=block_s)
    assert lay.smem_bytes < full.smem_bytes      # no f_O / phi_O regions
    if block_s is not None:
        assert lay.block_s == block_s


def test_edge_layout_raises_when_nothing_fits():
    with pytest.raises(ValueError, match="edge-block"):
        autotune.plan_launch(30, 16, [20, 8], budget_bytes=1024)


def test_fused_ladder_comes_from_the_edge_layout():
    """B3's warp design walks the batch one event at a time (no batch
    tile), so ``fused`` earns plain doublings up to max_batch, the ladder
    of fused_full at jedi_30p; where the team layout holds
    (jedi_tracks_128) its tiles still set the ladder."""
    _, tcfg, _, tp, _ = _setup("30p", 1)
    lay = autotune.edge_layout_for(tcfg, tp)
    spec = tpaths.get("fused")
    assert lay.design == "warp" and lay.batch_bytes == 0
    assert spec.bucket_bytes(tcfg, tp) == 0
    assert spec.reserved_smem_bytes(tcfg, tp) == lay.reserved_bytes
    assert spec.bucket_ladder(tcfg, tp, 256) == [8, 16, 32, 64, 128, 256] \
        == tpaths.get("fused_full").bucket_ladder(tcfg, tp, 256)
    assert spec.bucket_ladder(tcfg, tp, 1000) == [
        8, 16, 32, 64, 128, 256, 512, 1000]
    for cfg in (jedi_50p.MODEL, jedi_tracks_128.MODEL):
        params = tinet.init(0, cfg, scale="lecun", device="cpu")
        lay = autotune.edge_layout_for(cfg, params)
        ladder = spec.bucket_ladder(cfg, params, 256)
        if cfg.n_objects == 50:
            assert lay.design == "warp"
            assert ladder == [8, 16, 32, 64, 128, 256]
        else:
            assert lay.design == "team"
            assert spec.bucket_bytes(cfg, params) == lay.per_event_bytes
            assert ladder == shared.bucket_ladder(
                256, lay.per_event_bytes, reserved_bytes=lay.reserved_bytes)


@pytest.mark.parametrize("n_o,fr,block_s,design", [
    (30, [20, 20, 20, 8], None, "warp"),
    (50, [50, 50, 50, 8], None, "warp"),
    (13, [16, 12, 8], None, "warp"),
    (30, [20, 20, 20, 8], 30, "team"),
    (128, [128, 128, 8], None, "team"),
    (128, [128, 128, 8], 48, "team"),
])
def test_plan_edge_picks_b1s_design(n_o, fr, block_s, design):
    """B3's plan follows B1's rule: the warp design where f_R fits a
    lane's registers and no sender tile is pinned, else the team layout;
    either fits the opt-in shared memory, 16-byte aligned."""
    lay = autotune.plan_edge(n_o, 16, fr, block_s=block_s)
    assert lay.design == design
    assert lay.design == autotune.full_design(fr, block_s)
    assert lay.smem_bytes <= shared.SMEM_BLOCK_BYTES
    assert lay.threads % 32 == 0
    assert lay.threads <= shared.MAX_THREADS_PER_BLOCK
    offs = list(lay.offsets.values())
    assert offs == sorted(offs) and all(o % 4 == 0 for o in offs)
    if design == "team":
        assert lay == autotune.plan_launch(n_o, 16, fr, block_s=block_s)
        assert lay.batch_bytes == lay.per_event_bytes
        return
    # B1's warp design without the readout warp, f_O and phi_O
    rw = lay.mw
    assert rw in autotune.WARP_REG_WIDTHS and max(fr) <= rw
    assert lay.threads <= autotune.WARP_REG_WIDTHS[rw]
    assert (lay.threads // 32) * lay.ks >= n_o       # every warp computes
    assert lay.ks % autotune.WARP_RPL[rw] == 0
    assert (lay.team, lay.events_per_block, lay.batch_bytes) == (1, 1, 0)
    assert set(lay.offsets) == {"w", "b", "x", "part", "us", "ebar", "pool"}
    ust = autotune.pad4(fr[0]) | 1
    assert lay.offsets["us"] - lay.offsets["part"] >= n_o * ust
    assert lay.offsets["pool"] - lay.offsets["ebar"] >= n_o * fr[-1]
    pool = (len(fr) - 2) * (rw * rw + rw) + rw * 8 + 8
    assert lay.smem_words - lay.offsets["pool"] == autotune.pad4(pool)
    full = autotune.plan_full(n_o, 16, fr, [20, 24], [20, 5])
    assert full.design == "warp" and lay.smem_bytes < full.smem_bytes


ACT_NP = {"relu": lambda v: np.maximum(v, np.float32(0))}


def _warp_edge_emulation(x, bound, act):
    """B3's warp design step for step in numpy fp32: u_r and u_s per
    node; for receiver r the lane of sender s runs f_R's other layers on
    act(u_r + u_s + b1); the self-edge lane adds zero; lane l sums its
    senders l, l + 32, ... in ascending order, then the lanes by the xor
    tree (16, 8, 4, 2, 1)."""
    f = ACT_NP[act]
    fr = [t.numpy().astype(np.float32) for t in bound.fr]
    out = []
    for xe in x.astype(np.float32):
        n_o = xe.shape[0]
        u_r, u_s = xe @ fr[0], xe @ fr[1]
        h = (u_r[:, None, :] + u_s[None, :, :]) + fr[2]
        for i in range(3, len(fr), 2):
            h = f(h) @ fr[i] + fr[i + 1]
        h = np.where(np.eye(n_o, dtype=bool)[:, :, None], np.float32(0), h)
        lanes = [None] * 32
        for s in range(n_o):
            lanes[s % 32] = h[:, s] if lanes[s % 32] is None \
                else lanes[s % 32] + h[:, s]
        lanes = [np.zeros_like(h[:, 0]) if t is None else t for t in lanes]
        for off in (16, 8, 4, 2, 1):
            lanes = [lanes[i] + lanes[i ^ off] for i in range(32)]
        out.append(lanes[0])
    return np.stack(out)


@pytest.mark.parametrize("cfg", ["30p", "50p"])
def test_warp_design_sender_order_matches_plain_and_jax(cfg):
    """B3's warp design (one lane per sender, sender tiles of 32 at 50p,
    the xor-tree sender sum), emulated in numpy, against the plain
    version, which sums in the same order (the products' own sums may
    differ by an ulp: 2e-6 of the scale), and the JAX edge kernel at the
    reference's 5e-4."""
    jcfg, tcfg, jp, tp, x = _setup(cfg, 2)
    assert autotune.edge_layout_for(tcfg, tp).design == "warp"
    bound = ops.bind_edge(tp["fr"], tcfg)
    emu = _warp_edge_emulation(x, bound, tcfg.activation)
    plain = EK.fused_edge_block_plain(torch.from_numpy(x), bound.fr,
                                      activation=tcfg.activation).numpy()
    scale = max(1.0, float(np.abs(plain).max()))
    assert np.abs(emu - plain).max() <= 2e-6 * scale
    want = np.asarray(jops.fused_edge_block(jp["fr"], jcfg, jnp.asarray(x),
                                            interpret=True))
    np.testing.assert_allclose(emu, want, rtol=0, atol=5e-4 * scale)


@pytest.mark.parametrize("cfg", ["30p", "50p"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_in_kernel_order_matches_jax(cfg, dtype):
    """The plain version in the warp design's sender order against the
    JAX edge kernel and the JAX ``forward_fused`` (interpret mode): fp32
    at the reference's 5e-4; bf16 at 1e-3 (the same operands rounded,
    sums in another order; see test_edge_block_bf16_matches_jax_bf16)."""
    jcfg, tcfg, jp, tp, x = _setup(cfg, 2, compute_dtype=dtype)
    tol = 5e-4 if dtype == "float32" else 1e-3
    want = jops.fused_edge_block(jp["fr"], jcfg, jnp.asarray(x),
                                 interpret=True)
    _close(ops.fused_edge_block(tp["fr"], tcfg, torch.from_numpy(x)).numpy(),
           want, tol)
    want = jinet.forward_fused(jp, jcfg, jnp.asarray(x), interpret=True)
    _close(tinet.forward_fused(tp, tcfg, torch.from_numpy(x)).numpy(), want,
           tol)
