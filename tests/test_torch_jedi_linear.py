"""Port parity of JEDI-linear: kernel B2's module and its three paths.

Weights come from the JAX init (LeCun scale) carried across with the
bridge; inputs are ``make_jets`` from a numpy seed.  The plain forwards
are held against the JAX ones at 2e-4; on the CPU the kernel's wrapper
runs its plain version, held against the JAX kernel run in Pallas
interpret mode at 5e-4.  Logits are compared scaled to at least 1: an
untrained N_o=128 net's logits grow with the (N_o-1)-fold pool.  The
kernel itself runs in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``
on the card; here its launch plumbing is checked: the layout, the
header shared with the CUDA source, the bucket ladder it drives.
"""

import functools
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import int8_path as jint8
from repro.core import interaction_net as jinet
from repro.core import paths as jpaths
from repro.data.jets import make_jets
from repro.kernels.jedi_linear import ops as jops
from repro.kernels.jedi_linear import ref as jref
from repro_torch import bridge
from repro_torch.configs import jedi_50p, jedi_tracks_128
from repro_torch.core import int8_path as tint8
from repro_torch.core import interaction_net as tinet
from repro_torch.core import paths as tpaths
from repro_torch.kernels import autotune as shared
from repro_torch.kernels.fused_jedinet import full_kernel as FK
from repro_torch.kernels.fused_jedinet import ops as fused_ops
from repro_torch.kernels.jedi_linear import autotune, ops
from repro_torch.kernels.jedi_linear import linear_kernel as LK
from repro_torch.kernels.jedi_linear import ref as tref
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


@pytest.mark.parametrize("cfg", list(CFGS))
@pytest.mark.parametrize("fwd", ["forward_jedi_linear",
                                 "forward_jedi_linear_edge_sum"])
def test_plain_forwards_match_jax(cfg, fwd):
    jcfg, tcfg, jp, tp, x = _setup(cfg, 3)
    want = jax.jit(getattr(jref, fwd), static_argnums=1)(jp, jcfg,
                                                         jnp.asarray(x))
    got = getattr(tref, fwd)(tp, tcfg, torch.from_numpy(x))
    _close(got.numpy(), want, 2e-4)


def test_pooled_identity_holds_against_the_oracle():
    _, tcfg, _, tp, x = _setup("128p-narrow", 2)
    xt = torch.from_numpy(x)
    _close(tref.forward_jedi_linear(tp, tcfg, xt).numpy(),
           tref.forward_jedi_linear_edge_sum(tp, tcfg, xt).numpy(), 2e-4)


@pytest.mark.parametrize("cfg,batch", [("30p", 4), ("30p", 13),
                                       ("13p-narrow", 7),
                                       ("128p-narrow", 3)])
def test_full_plain_matches_jax_interpret(cfg, batch):
    """B = 13 is ragged for the JAX kernel's batch tile (it pads); the
    port's kernel masks its last block instead."""
    jcfg, tcfg, jp, tp, x = _setup(cfg, batch)
    want = jops.jedi_linear_forward_full(jp, jcfg, jnp.asarray(x),
                                         interpret=True)
    got = ops.jedi_linear_forward_full(tp, tcfg, torch.from_numpy(x))
    _close(got.numpy(), want, 5e-4)


def test_full_bf16_matches_jax_bf16():
    """bf16 against the JAX kernel in bf16: both round the same operands
    to bf16 before every product, keep biases, the pool and every sum in
    fp32, and differ only in summation order; a sum on the other side of
    a bf16 rounding boundary moves one operand by one bf16 ulp (2^-8
    relative), which reaches a logit through one of its many summed
    terms.  Bound: 1e-3 of the logit scale."""
    jcfg, tcfg, jp, tp, x = _setup("30p", 5, compute_dtype="bfloat16")
    want = jops.jedi_linear_forward_full(jp, jcfg, jnp.asarray(x),
                                         interpret=True)
    got = ops.jedi_linear_forward_full(tp, tcfg, torch.from_numpy(x))
    _close(got.numpy(), want, 1e-3)
    fp32 = ops.jedi_linear_forward_full(
        tp, tcfg.with_(compute_dtype="float32"), torch.from_numpy(x))
    assert float((got - fp32).abs().max()) > 0.0     # the bf16 path is live


def test_int8_full_matches_jax_int8_kernel_and_the_oracle():
    jcfg, tcfg, jp, tp, x = _setup("30p", 6)
    jq = jax.tree_util.tree_map(np.asarray,
                                jax.jit(jint8.quantize_params_int8)(jp))
    tq = tint8.quantize_params_int8(tp)
    want = jops.jedi_linear_forward_full(jq, jcfg, jnp.asarray(x),
                                         interpret=True)
    spec = tpaths.get("int8_jedi_linear_full")
    got = spec.forward(tq, tcfg, torch.from_numpy(x))
    _close(got.numpy(), want, 5e-4)
    _close(got.numpy(), spec.ref(tq, tcfg, torch.from_numpy(x)).numpy(),
           spec.tolerance)


def test_registry_chains_and_tolerances():
    want = {
        "jedi_linear": (["jedi_linear", "sr_split"], 2e-4, False),
        "jedi_linear_full": (["jedi_linear_full", "jedi_linear",
                              "sr_split"], 5e-4, True),
        "int8_jedi_linear_full": (["int8_jedi_linear_full",
                                   "jedi_linear_full", "jedi_linear",
                                   "sr_split"], 5e-4, True),
    }
    for name, (chain, tol, cuda) in want.items():
        spec, ref = tpaths.get(name), jpaths.get(name)
        assert tpaths.fallback_chain(name) == chain \
            == jpaths.fallback_chain(name)
        assert spec.tolerance == tol == ref.tolerance
        assert spec.cuda is cuda and spec.complexity == "O(N)"
        assert (spec.quantized, spec.weight_bytes) \
            == (ref.quantized, ref.weight_bytes)
        assert spec.ref.__name__.startswith("_ref_edge_sum")
    assert tpaths.get("int8_jedi_linear_full").compute_dtypes \
        == ("float32",)


def test_engine_serves_jedi_linear_full_equal_to_jax_oracle():
    jcfg, tcfg, jp, tp, x = _setup("13p-narrow", 5)
    want = jax.jit(jref.forward_jedi_linear_edge_sum, static_argnums=1)(
        jp, jcfg, jnp.asarray(x))
    eng = ResilientEngine(tp, tcfg, forward="jedi_linear_full",
                          device="cpu", max_batch=8)
    before = LK.jedi_linear_kernel_call.launches
    res = eng.run_stream([x, x, x], warmup=1)
    assert res["events"] == 10
    _close(eng.infer(x), want, 5e-4)
    assert eng.active_path(res["bucket"]) == "jedi_linear_full"
    assert not eng.health()["counters"]
    assert LK.jedi_linear_kernel_call.launches == before


def test_cpu_tensors_never_touch_the_kernel():
    _, tcfg, _, tp, x = _setup("13p-narrow", 2)
    before = LK.jedi_linear_kernel_call.launches
    tpaths.get("jedi_linear_full").forward(tp, tcfg, torch.from_numpy(x))
    tpaths.get("int8_jedi_linear_full").forward(
        tint8.quantize_params_int8(tp), tcfg, torch.from_numpy(x))
    assert LK.jedi_linear_kernel_call.launches == before


def test_binding_is_b1s_packed_weights():
    _, tcfg, _, tp, _ = _setup("13p-narrow", 1)
    assert ops.bind_linear is fused_ops.bind_full
    bound = ops.bind_linear(tint8.quantize_params_int8(tp), tcfg).pack()
    assert bound.wpack.dtype == torch.int8
    assert bound.scales[0] is bound.scales[1]      # w1's halves share it


def test_wrapper_rejects_what_the_kernel_does_not_take():
    _, tcfg, _, tp, x = _setup("13p-narrow", 2)
    bound = ops.bind_linear(tp, tcfg)
    kw = dict(activation="relu", n_targets=tcfg.n_targets)
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError, match="x must be"):
        LK.jedi_linear_kernel_call(xt[:, :, :8], bound, **kw)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        LK.jedi_linear_kernel_call(xt.double(), bound, **kw)
    with pytest.raises(ValueError, match="is on"):
        LK.jedi_linear_kernel_call(xt.to("meta"), bound, **kw)


def test_header_fields_and_launch_symbols_match_the_cuda_source():
    csrc = REPO / "src/repro_torch/kernels/csrc"
    src = (csrc / LK.SOURCES[0]).read_text()
    assert '#include "jedi_common.cuh"' in src
    assert '#include "jedi_warp.cuh"' in src       # the rows design's pieces
    common = (csrc / "jedi_common.cuh").read_text()
    block = common[common.index("HEADER-FIELDS-BEGIN"):
                   common.index("HEADER-FIELDS-END")]
    assert tuple(re.findall(r"F\((\w+)\)", block)) == FK.HEADER_FIELDS
    # both designs' entry points, under the names the wrapper builds
    for design, symbol in (("team", "jedi_linear_full"),
                           ("rows", "jedi_linear_full_rows")):
        for sym in (f"{symbol}_launch", f"{symbol}_header_len"):
            assert f"int {sym}(" in src, (design, sym)
    # regions B2 reads, in either design
    for region in ("part", "pool", "obuf", "us", "ebar", "slot"):
        assert f"a.off_{region}" in src
        assert f"off_{region}" in FK.HEADER_FIELDS
    # the rows design shares B1's staging, u_r / u_s, rows_mlp, readout
    # warp and resident launch
    warp = (csrc / "jedi_warp.cuh").read_text()
    for name in ("stage_weights", "node_halves", "rows_mlp", "readout_warp",
                 "launch_resident"):
        assert re.search(rf"\b{name}\(", warp)
        assert re.search(rf"\b{name}(<[^>]*>)?\(", src), name


@pytest.mark.parametrize("n_o,fr,fo,phi,design", [
    (30, [20, 20, 20, 8], [20, 20, 20, 24], [20, 20, 20, 5], "rows"),
    (50, [50, 50, 50, 8], [50, 50, 50, 24], [50, 50, 50, 5], "rows"),
    (128, [128, 128, 8], [64, 64, 24], [32, 32, 5], "team"),
    (13, [16, 12], [10], [12, 5], "rows"),
])
def test_layout_fits_and_is_aligned(n_o, fr, fo, phi, design):
    """B2's plan: the rows design where its node rows fit beside the
    weights (jedi_30p, jedi_50p), else the team layout (jedi_tracks_128);
    either fits the opt-in shared memory, 16-byte aligned."""
    lay = autotune.plan_linear(n_o, 16, fr, fo, phi)
    assert lay.design == design
    assert lay.smem_bytes <= shared.SMEM_BLOCK_BYTES
    assert lay.threads % 32 == 0 and lay.threads % lay.team == 0
    assert lay.threads <= shared.MAX_THREADS_PER_BLOCK
    assert lay.smem_bytes == lay.reserved_bytes \
        + lay.events_per_block * lay.per_event_bytes
    offs = list(lay.offsets.values())
    assert offs == sorted(offs) and all(o % 4 == 0 for o in offs)
    if design == "rows":
        # one event at a time, compute warps + the readout warp; rows an
        # odd number of words apart, wide enough for every f_R / f_O
        # layer and for C = [x || h]
        assert (lay.events_per_block, lay.team) == (1, 1)
        assert 64 <= lay.threads <= 512 and lay.batch_bytes == 0
        assert lay.mw % 2 == 1 and lay.mw >= 16 + fr[-1]
        assert lay.mw >= max(autotune.pad4(w) for w in fr + fo)
        assert lay.slot_stride % 2 == 0
        assert lay.slot_stride // 2 >= max(fo[-1], *phi)
        assert set(lay.offsets) == {"w", "b", "x", "part", "us", "ebar",
                                    "pool", "obuf", "slot"}
        for a, b in (("part", "us"), ("us", "ebar")):
            assert lay.offsets[b] - lay.offsets[a] >= n_o * lay.mw
        return
    assert lay.team in (1, 2, 4, 8, 16, 32)
    assert lay.slot_stride % 2 == 1 and lay.slot_stride >= 2 * lay.mw
    assert lay.batch_bytes == lay.per_event_bytes
    offs = [lay.offsets[k] for k in ("w", "b", "x", "part", "pool", "obuf",
                                     "osum", "slot")]
    assert offs == sorted(offs)
    assert 1 <= lay.ks <= n_o


def test_layout_raises_when_nothing_fits():
    with pytest.raises(ValueError, match="JEDI-linear"):
        autotune.plan_linear(30, 16, [20, 8], [20, 24], [20, 5],
                             budget_bytes=1024)


def test_ladder_comes_from_b2s_layout():
    """The rows design walks the batch one event at a time (no batch
    tile), so B2's paths earn plain doublings up to max_batch, the ladder
    of fused_full at jedi_30p; where the team layout holds
    (jedi_tracks_128) its tiles still set the ladder."""
    _, tcfg, _, tp, _ = _setup("30p", 1)
    lay = autotune.layout_for(tcfg, tp)
    full = tpaths.get("fused_full")
    assert lay.design == "rows" and lay.batch_bytes == 0
    for name in ("jedi_linear", "jedi_linear_full", "int8_jedi_linear_full"):
        spec = tpaths.get(name)
        p = spec.prepare_params(tp)
        assert spec.bucket_bytes(tcfg, p) == 0
        assert spec.reserved_smem_bytes(tcfg, p) == lay.reserved_bytes
        assert spec.bucket_ladder(tcfg, p, 256) == [8, 16, 32, 64, 128, 256] \
            == full.bucket_ladder(tcfg, tp, 256)
        assert spec.bucket_ladder(tcfg, p, 1000) == [
            8, 16, 32, 64, 128, 256, 512, 1000]
    for cfg in (jedi_50p.MODEL, jedi_tracks_128.MODEL):
        params = tinet.init(0, cfg, scale="lecun", device="cpu")
        lay = autotune.layout_for(cfg, params)
        spec = tpaths.get("jedi_linear_full")
        ladder = spec.bucket_ladder(cfg, params, 256)
        if cfg.n_objects == 50:
            assert lay.design == "rows"
            assert ladder == [8, 16, 32, 64, 128, 256]
        else:
            assert lay.design == "team"
            assert spec.bucket_bytes(cfg, params) == lay.per_event_bytes
            assert ladder == shared.bucket_ladder(
                256, lay.per_event_bytes, reserved_bytes=lay.reserved_bytes)


def test_fused_full_ladder_is_unchanged():
    """B1's ladder at jedi_30p as the first slice derived it."""
    _, tcfg, _, tp, _ = _setup("30p", 1)
    spec = tpaths.get("fused_full")
    assert spec.per_sample_bytes is None and spec.reserved_bytes is None
    assert spec.bucket_bytes(tcfg, tp) == 15936
    assert spec.reserved_smem_bytes(tcfg, tp) == 90736
    assert spec.bucket_ladder(tcfg, tp, 256) == [8, 16, 32, 64, 128, 256]


def _lanes_then_xor_tree(v):
    """(N, ...) summed over axis 0 as B2's rows design sums its pool: lane
    l adds rows l, l + 32, ... in ascending order, then the lanes by the
    xor tree of offsets 16, 8, 4, 2, 1 (numpy fp32)."""
    lanes = [None] * 32
    for j, row in enumerate(v):
        lanes[j % 32] = row if lanes[j % 32] is None else lanes[j % 32] + row
    lanes = [np.zeros_like(v[0]) if t is None else t for t in lanes]
    for off in (16, 8, 4, 2, 1):
        lanes = [lanes[i] + lanes[i ^ off] for i in range(32)]
    assert all(np.array_equal(lanes[0], t) for t in lanes)
    return lanes[0]


@pytest.mark.parametrize("n_o", [13, 30, 50, 128])
def test_pool_follows_the_rows_designs_lanes_and_xor_tree(n_o):
    """The plain version's pool is the rows design's, bitwise: lanes over
    the nodes, then the xor tree; the team layout's is its node splits."""
    rng = np.random.RandomState(n_o)
    u_s = rng.normal(0, 1, (3, n_o, 20)).astype(np.float32)
    rows = autotune.plan_linear(n_o, 16, [20, 8], [20, 24], [20, 5])
    assert rows.design == "rows"
    want = np.stack([_lanes_then_xor_tree(e) for e in u_s])[:, None]
    got = LK._pool(torch.from_numpy(u_s), rows).numpy()
    assert np.array_equal(got, want)
    team = autotune.plan_linear(128, 16, [128, 128, 8], [64, 64, 24],
                                [32, 32, 5])
    assert team.design == "team" and team.ks > 1
    split = [np.zeros(20, np.float32) for _ in range(team.ks)]
    for j in range(n_o):
        split[j % team.ks] = split[j % team.ks] + u_s[0, j]
    total = np.zeros(20, np.float32)
    for part in split:
        total = total + part
    assert np.array_equal(LK._pool(torch.from_numpy(u_s), team)[0, 0].numpy(),
                          total)


ACT_NP = {"relu": lambda v: np.maximum(v, np.float32(0))}


def _rows_design_emulation(x, bound, act):
    """B2's rows design step for step in numpy fp32: u_r and u_s per
    node (int8 scale after the product); the pool by lanes and the xor
    tree; h = (N_o - 1)(u_r + b1) + (pool - u_s), each step rounded;
    f_R's other layers, f_O on [x || h] per node, the node sum in node
    order, phi_O."""
    f = ACT_NP[act]
    fr, fo, phi = ([t.numpy().astype(np.float32) for t in ts]
                   for ts in (bound.fr, bound.fo, bound.phi))
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
        nm1 = np.float32(xe.shape[0] - 1)
        u_r, u_s = (xe @ fr[0]) * sc[0], (xe @ fr[1]) * sc[1]
        pool = _lanes_then_xor_tree(u_s)
        h = nm1 * (u_r + fr[2]) + (pool - u_s)
        if len(fr) > 3:
            h = mlp(f(h), fr[3:], sc[2:n_fr_w])
        node = mlp(np.concatenate([xe, h], 1), fo, sc[n_fr_w:n_fr_w + n_fo])
        osum = np.zeros(node.shape[1], np.float32)
        for r in range(node.shape[0]):
            osum = osum + node[r]
        out.append(mlp(osum, phi, sc[n_fr_w + n_fo:]))
    return np.stack(out)


@pytest.mark.parametrize("cfg,quant", [("30p", False), ("50p", False),
                                       ("30p", True)])
def test_rows_design_orders_match_plain_and_jax(cfg, quant):
    """B2's rows design (the pool by lanes and xor tree, the node sum in
    node order), emulated in numpy, against the plain version, which sums
    in the same orders (the products' own sums may differ by an ulp:
    2e-6 of the scale), and the JAX kernel at the reference's 5e-4."""
    jcfg, tcfg, jp, tp, x = _setup(cfg, 2)
    if quant:
        jp = jax.tree_util.tree_map(np.asarray,
                                    jax.jit(jint8.quantize_params_int8)(jp))
        tp = tint8.quantize_params_int8(tp)
    assert autotune.layout_for(tcfg, tp).design == "rows"
    bound = ops.bind_linear(tp, tcfg)
    emu = _rows_design_emulation(x, bound, tcfg.activation)
    plain = LK.jedi_linear_forward_full_plain(
        torch.from_numpy(x), bound.fr, bound.fo, bound.phi,
        activation=tcfg.activation, scales=bound.scales).numpy()
    scale = max(1.0, float(np.abs(plain).max()))
    assert np.abs(emu - plain).max() <= 2e-6 * scale
    want = np.asarray(jops.jedi_linear_forward_full(jp, jcfg, jnp.asarray(x),
                                                    interpret=True))
    np.testing.assert_allclose(emu, want, rtol=0, atol=5e-4 * scale)


@pytest.mark.parametrize("cfg", ["50p", "128p-narrow"])
@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8"])
def test_plain_in_kernel_order_matches_jax_kernel(cfg, mode):
    """The plain version, in the order of the design B2 runs, against the
    JAX kernel (interpret mode) on the same inputs and weights: fp32 and
    int8 at the reference's 5e-4, bf16 at 1e-3 (both round the same
    operands; a sum on the other side of a bf16 rounding boundary moves
    one operand by one bf16 ulp)."""
    jcfg, tcfg, jp, tp, x = _setup(
        cfg, 3, compute_dtype="bfloat16" if mode == "bfloat16"
        else "float32")
    if mode == "int8":
        jp = jax.tree_util.tree_map(np.asarray,
                                    jax.jit(jint8.quantize_params_int8)(jp))
        tp = tint8.quantize_params_int8(tp)
    want = jops.jedi_linear_forward_full(jp, jcfg, jnp.asarray(x),
                                         interpret=True)
    got = ops.jedi_linear_forward_full(tp, tcfg, torch.from_numpy(x))
    _close(got.numpy(), want, 1e-3 if mode == "bfloat16" else 5e-4)
