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
    common = (csrc / "jedi_common.cuh").read_text()
    block = common[common.index("HEADER-FIELDS-BEGIN"):
                   common.index("HEADER-FIELDS-END")]
    assert tuple(re.findall(r"F\((\w+)\)", block)) == FK.HEADER_FIELDS
    for sym in ("jedi_linear_full_launch", "jedi_linear_full_header_len"):
        assert f"int {sym}(" in src
    for region in ("part", "pool", "obuf"):        # regions B2 reads
        assert f"a.off_{region}" in src
        assert f"off_{region}" in FK.HEADER_FIELDS


@pytest.mark.parametrize("n_o,fr,fo,phi", [
    (30, [20, 20, 20, 8], [20, 20, 20, 24], [20, 20, 20, 5]),
    (50, [50, 50, 50, 8], [50, 50, 50, 24], [50, 50, 50, 5]),
    (128, [128, 128, 8], [64, 64, 24], [32, 32, 5]),
    (13, [16, 12], [10], [12, 5]),
])
def test_layout_fits_and_is_aligned(n_o, fr, fo, phi):
    lay = autotune.plan_linear(n_o, 16, fr, fo, phi)
    assert lay.smem_bytes <= shared.SMEM_BLOCK_BYTES
    assert lay.threads % 32 == 0 and lay.threads % lay.team == 0
    assert lay.threads <= shared.MAX_THREADS_PER_BLOCK
    assert lay.team in (1, 2, 4, 8, 16, 32)
    assert lay.slot_stride % 2 == 1 and lay.slot_stride >= 2 * lay.mw
    offs = [lay.offsets[k] for k in ("w", "b", "x", "part", "pool", "obuf",
                                     "osum", "slot")]
    assert offs == sorted(offs) and all(o % 4 == 0 for o in offs)
    assert lay.smem_bytes == lay.reserved_bytes \
        + lay.events_per_block * lay.per_event_bytes
    assert 1 <= lay.ks <= n_o


def test_layout_raises_when_nothing_fits():
    with pytest.raises(ValueError, match="JEDI-linear"):
        autotune.plan_linear(30, 16, [20, 8], [20, 24], [20, 5],
                             budget_bytes=1024)


def test_ladder_comes_from_b2s_layout():
    _, tcfg, _, tp, _ = _setup("30p", 1)
    lay = autotune.layout_for(tcfg, tp)
    for name in ("jedi_linear", "jedi_linear_full", "int8_jedi_linear_full"):
        spec = tpaths.get(name)
        p = spec.prepare_params(tp)
        assert spec.bucket_bytes(tcfg, p) == lay.per_event_bytes
        assert spec.reserved_smem_bytes(tcfg, p) == lay.reserved_bytes
        assert spec.bucket_ladder(tcfg, p, 256) == shared.bucket_ladder(
            256, lay.per_event_bytes, reserved_bytes=lay.reserved_bytes)
    full = tpaths.get("fused_full")
    assert tpaths.get("jedi_linear_full").bucket_ladder(tcfg, tp, 256) \
        != full.bucket_ladder(tcfg, tp, 256)


def test_fused_full_ladder_is_unchanged():
    """B1's ladder at jedi_30p as the first slice derived it."""
    _, tcfg, _, tp, _ = _setup("30p", 1)
    spec = tpaths.get("fused_full")
    assert spec.per_sample_bytes is None and spec.reserved_bytes is None
    assert spec.bucket_bytes(tcfg, tp) == 15936
    assert spec.reserved_smem_bytes(tcfg, tp) == 90736
    assert spec.bucket_ladder(tcfg, tp, 256) == [8, 16, 32, 64, 128, 256]
