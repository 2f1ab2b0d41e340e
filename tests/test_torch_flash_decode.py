"""Port parity of kernel B5's module: one-token GQA flash decode.

The same numpy inputs go through the JAX op (its Pallas kernel in
interpret mode) and the port's public op, whose wrapper runs the plain
version on the CPU, at the reference's tolerances: 2e-4 in fp32; a bf16
cache is held at 2e-4 against the JAX op on the same bf16 values and at
the reference's 5e-2 against the fp32 cache.  The places where a port
most easily departs from the reference are each a case: the finite
``NEG_INF`` (a row with no valid key gives the mean of v, a chunk all
masked before the first valid key is wiped), the integer window mask,
D = 80 (h2o-danube-1.8b's head width) at G = 4, and S not a multiple of
the sequence tile.  The CUDA kernel itself runs in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``; here its tile plan,
its C interface and its chunked online softmax (emulated step for step
in numpy) are checked.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode import ops as jops
from repro.kernels.flash_decode.ref import flash_decode_ref as jref
from repro_torch.kernels.flash_decode import kernel as K
from repro_torch.kernels.flash_decode import ops
from repro_torch.kernels.flash_decode.ref import NEG_INF, flash_decode_ref

CSRC = pathlib.Path(K.__file__).resolve().parents[1] / "csrc"


def _inputs(b, h, hkv, d, s, *, seed=0, causal=True, q_pos=None):
    rng = np.random.RandomState(seed)
    q = rng.normal(0, 1, (b, h, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, s, hkv, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, s, hkv, d)).astype(np.float32)
    if q_pos is None:
        q_pos = rng.randint(1, s, b)
    q_pos = np.asarray(q_pos, np.int32)
    kv_pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))
    if causal:
        kv_pos = np.where(kv_pos <= q_pos[:, None], kv_pos, -1)
    return q, k, v, q_pos, np.ascontiguousarray(kv_pos, np.int32)


def _jax(q, k, v, q_pos, kv_pos, **kw):
    return np.asarray(jops.flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_pos),
        jnp.asarray(kv_pos), interpret=True, **kw))


def _port(q, k, v, q_pos, kv_pos, **kw):
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (q, k, v, q_pos, kv_pos)]
    out = ops.flash_decode(*t, **kw)
    assert out.dtype == torch.float32 and out.shape == q.shape
    return out.numpy()


@pytest.mark.parametrize("b,h,hkv,d,s,chunk", [
    (2, 4, 4, 32, 256, 64),       # MHA (G=1)
    (4, 8, 2, 64, 512, 128),      # GQA
    (1, 16, 1, 128, 1024, 256),   # MQA
    (2, 8, 2, 80, 256, 64),       # h2o-danube-1.8b's D=80, G=4
])
def test_matches_jax_op_at_the_sweep_shapes(b, h, hkv, d, s, chunk):
    args = _inputs(b, h, hkv, d, s)
    np.testing.assert_allclose(_port(*args, chunk=chunk),
                               _jax(*args, chunk=chunk),
                               rtol=2e-4, atol=2e-4)


def test_sliding_window_matches_jax():
    """q_pos 200 with a window of 64: the first three 64-key chunks are
    all masked before the first valid key."""
    args = _inputs(2, 4, 2, 32, 256, causal=False, q_pos=[200, 255])
    np.testing.assert_allclose(_port(*args, window=64, chunk=64),
                               _jax(*args, window=64, chunk=64),
                               rtol=2e-4, atol=2e-4)


def test_bf16_cache():
    q, k, v, q_pos, kv_pos = _inputs(2, 8, 2, 80, 128, q_pos=[127, 127])
    kb = torch.from_numpy(k).to(torch.bfloat16)
    vb = torch.from_numpy(v).to(torch.bfloat16)
    got = ops.flash_decode(torch.from_numpy(q), kb, vb,
                           torch.from_numpy(q_pos),
                           torch.from_numpy(kv_pos), chunk=64).numpy()
    want = np.asarray(jops.flash_decode(
        jnp.asarray(q), jnp.asarray(k).astype(jnp.bfloat16),
        jnp.asarray(v).astype(jnp.bfloat16), jnp.asarray(q_pos),
        jnp.asarray(kv_pos), chunk=64, interpret=True))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    ref32 = np.asarray(jref(
        (jnp.asarray(q) / np.sqrt(80)).reshape(2, 2, 4, 80), jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(q_pos), jnp.asarray(kv_pos))
    ).reshape(2, 8, 80)
    np.testing.assert_allclose(got, ref32, rtol=5e-2, atol=5e-2)


def test_fully_masked_row_gives_the_mean_of_v_as_the_jax_op_does():
    q, k, v, q_pos, kv_pos = _inputs(3, 8, 2, 80, 128)
    kv_pos[1] = -1
    got = _port(q, k, v, q_pos, kv_pos, chunk=64)
    want = _jax(q, k, v, q_pos, kv_pos, chunk=64)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    mean_v = v[1].mean(0)                               # (Hkv, D)
    np.testing.assert_allclose(got[1].reshape(2, 4, 80),
                               np.repeat(mean_v[:, None], 4, 1),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("s,chunk", [(200, 64), (100, 16), (37, 64)])
def test_s_not_a_multiple_of_the_chunk(s, chunk):
    """The port takes any S for any tile; JAX picks its own divisor."""
    args = _inputs(2, 8, 2, 80, s, seed=4)
    np.testing.assert_allclose(_port(*args, chunk=chunk), _jax(*args),
                               rtol=2e-4, atol=2e-4)


def _kernel_emulation(qg, k, v, q_pos, kv_pos, chunk, window=None):
    """The CUDA kernel's algorithm step for step in numpy fp32: chunks of
    ``chunk`` keys (the last one short), finite NEG_INF, the (m, l, acc)
    carry, l floored before the divide."""
    b, hkv, g, d = qg.shape
    s_len = k.shape[1]
    out = np.zeros_like(qg)
    for bi in range(b):
        for h in range(hkv):
            m = np.full((g, 1), NEG_INF, np.float32)
            l = np.zeros((g, 1), np.float32)
            acc = np.zeros((g, d), np.float32)
            for c0 in range(0, s_len, chunk):
                kc, vc = k[bi, c0:c0 + chunk, h], v[bi, c0:c0 + chunk, h]
                kp = kv_pos[bi, c0:c0 + chunk]
                ok = (kp >= 0) & (kp <= q_pos[bi])
                if window is not None:
                    ok &= (q_pos[bi] - kp) < window
                s = np.where(ok[None], qg[bi, h] @ kc.T,
                             np.float32(NEG_INF)).astype(np.float32)
                m_new = np.maximum(m, s.max(-1, keepdims=True))
                p = np.exp(s - m_new)
                corr = np.exp(m - m_new)
                l = l * corr + p.sum(-1, keepdims=True)
                acc = acc * corr + p @ vc
                m = m_new
            out[bi, h] = acc / np.maximum(l, np.float32(1e-30))
    return out


@pytest.mark.parametrize("window,masked_row", [(None, False), (64, False),
                                               (None, True)])
def test_kernel_algorithm_equals_the_plain_version(window, masked_row):
    """The chunked online softmax with a short last chunk, an all-masked
    first chunk (window) and a row with no valid key gives the plain
    version's answer."""
    q, k, v, q_pos, kv_pos = _inputs(2, 8, 2, 80, 200, seed=5,
                                     causal=window is None,
                                     q_pos=[190, 150])
    if masked_row:
        kv_pos[0] = -1
    qg = (q / np.float32(np.sqrt(80))).reshape(2, 2, 4, 80)
    emu = _kernel_emulation(qg, k, v, q_pos, kv_pos, 48, window)
    plain = flash_decode_ref(torch.from_numpy(qg), torch.from_numpy(k),
                             torch.from_numpy(v), torch.from_numpy(q_pos),
                             torch.from_numpy(kv_pos), window=window)
    np.testing.assert_allclose(emu, plain.numpy(), rtol=2e-5, atol=2e-5)


def test_cpu_runs_the_plain_version_and_counts_no_launch():
    q, k, v, q_pos, kv_pos = (torch.from_numpy(a)
                              for a in _inputs(2, 4, 2, 32, 64))
    qg = (q * (1.0 / 32 ** 0.5)).reshape(2, 2, 2, 32)
    before = K.flash_decode_kernel_call.launches
    got = K.flash_decode_kernel_call(qg, k, v, q_pos, kv_pos, chunk=16)
    assert torch.equal(got, flash_decode_ref(qg, k, v, q_pos, kv_pos))
    assert K.flash_decode_kernel_call.launches == before


def _args32():
    q, k, v, q_pos, kv_pos = (torch.from_numpy(a)
                              for a in _inputs(2, 4, 2, 32, 64))
    return (q * (1.0 / 32 ** 0.5)).reshape(2, 2, 2, 32), k, v, q_pos, kv_pos


@pytest.mark.parametrize("edit,exc", [
    (lambda a: (a[0].double(),) + a[1:], ValueError),
    (lambda a: (a[0], a[1][:, :, :1], a[2]) + a[3:], ValueError),
    (lambda a: (a[0], a[1].bfloat16(), a[2]) + a[3:], TypeError),
    (lambda a: (a[0], a[1].half(), a[2].half()) + a[3:], TypeError),
    (lambda a: a[:3] + (a[3].long(), a[4]), ValueError),
    (lambda a: a[:4] + (a[4][:, :-1],), ValueError),
])
def test_wrapper_raises_on_what_the_kernel_does_not_take(edit, exc):
    with pytest.raises(exc):
        K.flash_decode_kernel_call(*edit(_args32()))


def test_wrapper_raises_on_a_window_below_one_and_on_bad_heads():
    with pytest.raises(ValueError, match="window"):
        K.flash_decode_kernel_call(*_args32(), window=0)
    q, k, v, q_pos, kv_pos = (torch.from_numpy(a)
                              for a in _inputs(1, 6, 4, 32, 16))
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_decode(q, k, v, q_pos, kv_pos)


@pytest.mark.parametrize("g,d,s,chunk", [(4, 80, 32768, None),
                                         (1, 32, 256, 64), (16, 128, 1024, 256),
                                         (4, 33, 100, 16), (2, 36, 10, None)])
def test_plan_fits_the_budget_and_pads_k_rows_to_odd_words(g, d, s, chunk):
    p = K.plan(g, d, s, chunk)
    assert 1 <= p.chunk <= min(chunk or K.DEFAULT_CHUNK, s)
    assert p.d4 % 4 == 0 and d <= p.d4 < d + 4
    assert p.kst % 4 == 0 and (p.kst // 4) % 2 == 1 and p.kst >= p.d4
    words = p.chunk * (p.kst + p.d4 + g + 1) + g * (2 * p.d4 + 3)
    assert p.smem_bytes == 4 * words <= K.SMEM_BUDGET
    bigger = (p.chunk + 1) * (p.kst + p.d4 + g + 1) + g * (2 * p.d4 + 3)
    assert p.chunk == min(chunk or K.DEFAULT_CHUNK, s) \
        or 4 * bigger > K.SMEM_BUDGET
    assert K.plan(4, 80, 32768) == K.Plan(64, 80, 84, 45872)


def test_plan_raises_on_rows_that_do_not_fit_and_on_chunk_below_one():
    with pytest.raises(ValueError, match="shared memory"):
        K.plan(64, 256, 1024)
    with pytest.raises(ValueError, match="chunk"):
        K.plan(4, 80, 1024, 0)


def test_c_interface_matches_the_wrapper():
    """The launcher's arguments, the shared-memory cap and the mask value
    in the CUDA source agree with the wrapper and the plain version."""
    src = (CSRC / "flash_decode.cu").read_text()
    sig = re.search(r"int flash_decode_launch\(([^)]*)\)", src).group(1)
    params = [p.strip() for p in sig.split(",")]
    assert [p.split()[-1] for p in params] == [
        "q", "k", "v", "q_pos", "kv_pos", "out", "batch", "s_len", "hkv",
        "g", "d", "window", "chunk", "kst", "smem_bytes", "bf16", "stream"]
    assert sum(p.startswith("int ") for p in params) == 10
    assert "kMaxSmem = 48 * 1024" in src and K.SMEM_BUDGET == 48 * 1024
    assert "kNegInf = -1e30f" in src and NEG_INF == -1e30
    assert "INFINITY" not in src
