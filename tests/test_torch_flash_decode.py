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
``tests/test_torch_cuda.py`` and ``chip_smoke.py``; here its launch plan
(sequence partitions, shared-memory ring), its C interface and its
algorithm (split sequence, 32-key tiles, online softmax per partition,
partitions combined in order; emulated step for step in numpy) are
checked.
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


def _kernel_emulation(qg, k, v, q_pos, kv_pos, part_len, window=None):
    """The CUDA kernel's algorithm step for step in numpy fp32: the
    sequence cut into partitions of ``part_len`` keys, each walked in
    tiles of 32 keys (the last one short: its missing keys add nothing),
    finite NEG_INF, the (m, l, acc) carry per partition; with several
    partitions they are combined in partition order, partition i weighed
    by exp(m_i - max m); l floored before the divide."""
    b, hkv, g, d = qg.shape
    s_len = k.shape[1]
    out = np.zeros_like(qg)
    for bi in range(b):
        for h in range(hkv):
            parts = []
            for p0 in range(0, s_len, part_len):
                p1 = min(p0 + part_len, s_len)
                m = np.full((g, 1), NEG_INF, np.float32)
                l = np.zeros((g, 1), np.float32)
                acc = np.zeros((g, d), np.float32)
                for c0 in range(p0, p1, K.TILE):
                    c1 = min(c0 + K.TILE, p1)
                    kc, vc = k[bi, c0:c1, h], v[bi, c0:c1, h]
                    kp = kv_pos[bi, c0:c1]
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
                parts.append((m, l, acc))
            ms = np.stack([pt[0] for pt in parts])          # (P, g, 1)
            w = np.exp(ms - ms.max(0))
            l = sum(wi * pt[1] for wi, pt in zip(w, parts))
            acc = sum(wi * pt[2] for wi, pt in zip(w, parts))
            out[bi, h] = acc / np.maximum(l, np.float32(1e-30))
    return out


def _emulation_case(name):
    """(inputs, part_len, window) of one emulation case: D = 80, G = 4."""
    s, causal, q_pos, window, part_len = 200, True, [190, 150], None, 48
    if name == "window, partitions all masked before the first valid key":
        causal, q_pos, window = False, [190, 150], 64
    q, k, v, q_pos, kv_pos = _inputs(2, 8, 2, 80, s, seed=5, causal=causal,
                                     q_pos=q_pos)
    if name == "a row with no valid key":
        kv_pos[0] = -1
    if name == "one partition, S not a multiple of the tile":
        part_len = s
    if name == "a partition all masked before the first valid key":
        kv_pos[:, :part_len + 7] = -1          # the first partition and more
    qg = (q / np.float32(np.sqrt(80))).reshape(2, 2, 4, 80)
    return (qg, k, v, q_pos, kv_pos), part_len, window


EMULATION_CASES = [
    "several partitions",
    "window, partitions all masked before the first valid key",
    "a row with no valid key",
    "one partition, S not a multiple of the tile",
    "a partition all masked before the first valid key",
]


@pytest.mark.parametrize("name", EMULATION_CASES)
def test_kernel_algorithm_equals_the_plain_version(name):
    """Split sequence, 32-key tiles with a short last one, per-partition
    carry and the ordered combine give the plain version's answer."""
    (qg, k, v, q_pos, kv_pos), part_len, window = _emulation_case(name)
    emu = _kernel_emulation(qg, k, v, q_pos, kv_pos, part_len, window)
    plain = flash_decode_ref(torch.from_numpy(qg), torch.from_numpy(k),
                             torch.from_numpy(v), torch.from_numpy(q_pos),
                             torch.from_numpy(kv_pos), window=window)
    np.testing.assert_allclose(emu, plain.numpy(), rtol=2e-5, atol=2e-5)
    if name == "a row with no valid key":
        np.testing.assert_allclose(emu[0], np.repeat(v[0].mean(0)[:, None],
                                                     4, 1),
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", EMULATION_CASES)
def test_kernel_algorithm_equals_the_jax_op(name):
    """The same emulation against the JAX op in interpret mode (its own
    chunked carry, its own divisor of S), at the reference's 2e-4."""
    (qg, k, v, q_pos, kv_pos), part_len, window = _emulation_case(name)
    emu = _kernel_emulation(qg, k, v, q_pos, kv_pos, part_len, window)
    q = (qg * np.float32(np.sqrt(80))).reshape(2, 8, 80)
    want = _jax(q, k, v, q_pos, kv_pos, window=window)
    np.testing.assert_allclose(emu.reshape(2, 8, 80), want, rtol=2e-4,
                               atol=2e-4)


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


@pytest.mark.parametrize("b,hkv,g,d,s,elem,chunk", [
    (128, 8, 4, 80, 32768, 2, None),      # danube decode_32k: tensor cores
    (1, 8, 4, 80, 32768, 2, None),        # B = 1
    (2, 4, 1, 32, 256, 4, 64),            # MHA, fp32
    (1, 1, 16, 128, 1024, 4, 256),        # MQA: two groups of 8 rows
    (2, 2, 4, 33, 100, 2, 16),            # D not whole 16-byte words
    (2, 2, 2, 36, 10, 4, None),
    (3, 2, 6, 64, 777, 2, None),          # G = 6: three groups of 2
    (2, 6, 4, 64, 300, 2, 100),           # Hkv = 6: blocks of 6 heads
])
def test_plan_fits_the_budget_and_pads_k_rows_to_odd_words(b, hkv, g, d, s,
                                                           elem, chunk):
    """The plan of the ring and the partitions: shared memory within the
    opt-in limit, every region 16-byte aligned, K and V rows an odd
    number of 16-byte words apart, partitions covering S exactly, the
    tensor-core path exactly where it applies."""
    p = K.plan(b, hkv, g, d, s, elem, chunk)
    per_word = 16 // elem
    assert p.words == -(-d // per_word) <= K.MAX_WORDS
    assert p.kst % 2 == 1 and p.words <= p.kst <= p.words + 1
    assert g % p.gb == 0 and p.gb in (1, 2, 4, 8) and p.n_groups == g // p.gb
    assert p.mma == (elem == 2 and g == 4 and d in K.MMA_WIDTHS)
    if p.mma:
        assert p.tile == K.MMA_TILE and hkv % p.heads == 0
        assert 1 <= p.heads <= K.MAX_HEADS
        stage = 16 * K.MMA_TILE * p.kst * 2 * p.heads + 4 * K.MMA_TILE
        rest = 4 * p.heads * p.gb * K.MMA_TILE
    else:
        assert p.tile == K.TILE and p.heads == 1
        stage = 16 * K.TILE * 2 * p.kst + 4 * K.TILE
        rest = 4 * p.gb * p.words * per_word + 4 * K.TILE * p.gb
    assert stage % 16 == 0 and rest % 16 == 0
    assert p.smem_bytes == K.STAGES * stage + rest \
        == K.smem_bytes(p.gb, p.words, elem, p.heads, p.mma) <= K.SMEM_BUDGET
    assert p.stages == K.STAGES >= 3 and p.threads == 32 * p.heads
    assert (p.n_parts - 1) * p.part_len < s <= p.n_parts * p.part_len
    if chunk is not None:
        assert p.part_len == min(chunk, s)
    else:
        assert p.part_len % p.tile == 0
    assert p.blocks == b * (hkv // p.heads) * p.n_groups * p.n_parts
    assert K.plan(b, hkv, g, d, s, elem, chunk, aligned=False).mma is False


@pytest.mark.parametrize("b", [1, 2, 16, 128])
def test_partitions_fill_the_card_at_any_batch(b):
    """At danube's decode_32k shape the grid covers the 132 SMs, B = 1
    included (with fewer kv-heads a block where 8 would leave SMs idle),
    with partitions of at least MIN_PART_KEYS keys; at B = 128 it holds
    several waves of the blocks the SMs keep resident."""
    p = K.plan(b, 8, 4, 80, 32768, 2)
    assert p.mma and p.blocks >= K.SMS and p.part_len >= K.MIN_PART_KEYS
    assert p.blocks_per_sm == K.blocks_per_sm(p.smem_bytes, p.threads) >= 1
    assert p.heads == (4 if b == 1 else 8)
    if b == 128:
        assert p.blocks >= K.WAVES * K.SMS * p.blocks_per_sm


def test_plan_raises_on_rows_that_do_not_fit_and_on_chunk_below_one():
    with pytest.raises(ValueError, match="16-byte words"):
        K.plan(1, 1, 4, 256, 1024, 4)
    with pytest.raises(ValueError, match="chunk"):
        K.plan(1, 1, 4, 80, 1024, 2, 0)
    with pytest.raises(ValueError, match="at least one key"):
        K.plan(1, 1, 4, 80, 0, 2)


def test_c_interface_matches_the_wrapper():
    """The launcher's arguments, the tiles, the ring's depth, the
    shared-memory cap and the mask value in the CUDA source agree with
    the wrapper and the plain version."""
    src = (CSRC / "flash_decode.cu").read_text()
    sig = re.search(r"int flash_decode_launch\(([^)]*)\)", src).group(1)
    params = [p.strip() for p in sig.split(",")]
    assert [p.split()[-1] for p in params] == [
        "q", "k", "v", "q_pos", "kv_pos", "out", "part", "batch", "s_len",
        "hkv", "g", "d", "window", "part_len", "n_parts", "gb", "words",
        "kst", "heads", "smem_bytes", "bf16", "use_mma", "stream"]
    assert sum(p.startswith("int ") for p in params) == 15
    assert "kMaxSmem = 227 * 1024" in src and K.SMEM_BUDGET == 227 * 1024
    assert f"kTile = {K.TILE};" in src
    assert f"kMmaTile = {K.MMA_TILE};" in src
    assert f"kStages = {K.STAGES};" in src
    assert f"kMaxWords = {K.MAX_WORDS};" in src
    assert f"kMaxHeads = {K.MAX_HEADS};" in src
    assert "kNegInf = -1e30f" in src and NEG_INF == -1e30
    assert "INFINITY" not in src
    for d in K.MMA_WIDTHS:
        assert re.search(rf"case {d}:\s*return launch_k\(flash_decode_mma_"
                         rf"kernel<{d // 16}>,", src)
