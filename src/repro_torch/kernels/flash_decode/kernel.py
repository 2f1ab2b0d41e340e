"""Flash decode: wrapper of kernel B5 and its shared-memory plan.

Port of ``repro.kernels.flash_decode.kernel``.  The TPU kernel
``_decode_kernel`` becomes the hand-written CUDA kernel in
``kernels/csrc/flash_decode.cu`` (see its header for the design and what
bounds it).  :func:`flash_decode_kernel_call` is the wrapper: on CUDA
tensors it checks shapes, types, devices and layout, allocates the output
with ``torch.empty`` and launches the kernel on the current stream
(raising on a non-zero ``cudaError_t``); on CPU tensors it runs the plain
version :func:`~repro_torch.kernels.flash_decode.ref.flash_decode_ref`.
It never catches and falls back.  ``flash_decode_kernel_call.launches``
counts one per call: with several sequence partitions the C call
launches the decode kernel and then the small kernel that combines the
partitions, and both are that one launch.

The wrapper reaches both through one registered op,
``torch.ops.repro_torch.flash_decode`` (``torch.library.custom_op``): its
CUDA kernel is the launch, its CPU kernel the plain version, and its fake
kernel gives the output's shape, so the op runs under ``FakeTensorMode``
(the dry run, ``launch/dryrun.py``) without reaching the launch.  Eager
calls on plain CUDA tensors with no dispatch mode active call the op's
CUDA kernel straight, as the op would, without its Python dispatch.  Its FLOP
formula (:func:`decode_flops`, registered with
``torch.utils.flop_counter``) counts the kernel's work, so a counter of
the step (``launch/roofline.py``) sees one op with B5's operations and
not the plain version's products.

:func:`plan` splits the sequence into partitions so the grid fills the
card at any batch, and picks the kernel's path: tensor cores for a bf16
cache at G = 4 (danube's decode), CUDA cores otherwise.  The kernel takes any S:
each partition's last tile is masked by length, so the reference's rule
``S % chunk == 0`` has no counterpart; ``chunk`` here pins the keys per
partition, the unit whose softmax carry is combined.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.flash_decode.ref import flash_decode_ref

LIB_NAME = "flash_decode"
SOURCES = ("flash_decode.cu",)

#: Dynamic shared memory a block may opt into (``kMaxSmem`` in the source).
SMEM_BUDGET = 227 * 1024
#: Shared memory of one H100 SM that blocks can share, and what the card
#: reserves per resident block.
SMEM_PER_SM = 228 * 1024
SMEM_RESERVED_PER_BLOCK = 1024
#: Resident blocks and threads an SM takes at most, and the card's SMs.
MAX_BLOCKS_PER_SM = 32
MAX_THREADS_PER_SM = 2048
SMS = 132
#: Keys per ring stage: the CUDA-core path's (one per lane of the block's
#: one warp) and the tensor-core path's (one mma tile); the ring's depth
#: (``kTile`` / ``kMmaTile`` / ``kStages`` in the source).
TILE = 32
MMA_TILE = 16
STAGES = 3
#: 16-byte words a cache row may have (``kMaxWords``).
MAX_WORDS = 32
#: kv-heads a block of the tensor-core path takes at most (``kMaxHeads``).
MAX_HEADS = 8
#: Head widths of the tensor-core path (``flash_decode_mma_kernel``).
MMA_WIDTHS = (32, 64, 80, 128)
#: The grid aims at this many waves of resident blocks, and a partition
#: has at least this many keys (its carry and its write are overhead).
WAVES = 4
MIN_PART_KEYS = 256


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch: query rows taken ``gb`` at a time (``n_groups`` blocks
    per kv-head group and partition), ``heads`` kv-heads per block (one
    warp each), rows of ``words`` 16-byte words (``kst`` words apart in
    shared memory), ``n_parts`` partitions of ``part_len`` keys walked in
    ``tile``-key stages, ``smem_bytes`` of shared memory per block,
    ``blocks`` blocks; ``mma``: the tensor-core path."""

    gb: int
    n_groups: int
    words: int
    kst: int
    heads: int
    tile: int
    part_len: int
    n_parts: int
    stages: int
    smem_bytes: int
    blocks: int
    mma: bool

    @property
    def path(self) -> str:
        """"mma" (the tensor-core products) or "fma" (CUDA cores)."""
        return "mma" if self.mma else "fma"

    @property
    def threads(self) -> int:
        return 32 * self.heads

    @property
    def blocks_per_sm(self) -> int:
        return blocks_per_sm(self.smem_bytes, self.threads)


def group_rows(g: int) -> int:
    """Query rows a block takes: the largest of 8, 4, 2, 1 dividing G."""
    return next(n for n in (8, 4, 2, 1) if g % n == 0)


def block_heads(hkv: int) -> int:
    """kv-heads a tensor-core block takes: the largest divisor of Hkv up
    to :data:`MAX_HEADS` (they lie side by side in each cache row)."""
    return max(n for n in range(1, MAX_HEADS + 1) if hkv % n == 0)


def smem_bytes(gb: int, words: int, elem: int, heads: int = 1,
               mma: bool = False) -> int:
    """A block's shared memory: the ring (K and V rows ``words | 1``
    16-byte words apart, kv_pos) and the p of its rows; the CUDA-core
    path also keeps the group's q rows in fp32."""
    kst = words | 1
    if mma:
        stage = 16 * MMA_TILE * kst * 2 * heads + 4 * MMA_TILE
        return STAGES * stage + 4 * heads * gb * MMA_TILE
    stage = 16 * TILE * 2 * kst + 4 * TILE
    return STAGES * stage + 4 * gb * words * (16 // elem) + 4 * TILE * gb


def blocks_per_sm(smem: int, threads: int = 32) -> int:
    return min(MAX_BLOCKS_PER_SM, MAX_THREADS_PER_SM // threads,
               SMEM_PER_SM // (smem + SMEM_RESERVED_PER_BLOCK))


def plan(b: int, hkv: int, g: int, d: int, s_len: int, elem: int,
         chunk: int | None = None, *, aligned: bool = True) -> Plan:
    """The launch for B sequences of S keys, Hkv kv-heads of G query rows
    of width D, a cache of ``elem`` bytes a value (4 or 2), 16-byte
    ``aligned`` or not.

    The tensor-core path where it applies (a bf16 cache, aligned, G = 4,
    D in :data:`MMA_WIDTHS`), with as many kv-heads a block as
    :func:`block_heads` gives and the grid still covers the 132 SMs;
    else the CUDA-core path.  ``chunk`` pins the keys per partition; by
    default there are enough partitions that the grid holds
    :data:`WAVES` waves of the blocks the card keeps resident, each of at
    least :data:`MIN_PART_KEYS` keys (whole tiles) where S allows."""
    if chunk is not None and chunk < 1:
        raise ValueError(f"chunk must be >= 1, not {chunk}")
    if s_len < 1:
        raise ValueError("the cache must hold at least one key")
    per_word = 16 // elem
    words = -(-d // per_word)
    if words > MAX_WORDS:
        raise ValueError(f"rows of D={d} x {elem} B are {words} 16-byte "
                         f"words; the kernel takes at most {MAX_WORDS}")
    gb = group_rows(g)
    mma = elem == 2 and aligned and g == 4 and d in MMA_WIDTHS
    heads = block_heads(hkv) if mma else 1
    while True:
        lay = _plan(b, hkv, g, d, s_len, elem, chunk, gb, words, heads, mma)
        # fewer heads a block where the grid would leave SMs idle
        if lay.blocks >= SMS or heads == 1:
            return lay
        heads = max(n for n in range(1, heads) if hkv % n == 0)


def _plan(b, hkv, g, d, s_len, elem, chunk, gb, words, heads, mma) -> Plan:
    tile = MMA_TILE if mma else TILE
    smem = smem_bytes(gb, words, elem, heads, mma)
    if smem > SMEM_BUDGET:
        raise ValueError(f"{smem} B of shared memory exceeds the kernel's "
                         f"{SMEM_BUDGET} B")
    pairs = b * (hkv // heads) * (g // gb)
    if chunk is None:
        per_sm = blocks_per_sm(smem, 32 * heads)
        want = -(-SMS * per_sm * WAVES // pairs)
        parts = max(1, min(want, -(-s_len // MIN_PART_KEYS)))
        part_len = -(-(-(-s_len // parts)) // tile) * tile
    else:
        part_len = min(int(chunk), s_len)
    n_parts = -(-s_len // part_len)
    return Plan(gb, g // gb, words, words | 1, heads, tile, part_len,
                n_parts, STAGES, smem, pairs * n_parts, mma)


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = build.load_library(LIB_NAME, SOURCES)
    for name, want in (("flash_decode_tile", TILE),
                       ("flash_decode_mma_tile", MMA_TILE),
                       ("flash_decode_stages", STAGES)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        if fn() != want:
            raise RuntimeError(f"{name}() is {fn()}, the wrapper's {want}: "
                               "rebuild in step")
    fn = lib.flash_decode_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 15 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, q_pos, kv_pos, window):
    if q.dim() != 4 or q.dtype != torch.float32:
        raise ValueError(f"q must be (B, Hkv, G, D) float32; got "
                         f"{tuple(q.shape)} {q.dtype}")
    b, hkv, _, d = q.shape
    if k.dim() != 4 or k.shape[0] != b or tuple(k.shape[2:]) != (hkv, d) \
            or k.shape != v.shape:
        raise ValueError(f"k and v must be (B, S, Hkv, D) = ({b}, S, {hkv}, "
                         f"{d}); got {tuple(k.shape)} and {tuple(v.shape)}")
    if k.dtype not in (torch.float32, torch.bfloat16) or v.dtype != k.dtype:
        raise TypeError(f"k and v must both be float32 or both bfloat16; "
                        f"got {k.dtype} and {v.dtype}")
    if q_pos.shape != (b,) or kv_pos.shape != (b, k.shape[1]) \
            or q_pos.dtype != torch.int32 or kv_pos.dtype != torch.int32:
        raise ValueError("q_pos must be (B,) and kv_pos (B, S), both int32")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, not {window}")
    devices = {t.device for t in (q, k, v, q_pos, kv_pos)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")


def flash_decode_kernel_call(q, k, v, q_pos, kv_pos, *, chunk=None,
                             window=None):
    """q: (B, Hkv, G, D) fp32 pre-scaled; k/v: (B, S, Hkv, D) fp32 or bf16;
    q_pos: (B,) int32; kv_pos: (B, S) int32 (-1: unwritten) ->
    (B, Hkv, G, D) fp32.

    CUDA tensors launch the kernel (and, with more than one partition,
    its combine) with ``chunk`` keys per partition, by default the
    plan's (:func:`plan`); CPU tensors run the plain version; fake
    tensors get the output's shape.  Raises on what the kernel does not
    take.
    """
    _check(q, k, v, q_pos, kv_pos, window)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the kernel runs on CUDA tensors, not {q.device}")
    return torch.ops.repro_torch.flash_decode(q, k, v, q_pos, kv_pos, chunk,
                                              window)


flash_decode_kernel_call.launches = 0


@torch.library.custom_op(
    "repro_torch::flash_decode", mutates_args=(), device_types="cpu",
    schema="(Tensor q, Tensor k, Tensor v, Tensor q_pos, Tensor kv_pos, "
           "int? chunk, int? window) -> Tensor")
def _flash_decode_op(q, k, v, q_pos, kv_pos, chunk, window):
    return flash_decode_ref(q, k, v, q_pos, kv_pos, window=window)


@_flash_decode_op.register_kernel("cuda")
def _launch(q, k, v, q_pos, kv_pos, chunk, window):
    """The kernel's launch on the current stream; counts it."""
    if not all(t.is_contiguous() for t in (q, k, v, q_pos, kv_pos)):
        raise ValueError("q, k, v, q_pos and kv_pos must be contiguous")
    b, hkv, g, d = q.shape
    s_len = k.shape[1]
    out = torch.empty((b, hkv, g, d), dtype=torch.float32, device=q.device)
    if b == 0:
        return out
    lay = plan(b, hkv, g, d, s_len, k.element_size(), chunk,
               aligned=k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0)
    part = None if lay.n_parts == 1 else torch.empty(
        b * hkv * g * lay.n_parts * (d + 2), dtype=torch.float32,
        device=q.device)
    err = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
        kv_pos.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), b, s_len, hkv, g, d,
        0 if window is None else int(window), lay.part_len, lay.n_parts,
        lay.gb, lay.words, lay.kst, lay.heads, lay.smem_bytes,
        int(k.dtype == torch.bfloat16), int(lay.mma),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"flash_decode_launch failed: cudaError_t {err} "
            f"({torch.cuda.get_device_name(q.device)}, B={b}, S={s_len}, "
            f"Hkv={hkv}, G={g}, D={d}, {lay.n_parts} partitions of "
            f"{lay.part_len} keys, {lay.smem_bytes} B shared memory)")
    # the module's name, so a stand-in there (chip_smoke's HeldB5) counts
    flash_decode_kernel_call.launches += 1
    return out


@_flash_decode_op.register_fake
def _fake(q, k, v, q_pos, kv_pos, chunk, window):
    return q.new_empty(q.shape, dtype=torch.float32)


def decode_flops(b: int, s: int, h: int, d: int) -> int:
    """Operations of one-token attention of B x H query rows of width D
    over S keys, every key read: per (row, key) the score (2D), its
    weight on v (2D), and the mask's select, the max, the exp and the
    sum (4)."""
    return b * h * s * (4 * d + 4)


#: The registered op (its overload packet), for callers that count it.
flash_decode_op = torch.ops.repro_torch.flash_decode


@register_flop_formula(flash_decode_op)
def _flash_decode_flops(q_shape, k_shape, *args, out_shape=None, **kwargs):
    b, hkv, g, d = q_shape
    return decode_flops(b, k_shape[1], hkv * g, d)
