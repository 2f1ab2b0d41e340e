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
counts the launches.

The kernel takes any S: its last sequence tile is masked by length, so
the reference's rule ``S % chunk == 0`` has no counterpart.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_decode.ref import flash_decode_ref

LIB_NAME = "flash_decode"
SOURCES = ("flash_decode.cu",)

#: The kernel's shared-memory budget per block (the default dynamic limit,
#: ``kMaxSmem`` in the source).
SMEM_BUDGET = 48 * 1024
#: Keys per sequence tile unless the caller asks for another.
DEFAULT_CHUNK = 64


@dataclasses.dataclass(frozen=True)
class Plan:
    """The kernel's shared-memory layout (``struct Layout`` in the
    source): ``chunk`` keys per tile, K rows ``kst`` floats apart."""

    chunk: int
    d4: int
    kst: int
    smem_bytes: int


def plan(g: int, d: int, s_len: int, chunk: int | None = None) -> Plan:
    """The layout for G query rows of width D over S keys.

    The tile is ``chunk`` keys (default :data:`DEFAULT_CHUNK`), at most S,
    and at most what fits :data:`SMEM_BUDGET`: K and V tiles in fp32, the
    G rows of q and acc, the (G, C) scores, the carry and the tile's
    kv_pos.  K rows are padded to an odd number of 16-byte words."""
    if chunk is not None and chunk < 1:
        raise ValueError(f"chunk must be >= 1, not {chunk}")
    d4 = -(-d // 4) * 4
    kst = d4 + 4 if (d4 // 4) % 2 == 0 else d4
    per_key, fixed = kst + d4 + g + 1, g * (2 * d4 + 3)
    fit = (SMEM_BUDGET // 4 - fixed) // per_key
    if fit < 1:
        raise ValueError(f"G={g} query rows of D={d} do not fit the "
                         f"kernel's {SMEM_BUDGET} B of shared memory")
    c = min(chunk or DEFAULT_CHUNK, max(s_len, 1), fit)
    return Plan(c, d4, kst, 4 * (c * per_key + fixed))


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load_library(LIB_NAME, SOURCES).flash_decode_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 \
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

    CUDA tensors launch the kernel with ``chunk`` keys per sequence tile
    (:func:`plan`); CPU tensors run the plain version.  Raises on what
    the kernel does not take.
    """
    _check(q, k, v, q_pos, kv_pos, window)
    if q.device.type == "cpu":
        return flash_decode_ref(q, k, v, q_pos, kv_pos, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, not {q.device}")
    if not all(t.is_contiguous() for t in (q, k, v, q_pos, kv_pos)):
        raise ValueError("q, k, v, q_pos and kv_pos must be contiguous")
    b, hkv, g, d = q.shape
    s_len = k.shape[1]
    lay = plan(g, d, s_len, chunk)
    out = torch.empty((b, hkv, g, d), dtype=torch.float32, device=q.device)
    if b == 0:
        return out
    err = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
        kv_pos.data_ptr(), out.data_ptr(), b, s_len, hkv, g, d,
        0 if window is None else int(window), lay.chunk, lay.kst,
        lay.smem_bytes, int(k.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"flash_decode_launch failed: cudaError_t {err} "
            f"({torch.cuda.get_device_name(q.device)}, B={b}, S={s_len}, "
            f"Hkv={hkv}, G={g}, D={d}, chunk {lay.chunk}, "
            f"{lay.smem_bytes} B shared memory)")
    flash_decode_kernel_call.launches += 1
    return out


flash_decode_kernel_call.launches = 0
