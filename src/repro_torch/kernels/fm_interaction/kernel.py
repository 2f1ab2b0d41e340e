"""FM pairwise interaction: wrapper of kernel B4 and its launch plan.

Port of ``repro.kernels.fm_interaction.kernel``.  The TPU kernel
``_fm_kernel`` becomes the hand-written CUDA kernel in
``kernels/csrc/fm_interaction.cu`` (see its header for the design and
what bounds it).  :func:`fm_interaction_kernel_call` is the wrapper: on a
CUDA tensor it checks shape, type and layout, allocates the (B,) output
with ``torch.empty`` and launches the kernel on the current stream
(raising on a non-zero ``cudaError_t``); on a CPU tensor it runs the
plain version :func:`~repro_torch.kernels.fm_interaction.ref.fm_interaction_ref`.
It never catches and falls back.  ``fm_interaction_kernel_call.launches``
counts the launches.

The kernel takes any B and masks its last block, so the reference's
``pick_block_b`` / ``pad_batch`` have no counterpart here.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fm_interaction.ref import fm_interaction_ref

LIB_NAME = "fm_interaction"
SOURCES = ("fm_interaction.cu",)

#: The kernel's shared-memory budget per block (the default dynamic limit,
#: ``kMaxSmem`` in the source).
SMEM_BUDGET = 48 * 1024
#: At most this many samples per block.
MAX_SAMPLES_PER_BLOCK = 256


def plan(f: int, k: int) -> tuple[int, int]:
    """(samples per block, shared-memory bytes) for (F, K): a block stages
    its samples' F*K values and K terms each in fp32.  A multiple of 8
    samples where 8 fit, so every block's range of v starts 16-byte
    aligned in fp32 and in bf16."""
    per_sample = 4 * (f * k + k)
    spb = min(SMEM_BUDGET // per_sample, MAX_SAMPLES_PER_BLOCK)
    if spb < 1:
        raise ValueError(f"F*K = {f * k} values per sample do not fit the "
                         f"kernel's {SMEM_BUDGET} B of shared memory")
    if spb >= 8:
        spb -= spb % 8
    return spb, spb * per_sample


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load_library(LIB_NAME, SOURCES).fm_interaction_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fm_interaction_kernel_call(v: torch.Tensor) -> torch.Tensor:
    """v: (B, F, K) fp32 or bf16 -> (B,) fp32.

    CUDA tensors launch the kernel; CPU tensors run the plain version.
    Raises on shapes, types, layouts or devices the kernel does not take.
    """
    if v.dim() != 3:
        raise ValueError(f"v must be (B, F, K); got {tuple(v.shape)}")
    if v.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"v must be float32 or bfloat16, not {v.dtype}")
    if v.device.type == "cpu":
        return fm_interaction_ref(v)
    if v.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, not {v.device}")
    if not v.is_contiguous():
        raise ValueError("v must be contiguous")
    b, f, k = v.shape
    spb, smem = plan(f, k)
    out = torch.empty((b,), dtype=torch.float32, device=v.device)
    if b == 0:
        return out
    err = _launcher()(v.data_ptr(), out.data_ptr(), b, f, k, spb,
                      int(v.dtype == torch.bfloat16),
                      torch.cuda.current_stream(v.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"fm_interaction_launch failed: cudaError_t {err} "
            f"({torch.cuda.get_device_name(v.device)}, B={b}, F={f}, K={k}, "
            f"{spb} samples per block, {smem} B shared memory)")
    fm_interaction_kernel_call.launches += 1
    return out


fm_interaction_kernel_call.launches = 0
