// Fused JEDI-net edge block (x -> Ebar) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_edge_block_kernel` in
// src/repro/kernels/fused_jedinet/kernel.py (pallas_call in
// `fused_edge_block_kernel_call`), which serves the `fused` path:
//
//   Ebar[b, i] = sum over s != i of f_R(x[b, i] || x[b, s])
//
// with f_R's first layer split into a receiver half x.W1r and a sender half
// x.W1s computed once per node, written to device memory as (B, N_o, D_e)
// fp32; f_O and phi_O follow in plain PyTorch, as the reference leaves them
// to XLA.  The TPU kernel sums the full N_o x N_o grid and subtracts the
// diagonal afterwards; this kernel skips the self-edge before the sum (the
// same function, without the cancellation).
//
// What bounds it on this card: arithmetic.  At jedi_30p an event costs
// ~0.4 M multiply-adds on the grid against ~2 KB of x read and ~1 KB of
// Ebar written, far above the H100's ~20 fp32 FLOP/B ridge.  The design is
// B1's edge stage (jedi_common.cuh `edge_block`): one block owns `epb`
// whole events and loops over sender tiles itself, so the jedi_tracks_128
// shapes that the TPU kernel's untiled VMEM model rejects run here with a
// sender tile smaller than N_o; f_R's weights are staged once per block in
// shared memory (int8 is rejected by the Python wrapper, as the reference
// rejects it); sums in fixed order, no float atomics.
//
// Build (no PyTorch headers; bound with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libfused_jedinet_edge.so fused_jedinet_edge.cu

#include "jedi_common.cuh"

namespace {

__global__ void jedi_edge_block_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float smem[];
  const Team t = make_team(a, smem);
  const int ev0 = blockIdx.x * a.epb;
  stage_inputs(a, smem, ev0);
  __syncthreads();

  edge_block(a, smem, t);

  // ---- Ebar to device memory, (B, N_o, D_e) fp32, the block's events are
  // contiguous there
  const float* EBAR = smem + a.off_ebar;
  const int n = a.epb * a.n_o * a.d_e;
  const size_t base = static_cast<size_t>(ev0) * a.n_o * a.d_e;
  const size_t limit = static_cast<size_t>(a.batch) * a.n_o * a.d_e;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (base + i < limit)
      a.out[base + i] = EBAR[(i / a.d_e) * a.de_p + i % a.d_e];
  }
}

}  // namespace

extern "C" {

int jedi_edge_block_header_len() { return kHeader; }

// Launch on `stream`; `meta` and `scales` as for jedi_fused_full_launch,
// with f_R's entries only (n_fo = n_phi = 0).  `out` is (B, N_o, D_e)
// fp32.  Returns the cudaError_t of the launch (0 = launched).
int jedi_edge_block_launch(const void* x, const void* w, const float* b,
                           float* out, const int* meta, int n_meta,
                           const float* scales, void* stream) {
  Args a;
  cudaError_t err = read_args(a, x, w, b, out, meta, n_meta, scales);
  if (err != cudaSuccess) return err;
  if (a.n_fo != 0 || a.n_phi != 0 || a.quant != 0)
    return cudaErrorInvalidValue;
  return launch_blocks(jedi_edge_block_kernel, a, stream);
}

}  // extern "C"
