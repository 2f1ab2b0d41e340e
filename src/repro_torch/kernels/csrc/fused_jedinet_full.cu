// Whole-network fused JEDI-net forward (x -> logits) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_tiled_forward_kernel` in
// src/repro/kernels/fused_jedinet/full_kernel.py (pallas_call in
// `fused_forward_full_kernel_call`).  Same function: f_R's first layer
// split into a receiver half u_r = x.W1r and a sender half u_s = xs.W1s,
// the dense receiver x sender grid through the remaining f_R layers, the
// self-edge skipped (never subtracted), the sender sum in fp32, then
// C = [x || Ebar], f_O, the node sum and phi_O.
//
// What bounds it on this card: arithmetic.  At jedi_30p an event costs
// ~0.9 M multiply-adds on the N_o x N_o grid against ~2 KB of x read and
// 20 B of logits written, so the card's fp32 rate, not its memory, is the
// limit (operations/byte far above the H100's ~20 fp32 FLOP/B ridge).
// The design keeps every intermediate on-chip and reads device memory
// once per block:
//   * one block owns `epb` whole events and loops over sender tiles
//     itself (the TPU carried its accumulator across sequential grid
//     steps; blocks here run in no order, so nothing crosses blocks);
//   * all weights are copied once into shared memory, upcast to fp32
//     (int8 and bf16 are read from device memory in their own width);
//   * a "team" of `team` threads evaluates one grid cell's MLP, each
//     thread 4 outputs per pass from float4 weight rows (broadcast reads);
//   * each receiver's senders are split `ks` ways; every split sums its
//     senders in ascending order into its own partial, and the partials
//     are summed in split order: no float atomics, so the logits are
//     bitwise repeatable from run to run.
// fp32 FMA on CUDA cores throughout; wgmma and TMA are later work.  The
// staging, the team MLPs, the edge block and the readout live in
// jedi_common.cuh, shared with B2 and B3 (numerics stated there).
//
// Build (no PyTorch headers; bound with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libfused_jedinet_full.so fused_jedinet_full.cu

#include "jedi_common.cuh"

namespace {

__global__ void jedi_fused_full_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float smem[];
  const Team t = make_team(a, smem);
  const int ev0 = blockIdx.x * a.epb;
  stage_inputs(a, smem, ev0);
  __syncthreads();

  // ---- edge block: Ebar for the block's events
  edge_block(a, smem, t);

  // ---- f_O on C = [x || Ebar], one node per team
  const float* X = smem + a.off_x;
  const float* EBAR = smem + a.off_ebar;
  float* OBUF = smem + a.off_obuf;
  for (int it = t.id; it < a.epb * a.n_o; it += t.n) {
    for (int i = t.tl; i < a.p + a.d_e; i += t.G)
      t.A[i] = i < a.p ? X[it * a.p + i] : EBAR[it * a.de_p + i - a.p];
    team_mlp(a, smem, t, a.e + a.n_fr, a.n_fo, t.A, t.B,
             OBUF + it * a.do_p);
    team_sync(t);
  }
  __syncthreads();

  // ---- node sum, phi_O, logits
  readout(a, smem, t, ev0);
}

}  // namespace

extern "C" {

int jedi_fused_full_header_len() { return kHeader; }

// Launch on `stream`.  `meta` = kHeader ints (JEDI_HEADER_FIELDS order)
// then 5 ints per entry (in, out, outp, w_off, b_off); `scales` one float
// per entry.  Returns the cudaError_t of the launch (0 = launched).
int jedi_fused_full_launch(const void* x, const void* w, const float* b,
                           float* out, const int* meta, int n_meta,
                           const float* scales, void* stream) {
  Args a;
  cudaError_t err = read_args(a, x, w, b, out, meta, n_meta, scales);
  if (err != cudaSuccess) return err;
  if (a.n_fo < 1 || a.n_phi < 1) return cudaErrorInvalidValue;
  return launch_blocks(jedi_fused_full_kernel, a, stream);
}

}  // extern "C"
