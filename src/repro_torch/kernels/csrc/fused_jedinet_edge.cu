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
// diagonal; this kernel skips the self-edge before the sum (the same
// function, without the cancellation).
//
// What bounds it on this card: arithmetic.  At jedi_30p an event costs
// ~0.4 M multiply-adds on the grid against ~2 KB of x read and ~1 KB of
// Ebar written, far above the H100's ~20 fp32 FLOP/B ridge.  So a design
// has to keep the FMA pipes fed.  Two designs; kernels/fused_jedinet/
// autotune.py `plan_edge` picks one per shape (the same rule as B1's
// `plan_full`) and the wrapper calls its entry point:
//
// * "warp" (jedi_edge_block_warp_launch), where f_R's widths fit in
//   registers (at most 64, D_e at most 8; jedi_30p and jedi_50p) and no
//   sender tile is pinned: B1's edge stage (jedi_warp.cuh) with every warp
//   computing and no f_O or readout.  One thread per edge, two receivers a
//   lane where the width allows, activations in registers, f_R's layers
//   after the first zero-padded to fixed widths, u_r and u_s once per
//   node, the self-edge lane adding zero and the sender sum a fixed
//   __shfl_xor tree.  A block walks events (as many blocks as the card
//   keeps resident, weights staged once per block); each event's N_o x D_e
//   sums are gathered in shared memory and written to device memory once,
//   coalesced.
// * "team" (jedi_edge_block_launch), where f_R is wider (jedi_tracks_128's
//   128) or a sender tile is pinned (`block_s`): the first port's layout
//   (jedi_common.cuh `edge_block`, shared with B1's team design) — one
//   block owns `epb` whole events and loops over sender tiles itself, so
//   the jedi_tracks_128 shapes that the TPU kernel's untiled VMEM model
//   rejects run here with a sender tile smaller than N_o.
//
// Both: f_R's weights staged once per block in shared memory (int8 is
// rejected by the Python wrapper, as the reference rejects it); in bf16
// every product operand is rounded to bf16, sums and biases stay fp32;
// sums in fixed order, no float atomics.
//
// Build (no PyTorch headers; bound with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libfused_jedinet_edge.so fused_jedinet_edge.cu

#include "jedi_common.cuh"
#include "jedi_warp.cuh"

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

// ---- The warp design --------------------------------------------------------
// Shared memory (word offsets from the header): w, b (the weights and
// biases), x (one event), part (u_r per node), us (u_s per node; rows
// `h1_p | 1` words apart), ebar (the event's N_o x D_e sums, in device
// memory's order) and pool (f_R's layers after the first, zero-padded).
// Every warp computes: the receivers r0 = warp * RPL, + warps * RPL, ...
template <int RW, bool MULTI>
__global__ void __launch_bounds__(warp_threads<RW>())
    jedi_edge_block_warp_kernel(const __grid_constant__ Args a) {
  constexpr int EW = kEdgeRegs;
  constexpr int R = warp_rpl<RW>();
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_w = nt >> 5;
  float* W = smem + a.off_w;
  float* Bv = smem + a.off_b;
  float* X = smem + a.off_x;
  float* UR = smem + a.off_part;
  float* US = smem + a.off_us;
  float* EB = smem + a.off_ebar;
  const int n_o = a.n_o, d_e = a.d_e, ust = a.h1_p | 1;
  const int n_ev = block_events(a);

  stage_weights(a, W, Bv, tid, nt);
  float* FP = smem + a.off_pool;
  float* FB = fr_padded_biases<RW>(a, FP);
  stage_fr_padded<RW>(a, FP, FB, tid, nt);
  __syncthreads();

  for (int k = 0; k < n_ev; ++k) {
    const int ev = blockIdx.x + k * gridDim.x;
    load_event(a, X, ev, tid, nt);
    __syncthreads();
    node_halves(a, W, X, UR, US, ust, tid, nt);
    __syncthreads();
    for (int r0 = warp * R; r0 < n_o; r0 += n_w * R) {
      float es[R][EW];
      edge_sums<RW, R, MULTI>(a, UR, US, ust, Bv, FP, FB, r0, lane, es);
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int r = r0 + q;
        if (r >= n_o) break;
        if (lane == 0) {
#pragma unroll
          for (int o = 0; o < EW; ++o)
            if (o < d_e) EB[r * d_e + o] = es[q][o];
        }
      }
    }
    __syncthreads();
    // the event's Ebar, contiguous in device memory: one coalesced write
    float* dst = a.out + static_cast<size_t>(ev) * n_o * d_e;
    for (int i = tid; i < n_o * d_e; i += nt) dst[i] = EB[i];
  }
}

// Launch the warp design over the batch: as many blocks as the card keeps
// resident, each walking events; each instantiation keeps its own launch
// cache.
template <int RW, bool MULTI>
cudaError_t launch_edge_warp(const Args& a, void* stream) {
  if (a.threads > warp_threads<RW>() || a.threads % 32 != 0)
    return cudaErrorInvalidValue;
  static ResidentCache cache;
  return launch_resident(jedi_edge_block_warp_kernel<RW, MULTI>, cache, a,
                         stream);
}

}  // namespace

extern "C" {

int jedi_edge_block_header_len() { return kHeader; }
int jedi_edge_block_warp_header_len() { return kHeader; }

// The team design.  Launch on `stream`; `meta` and `scales` as for
// jedi_fused_full_launch, with f_R's entries only (n_fo = n_phi = 0).
// `out` is (B, N_o, D_e) fp32.  Returns the cudaError_t of the launch (0 =
// launched).
int jedi_edge_block_launch(const void* x, const void* w, const float* b,
                           float* out, const int* meta, int n_meta,
                           const float* scales, void* stream) {
  Args a;
  cudaError_t err = read_args(a, x, w, b, out, meta, n_meta, scales);
  if (err != cudaSuccess) return err;
  if (a.n_fo != 0 || a.n_phi != 0 || a.quant != 0)
    return cudaErrorInvalidValue;
  static int opted = 0;
  return launch_blocks(jedi_edge_block_kernel, opted, a, stream);
}

// The warp design, same arguments.  The header's `mw` is the register
// width RW (20, 32 or 64: every f_R width must fit, and D_e <= 8), `team`
// is 1, `ks` the receivers per warp (a multiple of RPL), `epb` 1 and
// `threads` the warps' (all compute).
int jedi_edge_block_warp_launch(const void* x, const void* w, const float* b,
                                float* out, const int* meta, int n_meta,
                                const float* scales, void* stream) {
  Args a;
  cudaError_t err = read_args(a, x, w, b, out, meta, n_meta, scales);
  if (err != cudaSuccess) return err;
  if (a.n_fo != 0 || a.n_phi != 0 || a.quant != 0 || a.team != 1 ||
      a.epb != 1 || a.threads < 32 || (a.threads / 32) * a.ks < a.n_o ||
      !fr_fits_registers(a, a.mw))
    return cudaErrorInvalidValue;
  // RW as the header's mw; MULTI where a lane walks several sender tiles
  const bool multi = a.n_o > 32;
  if (a.mw == 20)
    return multi ? launch_edge_warp<20, true>(a, stream)
                 : launch_edge_warp<20, false>(a, stream);
  if (a.mw == 32)
    return multi ? launch_edge_warp<32, true>(a, stream)
                 : launch_edge_warp<32, false>(a, stream);
  if (a.mw == 64)
    return multi ? launch_edge_warp<64, true>(a, stream)
                 : launch_edge_warp<64, false>(a, stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
