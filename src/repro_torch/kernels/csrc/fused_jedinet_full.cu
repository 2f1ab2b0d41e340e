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
// limit (operations/byte far above the H100's ~20 fp32 FLOP/B ridge):
// 0.476 GFLOP at B=256, 7 us at 67 TFLOP/s.  What a design has to do is
// keep the FMA pipes fed: many independent chains per thread, few shared
// memory reads per FMA, and a full card.
//
// Two designs; kernels/fused_jedinet/autotune.py `plan_full` picks one per
// shape and the wrapper calls its entry point:
//
// * "warp" (jedi_fused_full_warp_launch), where f_R's widths fit in
//   registers (at most 64, D_e at most 8; jedi_30p and jedi_50p) and no
//   sender tile is pinned:
//   - one thread per edge: a warp's lanes are the senders of its
//     receivers (N_o > 32: each lane walks sender tiles of 32 in
//     ascending order); a lane takes two receivers at once where the
//     width allows (RPL), so each weight read feeds two edges; a block
//     owns one event at a time, and the grid is as many blocks as the
//     card keeps resident, each walking events (the weights are staged
//     once per block);
//   - the edge's activations live in registers (`RW` of them, a template
//     width of 20, 32 or 64); f_R's layers after the first are staged
//     zero-padded to RW x RW, so each is a fixed, fully unrolled set of
//     independent FMA chains whose weights are read as broadcast float4
//     (all lanes one address): one shared-memory read per 4 FMAs a
//     receiver;
//   - u_r and u_s are computed once per node, not once per edge;
//   - the self-edge lane's f_R output is zeroed before the sum, and the
//     sender sum is a fixed __shfl_xor tree (the plain version sums in the
//     same tree order);
//   - f_O runs for all the event's nodes at once on the compute warps, a
//     thread per (node, 4 output columns): on the receivers' own warps it
//     left most lanes idle and its serial chains were a third of the
//     event; a dedicated readout warp takes the node sum in node order
//     and phi_O (lanes over outputs) for event k from one of two f_O
//     buffers while the compute warps run event k + 1 into the other
//     (named barriers hand the buffers over).  No phase runs on a single
//     thread.
//   Its pieces (the staging, u_r / u_s, the edge stage, rows_mlp, the
//   readout warp, the resident launch) live in jedi_warp.cuh, shared with
//   B3's warp design and B2's rows design.
// * "team" (jedi_fused_full_launch), where f_R is wider (jedi_tracks_128's
//   128) or a sender tile is pinned (`block_s`): the first port's layout in
//   jedi_common.cuh, shared with B3 — one block owns `epb` whole events
//   and loops over sender tiles; a "team" of threads evaluates one grid
//   cell's MLP, 4 outputs per thread and pass; each receiver's senders are
//   split `ks` ways and the partials summed in split order.
//
// Both: every weight staged once into shared memory, upcast to fp32 as it
// lands (int8 and bf16 are read from device memory in their own width);
// in bf16 every product operand is rounded to bf16, sums and biases stay
// fp32; an int8 tensor's scale multiplies the fp32 sum before the bias
// (w1r and w1s share w1's).  Fixed summation orders and no float atomics:
// two launches give bitwise equal logits.  fp32 FMA on CUDA cores;
// wgmma is later work.
//
// Build (no PyTorch headers; bound with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libfused_jedinet_full.so fused_jedinet_full.cu

#include "jedi_common.cuh"
#include "jedi_warp.cuh"

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

// ---- The warp design --------------------------------------------------------
// Shared memory (word offsets from the header): w, b (the weights and
// biases), x (one event), part (u_r per node), us (u_s per node; both
// rows `h1_p | 1` words apart, so lanes reading different senders' rows
// hit different banks), ebar (f_O's two activation buffers, a row per
// node, rows an odd number of words apart), obuf (f_O's output per node,
// two events' worth), slot (the readout warp's two activation buffers of
// slot_stride / 2 words) and pool (f_R's layers after the first,
// zero-padded to RW x RW, the last to RW x kEdgeRegs, then their biases
// padded the same way).  The pieces it shares with B2 and B3 are in
// jedi_warp.cuh.

// RW: registers per lane for f_R's activations; the edge output (D_e <=
// kEdgeRegs) and its sender sum in kEdgeRegs more.  MULTI: N_o > 32, so a
// lane walks several sender tiles and keeps its running sum across them.
// The block's last warp is the readout warp: it takes event k's node sum
// and phi_O from one of two f_O buffers while the compute warps run event
// k + 1 into the other.
template <int RW, bool MULTI>
__global__ void __launch_bounds__(warp_threads<RW>())
    jedi_fused_full_warp_kernel(const __grid_constant__ Args a) {
  constexpr int EW = kEdgeRegs;
  constexpr int R = warp_rpl<RW>();
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n_cw = (nt >> 5) - 1, ct = 32 * n_cw;   // compute warps, threads
  float* W = smem + a.off_w;
  float* Bv = smem + a.off_b;
  float* X = smem + a.off_x;
  float* UR = smem + a.off_part;
  float* US = smem + a.off_us;
  float* S0 = smem + a.off_slot;             // the readout warp's buffers
  float* S1 = S0 + a.slot_stride / 2;
  float* FO = smem + a.off_ebar;             // f_O's two activation buffers
  int fst = (a.p + a.d_e + 3) / 4 * 4;       // their rows: odd, >= every
  for (int l = 0; l < a.n_fo; ++l)           // f_O input and padded output
    fst = max(fst, a.e[a.n_fr + l].outp);
  fst |= 1;
  const int n_o = a.n_o, p = a.p, ust = a.h1_p | 1;
  const int obuf_words = n_o * a.do_p;
  const int n_ev = block_events(a);

  // the weights (upcast, rounded in bf16) and biases, once per block, and
  // f_R's layers after the first padded to RW x RW (the last RW x EW)
  stage_weights(a, W, Bv, tid, nt);
  float* FP = smem + a.off_pool;
  float* FB = fr_padded_biases<RW>(a, FP);
  stage_fr_padded<RW>(a, FP, FB, tid, nt);
  __syncthreads();

  if (warp == n_cw) {
    // ---- the readout warp: node sum in node order, phi_O, the logits
    readout_warp(a, W, Bv, smem + a.off_obuf, S0, S1, n_ev, lane);
    return;
  }

  for (int k = 0; k < n_ev; ++k) {
    const int ev = blockIdx.x + k * gridDim.x;
    float* OBUF = smem + a.off_obuf + (k & 1) * obuf_words;
    load_event(a, X, ev, tid, ct);
    bar_sync(kBarCompute, ct);
    // u_r and u_s once per node, one thread per 4 columns of a node
    node_halves(a, W, X, UR, US, ust, tid, ct);
    bar_sync(kBarCompute, ct);
    // the readout of event k - 2 has left this f_O buffer
    if (k >= 2) bar_sync(kBarEmpty + (k & 1), nt);

    for (int r0 = warp * R; r0 < n_o; r0 += n_cw * R) {
      // ---- f_R on the edges (r0 + q, s), one sender per lane, summed
      float es[R][EW];
      edge_sums<RW, R, MULTI>(a, UR, US, ust, Bv, FP, FB, r0, lane, es);

      // ---- C = [x_r || Ebar_r], f_O's input row of node r
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int r = r0 + q;
        if (r >= n_o) break;
        float* c = FO + r * fst;
        for (int i = lane; i < p; i += 32) c[i] = X[r * p + i];
        if (lane == 0) {
#pragma unroll
          for (int o = 0; o < EW; ++o)
            if (o < a.d_e) c[p + o] = es[q][o];
        }
      }
    }
    bar_sync(kBarCompute, ct);    // every node's input row is written

    // ---- f_O for every node: a thread per (node, 4 output columns), the
    // nodes' rows ping-ponging between the two buffers, the last layer
    // into this event's f_O buffer
    rows_mlp(a, W, Bv, a.e + a.n_fr, a.n_fo, FO, FO + n_o * fst, n_o, fst,
             OBUF, a.do_p, tid, ct);
    bar_arrive(kBarFull + (k & 1), nt);   // to the readout warp
  }
}

// Launch the warp design over the batch: as many blocks as the card keeps
// resident (at most one per event), each walking events; each
// instantiation keeps its own launch cache.
template <int RW, bool MULTI>
cudaError_t launch_warp(const Args& a, void* stream) {
  if (a.threads > warp_threads<RW>() || a.threads % 32 != 0)
    return cudaErrorInvalidValue;
  static ResidentCache cache;
  return launch_resident(jedi_fused_full_warp_kernel<RW, MULTI>, cache, a,
                         stream);
}

}  // namespace

extern "C" {

int jedi_fused_full_header_len() { return kHeader; }
int jedi_fused_full_warp_header_len() { return kHeader; }

// The team design.  Launch on `stream`.  `meta` = kHeader ints
// (JEDI_HEADER_FIELDS order) then 5 ints per entry (in, out, outp, w_off,
// b_off); `scales` one float per entry.  Returns the cudaError_t of the
// launch (0 = launched).
int jedi_fused_full_launch(const void* x, const void* w, const float* b,
                           float* out, const int* meta, int n_meta,
                           const float* scales, void* stream) {
  Args a;
  cudaError_t err = read_args(a, x, w, b, out, meta, n_meta, scales);
  if (err != cudaSuccess) return err;
  if (a.n_fo < 1 || a.n_phi < 1) return cudaErrorInvalidValue;
  static int opted = 0;
  return launch_blocks(jedi_fused_full_kernel, opted, a, stream);
}

// The warp design, same arguments.  The header's `mw` is the register
// width RW (20, 32 or 64: every f_R width must fit, and D_e <= 8),
// `team` is 1, `ks` the receivers per compute warp (a multiple of RPL),
// `epb` 1 and `threads` the compute warps' plus the readout warp's.
int jedi_fused_full_warp_launch(const void* x, const void* w, const float* b,
                                float* out, const int* meta, int n_meta,
                                const float* scales, void* stream) {
  Args a;
  cudaError_t err = read_args(a, x, w, b, out, meta, n_meta, scales);
  if (err != cudaSuccess) return err;
  if (a.n_fo < 1 || a.n_phi < 1 || a.team != 1 || a.epb != 1 ||
      a.threads < 64 || (a.threads / 32 - 1) * a.ks < a.n_o ||
      a.slot_stride % 2 != 0 || !fr_fits_registers(a, a.mw))
    return cudaErrorInvalidValue;
  // RW as the header's mw; MULTI where a lane walks several sender tiles
  const bool multi = a.n_o > 32;
  if (a.mw == 20)
    return multi ? launch_warp<20, true>(a, stream)
                 : launch_warp<20, false>(a, stream);
  if (a.mw == 32)
    return multi ? launch_warp<32, true>(a, stream)
                 : launch_warp<32, false>(a, stream);
  if (a.mw == 64)
    return multi ? launch_warp<64, true>(a, stream)
                 : launch_warp<64, false>(a, stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
