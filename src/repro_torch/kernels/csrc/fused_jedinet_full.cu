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
// padded the same way).

// Receivers a lane takes at once (RPL) and the most threads a block may
// have, for the register width RW: RPL x RW activations and as many sums
// per lane must fit the registers of that many threads.  With two
// receivers a lane, each broadcast weight word feeds both edges.
template <int RW>
__host__ __device__ constexpr int warp_rpl() {
  return RW <= 32 ? 2 : 1;
}
template <int RW>
__host__ __device__ constexpr int warp_threads() {
  return RW <= 20 ? 512 : 256;
}

// The activation on v[0..n): ReLU inline, the others through one call
// each, so the unrolled loops hold one copy of the activations' code.
__device__ __noinline__ float activate_call(float v, int code) {
  return activate(v, code);
}
template <int RW>
__device__ __forceinline__ void activate_regs(float (&v)[RW], int act,
                                              int n) {
  if (act == 0) {
#pragma unroll
    for (int j = 0; j < RW; ++j)
      if (j < n) v[j] = v[j] > 0.f ? v[j] : 0.f;
  } else if (act > 0) {
#pragma unroll
    for (int j = 0; j < RW; ++j)
      if (j < n) v[j] = activate_call(v[j], act);
  }
}

// One f_R layer after the first on a lane's R edges: o[q] <- act(h[q] .
// W + b), from the layer zero-padded in shared memory to RW x OUT (and
// its bias to OUT), so the loops are fixed and fully unrolled: each
// weight row read as broadcast float4 (all lanes one address) feeds 4 R
// FMAs.  Padded inputs meet zero weight rows, so what the activation
// makes of a padded column never reaches an output.
template <int R, int RW, int OUT>
__device__ __forceinline__ void dense_pad(const float (&h)[R][RW],
                                          float (&o)[R][OUT], const float* Wp,
                                          const float* bp, float scale,
                                          bool bf16, bool quant, int act) {
#pragma unroll
  for (int q = 0; q < R; ++q)
#pragma unroll
    for (int j = 0; j < OUT; ++j) o[q][j] = 0.f;
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    float hi[R];
#pragma unroll
    for (int q = 0; q < R; ++q) hi[q] = bf16 ? rbf16(h[q][i]) : h[q][i];
    const float4* row = reinterpret_cast<const float4*>(Wp + i * OUT);
#pragma unroll
    for (int c = 0; c < OUT / 4; ++c) {
      const float4 w = row[c];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        o[q][4 * c] = fmaf(hi[q], w.x, o[q][4 * c]);
        o[q][4 * c + 1] = fmaf(hi[q], w.y, o[q][4 * c + 1]);
        o[q][4 * c + 2] = fmaf(hi[q], w.z, o[q][4 * c + 2]);
        o[q][4 * c + 3] = fmaf(hi[q], w.w, o[q][4 * c + 3]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
#pragma unroll
    for (int j = 0; j < OUT; ++j) {
      float v = o[q][j];
      if (quant) v *= scale;
      o[q][j] = v + bp[j];
    }
    activate_regs<OUT>(o[q], act, OUT);
  }
}

// Weight i of the packed buffer, upcast (and rounded in bf16).
__device__ __forceinline__ float weight_at(const Args& a, int i) {
  float v;
  if (a.w_kind == 0) {
    v = static_cast<const float*>(a.w)[i];
  } else if (a.w_kind == 1) {
    v = __bfloat162float(static_cast<const __nv_bfloat16*>(a.w)[i]);
  } else {
    v = static_cast<float>(static_cast<const int8_t*>(a.w)[i]);
  }
  return a.compute_bf16 ? rbf16(v) : v;
}

// Named barriers of the warp design (0 is __syncthreads): the compute
// warps among themselves, and per f_O buffer a FULL (compute warps arrive,
// the readout warp waits) and an EMPTY one (the other way round).
constexpr int kBarCompute = 1, kBarFull = 2, kBarEmpty = 4;
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Layers e[0..n) of an MLP on `rows` rows at once, by `ct` threads (the
// compute warps, or one warp when ct == 32): a thread per (row, 4 output
// columns) from float4 weight rows, each output summed over its inputs in
// order; the rows ping-pong between buf0 (the input) and buf1, `st` words
// apart, with a barrier of the threads between layers; the last layer's
// outputs go to `out`, `out_st` apart (its first E.out columns only).
__device__ __forceinline__ void rows_mlp(const Args& a, const float* W,
                                         const float* Bv, const Entry* e,
                                         int n, float* buf0, float* buf1,
                                         int rows, int st, float* out,
                                         int out_st, int tid, int ct) {
  const bool bf16 = a.compute_bf16 != 0;
  const bool quant = a.quant != 0;
  for (int l = 0; l < n; ++l) {
    const Entry& E = e[l];
    const bool last = l == n - 1;
    const float* cur = (l & 1) ? buf1 : buf0;
    float* nxt = last ? out : ((l & 1) ? buf0 : buf1);
    const int nst = last ? out_st : st;
    const int chunks = E.outp / 4;
    for (int it = tid; it < rows * chunks; it += ct) {
      const int nd = it / chunks, oc = 4 * (it - nd * chunks);
      const float* in = cur + nd * st;
      const float* col = W + E.w_off + oc;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int i = 0; i < E.in; ++i) {
        const float hi = bf16 ? rbf16(in[i]) : in[i];
        const float4 w = *reinterpret_cast<const float4*>(col + i * E.outp);
        acc.x = fmaf(hi, w.x, acc.x);
        acc.y = fmaf(hi, w.y, acc.y);
        acc.z = fmaf(hi, w.z, acc.z);
        acc.w = fmaf(hi, w.w, acc.w);
      }
      const float* cv = reinterpret_cast<const float*>(&acc);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (oc + j >= E.out) break;
        float v = cv[j];
        if (quant) v *= E.scale;
        v += Bv[E.b_off + oc + j];
        if (!last)
          v = a.act == 0 ? (v > 0.f ? v : 0.f) : activate_call(v, a.act);
        nxt[nd * nst + oc + j] = v;
      }
    }
    if (last) break;
    if (ct == 32)
      __syncwarp();
    else
      bar_sync(kBarCompute, ct);
  }
}

// RW: registers per lane for f_R's activations; the edge output (D_e <=
// kEdgeRegs) and its sender sum in kEdgeRegs more.  MULTI: N_o > 32, so a
// lane walks several sender tiles and keeps its running sum across them.
// The block's last warp is the readout warp: it takes event k's node sum
// and phi_O from one of two f_O buffers while the compute warps run event
// k + 1 into the other.
constexpr int kEdgeRegs = 8;
template <int RW, bool MULTI>
__global__ void __launch_bounds__(warp_threads<RW>())
    jedi_fused_full_warp_kernel(const __grid_constant__ Args a) {
  constexpr int EW = kEdgeRegs;
  constexpr int R = warp_rpl<RW>();
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n_cw = (nt >> 5) - 1, ct = 32 * n_cw;   // compute warps, threads
  const bool bf16 = a.compute_bf16 != 0;
  const bool quant = a.quant != 0;
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
  const Entry& E0 = a.e[0];   // w1r (carries b1)
  const Entry& E1 = a.e[1];   // w1s
  const int h1 = E0.out;
  const int edge_act = a.n_fr > 2 ? a.act : -1;   // f_R's output is linear
  const int n_ev = a.batch > static_cast<int>(blockIdx.x)
      ? (a.batch - 1 - blockIdx.x) / gridDim.x + 1 : 0;

  // the weights (upcast, rounded in bf16) and biases, once per block, and
  // f_R's layers after the first padded to RW x RW (the last RW x EW)
  for (int i = tid; i < a.w_total; i += nt) W[i] = weight_at(a, i);
  for (int i = tid; i < a.b_total; i += nt) Bv[i] = a.b[i];
  const int n_rest = a.n_fr - 2;
  float* FP = smem + a.off_pool;
  float* FB = FP + (n_rest - 1) * RW * RW + RW * EW;   // their biases
  for (int l = 0; l < n_rest; ++l) {
    const Entry& E = a.e[2 + l];
    const int out = l == n_rest - 1 ? EW : RW;
    float* wp = FP + l * RW * RW;
    for (int i = tid; i < RW * out; i += nt) {
      const int r = i / out, c = i - r * out;
      wp[i] = r < E.in && c < E.out ? weight_at(a, E.w_off + r * E.outp + c)
                                    : 0.f;
    }
    for (int c = tid; c < out; c += nt)
      FB[l * RW + c] = c < E.out ? a.b[E.b_off + c] : 0.f;
  }
  __syncthreads();

  if (warp == n_cw) {
    // ---- the readout warp: node sum in node order, phi_O, the logits
    for (int k = 0; k < n_ev; ++k) {
      const int ev = blockIdx.x + k * gridDim.x;
      const float* ob = smem + a.off_obuf + (k & 1) * obuf_words;
      bar_sync(kBarFull + (k & 1), nt);
      for (int o = lane; o < a.d_o; o += 32) {
        float s = 0.f;
#pragma unroll 8
        for (int r = 0; r < n_o; ++r) s += ob[r * a.do_p + o];
        S0[o] = s;
      }
      __syncwarp();
      if (k + 2 < n_ev) bar_arrive(kBarEmpty + (k & 1), nt);
      rows_mlp(a, W, Bv, a.e + a.n_fr + a.n_fo, a.n_phi, S0, S1, 1, 0,
               a.out + static_cast<size_t>(ev) * a.n_targets, a.n_targets,
               lane, 32);
      __syncwarp();    // the buffers are rewritten next event
    }
    return;
  }

  for (int k = 0; k < n_ev; ++k) {
    const int ev = blockIdx.x + k * gridDim.x;
    float* OBUF = smem + a.off_obuf + (k & 1) * obuf_words;
    const size_t xb = static_cast<size_t>(ev) * n_o * p;
    for (int i = tid; i < n_o * p; i += ct) {
      const float v =
          a.x_bf16
              ? __bfloat162float(
                    static_cast<const __nv_bfloat16*>(a.x)[xb + i])
              : static_cast<const float*>(a.x)[xb + i];
      X[i] = bf16 ? rbf16(v) : v;
    }
    bar_sync(kBarCompute, ct);
    // u_r and u_s once per node, one thread per 4 columns of a node
    const int h4 = a.h1_p / 4;
    for (int i = tid; i < 2 * n_o * h4; i += ct) {
      const int half = i / (n_o * h4);
      const int rest = i - half * n_o * h4;
      const int node = rest / h4, col = 4 * (rest - node * h4);
      const Entry& E = half ? E1 : E0;
      const float* xr = X + node * p;
      const float* wc = W + E.w_off + col;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int kk = 0; kk < p; ++kk) {
        const float xv = xr[kk];
        const float4 w = *reinterpret_cast<const float4*>(wc + kk * E.outp);
        acc.x = fmaf(xv, w.x, acc.x);
        acc.y = fmaf(xv, w.y, acc.y);
        acc.z = fmaf(xv, w.z, acc.z);
        acc.w = fmaf(xv, w.w, acc.w);
      }
      if (quant) {
        acc.x *= E.scale;
        acc.y *= E.scale;
        acc.z *= E.scale;
        acc.w *= E.scale;
      }
      float* dst = (half ? US : UR) + node * ust + col;
      dst[0] = acc.x;
      dst[1] = acc.y;
      dst[2] = acc.z;
      dst[3] = acc.w;
    }
    bar_sync(kBarCompute, ct);
    // the readout of event k - 2 has left this f_O buffer
    if (k >= 2) bar_sync(kBarEmpty + (k & 1), nt);

    for (int r0 = warp * R; r0 < n_o; r0 += n_cw * R) {
      // ---- f_R on the edges (r0 + q, s), one sender per lane
      float es[R][EW];
      for (int s0 = 0; s0 < n_o; s0 += 32) {
        const int s = s0 + lane;
        const float* us = US + min(s, n_o - 1) * ust;
        float h[R][RW];
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const float* ur = UR + min(r0 + q, n_o - 1) * ust;
#pragma unroll
          for (int i = 0; i < RW; ++i)
            h[q][i] = i < h1 ? (ur[i] + us[i]) + Bv[E0.b_off + i] : 0.f;
          activate_regs<RW>(h[q], edge_act, h1);
        }
        float e[R][EW];
        if (n_rest == 0) {      // f_R is one layer: its output is D_e wide
#pragma unroll
          for (int q = 0; q < R; ++q)
#pragma unroll
            for (int o = 0; o < EW; ++o) e[q][o] = h[q][o];
        } else {
          for (int l = 0; l < n_rest - 1; ++l) {
            float o[R][RW];
            dense_pad<R, RW, RW>(h, o, FP + l * RW * RW, FB + l * RW,
                                 a.e[2 + l].scale, bf16, quant, a.act);
#pragma unroll
            for (int q = 0; q < R; ++q)
#pragma unroll
              for (int i = 0; i < RW; ++i) h[q][i] = o[q][i];
          }
          dense_pad<R, RW, EW>(h, e, FP + (n_rest - 1) * RW * RW,
                               FB + (n_rest - 1) * RW,
                               a.e[a.n_fr - 1].scale, bf16, quant, -1);
        }
        // the self-edge (and a lane past N_o) adds zero before the sum
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const bool keep = s < n_o && s != r0 + q;
#pragma unroll
          for (int o = 0; o < EW; ++o) {
            const float v = keep && o < a.d_e ? e[q][o] : 0.f;
            es[q][o] = (MULTI && s0 > 0) ? es[q][o] + v : v;
          }
        }
        if (!MULTI) break;
      }
      // the sender sums: a fixed xor tree, the same total on every lane
#pragma unroll
      for (int q = 0; q < R; ++q)
#pragma unroll
        for (int o = 0; o < EW; ++o) {
          if (o < a.d_e) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              es[q][o] += __shfl_xor_sync(0xffffffffu, es[q][o], off);
          }
        }

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
// resident (at most one per event), each walking events.
template <int RW, bool MULTI>
cudaError_t launch_warp(const Args& a, void* stream) {
  if (a.batch == 0) return cudaSuccess;
  auto kernel = jedi_fused_full_warp_kernel<RW, MULTI>;
  const int smem = a.smem_words * static_cast<int>(sizeof(float));
  if (a.threads > warp_threads<RW>() || a.threads % 32 != 0)
    return cudaErrorInvalidValue;
  // the occupancy of one (threads, smem) pair is looked up once
  static int seen_threads = -1, seen_smem = -1, resident = 0;
  if (a.threads != seen_threads || smem != seen_smem) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    int per_sm = 0, dev = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        a.threads, smem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident = per_sm * sms;
    seen_threads = a.threads;
    seen_smem = smem;
  }
  const int grid = a.batch < resident ? a.batch : resident;
  kernel<<<grid, a.threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
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
  return launch_blocks(jedi_fused_full_kernel, a, stream);
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
      a.slot_stride % 2 != 0 ||
      a.d_e > kEdgeRegs)
    return cudaErrorInvalidValue;
  for (int l = 0; l < a.n_fr; ++l)
    if (a.e[l].outp > a.mw) return cudaErrorInvalidValue;
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
