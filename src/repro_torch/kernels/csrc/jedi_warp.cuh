// Device code of the port's register-resident JEDI designs (sm_90a), shared
// by the warp design of B1 (fused_jedinet_full.cu) and B3
// (fused_jedinet_edge.cu) and by B2's rows design (jedi_linear_full.cu).
//
// What they share: a block stages every weight once (upcast, rounded in
// bf16) and walks events, one at a time, as many blocks as the card keeps
// resident (launch_resident); per event, x is staged, u_r = x.W1r and
// u_s = x.W1s are computed once per node (node_halves), and
//   * B1 and B3 run f_R on every edge with one thread per edge, the
//     activations in registers and f_R's layers after the first
//     zero-padded to fixed widths (edge_sums: the self-edge lane adds
//     zero, and the sender sum is a fixed __shfl_xor tree);
//   * B1 and B2 run an MLP on all nodes at once (rows_mlp) and hand f_O's
//     outputs to a readout warp (readout_warp), which takes the node sum
//     in node order and phi_O while the other warps run the next event.
// Sums are taken in fixed orders with no float atomics, so two launches
// are bitwise equal; each kernel's plain version follows the same orders.

#pragma once

#include "jedi_common.cuh"

namespace {

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

// The widest D_e of the edge stage: the edge output and its sender sum
// take kEdgeRegs registers each.
constexpr int kEdgeRegs = 8;

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

// The weights (upcast, rounded in bf16) and biases into W and Bv, once per
// block, by `nt` threads.
__device__ __forceinline__ void stage_weights(const Args& a, float* W,
                                              float* Bv, int tid, int nt) {
  for (int i = tid; i < a.w_total; i += nt) W[i] = weight_at(a, i);
  for (int i = tid; i < a.b_total; i += nt) Bv[i] = a.b[i];
}

// f_R's layers after the first, zero-padded to RW x RW (the last to RW x
// kEdgeRegs) at FP, their biases padded the same way at FB, for
// edge_sums.
template <int RW>
__device__ __forceinline__ void stage_fr_padded(const Args& a, float* FP,
                                                float* FB, int tid, int nt) {
  constexpr int EW = kEdgeRegs;
  const int n_rest = a.n_fr - 2;
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
}

// The biases of stage_fr_padded's layers, after the layers themselves.
template <int RW>
__device__ __forceinline__ float* fr_padded_biases(const Args& a, float* FP) {
  return FP + (a.n_fr - 3) * RW * RW + RW * kEdgeRegs;
}

// x of event `ev` into X (rounded in bf16), by `nt` threads.
__device__ __forceinline__ void load_event(const Args& a, float* X, int ev,
                                           int tid, int nt) {
  const bool bf16 = a.compute_bf16 != 0;
  const size_t xb = static_cast<size_t>(ev) * a.n_o * a.p;
  for (int i = tid; i < a.n_o * a.p; i += nt) {
    const float v =
        a.x_bf16
            ? __bfloat162float(
                  static_cast<const __nv_bfloat16*>(a.x)[xb + i])
            : static_cast<const float*>(a.x)[xb + i];
    X[i] = bf16 ? rbf16(v) : v;
  }
}

// u_r = x.W1r and u_s = x.W1s once per node, in fp32 in every mode (an
// int8 tensor's scale applied, no bias), one thread per 4 columns of a
// node, each column summed over x's features in order; node rows `ust`
// words apart in UR and US.
__device__ __forceinline__ void node_halves(const Args& a, const float* W,
                                            const float* X, float* UR,
                                            float* US, int ust, int tid,
                                            int nt) {
  const bool quant = a.quant != 0;
  const int n_o = a.n_o, p = a.p;
  const Entry& E0 = a.e[0];   // w1r (carries b1)
  const Entry& E1 = a.e[1];   // w1s
  const int h4 = a.h1_p / 4;
  for (int i = tid; i < 2 * n_o * h4; i += nt) {
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
}

// The edge stage of receivers r0 .. r0 + R - 1, one sender per lane (N_o >
// 32, MULTI: each lane walks sender tiles of 32 in ascending order and
// keeps its running sum): f_R on act(u_r + u_s + b1) in registers through
// the padded layers at FP / FB; the self-edge lane (and a lane past N_o)
// adds zero before the sum; the sender sums es[q][0..D_e) by a fixed xor
// tree, the same total on every lane.  UR / US rows `ust` apart.
template <int RW, int R, bool MULTI>
__device__ __forceinline__ void edge_sums(const Args& a, const float* UR,
                                          const float* US, int ust,
                                          const float* Bv, const float* FP,
                                          const float* FB, int r0, int lane,
                                          float (&es)[R][kEdgeRegs]) {
  constexpr int EW = kEdgeRegs;
  const bool bf16 = a.compute_bf16 != 0;
  const bool quant = a.quant != 0;
  const int n_o = a.n_o;
  const Entry& E0 = a.e[0];   // w1r (carries b1)
  const int h1 = E0.out;
  const int n_rest = a.n_fr - 2;
  const int edge_act = a.n_fr > 2 ? a.act : -1;   // f_R's output is linear
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
}

// Named barriers (0 is __syncthreads): the compute warps among
// themselves, and per f_O buffer a FULL (compute warps arrive, the readout
// warp waits) and an EMPTY one (the other way round).
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
// Each layer's entry is read once into registers: read inside the loops
// from the kernel's parameters (a runtime index into them), it slowed
// every layer of B1's and B2's.  The activation between layers is ACT, a
// compile-time code, or for kActRuntime a.act (ReLU inline, the others
// through activate_call, whose call made a kernel as small as B2's
// spill).
constexpr int kActRuntime = -2;
template <int ACT>
__device__ __forceinline__ float rows_act(float v, int act) {
  if (ACT != kActRuntime) return activate(v, ACT);
  return act == 0 ? (v > 0.f ? v : 0.f) : activate_call(v, act);
}

template <int ACT = kActRuntime>
__device__ __forceinline__ void rows_mlp(const Args& a, const float* W,
                                         const float* Bv, const Entry* e,
                                         int n, float* buf0, float* buf1,
                                         int rows, int st, float* out,
                                         int out_st, int tid, int ct) {
  const bool bf16 = a.compute_bf16 != 0;
  const bool quant = a.quant != 0;
  const int act = a.act;
  for (int l = 0; l < n; ++l) {
    const int in_dim = e[l].in, out_dim = e[l].out, outp = e[l].outp;
    const int w_off = e[l].w_off, b_off = e[l].b_off;
    const float scale = e[l].scale;
    const bool last = l == n - 1;
    const float* cur = (l & 1) ? buf1 : buf0;
    float* nxt = last ? out : ((l & 1) ? buf0 : buf1);
    const int nst = last ? out_st : st;
    const int chunks = outp / 4;
    for (int it = tid; it < rows * chunks; it += ct) {
      const int nd = it / chunks, oc = 4 * (it - nd * chunks);
      const float* in = cur + nd * st;
      const float4* col = reinterpret_cast<const float4*>(W + w_off + oc);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int i = 0; i < in_dim; ++i) {
        const float hi = bf16 ? rbf16(in[i]) : in[i];
        const float4 w = col[i * chunks];
        acc.x = fmaf(hi, w.x, acc.x);
        acc.y = fmaf(hi, w.y, acc.y);
        acc.z = fmaf(hi, w.z, acc.z);
        acc.w = fmaf(hi, w.w, acc.w);
      }
      const float* cv = reinterpret_cast<const float*>(&acc);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (oc + j >= out_dim) break;
        float v = cv[j];
        if (quant) v *= scale;
        v += Bv[b_off + oc + j];
        if (!last) v = rows_act<ACT>(v, act);
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

// The readout warp of B1 and B2 (the block's last warp), for the block's
// `n_ev` events: event k's node sum in node order from f_O buffer k & 1
// (OB, two buffers of N_o x do_p words; FULL / EMPTY barriers hand them
// over), then phi_O through its two activation buffers S0 / S1, the
// logits to device memory; ACT as for rows_mlp.
template <int ACT = kActRuntime>
__device__ __forceinline__ void readout_warp(const Args& a, const float* W,
                                             const float* Bv, const float* OB,
                                             float* S0, float* S1, int n_ev,
                                             int lane) {
  const int nt = blockDim.x;
  const int obuf_words = a.n_o * a.do_p;
  for (int k = 0; k < n_ev; ++k) {
    const int ev = blockIdx.x + k * gridDim.x;
    const float* ob = OB + (k & 1) * obuf_words;
    bar_sync(kBarFull + (k & 1), nt);
    for (int o = lane; o < a.d_o; o += 32) {
      float s = 0.f;
#pragma unroll 8
      for (int r = 0; r < a.n_o; ++r) s += ob[r * a.do_p + o];
      S0[o] = s;
    }
    __syncwarp();
    if (k + 2 < n_ev) bar_arrive(kBarEmpty + (k & 1), nt);
    rows_mlp<ACT>(a, W, Bv, a.e + a.n_fr + a.n_fo, a.n_phi, S0, S1, 1, 0,
                  a.out + static_cast<size_t>(ev) * a.n_targets,
                  a.n_targets, lane, 32);
    __syncwarp();    // the buffers are rewritten next event
  }
}

// The events of the batch that block blockIdx.x walks: blockIdx.x,
// blockIdx.x + gridDim.x, ...
__device__ __forceinline__ int block_events(const Args& a) {
  return a.batch > static_cast<int>(blockIdx.x)
             ? (a.batch - 1 - blockIdx.x) / gridDim.x + 1
             : 0;
}

// ---- Host side --------------------------------------------------------------
// Launch `kernel` over the batch with as many blocks as the card keeps
// resident (at most one per event), each walking events.  `cache` belongs
// to this one kernel function (a static of its launcher): the shared-memory
// opt-in and the occupancy are looked up once per (threads, smem) and never
// shared with another kernel.  Returns the cudaError_t of the launch.
struct ResidentCache {
  int threads = -1, smem = -1, resident = 0;
};

template <class Kernel>
cudaError_t launch_resident(Kernel kernel, ResidentCache& cache,
                            const Args& a, void* stream) {
  if (a.batch == 0) return cudaSuccess;
  const int smem = a.smem_words * static_cast<int>(sizeof(float));
  if (a.threads != cache.threads || smem != cache.smem) {
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
    cache.resident = per_sm * sms;
    cache.threads = a.threads;
    cache.smem = smem;
  }
  const int grid = a.batch < cache.resident ? a.batch : cache.resident;
  kernel<<<grid, a.threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

// Every f_R layer of `a` fits the register width `rw` and D_e fits
// kEdgeRegs: what edge_sums needs of its header.
inline bool fr_fits_registers(const Args& a, int rw) {
  if (a.d_e > kEdgeRegs) return false;
  for (int l = 0; l < a.n_fr; ++l)
    if (a.e[l].outp > rw) return false;
  return true;
}

}  // namespace
