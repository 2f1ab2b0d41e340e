// Device code shared by the port's three JEDI kernels (sm_90a):
//   fused_jedinet_full.cu  (B1, whole JEDI-net, x -> logits)
//   fused_jedinet_edge.cu  (B3, the edge block only, x -> Ebar)
//   jedi_linear_full.cu    (B2, whole JEDI-linear, x -> logits)
// This header holds their launch header and the first port's "team"
// layout, which each keeps for the shapes its newer design does not take;
// the newer designs' pieces are in jedi_warp.cuh.
//
// All three read one launch header (JEDI_HEADER_FIELDS, mirrored by
// HEADER_FIELDS in kernels/fused_jedinet/full_kernel.py), keep every
// weight and intermediate of a block in its dynamic shared memory at
// the word offsets the Python layout models give, and evaluate one
// item's MLP (a grid cell, a node or an event) with a "team" of 1 to 32
// threads of one warp, 4 outputs per thread and pass, from float4 weight
// rows (broadcast reads).  Sums are taken in a fixed order with no float
// atomics, so two launches give bitwise equal results.
//
// Numerics: with compute_bf16 every operand of a product (activation and
// weight) is rounded to bf16 first, sums stay fp32 and biases stay fp32.
// int8 weights are read from device memory as int8 and upcast as they
// land in shared memory; their tensor's scale multiplies the fp32 sum
// after the product and before the bias.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxEntries = 24;

// One weight tensor as the kernels see it: (in, out) padded to (in, outp)
// with zero columns at word w_off of the weight region; its bias at b_off
// of the bias region (-1: none).
struct Entry {
  int in, out, outp, w_off, b_off;
  float scale;
};

struct Args {
  const void* x;
  const void* w;
  const float* b;
  float* out;
  // --- header: in JEDI_HEADER_FIELDS order, mirrored in Python ---
  int x_bf16, w_kind, compute_bf16, act, quant;
  int batch, n_o, p, d_e, d_o, n_targets;
  int n_fr, n_fo, n_phi;
  int epb, bs, ks, team, threads, mw, slot_stride;
  int off_w, off_b, off_x, off_ebar, off_part, off_us, off_obuf, off_osum,
      off_slot, off_pool;
  int w_total, b_total, h1_p, de_p, do_p, smem_words;
  Entry e[kMaxEntries];
};

// HEADER-FIELDS-BEGIN
#define JEDI_HEADER_FIELDS(F)                                              \
  F(x_bf16) F(w_kind) F(compute_bf16) F(act) F(quant)                     \
  F(batch) F(n_o) F(p) F(d_e) F(d_o) F(n_targets)                         \
  F(n_fr) F(n_fo) F(n_phi)                                                \
  F(epb) F(bs) F(ks) F(team) F(threads) F(mw) F(slot_stride)              \
  F(off_w) F(off_b) F(off_x) F(off_ebar) F(off_part) F(off_us) F(off_obuf) \
  F(off_osum) F(off_slot) F(off_pool)                                     \
  F(w_total) F(b_total) F(h1_p) F(de_p) F(do_p) F(smem_words)
// HEADER-FIELDS-END

#define JEDI_COUNT(name) +1
constexpr int kHeader = 0 JEDI_HEADER_FIELDS(JEDI_COUNT);

__device__ __forceinline__ float rbf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Activation codes: the order of repro_torch.nn.core.ACTIVATIONS.
__device__ __forceinline__ float activate(float v, int code) {
  switch (code) {
    case 0:  // relu
      return v > 0.f ? v : 0.f;
    case 1: {  // gelu, tanh approximation (jax.nn.gelu's default)
      const float u = 0.7978845608028654f * (v + 0.044715f * v * v * v);
      return 0.5f * v * (1.f + tanhf(u));
    }
    case 2:  // silu
      return v / (1.f + expf(-v));
    case 3:  // selu
      return v > 0.f ? 1.0507009873554805f * v
                     : 1.0507009873554805f * 1.6732632423543772f * expm1f(v);
    case 4:
      return tanhf(v);
    case 5:  // sigmoid
      return 1.f / (1.f + expf(-v));
    default:  // identity
      return v;
  }
}

// 4 outputs [oc, oc+4) of in[0:nin] @ W, W row-major (nin, outp) in smem.
__device__ __forceinline__ float4 dense4(const float* in, int nin,
                                         const float* W, int outp, int oc,
                                         bool bf16) {
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* col = W + oc;
  for (int i = 0; i < nin; ++i) {
    const float h = bf16 ? rbf16(in[i]) : in[i];
    const float4 w = *reinterpret_cast<const float4*>(col + i * outp);
    acc.x = fmaf(h, w.x, acc.x);
    acc.y = fmaf(h, w.y, acc.y);
    acc.z = fmaf(h, w.z, acc.z);
    acc.w = fmaf(h, w.w, acc.w);
  }
  return acc;
}

// Scale (int8), bias and activation of one output chunk, in that order.
__device__ __forceinline__ void epilogue(float4& v, const Entry& E,
                                         const float* bias, int oc,
                                         bool quant, int act) {
  float* c = reinterpret_cast<float*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float t = c[j];
    if (quant) t *= E.scale;
    if (E.b_off >= 0) t += bias[E.b_off + oc + j];
    if (act >= 0) t = activate(t, act);
    c[j] = t;
  }
}

__device__ __forceinline__ void store4(float* dst, const float4& v) {
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

// A thread's place in its team.  The threads of one team sit in one warp
// (the team size G is a power of 2 <= 32), so a team syncs with
// __syncwarp on its own lanes.  Each team owns a slot of two activation
// buffers A and B of `mw` words (plus B1's U, see below).
struct Team {
  int G, id, tl, n;
  unsigned mask;
  float* A;
  float* B;
};

__device__ __forceinline__ Team make_team(const Args& a, float* smem) {
  Team t;
  const int tid = threadIdx.x;
  t.G = a.team;
  t.id = tid / t.G;
  t.tl = tid % t.G;
  t.n = blockDim.x / t.G;
  t.mask = t.G >= 32 ? 0xffffffffu
                     : (((1u << t.G) - 1u) << ((tid & 31) / t.G * t.G));
  t.A = smem + a.off_slot + t.id * a.slot_stride;
  t.B = t.A + a.mw;
  return t;
}

__device__ __forceinline__ void team_sync(const Team& t) {
  if (t.G > 1) __syncwarp(t.mask);
}

// Stage the weights (upcast as they land), the biases and the block's
// `epb` events, starting at event ev0, into shared memory.  Events past
// the batch end are zeros and are never stored.
__device__ __forceinline__ void stage_inputs(const Args& a, float* smem,
                                             int ev0) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const bool bf16 = a.compute_bf16 != 0;
  float* W = smem + a.off_w;
  float* Bv = smem + a.off_b;
  float* X = smem + a.off_x;
  for (int i = tid; i < a.w_total; i += nt) {
    float v;
    if (a.w_kind == 0) {
      v = static_cast<const float*>(a.w)[i];
    } else if (a.w_kind == 1) {
      v = __bfloat162float(static_cast<const __nv_bfloat16*>(a.w)[i]);
    } else {
      v = static_cast<float>(static_cast<const int8_t*>(a.w)[i]);
    }
    W[i] = bf16 ? rbf16(v) : v;
  }
  for (int i = tid; i < a.b_total; i += nt) Bv[i] = a.b[i];
  const int xn = a.epb * a.n_o * a.p;
  const size_t xbase = static_cast<size_t>(ev0) * a.n_o * a.p;
  const size_t xlimit = static_cast<size_t>(a.batch) * a.n_o * a.p;
  for (int i = tid; i < xn; i += nt) {
    float v = 0.f;
    if (xbase + i < xlimit) {
      v = a.x_bf16
              ? __bfloat162float(
                    static_cast<const __nv_bfloat16*>(a.x)[xbase + i])
              : static_cast<const float*>(a.x)[xbase + i];
    }
    X[i] = bf16 ? rbf16(v) : v;
  }
}

// Layers e[0..n) of one MLP for one item, by its team: activation `act`
// between layers, none after the last.  The input is in `cur`; each layer
// writes the team's other buffer, the last one `dst` when it is given.
// Returns where the result is.  The caller syncs the team before reading
// chunks that other threads of the team wrote.
__device__ __forceinline__ float* team_mlp(const Args& a, const float* smem,
                                           const Team& t, const Entry* e,
                                           int n, float* cur, float* nxt,
                                           float* dst) {
  const float* W = smem + a.off_w;
  const float* Bv = smem + a.off_b;
  const bool bf16 = a.compute_bf16 != 0;
  const bool quant = a.quant != 0;
  for (int l = 0; l < n; ++l) {
    team_sync(t);
    const Entry& E = e[l];
    const bool last = l == n - 1;
    float* out = last && dst != nullptr ? dst : nxt;
    for (int oc = 4 * t.tl; oc < E.outp; oc += 4 * t.G) {
      float4 v = dense4(cur, E.in, W + E.w_off, E.outp, oc, bf16);
      epilogue(v, E, Bv, oc, quant, last ? -1 : a.act);
      store4(out + oc, v);
    }
    nxt = cur;
    cur = out;
  }
  return cur;
}

// ---- The edge block (B1 and B3) -------------------------------------------
// EBAR[e, r] = sum over senders s != r of f_R(x_r || x_s), for the block's
// events, over the receiver x sender grid one sender tile of `bs` at a time.
// f_R's first layer is split: U = x_r . W1r per receiver, US = x_s . W1s per
// sender of the tile.  The self-edge is skipped before the sum (never
// subtracted afterwards).  Each receiver's senders are split `ks` ways; a
// split sums its senders in ascending order into its own partial (PART),
// and the partials are summed in split order.  A team's slot holds A | B |
// U (h1_p words).
__device__ __forceinline__ void edge_block(const Args& a, float* smem,
                                           const Team& t) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const float* W = smem + a.off_w;
  const float* Bv = smem + a.off_b;
  const float* X = smem + a.off_x;
  float* EBAR = smem + a.off_ebar;
  float* PART = smem + a.off_part;
  float* US = smem + a.off_us;
  float* U = t.A + 2 * a.mw;
  const bool bf16 = a.compute_bf16 != 0;
  const bool quant = a.quant != 0;
  const int n_o = a.n_o, p = a.p;
  const Entry& E0 = a.e[0];  // w1r (carries b1)
  const Entry& E1 = a.e[1];  // w1s
  const int edge_act = a.n_fr > 2 ? a.act : -1;  // f_R output is linear
  const int n_items = a.epb * n_o * a.ks;
  const int nch1 = a.h1_p / 4;

  for (int i = tid; i < a.epb * n_o * a.ks * a.de_p; i += nt) PART[i] = 0.f;
  for (int s0 = 0; s0 < n_o; s0 += a.bs) {
    const int len = min(a.bs, n_o - s0);
    for (int i = tid; i < a.epb * len * nch1; i += nt) {
      const int c = i % nch1;
      const int rest = i / nch1;
      const int sl = rest % len;
      const int e = rest / len;
      float4 v = dense4(X + (e * n_o + s0 + sl) * p, p, W + E1.w_off,
                        E1.outp, 4 * c, bf16);
      epilogue(v, E1, Bv, 4 * c, quant, -1);
      store4(US + (e * a.bs + sl) * a.h1_p + 4 * c, v);
    }
    __syncthreads();
    for (int it = t.id; it < n_items; it += t.n) {
      const int k = it % a.ks;
      const int r = (it / a.ks) % n_o;
      const int e = it / (a.ks * n_o);
      for (int oc = 4 * t.tl; oc < a.h1_p; oc += 4 * t.G) {  // U = x_r.W1r
        float4 v = dense4(X + (e * n_o + r) * p, p, W + E0.w_off, E0.outp,
                          oc, bf16);
        if (quant) {
          v.x *= E0.scale;
          v.y *= E0.scale;
          v.z *= E0.scale;
          v.w *= E0.scale;
        }
        store4(U + oc, v);
      }
      float* part = PART + ((e * n_o + r) * a.ks + k) * a.de_p;
      for (int sl = k; sl < len; sl += a.ks) {
        if (s0 + sl == r) continue;  // the self-edge is skipped
        team_sync(t);
        const float* us = US + (e * a.bs + sl) * a.h1_p;
        for (int oc = 4 * t.tl; oc < a.h1_p; oc += 4 * t.G) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float v = (U[oc + j] + us[oc + j]) + Bv[E0.b_off + oc + j];
            t.A[oc + j] = edge_act >= 0 ? activate(v, edge_act) : v;
          }
        }
        const float* cur =
            team_mlp(a, smem, t, a.e + 2, a.n_fr - 2, t.A, t.B, nullptr);
        // each thread adds the chunks it wrote itself: no sync needed
        for (int oc = 4 * t.tl; oc < a.de_p; oc += 4 * t.G) {
#pragma unroll
          for (int j = 0; j < 4; ++j) part[oc + j] += cur[oc + j];
        }
      }
      team_sync(t);  // U and the buffers are rewritten next item
    }
    __syncthreads();  // US is rewritten by the next tile
  }

  // the partials summed in split order (fixed order)
  for (int i = tid; i < a.epb * n_o * a.de_p; i += nt) {
    const int d = i % a.de_p;
    const float* pp = PART + (i / a.de_p) * a.ks * a.de_p + d;
    float s = 0.f;
    for (int k = 0; k < a.ks; ++k) s += pp[k * a.de_p];
    EBAR[i] = s;
  }
  __syncthreads();
}

// ---- The readout (B1 and B2) ----------------------------------------------
// OSUM[e] = sum of f_O's outputs OBUF[e, r] over the nodes r in node order,
// then phi_O on it, one event per team; the logits go straight to device
// memory for the events inside the batch.
__device__ __forceinline__ void readout(const Args& a, float* smem,
                                        const Team& t, int ev0) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const float* OBUF = smem + a.off_obuf;
  float* OSUM = smem + a.off_osum;
  for (int i = tid; i < a.epb * a.do_p; i += nt) {
    const int d = i % a.do_p;
    const float* ob = OBUF + (i / a.do_p) * a.n_o * a.do_p + d;
    float s = 0.f;
    for (int r = 0; r < a.n_o; ++r) s += ob[r * a.do_p];
    OSUM[i] = s;
  }
  __syncthreads();
  for (int it = t.id; it < a.epb; it += t.n) {
    const int g = ev0 + it;
    for (int i = t.tl; i < a.d_o; i += t.G) t.A[i] = OSUM[it * a.do_p + i];
    const float* res =
        team_mlp(a, smem, t, a.e + a.n_fr + a.n_fo, a.n_phi, t.A, t.B,
                 nullptr);
    team_sync(t);
    if (g < a.batch) {
      for (int j = t.tl; j < a.n_targets; j += t.G)
        a.out[static_cast<size_t>(g) * a.n_targets + j] = res[j];
    }
    team_sync(t);  // the buffers are rewritten next item
  }
}

// ---- Host side --------------------------------------------------------------
// Read `meta` (kHeader ints in JEDI_HEADER_FIELDS order, then 5 ints per
// entry: in, out, outp, w_off, b_off) and `scales` (one float per entry)
// into `a`.  Returns cudaErrorInvalidValue on a malformed header.
inline cudaError_t read_args(Args& a, const void* x, const void* w,
                             const float* b, float* out, const int* meta,
                             int n_meta, const float* scales) {
  if (n_meta < kHeader) return cudaErrorInvalidValue;
  a.x = x;
  a.w = w;
  a.b = b;
  a.out = out;
  int k = 0;
#define JEDI_READ(name) a.name = meta[k++];
  JEDI_HEADER_FIELDS(JEDI_READ)
#undef JEDI_READ
  const int n_entries = a.n_fr + a.n_fo + a.n_phi;
  if (n_entries > kMaxEntries || a.n_fr < 2 ||
      n_meta != kHeader + 5 * n_entries || a.team < 1 || a.team > 32 ||
      (a.team & (a.team - 1)) != 0 || a.threads % a.team != 0 ||
      a.epb < 1 || a.bs < 1 || a.ks < 1)
    return cudaErrorInvalidValue;
  for (int i = 0; i < n_entries; ++i) {
    const int* m = meta + kHeader + 5 * i;
    a.e[i] = Entry{m[0], m[1], m[2], m[3], m[4], scales[i]};
  }
  return cudaSuccess;
}

// Launch `kernel` over the batch (one block per `epb` events) on `stream`.
// `opted` is the kernel's own record (a static of its launcher, never
// shared with another kernel) of the dynamic shared memory it has opted in
// to: the opt-in is asked for only when a launch needs more.  Returns the
// cudaError_t of the launch (0 = launched).
template <class Kernel>
cudaError_t launch_blocks(Kernel kernel, int& opted, const Args& a,
                          void* stream) {
  if (a.batch == 0) return cudaSuccess;
  const int smem = a.smem_words * static_cast<int>(sizeof(float));
  if (smem > opted) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted = smem;
  }
  const int grid = (a.batch + a.epb - 1) / a.epb;
  kernel<<<grid, a.threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // namespace
