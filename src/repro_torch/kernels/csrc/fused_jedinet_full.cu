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
// fp32 FMA on CUDA cores throughout; wgmma and TMA are later work.
//
// Numerics: with compute_bf16 every operand of a product (activation and
// weight) is rounded to bf16 first, accumulation stays fp32 and biases
// stay fp32.  int8 weights multiply the fp32 accumulator by their
// tensor's scale after the product and before the bias.
//
// Build (no PyTorch headers; bound with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libfused_jedinet_full.so fused_jedinet_full.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxEntries = 24;

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
      off_slot;
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
  F(off_osum) F(off_slot)                                                 \
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

// The threads of one team sit in one warp (team is a power of 2 <= 32).
__device__ __forceinline__ void team_sync(int team, unsigned mask) {
  if (team > 1) __syncwarp(mask);
}

// __grid_constant__: the entries are indexed at run time straight from the
// parameter space, with no per-thread copy of the struct.
__global__ void jedi_fused_full_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float smem[];
  float* W = smem + a.off_w;
  float* Bv = smem + a.off_b;
  float* X = smem + a.off_x;
  float* EBAR = smem + a.off_ebar;
  float* PART = smem + a.off_part;
  float* US = smem + a.off_us;
  float* OBUF = smem + a.off_obuf;
  float* OSUM = smem + a.off_osum;

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int G = a.team;
  const int team = tid / G;
  const int tl = tid % G;
  const int n_teams = nt / G;
  const unsigned mask =
      G >= 32 ? 0xffffffffu : (((1u << G) - 1u) << ((tid & 31) / G * G));
  float* A = smem + a.off_slot + team * a.slot_stride;
  float* Bb = A + a.mw;
  float* U = A + 2 * a.mw;
  const bool bf16 = a.compute_bf16 != 0;
  const bool quant = a.quant != 0;
  const int ev0 = blockIdx.x * a.epb;
  const int n_o = a.n_o, p = a.p;

  // ---- stage: weights (upcast as they land), biases, the block's events
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
  const int xn = a.epb * n_o * p;
  const size_t xbase = static_cast<size_t>(ev0) * n_o * p;
  const size_t xlimit = static_cast<size_t>(a.batch) * n_o * p;
  for (int i = tid; i < xn; i += nt) {
    float v = 0.f;  // events past the batch end are zeros, never stored
    if (xbase + i < xlimit) {
      v = a.x_bf16
              ? __bfloat162float(
                    static_cast<const __nv_bfloat16*>(a.x)[xbase + i])
              : static_cast<const float*>(a.x)[xbase + i];
    }
    X[i] = bf16 ? rbf16(v) : v;
  }
  for (int i = tid; i < a.epb * n_o * a.ks * a.de_p; i += nt) PART[i] = 0.f;
  __syncthreads();

  // ---- edge block: receiver x sender grid, one sender tile at a time
  const Entry& E0 = a.e[0];  // w1r (carries b1)
  const Entry& E1 = a.e[1];  // w1s
  const int edge_act = a.n_fr > 2 ? a.act : -1;  // f_R output is linear
  const int n_items = a.epb * n_o * a.ks;
  const int nch1 = a.h1_p / 4;
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
    for (int it = team; it < n_items; it += n_teams) {
      const int k = it % a.ks;
      const int r = (it / a.ks) % n_o;
      const int e = it / (a.ks * n_o);
      for (int oc = 4 * tl; oc < a.h1_p; oc += 4 * G) {  // U = x_r . W1r
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
        team_sync(G, mask);
        const float* us = US + (e * a.bs + sl) * a.h1_p;
        for (int oc = 4 * tl; oc < a.h1_p; oc += 4 * G) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float t = (U[oc + j] + us[oc + j]) + Bv[E0.b_off + oc + j];
            A[oc + j] = edge_act >= 0 ? activate(t, edge_act) : t;
          }
        }
        float* cur = A;
        float* nxt = Bb;
        for (int l = 2; l < a.n_fr; ++l) {
          team_sync(G, mask);
          const Entry& E = a.e[l];
          const int act = l == a.n_fr - 1 ? -1 : a.act;
          for (int oc = 4 * tl; oc < E.outp; oc += 4 * G) {
            float4 v = dense4(cur, E.in, W + E.w_off, E.outp, oc, bf16);
            epilogue(v, E, Bv, oc, quant, act);
            store4(nxt + oc, v);
          }
          float* t = cur;
          cur = nxt;
          nxt = t;
        }
        // each thread adds the chunks it wrote itself: no sync needed
        for (int oc = 4 * tl; oc < a.de_p; oc += 4 * G) {
#pragma unroll
          for (int j = 0; j < 4; ++j) part[oc + j] += cur[oc + j];
        }
      }
      team_sync(G, mask);  // U and the buffers are rewritten next item
    }
    __syncthreads();  // US is rewritten by the next tile
  }

  // ---- Ebar: the partials summed in split order (fixed order)
  for (int i = tid; i < a.epb * n_o * a.de_p; i += nt) {
    const int d = i % a.de_p;
    const float* pp = PART + (i / a.de_p) * a.ks * a.de_p + d;
    float s = 0.f;
    for (int k = 0; k < a.ks; ++k) s += pp[k * a.de_p];
    EBAR[i] = s;
  }
  __syncthreads();

  // ---- f_O on C = [x || Ebar], one node per team
  for (int it = team; it < a.epb * n_o; it += n_teams) {
    for (int i = tl; i < p + a.d_e; i += G)
      A[i] = i < p ? X[it * p + i] : EBAR[it * a.de_p + i - p];
    float* cur = A;
    float* nxt = Bb;
    for (int l = 0; l < a.n_fo; ++l) {
      team_sync(G, mask);
      const Entry& E = a.e[a.n_fr + l];
      const bool last = l == a.n_fo - 1;
      float* dst = last ? OBUF + it * a.do_p : nxt;
      for (int oc = 4 * tl; oc < E.outp; oc += 4 * G) {
        float4 v = dense4(cur, E.in, W + E.w_off, E.outp, oc, bf16);
        epilogue(v, E, Bv, oc, quant, last ? -1 : a.act);
        store4(dst + oc, v);
      }
      float* t = cur;
      cur = nxt;
      nxt = t;
    }
    team_sync(G, mask);
  }
  __syncthreads();

  // ---- node sum, in node order
  for (int i = tid; i < a.epb * a.do_p; i += nt) {
    const int d = i % a.do_p;
    const float* ob = OBUF + (i / a.do_p) * n_o * a.do_p + d;
    float s = 0.f;
    for (int r = 0; r < n_o; ++r) s += ob[r * a.do_p];
    OSUM[i] = s;
  }
  __syncthreads();

  // ---- phi_O, one event per team; logits straight to device memory
  for (int it = team; it < a.epb; it += n_teams) {
    const int g = ev0 + it;
    for (int i = tl; i < a.d_o; i += G) A[i] = OSUM[it * a.do_p + i];
    float* cur = A;
    float* nxt = Bb;
    for (int l = 0; l < a.n_phi; ++l) {
      team_sync(G, mask);
      const Entry& E = a.e[a.n_fr + a.n_fo + l];
      const bool last = l == a.n_phi - 1;
      for (int oc = 4 * tl; oc < E.outp; oc += 4 * G) {
        float4 v = dense4(cur, E.in, W + E.w_off, E.outp, oc, bf16);
        epilogue(v, E, Bv, oc, quant, last ? -1 : a.act);
        if (!last) {
          store4(nxt + oc, v);
        } else if (g < a.batch) {
          const float* c = reinterpret_cast<const float*>(&v);
          for (int j = 0; j < 4 && oc + j < a.n_targets; ++j)
            a.out[static_cast<size_t>(g) * a.n_targets + oc + j] = c[j];
        }
      }
      float* t = cur;
      cur = nxt;
      nxt = t;
    }
    team_sync(G, mask);
  }
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
  if (n_meta < kHeader) return cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.w = w;
  a.b = b;
  a.out = out;
  int k = 0;
#define JEDI_READ(name) a.name = meta[k++];
  JEDI_HEADER_FIELDS(JEDI_READ)
#undef JEDI_READ
  const int n_entries = a.n_fr + a.n_fo + a.n_phi;
  if (n_entries > kMaxEntries || a.n_fr < 2 || a.n_fo < 1 || a.n_phi < 1 ||
      n_meta != kHeader + 5 * n_entries || a.team < 1 || a.team > 32 ||
      a.threads % a.team != 0 || a.epb < 1 || a.bs < 1 || a.ks < 1)
    return cudaErrorInvalidValue;
  for (int i = 0; i < n_entries; ++i) {
    const int* m = meta + kHeader + 5 * i;
    a.e[i] = Entry{m[0], m[1], m[2], m[3], m[4], scales[i]};
  }
  if (a.batch == 0) return cudaSuccess;
  const size_t smem = static_cast<size_t>(a.smem_words) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      jedi_fused_full_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int grid = (a.batch + a.epb - 1) / a.epb;
  jedi_fused_full_kernel<<<grid, a.threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
