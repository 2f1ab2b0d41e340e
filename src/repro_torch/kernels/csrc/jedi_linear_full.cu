// Whole-network fused JEDI-linear forward (x -> logits) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_linear_forward_kernel` in
// src/repro/kernels/jedi_linear/linear_kernel.py (pallas_call in
// `jedi_linear_kernel_call`), which serves `jedi_linear_full` and
// `int8_jedi_linear_full`.  Same function: f_R's first layer is linear and
// commutes with the sender sum, so per event
//
//   u_r = x.W1r,  u_s = x.W1s              (per node)
//   pooled = sum over nodes j of u_s[j]     (one pool)
//   h_i = (N_o - 1)(u_r[i] + b1) + (pooled - u_s[i])
//
// then the remaining f_R layers per node, C = [x || h], f_O, the node sum
// and phi_O.  u_r, u_s, pooled and h stay fp32 in every mode: the
// (N_o - 1)-fold scale would amplify bf16 rounding.
//
// What bounds it on this card: arithmetic.  At jedi_30p an event costs
// ~0.1 M multiply-adds (per-node MLPs) against ~2 KB of x read and 20 B of
// logits written, far above the H100's ~20 fp32 FLOP/B ridge; at a 256-event
// batch the work is ~50 MFLOP, under a microsecond at the card's fp32 rate,
// so the launch and one block's serial chain of small layers set its time.
// The design, on the staging, team MLPs and readout of jedi_common.cuh:
//   * one block owns `epb` whole events (the batch's ragged last block is
//     masked, not padded); all weights are staged once per block in shared
//     memory, upcast to fp32 as they land;
//   * the pool: each event's nodes are split `ks` ways, each split sums
//     its nodes' u_s in ascending order into a partial (PART), and the
//     partials are summed in split order: no float atomics, so two launches
//     are bitwise equal;
//   * one node per team: u_r and u_s of the node (u_s recomputed, the same
//     arithmetic as in the pool, so no (N_o, H1) buffer per event is kept
//     and jedi_tracks_128 fits), the recombination, f_R's remaining layers,
//     C = [x || h] and f_O into OBUF; then the node sum and phi_O.
//
// Build (no PyTorch headers; bound with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libjedi_linear_full.so jedi_linear_full.cu

#include "jedi_common.cuh"

namespace {

// 4 outputs [oc, oc+4) of the first-layer projection x . E (E = w1r or
// w1s), its int8 scale applied; the bias is added by the caller.
__device__ __forceinline__ float4 project4(const float* x, int p,
                                           const float* W, const Entry& E,
                                           int oc, bool bf16, bool quant) {
  float4 v = dense4(x, p, W + E.w_off, E.outp, oc, bf16);
  if (quant) {
    v.x *= E.scale;
    v.y *= E.scale;
    v.z *= E.scale;
    v.w *= E.scale;
  }
  return v;
}

__global__ void jedi_linear_full_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float smem[];
  const Team t = make_team(a, smem);
  const int ev0 = blockIdx.x * a.epb;
  stage_inputs(a, smem, ev0);
  __syncthreads();

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const float* W = smem + a.off_w;
  const float* Bv = smem + a.off_b;
  const float* X = smem + a.off_x;
  float* PART = smem + a.off_part;
  float* POOL = smem + a.off_pool;
  float* OBUF = smem + a.off_obuf;
  const bool bf16 = a.compute_bf16 != 0;
  const bool quant = a.quant != 0;
  const int n_o = a.n_o, p = a.p;
  const Entry& E0 = a.e[0];  // w1r (carries b1)
  const Entry& E1 = a.e[1];  // w1s
  const int nch1 = a.h1_p / 4;

  // ---- pool: partial sums of u_s over each split's nodes, in node order
  for (int i = tid; i < a.epb * a.ks * nch1; i += nt) {
    const int c = i % nch1;
    const int k = (i / nch1) % a.ks;
    const int e = i / (nch1 * a.ks);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = k; j < n_o; j += a.ks) {
      const float4 v =
          project4(X + (e * n_o + j) * p, p, W, E1, 4 * c, bf16, quant);
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    store4(PART + (e * a.ks + k) * a.h1_p + 4 * c, acc);
  }
  __syncthreads();
  // ... and the partials summed in split order
  for (int i = tid; i < a.epb * a.h1_p; i += nt) {
    const int d = i % a.h1_p;
    const float* pp = PART + (i / a.h1_p) * a.ks * a.h1_p + d;
    float s = 0.f;
    for (int k = 0; k < a.ks; ++k) s += pp[k * a.h1_p];
    POOL[i] = s;
  }
  __syncthreads();

  // ---- per node, one node per team: recombination, f_R, C, f_O
  const float nm1 = static_cast<float>(n_o - 1);
  const int first_act = a.n_fr > 2 ? a.act : -1;  // f_R output is linear
  for (int it = t.id; it < a.epb * n_o; it += t.n) {
    const float* xi = X + it * p;
    const float* pool = POOL + (it / n_o) * a.h1_p;
    for (int oc = 4 * t.tl; oc < a.h1_p; oc += 4 * t.G) {
      const float4 ur = project4(xi, p, W, E0, oc, bf16, quant);
      const float4 us = project4(xi, p, W, E1, oc, bf16, quant);
      const float* r = reinterpret_cast<const float*>(&ur);
      const float* s = reinterpret_cast<const float*>(&us);
      // rounded step by step as the plain version rounds it (no FMA
      // contraction): the (N_o - 1)-fold scale would carry a one-ulp
      // difference across a bf16 rounding of the next layer's operand
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float h =
            __fadd_rn(__fmul_rn(nm1, __fadd_rn(r[j], Bv[E0.b_off + oc + j])),
                      __fsub_rn(pool[oc + j], s[j]));
        t.A[oc + j] = first_act >= 0 ? activate(h, first_act) : h;
      }
    }
    float* cur = team_mlp(a, smem, t, a.e + 2, a.n_fr - 2, t.A, t.B,
                          nullptr);
    team_sync(t);
    float* c = cur == t.A ? t.B : t.A;  // C = [x_i || h_i]
    for (int i = t.tl; i < p + a.d_e; i += t.G)
      c[i] = i < p ? xi[i] : cur[i - p];
    team_mlp(a, smem, t, a.e + a.n_fr, a.n_fo, c, cur, OBUF + it * a.do_p);
    team_sync(t);  // the buffers are rewritten next item
  }
  __syncthreads();

  // ---- node sum, phi_O, logits
  readout(a, smem, t, ev0);
}

}  // namespace

extern "C" {

int jedi_linear_full_header_len() { return kHeader; }

// Launch on `stream`; `meta` and `scales` as for jedi_fused_full_launch
// (the layout of kernels/jedi_linear/autotune.py: `ks` node splits of the
// pool, PART its partials, POOL the pooled u_s).  Returns the cudaError_t
// of the launch (0 = launched).
int jedi_linear_full_launch(const void* x, const void* w, const float* b,
                            float* out, const int* meta, int n_meta,
                            const float* scales, void* stream) {
  Args a;
  cudaError_t err = read_args(a, x, w, b, out, meta, n_meta, scales);
  if (err != cudaSuccess) return err;
  if (a.n_fo < 1 || a.n_phi < 1) return cudaErrorInvalidValue;
  return launch_blocks(jedi_linear_full_kernel, a, stream);
}

}  // extern "C"
