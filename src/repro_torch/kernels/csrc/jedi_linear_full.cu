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
// What bounds it on this card: arithmetic, on paper.  At jedi_30p an event
// costs ~0.1 M multiply-adds (per-node MLPs) against ~2 KB of x read and
// 20 B of logits written; at a 256-event batch the work is ~50 MFLOP,
// under a microsecond at the card's fp32 rate.  What sets its time is
// latency: the launch, and per event a chain of ~13 small dependent
// layers.  So the design keeps every phase as wide as the event allows
// and the card full.  Two designs; kernels/jedi_linear/autotune.py
// `plan_linear` picks one per shape and the wrapper calls its entry point:
//
// * "rows" (jedi_linear_full_rows_launch), where an event's node rows fit
//   in shared memory beside the weights (jedi_30p, jedi_50p), on the
//   pieces of jedi_warp.cuh: a block walks events (as many blocks as the
//   card keeps resident, one event each at B = 256 on jedi_30p), the
//   weights staged once per block.  Per event, on the compute warps:
//   - x staged; u_r and u_s once per node, a thread per (node, 4
//     columns);
//   - the pool in a fixed order with no float atomics: a warp per column,
//     lane l adding nodes l, l + 32, ... in ascending order, then the
//     lanes by the __shfl_xor tree of B1's sender sum;
//   - the recombination per (node, column), rounded step by step as the
//     plain version rounds it (no FMA contraction: the (N_o - 1)-fold
//     scale would carry a one-ulp difference across a bf16 rounding of
//     the next layer's operand);
//   - f_R's remaining layers, then f_O on C = [x || h], for all nodes at
//     once (rows_mlp: a thread per (node, 4 output columns));
//   then the readout warp takes the node sum in node order and phi_O from
//   one of two f_O buffers while the compute warps run the next event.  No
//   phase runs on a single thread.
// * "team" (jedi_linear_full_launch), where the rows do not fit
//   (jedi_tracks_128: 128 nodes of 128-wide rows beside 123 KB of
//   weights): the first port's layout — one block owns `epb` whole events;
//   the pool's nodes are split `ks` ways, each split summed in ascending
//   order and the partials in split order; one node per team recomputes
//   its u_s, so no (N_o, H1) buffer per event is kept; then the team
//   readout of jedi_common.cuh.
//
// Both: every weight staged once per block in shared memory, upcast to
// fp32 as it lands; in bf16 every product operand is rounded to bf16,
// sums and biases stay fp32; an int8 tensor's scale multiplies the fp32
// sum before the bias (w1r and w1s share w1's).  Fixed summation orders
// and no float atomics: two launches give bitwise equal logits.
//
// Build (no PyTorch headers; bound with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libjedi_linear_full.so jedi_linear_full.cu

#include "jedi_common.cuh"
#include "jedi_warp.cuh"

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

// ---- The rows design --------------------------------------------------------
// Shared memory (word offsets from the header): w, b (the weights and
// biases), x (one event), part (u_r per node, then h), us (u_s per node),
// ebar (C = [x || h] per node), all three a row per node `mw` words apart
// (odd, at least every f_R and f_O width and P + D_e), pool (the pooled
// u_s), obuf (f_O's output per node, two events' worth) and slot (the
// readout warp's two activation buffers of slot_stride / 2 words).  The
// block's last warp is the readout warp.  ACT is the activation's code, a
// template argument so that no phase calls a function.
template <int ACT>
__global__ void __launch_bounds__(512)
    jedi_linear_rows_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n_cw = (nt >> 5) - 1, ct = 32 * n_cw;   // compute warps, threads
  float* W = smem + a.off_w;
  float* Bv = smem + a.off_b;
  float* X = smem + a.off_x;
  float* H0 = smem + a.off_part;
  float* H1 = smem + a.off_us;
  float* C = smem + a.off_ebar;
  float* POOL = smem + a.off_pool;
  float* S0 = smem + a.off_slot;
  float* S1 = S0 + a.slot_stride / 2;
  const int n_o = a.n_o, p = a.p, st = a.mw;
  const int obuf_words = n_o * a.do_p;
  const Entry& E0 = a.e[0];   // w1r (carries b1)
  const int h1 = E0.out;
  const int n_rest = a.n_fr - 2;
  const float nm1 = static_cast<float>(n_o - 1);
  const int n_ev = block_events(a);

  stage_weights(a, W, Bv, tid, nt);
  __syncthreads();

  if (warp == n_cw) {
    // ---- the readout warp: node sum in node order, phi_O, the logits
    readout_warp<ACT>(a, W, Bv, smem + a.off_obuf, S0, S1, n_ev, lane);
    return;
  }

  for (int k = 0; k < n_ev; ++k) {
    const int ev = blockIdx.x + k * gridDim.x;
    load_event(a, X, ev, tid, ct);
    bar_sync(kBarCompute, ct);
    // u_r and u_s once per node, one thread per 4 columns of a node
    node_halves(a, W, X, H0, H1, st, tid, ct);
    bar_sync(kBarCompute, ct);

    // ---- the pool: a warp per column, lane l adds nodes l, l + 32, ...
    // in ascending order, then the lanes by the xor tree
    for (int c = warp; c < h1; c += n_cw) {
      float v = 0.f;
      for (int s0 = 0; s0 < n_o; s0 += 32) {
        const int s = s0 + lane;
        const float u = s < n_o ? H1[s * st + c] : 0.f;
        v = s0 > 0 ? v + u : u;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) POOL[c] = v;
    }
    // C's first P columns: the node's x
    for (int i = tid; i < n_o * p; i += ct) {
      const int node = i / p;
      C[node * st + i - node * p] = X[i];
    }
    bar_sync(kBarCompute, ct);

    // ---- the recombination per (node, column), in place over u_r (or
    // into C where f_R is one layer, whose output is linear), rounded step
    // by step
    float* hdst = n_rest > 0 ? H0 : C + p;
    for (int i = tid; i < n_o * h1; i += ct) {
      const int node = i / h1, c = i - node * h1;
      const float h = __fadd_rn(
          __fmul_rn(nm1, __fadd_rn(H0[node * st + c], Bv[E0.b_off + c])),
          __fsub_rn(POOL[c], H1[node * st + c]));
      hdst[node * st + c] = n_rest > 0 ? activate(h, ACT) : h;
    }
    bar_sync(kBarCompute, ct);

    // ---- f_R's remaining layers for every node, the last into C's
    // columns P .. P + D_e
    if (n_rest > 0) {
      rows_mlp<ACT>(a, W, Bv, a.e + 2, n_rest, H0, H1, n_o, st, C + p, st,
                    tid, ct);
      bar_sync(kBarCompute, ct);
    }
    // the readout of event k - 2 has left this f_O buffer
    if (k >= 2) bar_sync(kBarEmpty + (k & 1), nt);
    // ---- f_O for every node, the last layer into this event's f_O buffer
    rows_mlp<ACT>(a, W, Bv, a.e + a.n_fr, a.n_fo, C, H0, n_o, st,
                  smem + a.off_obuf + (k & 1) * obuf_words, a.do_p, tid, ct);
    bar_arrive(kBarFull + (k & 1), nt);   // to the readout warp
  }
}

// Launch the rows design for the activation ACT; each instantiation keeps
// its own launch cache.
template <int ACT>
cudaError_t launch_rows(const Args& a, void* stream) {
  static ResidentCache cache;
  return launch_resident(jedi_linear_rows_kernel<ACT>, cache, a, stream);
}

}  // namespace

extern "C" {

int jedi_linear_full_header_len() { return kHeader; }
int jedi_linear_full_rows_header_len() { return kHeader; }

// The team design.  Launch on `stream`; `meta` and `scales` as for
// jedi_fused_full_launch (the layout of kernels/jedi_linear/autotune.py:
// `ks` node splits of the pool, PART its partials, POOL the pooled u_s).
// Returns the cudaError_t of the launch (0 = launched).
int jedi_linear_full_launch(const void* x, const void* w, const float* b,
                            float* out, const int* meta, int n_meta,
                            const float* scales, void* stream) {
  Args a;
  cudaError_t err = read_args(a, x, w, b, out, meta, n_meta, scales);
  if (err != cudaSuccess) return err;
  if (a.n_fo < 1 || a.n_phi < 1) return cudaErrorInvalidValue;
  static int opted = 0;
  return launch_blocks(jedi_linear_full_kernel, opted, a, stream);
}

// The rows design, same arguments.  The header's `mw` is the row stride
// (odd, at least P + D_e and every f_R and f_O width), `team` 1, `epb` 1,
// `threads` the compute warps' plus the readout warp's (at most 512) and
// `slot_stride` the readout warp's two buffers.
int jedi_linear_full_rows_launch(const void* x, const void* w,
                                 const float* b, float* out, const int* meta,
                                 int n_meta, const float* scales,
                                 void* stream) {
  Args a;
  cudaError_t err = read_args(a, x, w, b, out, meta, n_meta, scales);
  if (err != cudaSuccess) return err;
  if (a.n_fo < 1 || a.n_phi < 1 || a.team != 1 || a.epb != 1 ||
      a.threads < 64 || a.threads > 512 || a.threads % 32 != 0 ||
      a.mw % 2 != 1 || a.p + a.d_e > a.mw || a.slot_stride % 2 != 0)
    return cudaErrorInvalidValue;
  for (int l = 0; l < a.n_fr + a.n_fo; ++l)
    if (a.e[l].outp > a.mw) return cudaErrorInvalidValue;
  switch (a.act) {   // the activation as a template argument
    case 0: return launch_rows<0>(a, stream);
    case 1: return launch_rows<1>(a, stream);
    case 2: return launch_rows<2>(a, stream);
    case 3: return launch_rows<3>(a, stream);
    case 4: return launch_rows<4>(a, stream);
    case 5: return launch_rows<5>(a, stream);
    case 6: return launch_rows<6>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
