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
// Three designs; kernels/fused_jedinet/autotune.py `plan_full` picks one per
// shape and the wrapper calls its entry point:
//
// * "warp" (jedi_fused_full_warp_launch), where f_R's widths fit in a
//   lane's registers with two receivers a lane (at most 32, D_e at most 8;
//   jedi_30p) and no sender tile is pinned:
//   - one thread per edge: a warp's lanes are the senders of its
//     receivers (N_o > 32: each lane walks sender tiles of 32 in
//     ascending order); a lane takes two receivers at once (RPL), so each
//     weight read feeds two edges; a block owns one event at a time, and
//     the grid is as many blocks as the card keeps resident, each walking
//     events (the weights are staged once per block);
//   - the edge's activations live in registers (`RW` of them, a template
//     width of 20 or 32); f_R's layers after the first are staged
//     zero-padded to RW x RW, so each is a fixed, fully unrolled set of
//     independent FMA chains whose weights are read as broadcast float4
//     (all lanes one address): one shared-memory read per 8 FMAs;
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
// * "tile" (jedi_fused_full_tile_launch), where f_R is wider than 32 but
//   fits the warp design's test (jedi_50p's 50): there the warp design
//   fell to one receiver a lane at RW 64, so each edge ran 64 x 64
//   zero-padded layers (62% of its FMAs useful), 15 of each receiver's 64
//   lanes idled, and each broadcast weight read fed 4 FMAs.  Instead:
//   - a block still owns one event at a time, walks events, stages the
//     weights once, computes u_r / u_s per node and keeps the readout
//     warp, f_O (rows_mlp) and phi_O (readout_warp) unchanged;
//   - the event's N_o (N_o - 1) edges, receiver-major over s != r (the
//     self-edge is never computed), are cut into tiles of `bs` edges;
//     f_R's first layer, act(u_r + u_s + b1), fills a feature-major tile
//     in shared memory, a row of `ks` words per feature;
//   - each later layer is a register-tiled outer product (the LL-GNN
//     paper's outer-product, column-major scheme): a thread holds M edges
//     x 4 outputs of fp32 sums and, for each input feature in order,
//     reads its M activations and 4 weights as float4s (M = 12: 12 FMAs a
//     read), the next feature's while this one's FMAs run; outputs are
//     padded only to the packed layout's outp; after a barrier the
//     epilogue (the int8 scale, the bias, the activation) writes them
//     back into the tile;
//   - the last layer (D_e wide) goes to a row per edge, and each
//     receiver's edges are added to its running sum in sender order, in
//     fp32, by one thread per (receiver, output): a fixed order, which
//     the plain version follows;
//   - after the event's last tile the tile's memory holds f_O's buffers.
//   What bounds it: the FMA pipes.  At jedi_50p an event is 2,450 x (50 x
//   52 x 2 + 50 x 8) = 13.7 M FMAs in f_R (96% of them useful); a block
//   is 15 compute warps and the readout warp, one block an SM (229,616 B
//   of shared memory: the weights 87 KB, a 432-edge tile 90 KB).  On the
//   H100 a register-tiled FMA loop issues at ~77% of the FMA peak
//   (register bank clashes), and the 15 warps sit 4, 4, 4, 3 on the SM's
//   schedulers; f_R's middle layers take about two thirds of a launch,
//   the fill, the last layer and f_O (rows_mlp, which is bound by its
//   shared-memory reads) a tenth each (PERF.md section 6).
// * "team" (jedi_fused_full_launch), where f_R is wider (jedi_tracks_128's
//   128) or a sender tile is pinned (`block_s`): the first port's layout in
//   jedi_common.cuh, shared with B3 — one block owns `epb` whole events
//   and loops over sender tiles; a "team" of threads evaluates one grid
//   cell's MLP, 4 outputs per thread and pass; each receiver's senders are
//   split `ks` ways and the partials summed in split order.
//
// All: every weight staged once into shared memory, upcast to fp32 as it
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


// ---- The tile design --------------------------------------------------------
// Shared memory (word offsets from the header): w, b, x, part and us as in
// the warp design; ebar (each receiver's running sum, N_o rows of de_p
// words), obuf and slot as in the warp design, osum (the tile's f_R
// outputs, an edge a row of de_p words) and pool (the tile: f_R's
// activations feature-major, a row of `ks` words per feature, so a
// thread's edges at one feature are contiguous; after the event's last
// tile, f_O's two activation buffers).

constexpr int kTileN = 4;          // outputs a thread takes: one float4
constexpr int kTileLanes = 4;      // lanes side by side along edge groups
constexpr int kTileThreads = 512;  // compute warps and the readout warp

// Edge g of an event, receiver-major over s != r (N_o - 1 senders a
// receiver, ascending): its receiver r and sender s.
__device__ __forceinline__ void tile_edge(int g, int n_s, int& r, int& s) {
  r = g / n_s;
  const int j = g - r * n_s;
  s = j + (j >= r);
}

// f_R's first layer on the tile's n_t edges from edge g0, a thread per
// edge: act((u_r + u_s) + b1) into rows 0 .. h1 of the tile H (rounded in
// bf16: every later use is a product operand).  ACT as for rows_mlp;
// FP32: neither bf16 nor int8, known at compile time.
template <int ACT, bool FP32>
__device__ __forceinline__ void tile_fill(const Args& a, const float* UR,
                                          const float* US, int ust,
                                          const float* Bv, float* H, int g0,
                                          int n_t, int tid, int ct) {
  const Entry& E0 = a.e[0];   // w1r (carries b1)
  const float* b1 = Bv + E0.b_off;
  const int h1 = E0.out, ts = a.ks, n_s = a.n_o - 1, act = a.act;
  const bool bf16 = !FP32 && a.compute_bf16 != 0;
  for (int t = tid; t < n_t; t += ct) {
    int r, s;
    tile_edge(g0 + t, n_s, r, s);
    const float* ur = UR + r * ust;
    const float* us = US + s * ust;
#pragma unroll 5
    for (int k = 0; k < h1; ++k) {
      const float v = rows_act<ACT>((ur[k] + us[k]) + b1[k], act);
      H[k * ts + t] = bf16 ? rbf16(v) : v;
    }
  }
}

// M activations of the tile at row pointer p (M contiguous words) and 4
// weights at q, as float4s, into registers.
template <int M>
__device__ __forceinline__ void tile_operands(const float* p, const float* q,
                                              float (&h)[M],
                                              float (&w)[kTileN]) {
#pragma unroll
  for (int j = 0; j < M / 4; ++j) {
    const float4 v = *reinterpret_cast<const float4*>(p + 4 * j);
    h[4 * j] = v.x;
    h[4 * j + 1] = v.y;
    h[4 * j + 2] = v.z;
    h[4 * j + 3] = v.w;
  }
  const float4 v = *reinterpret_cast<const float4*>(q);
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

// acc += the outer product of M activations and 4 weights, a weight at a
// time (in this order ptxas's registers clash less than activation-major).
template <int M>
__device__ __forceinline__ void tile_fma(float (&acc)[M][kTileN],
                                         const float (&h)[M],
                                         const float (&w)[kTileN]) {
#pragma unroll
  for (int c = 0; c < kTileN; ++c)
#pragma unroll
    for (int m = 0; m < M; ++m) acc[m][c] = fmaf(h[m], w[c], acc[m][c]);
}

// One of f_R's middle layers (entry `e`) on the tile, in place.  Thread
// `tid` takes M edges (edge group eg) x 4 outputs (output group og of G =
// outp / 4): kTileLanes neighbouring lanes take neighbouring edge groups
// and the same output group, the next lanes the next output group, so a
// warp reads a few edge groups' activations and a few output groups'
// weights, and a quarter warp's float4 stores fall on distinct banks.
// For each input feature in order the thread adds the outer product of
// its M activations and 4 weights, so each output is summed over the
// inputs in order from zero, as dense_pad sums it; the next feature's
// operands load while this one's FMAs run (the last one loaded twice,
// so the loop has no branch).  After a barrier, the epilogue (the int8
// scale, the bias, the activation, rounded in bf16) writes the outputs
// back into the tile's rows.  ACT and FP32 as for tile_fill.
template <int M, int ACT, bool FP32>
__device__ __forceinline__ void tile_layer(const Args& a, const float* W,
                                           const float* Bv, const Entry& e,
                                           float* H, int n_t, int tid,
                                           int ct) {
  const int in_dim = e.in, outp = e.outp, w_off = e.w_off, b_off = e.b_off;
  const float scale = e.scale;
  const int ts = a.ks, groups = outp / kTileN;
  const int og = tid / kTileLanes % groups;
  const int eg = tid / (kTileLanes * groups) * kTileLanes + tid % kTileLanes;
  const bool on = tid < a.bs / M * groups && eg * M < n_t;
  float acc[M][kTileN];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int c = 0; c < kTileN; ++c) acc[m][c] = 0.f;
  if (on) {
    const float* hp = H + eg * M;
    const float* wp = W + w_off + og * kTileN;
    const int last = in_dim - 1;
    float ha[M], wa[kTileN], hb[M], wb[kTileN];
    tile_operands<M>(hp, wp, ha, wa);
    int k = 0;
    for (; k < last; k += 2) {
      tile_operands<M>(hp + (k + 1) * ts, wp + (k + 1) * outp, hb, wb);
      tile_fma<M>(acc, ha, wa);
      const int k2 = min(k + 2, last);
      tile_operands<M>(hp + k2 * ts, wp + k2 * outp, ha, wa);
      tile_fma<M>(acc, hb, wb);
    }
    if (k == last) tile_fma<M>(acc, ha, wa);
  }
  bar_sync(kBarCompute, ct);      // every thread has read the tile
  if (on) {
    const bool bf16 = !FP32 && a.compute_bf16 != 0;
    const bool quant = !FP32 && a.quant != 0;
    const int act = a.act;
    float* dst = H + og * kTileN * ts + eg * M;
#pragma unroll
    for (int c = 0; c < kTileN; ++c) {
      const float bias = Bv[b_off + og * kTileN + c];
      float v[M];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        float t = acc[m][c];
        if (quant) t *= scale;
        t = rows_act<ACT>(t + bias, act);
        v[m] = bf16 ? rbf16(t) : t;
      }
#pragma unroll
      for (int j = 0; j < M / 4; ++j)
        *reinterpret_cast<float4*>(dst + c * ts + 4 * j) =
            make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
    }
  }
  bar_sync(kBarCompute, ct);      // the layer's outputs are in the tile
}

// 4 sums of f_R's last layer with the int8 scale and the bias.
__device__ __forceinline__ float4 tile_out(float4 v, const float* bias,
                                           float scale, bool quant) {
  if (quant) {
    v.x *= scale;
    v.y *= scale;
    v.z *= scale;
    v.w *= scale;
  }
  return make_float4(v.x + bias[0], v.y + bias[1], v.z + bias[2],
                     v.w + bias[3]);
}

// s0 += h.x w and s1 += h.y w: 2 edges x 4 outputs of f_R's last layer.
__device__ __forceinline__ void tile_fma2(float4& s0, float4& s1, float2 h,
                                          float4 w) {
  s0.x = fmaf(h.x, w.x, s0.x);
  s0.y = fmaf(h.x, w.y, s0.y);
  s0.z = fmaf(h.x, w.z, s0.z);
  s0.w = fmaf(h.x, w.w, s0.w);
  s1.x = fmaf(h.y, w.x, s1.x);
  s1.y = fmaf(h.y, w.y, s1.y);
  s1.z = fmaf(h.y, w.z, s1.z);
  s1.w = fmaf(h.y, w.w, s1.w);
}

// f_R's last layer (D_e outputs, no activation) on the tile, a thread per
// 2 edges x 4 outputs, each output summed over the inputs in order (the
// next feature's operands loading while this one's FMAs run); into O, an
// edge a row of de_p words.
__device__ __forceinline__ void tile_last(const Args& a, const float* W,
                                          const float* Bv, const float* H,
                                          float* O, int n_t, int tid,
                                          int ct) {
  const Entry& e = a.e[a.n_fr - 1];
  const int in_dim = e.in, outp = e.outp, w_off = e.w_off, b_off = e.b_off;
  const float scale = e.scale;
  const bool quant = a.quant != 0;
  const int ts = a.ks, de_p = a.de_p, groups = outp / kTileN;
  const int pairs = (n_t + 1) / 2, last = in_dim - 1;
  for (int it = tid; it < pairs * groups; it += ct) {
    const int ep = it / groups, og = it - ep * groups;
    const float* hp = H + 2 * ep;
    const float* wp = W + w_off + og * kTileN;
    float4 s0 = make_float4(0.f, 0.f, 0.f, 0.f), s1 = s0;
    float2 ha = *reinterpret_cast<const float2*>(hp);
    float4 wa = *reinterpret_cast<const float4*>(wp);
    int k = 0;
    for (; k < last; k += 2) {
      const float2 hb = *reinterpret_cast<const float2*>(hp + (k + 1) * ts);
      const float4 wb = *reinterpret_cast<const float4*>(wp + (k + 1) * outp);
      tile_fma2(s0, s1, ha, wa);
      const int k2 = min(k + 2, last);
      ha = *reinterpret_cast<const float2*>(hp + k2 * ts);
      wa = *reinterpret_cast<const float4*>(wp + k2 * outp);
      tile_fma2(s0, s1, hb, wb);
    }
    if (k == last) tile_fma2(s0, s1, ha, wa);
    const float* bias = Bv + b_off + og * kTileN;
    *reinterpret_cast<float4*>(O + 2 * ep * de_p + og * kTileN) =
        tile_out(s0, bias, scale, quant);
    *reinterpret_cast<float4*>(O + (2 * ep + 1) * de_p + og * kTileN) =
        tile_out(s1, bias, scale, quant);
  }
}

// Each receiver's edges of this tile (n_t edges from edge g0), added in
// sender order to its running sum in EB (N_o rows of de_p words), which
// its first edge starts from zero: a thread per (receiver, output).
__device__ __forceinline__ void tile_sums(const Args& a, const float* O,
                                          float* EB, int g0, int n_t,
                                          int tid, int ct) {
  const int n_s = a.n_o - 1, d_e = a.d_e, de_p = a.de_p;
  const int r0 = g0 / n_s, n_r = (g0 + n_t - 1) / n_s - r0 + 1;
  for (int it = tid; it < n_r * d_e; it += ct) {
    const int q = it / d_e, o = it - q * d_e, r = r0 + q;
    const int lo = max(g0, r * n_s), hi = min(g0 + n_t, (r + 1) * n_s);
    float s = lo > r * n_s ? EB[r * de_p + o] : 0.f;
#pragma unroll 7
    for (int g = lo; g < hi; ++g) s += O[(g - g0) * de_p + o];
    EB[r * de_p + o] = s;
  }
}

// The compute warps' part of the tile design: for each of the block's
// events, x, u_r / u_s per node, f_R over the event's edges a tile at a
// time summed per receiver, then C = [x_r || Ebar_r] and f_O for every
// node (rows_mlp) into the event's f_O buffer for the readout warp.  ACT
// and FP32 as for tile_fill.
template <int M, int ACT, bool FP32>
__device__ __forceinline__ void tile_events(const Args& a, float* smem,
                                            int n_ev, int tid, int ct) {
  float* W = smem + a.off_w;
  float* Bv = smem + a.off_b;
  float* X = smem + a.off_x;
  float* UR = smem + a.off_part;
  float* US = smem + a.off_us;
  float* EB = smem + a.off_ebar;             // the receivers' sums
  float* O = smem + a.off_osum;              // the tile's f_R outputs
  float* H = smem + a.off_pool;              // the tile
  float* FO = H;                             // then f_O's two buffers
  int fst = (a.p + a.d_e + 3) / 4 * 4;       // f_O's rows: odd, >= every
  for (int l = 0; l < a.n_fo; ++l)           // f_O input and padded output
    fst = max(fst, a.e[a.n_fr + l].outp);
  fst |= 1;
  const int nt = blockDim.x, n_o = a.n_o, p = a.p, ust = a.h1_p | 1;
  const int cw = p + a.d_e, obuf_words = n_o * a.do_p;
  const int n_edges = n_o * (n_o - 1), tile = a.bs;
  for (int k = 0; k < n_ev; ++k) {
    const int ev = blockIdx.x + k * gridDim.x;
    float* OBUF = smem + a.off_obuf + (k & 1) * obuf_words;
    load_event(a, X, ev, tid, ct);
    bar_sync(kBarCompute, ct);
    node_halves(a, W, X, UR, US, ust, tid, ct);
    bar_sync(kBarCompute, ct);

    // ---- f_R over the event's edges, a tile at a time, summed per receiver
    for (int g0 = 0; g0 < n_edges; g0 += tile) {
      const int n_t = min(tile, n_edges - g0);
      tile_fill<ACT, FP32>(a, UR, US, ust, Bv, H, g0, n_t, tid, ct);
      bar_sync(kBarCompute, ct);
      for (int l = 2; l < a.n_fr - 1; ++l)
        tile_layer<M, ACT, FP32>(a, W, Bv, a.e[l], H, n_t, tid, ct);
      tile_last(a, W, Bv, H, O, n_t, tid, ct);
      bar_sync(kBarCompute, ct);
      tile_sums(a, O, EB, g0, n_t, tid, ct);
    }
    bar_sync(kBarCompute, ct);    // every sum is final; the tile is free
    // the readout of event k - 2 has left this f_O buffer
    if (k >= 2) bar_sync(kBarEmpty + (k & 1), nt);

    // ---- C = [x_r || Ebar_r] for every node, then f_O as the warp design
    for (int i = tid; i < n_o * cw; i += ct) {
      const int r = i / cw, c = i - r * cw;
      FO[r * fst + c] = c < p ? X[r * p + c] : EB[r * a.de_p + c - p];
    }
    bar_sync(kBarCompute, ct);
    rows_mlp<ACT>(a, W, Bv, a.e + a.n_fr, a.n_fo, FO, FO + n_o * fst, n_o,
                  fst, OBUF, a.do_p, tid, ct);
    bar_arrive(kBarFull + (k & 1), nt);   // to the readout warp
  }
}

// M: the edges a thread takes in f_R's middle layers.  The block's last
// warp is the readout warp, as in the warp design.  ReLU (jedi_50p's) runs
// inline, and fp32 ReLU with neither bf16 rounding nor int8 scales in
// the tile's epilogues (5% of the launch at jedi_50p); the other
// activations through activate_call.
template <int M>
__global__ void __launch_bounds__(kTileThreads, 1)
    jedi_fused_full_tile_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int ct = nt - 32;                    // compute threads
  float* W = smem + a.off_w;
  float* Bv = smem + a.off_b;
  const int n_ev = block_events(a);

  stage_weights(a, W, Bv, tid, nt);
  __syncthreads();
  if (tid >= ct) {
    // ---- the readout warp: node sum in node order, phi_O, the logits
    float* S0 = smem + a.off_slot;
    float* S1 = S0 + a.slot_stride / 2;
    if (a.act == 0)
      readout_warp<0>(a, W, Bv, smem + a.off_obuf, S0, S1, n_ev, tid & 31);
    else
      readout_warp(a, W, Bv, smem + a.off_obuf, S0, S1, n_ev, tid & 31);
    return;
  }
  if (a.act == 0 && a.compute_bf16 == 0 && a.quant == 0)
    tile_events<M, 0, true>(a, smem, n_ev, tid, ct);
  else if (a.act == 0)
    tile_events<M, 0, false>(a, smem, n_ev, tid, ct);
  else
    tile_events<M, kActRuntime, false>(a, smem, n_ev, tid, ct);
}

// Each layer the tile holds takes at most one output group per compute
// thread, its edge groups come kTileLanes at a time, and f_R's last layer
// is D_e wide padded to de_p.
inline bool tile_fits_threads(const Args& a) {
  int rows = a.e[0].outp;
  for (int l = 2; l < a.n_fr - 1; ++l)
    rows = a.e[l].outp > rows ? a.e[l].outp : rows;
  const int groups = a.bs / a.mw;
  return groups % kTileLanes == 0 &&
         groups * (rows / kTileN) <= a.threads - 32 &&
         a.e[a.n_fr - 1].outp == a.de_p;
}

// Launch the tile design over the batch, as the warp design.
template <int M>
cudaError_t launch_tile(const Args& a, void* stream) {
  static ResidentCache cache;
  return launch_resident(jedi_fused_full_tile_kernel<M>, cache, a, stream);
}

}  // namespace

extern "C" {

int jedi_fused_full_header_len() { return kHeader; }
int jedi_fused_full_warp_header_len() { return kHeader; }
int jedi_fused_full_tile_header_len() { return kHeader; }

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
// width RW (20 or 32: every f_R width must fit, and D_e <= 8),
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
  return cudaErrorInvalidValue;
}

// The tile design, same arguments.  The header's `bs` is the tile's edges
// (a multiple of M), `ks` the words between its feature rows, `mw` the
// edges a thread takes (M = 12), `team` 1, `epb` 1 and `threads` the
// compute warps' plus the readout warp's.
int jedi_fused_full_tile_launch(const void* x, const void* w, const float* b,
                                float* out, const int* meta, int n_meta,
                                const float* scales, void* stream) {
  Args a;
  cudaError_t err = read_args(a, x, w, b, out, meta, n_meta, scales);
  if (err != cudaSuccess) return err;
  if (a.n_fo < 1 || a.n_phi < 1 || a.n_fr < 3 || a.n_o < 2 ||
      a.team != 1 || a.epb != 1 || a.threads < 64 ||
      a.threads > kTileThreads || a.threads % 32 != 0 ||
      a.slot_stride % 2 != 0 || a.mw < 1 || a.bs < a.mw ||
      a.bs % a.mw != 0 || a.ks < a.bs || a.ks % 4 != 0 ||
      !tile_fits_threads(a))
    return cudaErrorInvalidValue;
  if (a.mw == 12) return launch_tile<12>(a, stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
