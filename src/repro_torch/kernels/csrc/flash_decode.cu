// Flash decode: one-token GQA attention over a KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_decode_kernel` in
// src/repro/kernels/flash_decode/kernel.py (pallas_call in
// `flash_decode_kernel_call`), reached through `ops.flash_decode`:
//
//   for each (b, kv-head h) and each of its G query rows g:
//     s[c]   = q[b, h, g] . k[b, c, h]           (q pre-scaled by 1/sqrt(D))
//     ok[c]  = kv_pos[b, c] >= 0 && kv_pos[b, c] <= q_pos[b]
//              && (no window || q_pos[b] - kv_pos[b, c] < window)
//     s[c]   = ok[c] ? s[c] : -1e30
//     out    = sum_c softmax(s)[c] v[b, c, h]
//
// q is (B, Hkv, G, D) fp32; k and v are (B, S, Hkv, D) fp32 or bf16; q_pos
// is (B,) and kv_pos (B, S) int32; out is (B, Hkv, G, D) fp32.  The mask is
// an integer compare, as in the reference.  Masked scores are the finite
// -1e30 of the reference, never -inf: masked keys still count, so a row
// with no valid key gives the mean of v over its S keys (every p = 1), and
// keys masked before the first valid one are wiped when it arrives
// (corr = exp(-1e30 - m) = 0).  l is floored at 1e-30 before the divide.
//
// What bounds it on this card: bytes.  Each cache value is read once and
// used in 2 multiply-adds per query row (G of them), so at G = 4 and bf16
// a byte carries ~4 operations, far below the H100's ~20 fp32 FLOP/B
// ridge.  At h2o-danube-1.8b's decode_32k shape (B=128, S=32768, Hkv=8,
// D=80, bf16) the cache is 10.74 GB: 3.2 ms at 3.35 TB/s.  The design keeps
// enough bytes in flight to hold HBM busy, at any batch:
//   * Split-sequence decoding.  Each (b, kv-head) is cut into P partitions
//     of `part_len` keys; P is chosen (kernels/flash_decode/kernel.py
//     `plan`) so the grid holds several waves of the blocks the card keeps
//     resident, B = 1 included.  With P > 1 each warp writes its partition's
//     (m, l, acc) to fp32 scratch and a second small kernel, launched by the
//     same C call, combines the partitions in partition order, weighing
//     partition i by exp(m_i - max m): a partition all masked before a
//     valid key is wiped, a row with no valid key gives the mean of v.  No
//     float atomics: launches are bitwise equal.
//   * A ring of 3 stages in dynamic shared memory, in the cache's own type,
//     filled by cp.async (16 bytes a lane, neighbouring lanes on
//     neighbouring words of a row), so two tiles stream in while one is
//     computed.  Rows sit an odd number of 16-byte words apart, so per-lane
//     row reads and ldmatrix are free of bank conflicts.  Above 48 KB of
//     shared memory the launcher opts in.
//   * fp32 math as the reference: bf16 is upcast exactly, p is never
//     rounded on the CUDA-core path and carried as bf16 hi + lo on the
//     tensor-core path.
// Two paths:
//   * Tensor cores (flash_decode_mma_kernel): a bf16 cache, G = 4 rows a
//     kv-head, D of 32, 64, 80 or 128 (danube's decode).  A block of NH
//     warps owns NH neighbouring kv-heads of one (b, partition), one warp a
//     head, and the block walks 16-key tiles in lockstep: each stage holds
//     the 16 keys of all NH heads, which lie together in the cache, so the
//     block streams whole contiguous cache rows.  Scores S^T = K . Q^T and
//     values O^T += V^T . P^T run on mma.sync m16n8k16 (bf16 operands,
//     fp32 sums): K and V enter exactly; q and p are split into bf16 hi +
//     lo (x = hi + lo to 2^-17 of x), the mma's 8 columns holding [4 rows
//     hi | 4 rows lo], the lanes adding the halves.
//   * CUDA cores (flash_decode_kernel), every other case (fp32 caches, any
//     G, D up to 32 16-byte words a row: bf16 D <= 256, fp32 D <= 128):
//     one block of one warp per (b, kv-head, group of GB <= 8 rows,
//     partition), 32-key tiles; the score loop gives each lane one key and
//     reads q words that all lanes read at one address (broadcast), the
//     p.v loop gives each lane one 16-byte word of a V row with acc for the
//     word's columns x GB rows in registers.  Rows that are not whole
//     16-byte words, or a cache not 16-byte aligned, are staged by plain
//     loads with the row's tail zeroed: slower, the same arithmetic.
// The online-softmax carry (m per row, l per lane) lives in registers; the
// sums over lanes and key groups are fixed shuffle orders.  Any S (each
// partition's last tile is masked by length: its missing keys contribute
// nothing), any G.
//
// Build (no PyTorch headers; bound with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libflash_decode.so flash_decode.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kTile = 32;                  // keys per stage: one per lane
constexpr int kStages = 3;                 // the ring's depth
constexpr int kMaxWords = 32;              // 16-byte words per cache row
constexpr float kNegInf = -1e30f;          // the reference's NEG_INF
constexpr size_t kMaxSmem = 227 * 1024;    // the opt-in dynamic limit
constexpr int kCombineThreads = 256;
constexpr int kMmaTile = 16;               // keys per stage, tensor cores
constexpr int kMaxHeads = 8;               // kv-heads per block, ditto

struct Args {
  const float* q;
  const void* k;
  const void* v;
  const int* q_pos;
  const int* kv_pos;
  float* out;
  float* part;     // (B, Hkv, G, P, D + 2): m, l, acc; unused when P == 1
  int batch, s_len, hkv, g, d;
  int window;      // <= 0: no window
  int part_len;    // keys per partition
  int n_parts;     // P
  int n_groups;    // G / GB
  int words;       // W: 16-byte words per row
  int kst;         // row stride in shared memory (words, odd)
  int heads;       // NH: kv-heads per block (tensor-core path), else 1
  int vec;         // 1: rows are whole 16-byte words, 16-byte aligned
};

// ---- cp.async -------------------------------------------------------------
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One 16-byte word of a row as fp32: 8 bf16 (upcast exactly) or 4 fp32.
template <typename T>
struct Word;
template <>
struct Word<__nv_bfloat16> {
  static constexpr int kElems = 8;
  __device__ static __forceinline__ void unpack(const uint4& w, float* f) {
    const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
};
template <>
struct Word<float> {
  static constexpr int kElems = 4;
  __device__ static __forceinline__ void unpack(const uint4& w, float* f) {
    f[0] = __uint_as_float(w.x);
    f[1] = __uint_as_float(w.y);
    f[2] = __uint_as_float(w.z);
    f[3] = __uint_as_float(w.w);
  }
};

// Bytes of one ring stage of the CUDA-core path: K and V (32 rows each,
// kst words apart; `words` of them hold the row), kv_pos.
__host__ __device__ __forceinline__ size_t stage_bytes(int kst) {
  return 16 * static_cast<size_t>(kTile) * 2 * kst + 4 * kTile;
}

// Start the copy of `n` rows of one kv-head into ks / vs (rows kst words
// apart) by cp.async, 16 bytes a lane with neighbouring lanes on
// neighbouring words: lane l's first (row, word) is (cw, cj), each step of
// 32 words a row is `words` long.  Rows of the tile past `n` (up to
// `rows`) have V zeroed: their p is 0, and 0 x stale bits could be NaN.
// Without whole aligned 16-byte words (a.vec == 0) the rows are staged by
// plain loads with their tail past D zeroed.
template <typename T>
__device__ __forceinline__ void load_rows(const Args& a, uint4* ks,
                                          uint4* vs, const T* kg,
                                          const T* vg, int n, int rows,
                                          int cw, int cj) {
  const int lane = threadIdx.x & 31;
  const int W = a.words;
  for (int i = n * a.kst + lane; i < rows * a.kst; i += 32)
    vs[i] = make_uint4(0u, 0u, 0u, 0u);
  const size_t row_step = static_cast<size_t>(a.hkv) * a.d;   // elements
  constexpr int E = Word<T>::kElems;
  if (a.vec) {
    const int step_c = 32 / W, step_j = 32 - step_c * W;
    for (int c = cw, j = cj; c < n;) {
      const size_t off = c * row_step + static_cast<size_t>(j) * E;
      cp_async16(ks + c * a.kst + j, kg + off);
      cp_async16(vs + c * a.kst + j, vg + off);
      c += step_c;
      j += step_j;
      if (j >= W) {
        j -= W;
        ++c;
      }
    }
  } else {
    const int re = W * E;
    T* kd = reinterpret_cast<T*>(ks);
    T* vd = reinterpret_cast<T*>(vs);
    const T zero = T(0.f);
    for (int i = lane; i < n * re; i += 32) {
      const int c = i / re, e = i - c * re;
      const bool in = e < a.d;
      const size_t off = c * row_step + e;
      kd[c * a.kst * E + e] = in ? kg[off] : zero;
      vd[c * a.kst * E + e] = in ? vg[off] : zero;
    }
  }
}

// The kv_pos of `n` keys from `src` into `kp`, one lane each.
__device__ __forceinline__ void load_kv_pos(const Args& a, int* kp,
                                            const int* src, int n) {
  const int lane = threadIdx.x & 31;
  if (lane >= n) return;
  if (a.vec)
    cp_async4(kp + lane, src + lane);
  else
    kp[lane] = src[lane];
}

// Start the copy of keys [c0, c0 + n) of (b, h) into one 32-key stage.
template <typename T>
__device__ __forceinline__ void load_tile(const Args& a, unsigned char* st,
                                          int b, int h, int c0, int n,
                                          int cw, int cj) {
  uint4* ks = reinterpret_cast<uint4*>(st);
  uint4* vs = ks + kTile * a.kst;
  const size_t row0 =
      ((static_cast<size_t>(b) * a.s_len + c0) * a.hkv + h) * a.d;
  load_rows<T>(a, ks, vs, static_cast<const T*>(a.k) + row0,
               static_cast<const T*>(a.v) + row0, n, kTile, cw, cj);
  load_kv_pos(a, reinterpret_cast<int*>(vs + kTile * a.kst),
              a.kv_pos + static_cast<size_t>(b) * a.s_len + c0, n);
}

template <typename T, int GB>
__global__ void __launch_bounds__(32) flash_decode_kernel(
    const __grid_constant__ Args a) {
  constexpr int E = Word<T>::kElems;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const int W = a.words;
  int idx = blockIdx.x;      // (b, p, h, group), the group fastest
  const int gg = idx % a.n_groups;
  idx /= a.n_groups;
  const int h = idx % a.hkv;
  idx /= a.hkv;
  const int p = idx % a.n_parts;
  const int b = idx / a.n_parts;

  const size_t sb = stage_bytes(a.kst);
  unsigned char* ring = smem;
  float* qs = reinterpret_cast<float*>(smem + kStages * sb);  // GB x W*E
  float* ps = qs + GB * W * E;                                // 32 x GB
  const int qw = W * E;

  // this block's GB query rows, zero past D
  const size_t row = (static_cast<size_t>(b) * a.hkv + h) * a.g + gg * GB;
  const float* qg = a.q + row * a.d;
  for (int i = lane; i < GB * qw; i += 32) {
    const int g = i / qw, e = i - g * qw;
    qs[i] = e < a.d ? qg[g * a.d + e] : 0.f;
  }
  const int qp = a.q_pos[b];
  const int key_lo = p * a.part_len;
  const int key_hi = min(a.s_len, key_lo + a.part_len);
  const int n_tiles = (key_hi - key_lo + kTile - 1) / kTile;
  const int cw = lane / W, cj = lane - cw * W;   // copy and p.v mapping

  // prologue: the first kStages - 1 tiles in flight
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) {
      const int c0 = key_lo + s * kTile;
      load_tile<T>(a, ring + s * sb, b, h, c0, min(kTile, key_hi - c0), cw,
                   cj);
    }
    cp_commit();
  }

  float m[GB], l[GB], acc[GB][E];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }
  const int kpi = 32 / W;              // keys per pass of the p.v loop
  const bool pv_lane = cw < kpi;

  for (int t = 0; t < n_tiles; ++t) {
    cp_wait<kStages - 2>();            // this lane's copies of tile t
    __syncwarp();                      // ... and every lane's; slot t-1 free
    {
      const int tn = t + kStages - 1;
      if (tn < n_tiles) {
        const int c0 = key_lo + tn * kTile;
        load_tile<T>(a, ring + (tn % kStages) * sb, b, h, c0,
                     min(kTile, key_hi - c0), cw, cj);
      }
      cp_commit();
    }
    const unsigned char* st = ring + (t % kStages) * sb;
    const uint4* ks = reinterpret_cast<const uint4*>(st);
    const uint4* vs = ks + kTile * a.kst;
    const int* kp = reinterpret_cast<const int*>(vs + kTile * a.kst);
    const int n = min(kTile, key_hi - (key_lo + t * kTile));

    // scores: one key per lane, q words read by every lane at one address
    float s[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) s[g] = 0.f;
    const uint4* kr = ks + lane * a.kst;
#pragma unroll 2
    for (int w = 0; w < W; ++w) {
      float kf[E];
      Word<T>::unpack(kr[w], kf);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        const float4* qv = reinterpret_cast<const float4*>(qs + g * qw + w * E);
#pragma unroll
        for (int e4 = 0; e4 < E / 4; ++e4) {
          const float4 x = qv[e4];
          s[g] = fmaf(x.x, kf[4 * e4], s[g]);
          s[g] = fmaf(x.y, kf[4 * e4 + 1], s[g]);
          s[g] = fmaf(x.z, kf[4 * e4 + 2], s[g]);
          s[g] = fmaf(x.w, kf[4 * e4 + 3], s[g]);
        }
      }
    }
    const bool present = lane < n;     // past the tile's end: no key
    const int kv = kp[lane];
    bool ok = present && kv >= 0 && kv <= qp;
    if (a.window > 0) ok = ok && (qp - kv) < a.window;

    // the online-softmax carry: masked keys count, absent ones do not
    float corr[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float sg = ok ? s[g] : kNegInf;
      float mx = sg;       // an absent key's -1e30 never exceeds the carry
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[g], mx);
      corr[g] = expf(m[g] - m_new);
      const float pg = present ? expf(sg - m_new) : 0.f;
      l[g] = l[g] * corr[g] + pg;
      ps[lane * GB + g] = pg;
      m[g] = m_new;
    }
#pragma unroll
    for (int g = 0; g < GB; ++g)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= corr[g];
    __syncwarp();                      // p of every key written

    // acc += p . v: one 16-byte word of a V row per lane, kpi keys a pass
    if (pv_lane) {
      for (int c = cw; c < n; c += kpi) {
        float vf[E];
        Word<T>::unpack(vs[c * a.kst + cj], vf);
        float pc[GB];
#pragma unroll
        for (int g = 0; g < GB; ++g) pc[g] = ps[c * GB + g];
#pragma unroll
        for (int g = 0; g < GB; ++g)
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] = fmaf(pc[g], vf[e], acc[g][e]);
      }
    }
  }
  cp_wait<0>();

  // l: the lanes' partial sums, a fixed xor tree; acc: the key groups of
  // the p.v loop summed in group order onto group 0 (lanes 0..W-1)
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
  for (int k = 1; k < kpi; ++k) {
#pragma unroll
    for (int g = 0; g < GB; ++g)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float o = __shfl_sync(0xffffffffu, acc[g][e], cj + k * W);
        if (cw == 0) acc[g][e] += o;
      }
  }
  if (cw != 0) return;
  const int dd = a.d;
  if (a.n_parts == 1) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float den = fmaxf(l[g], 1e-30f);
      float* o = a.out + (row + g) * dd;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int d = cj * E + e;
        if (d < dd) o[d] = acc[g][e] / den;
      }
    }
  } else {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float* pr = a.part + ((row + g) * a.n_parts + p) * (dd + 2);
      if (lane == 0) {
        pr[0] = m[g];
        pr[1] = l[g];
      }
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int d = cj * E + e;
        if (d < dd) pr[2 + d] = acc[g][e];
      }
    }
  }
}

// ---- The tensor-core path: bf16 cache, G = 4, D = 16 * DK ------------------
// A block of NH warps, warp w on kv-head h0 + w of one (b, partition);
// stages of 16 keys x NH heads, one __syncthreads per stage.  Scores: S^T
// (16 keys x 8) = K (keys x D, ldmatrix) . Q^T (q fragments in registers
// for the whole partition).  Values: O^T (D x 8) += V^T (ldmatrix.trans)
// . P^T (p from shared memory as (4, 16) fp32).

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}
__device__ __forceinline__ float bf16_hi(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
// (x0, x1) as a bf16 pair: their hi parts (part 0) or lo parts (part 1)
__device__ __forceinline__ unsigned split_pair(float x0, float x1, int part) {
  const float h0 = bf16_hi(x0), h1 = bf16_hi(x1);
  return part ? pack_bf16x2(x0 - h0, x1 - h1) : pack_bf16x2(h0, h1);
}
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Bytes of one tensor-core stage: K and V of NH heads (16 rows each, kst
// words apart), kv_pos.
__host__ __device__ __forceinline__ size_t mma_stage_bytes(int kst,
                                                           int heads) {
  return 16 * static_cast<size_t>(kMmaTile) * kst * 2 * heads +
         4 * kMmaTile;
}

template <int DK>
__global__ void __launch_bounds__(32 * kMaxHeads) flash_decode_mma_kernel(
    const __grid_constant__ Args a) {
  constexpr int GB = 4, D = 16 * DK, TK = kMmaTile;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, t = lane & 3;
  const int NH = a.heads;
  int idx = blockIdx.x;      // (b, p, head block, group), the group fastest
  const int gg = idx % a.n_groups;
  idx /= a.n_groups;
  const int hb = idx % (a.hkv / NH);
  idx /= a.hkv / NH;
  const int p = idx % a.n_parts;
  const int b = idx / a.n_parts;
  const int h = hb * NH + warp;
  const int W = a.words;
  const int row_bytes = 16 * a.kst;
  const size_t sb = mma_stage_bytes(a.kst, NH);
  const size_t head_bytes = static_cast<size_t>(TK) * row_bytes;
  unsigned char* ring = smem;
  float* ps = reinterpret_cast<float*>(smem + kStages * sb) + warp * GB * TK;

  // q fragments (the mma's B side): column grp is row grp % 4 of the
  // group, its hi part for grp < 4 and lo part after; rows k of the
  // 16-deep step are dims 2t, 2t+1 (b0) and 2t+8, 2t+9 (b1)
  const size_t row = (static_cast<size_t>(b) * a.hkv + h) * a.g + gg * GB;
  unsigned qb[DK][2];
  {
    const float* qr = a.q + (row + (grp & 3)) * D;
    const int part = grp >> 2;
#pragma unroll
    for (int k = 0; k < DK; ++k)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int d = 16 * k + 2 * t + 8 * hh;
        qb[k][hh] = split_pair(qr[d], qr[d + 1], part);
      }
  }
  const int qp = a.q_pos[b];
  const int key_lo = p * a.part_len;
  const int key_hi = min(a.s_len, key_lo + a.part_len);
  const int n_tiles = (key_hi - key_lo + TK - 1) / TK;
  const int cw = lane / W, cj = lane - cw * W;   // the copy mapping
  const size_t seq0 = static_cast<size_t>(b) * a.s_len;

  // this warp's head's rows of a stage, and the stage's kv_pos
  auto load = [&](int tile, int slot) {
    const int c0 = key_lo + tile * TK;
    const int n = min(TK, key_hi - c0);
    unsigned char* st = ring + slot * sb;
    const size_t row0 = ((seq0 + c0) * a.hkv + h) * a.d;
    load_rows<__nv_bfloat16>(
        a, reinterpret_cast<uint4*>(st + warp * head_bytes),
        reinterpret_cast<uint4*>(st + (NH + warp) * head_bytes),
        static_cast<const __nv_bfloat16*>(a.k) + row0,
        static_cast<const __nv_bfloat16*>(a.v) + row0, n, TK, cw, cj);
    if (warp == 0)
      load_kv_pos(a, reinterpret_cast<int*>(st + 2 * NH * head_bytes),
                  a.kv_pos + seq0 + c0, n);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load(s, s);
    cp_commit();
  }

  // this lane's rows of the group: 2 (t & 1) + j, j = 0, 1
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[DK][4];     // O^T tile k: dims 16k + grp (+8), columns 2t, 2t+1
#pragma unroll
  for (int k = 0; k < DK; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[k][i] = 0.f;
  // ldmatrix row addresses: lane -> (key, dim offset) of its 8x8 matrix
  const int a_key = (lane & 7) + (((lane >> 3) & 1) << 3);   // K, no trans
  const int a_dim = (lane >> 4) << 3;
  const int v_key = (lane & 7) + ((lane >> 4) << 3);         // V, trans
  const int v_dim = ((lane >> 3) & 1) << 3;

  for (int tt = 0; tt < n_tiles; ++tt) {
    cp_wait<kStages - 2>();            // this thread's copies of tile tt
    __syncthreads();                   // every warp's; slot tt - 1 free
    if (tt + kStages - 1 < n_tiles) load(tt + kStages - 1,
                                         (tt + kStages - 1) % kStages);
    cp_commit();
    const unsigned char* st = ring + (tt % kStages) * sb;
    const unsigned char* kh = st + warp * head_bytes;
    const unsigned char* vh = st + (NH + warp) * head_bytes;
    const int* kp = reinterpret_cast<const int*>(st + 2 * NH * head_bytes);
    const int n = min(TK, key_hi - (key_lo + tt * TK));

    // scores of keys grp (c0, c1) and grp + 8 (c2, c3), columns 2t, 2t+1;
    // hi + lo added across lanes t and t ^ 2
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < DK; ++k) {
      unsigned af[4];
      ldsm_x4(af, kh + a_key * row_bytes + 2 * (16 * k + a_dim));
      mma_bf16(sc, af, qb[k][0], qb[k][1]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      sc[i] += __shfl_xor_sync(0xffffffffu, sc[i], 2);

    // mask, the carry, p to shared memory as (GB, 16)
    float corr[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float sg[2];
      bool present[2];
      float mx = kNegInf;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {          // key grp + 8 hf
        const int key = grp + 8 * hf;
        present[hf] = key < n;
        const int kv = kp[key];
        bool ok = present[hf] && kv >= 0 && kv <= qp;
        if (a.window > 0) ok = ok && (qp - kv) < a.window;
        sg[hf] = ok ? sc[2 * hf + j] : kNegInf;
        mx = fmaxf(mx, sg[hf]);
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[j], mx);
      corr[j] = expf(m[j] - m_new);
      float sum = 0.f;
      const int g = 2 * (t & 1) + j;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float pg = present[hf] ? expf(sg[hf] - m_new) : 0.f;
        sum += pg;
        if (t < 2) ps[g * TK + grp + 8 * hf] = pg;
      }
      l[j] = l[j] * corr[j] + sum;
      m[j] = m_new;
    }
#pragma unroll
    for (int k = 0; k < DK; ++k) {
      acc[k][0] *= corr[0];
      acc[k][1] *= corr[1];
      acc[k][2] *= corr[0];
      acc[k][3] *= corr[1];
    }
    __syncwarp();

    // acc += V^T . P^T over the tile's 16 keys
    {
      const float* pr = ps + (grp & 3) * TK + 2 * t;
      const float2 p01 = *reinterpret_cast<const float2*>(pr);
      const float2 p89 = *reinterpret_cast<const float2*>(pr + 8);
      const unsigned b0 = split_pair(p01.x, p01.y, grp >> 2);
      const unsigned b1 = split_pair(p89.x, p89.y, grp >> 2);
#pragma unroll
      for (int k = 0; k < DK; ++k) {
        unsigned af[4];
        ldsm_x4_trans(af, vh + v_key * row_bytes + 2 * (16 * k + v_dim));
        mma_bf16(acc[k], af, b0, b1);
      }
    }
  }
  cp_wait<0>();

  // l over the lanes of one column pair; acc hi + lo across t and t ^ 2
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
      l[j] += __shfl_xor_sync(0xffffffffu, l[j], o);
#pragma unroll
  for (int k = 0; k < DK; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      acc[k][i] += __shfl_xor_sync(0xffffffffu, acc[k][i], 2);
  if (t >= 2) return;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const size_t r = row + 2 * t + j;
    if (a.n_parts == 1) {
      const float den = fmaxf(l[j], 1e-30f);
      float* o = a.out + r * D;
#pragma unroll
      for (int k = 0; k < DK; ++k) {
        o[16 * k + grp] = acc[k][j] / den;
        o[16 * k + grp + 8] = acc[k][2 + j] / den;
      }
    } else {
      float* pr = a.part + (r * a.n_parts + p) * (D + 2);
      if (grp == 0) {
        pr[0] = m[j];
        pr[1] = l[j];
      }
#pragma unroll
      for (int k = 0; k < DK; ++k) {
        pr[2 + 16 * k + grp] = acc[k][j];
        pr[2 + 16 * k + grp + 8] = acc[k][2 + j];
      }
    }
  }
}

// The partitions of each (b, h, g) row combined in partition order: one
// thread per output value.
__global__ void flash_decode_combine(const float* __restrict__ part,
                                     float* __restrict__ out, int rows,
                                     int n_parts, int d) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= static_cast<long long>(rows) * d) return;
  const int r = static_cast<int>(i / d), dd = static_cast<int>(i -
      static_cast<long long>(r) * d);
  const float* pr = part + static_cast<size_t>(r) * n_parts * (d + 2);
  float mx = pr[0];
  for (int p = 1; p < n_parts; ++p) mx = fmaxf(mx, pr[p * (d + 2)]);
  float l = 0.f, acc = 0.f;
  for (int p = 0; p < n_parts; ++p) {
    const float* q = pr + p * (d + 2);
    const float w = expf(q[0] - mx);
    l = fmaf(q[1], w, l);
    acc = fmaf(q[2 + dd], w, acc);
  }
  out[i] = acc / fmaxf(l, 1e-30f);
}

// Launch after opting the kernel in to `smem` bytes of dynamic shared
// memory.
template <class Kernel>
cudaError_t launch_k(Kernel kernel, const Args& a, unsigned grid,
                     int threads, int smem, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fma(const Args& a, int gb, unsigned grid, int smem,
                       cudaStream_t st) {
  switch (gb) {
    case 1: return launch_k(flash_decode_kernel<T, 1>, a, grid, 32, smem, st);
    case 2: return launch_k(flash_decode_kernel<T, 2>, a, grid, 32, smem, st);
    case 4: return launch_k(flash_decode_kernel<T, 4>, a, grid, 32, smem, st);
    case 8: return launch_k(flash_decode_kernel<T, 8>, a, grid, 32, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_mma(const Args& a, unsigned grid, int smem,
                       cudaStream_t st) {
  const int threads = 32 * a.heads;
  switch (a.d) {
    case 32:
      return launch_k(flash_decode_mma_kernel<2>, a, grid, threads, smem, st);
    case 64:
      return launch_k(flash_decode_mma_kernel<4>, a, grid, threads, smem, st);
    case 80:
      return launch_k(flash_decode_mma_kernel<5>, a, grid, threads, smem, st);
    case 128:
      return launch_k(flash_decode_mma_kernel<8>, a, grid, threads, smem, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int flash_decode_tile() { return kTile; }
int flash_decode_mma_tile() { return kMmaTile; }
int flash_decode_stages() { return kStages; }

// Launch on `stream`.  q (batch, hkv, g, d) fp32; k, v (batch, s_len, hkv,
// d) fp32 (bf16 = 0) or bf16 (bf16 = 1); q_pos (batch,), kv_pos (batch,
// s_len) int32; out (batch, hkv, g, d) fp32; `part` fp32 scratch of
// batch * hkv * g * n_parts * (d + 2) values (unused, may be null, when
// n_parts == 1).  `window` <= 0: none.  `use_mma` picks the tensor-core
// path (bf16, gb == g == 4, d of 32, 64, 80 or 128, a 16-byte aligned
// cache; `heads` kv-heads per block, dividing hkv) or the CUDA-core path
// (heads == 1).  `part_len`, `n_parts`, `gb`, `words`, `kst`, `heads` and
// `smem_bytes` come from the wrapper's plan (kernels/flash_decode/kernel.py
// `plan`), which this function re-derives and checks.  With n_parts > 1
// it launches the combine kernel too.  Returns the cudaError_t of the
// launches (0 = launched).
int flash_decode_launch(const float* q, const void* k, const void* v,
                        const int* q_pos, const int* kv_pos, float* out,
                        float* part, int batch, int s_len, int hkv, int g,
                        int d, int window, int part_len, int n_parts, int gb,
                        int words, int kst, int heads, int smem_bytes,
                        int bf16, int use_mma, void* stream) {
  if (batch <= 0 || s_len <= 0 || hkv <= 0 || g <= 0 || d <= 0 ||
      part_len <= 0 || gb <= 0 || g % gb != 0 || heads <= 0 ||
      hkv % heads != 0)
    return cudaErrorInvalidValue;
  const int elem = bf16 ? 2 : 4;
  const int per_word = 16 / elem;
  const int n_groups = g / gb;
  Args a{q,     k,        v,       q_pos,    kv_pos, out,   part,
         batch, s_len,    hkv,     g,        d,      window, part_len,
         n_parts, n_groups, words, kst,     heads,  0};
  a.vec = (d * elem) % 16 == 0 &&
          (reinterpret_cast<uintptr_t>(k) & 15) == 0 &&
          (reinterpret_cast<uintptr_t>(v) & 15) == 0;
  // the wrapper's plan must be the kernel's layout
  size_t smem;
  if (use_mma) {
    if (!bf16 || gb != 4 || g != 4 || heads > kMaxHeads || !a.vec ||
        (d != 32 && d != 64 && d != 80 && d != 128))
      return cudaErrorInvalidValue;
    smem = kStages * mma_stage_bytes(kst, heads) +
           4 * static_cast<size_t>(heads) * gb * kMmaTile;
  } else {
    if (heads != 1) return cudaErrorInvalidValue;
    smem = kStages * stage_bytes(kst) +
           4 * static_cast<size_t>(gb) * words * per_word +
           4 * static_cast<size_t>(kTile) * gb;
  }
  if (words != (d + per_word - 1) / per_word || words > kMaxWords ||
      kst != (words | 1) || n_parts != (s_len + part_len - 1) / part_len ||
      (n_parts > 1 && part == nullptr) ||
      static_cast<size_t>(smem_bytes) != smem || smem > kMaxSmem)
    return cudaErrorInvalidValue;
  const long long blocks = static_cast<long long>(batch) * n_parts *
                           (hkv / heads) * n_groups;
  const long long rows = static_cast<long long>(batch) * hkv * g;
  if (blocks > INT_MAX || rows * d > INT_MAX) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  cudaError_t err =
      use_mma ? launch_mma(a, grid, smem_bytes, st)
              : (bf16 ? launch_fma<__nv_bfloat16>(a, gb, grid, smem_bytes, st)
                      : launch_fma<float>(a, gb, grid, smem_bytes, st));
  if (err != cudaSuccess || n_parts == 1) return err;
  const unsigned cgrid = static_cast<unsigned>(
      (rows * d + kCombineThreads - 1) / kCombineThreads);
  flash_decode_combine<<<cgrid, kCombineThreads, 0, st>>>(
      part, out, static_cast<int>(rows), n_parts, d);
  return cudaGetLastError();
}

}  // extern "C"
