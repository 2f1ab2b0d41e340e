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
// -1e30 of the reference, never -inf: a row with no valid key gives the
// mean of v over its S keys (every p = exp(0) = 1), and a chunk that is all
// masked before the first valid key is wiped when one arrives
// (corr = exp(-1e30 - m) = 0).  l is floored at 1e-30 before the divide.
//
// What bounds it on this card: bytes.  Each cache value is read once and
// used in 2 multiply-adds per query row (G of them), so at G = 4 and bf16
// a byte carries ~4 operations, below the H100's ~20 fp32 FLOP/B ridge.
// At h2o-danube-1.8b's decode_32k shape (B=128, S=32768, Hkv=8, D=80, bf16)
// the cache is 10.74 GB.  The design: one block of 128 threads per
// (b, kv-head), walking the sequence in chunks of C keys, so the G query
// rows of a kv-head share every K/V byte read.  Each chunk's K and V rows
// are staged into shared memory as fp32 (16-byte loads where the row is
// 16-byte aligned; K rows padded to an odd number of 16-byte words, so the
// score loop's 16-byte reads are free of bank conflicts); then one thread
// per (g, c) takes a score, one warp per g folds the chunk into the online
// softmax carry (m, l) with a fixed shuffle tree, and one thread per
// (g, d) updates acc.  The carry lives in shared memory in fp32.  Fixed
// order and no atomics: two launches are bitwise equal.  Any S (the last
// chunk is masked by length, its missing keys contribute nothing), any D,
// any G.  Split-sequence decoding, cp.async/TMA double buffering and a
// register-blocked acc are later work.
//
// Build (no PyTorch headers; bound with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libflash_decode.so flash_decode.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;         // the reference's NEG_INF
constexpr size_t kMaxSmem = 48 * 1024;    // the default dynamic limit

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Args {
  const float* q;
  const void* k;
  const void* v;
  const int* q_pos;
  const int* kv_pos;
  float* out;
  int batch, s_len, hkv, g, d;
  int window;      // <= 0: no window
  int chunk;       // C, keys per tile
  int d4;          // D rounded up to 4
  int kst;         // K row stride in shared memory (floats)
  int vec;         // 1: K/V rows are 16-byte aligned
};

// Shared-memory layout in floats; the first four regions are multiples of
// 4 floats long, so each starts 16-byte aligned.
struct Layout {
  float *ks, *vs, *qs, *acc, *ps, *m, *l, *corr;
  int* kp;
  __device__ Layout(float* smem, const Args& a) {
    ks = smem;                          // (C, kst)
    vs = ks + a.chunk * a.kst;          // (C, d4)
    qs = vs + a.chunk * a.d4;           // (G, d4)
    acc = qs + a.g * a.d4;              // (G, d4)
    ps = acc + a.g * a.d4;              // (G, C) scores, then p
    m = ps + a.g * a.chunk;             // (G,)
    l = m + a.g;                        // (G,)
    corr = l + a.g;                     // (G,)
    kp = reinterpret_cast<int*>(corr + a.g);   // (C,)
  }
};

// Stage keys [c0, c0 + n) of (b, h) into ks / vs as fp32, and their kv_pos.
template <typename T>
__device__ void load_chunk(const Args& a, const Layout& sm, int b, int h,
                           int c0, int n) {
  const T* kg = static_cast<const T*>(a.k);
  const T* vg = static_cast<const T*>(a.v);
  const size_t row0 =
      (static_cast<size_t>(b) * a.s_len + c0) * a.hkv + h;   // in rows of D
  const size_t row_step = a.hkv;
  if (a.vec) {
    constexpr int kVec = 16 / sizeof(T);
    const int vpr = a.d / kVec;                  // 16-byte words per row
    for (int i = threadIdx.x; i < n * vpr; i += kThreads) {
      const int c = i / vpr, j = i - c * vpr;
      const size_t off = (row0 + c * row_step) * a.d + j * kVec;
      const uint4 kr = __ldg(reinterpret_cast<const uint4*>(kg + off));
      const uint4 vr = __ldg(reinterpret_cast<const uint4*>(vg + off));
      const T* ke = reinterpret_cast<const T*>(&kr);
      const T* ve = reinterpret_cast<const T*>(&vr);
      float* kd = sm.ks + c * a.kst + j * kVec;
      float* vd = sm.vs + c * a.d4 + j * kVec;
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        kd[e] = to_f32(ke[e]);
        vd[e] = to_f32(ve[e]);
      }
    }
  } else {
    for (int i = threadIdx.x; i < n * a.d; i += kThreads) {
      const int c = i / a.d, dd = i - c * a.d;
      const size_t off = (row0 + c * row_step) * a.d + dd;
      sm.ks[c * a.kst + dd] = to_f32(kg[off]);
      sm.vs[c * a.d4 + dd] = to_f32(vg[off]);
    }
  }
  for (int c = threadIdx.x; c < n; c += kThreads)
    sm.kp[c] = a.kv_pos[static_cast<size_t>(b) * a.s_len + c0 + c];
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(
    const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float smem[];
  const Layout sm(smem, a);
  const int b = blockIdx.x / a.hkv, h = blockIdx.x - b * a.hkv;
  const int qp = a.q_pos[b];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // q rows (zero-padded to d4), the carry, and K's pad columns (never
  // written by a load, so they stay zero and the score loop may run to d4)
  const float* qg = a.q + (static_cast<size_t>(b) * a.hkv + h) * a.g * a.d;
  for (int i = threadIdx.x; i < a.g * a.d4; i += kThreads) {
    const int g = i / a.d4, dd = i - g * a.d4;
    sm.qs[i] = dd < a.d ? qg[g * a.d + dd] : 0.f;
    sm.acc[i] = 0.f;
  }
  for (int g = threadIdx.x; g < a.g; g += kThreads) {
    sm.m[g] = kNegInf;
    sm.l[g] = 0.f;
  }
  for (int i = threadIdx.x; i < a.chunk * (a.kst - a.d); i += kThreads) {
    const int c = i / (a.kst - a.d), dd = a.d + i % (a.kst - a.d);
    sm.ks[c * a.kst + dd] = 0.f;
  }

  for (int c0 = 0; c0 < a.s_len; c0 += a.chunk) {
    const int n = min(a.chunk, a.s_len - c0);
    __syncthreads();              // the previous chunk is done with ks/vs/ps
    load_chunk<T>(a, sm, b, h, c0, n);
    __syncthreads();

    // scores: one thread per (g, c), masked to the finite -1e30
    for (int it = threadIdx.x; it < a.g * n; it += kThreads) {
      const int g = it / n, c = it - g * n;
      const float4* qr = reinterpret_cast<const float4*>(sm.qs + g * a.d4);
      const float4* kr = reinterpret_cast<const float4*>(sm.ks + c * a.kst);
      float s = 0.f;
      for (int j = 0; j < a.d4 / 4; ++j) {
        const float4 x = qr[j], y = kr[j];
        s = fmaf(x.x, y.x, s);
        s = fmaf(x.y, y.y, s);
        s = fmaf(x.z, y.z, s);
        s = fmaf(x.w, y.w, s);
      }
      const int kv = sm.kp[c];
      bool ok = kv >= 0 && kv <= qp;
      if (a.window > 0) ok = ok && (qp - kv) < a.window;
      sm.ps[g * a.chunk + c] = ok ? s : kNegInf;
    }
    __syncthreads();

    // the online softmax carry: one warp per query row
    for (int g = warp; g < a.g; g += kWarps) {
      float* pr = sm.ps + g * a.chunk;
      float mx = kNegInf;
      for (int c = lane; c < n; c += 32) mx = fmaxf(mx, pr[c]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = sm.m[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = lane; c < n; c += 32) {
        const float p = expf(pr[c] - m_new);
        pr[c] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        sm.l[g] = sm.l[g] * corr + sum;
        sm.m[g] = m_new;
        sm.corr[g] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p . v: one thread per (g, d)
    for (int it = threadIdx.x; it < a.g * a.d; it += kThreads) {
      const int g = it / a.d, dd = it - g * a.d;
      const float* pr = sm.ps + g * a.chunk;
      float pv = 0.f;
      for (int c = 0; c < n; ++c) pv = fmaf(pr[c], sm.vs[c * a.d4 + dd], pv);
      float* ac = sm.acc + g * a.d4 + dd;
      *ac = *ac * sm.corr[g] + pv;
    }
  }
  __syncthreads();

  float* og = a.out + (static_cast<size_t>(b) * a.hkv + h) * a.g * a.d;
  for (int it = threadIdx.x; it < a.g * a.d; it += kThreads) {
    const int g = it / a.d, dd = it - g * a.d;
    og[it] = sm.acc[g * a.d4 + dd] / fmaxf(sm.l[g], 1e-30f);
  }
}

}  // namespace

extern "C" {

int flash_decode_threads() { return kThreads; }

// Launch on `stream`.  q (batch, hkv, g, d) fp32; k, v (batch, s_len, hkv,
// d) fp32 (bf16 = 0) or bf16 (bf16 = 1); q_pos (batch,), kv_pos (batch,
// s_len) int32; out (batch, hkv, g, d) fp32.  `window` <= 0: none.
// `chunk`, `kst` and `smem_bytes` come from the wrapper's layout
// (kernels/flash_decode/kernel.py `plan`).  Returns the cudaError_t of the
// launch (0 = launched).
int flash_decode_launch(const float* q, const void* k, const void* v,
                        const int* q_pos, const int* kv_pos, float* out,
                        int batch, int s_len, int hkv, int g, int d,
                        int window, int chunk, int kst, int smem_bytes,
                        int bf16, void* stream) {
  if (batch <= 0 || s_len < 0 || hkv <= 0 || g <= 0 || d <= 0 || chunk <= 0)
    return cudaErrorInvalidValue;
  Args a{q, k, v, q_pos, kv_pos, out, batch, s_len, hkv, g, d, window, chunk,
         (d + 3) / 4 * 4, kst, 0};
  // the wrapper's layout must be the kernel's (struct Layout)
  const size_t words = static_cast<size_t>(chunk) * (kst + a.d4 + g + 1) +
                       static_cast<size_t>(g) * (2 * a.d4 + 3);
  if (kst < a.d4 || kst % 4 != 0 ||
      static_cast<size_t>(smem_bytes) != 4 * words ||
      static_cast<size_t>(smem_bytes) > kMaxSmem)
    return cudaErrorInvalidValue;
  const size_t elem = bf16 ? 2 : 4;
  a.vec = (d * elem) % 16 == 0 &&
          (reinterpret_cast<uintptr_t>(k) & 15) == 0 &&
          (reinterpret_cast<uintptr_t>(v) & 15) == 0;
  const unsigned grid = static_cast<unsigned>(batch) * hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    flash_decode_kernel<__nv_bfloat16><<<grid, kThreads, smem_bytes, st>>>(a);
  else
    flash_decode_kernel<float><<<grid, kThreads, smem_bytes, st>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
