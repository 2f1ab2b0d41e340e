// FM pairwise interaction (the sum-square identity) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fm_kernel` in
// src/repro/kernels/fm_interaction/kernel.py (pallas_call in
// `fm_interaction_kernel_call`), which serves
// `models/recsys.forward(use_kernel=True)`:
//
//   out[b] = 0.5 * sum_k [ (sum_f v[b, f, k])^2 - sum_f v[b, f, k]^2 ]
//
// v is (B, F, K) fp32 or bf16, row-major and contiguous; out is (B,) fp32.
// Sums are taken in fp32 (bf16 is upcast on load).
//
// What bounds it on this card: bytes.  Each value is read once and costs
// ~3 operations, far below the H100's ~20 fp32 FLOP/B ridge; at the fm
// config's serve_bulk shape (262,144 x 39 x 10 fp32) that is 409 MB read.
// The design reads v once, coalesced: a block of 256 threads owns `spb`
// consecutive samples, whose spb*F*K values are one contiguous range of
// device memory, and stages them into shared memory as fp32 with 16-byte
// loads where aligned (the wrapper makes spb a multiple of 8 so that every
// block's range is).  Then one thread per (sample, k) sums v and v^2 over
// f in field order and writes (sum^2 - sumsq), and one thread per sample
// adds its K terms in k order.  Fixed order and no atomics: two launches
// are bitwise equal.  The ragged last block masks samples >= B, so any B
// runs without padding.
//
// Build (no PyTorch headers; bound with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libfm_interaction.so fm_interaction.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 48 * 1024;   // the default dynamic limit

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// dst[i] = float(src[i]) for i < n, by the whole block; 16-byte loads
// when src is 16-byte aligned, then the tail one value at a time.
template <typename T>
__device__ void stage(const T* __restrict__ src, float* dst, int n) {
  constexpr int kVec = 16 / sizeof(T);
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int nv = n / kVec;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
#pragma unroll 4
    for (int i = threadIdx.x; i < nv; i += kThreads) {
      const uint4 raw = __ldg(s4 + i);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) dst[i * kVec + j] = to_f32(e[j]);
    }
    done = nv * kVec;
  }
  for (int i = done + threadIdx.x; i < n; i += kThreads)
    dst[i] = to_f32(src[i]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fm_interaction_kernel(const T* __restrict__ v, float* __restrict__ out,
                          int batch, int f, int k, int spb) {
  extern __shared__ __align__(16) float smem[];
  const int fk = f * k;
  const int s0 = blockIdx.x * spb;
  const int ns = min(spb, batch - s0);        // the ragged last block
  float* vals = smem;                         // (ns, F, K) fp32
  float* terms = smem + static_cast<size_t>(spb) * fk;   // (ns, K)

  stage(v + static_cast<size_t>(s0) * fk, vals, ns * fk);
  __syncthreads();

  for (int it = threadIdx.x; it < ns * k; it += kThreads) {
    const int s = it / k;
    const float* col = vals + s * fk + (it - s * k);
    float sum = 0.f, sq = 0.f;
    for (int ff = 0; ff < f; ++ff) {
      const float x = col[ff * k];
      sum += x;
      sq += x * x;
    }
    terms[it] = sum * sum - sq;
  }
  __syncthreads();

  for (int s = threadIdx.x; s < ns; s += kThreads) {
    float t = 0.f;
    for (int kk = 0; kk < k; ++kk) t += terms[s * k + kk];
    out[s0 + s] = 0.5f * t;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`: v (batch, f, k) fp32 (bf16 = 0) or bf16 (bf16 = 1),
// out (batch,) fp32, `spb` samples per block.  Returns the cudaError_t of
// the launch (0 = launched).
int fm_interaction_launch(const void* v, float* out, int batch, int f, int k,
                          int spb, int bf16, void* stream) {
  if (batch <= 0 || f <= 0 || k <= 0 || spb <= 0)
    return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(spb) * (f * k + k) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const int grid = (batch + spb - 1) / spb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    fm_interaction_kernel<__nv_bfloat16><<<grid, kThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(v), out, batch, f, k, spb);
  } else {
    fm_interaction_kernel<float><<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(v), out, batch, f, k, spb);
  }
  return cudaGetLastError();
}

}  // extern "C"
