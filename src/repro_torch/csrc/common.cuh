// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel reads float32 or bfloat16 storage and accumulates in
// float32 (the bf16 prefill kernels multiply bf16 operands on the tensor
// cores, prefill_tile.cuh).
// The C entry points take a dtype code (DTYPE_F32 / DTYPE_BF16, mirrored
// in kernels/cuda_lib.py), launch on the caller's stream and return
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cassert>
#include <cstdint>

namespace rt {

constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(static_cast<int>(0xff800000u));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reduction through `red` (one float per warp).  Every thread
// of the block must call it; all get the result.
template <bool IS_MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = IS_MAX ? warp_max(v) : warp_sum(v);
  __syncthreads();  // `red` may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = IS_MAX ? neg_inf() : 0.f;
  for (int w = 0; w < nw; ++w) r = IS_MAX ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// Second pass of split-KV decode: one block per output row merges the
// row's S partitions' (max, sum, unnormalised output) triples,
// acc (rows, S, HD) and m / l (rows, S) in float32.  A partition that saw
// no live key reports m = -inf and is skipped; a row with none at all
// yields exact zeros.
template <typename T, int HD>
__global__ void split_kv_merge_kernel(const float* __restrict__ acc,
                                      const float* __restrict__ m,
                                      const float* __restrict__ l,
                                      T* __restrict__ out, int S) {
  const size_t row = blockIdx.x;
  float mx = neg_inf();
  for (int s = 0; s < S; ++s) mx = fmaxf(mx, m[row * S + s]);
  for (int d = threadIdx.x; d < HD; d += blockDim.x) {
    float num = 0.f, den = 0.f;
    if (mx != neg_inf()) {
      for (int s = 0; s < S; ++s) {
        const float ms = m[row * S + s];
        if (ms == neg_inf()) continue;
        const float w = expf(ms - mx);
        num += w * acc[(row * S + s) * HD + d];
        den += w * l[row * S + s];
      }
    }
    out[row * HD + d] = from_f32<T>(num / fmaxf(den, 1e-30f));
  }
}

// ---------------------------------------- asynchronous copies (sm_80+)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; when !valid nothing is read and the
// destination is filled with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Raise the dynamic shared-memory limit of `kernel` to `bytes`.  The
// launchers call it once per instantiation (the port drives one card per
// process).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace rt
