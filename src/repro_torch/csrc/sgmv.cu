// SGMV: per-row multi-LoRA delta  y = scaling * (x @ A[idx]) @ B[idx].
//
// Replaces: src/repro/kernels/sgmv/sgmv.py, `_sgmv_kernel` under `sgmv`
// (and the sort / segment-pad / block-adapter search of
// src/repro/kernels/sgmv/ops.py::sgmv_apply, which exist only to feed the
// TPU's BlockSpec and are not carried over).
//
// Bound on this card: bytes.  At the serving shapes (D = O = 4096, r = 16,
// R = 8 decode rows or 256 prefill rows, N = 4 adapters) the call moves x,
// the A/B slabs of the adapters the batch uses, and y: about 1-5 MB, i.e.
// well under 2 us at 3.35 TB/s, and 2*R*r*(D+O) flops, far below any peak.
// At R = 8 the launch and the memory latency of a few dependent loads are
// larger than either bound, so the design buys parallelism: every load a
// thread issues is independent of the others.
//
// Design (Punica style, two kernels, no sort, no padding):
//  * shrink: one CTA per (row, slice of `dchunk` input features; the
//    wrapper passes 128), so even the 8-row decode batch spreads over
//    R * D / dchunk CTAs.  Threads are
//    (d-lane, rank column) pairs: a warp reads consecutive elements of the
//    row-major (D, r) slab A[idx[row]] — one contiguous span — while
//    x[row, d] is a broadcast.  Each CTA reduces its lanes in shared
//    memory in a fixed order and writes one float32 partial per rank
//    column: part (R, S, r), S = ceil(D / dchunk).  No atomics, so the
//    result is deterministic.
//  * expand: one thread per output column; the CTA first sums the row's S
//    partials in a fixed order into xa (r floats in shared memory) — xa
//    stays float32 between the kernels, as the reference keeps it in an
//    f32 scratch and casts B to f32; rounding it to the storage type would
//    drift — then reads B[idx[row], k, :] coalesced along O.
//  * rows whose adapter id is outside [0, N) write an exact zero row and
//    never touch another row's data; N == 1 needs no special case.
#include "common.cuh"

namespace {

constexpr int kShrinkThreads = 256;
constexpr int kExpandThreads = 256;

template <typename T>
__global__ void sgmv_shrink_kernel(const T* __restrict__ x,
                                   const T* __restrict__ a,
                                   const int* __restrict__ idx,
                                   float* __restrict__ part, int D, int r,
                                   int N, int dchunk) {
  __shared__ float red[kShrinkThreads];
  const int row = blockIdx.x;
  const int s = blockIdx.y, S = gridDim.y;
  const int tid = threadIdx.x;
  const int lanes = blockDim.x / r;  // d-lanes per rank column
  const int k = tid % r;
  const int lane = tid / r;
  const int ad = idx[row];
  const int d0 = s * dchunk, d1 = min(D, d0 + dchunk);
  float acc = 0.f;
  if (ad >= 0 && ad < N && lane < lanes) {
    const T* xr = x + static_cast<size_t>(row) * D;
    const T* ar = a + static_cast<size_t>(ad) * D * r;
#pragma unroll 4
    for (int d = d0 + lane; d < d1; d += lanes)
      acc += rt::to_f32(xr[d]) *
             rt::to_f32(ar[static_cast<size_t>(d) * r + k]);
  }
  red[tid] = acc;
  __syncthreads();
  if (tid < r) {
    float sum = 0.f;
    for (int l = 0; l < lanes; ++l) sum += red[l * r + tid];
    part[(static_cast<size_t>(row) * S + s) * r + tid] = sum;
  }
}

template <typename T>
__global__ void sgmv_expand_kernel(const float* __restrict__ part,
                                   const T* __restrict__ b,
                                   const int* __restrict__ idx,
                                   T* __restrict__ y, int r, int O, int N,
                                   int S, float scaling) {
  extern __shared__ float xs[];  // r floats
  const int row = blockIdx.y;
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  const int ad = idx[row];
  const bool valid = ad >= 0 && ad < N;
  for (int k = threadIdx.x; k < r; k += blockDim.x) {
    float sum = 0.f;
    const float* pr = part + static_cast<size_t>(row) * S * r + k;
    for (int s = 0; s < S; ++s) sum += pr[static_cast<size_t>(s) * r];
    xs[k] = sum;
  }
  __syncthreads();
  if (o >= O) return;
  float acc = 0.f;
  if (valid) {
    const T* br = b + static_cast<size_t>(ad) * r * O + o;
#pragma unroll 8
    for (int k = 0; k < r; ++k)
      acc += xs[k] * rt::to_f32(br[static_cast<size_t>(k) * O]);
  }
  y[static_cast<size_t>(row) * O + o] =
      rt::from_f32<T>(valid ? scaling * acc : 0.f);
}

template <typename T>
void launch_shrink(const void* x, const void* a, const void* idx, void* part,
                   int R, int D, int r, int N, int dchunk, cudaStream_t s) {
  dim3 grid(R, (D + dchunk - 1) / dchunk);
  sgmv_shrink_kernel<T><<<grid, kShrinkThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const int*>(idx), static_cast<float*>(part), D, r, N,
      dchunk);
}

template <typename T>
void launch_expand(const void* part, const void* b, const void* idx, void* y,
                   int R, int r, int O, int N, int S, float scaling,
                   cudaStream_t s) {
  dim3 grid((O + kExpandThreads - 1) / kExpandThreads, R);
  sgmv_expand_kernel<T><<<grid, kExpandThreads, r * sizeof(float), s>>>(
      static_cast<const float*>(part), static_cast<const T*>(b),
      static_cast<const int*>(idx), static_cast<T*>(y), r, O, N, S, scaling);
}

}  // namespace

// x (R, D), a (N, D, r) -> part (R, S, r) float32 with
// S = ceil(D / dchunk).  Requires 1 <= r <= 256 and dchunk >= 1.
extern "C" int sgmv_shrink(const void* x, const void* a, const void* idx,
                           void* part, int R, int D, int r, int N,
                           int dchunk, int dtype, void* stream) {
  if (r < 1 || r > kShrinkThreads || dchunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::DTYPE_BF16)
    launch_shrink<__nv_bfloat16>(x, a, idx, part, R, D, r, N, dchunk, s);
  else
    launch_shrink<float>(x, a, idx, part, R, D, r, N, dchunk, s);
  return rt::launch_status();
}

// part (R, S, r) float32, b (N, r, O) -> y (R, O) in the storage type.
extern "C" int sgmv_expand(const void* part, const void* b, const void* idx,
                           void* y, int R, int r, int O, int N, int S,
                           float scaling, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::DTYPE_BF16)
    launch_expand<__nv_bfloat16>(part, b, idx, y, R, r, O, N, S, scaling, s);
  else
    launch_expand<float>(part, b, idx, y, R, r, O, N, S, scaling, s);
  return rt::launch_status();
}
