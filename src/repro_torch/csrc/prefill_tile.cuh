// The tile step shared by the two prefill attention kernels
// (paged_prefill.cu, flash_attn.cu).
//
// A CTA of 256 threads owns a tile of kM = 64 query rows and walks keys in
// stages of kKT = 64, both staged in shared memory as float32 rows padded
// to HD + 4 floats (the odd stride keeps the key reads free of bank
// conflicts).  Thread (tx, ty) = (tid % 16, tid / 16) owns rows 4*ty + i
// and keys tx + 16*j of a stage, i, j < 4:
//  * its 4 x 4 register tile of scores comes from float4 shared-memory
//    reads, so one read feeds eight FMAs;
//  * masked keys get probability exactly 0; the float32 online softmax's
//    row max and row sum are reduced across the 16 threads of a row group
//    with shuffles;
//  * the probabilities go through shared memory to the P @ V product,
//    where the thread owns 4 rows x HD/16 output columns in registers.
#pragma once

#include "common.cuh"

namespace rt {
namespace tile {

constexpr int kThreads = 256;
constexpr int kM = 64;        // query rows per CTA
constexpr int kKT = 64;       // keys per staged sub-tile
constexpr int kRPT = 4;       // rows per thread (kM / 16)
constexpr int kKPT = 4;       // keys per thread (kKT / 16)
constexpr int kLDP = kM + 4;  // padded row stride of the probability tile
static_assert(kRPT == 4 && kM == 16 * kRPT && kKT == 16 * kKPT &&
                  kThreads == 256,
              "the thread layout is 16 row groups x 16 key groups");

// Floats of shared memory: Q tile, K and V stages, probability tile.
template <int HD>
constexpr size_t smem_floats() {
  return static_cast<size_t>(kM + 2 * kKT) * (HD + 4) + kKT * kLDP;
}

// Online-softmax state of the 4 rows a thread owns.
template <int HD>
struct Rows {
  float m[kRPT], l[kRPT], acc[kRPT][HD / 16];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < kRPT; ++i) {
      m[i] = neg_inf();
      l[i] = 0.f;
#pragma unroll
      for (int e = 0; e < HD / 16; ++e) acc[i][e] = 0.f;
    }
  }

  // Normalised output of row i, column tx + 16 e.
  __device__ __forceinline__ float out(int i, int e) const {
    return acc[i][e] / fmaxf(l[i], 1e-30f);
  }
};

// Fold one stage of staged keys into the running softmax.  ok(i, j) says
// whether the thread's row i sees its key j.  Every thread of the CTA must
// call it after Ks / Vs are staged and synchronised; it synchronises once
// (between writing Ps and reading it back).
template <int HD, typename KeyOk>
__device__ __forceinline__ void attend_stage(const float* Qs, const float* Ks,
                                             const float* Vs, float* Ps,
                                             float scale, KeyOk ok,
                                             Rows<HD>& st) {
  constexpr int LD = HD + 4;
  constexpr int DPT = HD / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  float s[kRPT][kKPT];
#pragma unroll
  for (int i = 0; i < kRPT; ++i)
#pragma unroll
    for (int j = 0; j < kKPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 qv[kRPT], kv[kKPT];
#pragma unroll
    for (int i = 0; i < kRPT; ++i)
      qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty * kRPT + i) * LD + d]);
#pragma unroll
    for (int j = 0; j < kKPT; ++j)
      kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * LD + d]);
#pragma unroll
    for (int i = 0; i < kRPT; ++i)
#pragma unroll
      for (int j = 0; j < kKPT; ++j)
        s[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y +
                   qv[i].z * kv[j].z + qv[i].w * kv[j].w;
  }

#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    float mx = st.m[i];
#pragma unroll
    for (int j = 0; j < kKPT; ++j) {
      s[i][j] = ok(i, j) ? s[i][j] * scale : neg_inf();
      mx = fmaxf(mx, s[i][j]);
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    // mx stays -inf while the row has seen no live key: then every
    // probability is 0 and nothing is rescaled
    const float corr = mx == neg_inf() ? 1.f : expf(st.m[i] - mx);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < kKPT; ++j) {
      const float p = s[i][j] == neg_inf() ? 0.f : expf(s[i][j] - mx);
      s[i][j] = p;
      rs += p;
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      rs += __shfl_xor_sync(0xffffffffu, rs, o);
    st.m[i] = mx;
    st.l[i] = st.l[i] * corr + rs;
#pragma unroll
    for (int e = 0; e < DPT; ++e) st.acc[i][e] *= corr;
  }
#pragma unroll
  for (int j = 0; j < kKPT; ++j)
    *reinterpret_cast<float4*>(&Ps[(tx + 16 * j) * kLDP + ty * kRPT]) =
        make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
  __syncthreads();

#pragma unroll 4
  for (int kk = 0; kk < kKT; ++kk) {
    const float4 p =
        *reinterpret_cast<const float4*>(&Ps[kk * kLDP + ty * kRPT]);
#pragma unroll
    for (int e = 0; e < DPT; ++e) {
      const float v = Vs[kk * LD + tx + 16 * e];
      st.acc[0][e] += p.x * v;
      st.acc[1][e] += p.y * v;
      st.acc[2][e] += p.z * v;
      st.acc[3][e] += p.w * v;
    }
  }
}

}  // namespace tile
}  // namespace rt
