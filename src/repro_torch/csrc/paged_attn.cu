// Paged single-token GQA decode attention with an in-kernel block-table
// walk.
//
// Replaces: src/repro/kernels/paged_attention/paged_attn.py,
// `_paged_kernel` under `paged_decode_attention`.
//
// Bound on this card: bytes.  A decode step reads every live key and value
// of every row once: at Llama-2-7B widths (K = 32 kv heads, hd = 128, bf16)
// that is 16 KiB per token per layer, so 8 rows at ~800 tokens move ~105
// MB per layer (~31 us at 3.35 TB/s), against ~4 flops per byte — two
// orders of magnitude below the tensor-core ridge.
//
// Design: split-KV (flash-decoding).  Llama-2-7B has G = 1 (K = H = 32), so
// one CTA per (row, kv head) gives only 8 * 32 = 256 CTAs of one long walk
// each, too few bytes in flight to fill 132 SMs.  The grid is therefore
// (row * kv head, partition of PART tokens): each CTA walks one partition
// of the row's logical history through the block table (reading only the
// physical blocks the table names), and a second small kernel merges the
// partitions' (max, sum, unnormalised output) triples.  Partitions wholly
// past the row's position exit at once, so short rows cost almost nothing.
//  * Scores: a warp per token; lanes hold hd/32 contiguous elements, so a
//    key row is one coalesced read, reduced with shuffles.
//  * Values: one thread per head-dim element, coalesced along hd.
//  * Masking is by construction: only tokens t <= pos (and t > pos -
//    window) are visited, and a -1 table entry is never read — its keys
//    get probability exactly 0.  A row with no live key (an inactive slot)
//    yields exact zeros, finite as the runtime requires.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPart = 128;  // tokens per partition (upper bound)
constexpr int kMaxG = 8;       // query heads per kv head

template <typename T, int HD>
__global__ void paged_decode_part_kernel(
    const T* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, const int* __restrict__ tbl,
    const int* __restrict__ pos, float* __restrict__ acc_out,
    float* __restrict__ m_out, float* __restrict__ l_out, int K, int G,
    int NB, int bs, int MB, int part, int window, float scale) {
  constexpr int EPL = HD / 32;  // key elements per lane
  __shared__ float sc[kMaxG][kMaxPart];
  __shared__ long long off[kMaxPart];  // pool offset of token, -1 = masked
  __shared__ float red[kWarps];

  const int b = blockIdx.x / K, h = blockIdx.x % K;
  const int s = blockIdx.y, S = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = pos[b];
  const int t0 = s * part;
  const int t_end = min(min(t0 + part, p + 1), MB * bs);  // exclusive
  int t_begin = t0;
  if (window > 0) t_begin = max(t_begin, p - window + 1);
  const int n = t_end - t_begin;

  const size_t qh = static_cast<size_t>(b) * K + h;  // (row, kv head)
  if (n <= 0) {
    for (int g = 0; g < G; ++g) {
      const size_t o = (qh * G + g) * S + s;
      for (int d = tid; d < HD; d += kThreads) acc_out[o * HD + d] = 0.f;
      if (tid == 0) {
        m_out[o] = rt::neg_inf();
        l_out[o] = 0.f;
      }
    }
    return;
  }

  // this lane's slice of every query head of the group
  float qr[kMaxG][EPL];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      qr[g][e] = g < G ? rt::to_f32(q[(qh * G + g) * HD + lane * EPL + e])
                       : 0.f;
  }

  // scores, one warp per token
  for (int i = warp; i < n; i += kWarps) {
    const int t = t_begin + i;
    const int phys = tbl[b * MB + t / bs];
    assert(phys < NB);
    if (phys < 0) {
      if (lane == 0) {
        off[i] = -1;
        for (int g = 0; g < G; ++g) sc[g][i] = rt::neg_inf();
      }
      continue;
    }
    const long long base =
        ((static_cast<long long>(h) * NB + phys) * bs + t % bs) * HD;
    float kv[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) kv[e] = rt::to_f32(kp[base + lane * EPL + e]);
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) dot += qr[g][e] * kv[e];
      dot = rt::warp_sum(dot);
      if (lane == 0) sc[g][i] = dot * scale;
    }
    if (lane == 0) off[i] = base;
  }
  __syncthreads();

  for (int g = 0; g < G; ++g) {
    float mx = rt::neg_inf();
    for (int i = tid; i < n; i += kThreads) mx = fmaxf(mx, sc[g][i]);
    mx = rt::block_reduce<true>(mx, red);
    // mx is finite unless every visited token was masked; then all
    // probabilities are zero and the partition reports an empty triple
    float sum = 0.f;
    for (int i = tid; i < n; i += kThreads) {
      const float pr = off[i] < 0 ? 0.f : expf(sc[g][i] - mx);
      sc[g][i] = pr;
      sum += pr;
    }
    sum = rt::block_reduce<false>(sum, red);  // also orders the sc writes
    const size_t o = (qh * G + g) * S + s;
    for (int d = tid; d < HD; d += kThreads) {
      float acc = 0.f;
      for (int i = 0; i < n; ++i) {
        if (off[i] < 0) continue;
        acc += sc[g][i] * rt::to_f32(vp[off[i] + d]);
      }
      acc_out[o * HD + d] = acc;
    }
    if (tid == 0) {
      m_out[o] = sum > 0.f ? mx : rt::neg_inf();
      l_out[o] = sum;
    }
  }
}

template <typename T, int HD>
__global__ void paged_decode_merge_kernel(const float* __restrict__ acc,
                                          const float* __restrict__ m,
                                          const float* __restrict__ l,
                                          T* __restrict__ out, int S) {
  const size_t row = blockIdx.x;  // (b, kv head, g) == output head row
  float mx = rt::neg_inf();
  for (int s = 0; s < S; ++s) mx = fmaxf(mx, m[row * S + s]);
  for (int d = threadIdx.x; d < HD; d += blockDim.x) {
    float num = 0.f, den = 0.f;
    if (mx != rt::neg_inf()) {
      for (int s = 0; s < S; ++s) {
        const float ms = m[row * S + s];
        if (ms == rt::neg_inf()) continue;
        const float w = expf(ms - mx);
        num += w * acc[(row * S + s) * HD + d];
        den += w * l[row * S + s];
      }
    }
    out[row * HD + d] = rt::from_f32<T>(num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int HD>
void launch(const void* q, const void* kp, const void* vp, const void* tbl,
            const void* pos, void* acc, void* m, void* l, void* out, int B,
            int K, int G, int NB, int bs, int MB, int part, int window,
            cudaStream_t st) {
  const int S = (MB * bs + part - 1) / part;
  const float scale =
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(HD)));
  dim3 grid(B * K, S);
  paged_decode_part_kernel<T, HD><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(tbl),
      static_cast<const int*>(pos), static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l), K, G, NB, bs, MB, part,
      window, scale);
  if (cudaPeekAtLastError() != cudaSuccess) return;
  paged_decode_merge_kernel<T, HD><<<B * K * G, HD, 0, st>>>(
      static_cast<const float*>(acc), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<T*>(out), S);
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* kp, const void* vp,
                const void* tbl, const void* pos, void* acc, void* m, void* l,
                void* out, int B, int K, int G, int NB, int bs, int MB,
                int part, int window, cudaStream_t st) {
  switch (hd) {
    case 32:
      launch<T, 32>(q, kp, vp, tbl, pos, acc, m, l, out, B, K, G, NB, bs, MB,
                    part, window, st);
      return 0;
    case 64:
      launch<T, 64>(q, kp, vp, tbl, pos, acc, m, l, out, B, K, G, NB, bs, MB,
                    part, window, st);
      return 0;
    case 128:
      launch<T, 128>(q, kp, vp, tbl, pos, acc, m, l, out, B, K, G, NB, bs,
                     MB, part, window, st);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, K*G, hd); kp/vp (K, NB, bs, hd); tbl (B, MB) int32; pos (B,) int32;
// scratch acc (B, K, G, S, hd), m/l (B, K, G, S) float32 with
// S = ceil(MB*bs / part); out (B, K*G, hd).  window <= 0 means none.
extern "C" int paged_decode(const void* q, const void* kp, const void* vp,
                            const void* tbl, const void* pos, void* acc,
                            void* m, void* l, void* out, int B, int K, int G,
                            int NB, int bs, int MB, int hd, int part,
                            int window, int dtype, void* stream) {
  if (G < 1 || G > kMaxG || part < 1 || part > kMaxPart)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const int bad =
      dtype == rt::DTYPE_BF16
          ? dispatch_hd<__nv_bfloat16>(hd, q, kp, vp, tbl, pos, acc, m, l,
                                       out, B, K, G, NB, bs, MB, part, window,
                                       st)
          : dispatch_hd<float>(hd, q, kp, vp, tbl, pos, acc, m, l, out, B, K,
                               G, NB, bs, MB, part, window, st);
  if (bad) return bad;
  return rt::launch_status();
}
