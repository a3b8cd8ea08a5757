// Single-token GQA decode attention over the engine's ring KV cache.
//
// Replaces: src/repro/kernels/decode_attention/decode_attn.py:34,
// `_decode_kernel` under `decode_attention` (its pl.pallas_call at :90).
//
// Bound on this card: bytes.  A decode step reads every live slot's key
// and value once: at Llama-2-7B widths (K = 32 kv heads, hd = 128, bf16)
// that is 16 KiB per slot per layer, so the launcher's 3 rows over 531 live
// slots of a 540-slot ring move 26.1 MB (7.8 us at 3.35 TB/s), and 8 rows
// of a full ring 70.8 MB (21.1 us), against ~1 flop per byte.
//
// Design: split-KV, as the paged decode kernel (paged_attn.cu).  The TPU
// grid walked the cache sequentially with (m, l, acc) in VMEM scratch; here
// one CTA per (row, kv head, partition of PART slots) carries all G query
// heads of that kv head, as the Pallas kernel's (G, hd) tile does, and
// rt::split_kv_merge_kernel combines the partitions' (max, sum,
// unnormalised output) triples.
//  * The cache is read in place in the engine's (B, S, K, hd) layout: a
//    slot's key for one kv head is hd contiguous elements, read by one warp
//    (hd/32 elements a lane) and reduced with shuffles.  The reference's
//    wrapper transposes the whole cache to (B, K, S, hd) every step; this
//    kernel needs no copy.
//  * Slots are tested one by one against slot_pos (valid if 0 <= slot_pos
//    <= pos, and > pos - window with a window).  Once the ring has wrapped
//    the valid slots are not a contiguous range, so no position bound can
//    replace the predicate.  Masked slots are never read and get
//    probability exactly 0; a row with no valid slot yields zeros.
//  * pos comes from a device int32 scalar (pos_ptr) or, when that is
//    null, from the host (pos_host): neither needs a host synchronise.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPart = 128;  // slots per partition (upper bound)
constexpr int kMaxG = 8;       // query heads per kv head

template <typename T, int HD>
__global__ void ring_decode_part_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ slot_pos,
    const int* __restrict__ pos_ptr, int pos_host, float* __restrict__ acc_out,
    float* __restrict__ m_out, float* __restrict__ l_out, int K, int G, int S,
    int part, int window, float scale) {
  constexpr int EPL = HD / 32;  // key elements per lane
  __shared__ float sc[kMaxG][kMaxPart];
  __shared__ int live[kMaxPart];  // 1 if the slot is attended
  __shared__ float red[kWarps];

  const int b = blockIdx.x / K, h = blockIdx.x % K;
  const int s = blockIdx.y, NP = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = pos_ptr != nullptr ? *pos_ptr : pos_host;
  const int t0 = s * part;
  const int n = min(part, S - t0);
  const size_t qh = static_cast<size_t>(b) * K + h;  // (row, kv head)

  // this lane's slice of every query head of the group
  float qr[kMaxG][EPL];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      qr[g][e] = g < G ? rt::to_f32(q[(qh * G + g) * HD + lane * EPL + e])
                       : 0.f;
  }

  // scores, one warp per slot
  for (int i = warp; i < n; i += kWarps) {
    const int sp = slot_pos[t0 + i];
    bool ok = sp >= 0 && sp <= p;
    if (window > 0) ok = ok && sp > p - window;
    if (!ok) {
      if (lane == 0) {
        live[i] = 0;
        for (int g = 0; g < G; ++g) sc[g][i] = rt::neg_inf();
      }
      continue;
    }
    const size_t base =
        ((static_cast<size_t>(b) * S + t0 + i) * K + h) * HD;
    float kv[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) kv[e] = rt::to_f32(k[base + lane * EPL + e]);
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) dot += qr[g][e] * kv[e];
      dot = rt::warp_sum(dot);
      if (lane == 0) sc[g][i] = dot * scale;
    }
    if (lane == 0) live[i] = 1;
  }
  __syncthreads();

  for (int g = 0; g < G; ++g) {
    float mx = rt::neg_inf();
    for (int i = tid; i < n; i += kThreads) mx = fmaxf(mx, sc[g][i]);
    mx = rt::block_reduce<true>(mx, red);
    // mx is -inf only if no slot of the partition is live: then every
    // probability is zero and the partition reports an empty triple
    float sum = 0.f;
    for (int i = tid; i < n; i += kThreads) {
      const float pr = live[i] ? expf(sc[g][i] - mx) : 0.f;
      sc[g][i] = pr;
      sum += pr;
    }
    sum = rt::block_reduce<false>(sum, red);  // also orders the sc writes
    const size_t o = (qh * G + g) * NP + s;
    for (int d = tid; d < HD; d += kThreads) {
      float acc = 0.f;
      for (int i = 0; i < n; ++i) {
        if (!live[i]) continue;
        acc += sc[g][i] *
               rt::to_f32(v[((static_cast<size_t>(b) * S + t0 + i) * K + h) *
                                HD + d]);
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
void launch(const void* q, const void* k, const void* v, const void* spos,
            const void* pos_ptr, int pos_host, void* acc, void* m, void* l,
            void* out, int B, int K, int G, int S, int part, int window,
            cudaStream_t st) {
  const int NP = (S + part - 1) / part;
  const float scale =
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(HD)));
  dim3 grid(B * K, NP);
  ring_decode_part_kernel<T, HD><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(spos),
      static_cast<const int*>(pos_ptr), pos_host, static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l), K, G, S, part, window,
      scale);
  if (cudaPeekAtLastError() != cudaSuccess) return;
  rt::split_kv_merge_kernel<T, HD><<<B * K * G, HD, 0, st>>>(
      static_cast<const float*>(acc), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<T*>(out), NP);
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                const void* spos, const void* pos_ptr, int pos_host,
                void* acc, void* m, void* l, void* out, int B, int K, int G,
                int S, int part, int window, cudaStream_t st) {
  switch (hd) {
    case 32:
      launch<T, 32>(q, k, v, spos, pos_ptr, pos_host, acc, m, l, out, B, K,
                    G, S, part, window, st);
      return 0;
    case 64:
      launch<T, 64>(q, k, v, spos, pos_ptr, pos_host, acc, m, l, out, B, K,
                    G, S, part, window, st);
      return 0;
    case 128:
      launch<T, 128>(q, k, v, spos, pos_ptr, pos_host, acc, m, l, out, B, K,
                     G, S, part, window, st);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, K*G, hd); k/v (B, S, K, hd); slot_pos (S,) int32; pos_ptr a device
// int32 scalar, or null to take pos_host; scratch acc (B, K, G, NP, hd),
// m/l (B, K, G, NP) float32 with NP = ceil(S / part); out (B, K*G, hd).
// window <= 0 means none.
extern "C" int ring_decode(const void* q, const void* k, const void* v,
                           const void* slot_pos, const void* pos_ptr,
                           void* acc, void* m, void* l, void* out,
                           int pos_host, int B, int K, int G, int S, int hd,
                           int part, int window, int dtype, void* stream) {
  if (B < 1 || K < 1 || S < 1 || G < 1 || G > kMaxG || part < 1 ||
      part > kMaxPart)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const int bad =
      dtype == rt::DTYPE_BF16
          ? dispatch_hd<__nv_bfloat16>(hd, q, k, v, slot_pos, pos_ptr,
                                       pos_host, acc, m, l, out, B, K, G, S,
                                       part, window, st)
          : dispatch_hd<float>(hd, q, k, v, slot_pos, pos_ptr, pos_host, acc,
                               m, l, out, B, K, G, S, part, window, st);
  if (bad) return bad;
  return rt::launch_status();
}
