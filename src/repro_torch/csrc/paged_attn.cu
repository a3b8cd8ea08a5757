// Paged single-token GQA decode attention with an in-kernel block-table
// walk.
//
// Replaces: src/repro/kernels/paged_attention/paged_attn.py:48,
// `_paged_kernel` under `paged_decode_attention` (its pl.pallas_call at
// :116).
//
// Bound on this card: bytes.  A decode step reads every live key and value
// of every row once: at Llama-2-7B widths (K = 32 kv heads, hd = 128, bf16)
// that is 16 KiB per token per layer, so 8 rows at ~500 tokens move ~64
// MB per layer (~19 us at 3.35 TB/s), against ~1 flop per byte at G = 1:
// two orders of magnitude below the tensor-core ridge.
//
// Design: split-KV (flash-decoding) on the partition step shared with the
// ring decode kernel (decode_tile.cuh).  Llama-2-7B has G = 1 (K = H =
// 32), so one CTA per (row, kv head) would give only 8 * 32 = 256 CTAs of
// one long walk each, too few bytes in flight to fill 132 SMs.  The grid is
// therefore (row * kv head, partition of `part` tokens): each CTA stages
// one partition of the row's logical history, resolved through the block
// table (reading only the physical blocks the table names), in shared
// memory with cp.async, and a second small kernel merges the partitions'
// (max, sum, unnormalised output) triples.  Partitions wholly past the
// row's position (or before its window) exit at once, so short rows cost
// almost nothing.  What this kernel supplies is token t's address and
// validity:
//  * t is attended if t_begin <= t <= pos (t_begin = pos - window + 1 with
//    a window) and its table entry is not -1; its row for kv head h is at
//    ((h * NB + phys) * bs + t % bs) * hd of the (K, NB, bs, hd) pool, a
//    pool block being bs * hd contiguous elements per kv head.
//  * A token that is not attended is never read — the garbage block 0
//    holds what stalled rows wrote — and gets probability exactly 0.  A
//    row with no live key (an inactive slot) yields exact zeros, finite as
//    the runtime requires.
// A kv head with more than kMaxG = 8 query heads (Nemotron-4-340B: 12
// over 1, at hd 192; RecurrentGemma-9B: 16 over 1, at hd 256) splits them
// into groups of 8 on the grid's third axis; each group's CTA stages the
// partition itself, so K/V are read once per group, and the last group
// of Nemotron's holds 4 heads.  At hd 256 a bf16 partition of 64 slots
// and 8 heads stages 99 KB (float32: 163 KB), above the 48 KB default:
// the launcher raises the limit once per instantiation (rt::allow_smem)
// to its largest partition (dec::max_part).
#include <cmath>

#include "decode_tile.cuh"

namespace {

namespace dec = rt::decode;

template <typename T, int HD, int GP>
__global__ void __launch_bounds__(dec::kThreads) paged_decode_part_kernel(
    const T* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, const int* __restrict__ tbl,
    const int* __restrict__ pos, float* __restrict__ acc,
    float* __restrict__ m, float* __restrict__ l, int K, int G, int NB,
    int bs, int MB, int part, int window, float scale) {
  const int b = blockIdx.x / K, h = blockIdx.x % K, s = blockIdx.y;
  const int g0 = blockIdx.z * dec::kMaxG;  // this CTA's query heads
  const int Gc = min(dec::kMaxG, G - g0);
  const int p = pos[b];
  const int t_end = min(min((s + 1) * part, p + 1), MB * bs);  // exclusive
  int t_begin = s * part;
  if (window > 0) t_begin = max(t_begin, p - window + 1);
  dec::partition_step<T, HD, GP>(
      q, kp, vp, (static_cast<size_t>(b) * K + h) * G + g0, Gc,
      t_end - t_begin, part,
      [=](int i) -> long long {
        const int t = t_begin + i;
        const int phys = tbl[b * MB + t / bs];
        assert(phys < NB);
        return phys < 0
                   ? -1
                   : ((static_cast<long long>(h) * NB + phys) * bs + t % bs) *
                         HD;
      },
      acc, m, l, s, gridDim.y, scale);
}

template <typename T, int HD, int GP>
int launch(const void* q, const void* kp, const void* vp, const void* tbl,
           const void* pos, void* acc, void* m, void* l, void* out, int B,
           int K, int G, int NB, int bs, int MB, int part, int window,
           cudaStream_t st) {
  const int NP = (MB * bs + part - 1) / part;
  const float scale =
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(HD)));
  if (part > dec::max_part<T, HD, GP>())
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = rt::allow_smem(
      paged_decode_part_kernel<T, HD, GP>,
      dec::smem_bytes<T, HD>(dec::max_part<T, HD, GP>(), GP));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int groups = (G + dec::kMaxG - 1) / dec::kMaxG;
  dim3 grid(B * K, NP, groups);
  paged_decode_part_kernel<T, HD, GP>
      <<<grid, dec::kThreads,
         dec::smem_bytes<T, HD>(part, G < dec::kMaxG ? G : dec::kMaxG),
         st>>>(
          static_cast<const T*>(q), static_cast<const T*>(kp),
          static_cast<const T*>(vp), static_cast<const int*>(tbl),
          static_cast<const int*>(pos), static_cast<float*>(acc),
          static_cast<float*>(m), static_cast<float*>(l), K, G, NB, bs, MB,
          part, window, scale);
  if (cudaPeekAtLastError() != cudaSuccess) return 0;  // launch_status
  rt::split_kv_merge_kernel<T, HD><<<B * K * G, HD, 0, st>>>(
      static_cast<const float*>(acc), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<T*>(out), NP);
  return 0;
}

}  // namespace

// q (B, K*G, hd); kp/vp (K, NB, bs, hd); tbl (B, MB) int32; pos (B,) int32;
// scratch acc (B, K, G, S, hd), m/l (B, K, G, S) float32 with
// S = ceil(MB*bs / part); out (B, K*G, hd).  q, kp and vp start on 16-byte
// boundaries.  window <= 0 means none.  hd 32, 64, 128, 192 or 256; G up
// to kMaxGroups * kMaxG = 16.
extern "C" int paged_decode(const void* q, const void* kp, const void* vp,
                            const void* tbl, const void* pos, void* acc,
                            void* m, void* l, void* out, int B, int K, int G,
                            int NB, int bs, int MB, int hd, int part,
                            int window, int dtype, void* stream) {
  if (part < 1 || part > dec::kMaxPart || G < 1 ||
      G > dec::kMaxGroups * dec::kMaxG)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const int bad = dec::dispatch(
      dtype, hd, G < dec::kMaxG ? G : dec::kMaxG, [&](auto t, auto d, auto gp) {
        return launch<typename decltype(t)::type, decltype(d)::value,
                      decltype(gp)::value>(q, kp, vp, tbl, pos, acc, m, l,
                                           out, B, K, G, NB, bs, MB, part,
                                           window, st);
      });
  if (bad) return bad;
  return rt::launch_status();
}
