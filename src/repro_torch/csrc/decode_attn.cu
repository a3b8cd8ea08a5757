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
// Design: split-KV, as the paged decode kernel (paged_attn.cu), on the
// partition step they share (decode_tile.cuh).  The TPU grid walked the
// cache sequentially with (m, l, acc) in VMEM scratch; here one CTA per
// (row, kv head, partition of `part` slots) carries all G query heads of
// that kv head, as the Pallas kernel's (G, hd) tile does, stages the
// partition's K and V rows in shared memory with cp.async, and
// rt::split_kv_merge_kernel combines the partitions' (max, sum,
// unnormalised output) triples.  What this kernel supplies is slot i's
// address and validity:
//  * The cache is read in place in the engine's (B, S, K, hd) layout: a
//    slot's key for one kv head is hd contiguous elements.  The
//    reference's wrapper transposes the whole cache to (B, K, S, hd) every
//    step; this kernel needs no copy.
//  * Slots are tested one by one against slot_pos (valid if 0 <= slot_pos
//    <= pos, and > pos - window with a window).  Once the ring has wrapped
//    the valid slots are not a contiguous range, so no position bound can
//    replace the predicate.  Masked slots are never read and get
//    probability exactly 0; a row with no valid slot yields zeros.
//  * pos comes from a device int32 scalar (pos_ptr) or, when that is
//    null, from the host (pos_host): neither needs a host synchronise.
// A kv head with more than kMaxG = 8 query heads (Nemotron-4-340B: 12 at
// hd 192; RecurrentGemma-9B: 16 at hd 256) splits them into groups of 8
// on the grid's third axis, as paged decode does; each group's CTA stages
// the partition itself.  At hd 192 and 256 a partition of 64 slots and 8
// heads stages 75-99 KB in bf16 (124-163 KB in float32), above the 48 KB
// default: the launcher raises the limit once per instantiation to its
// largest partition (dec::max_part).
#include <cmath>

#include "decode_tile.cuh"

namespace {

namespace dec = rt::decode;

template <typename T, int HD, int GP>
__global__ void __launch_bounds__(dec::kThreads) ring_decode_part_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ slot_pos,
    const int* __restrict__ pos_ptr, int pos_host, float* __restrict__ acc,
    float* __restrict__ m, float* __restrict__ l, int K, int G, int S,
    int part, int window, float scale) {
  const int b = blockIdx.x / K, h = blockIdx.x % K, s = blockIdx.y;
  const int g0 = blockIdx.z * dec::kMaxG;  // this CTA's query heads
  const int p = pos_ptr != nullptr ? *pos_ptr : pos_host;
  const int t0 = s * part;
  const size_t row0 = static_cast<size_t>(b) * S + t0;  // slot 0's cache row
  dec::partition_step<T, HD, GP>(
      q, k, v, (static_cast<size_t>(b) * K + h) * G + g0,
      min(dec::kMaxG, G - g0), min(part, S - t0), part,
      [=](int i) -> long long {
        const int sp = slot_pos[t0 + i];
        const bool ok =
            sp >= 0 && sp <= p && (window <= 0 || sp > p - window);
        return ok ? static_cast<long long>(((row0 + i) * K + h) * HD) : -1;
      },
      acc, m, l, s, gridDim.y, scale);
}

template <typename T, int HD, int GP>
int launch(const void* q, const void* k, const void* v, const void* spos,
           const void* pos_ptr, int pos_host, void* acc, void* m, void* l,
           void* out, int B, int K, int G, int S, int part, int window,
           cudaStream_t st) {
  const int NP = (S + part - 1) / part;
  const float scale =
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(HD)));
  if (part > dec::max_part<T, HD, GP>())
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = rt::allow_smem(
      ring_decode_part_kernel<T, HD, GP>,
      dec::smem_bytes<T, HD>(dec::max_part<T, HD, GP>(), GP));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int groups = (G + dec::kMaxG - 1) / dec::kMaxG;
  dim3 grid(B * K, NP, groups);
  ring_decode_part_kernel<T, HD, GP>
      <<<grid, dec::kThreads,
         dec::smem_bytes<T, HD>(part, G < dec::kMaxG ? G : dec::kMaxG),
         st>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const int*>(spos),
          static_cast<const int*>(pos_ptr), pos_host,
          static_cast<float*>(acc), static_cast<float*>(m),
          static_cast<float*>(l), K, G, S, part, window, scale);
  if (cudaPeekAtLastError() != cudaSuccess) return 0;  // launch_status
  rt::split_kv_merge_kernel<T, HD><<<B * K * G, HD, 0, st>>>(
      static_cast<const float*>(acc), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<T*>(out), NP);
  return 0;
}

}  // namespace

// q (B, K*G, hd); k/v (B, S, K, hd); slot_pos (S,) int32; pos_ptr a device
// int32 scalar, or null to take pos_host; scratch acc (B, K, G, NP, hd),
// m/l (B, K, G, NP) float32 with NP = ceil(S / part); out (B, K*G, hd).
// q, k and v start on 16-byte boundaries.  window <= 0 means none.  hd
// 32, 64, 128, 192 or 256; G up to kMaxGroups * kMaxG = 16.
extern "C" int ring_decode(const void* q, const void* k, const void* v,
                           const void* slot_pos, const void* pos_ptr,
                           void* acc, void* m, void* l, void* out,
                           int pos_host, int B, int K, int G, int S, int hd,
                           int part, int window, int dtype, void* stream) {
  if (B < 1 || K < 1 || S < 1 || part < 1 || part > dec::kMaxPart ||
      G < 1 || G > dec::kMaxGroups * dec::kMaxG)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const int bad = dec::dispatch(
      dtype, hd, G < dec::kMaxG ? G : dec::kMaxG, [&](auto t, auto d, auto gp) {
        return launch<typename decltype(t)::type, decltype(d)::value,
                      decltype(gp)::value>(q, k, v, slot_pos, pos_ptr,
                                           pos_host, acc, m, l, out, B, K,
                                           G, S, part, window, st);
      });
  if (bad) return bad;
  return rt::launch_status();
}

// Bytes of dynamic shared memory of one partition step (decode_tile.cuh)
// at head dim hd (32, 64, 128, 192 or 256), dtype, part slots and G
// (1..8) query heads of one CTA.
extern "C" int decode_smem_bytes(int hd, int dtype, int part, int G) {
  return dec::dispatch(dtype, hd, G, [&](auto t, auto d, auto) {
    return static_cast<int>(dec::smem_bytes<typename decltype(t)::type,
                                            decltype(d)::value>(part, G));
  });
}
