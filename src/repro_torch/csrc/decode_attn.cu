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
// bfloat16 (the serving dtype): one launch on a pipelined step with its
// merge folded in (ring_decode_step.cuh, rt::ring).  The split-KV design
// before it ran one CTA per (row, kv head, 64-slot partition), each paying
// its prologue (slot offsets, q into registers) per 64 slots and copying
// its whole partition before computing, then a second launch,
// rt::split_kv_merge_kernel, that read every partition's float32 triple
// back from device memory with one CTA per (row, head) looping over them
// serially (512 partitions at 32768 slots).  Now a cluster of C CTAs
// takes one (row, kv head, group of at most 8 query heads); each CTA
// tests its contiguous range of slots once, walks its live partitions
// through a 3-stage ring that a producer warp keeps full by TMA, and the
// cluster merges its C triples in distributed shared memory, writing the
// output (and, with `lse`, the log-sum-exp) itself: no scratch in device
// memory, no second launch.  Masked slots are copied (a TMA box is
// whole) and selected away, so a NaN in a stale slot cannot reach the
// output.  The library picks C and the partition per shape
// (rt::ring::plan, exported as ring_decode_plan).
//  * The cache is read in place in the engine's (B, S, K, hd) layout: a
//    slot's key for one kv head is hd contiguous elements.  The
//    reference's wrapper transposes the whole cache to (B, K, S, hd) every
//    step; this kernel needs no copy.
//  * Slots are tested one by one against slot_pos (valid if 0 <= slot_pos
//    <= pos, and > pos - window with a window).  Once the ring has wrapped
//    the valid slots are not a contiguous range, so no position bound can
//    replace the predicate.  A row with no valid slot yields zeros.
//  * pos comes from a device int32 scalar (pos_ptr) or, when that is
//    null, from the host (pos_host): neither needs a host synchronise.
//  * A kv head with more than 8 query heads (Nemotron-4-340B: 12 at hd
//    192; RecurrentGemma-9B: 16 at hd 256) splits them into groups of 8,
//    each group's cluster reading the kv head's slots itself.
//
// float32 (the SMOKE parity runs) keeps the split-KV design unchanged, as
// the paged decode kernel (paged_attn.cu) runs it: one CTA per (row, kv
// head, head group, partition of `part` slots) on the partition step they
// share (decode_tile.cuh), which stages the partition's K and V rows in
// shared memory with cp.async and leaves a triple per partition for
// rt::split_kv_merge_kernel.  At hd 256 a partition of 64 slots and 8
// heads stages 163 KB, above the 48 KB default: the launcher raises the
// limit once per instantiation to its largest partition (dec::max_part).
#include <cmath>

#include "ring_decode_step.cuh"

namespace {

namespace dec = rt::decode;
using bf16 = __nv_bfloat16;

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

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v,
                const void* spos, const void* pos_ptr, int pos_host,
                void* out, void* lse, int B, int K, int G, int S, int window,
                cudaStream_t st) {
  namespace ring = rt::ring;
  using X = ring::Boxes<HD>;
  const ring::Plan p = ring::plan(B, K, G, S, HD);
  const int slots = ring::range(p, S);
  if (slots > ring::kMaxRange) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = rt::allow_smem(
      ring::ring_decode_kernel<HD>,
      ring::smem_bytes<HD>(ring::part_for(HD), ring::kMaxStages,
                           ring::kMaxRange));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap km, vm;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(K) * HD,
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(K) * HD * 2,
                                 static_cast<cuuint64_t>(S) * K * HD * 2};
  const cuuint32_t box[3] = {X::kCols, static_cast<cuuint32_t>(p.part), 1};
  if (!rt::bf16_tensor_map(&km, k, 3, dims, strides, box, X::kRowBytes) ||
      !rt::bf16_tensor_map(&vm, v, 3, dims, strides, box, X::kRowBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale =
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(HD)));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster, B * K * ((G + ring::kMaxG - 1) / ring::kMaxG));
  cfg.blockDim = dim3(ring::kThreads);
  cfg.dynamicSmemBytes = ring::smem_bytes<HD>(p.part, p.stages, slots);
  cfg.stream = st;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = p.cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, ring::ring_decode_kernel<HD>, km, vm,
      static_cast<const bf16*>(q), static_cast<const int*>(spos),
      static_cast<const int*>(pos_ptr), pos_host, static_cast<bf16*>(out),
      static_cast<float*>(lse), K, G, S, p.part, p.stages, window, scale));
}

}  // namespace

// q (B, K*G, hd); k/v (B, S, K, hd); slot_pos (S,) int32; pos_ptr a device
// int32 scalar, or null to take pos_host; out (B, K*G, hd).  bf16: one
// launch, no scratch (acc, m, l and part unused); lse (B, K*G) float32 or
// null.  float32: scratch acc (B, K, G, NP, hd), m/l (B, K, G, NP) with NP =
// ceil(S / part), lse null (the wrapper reads m and l).  q, k and v start
// on 16-byte boundaries.  window <= 0 means none.  hd 32, 64, 128, 192 or
// 256; G up to kMaxGroups * kMaxG = 16.
extern "C" int ring_decode(const void* q, const void* k, const void* v,
                           const void* slot_pos, const void* pos_ptr,
                           void* acc, void* m, void* l, void* out, void* lse,
                           int pos_host, int B, int K, int G, int S, int hd,
                           int part, int window, int dtype, void* stream) {
  if (B < 1 || K < 1 || S < 1 || G < 1 ||
      G > dec::kMaxGroups * dec::kMaxG)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const int gp = G < dec::kMaxG ? G : dec::kMaxG;
  int bad;
  if (dtype == rt::DTYPE_BF16) {
    auto f = [&](auto, auto d, auto) {
      return launch_bf16<decltype(d)::value>(q, k, v, slot_pos, pos_ptr,
                                             pos_host, out, lse, B, K, G, S,
                                             window, st);
    };
    bad = dec::dispatch_hd<bf16>(hd, 1, f);  // every G: one instantiation
  } else {
    if (part < 1 || part > dec::kMaxPart || lse != nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    auto f = [&](auto t, auto d, auto g) {
      return launch<typename decltype(t)::type, decltype(d)::value,
                    decltype(g)::value>(q, k, v, slot_pos, pos_ptr, pos_host,
                                        acc, m, l, out, B, K, G, S, part,
                                        window, st);
    };
    bad = dec::dispatch_hd<float>(hd, gp, f);
  }
  if (bad) return bad;
  return rt::launch_status();
}

// The bf16 plan of a call: cluster size | slots a partition << 8 | ring
// stages << 16 (the wrapper's tests read the rule).
extern "C" int ring_decode_plan(int B, int K, int G, int S, int hd) {
  const rt::ring::Plan p = rt::ring::plan(B, K, G, S, hd);
  return p.cluster | p.part << 8 | p.stages << 16;
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
