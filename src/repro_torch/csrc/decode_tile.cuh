// The partition step shared by the two split-KV decode kernels
// (decode_attn.cu over the ring cache, paged_attn.cu over the block pools).
//
// One CTA of 128 threads takes one (row, kv head, partition of `part`
// slots) for the G query heads of that kv head (at most kMaxG of them).  The kernels differ only in
// how slot i of the partition is found and whether it is attended, and
// each passes that as slot_offset(i): the element offset of the slot's K/V
// row for this kv head, or -1 when the slot is not attended.  The step:
//
//  1. resolves the partition's slots into a shared array of offsets, one
//     thread a slot.  A partition with no attended slot issues no copy and
//     writes the empty triple (acc = 0, m = -inf, l = 0), which the merge
//     skips;
//  2. copies the K rows of the partition, then its V rows, global ->
//     shared with 16-byte cp.async.cg, as two commit groups: all of the
//     partition's bytes are in flight at once (32 KB at part 64, hd 128,
//     bf16).  A slot that is not attended is zero-filled (src-size 0), so
//     nothing is read from it: paged pools hold whatever stalled rows last
//     wrote to the garbage block, ring slots past pos hold a stale lap;
//  3. waits for the K group only and computes the scores from shared
//     memory while V is in flight.  A key row of CH = hd * sizeof(T) / 16
//     chunks of 16 bytes is split over LPR lanes, CH rounded up to a power
//     of two and at most 32 (16 at hd 128 in bf16, 32 in float32 and at
//     hd 192 and 256), lane c holding chunks c, c + LPR, ... below CH:
//     CPL = ceil(CH / LPR) of them (2 at hd 192 and 256 in float32, else
//     1).  At hd 192 the row is ragged: in bf16 its 24 chunks leave lanes
//     24-31 empty, in float32 lanes 16-31 hold one chunk where 0-15 hold
//     two; an empty chunk counts as zeros.  Each lane reads its chunks
//     once for all G heads, whose q chunks it holds in float32 registers,
//     and the G dot products are reduced over the LPR lanes with
//     log2(LPR) shuffles;
//  4. takes the partition softmax, one warp a head: float32 max and sum,
//     probability exactly 0 for a slot that is not attended;
//  5. waits for V and forms P V from shared memory: thread (j, c) owns
//     the chunks c, c + LPR, ... of the head dimension for rows j, j + 128
//     / LPR, ... and all G heads, so V is read once per CTA whatever G.
//     The partial sums are reduced over a warp's row groups with shuffles
//     and over the 4 warps through shared memory;
//  6. writes each head's unnormalised (acc, m, l) triple for
//     rt::split_kv_merge_kernel (common.cuh).
//
// Bound: bytes.  A decode step does about G flops per byte it reads (1 at
// G = 1, 8 at G = 8), far under the tensor cores' ridge of ~295, so the
// step runs on the CUDA cores in float32 and its design is about keeping
// bytes in flight.  G is a template bound (GP = 1, 2, 4 or 8, the least
// power of two >= G), so the G = 1 path carries no registers for 8 heads.
// A CTA takes at most kMaxG = 8 query heads: at hd 192 and 256 a lane
// holds 8 floats of q and 8 of the output per head (128 registers at 8
// heads), so 16 heads would spill.  Both kernels give a kv head with more
// query heads (Nemotron-4-340B: 12 over 1, RecurrentGemma-9B: 16 over 1)
// groups of at most 8 on the grid's third axis, up to kMaxGroups of
// them; each group's CTA reads the partition's K/V again (twice at G = 12
// or 16), and the last group masks the heads past G.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace rt {
namespace decode {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPart = kThreads;  // slots per partition: one thread each
constexpr int kMaxG = 8;            // query heads per CTA
constexpr int kMaxGroups = 2;       // head groups of kMaxG per kv head
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory of one CTA

// The least power of two >= n (n >= 1).
__host__ __device__ constexpr int pow2_ceil(int n) {
  return n <= 1 ? 1 : 2 * pow2_ceil((n + 1) / 2);
}

// A row of HD elements as 16-byte chunks over the lanes of a warp: lane c
// (c < LPR) holds chunks c, c + LPR, ... below CH.
template <typename T, int HD>
struct RowLayout {
  static constexpr int EPC = 16 / sizeof(T);  // elements per chunk
  static constexpr int CH = HD / EPC;         // chunks per row
  static constexpr int LPR = CH < 32 ? pow2_ceil(CH) : 32;  // lanes per row
  static constexpr int CPL = (CH + LPR - 1) / LPR;  // chunk slots per lane
  static constexpr int EPL = CPL * EPC;             // elements per lane
  static constexpr bool kRagged = CH % LPR != 0;    // some slots are empty
  static_assert(HD % EPC == 0 && CH >= 1 && 32 % LPR == 0,
                "a row spans 1..32 lanes of whole 16-byte chunks");
};

// Bytes of dynamic shared memory: K and V rows, slot offsets, scores
// [G][part], the P V partial sums [kWarps][G][HD].
template <typename T, int HD>
constexpr size_t smem_bytes(int part, int G) {
  return (2 * sizeof(T) * HD + sizeof(long long) + sizeof(float) * G) *
             static_cast<size_t>(part) +
         sizeof(float) * kWarps * G * HD;
}

// The largest partition (a power of two <= kMaxPart) whose staging at GP
// heads fits one CTA's shared memory: 128 slots, but 64 at hd 256 in
// float32.
template <typename T, int HD, int GP>
constexpr int max_part() {
  int part = kMaxPart;
  while (part > 1 && smem_bytes<T, HD>(part, GP) > kMaxSmem) part /= 2;
  return part;
}

// 16 bytes (4 floats or 8 bf16) -> float32.
__device__ __forceinline__ void load16(const float* p, float (&f)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  f[0] = u.x;
  f[1] = u.y;
  f[2] = u.z;
  f[3] = u.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // element 2j is the low half of word j
    f[2 * j] = __uint_as_float(w[j] << 16);
    f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

// Whether chunk slot j of lane slot c holds a chunk of the row.
template <typename T, int HD>
__device__ __forceinline__ bool holds(int c, int j) {
  using L = RowLayout<T, HD>;
  return !L::kRagged || c + j * L::LPR < L::CH;
}

// The EPL elements of row `row` that lane slot c holds: chunks c, c +
// LPR, ..., as float32; an empty slot reads as zeros.
template <typename T, int HD>
__device__ __forceinline__ void load_lane(const T* row, int c,
                                          float (&f)[RowLayout<T, HD>::EPL]) {
  using L = RowLayout<T, HD>;
#pragma unroll
  for (int j = 0; j < L::CPL; ++j) {
    float t[L::EPC];
    if (holds<T, HD>(c, j)) {
      load16(row + (c + j * L::LPR) * L::EPC, t);
    } else {
#pragma unroll
      for (int e = 0; e < L::EPC; ++e) t[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < L::EPC; ++e) f[j * L::EPC + e] = t[e];
  }
}

// Issue the 16-byte copies of rows 0..n-1 of `src` (offsets off[i], -1 =
// zero-fill) into `dst` (rows of HD elements).
template <typename T, int HD>
__device__ __forceinline__ void copy_rows(T* dst, const T* src,
                                          const long long* off, int n) {
  constexpr int EPC = RowLayout<T, HD>::EPC, CH = RowLayout<T, HD>::CH;
  for (int x = threadIdx.x; x < n * CH; x += kThreads) {
    const int i = x / CH, ch = x % CH;
    const long long o = off[i];
    cp_async16(dst + i * HD + ch * EPC, src + (o >= 0 ? o : 0) + ch * EPC,
               o >= 0);
  }
}

// Step 3: scores of rows 0..n-1 of Ks for the G heads whose chunks this
// lane holds in qr, into sc[g * part + i] (-inf where off[i] < 0).
template <typename T, int HD, int GP>
__device__ __forceinline__ void score_rows(
    const T* Ks, const long long* off,
    const float (&qr)[GP][RowLayout<T, HD>::EPL], float* sc, int G, int n,
    int part, float scale) {
  constexpr int EPL = RowLayout<T, HD>::EPL, LPR = RowLayout<T, HD>::LPR;
  constexpr int RPW = 32 / LPR;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = lane % LPR;
  for (int i0 = warp * RPW; i0 < n; i0 += kWarps * RPW) {  // warp-uniform
    const int i = i0 + lane / LPR;
    float kf[EPL];
    if (i < n) {
      load_lane<T, HD>(Ks + i * HD, c, kf);
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) kf[e] = 0.f;
    }
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      if (g >= G) break;
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) dot += qr[g][e] * kf[e];
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (c == 0 && i < n)
        sc[g * part + i] = off[i] >= 0 ? dot * scale : neg_inf();
    }
  }
}

// Step 5: this thread's share of P V, rows j, j + 128 / LPR, ... of Vs
// with probabilities sc[g * part + i], added into acc.
template <typename T, int HD, int GP>
__device__ __forceinline__ void pv_rows(
    const T* Vs, const float* sc, float (&acc)[GP][RowLayout<T, HD>::EPL],
    int G, int n, int part) {
  constexpr int EPL = RowLayout<T, HD>::EPL, LPR = RowLayout<T, HD>::LPR;
  constexpr int NGRP = kThreads / LPR;
  const int c = threadIdx.x % LPR;
  for (int i = threadIdx.x / LPR; i < n; i += NGRP) {
    float vf[EPL];
    load_lane<T, HD>(Vs + i * HD, c, vf);
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      if (g >= G) break;
      const float pr = sc[g * part + i];
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] += pr * vf[e];
    }
  }
}

// The whole partition step (steps 1-6 above).  Every thread of the CTA
// calls it with the same arguments; the CTA is launched with
// smem_bytes<T, HD>(part, G) bytes of dynamic shared memory.  It serves
// the G query heads q0, q0 + 1, ... (G <= GP), each a row of HD elements
// of q; the triple of query head q0 + g goes to index (q0 + g) * NP + s of
// m_out / l_out (times HD for acc_out).
template <typename T, int HD, int GP, typename SlotOffset>
__device__ __forceinline__ void partition_step(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, size_t q0, int G, int n, int part,
    SlotOffset slot_offset, float* __restrict__ acc_out,
    float* __restrict__ m_out, float* __restrict__ l_out, int s, int NP,
    float scale) {
  using L = RowLayout<T, HD>;
  constexpr int EPC = L::EPC, LPR = L::LPR, EPL = L::EPL;
  static_assert(GP >= 1 && GP <= kMaxG, "query heads per CTA");
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + part * HD;
  long long* off = reinterpret_cast<long long*>(Vs + part * HD);
  float* sc = reinterpret_cast<float*>(off + part);  // [G][part]
  float* red = sc + G * part;                         // [kWarps][G][HD]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = lane % LPR;  // this lane's first 16-byte chunk of a row

  // 1. resolve
  const long long mine = tid < n ? slot_offset(tid) : -1;
  if (tid < n) off[tid] = mine;
  if (!__syncthreads_or(mine >= 0)) {
    for (int d = tid; d < G * HD; d += kThreads)
      acc_out[((q0 + d / HD) * NP + s) * HD + d % HD] = 0.f;
    if (tid < G) {
      m_out[(q0 + tid) * NP + s] = neg_inf();
      l_out[(q0 + tid) * NP + s] = 0.f;
    }
    return;
  }

  // 2. every K row, then every V row, in flight at once
  copy_rows<T, HD>(Ks, k, off, n);
  cp_async_commit();
  copy_rows<T, HD>(Vs, v, off, n);
  cp_async_commit();
  float qr[GP][EPL];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    if (g < G) {
      load_lane<T, HD>(q + (q0 + g) * HD, c, qr[g]);
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) qr[g][e] = 0.f;
    }
  }

  // 3. scores, while V is in flight
  cp_async_wait<1>();
  __syncthreads();
  score_rows<T, HD, GP>(Ks, off, qr, sc, G, n, part, scale);
  __syncthreads();

  // 4. partition softmax, one warp a head; the partition has an attended
  // slot, so the max is finite
  for (int g = warp; g < G; g += kWarps) {
    float* row = sc + g * part;
    float mx = neg_inf();
    for (int i = lane; i < n; i += 32) mx = fmaxf(mx, row[i]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float x = row[i];
      const float pr = x == neg_inf() ? 0.f : expf(x - mx);
      row[i] = pr;
      sum += pr;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      m_out[(q0 + g) * NP + s] = mx;
      l_out[(q0 + g) * NP + s] = sum;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // 5. P V: masked rows are zero-filled and weigh exactly 0
  float acc[GP][EPL];
#pragma unroll
  for (int g = 0; g < GP; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  pv_rows<T, HD, GP>(Vs, sc, acc, G, n, part);
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1)  // the warp's row groups
#pragma unroll
    for (int g = 0; g < GP; ++g)
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
  if (lane < LPR) {
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      if (g >= G) break;
#pragma unroll
      for (int j = 0; j < L::CPL; ++j) {
        if (!holds<T, HD>(c, j)) continue;
#pragma unroll
        for (int e = 0; e < EPC; ++e)
          red[(warp * G + g) * HD + (c + j * LPR) * EPC + e] =
              acc[g][j * EPC + e];
      }
    }
  }
  __syncthreads();

  // 6. the partition's unnormalised output of each head
  for (int d = tid; d < G * HD; d += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += red[w * G * HD + d];
    acc_out[((q0 + d / HD) * NP + s) * HD + d % HD] = a;
  }
}

// Host side: call f(type_tag<T>{}, int_tag<HD>{}, int_tag<GP>{}) for the
// instantiation that serves (dtype, hd, G), GP the least power of two >= G.
template <typename T>
struct type_tag {
  using type = T;
};
template <int N>
using int_tag = std::integral_constant<int, N>;

template <typename T, int HD, typename F>
int dispatch_g(int G, F& f) {
  if (G == 1) return f(type_tag<T>{}, int_tag<HD>{}, int_tag<1>{});
  if (G == 2) return f(type_tag<T>{}, int_tag<HD>{}, int_tag<2>{});
  if (G <= 4) return f(type_tag<T>{}, int_tag<HD>{}, int_tag<4>{});
  return f(type_tag<T>{}, int_tag<HD>{}, int_tag<8>{});
}

template <typename T, typename F>
int dispatch_hd(int hd, int G, F& f) {
  switch (hd) {
    case 32:
      return dispatch_g<T, 32>(G, f);
    case 64:
      return dispatch_g<T, 64>(G, f);
    case 128:
      return dispatch_g<T, 128>(G, f);
    case 192:
      return dispatch_g<T, 192>(G, f);
    case 256:
      return dispatch_g<T, 256>(G, f);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// G: query heads of one CTA (1..kMaxG).
template <typename F>
int dispatch(int dtype, int hd, int G, F&& f) {
  if (G < 1 || G > kMaxG) return static_cast<int>(cudaErrorInvalidValue);
  return dtype == DTYPE_BF16 ? dispatch_hd<__nv_bfloat16>(hd, G, f)
                             : dispatch_hd<float>(hd, G, f);
}

}  // namespace decode
}  // namespace rt
