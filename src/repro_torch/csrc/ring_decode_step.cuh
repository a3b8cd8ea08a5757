// The bf16 decode step shared by ring decode (decode_attn.cu) and paged
// decode (paged_attn.cu): one launch, a cluster of CTAs per (row, kv head,
// group of query heads), its CTAs walking their stages of keys through a
// pipelined shared-memory ring and merging their (max, sum, unnormalised
// output) triples through distributed shared memory.
//
// The two kernels differ only in where a stage's keys come from and which
// of them are attended.  Each passes a *source* (RingSrc below, PagedSrc
// in paged_attn.cu) that says which stages its CTA walks and fills a ring
// slot with one of them; the consumer and the two merges are this file's
// step(), written once.  A source:
//
//   int count()       stages of this CTA's walk, j = 0 .. count() - 1
//   bool live(int j)  false: neither side touches stage j (ring decode's
//                     dead partitions); both sides skip it, in the same
//                     order, so the ring's stages stay in step
//   void begin(int lane)
//                     the producer warp's 32 lanes, before its first fill
//   void prepare(int j, int lane)
//                     the same lanes, before ring slot st is free: what
//                     fill(j) needs that the slot does not (paged decode:
//                     the stage's table entries and bits)
//   void fill(int j, unsigned char* st, uint64_t* full, uint32_t* bits,
//             int lane)
//                     the same lanes (on the producer's own copy of the
//                     source, which may keep state from stage to stage),
//                     once ring slot st is free: copy stage j's K (st) and V
//                     (st + 2 P HD) into it, its slots' bits into bits
//                     (kSlotWords words, for a source that keeps them per
//                     slot) and arrive on full
//   unsigned group(int j, const uint32_t* bits, int o)
//                     the attended bits of slots o .. o + 15 of stage j
//   static int off(int P, int row, int col)
//                     the byte offset of (row, column col) in a ring slot's
//                     K (or V) region of P rows: where fill's copies put it
//
// Ring decode (RingSrc): grid (C, B x K x groups of 8 heads), clusters of
// (C, 1, 1).  CTA c walks partitions [c per, (c + 1) per) of P slots (per =
// ceil(NP / C)).  A prologue tests every slot of the CTA against slot_pos
// (valid if 0 <= slot_pos <= pos, and > pos - window with a window; slots
// past S are not) into a bit mask in shared memory, 4 slots a lane from one
// 16-byte load; a partition with no bit set is dead.  The cache (B, S, K,
// hd) is a 3-D map (K hd, S, B): one kv head's P slots land as hd / 64
// boxes of 64 columns x P rows.  Slots past S arrive as zeros.
//
// The step:
//  1. The producer warp keeps up to NS stages in flight; the TMA boxes
//     land under the 128-byte swizzle (hd 32: one box of 32 columns,
//     64-byte swizzle), so the consumers' ldmatrix meets few bank
//     conflicts.  The consumers release a stage on its "empty" mbarrier.
//     The producer starts (begin) while the barriers are made, and the
//     consumers stage the Q tile while its first copies are in flight.
//  2. The four consumer warps split each stage into 16-slot groups (warp w
//     takes groups w, w + 4, ...) and keep, per warp, a running float32
//     (m, l, acc) for the query heads over every group they take.  On the
//     tensor cores (mma.sync.m16n8k16, bf16 operands, float32 sums; the
//     heads are the rows of the m16 tile): S = Q K^T for the group's 16
//     slots, K's fragments by ldmatrix and Q's held in registers (ROWS 8:
//     up to 8 heads, rows 8-15 zero) or read by ldmatrix from a Q tile in
//     shared memory (ROWS 16: up to 16 heads, whose running sums take the
//     registers Q's fragments would); the group's max raises m (acc and l
//     scaled by exp(m_old - m_new), skipped where no row's max moved;
//     scores in the log2 domain, exp2 of score x log2 e, one MUFU op); P,
//     rounded to bf16 as the Pallas kernels round it, is the A operand of
//     P V straight from the score registers, V's fragments by
//     ldmatrix.trans.
//     A copy brings a masked slot whole: a ring slot past pos holds a
//     stale lap, a paged block slots past pos or before the window and
//     whatever stalled rows wrote, a slot of a block that was not copied
//     whatever the ring slot held before.  So masking *selects*: a masked
//     slot's score is -inf by a select on its bit (not on its value), its
//     probability exactly 0, and its V elements are zeroed in the fragment
//     registers by a select before the product, never multiplied by 0.  A
//     group with no valid slot is skipped.
//  3. The four warps' triples merge in shared memory into the CTA's, in
//     order of warp (each head's warp weights computed once); a CTA alone
//     in its cluster writes its triple out, else the cluster syncs and
//     CTA c merges 4-column pieces c x 160 + t, ... of the G x hd outputs
//     over the C triples in order of rank, every load from the other CTAs
//     in flight at once (M = max m, weights exp(m_q - M), 0 for a CTA that
//     saw no valid slot); either divides by max(sum w l, 1e-30), rounds
//     once to bf16 and, when asked, writes the log-sum-exp M + log(sum w
//     l) (-inf for a row and head with no valid slot, whose output is
//     exact zeros).  The order is fixed: the output is bitwise the same
//     run to run.
//
// plan() picks C and P per ring shape: P slots of 32 KB of K and V a stage
// (64 at hd 128, 128 at hd 64 and below, 32 at hd 192 and 256), NS = 3
// stages, and C (a power of two, 1..8, at most half the partitions) the
// largest that keeps the grid within one CTA an SM: a cluster that does
// not fit beside the others waits for a second wave, which costs a whole
// CTA's walk (at two CTAs an SM the clusters of 2 x 32768 slots did not
// all fit; chip_variants.py 6).  So latency-bound shapes (one kv head, a
// short ring) get 8 CTAs a pair, Llama-2-7B's 3 rows one CTA a pair over
// 9 partitions, and 2 rows x 32768 slots (64 pairs) 2 CTAs of 256
// partitions each.  paged_plan() is paged decode's (paged_attn.cu).
#pragma once

#include <cooperative_groups.h>

#include "decode_tile.cuh"

namespace rt {
namespace ring {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kCWarps = 4;                   // consumer warps
constexpr int kConsumers = 32 * kCWarps;
constexpr int kThreads = kConsumers + 32;    // + the producer warp
constexpr int kMaxG = decode::kMaxG;         // ring: query heads a cluster
constexpr int kMaxStages = 4;
constexpr int kMaxCluster = 8;
constexpr int kMaxRange = 65536;             // slots a CTA walks at most
constexpr int kStageBytes = 32 * 1024;       // K and V of one partition
constexpr int kSlotWords = 4;                // a stage's bits (P <= 128)
constexpr int kSms = 132;

struct Plan {
  int cluster, part, stages;
};

// Slots a partition: the most (a power of two, 32..128) whose K and V
// rows fit kStageBytes.
__host__ __device__ constexpr int part_for(int hd) {
  int part = 128;
  while (part > 32 && 4 * part * hd > kStageBytes) part /= 2;
  return part;
}

inline Plan plan(int B, int K, int G, int S, int hd) {
  Plan p{1, part_for(hd), 3};
  const long units =
      static_cast<long>(B) * K * ((G + kMaxG - 1) / kMaxG);
  const int np = (S + p.part - 1) / p.part;
  while (p.cluster < kMaxCluster && units * p.cluster * 2 <= kSms &&
         2 * p.cluster <= np)
    p.cluster *= 2;
  return p;
}

// Slots one CTA walks under a plan (its bit mask's length).
inline int range(const Plan& p, int S) {
  const int np = (S + p.part - 1) / p.part;
  return (np + p.cluster - 1) / p.cluster * p.part;
}

// Columns of one TMA box and its swizzle: 64 (128-byte rows), or the
// whole row at hd 32 (64-byte rows).
template <int HD>
struct Boxes {
  static constexpr int kCols = HD >= 64 ? 64 : HD;
  static constexpr int kRowBytes = 2 * kCols;
  static constexpr int kCount = HD / kCols;
  static_assert(HD % kCols == 0 && (kRowBytes == 128 || kRowBytes == 64),
                "whole boxes of 64 or 32 columns");
};

// Byte offset of (row, column col) in a region of HD / kCols swizzled
// boxes of `rows` rows; col a multiple of 8 (a 16-byte unit).
template <int HD>
__device__ __forceinline__ int swz(int rows, int row, int col) {
  using X = Boxes<HD>;
  const int u = (col % X::kCols) / 8;
  const int su = X::kRowBytes == 128 ? u ^ (row & 7) : u ^ ((row >> 1) & 3);
  return (col / X::kCols) * rows * X::kRowBytes + row * X::kRowBytes +
         (su << 4);
}

// Row stride (elements) of the ROWS = 16 Q tile: 16 bytes of padding put
// the 8 rows an ldmatrix reads on 8 distinct 16-byte bank groups.
template <int HD>
__host__ __device__ constexpr int q_ld() {
  return HD + 8;
}

// Row stride (floats) of the warps' accumulators after the walk: 8 floats
// of padding put the 8 rows a warp's float2 stores meet on distinct banks.
template <int HD>
__host__ __device__ constexpr int acc_ld() {
  return HD + 8;
}

// Bytes the warps' triples take in the ring's memory after the walk.
template <int HD, int ROWS>
__host__ __device__ constexpr size_t merge_bytes() {
  return sizeof(float) * kCWarps * ROWS * (2 + acc_ld<HD>());
}

// Bytes of the ring's span: its stages, or the warps' triples after the
// walk if they take more.
template <int HD, int ROWS>
__host__ __device__ constexpr size_t span_bytes(int part, int stages) {
  const size_t ring = static_cast<size_t>(stages) * 4 * part * HD;
  return ring > merge_bytes<HD, ROWS>() ? ring : merge_bytes<HD, ROWS>();
}

// Ring decode's dynamic shared memory: the 1024-aligned ring and the slot
// mask.
template <int HD>
constexpr size_t smem_bytes(int part, int stages, int slots) {
  return 1024 + span_bytes<HD, 8>(part, stages) +
         static_cast<size_t>((slots + 31) / 32) * 4;
}

// Four outputs v / den, rounded once to bf16, as one 8-byte store.
__device__ __forceinline__ void store4(bf16* out, float4 v, float den) {
  const uint2 w = make_uint2(pack_bf16(v.x / den, v.y / den),
                             pack_bf16(v.z / den, v.w / den));
  *reinterpret_cast<uint2*>(out) = w;
}

// Steps 1-3 above.  Every thread of the CTA (kThreads) calls it after its
// source's prologue, whose shared-memory writes it orders before the
// walk.  `ring` is 1024-aligned, span_bytes<HD, ROWS>(P, ns) long; `bits`
// holds ns x kSlotWords words; `qs` 16 x q_ld<HD>() bf16 for ROWS 16.
// Query heads q0 .. q0 + Gc - 1 (Gc <= ROWS) are this cluster's.
template <int HD, int ROWS, class Src>
__device__ __forceinline__ void step(const Src& src, unsigned char* ring,
                                     uint32_t* bits, bf16* qs, int P, int ns,
                                     const bf16* __restrict__ q, size_t q0,
                                     int Gc, float scale,
                                     bf16* __restrict__ out,
                                     float* __restrict__ lse) {
  static_assert(ROWS == 8 || ROWS == 16, "heads are rows of the m16 tile");
  constexpr int NT = HD / 8;        // n8 tiles of a P V row
  constexpr int RH = ROWS / 8;      // rows a lane holds: g (and g + 8)
  constexpr int QLD = q_ld<HD>();
  constexpr int ALD = acc_ld<HD>();
  __shared__ __align__(16) float pacc[ROWS][HD];  // this CTA's acc
  __shared__ float m_s[ROWS], l_s[ROWS];
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];
  const int sb = 4 * P * HD;  // K then V boxes of a stage, bf16
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = gridDim.x, c = blockIdx.x;

  // the producer's copy of the source starts its loads (paged decode: the
  // table) while the barriers are made
  Src ps = src;
  if (warp == kCWarps) ps.begin(lane);
  if (tid == 0) {
    for (int s = 0; s < ns; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kCWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int count = src.count();

  if (warp == kCWarps) {
    // 1. producer: each live stage, in order
    int k = 0;
    for (int j = 0; j < count; ++j) {
      if (!ps.live(j)) continue;
      const int s = k % ns;
      ps.prepare(j, lane);
      if (k >= ns) mbar_wait(&empty[s], ((k / ns) - 1) & 1);
      ps.fill(j, ring + s * sb, &full[s], bits + s * kSlotWords, lane);
      ++k;
    }
    __syncwarp();
  } else {
    // 2. consumers: each warp's running softmax over its 16-slot groups
    const int g = lane >> 2, t4 = lane & 3;   // fragment row (head), pair
    const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, its row
    uint32_t qa[ROWS == 8 ? HD / 16 : 1][2];  // ROWS 8: Q's A fragments
    if constexpr (ROWS == 16) {
      // the Q tile, rows past Gc zero, staged by the consumers while the
      // producer's first copies are in flight
      for (int x = tid; x < 16 * HD / 8; x += kConsumers) {
        const int r = x / (HD / 8), col = x % (HD / 8) * 8;
        *reinterpret_cast<uint4*>(qs + r * QLD + col) =
            r < Gc
                ? *reinterpret_cast<const uint4*>(q + (q0 + r) * HD + col)
                : make_uint4(0, 0, 0, 0);
      }
      named_sync(1, kConsumers);
    } else {
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        const bf16* qr =
            q + (q0 + (g < Gc ? g : 0)) * HD + 16 * ks + 2 * t4;
        qa[ks][0] = g < Gc ? *reinterpret_cast<const uint32_t*>(qr) : 0u;
        qa[ks][1] =
            g < Gc ? *reinterpret_cast<const uint32_t*>(qr + 8) : 0u;
      }
    }
    float acc[NT][2 * RH];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2 * RH; ++e) acc[nt][e] = 0.f;
    // scores in the log2 domain: exp(x) = exp2(x log2 e)
    const float scale2 = scale * 1.4426950408889634f;
    float m_run[RH], l_part[RH];  // l over this lane's columns
#pragma unroll
    for (int r = 0; r < RH; ++r) {
      m_run[r] = neg_inf();
      l_part[r] = 0.f;
    }
    int k = 0;
    for (int j = 0; j < count; ++j) {
      if (!src.live(j)) continue;
      const int s = k % ns;
      const unsigned char* Ks = ring + s * sb;
      const unsigned char* Vs = Ks + 2 * P * HD;
      const uint32_t* sbits = bits + s * kSlotWords;
      mbar_wait(&full[s], (k / ns) & 1);
      for (int o = 16 * warp; o < P; o += 16 * kCWarps) {  // warp-uniform
        const unsigned gb = src.group(j, sbits, o);
        if (gb == 0) continue;
        // S = Q K^T over the group's 16 slots (n-tiles of 8), the even
        // and odd k-steps in two sums (two chains of products, not one)
        float sc[2][4] = {}, sd[2][4] = {};
#pragma unroll
        for (int ks = 0; ks < HD / 16; ++ks) {
          uint32_t kb[4];
          ldsm_x4(kb, reinterpret_cast<const bf16*>(
                          Ks + Src::off(P, o + (mi >> 1) * 8 + mr,
                                       16 * ks + (mi & 1) * 8)));
          uint32_t a[4];
          if constexpr (ROWS == 8) {
            a[0] = qa[ks][0];
            a[1] = 0u;
            a[2] = qa[ks][1];
            a[3] = 0u;
          } else {
            ldsm_x4(a, qs + ((mi & 1) * 8 + mr) * QLD + 16 * ks +
                           (mi >> 1) * 8);
          }
          float(&d)[2][4] = ks % 2 ? sd : sc;
          mma_bf16(d[0], a, kb[0], kb[1]);
          mma_bf16(d[1], a, kb[2], kb[3]);
        }
        // masked slots: -inf by a select on the bit; element e of a
        // fragment is row g + 8 (e / 2), column 8 nt + 2 t4 + e % 2
        float mx[RH];
#pragma unroll
        for (int r = 0; r < RH; ++r) mx[r] = neg_inf();
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2 * RH; ++e) {
            const bool ok = gb >> (8 * nt + 2 * t4 + e % 2) & 1u;
            sc[nt][e] = ok ? (sc[nt][e] + sd[nt][e]) * scale2 : neg_inf();
            mx[e / 2] = fmaxf(mx[e / 2], sc[nt][e]);
          }
        float alpha[RH], m_new[RH];
        bool moved = false;
#pragma unroll
        for (int r = 0; r < RH; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          m_new[r] = fmaxf(m_run[r], mx[r]);   // finite: a slot is valid
          alpha[r] = exp2f(m_run[r] - m_new[r]);  // 0 at the first group
          m_run[r] = m_new[r];
          moved = moved || alpha[r] != 1.f;
        }
        float pr[2][2 * RH];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2 * RH; ++e) {
            const float x = sc[nt][e];
            pr[nt][e] = x == neg_inf() ? 0.f : exp2f(x - m_new[e / 2]);
          }
#pragma unroll
        for (int r = 0; r < RH; ++r)
          l_part[r] = l_part[r] * alpha[r] +
                      (pr[0][2 * r] + pr[0][2 * r + 1]) +
                      (pr[1][2 * r] + pr[1][2 * r + 1]);
        if (__any_sync(0xffffffffu, moved)) {  // a row's max moved
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 2 * RH; ++e) acc[nt][e] *= alpha[e / 2];
        }
        // P V: P from the score registers (A: rows g, g + 8 x slots 2 t4,
        // 2 t4 + 1, then 8 + 2 t4, 9 + 2 t4); V's masked slots zeroed in
        // the fragments (b0: slots 2 t4, 2 t4 + 1; b1: 8 + 2 t4, 9 + 2 t4)
        const uint32_t pa[4] = {
            pack_bf16(pr[0][0], pr[0][1]),
            ROWS == 16 ? pack_bf16(pr[0][RH == 2 ? 2 : 0],
                                   pr[0][RH == 2 ? 3 : 1])
                       : 0u,
            pack_bf16(pr[1][0], pr[1][1]),
            ROWS == 16 ? pack_bf16(pr[1][RH == 2 ? 2 : 0],
                                   pr[1][RH == 2 ? 3 : 1])
                       : 0u};
        const uint32_t km0 = (gb >> (2 * t4) & 1u ? 0x0000ffffu : 0u) |
                             (gb >> (2 * t4 + 1) & 1u ? 0xffff0000u : 0u);
        const uint32_t km1 = (gb >> (2 * t4 + 8) & 1u ? 0x0000ffffu : 0u) |
                             (gb >> (2 * t4 + 9) & 1u ? 0xffff0000u : 0u);
#pragma unroll
        for (int n2 = 0; n2 < HD / 16; ++n2) {
          uint32_t vb[4];
          ldsm_x4_trans(vb, reinterpret_cast<const bf16*>(
                                Vs + Src::off(P, o + (mi & 1) * 8 + mr,
                                             16 * n2 + (mi >> 1) * 8)));
          float d0[4], d1[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            d0[e] = e < 2 * RH ? acc[2 * n2][e % (2 * RH)] : 0.f;
            d1[e] = e < 2 * RH ? acc[2 * n2 + 1][e % (2 * RH)] : 0.f;
          }
          mma_bf16(d0, pa, vb[0] & km0, vb[1] & km1);
          mma_bf16(d1, pa, vb[2] & km0, vb[3] & km1);
#pragma unroll
          for (int e = 0; e < 2 * RH; ++e) {
            acc[2 * n2][e] = d0[e];
            acc[2 * n2 + 1][e] = d1[e];
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      ++k;
    }
    // 3a. the warps' triples, in the ring's memory (every copy has landed
    // and been read), merged in order of warp into the CTA's
#pragma unroll
    for (int r = 0; r < RH; ++r) {
      l_part[r] += __shfl_xor_sync(0xffffffffu, l_part[r], 1);
      l_part[r] += __shfl_xor_sync(0xffffffffu, l_part[r], 2);
    }
    named_sync(1, kConsumers);
    float* wm = reinterpret_cast<float*>(ring);  // [kCWarps][ROWS]
    float* wl = wm + kCWarps * ROWS;
    float* wacc = wl + kCWarps * ROWS;           // [kCWarps][ROWS][ALD]
    if (t4 == 0) {
#pragma unroll
      for (int r = 0; r < RH; ++r) {
        wm[warp * ROWS + g + 8 * r] = m_run[r];
        wl[warp * ROWS + g + 8 * r] = l_part[r];
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < RH; ++r)
        *reinterpret_cast<float2*>(
            &wacc[(warp * ROWS + g + 8 * r) * ALD + 8 * nt + 2 * t4]) =
            make_float2(acc[nt][2 * r], acc[nt][2 * r + 1]);
    named_sync(1, kConsumers);
    // per head: M = max m, each warp's weight exp(m_w - M) (0 for a warp
    // that saw no valid slot) in place of its m, the CTA's l
    if (tid < Gc) {
      float M = neg_inf();
#pragma unroll
      for (int w = 0; w < kCWarps; ++w) M = fmaxf(M, wm[w * ROWS + tid]);
      float l = 0.f;
#pragma unroll
      for (int w = 0; w < kCWarps; ++w) {
        const float mw = wm[w * ROWS + tid];
        const float f = mw == neg_inf() ? 0.f : exp2f(mw - M);
        l += f * wl[w * ROWS + tid];
        wm[w * ROWS + tid] = f;
      }
      m_s[tid] = M;
      l_s[tid] = l;
    }
    named_sync(1, kConsumers);
    for (int d = tid; d < Gc * HD / 4; d += kConsumers) {  // 4 columns
      const int gg = d / (HD / 4), col = d % (HD / 4) * 4;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < kCWarps; ++w) {
        const float f = wm[w * ROWS + gg];
        const float4 v = *reinterpret_cast<const float4*>(
            &wacc[(w * ROWS + gg) * ALD + col]);
        a.x += f * v.x;
        a.y += f * v.y;
        a.z += f * v.z;
        a.w += f * v.w;
      }
      if (C == 1) {  // the CTA's triple is the output
        store4(out + (q0 + gg) * HD + col, a, fmaxf(l_s[gg], 1e-30f));
        if (lse != nullptr && col == 0)  // back from the log2 domain
          lse[q0 + gg] = m_s[gg] == neg_inf()
                             ? neg_inf()
                             : (m_s[gg] + log2f(l_s[gg])) *
                                   0.6931471805599453f;
      } else {
        *reinterpret_cast<float4*>(&pacc[gg][col]) = a;
      }
    }
  }
  if (C == 1) return;

  // 3b. the cluster's merge, in order of rank: M = max m over the ranks,
  // their weights exp(m_r - M) (0 for a CTA that saw no valid slot); all
  // of an element's loads from the other CTAs are in flight at once
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int e = c * kThreads + tid; e < Gc * HD / 4; e += C * kThreads) {
    const int gg = e / (HD / 4), col = e % (HD / 4) * 4;  // 4 columns
    float mr[kMaxCluster], lr[kMaxCluster];
    float4 ar[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < C) {
        mr[r] = *cluster.map_shared_rank(&m_s[gg], r);
        lr[r] = *cluster.map_shared_rank(&l_s[gg], r);
        ar[r] = *cluster.map_shared_rank(
            reinterpret_cast<float4*>(&pacc[gg][col]), r);
      }
    }
    float M = neg_inf();
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < C) M = fmaxf(M, mr[r]);
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
    float den = 0.f;
    if (M != neg_inf()) {
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        if (r >= C || mr[r] == neg_inf()) continue;
        const float w = exp2f(mr[r] - M);
        num.x += w * ar[r].x;
        num.y += w * ar[r].y;
        num.z += w * ar[r].z;
        num.w += w * ar[r].w;
        den += w * lr[r];
      }
    }
    store4(out + (q0 + gg) * HD + col, num, fmaxf(den, 1e-30f));
    if (lse != nullptr && col == 0)  // back from the log2 domain
      lse[q0 + gg] = M == neg_inf() ? neg_inf()
                                    : (M + log2f(den)) * 0.6931471805599453f;
  }
  cluster.sync();  // no CTA leaves while another reads its triple
}

// Ring decode's source: the CTA's partitions [pa, pa + npart) of P slots,
// their bits in one mask over the CTA's slots (the kernel's prologue).
template <int HD>
struct RingSrc {
  const CUtensorMap *kmap, *vmap;
  const uint32_t* mask;
  int P, pa, npart, h, b;

  __device__ int count() const { return npart; }
  __device__ bool live(int j) const {
    unsigned any = 0;
    for (int w = j * P / 32; w < (j + 1) * P / 32; ++w) any |= mask[w];
    return any != 0;
  }
  __device__ unsigned group(int j, const uint32_t*, int o) const {
    const int l0 = j * P + o;  // the group's first slot in the mask
    return mask[l0 >> 5] >> (l0 & 31) & 0xffffu;
  }
  static __device__ __forceinline__ int off(int rows, int row, int col) {
    return swz<HD>(rows, row, col);
  }
  __device__ void begin(int lane) const {
    if (lane == 0) {
      tma_prefetch(kmap);
      tma_prefetch(vmap);
    }
  }
  __device__ void prepare(int, int) const {}
  // K and V boxes of partition j, by lane 0
  __device__ void fill(int j, unsigned char* st, uint64_t* full, uint32_t*,
                       int lane) const {
    using X = Boxes<HD>;
    if (lane != 0) return;
    mbar_arrive_tx(full, 4 * P * HD);
#pragma unroll
    for (int x = 0; x < X::kCount; ++x) {
      tma_load_3d(st + x * P * X::kRowBytes, kmap, full,
                  h * HD + x * X::kCols, (pa + j) * P, b);
      tma_load_3d(st + 2 * P * HD + x * P * X::kRowBytes, vmap, full,
                  h * HD + x * X::kCols, (pa + j) * P, b);
    }
  }
};

// Two CTAs an SM up to hd 128; at hd 192 and 256 one, whose registers
// hold the longer rows' fragments without spilling.
template <int HD>
__global__ void __launch_bounds__(kThreads, HD <= 128 ? 2 : 1)
    ring_decode_kernel(
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const bf16* __restrict__ q,
    const int* __restrict__ slot_pos, const int* __restrict__ pos_ptr,
    int pos_host, bf16* __restrict__ out, float* __restrict__ lse, int K,
    int G, int S, int P, int ns, int window, float scale) {
  extern __shared__ unsigned char dyn[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(dyn) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = gridDim.x, c = blockIdx.x;
  const int groups = (G + kMaxG - 1) / kMaxG;
  const int grp = blockIdx.y % groups, bh = blockIdx.y / groups;
  const int b = bh / K, h = bh % K;
  const int g0 = grp * kMaxG, Gc = min(kMaxG, G - g0);
  const int pos = pos_ptr != nullptr ? *pos_ptr : pos_host;
  const int np = (S + P - 1) / P, per = (np + C - 1) / C;
  const int pa = min(np, c * per), npart = min(np, pa + per) - pa;
  const int s0 = pa * P;
  const int words = npart * P / 32;
  uint32_t* mask =
      reinterpret_cast<uint32_t*>(ring + span_bytes<HD, 8>(P, ns));

  // prologue: the CTA's slots as bits, 4 a lane (one 16-byte load of
  // slot_pos where it is aligned and whole), 8 lanes a 32-slot word
  auto attended = [&](int t) {
    const int sp = t < S ? slot_pos[t] : -1;
    return sp >= 0 && sp <= pos && (window <= 0 || sp > pos - window);
  };
  const bool vec = (reinterpret_cast<uintptr_t>(slot_pos) & 15) == 0;
#pragma unroll 4
  for (int w4 = warp; 4 * w4 < words; w4 += kThreads / 32) {
    const int t = s0 + 128 * w4 + 4 * lane;
    unsigned nib = 0;
    if (vec && t + 3 < S) {
      const int4 v = *reinterpret_cast<const int4*>(slot_pos + t);
      const int sp[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        nib |= (sp[e] >= 0 && sp[e] <= pos &&
                (window <= 0 || sp[e] > pos - window)) << e;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) nib |= attended(t + e) << e;
    }
    unsigned bits = nib << (4 * (lane & 7));
    bits |= __shfl_xor_sync(0xffffffffu, bits, 1);
    bits |= __shfl_xor_sync(0xffffffffu, bits, 2);
    bits |= __shfl_xor_sync(0xffffffffu, bits, 4);
    const int w = 4 * w4 + lane / 8;
    if ((lane & 7) == 0 && w < words) mask[w] = bits;
  }
  const RingSrc<HD> src{&kmap, &vmap, mask, P, pa, npart, h, b};
  step<HD, 8>(src, ring, nullptr, nullptr, P, ns, q,
              static_cast<size_t>(bh) * G + g0, Gc, scale, out, lse);
}

}  // namespace ring
}  // namespace rt
