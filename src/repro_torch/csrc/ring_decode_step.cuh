// The bf16 ring decode step (decode_attn.cu): one launch, a cluster per
// (row, kv head, group of at most 8 query heads), its CTAs walking the
// ring's partitions through a pipelined shared-memory ring and merging
// their (max, sum, unnormalised output) triples through distributed shared
// memory.
//
// Grid (C, B x K x groups), clusters of (C, 1, 1).  CTA c of a cluster
// walks partitions [c per, (c + 1) per) of P slots (per = ceil(NP / C)):
//
//  1. Prologue, once per CTA: every thread tests a share of the CTA's
//     slots against slot_pos (valid if 0 <= slot_pos <= pos, and > pos -
//     window with a window; slots past S are not) into a bit mask in
//     shared memory, 4 slots a lane from one 16-byte load.  A partition
//     with no bit set is *dead*: the producer copies nothing for it and the
//     consumers skip it, in the same order, so the ring's stages stay in
//     step.
//  2. The producer warp keeps up to NS stages of a live partition's K and
//     V in flight by TMA: the cache (B, S, K, hd) is a 3-D map (K hd, S,
//     B), and one kv head's P slots land as hd / 64 boxes of 64 columns x
//     P rows under the 128-byte swizzle (hd 32: one box of 32 columns,
//     64-byte swizzle), so the consumers' ldmatrix hits every bank once.
//     Slots past S arrive as zeros.  The consumers release a stage on its
//     "empty" mbarrier.
//  3. The four consumer warps split each partition into 16-slot groups
//     (warp w takes groups w, w + 4, ...) and keep, per warp, a running
//     float32 (m, l, acc) for the (at most 8) query heads over every group
//     they take.  On the tensor cores (mma.sync.m16n8k16, bf16 operands,
//     float32 sums; the heads are the rows of the m16 tile, rows 8-15
//     zero): S = Q K^T for the group's 16 slots, Q's fragments in
//     registers for the whole walk and K's by ldmatrix; the group's max
//     raises m (acc and l scaled by exp(m_old - m_new), skipped where no
//     row's max moved; scores in the log2 domain, exp2 of score x log2 e,
//     one MUFU op); P, rounded to bf16 as the Pallas kernel rounds it, is
//     the A operand of P V straight from the score registers, V's
//     fragments by ldmatrix.trans.
//     A TMA box copies a masked slot whole: a ring slot past pos holds a
//     stale lap, a fresh cache anything, NaN included.  So masking
//     *selects*: a masked slot's score is -inf by a select on its bit (not
//     on its value), its probability exactly 0, and its V elements are
//     zeroed in the fragment registers by a select before the product,
//     never multiplied by 0.  A group with no valid slot is skipped.
//  4. The four warps' triples merge in shared memory into the CTA's, in
//     order of warp; the cluster syncs; CTA c merges elements c x 160 + t,
//     ... of the G x hd outputs over the C triples in order of rank (M =
//     max m, weights exp(m_q - M), 0 for a CTA that saw no valid slot),
//     divides by max(sum w l, 1e-30), rounds once to bf16 and, when asked,
//     writes the log-sum-exp M + log(sum w l) (-inf for a row and head
//     with no valid slot, whose output is exact zeros).  The order is
//     fixed: the output is bitwise the same run to run.
//
// plan() picks C and P per shape: P slots of 32 KB of K and V a stage
// (64 at hd 128, 128 at hd 64 and below, 32 at hd 192 and 256), NS = 3
// stages, and C (a power of two, 1..8, at most half the partitions) the
// largest that keeps the grid within one CTA an SM: a cluster that does
// not fit beside the others waits for a second wave, which costs a whole
// CTA's walk (at two CTAs an SM the clusters of 2 x 32768 slots did not
// all fit; chip_variants.py 6).  So latency-bound shapes (one kv head, a
// short ring) get 8 CTAs a pair, Llama-2-7B's 3 rows one CTA a pair over
// 9 partitions, and 2 rows x 32768 slots (64 pairs) 2 CTAs of 256
// partitions each.
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
constexpr int kMaxG = decode::kMaxG;         // query heads a cluster
constexpr int kMaxStages = 4;
constexpr int kMaxCluster = 8;
constexpr int kMaxRange = 65536;             // slots a CTA walks at most
constexpr int kStageBytes = 32 * 1024;       // K and V of one partition
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

// Bytes of dynamic shared memory: the 1024-aligned ring and the slot mask.
template <int HD>
constexpr size_t smem_bytes(int part, int stages, int slots) {
  return 1024 + static_cast<size_t>(stages) * 4 * part * HD +
         static_cast<size_t>((slots + 31) / 32) * 4;
}

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
  using X = Boxes<HD>;
  constexpr int NT = HD / 8;  // n8 tiles of a P V row
  extern __shared__ unsigned char dyn[];
  __shared__ __align__(16) float pacc[kMaxG][HD];  // this CTA's acc
  __shared__ float m_s[kMaxG], l_s[kMaxG];
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(dyn) + 1023) & ~uintptr_t(1023));
  const int sb = 4 * P * HD;  // K then V boxes of a stage, bf16
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = gridDim.x, c = blockIdx.x;
  const int groups = (G + kMaxG - 1) / kMaxG;
  const int grp = blockIdx.y % groups, bh = blockIdx.y / groups;
  const int b = bh / K, h = bh % K;
  const int g0 = grp * kMaxG, Gc = min(kMaxG, G - g0);
  const size_t q0 = static_cast<size_t>(bh) * G + g0;  // first query row
  const int pos = pos_ptr != nullptr ? *pos_ptr : pos_host;
  const int np = (S + P - 1) / P, per = (np + C - 1) / C;
  const int pa = min(np, c * per), npart = min(np, pa + per) - pa;
  const int s0 = pa * P;
  const int words = npart * P / 32;
  uint32_t* mask = reinterpret_cast<uint32_t*>(ring + ns * sb);

  // 1. prologue: the CTA's slots as bits, 4 a lane (one 16-byte load of
  // slot_pos where it is aligned and whole), 8 lanes a 32-slot word; then
  // the barriers
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
  if (tid == 0) {
    for (int s = 0; s < ns; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kCWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();
  auto live = [&](int j) {
    unsigned any = 0;
    for (int w = j * P / 32; w < (j + 1) * P / 32; ++w) any |= mask[w];
    return any != 0;
  };

  if (warp == kCWarps) {
    // 2. producer: K and V boxes of each live partition, in order
    if (lane == 0) {
      tma_prefetch(&kmap);
      tma_prefetch(&vmap);
      int k = 0;
      for (int j = 0; j < npart; ++j) {
        if (!live(j)) continue;
        const int s = k % ns;
        if (k >= ns) mbar_wait(&empty[s], ((k / ns) - 1) & 1);
        unsigned char* st = ring + s * sb;
        mbar_arrive_tx(&full[s], sb);
#pragma unroll
        for (int x = 0; x < X::kCount; ++x) {
          tma_load_3d(st + x * P * X::kRowBytes, &kmap, &full[s],
                      h * HD + x * X::kCols, (pa + j) * P, b);
          tma_load_3d(st + 2 * P * HD + x * P * X::kRowBytes, &vmap,
                      &full[s], h * HD + x * X::kCols, (pa + j) * P, b);
        }
        ++k;
      }
    }
    __syncwarp();
  } else {
    // 3. consumers: each warp's running softmax over its 16-slot groups
    const int g = lane >> 2, t4 = lane & 3;   // fragment row (head), pair
    const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, its row
    uint32_t qa[HD / 16][2];  // Q's A fragments: row g, rows 8-15 zero
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      const bf16* qr = q + (q0 + (g < Gc ? g : 0)) * HD + 16 * ks + 2 * t4;
      qa[ks][0] = g < Gc ? *reinterpret_cast<const uint32_t*>(qr) : 0u;
      qa[ks][1] = g < Gc ? *reinterpret_cast<const uint32_t*>(qr + 8) : 0u;
    }
    float acc[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = 0.f;
    // scores in the log2 domain: exp(x) = exp2(x log2 e)
    const float scale2 = scale * 1.4426950408889634f;
    float m_run = neg_inf(), l_part = 0.f;  // l over this lane's columns
    int k = 0;
    for (int j = 0; j < npart; ++j) {
      if (!live(j)) continue;
      const int s = k % ns;
      const unsigned char* Ks = ring + s * sb;
      const unsigned char* Vs = Ks + 2 * P * HD;
      mbar_wait(&full[s], (k / ns) & 1);
      for (int o = 16 * warp; o < P; o += 16 * kCWarps) {  // warp-uniform
        const int l0 = j * P + o;  // the group's first slot in the mask
        const unsigned gb = mask[l0 >> 5] >> (l0 & 31) & 0xffffu;
        if (gb == 0) continue;
        // S = Q K^T over the group's 16 slots (n-tiles of 8), the even
        // and odd k-steps in two sums (two chains of products, not one)
        float sc[2][4] = {}, sd[2][4] = {};
#pragma unroll
        for (int ks = 0; ks < HD / 16; ++ks) {
          uint32_t kb[4];
          ldsm_x4(kb, reinterpret_cast<const bf16*>(
                          Ks + swz<HD>(P, o + (mi >> 1) * 8 + mr,
                                       16 * ks + (mi & 1) * 8)));
          const uint32_t a[4] = {qa[ks][0], 0u, qa[ks][1], 0u};
          float(&d)[2][4] = ks % 2 ? sd : sc;
          mma_bf16(d[0], a, kb[0], kb[1]);
          mma_bf16(d[1], a, kb[2], kb[3]);
        }
        // masked slots: -inf by a select on the bit
        float mx = neg_inf();
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool ok = gb >> (8 * nt + 2 * t4 + e) & 1u;
            sc[nt][e] = ok ? (sc[nt][e] + sd[nt][e]) * scale2 : neg_inf();
            mx = fmaxf(mx, sc[nt][e]);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run, mx);   // finite: a slot is valid
        const float alpha = exp2f(m_run - m_new);  // 0 at the first group
        m_run = m_new;
        float pr[2][2];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = sc[nt][e];
            pr[nt][e] = x == neg_inf() ? 0.f : exp2f(x - m_new);
          }
        l_part = l_part * alpha + (pr[0][0] + pr[0][1]) +
                 (pr[1][0] + pr[1][1]);
        if (!__all_sync(0xffffffffu, alpha == 1.f)) {  // a row's max moved
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            acc[nt][0] *= alpha;
            acc[nt][1] *= alpha;
          }
        }
        // P V: P from the score registers; V's masked slots zeroed in the
        // fragments (b0: slots 2 t4, 2 t4 + 1; b1: 8 + 2 t4, 9 + 2 t4)
        const uint32_t pa[4] = {pack_bf16(pr[0][0], pr[0][1]), 0u,
                                pack_bf16(pr[1][0], pr[1][1]), 0u};
        const uint32_t km0 = (gb >> (2 * t4) & 1u ? 0x0000ffffu : 0u) |
                             (gb >> (2 * t4 + 1) & 1u ? 0xffff0000u : 0u);
        const uint32_t km1 = (gb >> (2 * t4 + 8) & 1u ? 0x0000ffffu : 0u) |
                             (gb >> (2 * t4 + 9) & 1u ? 0xffff0000u : 0u);
#pragma unroll
        for (int n2 = 0; n2 < HD / 16; ++n2) {
          uint32_t vb[4];
          ldsm_x4_trans(vb, reinterpret_cast<const bf16*>(
                                Vs + swz<HD>(P, o + (mi & 1) * 8 + mr,
                                             16 * n2 + (mi >> 1) * 8)));
          float d0[4] = {acc[2 * n2][0], acc[2 * n2][1], 0.f, 0.f};
          float d1[4] = {acc[2 * n2 + 1][0], acc[2 * n2 + 1][1], 0.f, 0.f};
          mma_bf16(d0, pa, vb[0] & km0, vb[1] & km1);
          mma_bf16(d1, pa, vb[2] & km0, vb[3] & km1);
          acc[2 * n2][0] = d0[0];
          acc[2 * n2][1] = d0[1];
          acc[2 * n2 + 1][0] = d1[0];
          acc[2 * n2 + 1][1] = d1[1];
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      ++k;
    }
    // 4a. the warps' triples, in the ring's memory (every copy has landed
    // and been read), merged in order of warp into the CTA's
    l_part += __shfl_xor_sync(0xffffffffu, l_part, 1);
    l_part += __shfl_xor_sync(0xffffffffu, l_part, 2);
    named_sync(1, kConsumers);
    float* wm = reinterpret_cast<float*>(ring);  // [kCWarps][kMaxG]
    float* wl = wm + kCWarps * kMaxG;
    float* wacc = wl + kCWarps * kMaxG;          // [kCWarps][kMaxG][HD]
    if (t4 == 0) {
      wm[warp * kMaxG + g] = m_run;
      wl[warp * kMaxG + g] = l_part;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      *reinterpret_cast<float2*>(
          &wacc[(warp * kMaxG + g) * HD + 8 * nt + 2 * t4]) =
          make_float2(acc[nt][0], acc[nt][1]);
    named_sync(1, kConsumers);
    for (int d = tid; d < Gc * HD; d += kConsumers) {
      const int gg = d / HD, col = d % HD;
      float M = neg_inf();
#pragma unroll
      for (int w = 0; w < kCWarps; ++w) M = fmaxf(M, wm[w * kMaxG + gg]);
      float a = 0.f, l = 0.f;
      if (M != neg_inf()) {
#pragma unroll
        for (int w = 0; w < kCWarps; ++w) {
          const float mw = wm[w * kMaxG + gg];
          if (mw == neg_inf()) continue;
          const float f = exp2f(mw - M);
          a += f * wacc[(w * kMaxG + gg) * HD + col];
          l += f * wl[w * kMaxG + gg];
        }
      }
      pacc[gg][col] = a;
      if (col == 0) {
        m_s[gg] = M;
        l_s[gg] = l;
      }
    }
  }

  // 4b. the cluster's merge, in order of rank
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int e = c * kThreads + tid; e < Gc * HD; e += C * kThreads) {
    const int gg = e / HD, col = e % HD;
    float mr[kMaxCluster], ar[kMaxCluster], lr[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < C) {
        mr[r] = *cluster.map_shared_rank(&m_s[gg], r);
        ar[r] = *cluster.map_shared_rank(&pacc[gg][col], r);
        lr[r] = *cluster.map_shared_rank(&l_s[gg], r);
      }
    }
    float M = neg_inf();
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < C) M = fmaxf(M, mr[r]);
    float num = 0.f, den = 0.f;
    if (M != neg_inf()) {
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        if (r >= C || mr[r] == neg_inf()) continue;
        const float w = exp2f(mr[r] - M);
        num += w * ar[r];
        den += w * lr[r];
      }
    }
    out[(q0 + gg) * HD + col] = __float2bfloat16(num / fmaxf(den, 1e-30f));
    if (lse != nullptr && col == 0)  // back from the log2 domain
      lse[q0 + gg] = M == neg_inf() ? neg_inf()
                                    : (M + log2f(den)) * 0.6931471805599453f;
  }
  cluster.sync();  // no CTA leaves while another reads its triple
}

}  // namespace ring
}  // namespace rt
