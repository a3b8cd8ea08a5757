// Chunked paged prefill GQA attention with an in-kernel block-table walk.
//
// Replaces: src/repro/kernels/paged_prefill/prefill_attn.py:52,
// `_prefill_kernel` under `paged_prefill_attention` (its pl.pallas_call at
// :136).
//
// Bound on this card: bytes for the shapes the serving path gives it.  A
// chunk of C = 64 queries per row attends over the row's whole paged
// history; the call must read each live history key and value once (16 KiB
// per token per layer at Llama-2-7B widths, bf16) and does ~4*C*G flops
// per key byte pair: below the bf16 tensor-core ridge (~295 per byte) up
// to G = 1, so the ideal kernel is memory-bound (9.2 us of bytes against
// 1.7 us of products at 4 rows x 64 queries over 1632 keys; Mixtral's
// G = 6 over 4096 keys 26.1 us).  What stands in its way is the walk's
// latency: each CTA walks one (row, kv head)'s history alone.
//
// Design: one CTA per (row, kv head, tile of query-head rows, key
// partition).  Tile row r is query r / G of query head h * G + r % G, so
// all G heads of a kv head share the staged keys (GQA without K/V
// replication), and a tile holds 64 / G or 128 / G queries.  The CTA walks
// logical key positions from the first one its window can see (rounded
// down to a stage boundary) up to its last query — keys wholly in the
// future or wholly outside the window are never visited — in stages of KT
// keys.  Queries sit at start[b] + c; the kernel also receives the
// positions the plain version would take and traps unless they are that
// contiguous run (a trap, not an assert: a call in the kernel would
// serialise its wgmma).
//
// Which tile step (prefill_tile.cuh) runs is set by the dtype:
//  * bf16: the Hopper step, rt::tile::wg.  The producer warpgroup's first
//    warp walks the block table: lane i takes piece i of a stage, R =
//    gcd(bs, KT) keys of one block, and copies it with TMA from the pool
//    (a 2-d map over (hd, K * NB * bs), boxes of 64 columns x R keys); a
//    piece past the tile's last query or under a -1 table entry is
//    zero-filled instead, so no stale or never-written shared memory
//    reaches P V.  A box must start on the swizzle's 1 KB period, so where
//    R is not a multiple of 8 (a block size such as 4 or 12) the warp
//    copies the stage key by key with cp.async into the same slots, with
//    zero-fill, and waits for it before it arrives (3.5-4.4x the time of
//    blocks of 16 at Llama-2-7B's widths, chip_smoke.py phase 3).  The
//    stage's key positions (-1 for a key not read) go to the masks.  Tile
//    rule (wg::tile_rows over the walk the launcher knows
//    of: the table's span, or the window and the chunk): 128 rows where
//    there are 128 and hd is 192 or 256, or 128 over 512 keys or more;
//    else 64 — so Llama's C = 64, G = 1 takes one consumer warpgroup, two
//    CTAs an SM, and G = 4, 6, 12 and 16 take 128-row tiles (the history
//    read once per 128 / G queries, where a 64-row tile reads it once
//    per 64 / G).
//    Key partitions: where four times the grid (rows x kv heads x tiles)
//    still fits one CTA an SM, the walk is split into up to 4 parts of
//    whole stages, each of 512 keys or more of the longest walk the
//    launcher knows of (partitions(), read by the wrapper through
//    paged_prefill_partitions).  Each part writes its unnormalised rows,
//    max and sum in float32 to the wrapper's scratch, and
//    prefill_split_merge merges them by log-sum-exp
//    (rt::split_kv_merge_row), rounding once.  Of the serving shapes only
//    RecurrentGemma-9B's (one kv head: 32 CTAs for 4 rows) is split, in
//    4; Llama-2-7B's, Mixtral-8x22B's and Nemotron-4's grids of 64-192
//    CTAs are not: there the merge cost more than the split saved.
//    Shared memory and registers per head dim: prefill_tile.cuh (+4 bytes
//    a key of positions a stage).
//  * float32: the CUDA-core step of 256 threads, 64-row tiles, with scalar
//    loads staged synchronously into float32 rows (164 KB at hd 192, 213
//    KB at hd 256); no partitions.
#include <algorithm>
#include <cmath>

#include "prefill_tile.cuh"

namespace {

using rt::tile::kKT;
using rt::tile::kM;
using bf16 = __nv_bfloat16;

// ------------------------------------------------------------- float32
template <int HD>
constexpr size_t smem_bytes_f32() {
  return rt::tile::smem_floats<HD>() * sizeof(float) +
         kKT * (sizeof(long long) + sizeof(int));
}

template <int HD>
__global__ void __launch_bounds__(rt::tile::kThreads) paged_prefill_f32(
    const float* __restrict__ q, const float* __restrict__ kp,
    const float* __restrict__ vp, const int* __restrict__ tbl,
    const int* __restrict__ start, const int* __restrict__ q_pos,
    float* __restrict__ out, int C, int K, int G, int NB, int bs, int MB,
    int window, float scale) {
  using rt::tile::kLDP;
  using rt::tile::kRPT;
  using rt::tile::kThreads;
  constexpr int LD = HD + 4;     // padded row stride of Qs / Ks / Vs
  constexpr int DPT = HD / 16;   // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                               // [kM][LD]
  float* Ks = Qs + kM * LD;                       // [kKT][LD]
  float* Vs = Ks + kKT * LD;                      // [kKT][LD]
  float* Ps = Vs + kKT * LD;                      // [kKT][kLDP]
  long long* koff = reinterpret_cast<long long*>(Ps + kKT * kLDP);
  int* kpos = reinterpret_cast<int*>(koff + kKT);  // -1 = masked key

  const int b = blockIdx.x / K, h = blockIdx.x % K;
  const int H = K * G, rows = C * G;
  const int r0 = blockIdx.y * kM;
  const int r_end = min(rows, r0 + kM);  // exclusive
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int st = start[b];
  const int q_first = st + r0 / G;
  const int q_last = st + (r_end - 1) / G;

  for (int c = r0 / G + tid; c <= (r_end - 1) / G; c += kThreads)
    assert(q_pos[static_cast<size_t>(b) * C + c] == st + c);
  for (int i = tid; i < kM * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, rr = r0 + r;
    float v = 0.f;
    if (rr < r_end) {
      const int c = rr / G, hq = h * G + rr % G;
      v = q[((static_cast<size_t>(b) * C + c) * H + hq) * HD + d];
    }
    Qs[r * LD + d] = v;
  }

  int qp[kRPT];  // absolute position of each owned row; -1 for a dead row
#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    const int rr = r0 + ty * kRPT + i;
    qp[i] = rr < r_end ? st + rr / G : -1;
  }
  rt::tile::Rows<HD> rows_st;
  rows_st.init();

  const int t_lo = window > 0 ? max(0, q_first - window + 1) : 0;
  const int t_hi = min(q_last, MB * bs - 1);  // inclusive
  for (int k0 = t_lo; k0 <= t_hi; k0 += kKT) {
    __syncthreads();  // the previous stage is done with Ks / Vs / Ps
    if (tid < kKT) {
      const int t = k0 + tid;
      int ok = -1;
      long long off = 0;
      if (t <= t_hi) {
        const int phys = tbl[b * MB + t / bs];
        assert(phys < NB);
        if (phys >= 0) {
          ok = t;
          off = ((static_cast<long long>(h) * NB + phys) * bs + t % bs) * HD;
        }
      }
      kpos[tid] = ok;
      koff[tid] = off;
    }
    __syncthreads();
    for (int i = tid; i < kKT * HD; i += kThreads) {
      const int kk = i / HD, d = i % HD;
      float kv = 0.f, vv = 0.f;
      if (kpos[kk] >= 0) {
        kv = kp[koff[kk] + d];
        vv = vp[koff[kk] + d];
      }
      Ks[kk * LD + d] = kv;
      Vs[kk * LD + d] = vv;
    }
    __syncthreads();
    rt::tile::attend_stage<HD>(
        Qs, Ks, Vs, Ps, scale,
        [&](int i, int j) {
          const int t = kpos[tx + 16 * j];
          bool ok = t >= 0 && t <= qp[i];
          if (window > 0) ok = ok && t > qp[i] - window;
          return ok;
        },
        rows_st);
  }

#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    const int rr = r0 + ty * kRPT + i;
    if (rr >= r_end) continue;
    const int c = rr / G, hq = h * G + rr % G;
    float* o = out + ((static_cast<size_t>(b) * C + c) * H + hq) * HD;
#pragma unroll
    for (int e = 0; e < DPT; ++e) o[tx + 16 * e] = rows_st.out(i, e);
  }
}

// ------------------------------------------------------------ bfloat16
template <int HD, int NWG>
using CfgBf16 = rt::tile::wg::Cfg<HD, NWG, true>;

template <int HD, int NWG>
__global__ void __launch_bounds__(CfgBf16<HD, NWG>::kThreads,
                                  CfgBf16<HD, NWG>::kOcc)
    paged_prefill_bf16(const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const bf16* __restrict__ kpool,
                       const bf16* __restrict__ vpool,
                       const bf16* __restrict__ q, const int* __restrict__ tbl,
                       const int* __restrict__ start,
                       const int* __restrict__ q_pos, bf16* __restrict__ out,
                       float* __restrict__ part_acc,
                       float* __restrict__ part_m,
                       float* __restrict__ part_l, int C, int K, int G,
                       int NB, int bs, int MB, int window, int R,
                       float scale_log2) {
  namespace wg = rt::tile::wg;
  using Cf = CfgBf16<HD, NWG>;
  constexpr int KT = Cf::KT;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const wg::Smem<Cf> sm(smem_raw);

  const int b = blockIdx.x / K, h = blockIdx.x % K;
  const int H = K * G, rows = C * G;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * Cf::kM;  // longest first
  const int r_end = min(rows, r0 + Cf::kM);               // exclusive
  const int st0 = start[b];
  const int q_first = st0 + r0 / G, q_last = st0 + (r_end - 1) / G;
  const int t_lo = window > 0 ? max(0, q_first - window + 1) / KT * KT : 0;
  const int t_hi = min(q_last, MB * bs - 1);  // inclusive
  const int n = t_hi >= t_lo ? (t_hi - t_lo) / KT + 1 : 0;
  // key partition blockIdx.z of gridDim.z walks stages [s0, s1)
  const int S = gridDim.z, p = blockIdx.z;
  const int s0 = p * n / S, s1 = (p + 1) * n / S;
  sm.init_barriers();

  if (threadIdx.x < 128) {  // the producer warpgroup: its first warp
    wg::producer_regs<Cf>();
    const CUtensorMap *kp = &kmap, *vp = &vmap;
    if (threadIdx.x == 0) {
      rt::tma_prefetch(kp);
      rt::tma_prefetch(vp);
    }
    const int lane = threadIdx.x;
    if (lane < 32)
      wg::produce<Cf>(s0, s1, sm, [&](int s, int slot) {
        if (R % 8) {
          // no TMA box fits a piece (it would not start on the swizzle's
          // 1 KB period): the warp copies the stage key by key with
          // cp.async into the same swizzled slots, zero-filling the keys
          // it does not read, and arrives once they have landed
          constexpr int CH = HD / 8;
          for (int c = lane; c < KT * CH; c += 32) {
            const int kk = c / CH, ch = c % CH, t = t_lo + s * KT + kk;
            const int phys = t <= t_hi ? tbl[b * MB + t / bs] : -1;
            if (phys >= NB) __trap();  // a table entry past the pool
            if (ch == 0) sm.kpos[slot * KT + kk] = phys >= 0 ? t : -1;
            const size_t src =
                phys >= 0
                    ? ((static_cast<size_t>(h) * NB + phys) * bs + t % bs) *
                              HD +
                          ch * 8
                    : 0;
            const uint32_t off =
                slot * Cf::kTileBytes + wg::chunk_offset<Cf>(KT, kk, ch);
            rt::cp_async16(sm.k + off, kpool + src, phys >= 0);
            rt::cp_async16(sm.v + off, vpool + src, phys >= 0);
          }
          rt::cp_async_commit();
          rt::cp_async_wait<0>();
          rt::fence_proxy_async();
          __syncwarp();
          if (lane == 0) rt::mbar_arrive(&sm.full[slot]);
          return;
        }
        // lane i takes piece i of the stage: R keys of one table block (R
        // divides bs and KT), one TMA box per SW columns of K and of V;
        // a piece wholly past t_hi or under a -1 entry is zero-filled
        // instead.  Its keys' positions go to the masks: -1 for a key
        // past t_hi or not read.
        const int pieces = KT / R, t = t_lo + s * KT + lane * R;
        int phys = -1;
        if (lane < pieces && t <= t_hi) {
          phys = tbl[b * MB + t / bs];
          if (phys >= NB) __trap();  // a table entry past the pool
        }
        if (lane < pieces)
          for (int i = 0; i < R; ++i)
            sm.kpos[slot * KT + lane * R + i] =
                phys >= 0 && t + i <= t_hi ? t + i : -1;
        const unsigned read = __ballot_sync(0xffffffffu, phys >= 0);
        for (int i = 0; i < pieces; ++i) {
          if ((read >> i) & 1u) continue;
#pragma unroll
          for (int j = 0; j < Cf::NCH; ++j)
            for (int c = lane; c < R * Cf::SWB / 16; c += 32) {
              const int off = slot * Cf::kTileBytes + j * KT * Cf::SWB +
                              i * R * Cf::SWB + c * 16;
              *reinterpret_cast<uint4*>(sm.k + off) = make_uint4(0, 0, 0, 0);
              *reinterpret_cast<uint4*>(sm.v + off) = make_uint4(0, 0, 0, 0);
            }
        }
        rt::fence_proxy_async();
        __syncwarp();
        if (lane == 0)
          rt::mbar_arrive_tx(&sm.full[slot],
                             __popc(read) * 2 * Cf::NCH * R * Cf::SWB);
        if (phys >= 0) {
          const int row = (h * NB + phys) * bs + t % bs;
#pragma unroll
          for (int j = 0; j < Cf::NCH; ++j) {
            const int off =
                slot * Cf::kTileBytes + j * KT * Cf::SWB + lane * R * Cf::SWB;
            rt::tma_load_2d(sm.k + off, kp, &sm.full[slot], j * Cf::SW, row);
            rt::tma_load_2d(sm.v + off, vp, &sm.full[slot], j * Cf::SW, row);
          }
        }
      });
  } else {  // the consumer warpgroups
    wg::consumer_regs<Cf>();
    const int w = threadIdx.x / 128 - 1, tid = threadIdx.x & 127;
    const int lane = tid & 31;
    // the positions must be the contiguous run from start[b] (a trap, not
    // an assert: a call in the kernel would serialise its wgmma)
    for (int c = r0 / G + 128 * w + tid; c <= (r_end - 1) / G; c += 128 * NWG)
      if (q_pos[static_cast<size_t>(b) * C + c] != st0 + c) __trap();
    wg::stage_q<Cf>(sm.q, q, b, C, H, h, G, w, r0, r_end, tid);

    // the warpgroup's rows: absolute query range [qg_lo, qg_hi]; the
    // warp's: [qw_lo, qw_hi]; each lane's two rows
    const int g0 = r0 + 64 * w, w0 = g0 + 16 * (tid >> 5);
    const bool live = g0 < r_end;
    const int qg_lo = st0 + g0 / G, qg_hi = st0 + (min(r_end, g0 + 64) - 1) / G;
    const int qw_lo = st0 + w0 / G, qw_hi = st0 + (min(r_end, w0 + 16) - 1) / G;
    int qp[2];  // -1 for a dead row
  #pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rr = w0 + (lane >> 2) + 8 * i;
      qp[i] = rr < r_end ? st0 + rr / G : -1;
    }

    wg::Rows<HD> st;
    st.init();
    // a stage's key positions, in its ring slot
    auto kpos = [&](int s) { return sm.kpos + (s - s0) % Cf::NS * KT; };
    wg::consume<Cf>(
        s0, s1, sm, w, scale_log2,
        [&](int s) {  // every key of the stage is masked for every row
          const int k0 = t_lo + s * KT, k1 = k0 + KT - 1;
          return !live || k0 > qg_hi || (window > 0 && k1 <= qg_lo - window);
        },
        [&](int s) {  // the warp's rows need per-key masks
          const int k0 = t_lo + s * KT, k1 = k0 + KT - 1;
          // every key of the stage is read (none past t_hi, none under -1)
          const int* kb = kpos(s);
          bool all_read = true;
  #pragma unroll
          for (int kk = lane; kk < KT; kk += 32)
            all_read = all_read && kb[kk] >= 0;
          return !__all_sync(0xffffffffu, all_read) || k1 > qw_lo ||
                 (window > 0 && k0 <= qw_hi - window);
        },
        [&](int s, int i, int kk) {
          const int t = kpos(s)[kk];
          bool ok = t >= 0 && t <= qp[i];
          if (window > 0) ok = ok && t > qp[i] - window;
          return ok;
        },
        st);
    if (S == 1)
      wg::store_rows<Cf>(st, sm.q, out, b, C, H, h, G, w, r0, r_end);
    else
      wg::store_partial<Cf>(st, part_acc, part_m, part_l, S, p, b, C, H, h,
                            G, w, r0, r_end);
  }
}

// The partitions' merge: one block per output row (its own name, so a
// profile tells it from the decode kernels' merge).
template <int HD>
__global__ void prefill_split_merge_kernel(const float* __restrict__ acc,
                                           const float* __restrict__ m,
                                           const float* __restrict__ l,
                                           bf16* __restrict__ out, int S) {
  rt::split_kv_merge_row<bf16, HD>(acc, m, l, out, S, blockIdx.x);
}

// ------------------------------------------------------------- launch
// The longest walk the launcher can know of without reading the tables:
// the table's span, or the window and the chunk.
int walk(int span, int C, int window) {
  return window > 0 && window + C < span ? window + C : span;
}

int gcd_int(int a, int b) { return b == 0 ? a : gcd_int(b, a % b); }

template <int HD, int NWG>
int launch_bf16(const void* q, const void* kp, const void* vp,
                const void* tbl, const void* start, const void* q_pos,
                void* out, void* part_acc, void* part_m, void* part_l, int B,
                int C, int K, int G, int NB, int bs, int MB, int window,
                int S, float scale_log2, cudaStream_t s) {
  using Cf = CfgBf16<HD, NWG>;
  // a stage's keys come in pieces of R that each lie in one table block;
  // a TMA box starts on the swizzle's 1 KB period, so where R is not a
  // multiple of 8 the kernel copies key by key instead
  const int R = gcd_int(bs, Cf::KT);
  if (S < 1 || (S > 1 && (!part_acc || !part_m || !part_l)))
    return static_cast<int>(cudaErrorInvalidValue);
  // the pools (K, NB, bs, HD) as 2-d maps (HD, K * NB * bs); a box is SW
  // columns of R keys
  const cuuint64_t dims[2] = {HD, static_cast<cuuint64_t>(K) * NB * bs};
  const cuuint64_t strides[1] = {HD * 2ull};
  const cuuint32_t box[2] = {Cf::SW, static_cast<cuuint32_t>(R)};
  CUtensorMap km, vm;
  if (!rt::bf16_tensor_map(&km, kp, 2, dims, strides, box, Cf::SWB) ||
      !rt::bf16_tensor_map(&vm, vp, 2, dims, strides, box, Cf::SWB))
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr =
      rt::allow_smem(paged_prefill_bf16<HD, NWG>, Cf::kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(B * K, (C * G + Cf::kM - 1) / Cf::kM, S);
  paged_prefill_bf16<HD, NWG><<<grid, Cf::kThreads, Cf::kBytes, s>>>(
      km, vm, static_cast<const bf16*>(kp), static_cast<const bf16*>(vp),
      static_cast<const bf16*>(q), static_cast<const int*>(tbl),
      static_cast<const int*>(start), static_cast<const int*>(q_pos),
      static_cast<bf16*>(out), static_cast<float*>(part_acc),
      static_cast<float*>(part_m), static_cast<float*>(part_l), C, K, G, NB,
      bs, MB, window, R, scale_log2);
  if (S > 1) {
    if (cudaPeekAtLastError() != cudaSuccess) return 0;  // launch_status
    prefill_split_merge_kernel<HD><<<B * C * K * G, HD, 0, s>>>(
        static_cast<const float*>(part_acc),
        static_cast<const float*>(part_m), static_cast<const float*>(part_l),
        static_cast<bf16*>(out), S);
  }
  return 0;
}

template <int HD>
int launch(int dtype, const void* q, const void* kp, const void* vp,
           const void* tbl, const void* start, const void* q_pos, void* out,
           void* part_acc, void* part_m, void* part_l, int B, int C, int K,
           int G, int NB, int bs, int MB, int window, int S,
           cudaStream_t s) {
  const double scale = 1.0 / std::sqrt(static_cast<double>(HD));
  if (dtype == rt::DTYPE_BF16) {
    const float sl2 = static_cast<float>(rt::tile::wg::kLog2e * scale);
    return rt::tile::wg::tile_rows(HD, C * G, walk(MB * bs, C, window)) ==
                   128
               ? launch_bf16<HD, 2>(q, kp, vp, tbl, start, q_pos, out,
                                    part_acc, part_m, part_l, B, C, K, G, NB,
                                    bs, MB, window, S, sl2, s)
               : launch_bf16<HD, 1>(q, kp, vp, tbl, start, q_pos, out,
                                    part_acc, part_m, part_l, B, C, K, G, NB,
                                    bs, MB, window, S, sl2, s);
  }
  if (S != 1) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(B * K, (C * G + kM - 1) / kM);
  const size_t smem = smem_bytes_f32<HD>();
  static const cudaError_t attr =
      rt::allow_smem(paged_prefill_f32<HD>, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  paged_prefill_f32<HD><<<grid, rt::tile::kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(kp),
      static_cast<const float*>(vp), static_cast<const int*>(tbl),
      static_cast<const int*>(start), static_cast<const int*>(q_pos),
      static_cast<float*>(out), C, K, G, NB, bs, MB, window,
      static_cast<float>(scale));
  return 0;
}

// Key partitions of the bf16 walk: kParts parts where kParts times the
// grid (rows x kv heads x tiles) still fits one CTA on each of the `sms`
// SMs, fewer where the longest walk the launcher knows of (walk()) gives
// a part under kMinPartKeys keys, else none.  Measured on the card
// (chip_variants.py set 5, bf16, phase 3's shapes; unsplit / 2 / 4
// parts): RecurrentGemma-9B's 32 CTAs over 2112 keys 107.6 / 69.4 /
// 50.2 us; Mixtral-8x22B's 96 over 4160 119.0 / 140.1 / 122.5,
// Nemotron-4's 192 over 2112 175.1 / 180.1 / 205.6 and Llama-2-7B's 128
// over 1024 25.9 / 33.4 / 38.2: a grid on a quarter of the SMs gains,
// one on half of them or more loses to the merge.
constexpr int kParts = 4, kMinPartKeys = 512;

int partitions(int B, int C, int K, int G, int bs, int MB, int hd,
               int window, int sms) {
  const int keys = walk(MB * bs, C, window);
  const int tile = rt::tile::wg::tile_rows(hd, C * G, keys);
  const long long ctas =
      static_cast<long long>(B) * K * ((C * G + tile - 1) / tile);
  if (ctas * kParts > sms) return 1;
  return std::max(1, std::min(kParts, keys / kMinPartKeys));
}

}  // namespace

// q (B, C, K*G, hd); kp/vp (K, NB, bs, hd); tbl (B, MB) int32; start (B,)
// int32; q_pos (B, C) int32 (checked == start[b] + c); out like q.
// window <= 0 means none.  hd 32, 64, 128, 192 or 256.  bf16 walks each
// (row, kv head, tile)'s keys in S partitions (S = 1: no split); with S >
// 1 part_acc (B*C*K*G, S, hd), part_m and part_l (B*C*K*G, S) are float32
// scratch for the merge.  float32 takes S = 1.
extern "C" int paged_prefill(const void* q, const void* kp, const void* vp,
                             const void* tbl, const void* start,
                             const void* q_pos, void* out, void* part_acc,
                             void* part_m, void* part_l, int B, int C,
                             int K, int G, int NB, int bs, int MB, int hd,
                             int window, int S, int dtype, void* stream) {
  if (G < 1 || C < 1 || bs < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  int bad;
  switch (hd) {
#define REPRO_CASE(HD)                                                     \
  case HD:                                                                 \
    bad = launch<HD>(dtype, q, kp, vp, tbl, start, q_pos, out, part_acc,   \
                     part_m, part_l, B, C, K, G, NB, bs, MB, window, S, s); \
    break;
    REPRO_CASE(32)
    REPRO_CASE(64)
    REPRO_CASE(128)
    REPRO_CASE(192)
    REPRO_CASE(256)
#undef REPRO_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bad) return bad;
  return rt::launch_status();
}

// Key partitions the bf16 kernel's walk takes for this call on a card of
// `sms` SMs (partitions() above): the wrapper allocates the merge's
// scratch for them and passes the count to paged_prefill.  -1 for an
// unknown hd or a bad shape.
extern "C" int paged_prefill_partitions(int B, int C, int K, int G, int bs,
                                        int MB, int hd, int window,
                                        int sms) {
  if (B < 1 || C < 1 || K < 1 || G < 1 || bs < 1 || MB < 1 || sms < 1 ||
      (hd != 32 && hd != 64 && hd != 128 && hd != 192 && hd != 256))
    return -1;
  return partitions(B, C, K, G, bs, MB, hd, window, sms);
}
