// The tile steps shared by the two prefill attention kernels
// (paged_prefill.cu, flash_attn.cu).  Which step runs is a matter of the
// operands' dtype, decided in each kernel's C entry point:
//
//  * bfloat16 -> rt::tile::wg, Hopper's warpgroup step (below);
//  * float32  -> rt::tile, on the CUDA cores (the step of the kernels'
//    first version, kept because TF32 products would not hold the float32
//    tolerance of 1e-5 against the plain versions): tiles of kM = 64
//    query-head rows, stages of kKT = 64 keys.
//
// Both keep a float32 online softmax (masked keys get probability exactly
// 0, the row max stays -inf until a live key arrives, the output is
// divided by max(l, 1e-30), so a row that sees no key writes zeros).
//
// ---- bfloat16: rt::tile::wg (wgmma m64nNk16, TMA, mbarriers; sm_90a)
//
// A CTA is one producer warpgroup and NWG = 1 or 2 consumer warpgroups.
// Each consumer warpgroup owns 64 query-head rows of the tile, the M of
// one wgmma; tile row r is query r / G of query head h * G + r % G, so
// the G heads of a kv head share every staged K/V tile.
//  * Tile rule (wg::tile_rows, read by both C launchers, flash's wrapper
//    through flash_tile_rows and paged prefill's through its partition
//    rule, paged_prefill_partitions): 128 rows (two consumer
//    warpgroups) where a (batch row, kv head) has 128 query-head rows
//    (Tq * G or C * G) and hd is 192 or 256, or hd is 128 and the longest
//    walk is 512 keys or more; else 64 (one consumer warpgroup, two CTAs
//    an SM at hd <= 128).  Measured on the card (chip_variants.py set 1):
//    128 wherever there are 128 rows lost at hd 64 (Whisper's encoder,
//    233.5 against 183.1 us) and on short walks (a 128-key window 50.9
//    against 41.8 us, 3 x 500 tokens 54.7 against 48.9), where two or
//    three independent CTAs an SM keep the tensor cores busier than two
//    warpgroups of one CTA that start each stage together; 64 everywhere
//    lost at hd 192 (269.0 against 180.6 us) and over 32768 keys (23.5
//    against 20.1 ms).
//  * Loads: one thread of the producer warpgroup (flash), or its first
//    warp (paged prefill: a lane per table block of the stage), keeps a
//    ring of NS K/V stages in flight with TMA (cp.async.bulk.tensor) in
//    boxes of SW = 64 head-dim columns (32 at hd 32) x keys, which the
//    TMA writes in the 128-byte (64-byte) swizzle (paged prefill at a
//    block size that leaves a stage pieces of a multiple of 8 keys; at
//    others, such as 4 or 12, its warp copies key by key with cp.async
//    into the same swizzled slots).  A stage's "full"
//    mbarrier completes when its bytes land; its "empty" mbarrier when
//    every consumer warp has passed it.  The producer warpgroup gives up
//    registers with setmaxnreg (24 a thread in flash, 40 in paged
//    prefill, whose warp walks the table) to the consumers (240 / 232 a
//    thread with two consumer warpgroups, 232 / 216 with one at two CTAs
//    an SM, 136 at three; one consumer warpgroup at one CTA an SM needs
//    no exchange).
//    The roles split in one if / else: ptxas sizes each branch to its own
//    register count only so.
//  * Q is copied once per consumer warpgroup by its own threads
//    (cp.async, in the same swizzle): a tile's rows are not one box where
//    G does not divide 128.
//  * S = Q K^T: HD / 16 wgmma m64nKTk16, both operands from shared
//    memory, K-major, descriptors in the TMA's swizzle (a k-step is 32
//    bytes into the swizzle row; column blocks KT x SWB bytes apart).
//  * Softmax in registers, in wgmma's accumulator layout (a thread holds
//    2 rows x KT / 4 scores); the row max is reduced over the quad with
//    two shuffles, the row sum stays a per-thread partial of the float32
//    probabilities until the epilogue.  Per-element masks run only on the
//    stages that need them (the kernel says which, per warp); a stage
//    that masks every row of a warpgroup is not computed by it.
//  * P V: the score accumulators, rounded to bf16 pairs, are the register
//    A operand of KT / 16 wgmma m64nHDk16 with V from shared memory
//    (MN-major); O accumulates in float32 registers (HD / 2 a thread).
//  * The walk (consume): with a ring of three stages or more, stage s's
//    Q K^T and softmax run while stage s - 1's P V is on the tensor
//    cores (FlashAttention-3's overlap within a warpgroup: 20.1 against
//    22.8 ms one stage after the other over 32768 keys, chip_variants.py
//    set 1); with two, which the overlap would hold both of, one stage
//    after the other (measured faster there: 36.4-36.8 against 41.8 us for
//    the runtime's paged prefill at Llama-2-7B's widths, chip_smoke.py
//    phase 3, without and with the overlap).  The stages a warpgroup's
//    rows see no key of are a prefix and a suffix of the walk: it waits
//    for and releases them.
//  * Epilogue: normalise, round to bf16, stage each warpgroup's rows in
//    its own rows of the Q tile and write them with 16-byte stores; or,
//    for a key partition of paged prefill, write the unnormalised rows,
//    max and sum in float32 for rt::split_kv_merge_row.
//  * Shared memory and registers per head dim (Q tile + NS stages of KT
//    keys of K and V; flash / paged prefill, which adds 4 bytes a key of
//    positions a stage), with a 1 KB alignment slack:
//      two consumer warpgroups, 384 threads, one CTA an SM:
//        hd 32: KT 128, NS 4, 73 / 75 KB; hd 64: KT 128, NS 4, 145 / 147
//        KB; hd 128: KT 128, NS 3, 225 / 226.5 KB; hd 192: KT 64, NS 3,
//        193 / 194 KB; hd 256: KT 64, NS 2, 193 / 193.5 KB
//      one consumer warpgroup, 256 threads, KT 64:
//        hd 32 / 64 / 128: NS 4 / 4 / 2, 37 / 73 / 81 KB (+1 KB paged),
//        three CTAs an SM in flash at hd 32 and 64, else two; hd 192 /
//        256: NS 4 / 3, 217 / 225 KB (+1 KB), one CTA an SM
//    O takes 16-128 float32 registers a thread (hd 32-256) and S 32
//    (KT 64) or 64 (KT 128): at hd 192 and 256 the stages hold 64 keys so
//    that S, P and O fit beside each other.
//  * Alignment with the whole call: with kM-row tiles (kM / G queries
//    each) and stages that start at multiples of KT, a flash call over a
//    chunk of queries at an offset q0 that is a multiple of kM / G, whose
//    tile is the whole call's, walks the same tiles and stages as one call
//    over all the queries, so its rows come out bit for bit the same.
// This is the arithmetic of the Pallas kernels, not an approximation of
// it: they too take float32 scores of bf16 operands and round P to the
// value dtype before P V (flash.py:96, prefill_attn.py:95-96).
#pragma once

#include "common.cuh"

namespace rt {
namespace tile {

constexpr int kM = 64;   // query rows per CTA
constexpr int kKT = 64;  // keys per staged sub-tile

// ------------------------------------------- float32: CUDA-core tile step
//
// A CTA of 256 threads; Q, K and V staged as float32 rows padded to
// HD + 4 floats (the odd stride keeps the key reads free of bank
// conflicts).  Thread (tx, ty) = (tid % 16, tid / 16) owns rows 4*ty + i
// and keys tx + 16*j of a stage, i, j < 4:
//  * its 4 x 4 register tile of scores comes from float4 shared-memory
//    reads, so one read feeds eight FMAs;
//  * the row max and row sum are reduced across the 16 threads of a row
//    group with shuffles;
//  * the probabilities go through shared memory to the P @ V product,
//    where the thread owns 4 rows x HD/16 output columns in registers.

constexpr int kThreads = 256;
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


// ------------------------------------- bfloat16: the Hopper tile step
namespace wg {

using bf16 = __nv_bfloat16;

constexpr double kLog2e = 1.4426950408889634;  // scores go to base 2
constexpr int kSmemPerSM = 233472;   // 228 KB of shared memory an SM
constexpr int kSmemPerCTA = 1024;    // reserved by the system per CTA
constexpr int kMaxStages = 4;

// Query-head rows of a tile at head dim hd for a (batch row, kv head) of
// `rows` query-head rows whose longest key walk is `walk` keys: two
// consumer warpgroups (128) where there are 128 rows, the head dim is 128
// or more and, at 128, the walk is 512 keys or more; else one (64).
// (Measured on the card: see the note at the head of this file.)
__host__ __device__ constexpr int tile_rows(int hd, int rows, int walk) {
  return rows >= 128 && (hd > 128 || (hd == 128 && walk >= 512)) ? 128 : 64;
}

// The walk of a flash call: Tk keys, or at most the window and a tile's
// queries (128 / G) under a window.
__host__ __device__ constexpr int flash_walk(int Tk, int G, int window) {
  return window > 0 && window + (128 + G - 1) / G < Tk
             ? window + (128 + G - 1) / G
             : Tk;
}

// The step's shapes at head dim HD with NWG consumer warpgroups; KPOS
// when each stage also carries its keys' positions (paged prefill).
template <int HD_, int NWG, bool KPOS>
struct Shape {
  static constexpr int HD = HD_;
  static constexpr int kM = 64 * NWG;            // query-head rows a CTA
  static constexpr int kThreads = 128 * (NWG + 1);
  static constexpr int SW = HD >= 64 ? 64 : 32;  // elements a swizzle row
  static constexpr int SWB = 2 * SW;             // its bytes: the swizzle
  static constexpr int NCH = HD / SW;            // swizzle rows a K/V row
  static constexpr int kLayout = SWB == 128 ? 1 : 2;  // descriptor layout
  static constexpr int KT = HD <= 128 && NWG == 2 ? 128 : 64;  // keys
  static constexpr int kQBytes = kM * HD * 2;
  static constexpr int kTileBytes = KT * HD * 2;  // K or V of a stage
  static_assert(HD % SW == 0 && HD % 16 == 0, "head dim");
};

// Bytes of shared memory with ns stages, 1 KB of slack to align.
template <class S>
constexpr size_t smem_bytes(int ns, bool kpos) {
  return 1024 + S::kQBytes + 2 * ns * (S::kTileBytes + 8) +
         (kpos ? ns * S::KT * 4 : 0);
}

// CTAs an SM with one consumer warpgroup: as many as the shared memory of
// two stages leaves room for, up to three in flash (hd 32 and 64; measured
// on Whisper's encoder, 180.4 against 204.8 us at two) and two in paged
// prefill (whose producer keeps 40 registers: a third CTA would leave its
// consumers 120).  Two consumer warpgroups: one.
template <bool KPOS>
constexpr int kMaxOcc = KPOS ? 2 : 3;
template <class S, int NWG, bool KPOS>
constexpr int occupancy() {
  int occ = NWG == 1 ? kMaxOcc<KPOS> : 1;
  while (occ > 1 &&
         smem_bytes<S>(2, KPOS) + kSmemPerCTA > kSmemPerSM / occ)
    --occ;
  return occ;
}

// Ring stages: as many as fit, at most kMaxStages, at least 2.
template <class S, bool KPOS, int OCC>
constexpr int ring_stages() {
  int ns = kMaxStages;
  while (ns > 2 && smem_bytes<S>(ns, KPOS) + kSmemPerCTA > kSmemPerSM / OCC)
    --ns;
  return ns;
}

template <int HD_, int NWG, bool KPOS>
struct Cfg : Shape<HD_, NWG, KPOS> {
  using S = Shape<HD_, NWG, KPOS>;
  static constexpr int kOcc = occupancy<S, NWG, KPOS>();
  static constexpr int NS = ring_stages<S, KPOS, kOcc>();
  static constexpr size_t kBytes = smem_bytes<S>(NS, KPOS);
  // setmaxnreg, where the launch bounds cap the registers (two consumer
  // warpgroups, or two CTAs an SM): the producer warpgroup drops to
  // kProducerRegs (24 for flash's one copying thread, 40 for paged
  // prefill's table walk) and the consumers take what it frees
  static constexpr bool kRebalance = kOcc > 1 || NWG == 2;
  static constexpr int kProducerRegs = KPOS ? 40 : 24;
  static constexpr int kLaunchRegs = 65536 / kOcc / S::kThreads / 8 * 8;
  static constexpr int kConsumerRegs =
      (kLaunchRegs + (kLaunchRegs - kProducerRegs) / NWG) / 8 * 8;
  static_assert(kBytes + kSmemPerCTA <= kSmemPerSM / kOcc,
                "shared memory of the stages");
};

// Byte offset of 16-byte chunk `off` bits [4, 7) after the swizzle the
// TMA writes (128 B: XOR with bits [7, 10); 64 B: with bits [7, 9)),
// within a region aligned to 1 KB.
template <class C>
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  return off ^ (((off >> 7) & (C::SWB / 16 - 1)) << 4);
}

// Byte offset of row r, 16-byte chunk ch of a tile of `rows` rows stored
// as NCH column blocks of SW elements, each rows x SWB bytes, swizzled.
template <class C>
__device__ __forceinline__ uint32_t chunk_offset(int rows, int r, int ch) {
  constexpr int CPR = C::SW / 8;  // 16-byte chunks a swizzle row
  return (ch / CPR) * rows * C::SWB + swz<C>(r * C::SWB + (ch % CPR) * 16);
}

// Shared memory: the Q tile, the K and V rings, the barriers and the
// stages' key positions, from a base aligned to 1 KB (the swizzle's
// period).
template <class C>
struct Smem {
  unsigned char* q;  // [NCH][kM][SWB]
  unsigned char* k;  // [NS][NCH][KT][SWB]
  unsigned char* v;  // [NS][NCH][KT][SWB]
  uint64_t* full;    // [NS]: the stage's copies have landed
  uint64_t* empty;   // [NS]: every consumer warp is done with the stage
  int* kpos;         // [NS][KT] (KPOS)

  __device__ explicit Smem(unsigned char* raw) {
    q = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
    k = q + C::kQBytes;
    v = k + C::NS * C::kTileBytes;
    full = reinterpret_cast<uint64_t*>(v + C::NS * C::kTileBytes);
    empty = full + C::NS;
    kpos = reinterpret_cast<int*>(empty + C::NS);
  }

  // Thread 0 initialises the barriers; every thread of the CTA calls it.
  __device__ void init_barriers() const {
    if (threadIdx.x == 0) {
      for (int i = 0; i < C::NS; ++i) {
        mbar_init(&full[i], 1);
        mbar_init(&empty[i], 4 * (C::kThreads / 128 - 1));
      }
      mbar_init_fence();
    }
    __syncthreads();
  }
};

template <class C>
__device__ __forceinline__ void producer_regs() {
  if constexpr (C::kRebalance) regs_dec<C::kProducerRegs>();
}
template <class C>
__device__ __forceinline__ void consumer_regs() {
  if constexpr (C::kRebalance) regs_inc<C::kConsumerRegs>();
}

// The producer's walk over stages [s0, s1): for each, wait until the
// consumers have released its ring slot, then issue(s, slot) starts its
// copies and arrives on full[slot] with their bytes.
template <class C, typename Issue>
__device__ __forceinline__ void produce(int s0, int s1, const Smem<C>& sm,
                                        Issue issue) {
  for (int s = s0; s < s1; ++s) {
    const int i = s - s0, slot = i % C::NS;
    mbar_wait(&sm.empty[slot], ((i / C::NS) & 1) ^ 1);
    issue(s, slot);
  }
}

// Copy consumer warpgroup w's 64 rows of the tile into Qs (cp.async, in
// the TMA's swizzle); tile row r is query (r0 + r) / G of query head
// h * G + (r0 + r) % G of the (B, T, H, HD) tensor q, and rows at or past
// r_end are zero-filled.  The warpgroup's 128 threads call it (tid: the
// thread within the warpgroup); it returns once Q is visible to wgmma.
template <class C>
__device__ __forceinline__ void stage_q(unsigned char* Qs, const bf16* q,
                                        int b, int T, int H, int h, int G,
                                        int w, int r0, int r_end, int tid) {
  constexpr int HD = C::HD, CH = HD / 8;
  for (int c = tid; c < 64 * CH; c += 128) {
    const int r = c / CH, ch = c % CH, rr = r0 + 64 * w + r;
    const bool ok = rr < r_end;
    const size_t off =
        ok ? ((static_cast<size_t>(b) * T + rr / G) * H + h * G + rr % G) *
                     HD +
                 ch * 8
           : 0;
    cp_async16(Qs + chunk_offset<C>(C::kM, 64 * w + r, ch), q + off, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  named_sync(1 + w, 128);
}

// Online-softmax state of a thread's two rows, g and g + 8 of its warp's
// 16 (lane (g, t) = (lane / 4, lane % 4)); o[4 n + e] is row g + 8 (e / 2),
// column 8 n + 2 t + e % 2 (wgmma's accumulator layout).
template <int HD>
struct Rows {
  float o[HD / 2];  // unnormalised output, float32
  float m[2];       // running max, log2 domain
  float l[2];       // this lane's partial sum of probabilities

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = neg_inf();
      l[i] = 0.f;
    }
  }
};

// S = Q K^T for the stage in ring slot `slot`: HD / 16 wgmma
// m64nKTk16, both operands from shared memory, K-major, issued and
// committed as one group (the caller waits).  A k-step moves the start
// address (the descriptor's low bits, in 16 bytes) by a constant: one
// descriptor each, not one a k-step.
template <class C>
__device__ __forceinline__ void issue_qk(const Smem<C>& sm, int w, int slot,
                                         float (&s)[C::KT / 2]) {
  constexpr int HD = C::HD, KT = C::KT, SBO = 8 * C::SWB;
  const uint64_t dq = wgmma_desc(smem_u32(sm.q) + 64 * w * C::SWB, 16, SBO,
                                 C::kLayout);
  const uint64_t dk = wgmma_desc(smem_u32(sm.k) + slot * C::kTileBytes, 16,
                                 SBO, C::kLayout);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int blk = 16 * kk / C::SW, in = (16 * kk % C::SW) * 2;
    wgmma_ss<KT>(s, dq + ((blk * C::kM * C::SWB + in) >> 4),
                 dk + ((blk * KT * C::SWB + in) >> 4), kk);
  }
  wgmma_commit();
}

// O += P V for the stage in ring slot `slot`: KT / 16 wgmma m64nHDk16 with
// P's bf16 pairs as the register A operand and V from shared memory,
// MN-major (8-key groups SBO apart, SW-wide column blocks a stage's column
// block apart), committed as one group.
template <class C>
__device__ __forceinline__ void issue_pv(const Smem<C>& sm, int slot,
                                         const uint32_t (&pa)[C::KT / 16][4],
                                         float (&o)[C::HD / 2]) {
  constexpr int KT = C::KT;
  const uint64_t dv = wgmma_desc(smem_u32(sm.v) + slot * C::kTileBytes,
                                 KT * C::SWB, 8 * C::SWB, C::kLayout);
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk)
    wgmma_rs<C::HD>(o, pa[kk], dv + ((16 * kk * C::SWB) >> 4));
  wgmma_commit();
}

// Keeps the P fragments alive (and unmoved) until the product that reads
// them has been waited for.
template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Fold a stage's scores s into the running max and sum of the lane's two
// rows, leaving its float32 probabilities in s; corr is what the output,
// which still lacks this stage, must be scaled by.  scale_log2 = log2(e)
// / sqrt(HD).  When `masked`, ok(i, kk) says whether the lane's row i
// sees key kk of the stage; otherwise every key is live for every row.
template <class C, typename KeyOk>
__device__ __forceinline__ void softmax_stage(float (&s)[C::KT / 2],
                                              float scale_log2, bool masked,
                                              KeyOk ok, Rows<C::HD>& st,
                                              float (&corr)[2]) {
  constexpr int KT = C::KT, NT = KT / 8;
  const int t4 = threadIdx.x & 3;
  // scores -> log2 domain; mask; row max over the quad
  float mx[2] = {st.m[0], st.m[1]};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e] * scale_log2;
      if (masked && !ok(e >> 1, 8 * j + 2 * t4 + (e & 1))) x = neg_inf();
      s[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float base[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    // mx stays -inf while the row has seen no live key: then every
    // probability is 0 (exp2(-inf - 0)) and nothing is rescaled
    const bool none = mx[i] == neg_inf();
    corr[i] = none ? 1.f : exp2f(st.m[i] - mx[i]);
    base[i] = none ? 0.f : mx[i];
    st.m[i] = mx[i];
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < KT / 2; ++i) {
    const float p = exp2f(s[i] - base[(i >> 1) & 1]);
    s[i] = p;
    rs[(i >> 1) & 1] += p;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) st.l[i] = st.l[i] * corr[i] + rs[i];
}

// The probabilities of n-tiles 2kk, 2kk + 1, rounded to bf16 pairs, are
// the A fragment of key k-step kk of P V (P stays in registers).
template <class C>
__device__ __forceinline__ void pack_p(const float (&s)[C::KT / 2],
                                       uint32_t (&pa)[C::KT / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < C::KT / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

// Consumer warpgroup w's walk over stages [s0, s1).  It computes the run
// [ja, jb] of them for which skip(s) is false (its rows see no key of the
// others: the skipped stages are a prefix, under a window, and a suffix,
// past its causal edge), and only waits for and releases the others.
// masked(s) and ok(s, i, kk) are the stage's mask (see softmax_stage).
// With a ring of three stages or more the stages overlap: stage s's
// scores are computed and folded while stage s - 1's P V runs on the
// tensor cores; then the output is rescaled, stage s's P rounded into the
// fragments that product has finished reading, and stage s - 1's slot
// released.  (Measured on the card: with two stages, which the overlap
// would hold both of, one stage after the other is faster.)  The operand fences
// pin every register a product reads or writes to its side of
// wgmma.fence and wgmma.wait (no instruction between them defines one,
// which would serialise the products).
template <class C, typename Skip, typename Masked, typename KeyOk>
__device__ __forceinline__ void consume(int s0, int s1, const Smem<C>& sm,
                                        int w, float scale_log2, Skip skip,
                                        Masked masked, KeyOk ok,
                                        Rows<C::HD>& st) {
  constexpr int KT = C::KT, HD = C::HD;
  auto slot = [&](int s) { return (s - s0) % C::NS; };
  auto wait = [&](int s) {
    mbar_wait(&sm.full[slot(s)], ((s - s0) / C::NS) & 1);
  };
  auto release = [&](int s) {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&sm.empty[slot(s)]);
  };
  int ja = s0, jb = s1 - 1;
  while (ja <= jb && skip(ja)) ++ja;
  while (jb >= ja && skip(jb)) --jb;
  for (int s = s0; s < ja; ++s) {
    wait(s);
    release(s);
  }
  float sc[KT / 2];
  uint32_t pa[KT / 16][4];
  float corr[2];
  auto zero_scores = [&] {
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) sc[i] = 0.f;
    fence_regs(sc);
  };
  // with a ring of two stages (the overlap holds two) one stage runs
  // after the other: scores, softmax, rescale, P V
  if (C::NS < 3 && ja <= jb) {
    for (int s = ja; s <= jb; ++s) {
      wait(s);
      zero_scores();
      wgmma_fence();
      issue_qk<C>(sm, w, slot(s), sc);
      wgmma_wait<0>();
      fence_regs(sc);
      softmax_stage<C>(sc, scale_log2, masked(s),
                       [&](int i, int kk) { return ok(s, i, kk); }, st,
                       corr);
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) st.o[i] *= corr[(i >> 1) & 1];
      pack_p<C>(sc, pa);
      fence_regs(st.o);
      fence_frags(pa);
      wgmma_fence();
      issue_pv<C>(sm, slot(s), pa, st.o);
      wgmma_wait<0>();
      fence_regs(st.o);
      fence_frags(pa);
      release(s);
    }
  } else if (ja <= jb) {
    wait(ja);
    zero_scores();
    wgmma_fence();
    issue_qk<C>(sm, w, slot(ja), sc);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax_stage<C>(sc, scale_log2, masked(ja),
                     [&](int i, int kk) { return ok(ja, i, kk); }, st,
                     corr);  // O is still 0: nothing to rescale
    pack_p<C>(sc, pa);
    for (int s = ja + 1; s <= jb; ++s) {
      wait(s);
      zero_scores();
      fence_regs(st.o);
      fence_frags(pa);
      wgmma_fence();
      issue_qk<C>(sm, w, slot(s), sc);
      issue_pv<C>(sm, slot(s - 1), pa, st.o);
      wgmma_wait<1>();  // the scores; P V of stage s - 1 still runs
      fence_regs(sc);
      softmax_stage<C>(sc, scale_log2, masked(s),
                       [&](int i, int kk) { return ok(s, i, kk); }, st,
                       corr);
      wgmma_wait<0>();
      fence_regs(st.o);
      fence_frags(pa);
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) st.o[i] *= corr[(i >> 1) & 1];
      pack_p<C>(sc, pa);
      release(s - 1);
    }
    fence_regs(st.o);
    fence_frags(pa);
    wgmma_fence();
    issue_pv<C>(sm, slot(jb), pa, st.o);
    wgmma_wait<0>();
    fence_regs(st.o);
    fence_frags(pa);
    release(jb);
  }
  for (int s = max(jb + 1, ja); s < s1; ++s) {
    wait(s);
    release(s);
  }
}

// The quad's row sums of row i.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Normalise, round and write consumer warpgroup w's rows r0 + 64 w +
// {0..63} below r_end to out (the layout of stage_q), staged through the
// warpgroup's own rows of the Q tile for 16-byte stores.  The
// warpgroup's 128 threads call it.
template <class C>
__device__ __forceinline__ void store_rows(Rows<C::HD>& st,
                                           unsigned char* Qs, bf16* out,
                                           int b, int T, int H, int h, int G,
                                           int w, int r0, int r_end) {
  constexpr int HD = C::HD, CH = HD / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int wr = 64 * w + 16 * ((threadIdx.x >> 5) & 3);
  named_sync(1 + w, 128);  // every product of the warpgroup has read Q
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float inv = 1.f / fmaxf(quad_sum(st.l[i]), 1e-30f);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(
          Qs + chunk_offset<C>(C::kM, wr + g + 8 * i, n) + 4 * t4) =
          pack_bf16(st.o[4 * n + 2 * i] * inv,
                    st.o[4 * n + 2 * i + 1] * inv);
  }
  __syncwarp();
#pragma unroll 4
  for (int c = lane; c < 16 * CH; c += 32) {
    const int r = c / CH, ch = c % CH, rr = r0 + wr + r;
    if (rr >= r_end) continue;
    const size_t off =
        ((static_cast<size_t>(b) * T + rr / G) * H + h * G + rr % G) * HD +
        ch * 8;
    *reinterpret_cast<uint4*>(out + off) =
        *reinterpret_cast<const uint4*>(Qs + chunk_offset<C>(C::kM, wr + r,
                                                             ch));
  }
}

// One key partition's unnormalised rows for the merge
// (rt::split_kv_merge_row): acc (rows, S, HD), m and l (rows, S) in
// float32, output row (b * T + query) * H + head; m in natural-log units.
template <class C>
__device__ __forceinline__ void store_partial(const Rows<C::HD>& st,
                                              float* acc, float* pm,
                                              float* pl, int S, int p, int b,
                                              int T, int H, int h, int G,
                                              int w, int r0, int r_end) {
  constexpr int HD = C::HD;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int wr = r0 + 64 * w + 16 * ((threadIdx.x >> 5) & 3);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l = quad_sum(st.l[i]);
    const int rr = wr + g + 8 * i;
    if (rr >= r_end) continue;
    const size_t row =
        (static_cast<size_t>(b) * T + rr / G) * H + h * G + rr % G;
    float* a = acc + (row * S + p) * HD + 2 * t4;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<float2*>(a + 8 * n) =
          make_float2(st.o[4 * n + 2 * i], st.o[4 * n + 2 * i + 1]);
    if (t4 == 0) {
      pm[row * S + p] = st.m[i] * static_cast<float>(1.0 / kLog2e);
      pl[row * S + p] = l;
    }
  }
}

}  // namespace wg
}  // namespace tile
}  // namespace rt
