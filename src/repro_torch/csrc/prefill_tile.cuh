// The tile steps shared by the two prefill attention kernels
// (paged_prefill.cu, flash_attn.cu).  Which step runs is a matter of the
// operands' dtype, decided in each kernel's C entry point:
//
//  * bfloat16 -> rt::tile::tc, on the tensor cores (below);
//  * float32  -> rt::tile, on the CUDA cores (the step of the kernels'
//    first version, kept because TF32 products would not hold the float32
//    tolerance of 1e-5 against the plain versions).
//
// Both walk a tile of kM = 64 query-head rows over keys in stages of
// kKT = 64, with a float32 online softmax (masked keys get probability
// exactly 0, the row max stays -inf until a live key arrives, the output
// is divided by max(l, 1e-30), so a row that sees no key writes zeros).
//
// ---- bfloat16: rt::tile::tc (mma.sync.m16n8k16, bf16 in, float32 out)
//
// A CTA of 4 warps (128 threads); warp w owns tile rows 16w..16w+15, the
// M of one m16n8k16 product.
//  * Q is copied once into shared memory (the K buffer of the last ring
//    slot, not yet in use) and loaded with ldmatrix into A fragments that
//    stay in registers for the whole key walk (HD/16 k-steps x 4
//    registers: 32 at HD = 128).  At HD = 256 (q_in_smem) the fragments
//    would take 64 registers beside the output's 128 and spill, so Q gets
//    a buffer of its own past the ring and each stage reloads its
//    fragments with ldmatrix, one k-step at a time; the ring then holds
//    two stages (three of 64 keys at a 264-element stride, 203 KB, leave
//    no room for Q's 33 KB).
//  * K and V stages are copied as bf16 into a ring of NS buffers with
//    16-byte cp.async (src-size 0 zero-fills a key that is not read), so
//    stage s + NS - 1 is in flight while stage s is computed; one
//    __syncthreads per stage.  Rows are padded by 8 elements (16 bytes):
//    8 rows of one ldmatrix then fall in 8 distinct 16-byte bank groups.
//  * S = Q K^T: per warp 8 n-tiles x HD/16 k-steps of m16n8k16 with K
//    fragments from ldmatrix (K is stored key-major, i.e. "col" for B).
//  * Softmax in registers: a thread holds 2 rows x 16 scores; the row max
//    is reduced over the quad with two shuffles, the row sum stays a
//    per-thread partial of the float32 probabilities until the epilogue.
//    Per-element masks run only on stages that need them (the kernel
//    says which); a stage that masks every row of a warp is skipped.
//  * P V: the score accumulators, rounded to bf16 pairs, are the A
//    fragments of the second product (P never goes through shared
//    memory); V fragments come from ldmatrix.trans; O accumulates in
//    float32 registers (HD/8 n-tiles x 4: 64 at HD = 128, 128 at 256).
//  * Epilogue: normalise, round to bf16, stage each warp's 16 rows in its
//    own rows of the Q buffer and write them out with 16-byte stores.
// This is the arithmetic of the Pallas kernels, not an approximation of
// it: they too take float32 scores of bf16 operands and round P to the
// value dtype before P V (flash.py:96, prefill_attn.py:95-96).
//
// mma.sync and not wgmma: at the serving shapes both kernels are bound by
// bytes (flash 14.7 us of bytes against 6.2 us of bf16 products; paged
// prefill 9.2 against 1.7), so the gain is in tensor cores at all, bf16
// staging and copies in flight; a warp-specialised wgmma + TMA step pays
// off only for longer prompts.
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

// ------------------------------------------ bfloat16: tensor-core tile step
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr double kLog2e = 1.4426950408889634;  // scores go to base 2
static_assert(kM == 16 * kWarps, "one m16 row block per warp");

// Padded row stride (elements) of the Q, K and V buffers.
template <int HD>
__host__ __device__ constexpr int ld() {
  return HD + 8;
}

// Whether Q's fragments are read from shared memory at every stage
// instead of held in registers (see the top of this file).
template <int HD>
__host__ __device__ constexpr bool q_in_smem() {
  return HD > 128;
}

// Bytes of shared memory: a ring of NS (K, V) stages, K buffers first.
// The Q tile is staged in the K buffer of ring slot NS - 1 (q_buffer):
// the walk first fills that slot after every warp has loaded its Q
// fragments, and the epilogue reuses it once every stage is done.  With
// q_in_smem the Q tile has its own buffer after the ring.
template <int HD, int NS>
__host__ __device__ constexpr size_t smem_bytes() {
  return static_cast<size_t>(2 * NS * kKT + (q_in_smem<HD>() ? kM : 0)) *
         ld<HD>() * sizeof(bf16);
}
static_assert(kM == kKT, "the Q tile fits one K buffer");

template <int HD, int NS>
__device__ __forceinline__ bf16* q_buffer(bf16* Ks) {
  return q_in_smem<HD>() ? Ks + 2 * NS * kKT * ld<HD>()
                         : Ks + (NS - 1) * kKT * ld<HD>();
}

// Copy the tile's query rows into Qs (kM rows of stride ld<HD>()).  Tile
// row r is query (r0 + r) / G of query head h * G + (r0 + r) % G of the
// (B, T, H, HD) tensor q; rows at or past r_end are zero-filled.  Every
// thread of the CTA calls it; the caller commits the group.
template <int HD>
__device__ __forceinline__ void stage_q(bf16* Qs, const bf16* q, int b,
                                        int T, int H, int h, int G, int r0,
                                        int r_end) {
  constexpr int CH = HD / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kM * CH; c += kThreads) {
    const int r = c / CH, ch = c % CH, rr = r0 + r;
    const bool ok = rr < r_end;
    const size_t off =
        ok ? ((static_cast<size_t>(b) * T + rr / G) * H + h * G + rr % G) *
                     HD +
                 ch * 8
           : 0;
    cp_async16(Qs + r * ld<HD>() + ch * 8, q + off, ok);
  }
}

// Online-softmax state of one warp's 16 rows.  Lane (g, t) = (lane / 4,
// lane % 4) holds rows g and g + 8 (index i = 0, 1) and, of every 8-wide
// column block, columns 2t and 2t + 1.
template <int HD>
struct Rows {
  static constexpr int kQF = q_in_smem<HD>() ? 1 : HD / 16;
  uint32_t q[kQF][4];      // A fragments of Q, one per 16-wide k-step
  const bf16* qw;          // the warp's 16 rows of Q (q_in_smem)
  float o[HD / 8][4];      // unnormalised output, float32
  float m[2];              // running max, log2 domain
  float l[2];              // this lane's partial sum of probabilities

  // The A fragment of Q at k-step kk from the warp's rows of Qs.
  __device__ __forceinline__ void load_q(uint32_t (&f)[4], const bf16* Qw,
                                         int kk) const {
    const int lane = threadIdx.x & 31;
    ldsm_x4(f, Qw + (lane & 15) * ld<HD>() + kk * 16 + (lane >> 4) * 8);
  }

  // Load the warp's Q fragments from its 16 rows of Qs (with q_in_smem,
  // keep where they are).
  __device__ __forceinline__ void init(const bf16* Qw) {
    qw = Qw;
    if constexpr (!q_in_smem<HD>()) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) load_q(q[kk], Qw, kk);
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = neg_inf();
      l[i] = 0.f;
    }
  }
};

// Fold one staged stage of kKT keys (Ks, Vs: kKT rows of stride
// ld<HD>()) into a warp's running softmax.  scale_log2 = log2(e) /
// sqrt(HD).  When `masked`, ok(i, kk) says whether the lane's row i sees
// key kk of the stage; otherwise every key is live for every row.
template <int HD, typename KeyOk>
__device__ __forceinline__ void attend_stage(const bf16* Ks, const bf16* Vs,
                                             float scale_log2, bool masked,
                                             KeyOk ok, Rows<HD>& st) {
  constexpr int LD = ld<HD>();
  constexpr int NT = kKT / 8;  // 8-key n-tiles of S
  const int lane = threadIdx.x & 31, t4 = lane & 3;
  // ldmatrix row addresses: lane -> (8x8 matrix lane / 8, its row lane % 8)
  const int mi = lane >> 3, mr = lane & 7;

  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  // one k-step of S = Q K^T with Q's A fragment qa
  auto qk = [&](const uint32_t(&qa)[4], int kk) {
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      // matrices: keys 16jp + {0..7, 0..7, 8..15, 8..15} x dims
      // 16kk + {0..7, 8..15, 0..7, 8..15} -> (b0, b1) of n-tiles 2jp, 2jp+1
      uint32_t b[4];
      ldsm_x4(b, Ks + (16 * jp + (mi >> 1) * 8 + mr) * LD + kk * 16 +
                     (mi & 1) * 8);
      mma_bf16(s[2 * jp], qa, b[0], b[1]);
      mma_bf16(s[2 * jp + 1], qa, b[2], b[3]);
    }
  };
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    if constexpr (q_in_smem<HD>()) {
      uint32_t qa[4];
      st.load_q(qa, st.qw, kk);
      qk(qa, kk);
    } else {
      qk(st.q[kk], kk);
    }
  }

  // scores -> log2 domain; mask; row max over the quad
  float mx[2] = {st.m[0], st.m[1]};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e] * scale_log2;
      if (masked && !ok(e >> 1, 8 * j + 2 * t4 + (e & 1))) x = neg_inf();
      s[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float corr[2], base[2];
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
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(s[j][e] - base[e >> 1]);
      s[j][e] = p;
      rs[e >> 1] += p;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) st.l[i] = st.l[i] * corr[i] + rs[i];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    st.o[n][0] *= corr[0];
    st.o[n][1] *= corr[0];
    st.o[n][2] *= corr[1];
    st.o[n][3] *= corr[1];
  }

  // O += P V: the S accumulators of n-tiles 2kk, 2kk+1 are the A fragment
  // of key k-step kk
#pragma unroll
  for (int kk = 0; kk < kKT / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                           pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                           pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                           pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      // matrices: keys 16kk + {0..7, 8..15, 0..7, 8..15} x dims
      // 16dp + {0..7, 0..7, 8..15, 8..15}, transposed -> (b0, b1) of
      // n-tiles 2dp, 2dp+1
      uint32_t b[4];
      ldsm_x4_trans(b, Vs + (16 * kk + (mi & 1) * 8 + mr) * LD + dp * 16 +
                           (mi >> 1) * 8);
      mma_bf16(st.o[2 * dp], a, b[0], b[1]);
      mma_bf16(st.o[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// The stage pipeline.  issue(s, buf) starts the cp.async copies of stage
// s into ring buffer buf; stage(s, buf) computes it.  The caller has
// staged Q (stage_q into q_buffer) and committed it as the first group;
// its fragments are loaded into st once the Q copies have landed, while
// the first NS - 1 stages are in flight (in slots 0..NS-2).  Every thread of the CTA calls this.  One
// __syncthreads per stage: it publishes stage s and tells every warp that
// stage s - 1 is done, whose buffer the copies issued next reuse.
template <int HD, int NS, typename Issue, typename Stage>
__device__ __forceinline__ void walk(int n, const bf16* Qs, Rows<HD>& st,
                                     Issue issue, Stage stage) {
  static_assert(NS >= 2, "a ring of at least two stages");
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < n) issue(s, s);
    cp_async_commit();
  }
  cp_async_wait<NS - 1>();  // the Q group
  __syncthreads();
  st.init(Qs + (threadIdx.x >> 5) * 16 * ld<HD>());
  for (int s = 0; s < n; ++s) {
    cp_async_wait<NS - 2>();
    __syncthreads();
    if (s + NS - 1 < n) issue(s + NS - 1, (s + NS - 1) % NS);
    cp_async_commit();
    stage(s, s % NS);
  }
}

// Normalise, round and write the warp's rows r0 + 16w + {0..15} below
// r_end to out (the layout of stage_q), staged through the warp's own
// rows of Qs for 16-byte stores.  Every thread of the CTA calls it.
template <int HD>
__device__ __forceinline__ void store_rows(Rows<HD>& st, bf16* Qs, bf16* out,
                                           int b, int T, int H, int h, int G,
                                           int r0, int r_end) {
  constexpr int LD = ld<HD>(), CH = HD / 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  cp_async_wait<0>();
  __syncthreads();  // no copy into Qs is still in flight, from any thread
  bf16* Ow = Qs + warp * 16 * LD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = st.l[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(Ow + (g + 8 * i) * LD + 8 * n + 2 * t4) =
          pack_bf16(st.o[n][2 * i] * inv, st.o[n][2 * i + 1] * inv);
  }
  __syncwarp();
#pragma unroll
  for (int c = lane; c < 16 * CH; c += 32) {
    const int r = c / CH, ch = c % CH, rr = r0 + warp * 16 + r;
    if (rr >= r_end) continue;
    const size_t off =
        ((static_cast<size_t>(b) * T + rr / G) * H + h * G + rr % G) * HD +
        ch * 8;
    *reinterpret_cast<uint4*>(out + off) =
        *reinterpret_cast<const uint4*>(Ow + r * LD + ch * 8);
  }
}

}  // namespace tc
}  // namespace tile
}  // namespace rt
