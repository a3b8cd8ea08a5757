// Chunked paged prefill GQA attention with an in-kernel block-table walk.
//
// Replaces: src/repro/kernels/paged_prefill/prefill_attn.py,
// `_prefill_kernel` under `paged_prefill_attention`.
//
// Bound on this card: bytes for the shapes the serving path gives it.  A
// chunk of C = 64 queries per row attends over the row's whole paged
// history; the call must read each live history key and value once (16 KiB
// per token per layer at Llama-2-7B widths, bf16) and does ~4*C flops per
// key byte pair, i.e. ~128 flops per byte — below the bf16 tensor-core
// ridge (~295), so the ideal kernel is memory-bound (9.2 us of bytes
// against 1.7 us of products at 4 rows x 64 queries over 1632 keys).
//
// Design: one CTA per (row, kv head, tile of 64 query-head rows).  Tile
// row r is query r / G of query head h * G + r % G, so all G heads of a kv
// head share the staged keys (GQA without K/V replication), and at the
// serving shape (C = 64, G = 1) one tile holds the whole chunk: each
// history key is read from device memory once per (row, kv head).  The CTA
// walks logical key positions from the first one its window can see
// (rounded down to a stage boundary) up to its last query — keys wholly in
// the future or wholly outside the window are never visited — in stages of
// 64 keys, each key resolved through the block table (a -1 entry is never
// read; its key is staged as zeros and masked by kpos <= qpos, window and
// table).
//
// Which tile step (prefill_tile.cuh) runs is set by the dtype:
//  * bf16: the tensor-core step, 4 warps; each key row (hd x 2 bytes,
//    within a 16-key block that is contiguous per head in the
//    (K, NB, bs, hd) pool) is copied by 16-byte cp.async into a ring of
//    three K/V stages, so two stages are in flight while one is computed.
//    Each stage also records its keys' positions (-1 for a key that is not
//    read) for the masks.  Per-element masks run only on a warp's stages
//    that cross its causal diagonal or its window's first key, or hold a
//    key that is not read; a stage that masks all of a warp's rows is
//    skipped by that warp.
//  * float32: the CUDA-core step of 256 threads, with scalar loads staged
//    synchronously into float32 rows.
// Split-KV is not used.  At the serving shape the grid is 4 rows x 32 kv
// heads = 128 CTAs, under one wave of 132 SMs, but with two 32 KB stages
// in flight per CTA some 8 MB of copies can be in flight, above what the
// card's memory rate needs at ~1 us of latency; the longest walk (768
// keys in 12 stages) moves ~384 KB per CTA.  Shared memory: 103 KB at
// hd 128 (the ring, Q staged in its third K buffer, the key positions).
//
// hd 256 (RecurrentGemma-9B: 16 query heads over 1 kv head) takes the
// same kernels.  bf16: Q gets its own buffer and its fragments are
// reloaded per stage (prefill_tile.cuh, q_in_smem), and the ring has two
// stages: 2 x 2 x 64 x 264 x 2 bytes + Q's 33 KB = 166 KB.  float32: the
// CUDA-core step's Q tile, K and V stage and probability tile at a
// 260-float stride, 213 KB.
// At G = 16 a 64-row tile holds 4 queries, so a chunk of 64 queries is 16
// tiles per (row, kv head), and each tile walks the window's keys itself:
// the history is read 16 times, where the bound reads it once.
//
// hd 192 (Nemotron-4-340B: 96 query heads over 8 kv heads, G = 12) takes
// the hd-256 route in bf16 (Q's fragments from shared memory, 96 output
// registers) but keeps three ring stages: 2 x 3 x 64 x 200 x 2 bytes + Q's
// 25 KB = 176 KB.  A key row is 24 chunks of 16 bytes, which do not
// divide the 128 threads, so each thread copies 12 chunks of a stage at a
// stride of 128 chunks (the copy loop below).  float32 at hd 192: 164 KB.
//
// Queries sit at start[b] + c.  The kernel also receives the positions
// the plain version would take and asserts they are that contiguous run.
#include <cmath>

#include "prefill_tile.cuh"

namespace {

using rt::tile::kKT;
using rt::tile::kM;
using bf16 = __nv_bfloat16;

constexpr size_t kMaxSmem = 232448;  // dynamic shared memory of one CTA

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
// Stages of the bf16 ring: three where they fit one CTA's shared memory
// beside Q (hd 192: 176 KB), else two (hd 256).
template <int HD>
__host__ __device__ constexpr int stages_bf16() {
  return rt::tile::tc::smem_bytes<HD, 3>() + 3 * kKT * sizeof(int) <=
                 kMaxSmem
             ? 3
             : 2;
}

template <int HD>
__host__ __device__ constexpr size_t smem_bytes_bf16() {
  return rt::tile::tc::smem_bytes<HD, stages_bf16<HD>()>() +
         stages_bf16<HD>() * kKT * sizeof(int);
}

template <int HD>
__global__ void __launch_bounds__(rt::tile::tc::kThreads) paged_prefill_bf16(
    const bf16* __restrict__ q, const bf16* __restrict__ kp,
    const bf16* __restrict__ vp, const int* __restrict__ tbl,
    const int* __restrict__ start, const int* __restrict__ q_pos,
    bf16* __restrict__ out, int C, int K, int G, int NB, int bs, int MB,
    int window, float scale_log2) {
  namespace tc = rt::tile::tc;
  constexpr int NS = stages_bf16<HD>(), LD = tc::ld<HD>(), CH = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [NS][kKT][LD]
  bf16* Vs = Ks + NS * kKT * LD;                 // [NS][kKT][LD]
  bf16* Qs = tc::q_buffer<HD, NS>(Ks);           // [kM][LD]
  int* kpos = reinterpret_cast<int*>(smem_raw +  // [NS][kKT]
                                     tc::smem_bytes<HD, NS>());

  const int b = blockIdx.x / K, h = blockIdx.x % K;
  const int H = K * G, rows = C * G;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kM;  // longest walks first
  const int r_end = min(rows, r0 + kM);              // exclusive
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int st0 = start[b];

  for (int c = r0 / G + tid; c <= (r_end - 1) / G; c += tc::kThreads)
    assert(q_pos[static_cast<size_t>(b) * C + c] == st0 + c);
  tc::stage_q<HD>(Qs, q, b, C, H, h, G, r0, r_end);
  rt::cp_async_commit();

  // the warp's rows: absolute query range [qw_lo, qw_hi] and each lane's
  // two rows
  const int w0 = r0 + 16 * warp;
  const bool live = w0 < r_end;
  const int qw_lo = st0 + w0 / G, qw_hi = st0 + (min(r_end, w0 + 16) - 1) / G;
  int qp[2];  // -1 for a dead row
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rr = w0 + (lane >> 2) + 8 * i;
    qp[i] = rr < r_end ? st0 + rr / G : -1;
  }

  const int q_first = st0 + r0 / G, q_last = st0 + (r_end - 1) / G;
  const int t_lo =
      window > 0 ? max(0, q_first - window + 1) / kKT * kKT : 0;
  const int t_hi = min(q_last, MB * bs - 1);  // inclusive
  const int n = t_hi >= t_lo ? (t_hi - t_lo) / kKT + 1 : 0;

  tc::Rows<HD> st;

  // A thread copies chunks tid + i * kThreads of a stage's kKT * CH,
  // i < CPT: chunk c is chunk c % CH of key c / CH.  Where CH divides the
  // thread count (hd <= 128, 256) that is chunk tid % CH of keys
  // tid / CH + i * (kThreads / CH); at hd 192 (CH = 24) a thread's chunks
  // fall at other offsets of other keys.  The table entries of the next
  // stage's keys are loaded while the current one computes (issue(s) ends
  // with lookup(s + 1)).
  constexpr int CPT = kKT * CH / tc::kThreads;
  static_assert(kKT * CH % tc::kThreads == 0, "chunk layout");
  // key and chunk of a thread's i-th chunk; where CH divides the thread
  // count, the chunk is the same for every i and the key a fixed stride
  auto key_of = [&](int i) {
    if constexpr (tc::kThreads % CH == 0)
      return tid / CH + i * (tc::kThreads / CH);
    return (tid + i * tc::kThreads) / CH;
  };
  auto chunk_of = [&](int i) {
    if constexpr (tc::kThreads % CH == 0) return tid % CH;
    return (tid + i * tc::kThreads) % CH;
  };
  int phys[CPT];
  auto lookup = [&](int s) {
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int t = t_lo + s * kKT + key_of(i);
      phys[i] = s < n && t <= t_hi ? tbl[b * MB + t / bs] : -1;
      assert(phys[i] < NB);
    }
  };
  auto issue = [&](int s, int buf) {
    bf16* Kb = Ks + buf * kKT * LD;
    bf16* Vb = Vs + buf * kKT * LD;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int kk = key_of(i), ch = chunk_of(i), t = t_lo + s * kKT + kk;
      const bool ok = phys[i] >= 0;
      const size_t off =
          ok ? ((static_cast<size_t>(h) * NB + phys[i]) * bs + t % bs) * HD +
                   ch * 8
             : 0;
      rt::cp_async16(Kb + kk * LD + ch * 8, kp + off, ok);
      rt::cp_async16(Vb + kk * LD + ch * 8, vp + off, ok);
      if (ch == 0) kpos[buf * kKT + kk] = ok ? t : -1;
    }
    lookup(s + 1);
  };
  auto stage = [&](int s, int buf) {
    const int k0 = t_lo + s * kKT, k1 = k0 + kKT - 1;
    const int* kb = kpos + buf * kKT;
    // every key of the stage is read (none past t_hi, none under -1)
    const bool all_read = __all_sync(0xffffffffu, kb[lane] >= 0 &&
                                                      kb[lane + 32] >= 0);
    if (!live || k0 > qw_hi || (window > 0 && k1 <= qw_lo - window))
      return;  // every key of the stage is masked for every row
    const bool masked = !all_read || k1 > qw_lo ||
                        (window > 0 && k0 <= qw_hi - window);
    tc::attend_stage<HD>(
        Ks + buf * kKT * LD, Vs + buf * kKT * LD, scale_log2, masked,
        [&](int i, int kk) {
          const int t = kb[kk];
          bool ok = t >= 0 && t <= qp[i];
          if (window > 0) ok = ok && t > qp[i] - window;
          return ok;
        },
        st);
  };
  lookup(0);
  tc::walk<HD, NS>(n, Qs, st, issue, stage);
  tc::store_rows<HD>(st, Qs, out, b, C, H, h, G, r0, r_end);
}

// ------------------------------------------------------------- launch
template <int HD>
int launch(int dtype, const void* q, const void* kp, const void* vp,
           const void* tbl, const void* start, const void* q_pos, void* out,
           int B, int C, int K, int G, int NB, int bs, int MB, int window,
           cudaStream_t s) {
  const double scale = 1.0 / std::sqrt(static_cast<double>(HD));
  dim3 grid(B * K, (C * G + kM - 1) / kM);
  if (dtype == rt::DTYPE_BF16) {
    const size_t smem = smem_bytes_bf16<HD>();
    static const cudaError_t attr =
        rt::allow_smem(paged_prefill_bf16<HD>, smem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    paged_prefill_bf16<HD><<<grid, rt::tile::tc::kThreads, smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(kp),
        static_cast<const bf16*>(vp), static_cast<const int*>(tbl),
        static_cast<const int*>(start), static_cast<const int*>(q_pos),
        static_cast<bf16*>(out), C, K, G, NB, bs, MB, window,
        static_cast<float>(rt::tile::tc::kLog2e * scale));
    return 0;
  }
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

}  // namespace

// q (B, C, K*G, hd); kp/vp (K, NB, bs, hd); tbl (B, MB) int32; start (B,)
// int32; q_pos (B, C) int32 (checked == start[b] + c); out like q.
// window <= 0 means none.  hd 32, 64, 128, 192 or 256.
extern "C" int paged_prefill(const void* q, const void* kp, const void* vp,
                             const void* tbl, const void* start,
                             const void* q_pos, void* out, int B, int C,
                             int K, int G, int NB, int bs, int MB, int hd,
                             int window, int dtype, void* stream) {
  if (G < 1 || C < 1 || bs < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  int bad;
  switch (hd) {
    case 32:
      bad = launch<32>(dtype, q, kp, vp, tbl, start, q_pos, out, B, C, K, G,
                       NB, bs, MB, window, s);
      break;
    case 64:
      bad = launch<64>(dtype, q, kp, vp, tbl, start, q_pos, out, B, C, K, G,
                       NB, bs, MB, window, s);
      break;
    case 128:
      bad = launch<128>(dtype, q, kp, vp, tbl, start, q_pos, out, B, C, K, G,
                        NB, bs, MB, window, s);
      break;
    case 192:
      bad = launch<192>(dtype, q, kp, vp, tbl, start, q_pos, out, B, C, K, G,
                        NB, bs, MB, window, s);
      break;
    case 256:
      bad = launch<256>(dtype, q, kp, vp, tbl, start, q_pos, out, B, C, K, G,
                        NB, bs, MB, window, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bad) return bad;
  return rt::launch_status();
}
