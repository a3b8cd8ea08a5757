// Dense blocked GQA attention with causal and sliding-window masks (the
// prefill of the ring-cache engine).
//
// Replaces: src/repro/kernels/flash_attention/flash.py:33, `_flash_kernel`
// under `flash_attention` (its pl.pallas_call at :107).
//
// Bound on this card: bytes for the warm-function launcher's prefill at
// Llama-2-7B widths (3 rows x 500 tokens, 32 heads of 128, bf16): q, k, v
// and o are 49.2 MB (14.7 us at 3.35 TB/s) against 6.2 GFLOP of causal
// products (6.2 us at 989 TFLOP/s on the tensor cores).  Each CTA reads
// the keys of its own causal range again (from L2 for the most part), so
// what sets the time in practice is the rate at which the CTAs' copies
// and tensor-core products overlap, not device memory alone.
//
// Design.  The TPU grid's sequential kv axis, whose scratch (m, l, acc)
// persisted across steps, becomes a loop inside one CTA.  One CTA per
// (batch row, kv head, tile of 64 query-head rows); tile row r is query
// r / G of query head h * G + r % G, so all G heads of a kv head share the
// staged keys (GQA without K/V replication).  q, k and v are read in place
// in the model's (B, T, H, hd) / (B, T, K, hd) layout.  Tiles run from the
// last (the longest causal walk) to the first, so the long walks start in
// the first wave.  The CTA walks keys only from the window's first key
// (rounded down to a stage boundary) to the tile's last query (causal) or
// to the last key — the work the Pallas kernel skips with pl.when — in
// stages of 64 keys.  Rows past Tq are neither computed into nor written.
// A row that sees no key at all (possible only without causality's own
// diagonal) writes zeros, with the max(l, 1e-30) guard of flash.py:83.
//
// Query offset (q0): query i sits at position q0 + i, key j at j, so a
// sharded ring prefill can hand each rank its own chunks of the queries
// over the keys up to its last one.  Every position the masks and the
// walk bounds read (q_first, q_last, the warp's qw_lo / qw_hi, each row's
// qp, and the edges derived from them) is shifted by q0; the rows of q
// and out stay indexed from 0.  With q0 a multiple of 64 / G a chunk's
// tiles and stages line up with the whole call's, so its rows come out
// bit for bit the same.
//
// Which tile step (prefill_tile.cuh) runs is set by the dtype:
//  * bf16: the tensor-core step, 4 warps; K/V stages in a ring of two
//    buffers filled by cp.async, Q staged in the second (68 KB of shared
//    memory and 199 registers a thread at hd 128, so two CTAs fit on an
//    SM).  Per-element masks run only on a warp's stages that cross its
//    causal diagonal, its window's first key or Tk; a stage that masks
//    all of a warp's rows is skipped by that warp.
//  * float32: the CUDA-core step of 256 threads, with 16-byte loads staged
//    synchronously into float32 rows.
// Split-KV is not used: at the serving shapes the grid already holds
// 6 or more CTAs per SM (768 at 3 rows x 500 tokens).
//
// Prefix-LM (PaliGemma's image prefix, the reference's mask kind
// "prefix"): with prefix > 0 a key at position < prefix is visible to
// every query, so under causality query i sees keys j <= max(i,
// prefix - 1), and the window, where there is one, still applies after
// that.  A tile's walk then ends at max(its last query, prefix - 1), and
// tiles wholly inside the prefix attend bidirectionally over it.  The
// rule is a template flag (PREFIX), so the causal kernels without a
// prefix compile to the code they had without the rule.
//
// hd 192 and 256 (Nemotron-4-340B, PaliGemma-3B, RecurrentGemma-9B) take
// the hd-256 route of the tensor-core step (prefill_tile.cuh, q_in_smem:
// Q's fragments reloaded per stage from a buffer of their own) with the
// same two ring stages: 125 KB at hd 192, 165 KB at hd 256, one CTA an
// SM.  float32: 164 KB and 212 KB.
#include <cmath>

#include "prefill_tile.cuh"

namespace {

using rt::tile::kKT;
using rt::tile::kM;
using bf16 = __nv_bfloat16;

// ------------------------------------------------------------- float32
template <int HD, bool PREFIX>
__global__ void __launch_bounds__(rt::tile::kThreads) flash_kernel_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int Tq, int Tk,
    int K, int G, int causal, int window, int prefix, int q0, float scale) {
  using rt::tile::kLDP;
  using rt::tile::kRPT;
  using rt::tile::kThreads;
  constexpr int LD = HD + 4;    // padded row stride of Qs / Ks / Vs
  constexpr int DPT = HD / 16;  // output columns per thread
  constexpr int V4 = HD / 4;    // 4-element vectors per row
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;          // [kM][LD]
  float* Ks = Qs + kM * LD;  // [kKT][LD]
  float* Vs = Ks + kKT * LD; // [kKT][LD]
  float* Ps = Vs + kKT * LD; // [kKT][kLDP]

  const int b = blockIdx.x / K, h = blockIdx.x % K;
  const int H = K * G, rows = Tq * G;
  const int r0 = blockIdx.y * kM;
  const int r_end = min(rows, r0 + kM);  // exclusive
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q_first = q0 + r0 / G;  // positions of the tile's queries
  const int q_last = q0 + (r_end - 1) / G;

  for (int i = tid; i < kM * V4; i += kThreads) {
    const int r = i / V4, d = (i % V4) * 4, rr = r0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (rr < r_end) {
      const int c = rr / G, hq = h * G + rr % G;
      x = *reinterpret_cast<const float4*>(
          q + ((static_cast<size_t>(b) * Tq + c) * H + hq) * HD + d);
    }
    *reinterpret_cast<float4*>(&Qs[r * LD + d]) = x;
  }

  int qp[kRPT];  // query position of each owned row; -1 for a dead row
#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    const int rr = r0 + ty * kRPT + i;
    qp[i] = rr < r_end ? q0 + rr / G : -1;
  }
  rt::tile::Rows<HD> rows_st;
  rows_st.init();

  const int t_lo = window > 0 ? max(0, q_first - window + 1) : 0;
  const int t_hi = causal ? min(PREFIX ? max(q_last, prefix - 1) : q_last,
                               Tk - 1)
                         : Tk - 1;  // inclusive
  for (int k0 = t_lo; k0 <= t_hi; k0 += kKT) {
    __syncthreads();  // the previous stage is done with Ks / Vs / Ps
    for (int i = tid; i < kKT * V4; i += kThreads) {
      const int kk = i / V4, d = (i % V4) * 4, t = k0 + kk;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (t <= t_hi) {
        const size_t off =
            ((static_cast<size_t>(b) * Tk + t) * K + h) * HD + d;
        kx = *reinterpret_cast<const float4*>(k + off);
        vx = *reinterpret_cast<const float4*>(v + off);
      }
      *reinterpret_cast<float4*>(&Ks[kk * LD + d]) = kx;
      *reinterpret_cast<float4*>(&Vs[kk * LD + d]) = vx;
    }
    __syncthreads();
    rt::tile::attend_stage<HD>(
        Qs, Ks, Vs, Ps, scale,
        [&](int i, int j) {
          const int t = k0 + tx + 16 * j;
          bool ok = qp[i] >= 0 && t <= t_hi;
          if (causal) ok = ok && (t <= qp[i] || (PREFIX && t < prefix));
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
    float* o = out + ((static_cast<size_t>(b) * Tq + c) * H + hq) * HD;
#pragma unroll
    for (int e = 0; e < DPT; ++e) o[tx + 16 * e] = rows_st.out(i, e);
  }
}

// ------------------------------------------------------------ bfloat16
constexpr int kStagesBf16 = 2;

template <int HD, bool PREFIX>
__global__ void __launch_bounds__(rt::tile::tc::kThreads, 2)
    flash_kernel_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out,
                      int Tq, int Tk, int K, int G, int causal, int window,
                      int prefix, int q0, float scale_log2) {
  namespace tc = rt::tile::tc;
  constexpr int NS = kStagesBf16, LD = tc::ld<HD>(), CH = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [NS][kKT][LD]
  bf16* Vs = Ks + NS * kKT * LD;                 // [NS][kKT][LD]
  bf16* Qs = tc::q_buffer<HD, NS>(Ks);           // [kM][LD]

  const int b = blockIdx.x / K, h = blockIdx.x % K;
  const int H = K * G, rows = Tq * G;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kM;  // longest walks first
  const int r_end = min(rows, r0 + kM);              // exclusive
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  tc::stage_q<HD>(Qs, q, b, Tq, H, h, G, r0, r_end);
  rt::cp_async_commit();

  // the warp's rows: query positions [qw_lo, qw_hi] and each lane's two
  // rows' positions
  const int w0 = r0 + 16 * warp;
  const bool live = w0 < r_end;
  const int qw_lo = q0 + w0 / G, qw_hi = q0 + (min(r_end, w0 + 16) - 1) / G;
  int qp[2];  // -1 for a dead row
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rr = w0 + (lane >> 2) + 8 * i;
    qp[i] = rr < r_end ? q0 + rr / G : -1;
  }

  const int q_first = q0 + r0 / G, q_last = q0 + (r_end - 1) / G;
  const int t_lo =
      window > 0 ? max(0, q_first - window + 1) / kKT * kKT : 0;
  const int t_hi = causal ? min(PREFIX ? max(q_last, prefix - 1) : q_last,
                               Tk - 1)
                         : Tk - 1;  // inclusive
  const int n = t_hi >= t_lo ? (t_hi - t_lo) / kKT + 1 : 0;
  // under causality the warp's rows see keys up to these (the prefix
  // widens each row's edge to at least prefix - 1)
  const int edge_lo = PREFIX ? max(qw_lo, prefix - 1) : qw_lo;
  const int edge_hi = PREFIX ? max(qw_hi, prefix - 1) : qw_hi;

  tc::Rows<HD> st;

  auto issue = [&](int s, int buf) {
    const int k0 = t_lo + s * kKT;
    bf16* Kb = Ks + buf * kKT * LD;
    bf16* Vb = Vs + buf * kKT * LD;
    for (int c = tid; c < kKT * CH; c += tc::kThreads) {
      const int kk = c / CH, ch = c % CH, t = k0 + kk;
      const bool ok = t <= t_hi;
      const size_t off =
          ok ? ((static_cast<size_t>(b) * Tk + t) * K + h) * HD + ch * 8 : 0;
      rt::cp_async16(Kb + kk * LD + ch * 8, k + off, ok);
      rt::cp_async16(Vb + kk * LD + ch * 8, v + off, ok);
    }
  };
  auto stage = [&](int s, int buf) {
    const int k0 = t_lo + s * kKT, k1 = k0 + kKT - 1;
    if (!live || (causal && k0 > edge_hi) ||
        (window > 0 && k1 <= qw_lo - window))
      return;  // every key of the stage is masked for every row
    const bool masked = k1 > t_hi || (causal && k1 > edge_lo) ||
                        (window > 0 && k0 <= qw_hi - window);
    tc::attend_stage<HD>(
        Ks + buf * kKT * LD, Vs + buf * kKT * LD, scale_log2, masked,
        [&](int i, int kk) {
          const int t = k0 + kk;
          bool ok = qp[i] >= 0 && t <= t_hi;
          if (causal) ok = ok && (t <= qp[i] || (PREFIX && t < prefix));
          if (window > 0) ok = ok && t > qp[i] - window;
          return ok;
        },
        st);
  };
  tc::walk<HD, NS>(n, Qs, st, issue, stage);
  tc::store_rows<HD>(st, Qs, out, b, Tq, H, h, G, r0, r_end);
}

// ------------------------------------------------------------- launch
template <int HD, bool PREFIX>
int launch_kernel(int dtype, const void* q, const void* k, const void* v,
                  void* out, int B, int Tq, int Tk, int K, int G, int causal,
                  int window, int prefix, int q0, cudaStream_t s) {
  const double scale = 1.0 / std::sqrt(static_cast<double>(HD));
  dim3 grid(B * K, (Tq * G + kM - 1) / kM);
  if (dtype == rt::DTYPE_BF16) {
    const size_t smem = rt::tile::tc::smem_bytes<HD, kStagesBf16>();
    static const cudaError_t attr =
        rt::allow_smem(flash_kernel_bf16<HD, PREFIX>, smem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    flash_kernel_bf16<HD, PREFIX><<<grid, rt::tile::tc::kThreads, smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out), Tq, Tk, K, G,
        causal, window, prefix, q0,
        static_cast<float>(rt::tile::tc::kLog2e * scale));
    return 0;
  }
  const size_t smem = rt::tile::smem_floats<HD>() * sizeof(float);
  static const cudaError_t attr =
      rt::allow_smem(flash_kernel_f32<HD, PREFIX>, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  flash_kernel_f32<HD, PREFIX><<<grid, rt::tile::kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Tq, Tk, K, G,
      causal, window, prefix, q0, static_cast<float>(scale));
  return 0;
}

template <int HD>
int launch(int dtype, const void* q, const void* k, const void* v, void* out,
           int B, int Tq, int Tk, int K, int G, int causal, int window,
           int prefix, int q0, cudaStream_t s) {
  return causal && prefix > 0
             ? launch_kernel<HD, true>(dtype, q, k, v, out, B, Tq, Tk, K, G,
                                       causal, window, prefix, q0, s)
             : launch_kernel<HD, false>(dtype, q, k, v, out, B, Tq, Tk, K, G,
                                        causal, window, prefix, q0, s);
}

}  // namespace

// q (B, Tq, K*G, hd); k/v (B, Tk, K, hd); out like q; all contiguous.
// Query i sits at position p = q0 + i and key j at j.  causal != 0 keeps
// keys j <= p, and also keys j < prefix (prefix <= 0 means none); window
// > 0 keeps keys j > p - window; window <= 0 means none.  hd 32, 64, 128,
// 192 or 256.
extern "C" int flash_attn(const void* q, const void* k, const void* v,
                          void* out, int B, int Tq, int Tk, int K, int G,
                          int hd, int causal, int window, int prefix, int q0,
                          int dtype, void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || K < 1 || G < 1 || q0 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  int bad;
  switch (hd) {
    case 32:
      bad = launch<32>(dtype, q, k, v, out, B, Tq, Tk, K, G, causal, window,
                       prefix, q0, s);
      break;
    case 64:
      bad = launch<64>(dtype, q, k, v, out, B, Tq, Tk, K, G, causal, window,
                       prefix, q0, s);
      break;
    case 128:
      bad = launch<128>(dtype, q, k, v, out, B, Tq, Tk, K, G, causal,
                        window, prefix, q0, s);
      break;
    case 192:
      bad = launch<192>(dtype, q, k, v, out, B, Tq, Tk, K, G, causal,
                        window, prefix, q0, s);
      break;
    case 256:
      bad = launch<256>(dtype, q, k, v, out, B, Tq, Tk, K, G, causal,
                        window, prefix, q0, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bad) return bad;
  return rt::launch_status();
}
