// Dense blocked GQA attention with causal and sliding-window masks (the
// prefill of the ring-cache engine).
//
// Replaces: src/repro/kernels/flash_attention/flash.py:33, `_flash_kernel`
// under `flash_attention` (its pl.pallas_call at :107).
//
// Bound on this card, bf16, per the shapes its callers give it:
//  * the warm-function launcher's prefill at Llama-2-7B widths (3 rows x
//    500 tokens, 32 heads of 128): bytes, q, k, v and o 49.2 MB (14.7 us
//    at 3.35 TB/s) against 6.2 GFLOP of causal products (6.2 us);
//  * phase 17's sharded prefill (1 x 32768 causal) and Whisper's 1500-frame
//    encoder: operations (8.8 TFLOP, 8.9 ms; 36.9 GFLOP, 37.3 us).
// The CTAs re-read the keys of their own walks (from L2 for the most
// part), and what sets the time is how well the tensor-core products, the
// softmax between them and the copies overlap.
//
// Design.  The TPU grid's sequential kv axis, whose scratch (m, l, acc)
// persisted across steps, becomes a loop inside one CTA.  One CTA per
// (batch row, kv head, tile of query-head rows); tile row r is query r / G
// of query head h * G + r % G, so all G heads of a kv head share the
// staged keys (GQA without K/V replication).  q, k and v are read in place
// in the model's (B, T, H, hd) / (B, T, K, hd) layout.  The grid's fast
// axis is the tile, so the CTAs in flight walk the keys of few (row, kv
// head)s and share them in L2; tiles run from the last (the longest causal
// walk) to the first.  The CTA walks keys only from the window's first key
// (rounded down to a stage boundary) to the tile's last query (causal) or
// to the last key — the work the Pallas kernel skips with pl.when.  Rows
// past Tq are neither computed into nor written.  A row that sees no key
// at all (possible only without causality's own diagonal) writes zeros,
// with the max(l, 1e-30) guard of flash.py:83.
//
// Query offset (q0): query i sits at position q0 + i, key j at j, so a
// sharded ring prefill can hand each rank its own chunks of the queries
// over the keys up to its last one.  Every position the masks and the
// walk bounds read is shifted by q0; the rows of q and out stay indexed
// from 0.  Where a chunk's call and the whole call take the same tile
// (flash_tile_rows) and q0 is a multiple of its queries, kM / G, the
// chunk's tiles and stages line up with the whole call's, so its rows come
// out bit for bit the same.
//
// Which tile step (prefill_tile.cuh) runs is set by the dtype:
//  * bf16: the Hopper step, rt::tile::wg: a producer warpgroup whose one
//    thread keeps a ring of K/V stages in flight with TMA (4-d tensor maps
//    over k and v, (hd, K, Tk, B), boxes of 64 columns x KT keys; keys past
//    Tk read zeros), and one or two consumer warpgroups of 64 query-head
//    rows each on wgmma.  Tile rule (wg::tile_rows over flash_walk, the
//    longest walk: Tk, or the window and a tile's queries): 128 rows where
//    there are 128 and hd is 192 or 256, or 128 with a walk of 512 keys or
//    more; else 64.  So the launcher's 3 x 500, the zoo's 8 x 256, the
//    narrow windows and Whisper (hd 64) take 64-row tiles, two CTAs an SM;
//    the long walks (1 x 32768, Phi-3's 4096-key chunks), hd 192 and hd
//    256 take 128.  Per-element masks run only on a warp's stages that
//    cross its causal diagonal, its window's first key or Tk; the stages
//    that mask all of a warpgroup's rows are not computed by it.  Shared
//    memory and registers per head dim: prefill_tile.cuh.
//  * float32: the CUDA-core step of 256 threads, 64-row tiles, with 16-byte
//    loads staged synchronously into float32 rows (164 KB at hd 192, 212
//    KB at hd 256).
// Split-KV is not used: at the serving shapes the grid already holds 3 or
// more waves of CTAs (768 tiles at 3 rows x 500 tokens).
//
// Prefix-LM (PaliGemma's image prefix, the reference's mask kind
// "prefix"): with prefix > 0 a key at position < prefix is visible to
// every query, so under causality query i sees keys j <= max(i,
// prefix - 1), and the window, where there is one, still applies after
// that.  A tile's walk then ends at max(its last query, prefix - 1), and
// tiles wholly inside the prefix attend bidirectionally over it.  The
// rule is a template flag (PREFIX), so the causal kernels without a
// prefix compile to the code they had without the rule.
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
template <int HD, int NWG>
using CfgBf16 = rt::tile::wg::Cfg<HD, NWG, false>;

template <int HD, int NWG, bool PREFIX>
__global__ void __launch_bounds__(CfgBf16<HD, NWG>::kThreads,
                                  CfgBf16<HD, NWG>::kOcc)
    flash_kernel_bf16(const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const bf16* __restrict__ q, bf16* __restrict__ out,
                      int Tq, int Tk, int K, int G, int causal, int window,
                      int prefix, int q0, float scale_log2) {
  namespace wg = rt::tile::wg;
  using C = CfgBf16<HD, NWG>;
  constexpr int KT = C::KT;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const wg::Smem<C> sm(smem_raw);

  // the tiles of one (row, kv head) are neighbours in the grid, so the
  // CTAs in flight share their keys in L2
  const int b = blockIdx.y / K, h = blockIdx.y % K;
  const int H = K * G, rows = Tq * G;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * C::kM;  // longest first
  const int r_end = min(rows, r0 + C::kM);               // exclusive
  const int q_first = q0 + r0 / G, q_last = q0 + (r_end - 1) / G;
  const int t_lo = window > 0 ? max(0, q_first - window + 1) / KT * KT : 0;
  const int t_hi = causal ? min(PREFIX ? max(q_last, prefix - 1) : q_last,
                               Tk - 1)
                         : Tk - 1;  // inclusive
  const int n = t_hi >= t_lo ? (t_hi - t_lo) / KT + 1 : 0;
  sm.init_barriers();

  if (threadIdx.x < 128) {  // the producer warpgroup: one thread copies
    wg::producer_regs<C>();
    const CUtensorMap *kp = &kmap, *vp = &vmap;
    if (threadIdx.x == 0) {
      rt::tma_prefetch(kp);
      rt::tma_prefetch(vp);
    }
    if (threadIdx.x == 0)
      wg::produce<C>(0, n, sm, [&](int s, int slot) {
        const int k0 = t_lo + s * KT;
        rt::mbar_arrive_tx(&sm.full[slot], 2 * C::kTileBytes);
#pragma unroll
        for (int j = 0; j < C::NCH; ++j) {
          const int off = slot * C::kTileBytes + j * KT * C::SWB;
          rt::tma_load_4d(sm.k + off, kp, &sm.full[slot], j * C::SW, h, k0,
                          b);
          rt::tma_load_4d(sm.v + off, vp, &sm.full[slot], j * C::SW, h, k0,
                          b);
        }
      });
  } else {  // the consumer warpgroups
    wg::consumer_regs<C>();
    const int w = threadIdx.x / 128 - 1, tid = threadIdx.x & 127;
    const int lane = tid & 31;
    wg::stage_q<C>(sm.q, q, b, Tq, H, h, G, w, r0, r_end, tid);

    // the warpgroup's rows: query positions [qg_lo, qg_hi]; the warp's:
    // [qw_lo, qw_hi]; each lane's two rows' positions
    const int g0 = r0 + 64 * w, w0 = g0 + 16 * (tid >> 5);
    const bool live = g0 < r_end;
    const int qg_lo = q0 + g0 / G, qg_hi = q0 + (min(r_end, g0 + 64) - 1) / G;
    const int qw_lo = q0 + w0 / G, qw_hi = q0 + (min(r_end, w0 + 16) - 1) / G;
    int qp[2];  // -1 for a dead row
  #pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rr = w0 + (lane >> 2) + 8 * i;
      qp[i] = rr < r_end ? q0 + rr / G : -1;
    }
    // under causality the rows see keys up to these (the prefix widens
    // each row's edge to at least prefix - 1)
    const int edge_g = PREFIX ? max(qg_hi, prefix - 1) : qg_hi;
    const int edge_lo = PREFIX ? max(qw_lo, prefix - 1) : qw_lo;

    wg::Rows<HD> st;
    st.init();
    wg::consume<C>(
        0, n, sm, w, scale_log2,
        [&](int s) {  // every key of the stage is masked for every row
          const int k0 = t_lo + s * KT, k1 = k0 + KT - 1;
          return !live || (causal && k0 > edge_g) ||
                 (window > 0 && k1 <= qg_lo - window);
        },
        [&](int s) {  // the warp's rows need per-key masks
          const int k0 = t_lo + s * KT, k1 = k0 + KT - 1;
          return k1 > t_hi || (causal && k1 > edge_lo) ||
                 (window > 0 && k0 <= qw_hi - window);
        },
        [&](int s, int i, int kk) {
          const int t = t_lo + s * KT + kk;
          bool ok = qp[i] >= 0 && t <= t_hi;
          if (causal) ok = ok && (t <= qp[i] || (PREFIX && t < prefix));
          if (window > 0) ok = ok && t > qp[i] - window;
          return ok;
        },
        st);
    wg::store_rows<C>(st, sm.q, out, b, Tq, H, h, G, w, r0, r_end);
  }
}

// ------------------------------------------------------------- launch
template <int HD, int NWG, bool PREFIX>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int B, int Tq, int Tk, int K, int G, int causal, int window,
                int prefix, int q0, float scale_log2, cudaStream_t s) {
  using C = CfgBf16<HD, NWG>;
  // k and v (B, Tk, K, HD) as 4-d maps (HD, K, Tk, B); a box is SW
  // columns of KT keys of one (row, kv head); keys past Tk read zeros
  const cuuint64_t dims[4] = {HD, static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(Tk),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {HD * 2ull, HD * 2ull * K,
                                 HD * 2ull * K * Tk};
  const cuuint32_t box[4] = {C::SW, 1, C::KT, 1};
  CUtensorMap km, vm;
  if (!rt::bf16_tensor_map(&km, k, 4, dims, strides, box, C::SWB) ||
      !rt::bf16_tensor_map(&vm, v, 4, dims, strides, box, C::SWB))
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr =
      rt::allow_smem(flash_kernel_bf16<HD, NWG, PREFIX>, C::kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((Tq * G + C::kM - 1) / C::kM, B * K);
  flash_kernel_bf16<HD, NWG, PREFIX><<<grid, C::kThreads, C::kBytes, s>>>(
      km, vm, static_cast<const bf16*>(q), static_cast<bf16*>(out), Tq, Tk,
      K, G, causal, window, prefix, q0, scale_log2);
  return 0;
}

template <int HD, bool PREFIX>
int launch_kernel(int dtype, const void* q, const void* k, const void* v,
                  void* out, int B, int Tq, int Tk, int K, int G, int causal,
                  int window, int prefix, int q0, cudaStream_t s) {
  const double scale = 1.0 / std::sqrt(static_cast<double>(HD));
  if (dtype == rt::DTYPE_BF16) {
    const float sl2 = static_cast<float>(rt::tile::wg::kLog2e * scale);
    return rt::tile::wg::tile_rows(HD, Tq * G,
                                   rt::tile::wg::flash_walk(Tk, G, window)) ==
                   128
               ? launch_bf16<HD, 2, PREFIX>(q, k, v, out, B, Tq, Tk, K, G,
                                            causal, window, prefix, q0, sl2,
                                            s)
               : launch_bf16<HD, 1, PREFIX>(q, k, v, out, B, Tq, Tk, K, G,
                                            causal, window, prefix, q0, sl2,
                                            s);
  }
  dim3 grid(B * K, (Tq * G + kM - 1) / kM);
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

}  // namespace

// The kernels with the prefix rule (PREFIX) are instantiated in a
// translation unit of their own, flash_attn_prefix.cu, which includes this
// file with REPRO_FLASH_PREFIX_TU defined: the two halves of the build
// then compile in parallel.
int flash_attn_prefix_launch(int dtype, const void* q, const void* k,
                             const void* v, void* out, int B, int Tq, int Tk,
                             int K, int G, int hd, int causal, int window,
                             int prefix, int q0, cudaStream_t s);

#ifdef REPRO_FLASH_PREFIX_TU
int flash_attn_prefix_launch(int dtype, const void* q, const void* k,
                             const void* v, void* out, int B, int Tq, int Tk,
                             int K, int G, int hd, int causal, int window,
                             int prefix, int q0, cudaStream_t s) {
  switch (hd) {
#define REPRO_CASE(HD)                                                      \
  case HD:                                                                  \
    return launch_kernel<HD, true>(dtype, q, k, v, out, B, Tq, Tk, K, G,     \
                                   causal, window, prefix, q0, s);
    REPRO_CASE(32)
    REPRO_CASE(64)
    REPRO_CASE(128)
    REPRO_CASE(192)
    REPRO_CASE(256)
#undef REPRO_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
#else
namespace {

template <int HD>
int launch(int dtype, const void* q, const void* k, const void* v, void* out,
           int B, int Tq, int Tk, int K, int G, int causal, int window,
           int prefix, int q0, cudaStream_t s) {
  return causal && prefix > 0
             ? flash_attn_prefix_launch(dtype, q, k, v, out, B, Tq, Tk, K, G,
                                        HD, causal, window, prefix, q0, s)
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

// Query-head rows of one CTA's tile of a flash call (tile_rows,
// prefill_tile.cuh; 64 in float32).  A call over a chunk of queries at an
// offset that is a multiple of this / G gives the whole call's rows bit
// for bit where the two calls' tiles are the same.
extern "C" int flash_tile_rows(int hd, int G, int Tq, int Tk, int window,
                               int dtype) {
  if (G < 1 || Tq < 1 || Tk < 1 || (hd != 32 && hd != 64 && hd != 128 &&
                                    hd != 192 && hd != 256))
    return -1;
  return dtype == rt::DTYPE_BF16
             ? rt::tile::wg::tile_rows(hd, Tq * G,
                                       rt::tile::wg::flash_walk(Tk, G, window))
             : rt::tile::kM;
}
#endif  // REPRO_FLASH_PREFIX_TU
