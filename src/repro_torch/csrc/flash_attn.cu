// Dense blocked GQA attention with causal and sliding-window masks (the
// prefill of the ring-cache engine).
//
// Replaces: src/repro/kernels/flash_attention/flash.py:33, `_flash_kernel`
// under `flash_attention` (its pl.pallas_call at :107).
//
// Bound on this card: bytes for the warm-function launcher's prefill at
// Llama-2-7B widths (3 rows x 500 tokens, 32 heads of 128, bf16): q, k, v
// and o are 49.2 MB (14.7 us at 3.35 TB/s) against 6.2 GFLOP of causal
// products (6.2 us at 989 TFLOP/s on the tensor cores).  This kernel runs
// its products on CUDA cores in float32 (67 TFLOP/s peak), so in practice
// it is bound by those operations; tensor cores (mma / wgmma) are later
// work.
//
// Design: the paged-prefill kernel's tile step (prefill_tile.cuh), on
// contiguous storage.  The TPU grid's sequential kv axis, whose scratch
// (m, l, acc) persisted across steps, becomes a loop inside one CTA.  One
// CTA of 256 threads per (batch row, kv head, tile of 64 query-head rows);
// tile row r is query r / G of query head h * G + r % G, so all G heads of
// a kv head share the staged keys (GQA without K/V replication).  q, k and
// v are read in place in the model's (B, T, H, hd) / (B, T, K, hd) layout,
// with 16-byte (float) or 8-byte (bf16) vector loads.  The CTA walks keys
// only from the window's first key to the tile's last query (causal) or to
// the last key — the work the Pallas kernel skips with pl.when — in stages
// of 64 keys, masked by length (t < Tk), causality and window.
// Rows past Tq are neither computed into nor written.  A row that sees no
// key at all (possible only without causality's own diagonal) writes
// zeros, with the max(l, 1e-30) guard of flash.py:83.
#include <cmath>

#include "prefill_tile.cuh"

namespace {

using rt::tile::kKT;
using rt::tile::kLDP;
using rt::tile::kM;
using rt::tile::kRPT;
using rt::tile::kThreads;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int Tq, int Tk, int K,
    int G, int causal, int window, float scale) {
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
  const int q_first = r0 / G;
  const int q_last = (r_end - 1) / G;

  for (int i = tid; i < kM * V4; i += kThreads) {
    const int r = i / V4, d = (i % V4) * 4, rr = r0 + r;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (rr < r_end) {
      const int c = rr / G, hq = h * G + rr % G;
      rt::load4(q + ((static_cast<size_t>(b) * Tq + c) * H + hq) * HD + d,
                x);
    }
    *reinterpret_cast<float4*>(&Qs[r * LD + d]) =
        make_float4(x[0], x[1], x[2], x[3]);
  }

  int qp[kRPT];  // query position of each owned row; -1 for a dead row
#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    const int rr = r0 + ty * kRPT + i;
    qp[i] = rr < r_end ? rr / G : -1;
  }
  rt::tile::Rows<HD> rows_st;
  rows_st.init();

  const int t_lo = window > 0 ? max(0, q_first - window + 1) : 0;
  const int t_hi = causal ? min(q_last, Tk - 1) : Tk - 1;  // inclusive
  for (int k0 = t_lo; k0 <= t_hi; k0 += kKT) {
    __syncthreads();  // the previous stage is done with Ks / Vs / Ps
    for (int i = tid; i < kKT * V4; i += kThreads) {
      const int kk = i / V4, d = (i % V4) * 4, t = k0 + kk;
      float kx[4] = {0.f, 0.f, 0.f, 0.f}, vx[4] = {0.f, 0.f, 0.f, 0.f};
      if (t <= t_hi) {
        const size_t off =
            ((static_cast<size_t>(b) * Tk + t) * K + h) * HD + d;
        rt::load4(k + off, kx);
        rt::load4(v + off, vx);
      }
      *reinterpret_cast<float4*>(&Ks[kk * LD + d]) =
          make_float4(kx[0], kx[1], kx[2], kx[3]);
      *reinterpret_cast<float4*>(&Vs[kk * LD + d]) =
          make_float4(vx[0], vx[1], vx[2], vx[3]);
    }
    __syncthreads();
    rt::tile::attend_stage<HD>(
        Qs, Ks, Vs, Ps, scale,
        [&](int i, int j) {
          const int t = k0 + tx + 16 * j;
          bool ok = qp[i] >= 0 && t <= t_hi;
          if (causal) ok = ok && t <= qp[i];
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
    T* o = out + ((static_cast<size_t>(b) * Tq + c) * H + hq) * HD;
#pragma unroll
    for (int e = 0; e < DPT; ++e)
      o[tx + 16 * e] = rt::from_f32<T>(rows_st.out(i, e));
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Tq, int Tk, int K, int G, int causal, int window,
           cudaStream_t s) {
  const float scale =
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(HD)));
  const size_t smem = rt::tile::smem_floats<HD>() * sizeof(float);
  // once per instantiation: the port drives one card per process
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid(B * K, (Tq * G + kM - 1) / kM);
  flash_kernel<T, HD><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Tq, Tk, K, G, causal,
      window, scale);
  return 0;
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                void* out, int B, int Tq, int Tk, int K, int G, int causal,
                int window, cudaStream_t s) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, out, B, Tq, Tk, K, G, causal, window, s);
    case 64:
      return launch<T, 64>(q, k, v, out, B, Tq, Tk, K, G, causal, window, s);
    case 128:
      return launch<T, 128>(q, k, v, out, B, Tq, Tk, K, G, causal, window,
                            s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, Tq, K*G, hd); k/v (B, Tk, K, hd); out like q; all contiguous.
// Query i and key j sit at positions i and j.  causal != 0 keeps keys
// j <= i; window > 0 keeps keys j > i - window; window <= 0 means none.
extern "C" int flash_attn(const void* q, const void* k, const void* v,
                          void* out, int B, int Tq, int Tk, int K, int G,
                          int hd, int causal, int window, int dtype,
                          void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || K < 1 || G < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int bad =
      dtype == rt::DTYPE_BF16
          ? dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, B, Tq, Tk, K, G,
                                       causal, window, s)
          : dispatch_hd<float>(hd, q, k, v, out, B, Tq, Tk, K, G, causal,
                               window, s);
  if (bad) return bad;
  return rt::launch_status();
}
