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
// ridge (~295), so the ideal kernel is memory-bound.  This kernel runs its
// products on CUDA cores in float32, so in practice it is bound by those
// operations; tensor cores (mma / wgmma) are later work.
//
// Design: one CTA of 256 threads per (row, kv head, tile of 64 query-head
// rows).  Tile row r is query r / G of query head h * G + r % G, so all G
// heads of a kv head share the staged keys (GQA without K/V replication),
// and at the serving shape (C = 64, G = 1) one tile holds the whole chunk:
// each history key is read from device memory once per (row, kv head).
// The CTA walks logical key positions from the first one its window can
// see up to its last query — keys wholly in the future or wholly outside
// the window are never visited — in stages of 64 keys, each resolved
// through the block table (a -1 entry is never read; its key is staged as
// zeros and masked).  Per stage:
//  * K and V go to shared memory as float32 rows padded to HD + 4 floats;
//  * each thread computes a 4 x 4 register tile of scores (rows 4*ty + i,
//    keys tx + 16*j) from float4 reads — the odd padded stride keeps the
//    key reads free of bank conflicts — so a shared-memory read feeds
//    eight FMAs rather than half of one;
//  * masking (kpos <= qpos, window, table) sets probabilities to exactly
//    0; the float32 online softmax's row max and row sum are reduced
//    across the 16 threads of a row group with shuffles;
//  * the probabilities go through shared memory to the P @ V product,
//    where each thread owns 4 rows x HD/16 output columns in registers.
//
// Queries sit at start[b] + c.  The kernel also receives the positions
// the plain version would take and asserts they are that contiguous run.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kM = 64;      // query-head rows per CTA
constexpr int kKT = 64;     // keys per staged sub-tile
constexpr int kRPT = 4;     // rows per thread (kM / 16)
constexpr int kKPT = 4;     // keys per thread (kKT / 16)
constexpr int kLDP = kM + 4;  // padded row stride of the probability tile
static_assert(kRPT == 4 && kM == 16 * kRPT && kKT == 16 * kKPT &&
                  kThreads == 256,
              "the thread layout is 16 row groups x 16 key groups");

template <int HD>
constexpr size_t smem_bytes() {
  return (static_cast<size_t>(kM + 2 * kKT) * (HD + 4) + kKT * kLDP) *
             sizeof(float) +
         kKT * (sizeof(long long) + sizeof(int));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) paged_prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, const int* __restrict__ tbl,
    const int* __restrict__ start, const int* __restrict__ q_pos,
    T* __restrict__ out, int C, int K, int G, int NB, int bs, int MB,
    int window, float scale) {
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
      v = rt::to_f32(q[((static_cast<size_t>(b) * C + c) * H + hq) * HD + d]);
    }
    Qs[r * LD + d] = v;
  }

  int qp[kRPT];  // absolute position of each owned row; -1 for a dead row
  float m[kRPT], l[kRPT], acc[kRPT][DPT];
#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    const int rr = r0 + ty * kRPT + i;
    qp[i] = rr < r_end ? st + rr / G : -1;
    m[i] = rt::neg_inf();
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = 0.f;
  }

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
        kv = rt::to_f32(kp[koff[kk] + d]);
        vv = rt::to_f32(vp[koff[kk] + d]);
      }
      Ks[kk * LD + d] = kv;
      Vs[kk * LD + d] = vv;
    }
    __syncthreads();

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
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < kKPT; ++j) {
        const int t = kpos[tx + 16 * j];
        bool ok = t >= 0 && t <= qp[i];
        if (window > 0) ok = ok && t > qp[i] - window;
        s[i][j] = ok ? s[i][j] * scale : rt::neg_inf();
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      // mx stays -inf while the row has seen no live key: then every
      // probability is 0 and nothing is rescaled
      const float corr = mx == rt::neg_inf() ? 1.f : expf(m[i] - mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kKPT; ++j) {
        const float p = s[i][j] == rt::neg_inf() ? 0.f : expf(s[i][j] - mx);
        s[i][j] = p;
        rs += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      m[i] = mx;
      l[i] = l[i] * corr + rs;
#pragma unroll
      for (int e = 0; e < DPT; ++e) acc[i][e] *= corr;
    }
#pragma unroll
    for (int j = 0; j < kKPT; ++j)
      *reinterpret_cast<float4*>(&Ps[(tx + 16 * j) * kLDP + ty * kRPT]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kKT; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(&Ps[kk * kLDP + ty * kRPT]);
#pragma unroll
      for (int e = 0; e < DPT; ++e) {
        const float v = Vs[kk * LD + tx + 16 * e];
        acc[0][e] += p.x * v;
        acc[1][e] += p.y * v;
        acc[2][e] += p.z * v;
        acc[3][e] += p.w * v;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    const int rr = r0 + ty * kRPT + i;
    if (rr >= r_end) continue;
    const int c = rr / G, hq = h * G + rr % G;
    const float den = fmaxf(l[i], 1e-30f);
    T* o = out + ((static_cast<size_t>(b) * C + c) * H + hq) * HD;
#pragma unroll
    for (int e = 0; e < DPT; ++e)
      o[tx + 16 * e] = rt::from_f32<T>(acc[i][e] / den);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* kp, const void* vp, const void* tbl,
           const void* start, const void* q_pos, void* out, int B, int C,
           int K, int G, int NB, int bs, int MB, int window, cudaStream_t s) {
  const float scale =
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(HD)));
  const size_t smem = smem_bytes<HD>();
  // once per instantiation: the port drives one card per process
  static const cudaError_t attr = cudaFuncSetAttribute(
      paged_prefill_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid(B * K, (C * G + kM - 1) / kM);
  paged_prefill_kernel<T, HD><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(tbl),
      static_cast<const int*>(start), static_cast<const int*>(q_pos),
      static_cast<T*>(out), C, K, G, NB, bs, MB, window, scale);
  return 0;
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* kp, const void* vp,
                const void* tbl, const void* start, const void* q_pos,
                void* out, int B, int C, int K, int G, int NB, int bs, int MB,
                int window, cudaStream_t s) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, kp, vp, tbl, start, q_pos, out, B, C, K, G, NB,
                           bs, MB, window, s);
    case 64:
      return launch<T, 64>(q, kp, vp, tbl, start, q_pos, out, B, C, K, G, NB,
                           bs, MB, window, s);
    case 128:
      return launch<T, 128>(q, kp, vp, tbl, start, q_pos, out, B, C, K, G,
                            NB, bs, MB, window, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, C, K*G, hd); kp/vp (K, NB, bs, hd); tbl (B, MB) int32; start (B,)
// int32; q_pos (B, C) int32 (checked == start[b] + c); out like q.
// window <= 0 means none.
extern "C" int paged_prefill(const void* q, const void* kp, const void* vp,
                             const void* tbl, const void* start,
                             const void* q_pos, void* out, int B, int C,
                             int K, int G, int NB, int bs, int MB, int hd,
                             int window, int dtype, void* stream) {
  if (G < 1 || C < 1 || bs < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int bad =
      dtype == rt::DTYPE_BF16
          ? dispatch_hd<__nv_bfloat16>(hd, q, kp, vp, tbl, start, q_pos, out,
                                       B, C, K, G, NB, bs, MB, window, s)
          : dispatch_hd<float>(hd, q, kp, vp, tbl, start, q_pos, out, B, C,
                               K, G, NB, bs, MB, window, s);
  if (bad) return bad;
  return rt::launch_status();
}
