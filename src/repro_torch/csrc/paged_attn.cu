// Paged single-token GQA decode attention with an in-kernel block-table
// walk.
//
// Replaces: src/repro/kernels/paged_attention/paged_attn.py:48,
// `_paged_kernel` under `paged_decode_attention` (its pl.pallas_call at
// :116).
//
// Bound on this card: bytes.  A decode step reads every live key and value
// of every row once: at Llama-2-7B widths (K = 32 kv heads, hd = 128, bf16)
// that is 16 KiB per token per layer, so 8 rows at ~500 tokens move ~64
// MB per layer (~19 us at 3.35 TB/s), against ~1 flop per byte at G = 1:
// two orders of magnitude below the tensor-core ridge.
//
// Token t of a row at position pos is attended if lo <= t <= pos (lo = pos
// - window + 1 with a window, else 0) and its table entry is not -1; its
// row for kv head h is row (h * NB + phys) * bs + t % bs of the pool seen
// as (K * NB * bs, hd), a pool block being bs * hd contiguous elements per
// kv head.  A token that is not attended never reaches the output: the
// garbage block 0 holds what stalled rows wrote.  A row with no live key
// (an inactive slot) yields exact zeros, finite as the runtime requires.
//
// bfloat16 (the serving dtype): one launch on the pipelined step that ring
// decode runs too (ring_decode_step.cuh, rt::ring::step), with its merge
// folded in: no scratch in device memory, no second kernel.  A cluster of C
// CTAs takes one (row, kv head) with all of its G <= 16 query heads (the
// rows of the m16 tile: Nemotron-4-340B's 12 and RecurrentGemma-9B's 16
// read K and V once).  The decode step is captured once as a CUDA graph
// and pos is device data, so the grid and C come from the shapes alone
// (paged_plan, exported as paged_decode_plan); each CTA finds its share of
// its row's live range [lo, pos] in the kernel, in whole stages of P
// logical tokens (CTA c of C walks stages lo / P + [c n / C, (c + 1) n /
// C) of the n that hold the range), so rows at 128 and at 800 keys both
// spread over the cluster.  The producer warp resolves the block table
// per stage from registers (two chunks of 32 entries, the next in flight)
// and copies the stage's pieces with TMA: piece i is R = gcd(bs, P) tokens
// of one block, a box of R rows (a 3-d box of a piece's rows whole at hd
// 128 and 192, whose stage slots keep a row's 64-column chunks side by
// side; one box a 64-column chunk at hd 32, 64 and 256); a piece under a
// -1 entry, or wholly outside [lo, pos], is not copied.  The swizzle is a
// function of the shared-memory address, so a box of fewer than 8 rows
// (block sizes 4 and 12: R = 4; 6: R = 2) may start part way into its
// 1 KB period and still land where the consumers' ldmatrix reads it
// (phase 3 of chip_smoke.py holds block sizes 4, 6 and 12 to the plain
// version).  The stage's attended bits go to shared memory beside the
// ring; everything else in the slot (the rest of a copied block, a piece
// not copied) keeps what it held and is selected away by the consumers.
// Stages hold 64 slots (128 at hd 64 and below) and the ring 3 of them:
// 96 KB, two CTAs an SM, up to hd 128; 144 and 192 KB at hd 192 and 256,
// one CTA an SM, all four consumer warps busy on a stage.
//
// float32 (the SMOKE parity runs) keeps the split-KV design: one CTA per
// (row, kv head, head group of at most 8, partition of `part` tokens) on
// the partition step ring decode's float32 path shares (decode_tile.cuh),
// staging the partition's rows with cp.async, then
// rt::split_kv_merge_kernel.  At hd 256 a partition of 64 slots and 8
// heads stages 163 KB, above the 48 KB default: the launcher raises the
// limit once per instantiation (rt::allow_smem) to its largest partition
// (dec::max_part).
#include <cmath>
#include <utility>

#include "ring_decode_step.cuh"

namespace rt {
namespace ring {

constexpr int kPagedStages = 3;
constexpr int kMaxRounds = 4;  // pieces a lane copies: P / R / 32 <= 4

// Slots a stage of paged decode: the most (a power of two, 32..128) whose
// K and V rows fit kStageBytes, or twice that at hd 192 and 256 (one CTA
// an SM), so that a stage holds 64 slots and all four consumer warps have
// a 16-slot group of it.
__host__ __device__ constexpr int paged_part(int hd) {
  int part = 128;
  while (part > 32 && 4 * part * hd > (hd > 128 ? 2 : 1) * kStageBytes)
    part /= 2;
  return part;
}

// Paged decode's plan: P = paged_part(hd) slots a stage, kPagedStages
// stages, and C (a power of two, 1..8, at most half the stages of the
// table's span) the largest that keeps the grid of B x K clusters within
// one CTA an SM.
inline Plan paged_plan(int B, int K, int MB, int bs, int hd) {
  Plan p{1, paged_part(hd), kPagedStages};
  const long units = static_cast<long>(B) * K;
  const int np = (MB * bs + p.part - 1) / p.part;
  while (p.cluster < kMaxCluster && units * p.cluster * 2 <= kSms &&
         2 * p.cluster <= np)
    p.cluster *= 2;
  return p;
}

// Bytes of paged decode's dynamic shared memory: the 1024-aligned ring,
// the stages' bits and, for ROWS 16, the Q tile.
template <int HD, int ROWS>
constexpr size_t paged_smem_bytes(int part, int stages) {
  return 1024 + span_bytes<HD, ROWS>(part, stages) +
         sizeof(uint32_t) * kMaxStages * kSlotWords +
         (ROWS == 16 ? sizeof(bf16) * 16 * q_ld<HD>() : 0);
}

// The CTA's stages [a, a + n) of P logical tokens of row b's table (tbl:
// its MB entries), live tokens [lo, hi], kv head h; pieces of R tokens (R
// = gcd(bs, P), a power of two).  The producer's copy keeps the table in
// registers where a stage spans at most 32 blocks, 32 entries a chunk
// (lane l: entry e0 + l) and the next chunk in flight, so a stage finds
// its entries by shuffles: an entry read per stage is a round trip to L2
// that the stage's copies (and, under load, the other CTAs' traffic)
// wait behind.
template <int HD>
struct PagedSrc {
  using X = Boxes<HD>;
  // hd 128 and 192: a slot's 64-column chunks side by side (line NCH row
  // + x of the slot region, 128-byte swizzle), so that one 3-d box brings
  // a piece's rows whole, where a box a chunk took two or three TMA
  // copies (whose issue set the producer's pace at block sizes 4 and 12:
  // chip_variants.py 7's chunk-major variant); 8 consecutive rows meet 8
  // distinct bank groups at hd 192 and 4 at hd 128 (a 2-way conflict for
  // ldmatrix, which the consumers' time did not show).  hd 256 keeps the
  // chunk-major layout of ring decode (4 chunks would be a 4-way
  // conflict), as hd 32 and 64 do (one chunk: the same layout).
  static constexpr bool kRowMajor = X::kCount == 2 || X::kCount == 3;
  const CUtensorMap *kmap, *vmap;
  const int* tbl;
  int a, n, lo, hi, P, R, bs, NB, MB, h;
  int e0 = 0, cur = -1, nxt = -1;  // producer: chunks [e0, e0 + 64)
  // producer, prepare -> fill: the stage's bits, its pieces' pool rows
  // (lane l: piece 32 q + l; -1 not copied) and how many are copied
  unsigned word[kSlotWords] = {};
  int prow[kMaxRounds] = {};
  unsigned read = 0;

  __device__ int count() const { return n; }
  __device__ bool live(int) const { return true; }
  __device__ unsigned group(int, const uint32_t* bits, int o) const {
    return bits[o >> 5] >> (o & 31) & 0xffffu;
  }
  static __device__ __forceinline__ int off(int rows, int row, int col) {
    if constexpr (kRowMajor) {
      const int line = row * X::kCount + col / X::kCols;
      return line * X::kRowBytes +
             ((((col % X::kCols) / 8) ^ (line & 7)) << 4);
    } else {
      return swz<HD>(rows, row, col);
    }
  }
  __device__ int entry(int e) const { return e < MB ? tbl[e] : -1; }
  // the chunks serve a stage whose blocks span 32 entries at most
  __device__ bool chunked() const { return P <= 32 * bs; }
  // The chunks from the walk's first block (32-aligned).
  __device__ void begin(int lane) {
    tma_prefetch(kmap);
    tma_prefetch(vmap);
    if (!chunked()) return;
    e0 = a * P / bs & ~31;
    cur = entry(e0 + lane);
    nxt = entry(e0 + 32 + lane);
  }
  // Move the chunks on until the first block of stage t0's is in cur (a
  // stage's last block is then at most 31 blocks further).
  __device__ void advance(int t0, int lane) {
    while (t0 / bs >= e0 + 32) {
      e0 += 32;
      cur = nxt;
      nxt = entry(e0 + 32 + lane);
    }
  }
  // The entry of lane's block blk of the current stage (every lane calls
  // it); the next chunk only where a lane needs it, as its load may still
  // be in flight.
  __device__ int lookup(int blk, bool want) const {
    if (!chunked()) return want ? entry(blk) : -1;
    const int e = min(max(blk - e0, 0), 63);
    int v = __shfl_sync(0xffffffffu, cur, e & 31);
    const bool far = want && e >= 32;
    if (__any_sync(0xffffffffu, far)) {
      const int vn = __shfl_sync(0xffffffffu, nxt, e & 31);
      if (far) v = vn;
    }
    return v;
  }
  // The pool row of token t under table entry phys.
  __device__ int row(int phys, int t) const {
    return (h * NB + phys) * bs + t % bs;
  }
  // The stage's table entries, bits and pieces, into registers while its
  // ring slot may still be in use.
  __device__ void prepare(int j, int lane) {
    const int t0 = (a + j) * P;
    if (chunked()) advance(t0, lane);
    // each token's entry (lane l: token 32 w + l of the stage) and the
    // attended bits
    int ent[kSlotWords];
#pragma unroll
    for (int w = 0; w < kSlotWords; ++w) {
      ent[w] = -1;
      word[w] = 0;
      if (32 * w >= P) continue;
      const int t = t0 + 32 * w + lane;
      ent[w] = lookup(t / bs, t <= hi);
      if (ent[w] >= NB) __trap();  // a table entry past the pool
      word[w] =
          __ballot_sync(0xffffffffu, ent[w] >= 0 && t >= lo && t <= hi);
    }
    // pieces 32 q + lane: R tokens of one block, copied where its entry is
    // not -1 and they meet [lo, hi]; the rest of the slot keeps whatever
    // it held, selected away by the consumers
    const int lr = __ffs(R) - 1;  // R is a power of two
    read = 0;
#pragma unroll
    for (int q = 0; q < kMaxRounds; ++q) {
      prow[q] = -1;
      if (32 * q >= P >> lr) continue;
      const int i = (32 * q + lane) << lr;  // the piece's first token
      int e = -1;
#pragma unroll
      for (int w = 0; w < kSlotWords; ++w) {
        const int v = __shfl_sync(0xffffffffu, ent[w], i & 31);
        if (i >> 5 == w) e = v;
      }
      if (e >= 0 && i < P && t0 + i <= hi && t0 + i + R > lo)
        prow[q] = row(e, t0 + i);
      read += __popc(__ballot_sync(0xffffffffu, prow[q] >= 0));
    }
  }
  __device__ void fill(int j, unsigned char* st, uint64_t* full,
                       uint32_t* bits, int lane) {
    if (lane == 0) {  // the bits, then the arrival that publishes them
#pragma unroll
      for (int w = 0; w < kSlotWords; ++w)
        if (32 * w < P) bits[w] = word[w];
      mbar_arrive_tx(full, read * 4 * R * HD);  // K and V
    }
    __syncwarp();
    const int lr = __ffs(R) - 1;
#pragma unroll
    for (int q = 0; q < kMaxRounds; ++q) {
      if (prow[q] < 0) continue;
      const int i = (32 * q + lane) << lr;
      if constexpr (kRowMajor) {  // one box: the piece's rows whole
        const int o = i * X::kCount * X::kRowBytes;
        tma_load_3d(st + o, kmap, full, 0, 0, prow[q]);
        tma_load_3d(st + 2 * P * HD + o, vmap, full, 0, 0, prow[q]);
      } else {
#pragma unroll
        for (int x = 0; x < X::kCount; ++x) {
          const int o = x * P * X::kRowBytes + i * X::kRowBytes;
          tma_load_2d(st + o, kmap, full, x * X::kCols, prow[q]);
          tma_load_2d(st + 2 * P * HD + o, vmap, full, x * X::kCols,
                      prow[q]);
        }
      }
    }
  }
};

// Grid (C, B x K), clusters of (C, 1, 1); ROWS 8 for G <= 8, else 16.
template <int HD, int ROWS>
__global__ void __launch_bounds__(kThreads, HD <= 128 ? 2 : 1)
    paged_decode_kernel(const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const bf16* __restrict__ q,
                        const int* __restrict__ tbl,
                        const int* __restrict__ pos, bf16* __restrict__ out,
                        int K, int G, int NB, int bs, int MB, int P, int R,
                        int ns, int window, float scale) {
  extern __shared__ unsigned char dyn[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(dyn) + 1023) & ~uintptr_t(1023));
  uint32_t* bits =
      reinterpret_cast<uint32_t*>(ring + span_bytes<HD, ROWS>(P, ns));
  bf16* qs = reinterpret_cast<bf16*>(bits + kMaxStages * kSlotWords);
  const int C = gridDim.x, c = blockIdx.x;
  const int b = blockIdx.y / K, h = blockIdx.y % K;
  // the row's live tokens [lo, hi] in n stages from lo / P; this CTA's
  // share of them
  const int p = pos[b];
  const int hi = min(p, MB * bs - 1);
  const int lo = window > 0 ? max(0, p - window + 1) : 0;
  const int n = hi >= lo ? hi / P - lo / P + 1 : 0;
  const int a = lo / P + c * n / C, e = lo / P + (c + 1) * n / C;
  const PagedSrc<HD> src{&kmap, &vmap, tbl + b * MB, a, e - a, lo, hi,
                         P, R, bs, NB, MB, h};
  step<HD, ROWS>(src, ring, bits, qs, P, ns, q,
                 static_cast<size_t>(blockIdx.y) * G, G, scale, out,
                 nullptr);
}

}  // namespace ring
}  // namespace rt

namespace {

namespace dec = rt::decode;
namespace ring = rt::ring;
using bf16 = __nv_bfloat16;

template <typename T, int HD, int GP>
__global__ void __launch_bounds__(dec::kThreads) paged_decode_part_kernel(
    const T* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, const int* __restrict__ tbl,
    const int* __restrict__ pos, float* __restrict__ acc,
    float* __restrict__ m, float* __restrict__ l, int K, int G, int NB,
    int bs, int MB, int part, int window, float scale) {
  const int b = blockIdx.x / K, h = blockIdx.x % K, s = blockIdx.y;
  const int g0 = blockIdx.z * dec::kMaxG;  // this CTA's query heads
  const int Gc = min(dec::kMaxG, G - g0);
  const int p = pos[b];
  const int t_end = min(min((s + 1) * part, p + 1), MB * bs);  // exclusive
  int t_begin = s * part;
  if (window > 0) t_begin = max(t_begin, p - window + 1);
  dec::partition_step<T, HD, GP>(
      q, kp, vp, (static_cast<size_t>(b) * K + h) * G + g0, Gc,
      t_end - t_begin, part,
      [=](int i) -> long long {
        const int t = t_begin + i;
        const int phys = tbl[b * MB + t / bs];
        assert(phys < NB);
        return phys < 0
                   ? -1
                   : ((static_cast<long long>(h) * NB + phys) * bs + t % bs) *
                         HD;
      },
      acc, m, l, s, gridDim.y, scale);
}

template <typename T, int HD, int GP>
int launch(const void* q, const void* kp, const void* vp, const void* tbl,
           const void* pos, void* acc, void* m, void* l, void* out, int B,
           int K, int G, int NB, int bs, int MB, int part, int window,
           cudaStream_t st) {
  const int NP = (MB * bs + part - 1) / part;
  const float scale =
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(HD)));
  if (part > dec::max_part<T, HD, GP>())
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = rt::allow_smem(
      paged_decode_part_kernel<T, HD, GP>,
      dec::smem_bytes<T, HD>(dec::max_part<T, HD, GP>(), GP));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int groups = (G + dec::kMaxG - 1) / dec::kMaxG;
  dim3 grid(B * K, NP, groups);
  paged_decode_part_kernel<T, HD, GP>
      <<<grid, dec::kThreads,
         dec::smem_bytes<T, HD>(part, G < dec::kMaxG ? G : dec::kMaxG),
         st>>>(
          static_cast<const T*>(q), static_cast<const T*>(kp),
          static_cast<const T*>(vp), static_cast<const int*>(tbl),
          static_cast<const int*>(pos), static_cast<float*>(acc),
          static_cast<float*>(m), static_cast<float*>(l), K, G, NB, bs, MB,
          part, window, scale);
  if (cudaPeekAtLastError() != cudaSuccess) return 0;  // launch_status
  rt::split_kv_merge_kernel<T, HD><<<B * K * G, HD, 0, st>>>(
      static_cast<const float*>(acc), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<T*>(out), NP);
  return 0;
}

int gcd_int(int a, int b) { return b == 0 ? a : gcd_int(b, a % b); }

template <int HD, int ROWS>
int launch_bf16(const void* q, const void* kp, const void* vp,
                const void* tbl, const void* pos, void* out, int B, int K,
                int G, int NB, int bs, int MB, int window, cudaStream_t st) {
  using X = ring::Boxes<HD>;
  const ring::Plan p = ring::paged_plan(B, K, MB, bs, HD);
  // a stage's tokens come in pieces of R that each lie in one block
  const int R = gcd_int(bs, p.part);
  static const cudaError_t attr = rt::allow_smem(
      ring::paged_decode_kernel<HD, ROWS>,
      ring::paged_smem_bytes<HD, ROWS>(ring::paged_part(HD),
                                       ring::kPagedStages));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // the pools (K, NB, bs, HD) as 2-d maps (HD, K NB bs), a box kCols
  // columns of R rows; at hd 128 and 192 3-d maps (64, HD / 64, K NB bs),
  // a box a piece's R rows whole
  const cuuint32_t rows = R;
  const bool rm = ring::PagedSrc<HD>::kRowMajor;
  const cuuint64_t dims2[2] = {HD, static_cast<cuuint64_t>(K) * NB * bs};
  const cuuint64_t dims3[3] = {X::kCols, X::kCount,
                               static_cast<cuuint64_t>(K) * NB * bs};
  const cuuint64_t strides2[1] = {HD * 2ull};
  const cuuint64_t strides3[2] = {X::kRowBytes, HD * 2ull};
  const cuuint32_t box2[2] = {X::kCols, rows};
  const cuuint32_t box3[3] = {X::kCols, X::kCount, rows};
  CUtensorMap km, vm;
  for (auto [map, pool] : {std::pair{&km, kp}, std::pair{&vm, vp}})
    if (!rt::bf16_tensor_map(map, pool, rm ? 3 : 2, rm ? dims3 : dims2,
                             rm ? strides3 : strides2, rm ? box3 : box2,
                             X::kRowBytes))
      return static_cast<int>(cudaErrorInvalidValue);
  const float scale =
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(HD)));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster, B * K);
  cfg.blockDim = dim3(ring::kThreads);
  cfg.dynamicSmemBytes = ring::paged_smem_bytes<HD, ROWS>(p.part, p.stages);
  cfg.stream = st;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = p.cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, ring::paged_decode_kernel<HD, ROWS>, km, vm,
      static_cast<const bf16*>(q), static_cast<const int*>(tbl),
      static_cast<const int*>(pos), static_cast<bf16*>(out), K, G, NB, bs,
      MB, p.part, R, p.stages, window, scale));
}

}  // namespace

// q (B, K*G, hd); kp/vp (K, NB, bs, hd); tbl (B, MB) int32; pos (B,) int32;
// out (B, K*G, hd).  bf16: one launch, no scratch (acc, m, l and part
// unused).  float32: scratch acc (B, K, G, S, hd), m/l (B, K, G, S) with
// S = ceil(MB*bs / part).  q, kp and vp start on 16-byte boundaries.
// window <= 0 means none.  hd 32, 64, 128, 192 or 256; G up to
// kMaxGroups * kMaxG = 16.
extern "C" int paged_decode(const void* q, const void* kp, const void* vp,
                            const void* tbl, const void* pos, void* acc,
                            void* m, void* l, void* out, int B, int K, int G,
                            int NB, int bs, int MB, int hd, int part,
                            int window, int dtype, void* stream) {
  if (B < 1 || K < 1 || bs < 1 || MB < 1 || G < 1 ||
      G > dec::kMaxGroups * dec::kMaxG)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  int bad;
  if (dtype == rt::DTYPE_BF16) {
    auto f = [&](auto, auto d, auto) {
      constexpr int HD = decltype(d)::value;
      return G <= ring::kMaxG
                 ? launch_bf16<HD, 8>(q, kp, vp, tbl, pos, out, B, K, G, NB,
                                      bs, MB, window, st)
                 : launch_bf16<HD, 16>(q, kp, vp, tbl, pos, out, B, K, G,
                                       NB, bs, MB, window, st);
    };
    bad = dec::dispatch_hd<bf16>(hd, 1, f);  // every G: two instantiations
  } else {
    if (part < 1 || part > dec::kMaxPart)
      return static_cast<int>(cudaErrorInvalidValue);
    auto f = [&](auto t, auto d, auto g) {
      return launch<typename decltype(t)::type, decltype(d)::value,
                    decltype(g)::value>(q, kp, vp, tbl, pos, acc, m, l, out,
                                        B, K, G, NB, bs, MB, part, window,
                                        st);
    };
    bad = dec::dispatch_hd<float>(hd, G < dec::kMaxG ? G : dec::kMaxG, f);
  }
  if (bad) return bad;
  return rt::launch_status();
}

// The bf16 plan of a call: cluster size | slots a stage << 8 | ring
// stages << 16 (the wrapper's tests read the rule).
extern "C" int paged_decode_plan(int B, int K, int G, int MB, int bs,
                                 int hd) {
  if (G < 1 || G > dec::kMaxGroups * dec::kMaxG)
    return -static_cast<int>(cudaErrorInvalidValue);
  const ring::Plan p = ring::paged_plan(B, K, MB, bs, hd);
  return p.cluster | p.part << 8 | p.stages << 16;
}
