// SGMV: per-row multi-LoRA delta  y = scaling * (x @ A[idx]) @ B[idx].
//
// Replaces: src/repro/kernels/sgmv/sgmv.py:28, `_sgmv_kernel` under `sgmv`
// (its pl.pallas_call at :76), and the sort / segment-pad / block-adapter
// search of src/repro/kernels/sgmv/ops.py::sgmv_apply, which exist only to
// feed the TPU's BlockSpec and are not carried over.
//
// Bound on this card: bytes.  At the main path's shapes (D = O = 4096,
// r = 16, N = 4 adapters) the call must read x, the A and B slabs of the
// adapters its rows use (131 KB each), and write y:
//   R = 3 (warm-function decode, one adapter)      0.31 MB    0.09 us
//   R = 8 (runtime decode, 4 adapters)             1.18 MB    0.35 us
//   R = 256 (runtime prefill, 4 runs of 64)        5.24 MB    1.57 us
//   R = 1500 (warm-function prefill, one adapter) 24.8 MB     7.4 us
// against 2 R r (D + O) flops (0.4 GFLOP at R = 1500, 0.4 us at the bf16
// tensor-core rate).  At decode a launch and its few dependent memory
// latencies are larger than either bound; the previous design paid two
// launches, and a round trip of float32 partials of xa through device
// memory between them.
//
// bfloat16 (the serving dtype): one kernel, no sort, no padding, no
// atomics, no scratch in device memory (the result is bitwise the same
// run to run, and a CUDA graph replays it with nothing to reset).
//  * Adapter-pure row tiles.  Rows are cut into tiles of kTileM = 64
//    consecutive rows, and a tile into *passes*, one per distinct in-range
//    adapter id (at most min(64, N)), found by one ballot over the tile's
//    ids.  Prefill rows are token-major, so a request's run of rows shares
//    one adapter: a tile is one pass, or two where it straddles two
//    requests; the 8-row decode batch is one tile of up to 4 passes.  A
//    pass stages its adapter's slab once for all of its rows.  Rows out of
//    range are in no pass; their y rows are written as exact zeros.
//  * A cluster of C CTAs takes one tile (plan(): 16 for the decode rows'
//    one tile and for up to 4 tiles of a long D, else 8, or 4 where 8 a
//    tile would spill the clusters into a second wave; fewer where D has
//    fewer 128-feature chunks).  CTA c of the cluster shrinks its slice of
//    the chunks: for each pass, xa_c = x[:, slice] @ A[ad][slice] with
//    mma.sync.m16n8k16 (bf16 operands, float32 sums, as the Pallas
//    kernel's dot_general with preferred_element_type=float32) into a
//    float32 (rows x r) tile in its shared memory.  The shrink does about
//    16 flops a byte at r = 16, far under the tensor cores' ridge, so the
//    product stays on mma.sync; what it needs is bytes in flight.
//  * Copies: a producer warp keeps a ring of (x chunk, slab chunk) stages
//    full by TMA under mbarriers, as deep as kRingBytes of shared memory
//    allows (4 stages of 20 KB at 64-row tiles, 12 of 8 KB at the decode
//    batch's 16-row box); the four consumer warps multiply what has
//    landed, warp w on rows 16w..16w+15 (a tile of one 16-row block, the
//    decode rows, gives warp w passes w, w + 4, ... instead), and release
//    the stage.  A chunk is 128 features: two x boxes of 64 features
//    (128-byte rows) under the 128-byte swizzle, so each ldmatrix phase
//    hits every bank once, and one slab box of 16 contiguous 256-byte
//    rows; the boxes' rows past R and features past D arrive as zeros, so
//    a ragged edge needs no predicate.  Each warp keeps the even and odd
//    k-steps in two sums, two chains of products instead of one.
//  * The cluster's sum: each element of xa is the C slices' partials added
//    in order of slice through distributed shared memory (the C reads in
//    flight together), so every CTA holds the tile's whole xa, float32,
//    identical in all of them.  At the decode rows (xa at most one
//    element a thread) every CTA sums it all itself, and a split cluster
//    barrier keeps it resident until the others have read its partials;
//    else CTA c sums a 1/C share and stores it into every CTA.
//  * Expand: CTA c of the cluster's o-th copy owns column tiles (o C + c),
//    (o C + c) + OS C, ... of W columns; each thread owns 8
//    adjacent columns of a tile (16-byte loads and stores) for rows
//    t, t + 128 / (W / 8), ..., and holds B[ad][:, its columns] in
//    float32 registers, loaded once per run of its rows with one adapter
//    (the producer warp has prefetched the CTA's B columns into L2 while
//    the shrink ran).  The r FMAs per output run in float32 on the CUDA
//    cores, as the reference casts B to float32 (sgmv.py:45-52); scaling *
//    acc is rounded once to bf16.  No tensor core: they would round xa.
//  * Few rows (decode: R = 3 or 8, one tile): one cluster would put 16
//    SMs on the slabs, so the grid gives the tile OS copies of its
//    cluster over O (plan(): up to 16, about one CTA an SM in all); each
//    copy repeats the shrink, whose x and A then come from L2.  Column
//    tiles (plan()) give the busiest CTA the least work, a tile costing a
//    reload of B plus its FMAs.
//  * What the bf16 kernel takes (the C entry returns cudaErrorInvalidValue
//    otherwise, and ops.py raises ValueError first): D and O multiples of
//    8 and r 8 or 16 (every config of the repository uses r = 16), for the
//    tensor maps' 16-byte strides and 16-byte loads of B, and x, A and B
//    on 16-byte boundaries.
//
// float32 (the SMOKE parity runs) keeps the first version's two CUDA-core
// kernels unchanged: a shrink CTA per (row, slice of `dslice` features;
// the wrapper passes 128) whose threads are (d-lane, rank column) pairs
// reduced in shared memory into float32 partials in device memory, and an
// expand thread per output column that first sums the row's partials
// serially.  Their rows gather their own slabs: no tile, no pass, no
// cluster.
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using rt::ldsm_x4;
using rt::ldsm_x4_trans;
using rt::mma_bf16;
using rt::pack_bf16;

// ------------------------------- bfloat16: one launch on a cluster step
constexpr int kCWarps = 4;                   // consumer warps
constexpr int kThreads = 32 * (kCWarps + 1);  // + the producer warp
constexpr int kTileM = 16 * kCWarps;  // rows per tile: one m16 block a warp
constexpr int kBoxCols = 64;          // features of one x box (128 B)
constexpr int kChunk = 2 * kBoxCols;  // input features per stage
constexpr int kRank = 16;             // largest rank: two n8 tiles
constexpr int kMaxStages = 32;
constexpr int kRingBytes = 96 * 1024;  // the stages' shared memory
constexpr int kTargetCtas = 128;  // about one CTA an SM at few rows
constexpr int kSms = 132;
constexpr int kMaxCols = 1024;    // columns a CTA's tile: 8 a thread
static_assert(kTileM == 64, "two warps' ballots cover a tile's ids");

// The grid of one call: a cluster of `cluster` CTAs per (row tile, copy
// over O), `osplit` copies, column tiles of `cols` columns.
struct Plan {
  int cluster, osplit, cols;
};

__host__ __device__ inline Plan plan(int R, int D, int O) {
  const int tiles = (R + kTileM - 1) / kTileM;
  const int chunks = (D + kChunk - 1) / kChunk;
  // 16 CTAs split D for one tile, and for up to 4 tiles of a long D;
  // else 8, or 4 where 8 a tile would leave more than 1.5 CTAs an SM
  // (the clusters then spill into a second wave)
  Plan p{tiles <= 4 && (tiles == 1 || chunks >= 64) ? 16
         : 2 * tiles * 8 <= 3 * kSms                  ? 8
                                                      : 4,
         1, 8};
  while (p.cluster > 1 && p.cluster > chunks) p.cluster /= 2;
  while (p.osplit < 16 &&
         tiles * p.cluster * p.osplit * 2 <= kTargetCtas &&
         p.osplit * 2 * p.cluster * 8 <= O)
    p.osplit *= 2;
  // column tiles: the least work for the busiest CTA of a copy's
  // cluster, a tile costing a reload of B (about 4 rows' FMAs a thread)
  // plus its rows x columns / 1024 a thread; ties to the wider tile
  const int ctas = p.osplit * p.cluster, rows = R < kTileM ? R : kTileM;
  long best = 0;
  for (int cols = kMaxCols; cols >= 8; cols /= 2) {
    const long per = ((O + cols - 1) / cols + ctas - 1) / ctas;
    const long cost = per * (4 * 1024 + static_cast<long>(cols) * rows);
    if (best == 0 || cost < best) {
      best = cost;
      p.cols = cols;
    }
  }
  return p;
}

// Rows of the x box: the whole tile, or the rows a one-tile call has
// rounded up to whole m16 blocks.
__host__ __device__ inline int box_rows(int R) {
  return R >= kTileM ? kTileM : (R + 15) / 16 * 16;
}

template <int RK>
__host__ __device__ constexpr int stage_bytes(int bm) {
  return bm * kChunk * 2 + kChunk * RK * 2;  // two x boxes, then the slab
}

// ids[i] = adapter of row r0 + i (i < n), or -1 when the row is past R or
// its id lies outside [0, N).  Threads 0..n-1 write; the caller syncs.
__device__ __forceinline__ void load_ids(int* ids, const int* idx, int r0,
                                         int R, int N, int n) {
  const int t = threadIdx.x;
  if (t < n) {
    const int ad = r0 + t < R ? idx[r0 + t] : -1;
    ids[t] = ad >= 0 && ad < N ? ad : -1;
  }
}

// Two 8x8 b16 matrices, transposed; lanes 0-15 give the row addresses.
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(rt::smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// Grid (tiles x osplit, C), clusters of (1, C, 1): blockIdx.x = tile x
// osplit + copy, blockIdx.y = the CTA's slice of the chunks.  xmap: x as
// (D, R), boxes of (kBoxCols, bm), 128-byte swizzle; amap: A as (8 RK,
// D / 8, N), rows of 8 features, boxes of (8 RK, kChunk / 8, 1): a
// chunk's slab is one contiguous box of 16 rows of 256 bytes at r = 16.
template <int RK>
__global__ void __launch_bounds__(kThreads, 2) sgmv_bf16_kernel(
    const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap amap, const bf16* __restrict__ b,
    const int* __restrict__ idx, bf16* __restrict__ y, int R, int D, int O,
    int N, int osplit, int cols, int bm, int ns, float scaling) {
  extern __shared__ unsigned char dyn[];
  __shared__ __align__(16) float red[kTileM][RK];  // this slice's xa
  __shared__ __align__(16) float xs[kTileM][RK];   // the tile's xa
  constexpr int kMaxCluster = 16;
  __shared__ int ids[kTileM];
  __shared__ int pass_ad[kTileM];
  __shared__ unsigned first[2];
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(dyn) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = gridDim.y, c = blockIdx.y;
  const int copy = blockIdx.x % osplit;
  const int r0 = (blockIdx.x / osplit) * kTileM;
  const int rows = min(kTileM, R - r0);
  const int sb = stage_bytes<RK>(bm);

  // the tile's passes: its distinct in-range ids, in order of first row
  load_ids(ids, idx, r0, R, N, kTileM);
  for (int i = tid; i < kTileM * RK; i += kThreads) (&red[0][0])[i] = 0.f;
  if (tid == 0) {
    for (int s = 0; s < ns; ++s) {
      rt::mbar_init(&full[s], 1);
      rt::mbar_init(&empty[s], kCWarps);
    }
    rt::mbar_init_fence();
  }
  __syncthreads();
  if (tid < kTileM) {
    const int ad = ids[tid];
    bool is_first = ad >= 0;
    for (int u = 0; u < tid && is_first; ++u) is_first = ids[u] != ad;
    const unsigned m = __ballot_sync(0xffffffffu, is_first);
    if (lane == 0) first[warp] = m;
  }
  __syncthreads();
  const unsigned m0 = first[0], m1 = first[1];
  if (tid < kTileM) {
    const unsigned m = warp ? m1 : m0;
    if (m >> lane & 1)
      pass_ad[(warp ? __popc(m0) : 0) + __popc(m & ((1u << lane) - 1))] =
          ids[tid];
  }
  __syncthreads();
  const int passes = __popc(m0) + __popc(m1);
  // this CTA's slice of the chunks (none past the last chunk)
  const int chunks = (D + kChunk - 1) / kChunk, per = (chunks + C - 1) / C;
  const int c_lo = min(chunks, c * per);
  const int nc = min(chunks, c_lo + per) - c_lo;
  const int n = passes * nc;  // stages: passes x chunks

  if (warp == kCWarps) {
    // producer: stage j = (pass j / nc, chunk j % nc) into slot j % ns
    if (lane == 0) {
      rt::tma_prefetch(&xmap);
      rt::tma_prefetch(&amap);
      for (int j = 0; j < n; ++j) {
        const int s = j % ns;
        if (j >= ns) rt::mbar_wait(&empty[s], ((j / ns) - 1) & 1);
        unsigned char* st = ring + s * sb;
        const int d0 = (c_lo + j % nc) * kChunk;
        rt::mbar_arrive_tx(&full[s], sb);
        rt::tma_load_2d(st, &xmap, &full[s], d0, r0);
        rt::tma_load_2d(st + bm * kBoxCols * 2, &xmap, &full[s],
                        d0 + kBoxCols, r0);
        rt::tma_load_3d(st + bm * kChunk * 2, &amap, &full[s], 0, d0 / 8,
                        pass_ad[j / nc]);
      }
    }
    // the CTA's columns of B for every pass into L2 while the shrink runs
    const int lines = (cols + 63) / 64;  // 128-byte lines of a column tile
    for (int p = 0; p < passes; ++p) {
      const bf16* bp = b + static_cast<size_t>(pass_ad[p]) * RK * O;
      for (int t = copy * C + c; t * cols < O; t += osplit * C)
        for (int i = lane; i < RK * lines; i += 32) {
          const int col = t * cols + (i % lines) * 64;
          if (col < O) prefetch_l2(bp + static_cast<size_t>(i / lines) * O +
                                   col);
        }
    }
    __syncwarp();
  } else {
    const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, its row
    const int g = lane >> 2, t4 = lane & 3;   // mma fragment: row, columns
    // a tile of one 16-row block (the decode rows): warp w takes passes w,
    // w + 4, ... on that block; else warp w takes its own block of every
    // pass
    const bool one_block = bm <= 16;
    const int blk = one_block ? 0 : warp;
    const int arow = 16 * blk + (lane & 15);  // this lane's ldmatrix row
    // the even and odd k-steps in two sums (two chains of products)
    float acc[RK / 8][4] = {}, acd[RK / 8][4] = {};
    for (int j = 0; j < n; ++j) {
      const int s = j % ns;
      const int ad = pass_ad[j / nc];
      // a warp none of whose 16 rows is in the pass skips its products
      const bool live =
          (!one_block || (j / nc) % kCWarps == warp) &&
          __any_sync(0xffffffffu, lane < 16 && ids[16 * blk + lane] == ad);
      rt::mbar_wait(&full[s], (j / ns) & 1);
      if (live) {
        const unsigned char* Xs = ring + s * sb;
        const bf16* As = reinterpret_cast<const bf16*>(Xs + bm * kChunk * 2);
#pragma unroll
        for (int kk = 0; kk < kChunk / 16; ++kk) {
          uint32_t af[4];
          // box kk / 4, 16-byte unit of its 128-byte row
          const int unit = 2 * (kk % 4) + (lane >> 4);
          ldsm_x4(af, reinterpret_cast<const bf16*>(
                          Xs + (kk / 4) * bm * 128 + arow * 128 +
                          ((unit ^ (arow & 7)) << 4)));
          float(&d)[RK / 8][4] = kk % 2 ? acd : acc;
          if constexpr (RK == 16) {
            // features 16kk + {0..7, 8..15, 0..7, 8..15} x ranks {0..7,
            // 0..7, 8..15, 8..15}, transposed -> n-tiles 0 and 1
            uint32_t bf[4];
            ldsm_x4_trans(bf, As + (16 * kk + (mi & 1) * 8 + mr) * RK +
                                  (mi >> 1) * 8);
            mma_bf16(d[0], af, bf[0], bf[1]);
            mma_bf16(d[1], af, bf[2], bf[3]);
          } else {
            uint32_t bf[2];
            ldsm_x2_trans(bf, As + (16 * kk + (lane & 15)) * RK);
            mma_bf16(d[0], af, bf[0], bf[1]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) rt::mbar_arrive(&empty[s]);
      if (j % nc == nc - 1) {  // the pass's last chunk: its rows' partials
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = 16 * blk + g + 8 * i;
          if (live && ids[row] == ad) {
#pragma unroll
            for (int nt = 0; nt < RK / 8; ++nt)
              *reinterpret_cast<float2*>(&red[row][8 * nt + 2 * t4]) =
                  make_float2(acc[nt][2 * i] + acd[nt][2 * i],
                              acc[nt][2 * i + 1] + acd[nt][2 * i + 1]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < RK / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] = acd[nt][e] = 0.f;
      }
    }
  }

  // the cluster's sum of each element of the tile's xa over the C slices'
  // partials, in order of slice, through distributed shared memory (the C
  // reads in flight together; rows out of range are skipped).  Where the
  // tile's xa is at most one element a thread (the decode rows), every CTA
  // sums it all into its own `xs`, and a split barrier keeps each CTA
  // resident until the others have read its `red`; else CTA c sums
  // elements c x 160 + t, ... and stores each sum into every CTA's `xs`,
  // all done past a second barrier.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const bool local = rows * RK <= kThreads;
  for (int i = local ? tid : c * kThreads + tid; i < rows * RK;
       i += local ? kThreads : C * kThreads) {
    const int row = i / RK, k = i % RK;
    if (ids[row] < 0) continue;
    float part[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < C) part[q] = *cluster.map_shared_rank(&red[row][k], q);
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < C) v += part[q];
    if (local) {
      xs[row][k] = v;
    } else {
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q)
        if (q < C) *cluster.map_shared_rank(&xs[row][k], q) = v;
    }
  }
  if (local) {
    __syncthreads();
    rt::cluster_arrive();  // done reading the others' `red`
  } else {
    cluster.sync();
  }

  // expand: the CTA's column tiles, 8 columns a thread
  if (warp < kCWarps) {
    const int ncg = cols / 8, step = (32 * kCWarps) / ncg;
    const int cgi = tid % ncg;
    for (int t = copy * C + c; t * cols < O; t += osplit * C) {
      const int o = t * cols + 8 * cgi;
      const bool col_ok = o < O;
      float bv[RK][8];  // B[ad][:, o..o+7] in float32
      int cur = -1;
      for (int row = tid / ncg; row < rows; row += step) {
        const int ad = ids[row];
        bf16* dst = y + static_cast<size_t>(r0 + row) * O + o;
        if (ad < 0) {
          if (col_ok) *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
          continue;
        }
        if (ad != cur) {
          cur = ad;
#pragma unroll
          for (int k = 0; k < RK; ++k) {
            const uint4 w =
                col_ok ? *reinterpret_cast<const uint4*>(
                             b + (static_cast<size_t>(ad) * RK + k) * O + o)
                       : make_uint4(0, 0, 0, 0);
            const uint32_t h[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              bv[k][2 * e] = __uint_as_float(h[e] << 16);
              bv[k][2 * e + 1] = __uint_as_float(h[e] & 0xffff0000u);
            }
          }
        }
        float acc[8] = {};
#pragma unroll
        for (int k4 = 0; k4 < RK / 4; ++k4) {
          const float4 xk = *reinterpret_cast<const float4*>(&xs[row][4 * k4]);
          const float xv[4] = {xk.x, xk.y, xk.z, xk.w};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int e = 0; e < 8; ++e)
              acc[e] = fmaf(xv[kk], bv[4 * k4 + kk][e], acc[e]);
        }
        if (col_ok)
          *reinterpret_cast<uint4*>(dst) = make_uint4(
              pack_bf16(scaling * acc[0], scaling * acc[1]),
              pack_bf16(scaling * acc[2], scaling * acc[3]),
              pack_bf16(scaling * acc[4], scaling * acc[5]),
              pack_bf16(scaling * acc[6], scaling * acc[7]));
      }
    }
  }
  if (local) rt::cluster_wait();  // no CTA leaves while another reads `red`
}

template <int RK>
int launch_bf16(const void* x, const void* a, const void* b, const void* idx,
                void* y, int R, int D, int O, int N, float scaling,
                cudaStream_t st) {
  const Plan p = plan(R, D, O);
  const int bm = box_rows(R), sb = stage_bytes<RK>(bm);
  const int ns = min(kMaxStages, kRingBytes / sb);
  static const cudaError_t attr = [] {
    const cudaError_t e =
        rt::allow_smem(sgmv_bf16_kernel<RK>, kRingBytes + 1024);
    return e != cudaSuccess
               ? e
               : cudaFuncSetAttribute(
                     sgmv_bf16_kernel<RK>,
                     cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap xm, am;
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(D),
                               static_cast<cuuint64_t>(R)};
  const cuuint64_t xstrides[1] = {static_cast<cuuint64_t>(D) * 2};
  const cuuint32_t xbox[2] = {kBoxCols, static_cast<cuuint32_t>(bm)};
  const cuuint64_t adims[3] = {8 * RK, static_cast<cuuint64_t>(D) / 8,
                               static_cast<cuuint64_t>(N)};
  const cuuint64_t astrides[2] = {8 * RK * 2,
                                  static_cast<cuuint64_t>(D) * RK * 2};
  const cuuint32_t abox[3] = {8 * RK, kChunk / 8, 1};
  if (!rt::bf16_tensor_map(&xm, x, 2, xdims, xstrides, xbox, 128) ||
      !rt::bf16_tensor_map(&am, a, 3, adims, astrides, abox, 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((R + kTileM - 1) / kTileM * p.osplit, p.cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = ns * sb + 1024;
  cfg.stream = st;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = 1;
  at[0].val.clusterDim.y = p.cluster;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, sgmv_bf16_kernel<RK>, xm, am, static_cast<const bf16*>(b),
      static_cast<const int*>(idx), static_cast<bf16*>(y), R, D, O, N,
      p.osplit, p.cols, bm, ns, scaling));
}

// ------------------------------------- float32: the CUDA-core kernels
constexpr int kShrinkThreads = 256;
constexpr int kExpandThreads = 256;

template <typename T>
__global__ void sgmv_shrink_kernel(const T* __restrict__ x,
                                   const T* __restrict__ a,
                                   const int* __restrict__ idx,
                                   float* __restrict__ part, int D, int r,
                                   int N, int dchunk) {
  __shared__ float red[kShrinkThreads];
  const int row = blockIdx.x;
  const int s = blockIdx.y, S = gridDim.y;
  const int tid = threadIdx.x;
  const int lanes = blockDim.x / r;  // d-lanes per rank column
  const int k = tid % r;
  const int lane = tid / r;
  const int ad = idx[row];
  const int d0 = s * dchunk, d1 = min(D, d0 + dchunk);
  float acc = 0.f;
  if (ad >= 0 && ad < N && lane < lanes) {
    const T* xr = x + static_cast<size_t>(row) * D;
    const T* ar = a + static_cast<size_t>(ad) * D * r;
#pragma unroll 4
    for (int d = d0 + lane; d < d1; d += lanes)
      acc += rt::to_f32(xr[d]) *
             rt::to_f32(ar[static_cast<size_t>(d) * r + k]);
  }
  red[tid] = acc;
  __syncthreads();
  if (tid < r) {
    float sum = 0.f;
    for (int l = 0; l < lanes; ++l) sum += red[l * r + tid];
    part[(static_cast<size_t>(row) * S + s) * r + tid] = sum;
  }
}

template <typename T>
__global__ void sgmv_expand_kernel(const float* __restrict__ part,
                                   const T* __restrict__ b,
                                   const int* __restrict__ idx,
                                   T* __restrict__ y, int r, int O, int N,
                                   int S, float scaling) {
  extern __shared__ float xs[];  // r floats
  const int row = blockIdx.y;
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  const int ad = idx[row];
  const bool valid = ad >= 0 && ad < N;
  for (int k = threadIdx.x; k < r; k += blockDim.x) {
    float sum = 0.f;
    const float* pr = part + static_cast<size_t>(row) * S * r + k;
    for (int s = 0; s < S; ++s) sum += pr[static_cast<size_t>(s) * r];
    xs[k] = sum;
  }
  __syncthreads();
  if (o >= O) return;
  float acc = 0.f;
  if (valid) {
    const T* br = b + static_cast<size_t>(ad) * r * O + o;
#pragma unroll 8
    for (int k = 0; k < r; ++k)
      acc += xs[k] * rt::to_f32(br[static_cast<size_t>(k) * O]);
  }
  y[static_cast<size_t>(row) * O + o] =
      rt::from_f32<T>(valid ? scaling * acc : 0.f);
}

template <typename T>
void launch_cuda_core(const void* x, const void* a, const void* b,
                      const void* idx, void* part, void* y, int R, int D,
                      int r, int O, int N, int dslice, float scaling,
                      cudaStream_t st) {
  const int S = (D + dslice - 1) / dslice;
  sgmv_shrink_kernel<T><<<dim3(R, S), kShrinkThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const int*>(idx), static_cast<float*>(part), D, r, N,
      dslice);
  sgmv_expand_kernel<T><<<dim3((O + kExpandThreads - 1) / kExpandThreads, R),
                          kExpandThreads, r * sizeof(float), st>>>(
      static_cast<const float*>(part), static_cast<const T*>(b),
      static_cast<const int*>(idx), static_cast<T*>(y), r, O, N, S, scaling);
}

}  // namespace

// x (R, D), a (N, D, r), b (N, r, O), idx (R,) int32 -> y (R, O) in the
// storage type.  bf16: one launch, no scratch (part and dslice unused); D
// and O multiples of 8, r 8 or 16.  float32: through float32 scratch
// `part` of R x ceil(D / dslice) x r floats, 1 <= r <= 256.
extern "C" int sgmv(const void* x, const void* a, const void* b,
                    const void* idx, void* part, void* y, int R, int D, int r,
                    int O, int N, int dslice, float scaling, int dtype,
                    void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (R < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == rt::DTYPE_BF16) {
    if ((r != 8 && r != kRank) || D % 8 || O % 8)
      return static_cast<int>(cudaErrorInvalidValue);
    const int bad = r == kRank
                        ? launch_bf16<16>(x, a, b, idx, y, R, D, O, N,
                                          scaling, st)
                        : launch_bf16<8>(x, a, b, idx, y, R, D, O, N,
                                         scaling, st);
    return bad ? bad : rt::launch_status();
  }
  if (r < 1 || r > kShrinkThreads || dslice < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  launch_cuda_core<float>(x, a, b, idx, part, y, R, D, r, O, N, dslice,
                          scaling, st);
  return rt::launch_status();
}

// The bf16 grid of a call of R rows, D -> O: cluster size | copies over O
// << 8 | columns a CTA's tile << 16 (the wrapper's tests read the rule).
extern "C" int sgmv_plan(int R, int D, int O) {
  const Plan p = plan(R, D, O);
  return p.cluster | p.osplit << 8 | p.cols << 16;
}
