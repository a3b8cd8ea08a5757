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
// tensor-core rate).  At decode two launches and a few dependent memory
// latencies are larger than either bound.
//
// bfloat16 (the serving dtype): two kernels, no sort, no padding, no
// atomics (the result is bitwise the same run to run).
//  * Adapter-pure row tiles.  Rows are cut into tiles of kTileM = 64
//    consecutive rows, and a tile into *passes*, one per distinct in-range
//    adapter id (at most min(64, N)).  Prefill rows are token-major, so a
//    request's run of rows shares one adapter: a tile is one pass, or two
//    where it straddles two requests; the 8-row decode batch is one tile of
//    up to 4 passes.  A pass stages its adapter's slab once for all of its
//    rows.  The first version ran one CTA per row, which read the row's
//    whole 131 KB slab, 2 bytes per load: ~197 MB of L2 traffic in ~98 M
//    loads at R = 1500.  Rows out of range are in no pass; their y rows
//    are written as zeros.
//  * shrink: one CTA of 4 warps per (row tile, D slice).  For each pass it
//    stages the pass's x rows (the tile's other rows are zero-filled, not
//    read) and the slab's rows of the slice, in chunks of kChunk = 32
//    input features, with 16-byte cp.async into a ring of kStages buffers,
//    and multiplies them on the tensor cores: xa_part = x_tile @ A[ad]
//    with mma.sync.m16n8k16, bf16 operands and float32 sums, as the Pallas
//    kernel's dot_general with preferred_element_type=float32.  It is P V
//    of the prefill tile step: x takes P's place (A fragments by
//    ldmatrix) and the row-major (D, r) slab V's (B fragments by
//    ldmatrix.trans); r = 16 is two n8 tiles (r = 8 zero-fills the second).
//  * Slices and clusters.  ops.py::d_slice fixes the slice: the fewest
//    32-feature chunks a CTA that keep tiles x slices within 4 CTAs an SM
//    (so that enough copies are in flight) and D in at most 128 slices.
//    At D = 4096 the decode batch spreads over 128 CTAs of one chunk each,
//    R = 256 over 4 x 128, R = 1500 over 24 x 22 slices of 192 features.
//    Slices run as clusters of kCluster = 8 CTAs (the grid pads S to a
//    multiple of 8 with CTAs that have no chunk): each CTA leaves its
//    float32 partials in shared memory, and CTA c of the cluster adds rows
//    8c..8c+7 over the 8 slices in order through distributed shared
//    memory.  So a row keeps ceil(S / 8) partials (16 at decode, 3 at
//    R = 1500) where the first version kept S = 32, and the expand reads
//    8x fewer.
//  * expand: one CTA of 4 warps per (erows rows, 256 output columns);
//    ops.py::expand_rows takes 64 rows, or 32 or 16 where 64 leave fewer
//    than two CTAs an SM (R = 256: 16 rows, 256 CTAs; on an H100 at
//    700 W, 64-row CTAs took 1.4x as long there, chip_variants.py 4).
//    It is launched with
//    programmatic stream serialization: its CTAs become resident while
//    the shrink runs (the shrink allows it at its start), load the tile's
//    ids and prefetch B into L2, then wait for the shrink.  The CTA copies
//    its rows' cluster partials (one contiguous block) into shared memory
//    with cp.async, and each (row, k) of xa is their sum in order, a thread
//    each, where the first version had r threads each run a serial loop
//    over 32 partials.  xa stays float32, as the reference keeps it in an
//    f32 scratch.  Warp w takes rows w, w + 4, ...; each lane owns 8
//    adjacent output columns (16-byte loads and stores) and holds
//    B[ad][:, its columns] in float32 registers, loaded once per run of
//    its rows with one adapter, where the first version read B again for
//    every row.  The r FMAs per output run in float32 on the CUDA cores, as
//    the reference casts B to float32 (sgmv.py:45-52); scaling * acc is
//    rounded once to bf16.  No tensor core: they would round xa.
//  * What the bf16 kernels take (the C entry returns cudaErrorInvalidValue
//    otherwise, and ops.py raises ValueError first): D and O multiples of
//    8 and r 8 or 16 (every config of the repository uses r = 16), for
//    16-byte copies of x, A and B, and x, A and B on 16-byte boundaries
//    (y and the scratch are the wrapper's own allocations).
//
// float32 (the SMOKE parity runs) keeps the first version's two CUDA-core
// kernels unchanged: a shrink CTA per (row, slice of `dslice` features;
// the wrapper passes 128) whose threads are (d-lane, rank column) pairs
// reduced in shared memory, and an expand thread per output column that
// first sums the row's partials serially.  Their rows gather their own
// slabs: no tile, no pass, no cluster.
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using rt::cp_async16;
using rt::cp_async_commit;
using rt::cp_async_wait;
using rt::ldsm_x4;
using rt::ldsm_x4_trans;
using rt::mma_bf16;
using rt::pack_bf16;

// ----------------------------------------- bfloat16: row tiles and passes
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileM = 16 * kWarps;  // rows per tile: one m16 block a warp
constexpr int kChunk = 32;           // input features per shrink stage
constexpr int kStages = 4;           // shrink ring depth
constexpr int kRank = 16;            // largest rank: two n8 tiles
constexpr int kLdx = kChunk + 8;     // padded row strides (elements): the
constexpr int kLda = kRank + 8;      // rows of one ldmatrix hit 8 bank groups
constexpr int kCluster = 8;          // slices a cluster sums in its smem
constexpr int kMaxSlices = 128;      // so at most 16 cluster partials a row
constexpr int kOutTile = 8 * 32;     // expand columns per CTA: a warp x 8
static_assert(kTileM == 64, "two warps' ballots cover a tile's ids");
static_assert(kChunk % 16 == 0 && kRank == 16, "k-steps of 16, n8 x 2");
static_assert(kTileM % kCluster == 0 && (kTileM / kCluster) * kRank ==
                                           kThreads,
              "a cluster's CTAs each sum 8 rows x 16 ranks, a thread each");

// Bytes of the expand's dynamic shared memory: the tile's cluster
// partials (rows x sp x r float32).
constexpr size_t expand_smem_bytes(int rows, int sp, int r) {
  return static_cast<size_t>(rows) * sp * r * sizeof(float);
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

// Programmatic dependent launch (sm_90): the shrink lets the expand start
// early; the expand waits for the shrink's results only where it reads
// them.  Without a programmatic launch the wait returns at once.
__device__ __forceinline__ void allow_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_primary() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// part (R, gridDim.y / kCluster, r): slice s of the grid covers input
// features [s * dslice, (s + 1) * dslice); the kCluster slices of a
// cluster add their partials in order of slice inside the cluster.
__global__ void __cluster_dims__(1, kCluster, 1)
    __launch_bounds__(kThreads) sgmv_shrink_tc_kernel(
        const bf16* __restrict__ x, const bf16* __restrict__ a,
        const int* __restrict__ idx, float* __restrict__ part, int R, int D,
        int r, int N, int dslice) {
  __shared__ __align__(16) bf16 ring[kStages][kTileM * kLdx + kChunk * kLda];
  __shared__ __align__(16) float red[kTileM][kRank];  // this slice's xa
  __shared__ int ids[kTileM];
  __shared__ int pass_ad[kTileM];
  __shared__ unsigned first[2];
  allow_dependents();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * kTileM;
  const int s = blockIdx.y;
  const int d_lo = s * dslice, d_hi = min(D, d_lo + dslice);
  // chunks of the slice (none in the slices that pad the grid to clusters)
  const int nc = d_lo < D ? (d_hi - d_lo + kChunk - 1) / kChunk : 0;

  // the tile's passes: its distinct in-range ids, in order of first row
  load_ids(ids, idx, r0, R, N, kTileM);
  for (int i = tid; i < kTileM * kRank; i += kThreads) (&red[0][0])[i] = 0.f;
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
  const int n = (__popc(m0) + __popc(m1)) * nc;  // stages: passes x chunks

  // stage j = (pass j / nc, chunk j % nc) into ring buffer buf
  auto issue = [&](int j, int buf) {
    const int ad = pass_ad[j / nc], d0 = d_lo + (j % nc) * kChunk;
    bf16* Xs = ring[buf];
    bf16* As = Xs + kTileM * kLdx;
    for (int i = tid; i < kTileM * (kChunk / 8); i += kThreads) {
      const int row = i / (kChunk / 8), d = d0 + (i % (kChunk / 8)) * 8;
      const bool ok = ids[row] == ad && d < d_hi;
      cp_async16(Xs + row * kLdx + (d - d0),
                 ok ? x + static_cast<size_t>(r0 + row) * D + d : x, ok);
    }
    for (int i = tid; i < kChunk * (kRank / 8); i += kThreads) {
      const int dd = i / (kRank / 8), c = (i % (kRank / 8)) * 8;
      const bool ok = d0 + dd < d_hi && c < r;
      cp_async16(As + dd * kLda + c,
                 ok ? a + (static_cast<size_t>(ad) * D + d0 + dd) * r + c : a,
                 ok);
    }
  };

  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, its row
  const int g = lane >> 2, t4 = lane & 3;   // mma fragment: row, column pair
  float acc[kRank / 8][4] = {};
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n) issue(j, j);
    cp_async_commit();
  }
  for (int j = 0; j < n; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (j + kStages - 1 < n)
      issue(j + kStages - 1, (j + kStages - 1) % kStages);
    cp_async_commit();
    const int ad = pass_ad[j / nc];
    // a warp none of whose 16 rows is in the pass skips its products
    const bool live =
        __any_sync(0xffffffffu, lane < 16 && ids[16 * warp + lane] == ad);
    if (live) {
      const bf16* Xw = ring[j % kStages] + 16 * warp * kLdx;
      const bf16* As = ring[j % kStages] + kTileM * kLdx;
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        uint32_t af[4], bf[4];
        ldsm_x4(af, Xw + (lane & 15) * kLdx + kk * 16 + (lane >> 4) * 8);
        // matrices: features 16kk + {0..7, 8..15, 0..7, 8..15} x ranks
        // {0..7, 0..7, 8..15, 8..15}, transposed -> n-tiles 0 and 1
        ldsm_x4_trans(bf, As + (16 * kk + (mi & 1) * 8 + mr) * kLda +
                              (mi >> 1) * 8);
        mma_bf16(acc[0], af, bf[0], bf[1]);
        mma_bf16(acc[1], af, bf[2], bf[3]);
      }
    }
    if (j % nc == nc - 1) {  // the pass's last chunk: its rows' partials
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = 16 * warp + g + 8 * i;
        if (live && ids[row] == ad) {
#pragma unroll
          for (int nt = 0; nt < kRank / 8; ++nt)
            *reinterpret_cast<float2*>(&red[row][8 * nt + 2 * t4]) =
                make_float2(acc[nt][2 * i], acc[nt][2 * i + 1]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < kRank / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    }
  }
  cp_async_wait<0>();

  // the cluster's sum: CTA c adds rows 8c..8c+7 over the cluster's slices
  // in order, reading the other CTAs' `red` through distributed shared
  // memory, and writes one float32 partial per row and cluster
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  {
    const int c = static_cast<int>(cluster.block_rank());
    const int row = (kTileM / kCluster) * c + tid / kRank, k = tid % kRank;
    if (k < r && ids[row] >= 0) {
      float v = 0.f;
#pragma unroll
      for (int q = 0; q < kCluster; ++q)
        v += *cluster.map_shared_rank(&red[row][k], q);
      part[(static_cast<size_t>(r0 + row) * (gridDim.y / kCluster) +
            s / kCluster) * r + k] = v;
    }
  }
  cluster.sync();  // no CTA leaves while another reads its `red`
}

template <int RK>
__global__ void __launch_bounds__(kThreads) sgmv_expand_tc_kernel(
    const float* __restrict__ part, const bf16* __restrict__ b,
    const int* __restrict__ idx, bf16* __restrict__ y, int R, int O, int N,
    int sp, int erows, float scaling) {
  extern __shared__ __align__(16) float pt[];  // rows x sp x RK partials
  __shared__ __align__(16) float xs[kTileM][RK];
  __shared__ int ids[kTileM];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * erows, rows = min(erows, R - r0);
  const int o = blockIdx.y * kOutTile + 8 * lane;  // the lane's 8 columns
  const bool col_ok = o < O;
  load_ids(ids, idx, r0, R, N, erows);
  __syncthreads();

  // B[ad][:, o..o+7] of the warp's first row into L2 while the shrink
  // finishes (B is an input, not the shrink's result)
  const int first_ad = warp < rows ? ids[warp] : -1;
  if (first_ad >= 0 && col_ok)
#pragma unroll
    for (int k = 0; k < RK; ++k)
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
          b + (static_cast<size_t>(first_ad) * RK + k) * O + o));

  // the shrink's cluster partials of the tile's rows, one contiguous block
  wait_primary();
  const int nq = rows * sp * RK / 4;
  const float* src = part + static_cast<size_t>(r0) * sp * RK;
  for (int i = tid; i < nq; i += kThreads)
    cp_async16(pt + 4 * i, src + 4 * i, true);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // xa[row][k] = the row's cluster partials in order (rows out of range
  // are skipped: their partials were never written)
  for (int i = tid; i < rows * RK; i += kThreads) {
    const int row = i / RK, k = i % RK;
    if (ids[row] < 0) continue;
    float v = 0.f;
    for (int q = 0; q < sp; ++q) v += pt[(row * sp + q) * RK + k];
    xs[row][k] = v;
  }
  __syncthreads();

  float bv[RK][8];  // B[ad][:, o..o+7] in float32
  int cur = -1;
  for (int row = warp; row < rows; row += kWarps) {
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
        const uint4 w = col_ok ? *reinterpret_cast<const uint4*>(
                                     b + (static_cast<size_t>(ad) * RK + k) *
                                             O + o)
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
        for (int c = 0; c < 8; ++c)
          acc[c] = fmaf(xv[kk], bv[4 * k4 + kk][c], acc[c]);
    }
    if (col_ok)
      *reinterpret_cast<uint4*>(dst) = make_uint4(
          pack_bf16(scaling * acc[0], scaling * acc[1]),
          pack_bf16(scaling * acc[2], scaling * acc[3]),
          pack_bf16(scaling * acc[4], scaling * acc[5]),
          pack_bf16(scaling * acc[6], scaling * acc[7]));
  }
}

template <int RK>
cudaError_t launch_expand(const float* part, const bf16* b, const int* idx,
                          bf16* y, int R, int O, int N, int sp, int erows,
                          float scaling, cudaStream_t st) {
  static const cudaError_t attr = rt::allow_smem(
      sgmv_expand_tc_kernel<RK>,
      expand_smem_bytes(kTileM, kMaxSlices / kCluster, RK));
  if (attr != cudaSuccess) return attr;
  // programmatic stream serialization: the CTAs may become resident
  // while the shrink runs (it allows it at its start)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((R + erows - 1) / erows, (O + kOutTile - 1) / kOutTile);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = expand_smem_bytes(min(erows, R), sp, RK);
  cfg.stream = st;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, sgmv_expand_tc_kernel<RK>, part, b, idx, y,
                            R, O, N, sp, erows, scaling);
}

int launch_tc(const void* x, const void* a, const void* b, const void* idx,
              void* part, void* y, int R, int D, int r, int O, int N,
              int dslice, int erows, float scaling, cudaStream_t st) {
  const int tiles = (R + kTileM - 1) / kTileM;
  const int S = (D + dslice - 1) / dslice;
  if (S > kMaxSlices) return static_cast<int>(cudaErrorInvalidValue);
  const int sp = (S + kCluster - 1) / kCluster;  // cluster partials a row
  sgmv_shrink_tc_kernel<<<dim3(tiles, sp * kCluster), kThreads, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(a),
      static_cast<const int*>(idx), static_cast<float*>(part), R, D, r, N,
      dslice);
  const int shrink = rt::launch_status();
  if (shrink != cudaSuccess) return shrink;
  auto expand = r == 16 ? launch_expand<16> : launch_expand<8>;
  return static_cast<int>(expand(static_cast<const float*>(part),
                                 static_cast<const bf16*>(b),
                                 static_cast<const int*>(idx),
                                 static_cast<bf16*>(y), R, O, N, sp, erows,
                                 scaling, st));
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
// storage type, through float32 scratch `part` of R x P x r floats, where
// S = ceil(D / dslice) slices and P = ceil(S / 8) (bf16: a partial per
// cluster of 8 slices) or P = S (float32).  erows: rows per bf16 expand
// CTA (float32 takes one row a CTA and ignores it).
// bf16: D, O and r multiples of 8, r <= 16, dslice a multiple of 32,
// S <= 128, 1 <= erows <= 64.  float32: 1 <= r <= 256.
extern "C" int sgmv(const void* x, const void* a, const void* b,
                    const void* idx, void* part, void* y, int R, int D, int r,
                    int O, int N, int dslice, int erows, float scaling,
                    int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (R < 1 || dslice < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == rt::DTYPE_BF16) {
    if (r < 8 || r > kRank || r % 8 || D % 8 || O % 8 || dslice % kChunk ||
        erows < 1 || erows > kTileM)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_tc(x, a, b, idx, part, y, R, D, r, O, N, dslice, erows,
                     scaling, st);
  }
  if (r < 1 || r > kShrinkThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  launch_cuda_core<float>(x, a, b, idx, part, y, R, D, r, O, N, dslice,
                          scaling, st);
  return rt::launch_status();
}
