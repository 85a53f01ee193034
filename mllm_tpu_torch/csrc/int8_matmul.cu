// int8 weight-only matrix product for Hopper: y = (x @ q) * s, f32 out.
//
// Replaces: mllm_tpu/ops/quant_matmul.py, `int8_matmul` (Pallas kernel `_int8_kernel`).
//
// What it computes: y[m, n] = s[n] * sum_k bf16(x[m, k]) * q[k, n], with q int8
// [K, N] (k-major, as `repack_float_to_int8` and `_q8_device` store it) and s f32
// [N]; the sum is taken in f32. Every int8 value converts to bf16 exactly, so the
// products are those of the Pallas kernel; only the order of the f32 sums differs.
//
// What bounds it on this card: at decode (m <= 32) each weight byte is read
// once for 2m FLOPs, so the product is bound by HBM, at half the bytes of bf16
// (the main row, (8, 1536, 17920): 27.5 MB, 8.4 us at 3.35 TB/s). At prefill
// (m in the hundreds or thousands) it is bound by matrix math: (1536, 1536,
// 17920) is 84.6 GFLOP, 85.5 us at the 989 TFLOP/s of bf16 tensor cores.
//
// What the design does about it: two kernels, chosen by the wrapper from m
// alone (`INT8_STREAM_MAX_M` in ops/quant_matmul.py: the stream takes up to 32
// rows of x, and at 32 it beats the wgmma kernel on the card, PERF.md).
//
//  int8_stream_kernel (m <= 32) is the weight stream of int4_stream.cuh with
//  one int8 per byte: each block keeps 4 ring stages of 32 k-rows x TN bytes
//  (TN = 256 or 512 columns) in flight by 16-byte cp.async; the bytes become
//  bf16 in the mma fragments by prmt / lop3 and one bf16x2 subtraction, no I2F
//  (int4_stream.cuh: int8_to_bf16x2); mma.sync m16n8k16 takes the weights as
//  the 16-row operand, so up to 32 rows of x read each weight once, and every
//  k-step accumulates on the tensor core (the scale is per column: applied
//  once, when the tile is written). Column tiles are split along K over a
//  thread-block cluster (up to 16 CTAs): each rank streams its own k-rows of
//  every tile its cluster owns (x for them staged once), leaves its partial
//  in shared memory, and the ranks add the tile in rank order through
//  distributed shared memory: one launch, no workspace, no atomics, results
//  that repeat exactly. The plan (`int8_plan`) picks the tile width and the
//  cluster size from a cost model and the card's occupancy query for
//  clusters (how they pack into GPCs decides how many are resident).
//
//  int8_gemm_kernel (m > 32) computes y^T = q^T x^T: persistent and
//  warp-specialised, one producer thread keeps 5 stages of a 256-row x tile
//  (128 rows when m <= 128; bf16, 128-byte swizzle) and a 64 x 128 int8
//  weight tile (128-byte swizzle) in flight by TMA; each of two consumer
//  warpgroups builds the weight operand for its 64 output columns in
//  registers (16-bit shared loads, prmt, int8_to_bf16x2) and issues wgmma
//  m64n256k16 (m64n128k16 for 128-row tiles) with A from
//  registers and x as the K-major B from shared memory, f32 accumulators, the
//  column scale in the epilogue. Converting in registers keeps the int8 tile
//  out of any bf16 staging buffer: shared memory's bandwidth, which wgmma's
//  operand reads, the TMA writes and a staged conversion share, bounds this
//  kernel (PERF.md). A CTA walks output tiles (rows fastest); small products
//  split K over a cluster and add the ranks' partials through DSMEM. The TPU
//  kernel's (256, 512, 512) VMEM blocks and sequential k grid axis do not
//  carry over: k is a loop inside the CTA.
#include "hopper.cuh"
#include "int4_stream.cuh"

namespace mllm {
namespace {

using namespace i4s;

// ---------------------------------------------------------------------------
// m <= 32: the int8 weight stream
// ---------------------------------------------------------------------------

constexpr int kStages = 4;  // ring stages of 32 k-rows
constexpr int kMaxCluster = 16;  // the K splits of a tile: H100's largest (non-portable) cluster

struct StreamParams {
  const bf16* x;     // [M, K]
  const uint8_t* q;  // [K, N] int8 bytes
  const float* s;    // [N]
  float* out;        // [M, N]
  int M, K, N;
  int cluster;       // CTAs of a cluster: the K splits of a column tile
  int rows_per;      // k-rows of a split (a multiple of 32)
};

// u32 words of staged x for `rows` k-rows and MT8 tiles of 8 rows of x:
// [rows / 16 k-steps][8 MT8 rows of x][8 words] (int4_stream.cuh's order with
// one half).
__host__ __device__ constexpr int x8_words(int rows, int mt8) { return rows / 16 * 8 * mt8 * 8; }

// The 32 k-rows at q (row 0, column n0 applied; rows N bytes apart, N % 16 ==
// 0): ncols of TN columns and nrows of 32 rows exist, the rest zero-filled.
template <int TN>
__device__ __forceinline__ void issue_rows(uint8_t* stage, const uint8_t* q, long N, int ncols, int nrows) {
  constexpr int RB = row_bytes(TN);
  for (int i = threadIdx.x; i < kStageRows * (TN / 16); i += kThreads) {
    const int r = i / (TN / 16), c = (i % (TN / 16)) * 16;
    const bool ok = c < ncols && r < nrows;
    cp_async_16_pf(stage + r * RB + c, ok ? q + r * N + c : q, ok);
  }
}

// x rows [j0, j0 + rows) as B-fragment pairs: xs[(ks * 8 MT8 + m) * 8 + e],
// word e = 2t holds k-rows (t, 4 + t) of k-step ks, 2t + 1 rows (8 + t,
// 12 + t); rows of x past mrows and k-rows past K are zeros. One 16-byte load
// gives 8 consecutive k-rows of one row of x (K % 8 == 0), prmt pairs them.
template <int MT8>
__device__ __forceinline__ void stage_x8(uint32_t* xs, int rows, int mrows, const bf16* x, int K, int j0) {
  constexpr int M = 8 * MT8;
  const int ksteps = rows / 16;
  const int pad = ksteps * (M - mrows) * 8;
  for (int i = threadIdx.x; i < pad; i += kThreads) {
    const int e = i % 8, m = mrows + (i / 8) % (M - mrows), ks = i / 8 / (M - mrows);
    xs[(ks * M + m) * 8 + e] = 0u;
  }
  const int n = ksteps * 2 * mrows;  // 16-byte loads: (k-step, r0, m)
  for (int i0 = threadIdx.x; i0 < n; i0 += 4 * kThreads) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kThreads < n ? i0 + u * kThreads : i0;
      const int o = i % 2, m = (i / 2) % mrows, ks = i / 2 / mrows;
      const int k = j0 + ks * 16 + 8 * o;
      v[u] = k < K ? *reinterpret_cast<const uint4*>(x + (long)m * K + k) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n) {
        const int o = i % 2, m = (i / 2) % mrows, ks = i / 2 / mrows;
        uint32_t* w = xs + (ks * M + m) * 8 + o;
        w[0] = prmt(v[u].x, v[u].z, 0x5410u);  // rows (r0, r0 + 4)
        w[2] = prmt(v[u].x, v[u].z, 0x7632u);  // (r0 + 1, r0 + 5)
        w[4] = prmt(v[u].y, v[u].w, 0x5410u);  // (r0 + 2, r0 + 6)
        w[6] = prmt(v[u].y, v[u].w, 0x7632u);  // (r0 + 3, r0 + 7)
      }
    }
  }
}

// One stage for this warp: its 32 k-rows (k-steps ks0 and ks0 + 1 of the
// staged x), its strips, accumulated on the tensor core into acc (the
// layout of int4_stream.cuh's Acc). Lane (g, t) reads the 4-byte word of
// columns 4g .. 4g + 3 of rows t, 4 + t, 8 + t, 12 + t of each k-step; prmt
// pairs two rows' bytes of one column, int8_to_bf16x2 converts a pair.
template <int MT8, int TN>
__device__ __forceinline__ void consume_stage8(const uint8_t* stage, const uint32_t* xs, int ks0, Acc<MT8, TN>& acc) {
  constexpr int M = 8 * MT8, RB = row_bytes(TN);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int sp = 0; sp < TN / 256; ++sp) {
    const int col = (warp + 8 * sp) * 32 + 4 * g;
    uint32_t w[2][4];  // [k-step][rows t, 4 + t, 8 + t, 12 + t]
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[ks][i] = *reinterpret_cast<const uint32_t*>(stage + (ks * 16 + 4 * i + t) * RB + col);
    uint32_t a[2][2][4];  // [k-step][T][reg]: tile T's row g is column 4g + 2T, row g + 8 column 4g + 2T + 1
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int P = 0; P < 2; ++P)
#pragma unroll
        for (int T = 0; T < 2; ++T) {
          const uint32_t v = prmt(w[ks][2 * P], w[ks][2 * P + 1], T == 0 ? 0x5410u : 0x7632u);
          a[ks][T][2 * P] = int8_to_bf16x2(v);
          a[ks][T][2 * P + 1] = int8_to_bf16x2(v >> 8);
        }
#pragma unroll
    for (int mt = 0; mt < MT8; ++mt) {
      uint2 b[2];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        b[ks] = *reinterpret_cast<const uint2*>(xs + ((ks0 + ks) * M + mt * 8 + g) * 8 + 2 * t);
#pragma unroll
      for (int T = 0; T < 2; ++T) {
        mma_bf16_16816(acc[sp][T][mt], a[0][T], b[0].x, b[0].y);
        mma_bf16_16816(acc[sp][T][mt], a[1][T], b[1].x, b[1].y);
      }
    }
  }
}

template <int MT8, int TN>
int stream_smem_bytes(const StreamParams& p) {
  return kStages * q_bytes(TN) + 8 * MT8 * TN * 4 + TN * 4 + x8_words(p.rows_per, MT8) * 4;
}

// A cluster of p.cluster CTAs owns a column tile of TN at a time (tiles
// cid, cid + clusters, ...); rank r streams the k-rows [r rows_per, (r + 1)
// rows_per) of each, with its x staged once. At a tile's end each rank
// leaves its f32 partial in shared memory and, after a cluster barrier, adds
// a share of the tile's outputs over the ranks in rank order through
// distributed shared memory, scales and writes it; a second barrier, whose
// wait comes only before the partials are rewritten (or the CTA leaves),
// frees them. The ring runs on across tiles, so the next tile's stages load
// meanwhile.
template <int MT8, int TN>
__global__ void __launch_bounds__(kThreads, MT8 <= 2 ? 2 : 1) int8_stream_kernel(const StreamParams p) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int SB = q_bytes(TN), M8 = 8 * MT8;
  uint8_t* ring = smem;
  float* red = reinterpret_cast<float*>(smem + kStages * SB);  // [M8][TN] this rank's partial
  float* scales = red + M8 * TN;                                 // [TN] the tile's column scales
  uint32_t* xs = reinterpret_cast<uint32_t*>(scales + TN);

  const int C = p.cluster, rank = blockIdx.x % C, cid = blockIdx.x / C, clusters = gridDim.x / C;
  const int tiles = (p.N + TN - 1) / TN;
  const int my_tiles = cid < tiles ? (tiles - cid + clusters - 1) / clusters : 0;
  const int j0 = min(rank * p.rows_per, p.K), j1 = min(j0 + p.rows_per, p.K);
  const int nst = (j1 - j0 + kStageRows - 1) / kStageRows;  // stages of a tile
  const int total = my_tiles * nst;
  const long N = p.N;

  auto issue = [&](int u) {  // stage u = (tile i, stage st) into slot u % kStages
    if (u >= total) return;
    const int i = u / nst, st = u % nst;
    const int n0 = (cid + i * clusters) * TN, r0 = j0 + st * kStageRows;
    issue_rows<TN>(ring + (u % kStages) * SB, p.q + r0 * N + n0, N, min(TN, p.N - n0), min(kStageRows, j1 - r0));
  };
  for (int u = 0; u < kStages - 1; ++u) {
    issue(u);
    cp_async_commit();
  }
  if (nst > 0) stage_x8<MT8>(xs, nst * kStageRows, p.M, p.x, p.K, j0);  // visible after the loop's barrier

  Acc<MT8, TN> acc;
  bool arrived = false;  // this thread arrived at the cluster barrier that frees the partials
  for (int i = 0; i < my_tiles; ++i) {
    const int n0 = (cid + i * clusters) * TN;
    zero_acc<MT8, TN>(acc);
    // The tile's column scales, loaded now and kept in shared memory for its
    // end, so their round trip overlaps the stream.
    float sc[TN / kThreads];
#pragma unroll
    for (int j = 0; j < TN / kThreads; ++j) {
      const int c = threadIdx.x + j * kThreads;
      sc[j] = n0 + c < p.N ? p.s[n0 + c] : 0.f;
    }
    for (int st = 0; st < nst; ++st) {
      const int u = i * nst + st;
      cp_async_wait<kStages - 2>();
      __syncthreads();  // stage u landed for every thread; the slot issued next is free
      issue(u + kStages - 1);
      cp_async_commit();
      consume_stage8<MT8, TN>(ring + (u % kStages) * SB, xs, 2 * st, acc);
    }
    __syncthreads();  // the last tile's readers of `scales` are done
#pragma unroll
    for (int j = 0; j < TN / kThreads; ++j) scales[threadIdx.x + j * kThreads] = sc[j];
    __syncthreads();
    if (C == 1) {
      store_acc<MT8, TN>(acc, [&](int m, int col, float4 v) {
        if (m < p.M && n0 + col < p.N) {
          const float4 sc = *reinterpret_cast<const float4*>(scales + col);
          *reinterpret_cast<float4*>(p.out + m * N + n0 + col) = make_float4(v.x * sc.x, v.y * sc.y, v.z * sc.z, v.w * sc.w);
        }
      });
      continue;
    }
    if (arrived) cluster_wait();  // every rank has read the last tile's partials
    store_acc<MT8, TN>(acc, [&](int m, int col, float4 v) {
      if (m < p.M) *reinterpret_cast<float4*>(red + m * TN + col) = v;
    });
    cluster_sync();
    const int n4 = p.M * TN / 4, per = (n4 + C - 1) / C;
    for (int e = rank * per + threadIdx.x; e < min(n4, (rank + 1) * per); e += kThreads) {
      const int m = 4 * e / TN, col = 4 * e % TN;
      if (n0 + col >= p.N) continue;
      float4 v[kMaxCluster];  // every remote load first (one round trip), then the sums in rank order
#pragma unroll
      for (int rr = 0; rr < kMaxCluster; ++rr)
        if (rr < C) v[rr] = ld_cluster_f32x4(map_rank(red + 4 * e, rr));
      float4 a = v[0];
#pragma unroll
      for (int rr = 1; rr < kMaxCluster; ++rr) {
        if (rr < C) {
          a.x += v[rr].x;
          a.y += v[rr].y;
          a.z += v[rr].z;
          a.w += v[rr].w;
        }
      }
      const float4 sc = *reinterpret_cast<const float4*>(scales + col);
      *reinterpret_cast<float4*>(p.out + m * N + n0 + col) = make_float4(a.x * sc.x, a.y * sc.y, a.z * sc.z, a.w * sc.w);
    }
    cluster_arrive();  // this rank is done reading; the wait comes before the partials are rewritten
    arrived = true;
  }
  if (arrived) cluster_wait();  // no CTA leaves while another still reads its partial
  cp_async_wait<0>();
}

template <int MT8, int TN>
cudaError_t launch_stream(const StreamParams& p, int clusters, cudaStream_t stream) {
  const int smem = stream_smem_bytes<MT8, TN>(p);
  cudaError_t err = cudaFuncSetAttribute(int8_stream_kernel<MT8, TN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (p.cluster > 8 &&
      (err = cudaFuncSetAttribute(int8_stream_kernel<MT8, TN>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
          cudaSuccess)
    return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * p.cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, int8_stream_kernel<MT8, TN>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The most clusters of `cluster` CTAs of the stream kernel <MT8, TN> the card
// keeps resident at once (its SMs, shared memory and GPC layout).
template <int MT8, int TN>
cudaError_t stream_max_clusters(int cluster, int rows_per, int* out) {
  StreamParams p{};
  p.rows_per = rows_per;
  const int smem = stream_smem_bytes<MT8, TN>(p);
  cudaError_t err = cudaFuncSetAttribute(int8_stream_kernel<MT8, TN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (cluster > 8 &&
      (err = cudaFuncSetAttribute(int8_stream_kernel<MT8, TN>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
          cudaSuccess)
    return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, int8_stream_kernel<MT8, TN>, &cfg);
}

template <int TN>
cudaError_t launch_stream_rows(const StreamParams& p, int clusters, int mt8, cudaStream_t stream) {
  switch (mt8) {
    case 1: return launch_stream<1, TN>(p, clusters, stream);
    case 2: return launch_stream<2, TN>(p, clusters, stream);
    case 4: return launch_stream<4, TN>(p, clusters, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// m > 32: TMA + wgmma, warp-specialised, persistent
// ---------------------------------------------------------------------------

namespace gemm {

// kLoadStages: measured against other values with tools/int4_tune.py --kernel int8 (PERF.md)
// The product is computed as y^T = q^T x^T: the weights are wgmma's A
// operand, built in registers from the int8 tile, and x its B operand,
// K-major in shared memory (x's rows as they lie in memory).
constexpr int kBN = 128;  // output columns a tile: 64 per consumer warpgroup (wgmma m64)
constexpr int kBK = 64;   // k a stage: one 128-byte swizzled row of bf16 x
constexpr int kLoadStages = 5;  // x and int8 tiles in flight
constexpr int kConsumers = 2;
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kMaxCluster = 8;          // K splits of a tile (the portable cluster size)
constexpr int kWBytes = kBK * kBN;      // a stage's int8 tile [kBK][kBN], 128-byte swizzled

// BM rows of x a tile (wgmma n256, or n128 for m <= 128): a stage's x tile
// [BM][64] bf16, 128-byte swizzled, then its int8 tile.
template <int BM>
struct Tile {
  static constexpr int kXBytes = BM * kBK * 2;
  static constexpr int kStageBytes = kXBytes + kWBytes;
  static constexpr int kRingBytes = kLoadStages * kStageBytes;
  static constexpr int kSmem = 1024 /* alignment */ + kRingBytes + 16 * kLoadStages;
  static_assert(kConsumers * 128 * (BM / 2) * 4 <= kRingBytes, "a K split's partial tile reuses the ring");
  static_assert(kWBytes % 1024 == 0 && kXBytes % 1024 == 0, "every tile starts on a swizzle atom");
};

struct GemmParams {
  const float* s;  // [N]
  float* out;      // [M, N]
  int M, K, N;
  int mtiles, ntiles;
  int cluster;     // CTAs of a cluster: the K splits of a tile
  int kper;        // k-tiles of a K split (a cluster's rank), all of K when the cluster is one CTA
};

// The A fragments of this warp's 16 output columns for the k-step kk of an
// int8 stage [kBK][kBN] (128-byte swizzled: row k's 16-byte chunk c at
// c ^ (k % 8)). A's rows may stand for any 16 columns as long as the
// epilogue agrees: row g is column col0 + 2g, row g + 8 column col0 + 2g + 1,
// so one 16-bit load gives a lane both of its columns at one k; prmt pairs
// two k of one column and int8_to_bf16x2 converts them (exact, no I2F).
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const uint8_t* w8, int kk, int col0, int g, int t) {
  uint32_t u[4];  // k = 2t, 2t + 1, 2t + 8, 2t + 9 of the k-step: bytes (column 2g, 2g + 1)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = kk * 16 + 2 * t + (i & 1) + 8 * (i >> 1);
    const int col = col0 + 2 * g;
    u[i] = *reinterpret_cast<const uint16_t*>(w8 + k * kBN + ((((col / 16) ^ (k % 8)) * 16) | (col % 16)));
  }
  a[0] = int8_to_bf16x2(prmt(u[0], u[1], 0x0400u));  // row g, k 2t and 2t + 1
  a[1] = int8_to_bf16x2(prmt(u[0], u[1], 0x0501u));  // row g + 8
  a[2] = int8_to_bf16x2(prmt(u[2], u[3], 0x0400u));  // row g, k 2t + 8 and 2t + 9
  a[3] = int8_to_bf16x2(prmt(u[2], u[3], 0x0501u));  // row g + 8
}

// A cluster of C CTAs (grid.x = clusters * C) takes output tiles cid, cid +
// clusters, ... (tile t: rows of x (t % mtiles) * BM, columns (t / mtiles) *
// 128); rank r takes the k-tiles [r kper, (r + 1) kper) of each. With C > 1
// the ranks leave their f32 partials in the idle ring and each adds a share
// of the tile over the ranks in rank order through distributed shared memory.
template <int BM>
__global__ void __launch_bounds__(kThreads, 1)
    int8_gemm_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                     const GemmParams p) {
  constexpr int kXBytes = Tile<BM>::kXBytes, kStageBytes = Tile<BM>::kStageBytes;
  constexpr int kRingBytes = Tile<BM>::kRingBytes, kBM = BM;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* ring = base;  // [kLoadStages][x tile, int8 tile]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kRingBytes);
  uint64_t* empty = full + kLoadStages;
  float4* red = reinterpret_cast<float4*>(ring);  // [32][256 consumer threads] a split's partial (ring idle)

  const int tid = threadIdx.x;
  const int C = p.cluster, rank = blockIdx.x % C;
  const int cid = blockIdx.x / C, clusters = gridDim.x / C;
  const int ktiles = (p.K + kBK - 1) / kBK, tiles = p.mtiles * p.ntiles;
  const int kt0 = min(rank * p.kper, ktiles), kt1 = min(kt0 + p.kper, ktiles);
  if (tid == kConsumers * 128) {
    tma_prefetch(&tm_x);
    tma_prefetch(&tm_w);
  }
  if (tid == 0) {
    for (int i = 0; i < kLoadStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers * 128);
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == kConsumers) {
    // ---- producer: one thread issues every TMA load; the warpgroup meets the cluster ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    int it = 0;
    for (int tile = cid; tile < tiles; tile += clusters) {
      const int m0 = (tile % p.mtiles) * kBM, n0 = (tile / p.mtiles) * kBN;
      if (tid == kConsumers * 128) {
        for (int kt = kt0; kt < kt1; ++kt, ++it) {
          const int stage = it % kLoadStages;
          if (it >= kLoadStages) mbar_wait(&empty[stage], (it / kLoadStages - 1) & 1);
          mbar_arrive_expect_tx(&full[stage], kStageBytes);
          uint8_t* st = ring + stage * kStageBytes;
          tma_load_2d(st, &tm_x, &full[stage], kt * kBK, m0);
          tma_load_2d(st + kXBytes, &tm_w, &full[stage], n0, kt * kBK);
        }
      }
      if (C > 1) {  // the ring holds the partials until the second barrier
        cluster_sync();
        cluster_sync();
      }
    }
  } else {
    // ---- consumers: this warpgroup's 64 output columns of the tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int ctid = tid;  // 0 .. 255
    const int warp = (tid % 128) / 32, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int col0 = wg * 64 + warp * 16;  // this warp's 16 columns of the tile (A's rows)
    float acc[kBM / 2];
    int it = 0;
    for (int tile = cid; tile < tiles; tile += clusters) {
      const int m0 = (tile % p.mtiles) * kBM, n0 = (tile / p.mtiles) * kBN;
      const int col = n0 + col0 + 2 * g;  // this lane's two columns: col (A row g), col + 1 (A row g + 8)
      const float s0 = col < p.N ? p.s[col] : 0.f, s1 = col < p.N ? p.s[col + 1] : 0.f;
#pragma unroll
      for (int i = 0; i < kBM / 2; ++i) acc[i] = 0.f;  // ends the last tile's live range (a rank may have no k-tile)
      for (int kt = kt0; kt < kt1; ++kt, ++it) {
        const int stage = it % kLoadStages;
        const uint8_t* st = ring + stage * kStageBytes;
        mbar_wait(&full[stage], (it / kLoadStages) & 1);
        uint32_t a[kBK / 16][4];
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) a_frag(a[kk], st + kXBytes, kk, col0, g, t);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_rs_kb(acc, a[kk], wgmma_desc(st + kk * 32, 16, 1024), kt > kt0 || kk > 0);
        wgmma_commit();
        // a's registers are read by the products in flight: they finish
        // before the next stage's fragments are built (the other warpgroup's
        // products keep the tensor cores busy meanwhile)
        wgmma_wait<0>();
        wgmma_fence_operands(acc);
        mbar_arrive(&empty[stage]);
      }
      // acc[4 nb + c]: column col + (c >> 1), row of x m0 + 8 nb + 2 t + (c & 1)
      auto store = [&](int nb, float4 v) {
        const int row = m0 + nb * 8 + 2 * t;
        if (col >= p.N) return;
        if (row < p.M) *reinterpret_cast<float2*>(p.out + (long)row * p.N + col) = make_float2(v.x * s0, v.z * s1);
        if (row + 1 < p.M)
          *reinterpret_cast<float2*>(p.out + (long)(row + 1) * p.N + col) = make_float2(v.y * s0, v.w * s1);
      };
      if (C == 1) {
#pragma unroll
        for (int nb = 0; nb < kBM / 8; ++nb)
          store(nb, make_float4(acc[4 * nb], acc[4 * nb + 1], acc[4 * nb + 2], acc[4 * nb + 3]));
        continue;
      }
      // once both warpgroups are done with this tile's stages, the ring is idle
      asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers * 128) : "memory");
#pragma unroll
      for (int nb = 0; nb < kBM / 8; ++nb)
        red[nb * kConsumers * 128 + ctid] = make_float4(acc[4 * nb], acc[4 * nb + 1], acc[4 * nb + 2], acc[4 * nb + 3]);
      fence_proxy_async();  // these generic writes precede the TMA writes that refill the ring next tile
      cluster_sync();
      const int per = (kBM / 8 + C - 1) / C;
      for (int nb = rank * per; nb < min(kBM / 8, (rank + 1) * per); ++nb) {
        float4 a = ld_cluster_f32x4(map_rank(red + nb * kConsumers * 128 + ctid, 0));
        for (int rr = 1; rr < C; ++rr) {  // rank order
          const float4 v = ld_cluster_f32x4(map_rank(red + nb * kConsumers * 128 + ctid, rr));
          a.x += v.x;
          a.y += v.y;
          a.z += v.z;
          a.w += v.w;
        }
        store(nb, a);
      }
      cluster_sync();  // the partials are read before the ring refills
    }
  }
}

template <int BM>
cudaError_t max_clusters(int cluster, int* out) {
  constexpr int kSmem = Tile<BM>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(int8_gemm_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, int8_gemm_kernel<BM>, &cfg);
}

template <int BM>
cudaError_t launch(const void* x, const void* q, const GemmParams& p, int cluster, int clusters,
                   cudaStream_t stream) {
  constexpr int kSmem = Tile<BM>::kSmem, kBM = BM;
  CUtensorMap tx, tw;
  const cuuint64_t xdims[2] = {(cuuint64_t)p.K, (cuuint64_t)p.M};
  const cuuint64_t xstrides[1] = {(cuuint64_t)p.K * 2};
  const cuuint32_t xbox[2] = {kBK, kBM};
  const cuuint64_t wdims[2] = {(cuuint64_t)p.N, (cuuint64_t)p.K};
  const cuuint64_t wstrides[1] = {(cuuint64_t)p.N};
  const cuuint32_t wbox[2] = {kBN, kBK};
  if (!encode_tensor_map(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, xdims, xstrides, xbox,
                         CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_tensor_map(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, q, wdims, wstrides, wbox, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(int8_gemm_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, int8_gemm_kernel<BM>, tx, tw, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace gemm

}  // namespace
}  // namespace mllm

// Returns the CUDA error code of the launch (0 on success). The m <= 32
// stream; its plan (`int8_plan` in ops/quant_matmul.py): mt8 (1, 2 or 4)
// tiles of 8 rows of x, column tiles of tn (256 or 512), `clusters` clusters
// of `cluster` (1..16) CTAs, each CTA rows_per k-rows (a multiple of 32) of
// every tile its cluster owns. x and s are 16-byte aligned; K % 8 == 0, N %
// 16 == 0, M <= 8 mt8. Does not synchronise.
extern "C" int mllm_int8_matmul_bf16(const void* x, const void* q, const void* s, void* out, int M, int K, int N,
                                     int tn, int cluster, int rows_per, int clusters, int mt8, void* stream) {
  using namespace mllm;
  const StreamParams p{static_cast<const bf16*>(x), static_cast<const uint8_t*>(q), static_cast<const float*>(s),
                       static_cast<float*>(out), M, K, N, cluster, rows_per};
  if (K % 8 != 0 || N % 16 != 0 || M < 1 || M > 8 * mt8 || cluster < 1 || cluster > kMaxCluster || rows_per < 32 ||
      rows_per % 32 != 0 || (long)cluster * rows_per < K || clusters < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tn) {
    case 256: return static_cast<int>(launch_stream_rows<256>(p, clusters, mt8, st));
    case 512: return static_cast<int>(launch_stream_rows<512>(p, clusters, mt8, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Returns the CUDA error code of the launch (0 on success). Any M >= 1 (the
// wrapper sends m > 32 here); the plan (`int8_gemm_plan` in
// ops/quant_matmul.py): tiles of bm (128 or 256) rows of x, `clusters`
// clusters of `cluster` (1..8) CTAs, each rank kper k-tiles of 64 of every
// tile its cluster owns. x and q 16-byte
// aligned, K % 8 == 0, N % 16 == 0. Does not synchronise.
extern "C" int mllm_int8_gemm_bf16(const void* x, const void* q, const void* s, void* out, int M, int K, int N,
                                   int bm, int cluster, int kper, int clusters, void* stream) {
  using namespace mllm;
  const int ktiles = (K + gemm::kBK - 1) / gemm::kBK;
  if (K % 8 != 0 || N % 16 != 0 || M < 1 || (bm != 128 && bm != 256) || cluster < 1 ||
      cluster > gemm::kMaxCluster || kper < 1 || (long)cluster * kper < ktiles || clusters < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const gemm::GemmParams p{static_cast<const float*>(s), static_cast<float*>(out), M, K, N,
                           (M + bm - 1) / bm, (N + gemm::kBN - 1) / gemm::kBN, cluster, kper};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bm == 128 ? gemm::launch<128>(x, q, p, cluster, clusters, st)
                                    : gemm::launch<256>(x, q, p, cluster, clusters, st));
}

// The most clusters of `cluster` CTAs the card keeps resident at once, into
// *out: of the wgmma kernel with gemm rows of x a tile (128 or 256; 0: the
// stream), or of the stream kernel with mt8
// tiles of 8 rows, tn columns and rows_per k-rows of x staged. The plans of
// ops/quant_matmul.py size their grids with it. Returns the CUDA error code.
extern "C" int mllm_int8_max_clusters(int gemm, int mt8, int tn, int cluster, int rows_per, void* out) {
  using namespace mllm;
  int* n = static_cast<int*>(out);
  if (gemm) return static_cast<int>(gemm == 128 ? gemm::max_clusters<128>(cluster, n) : gemm::max_clusters<256>(cluster, n));
  if (tn == 256 && mt8 == 1) return static_cast<int>(stream_max_clusters<1, 256>(cluster, rows_per, n));
  if (tn == 256 && mt8 == 2) return static_cast<int>(stream_max_clusters<2, 256>(cluster, rows_per, n));
  if (tn == 256 && mt8 == 4) return static_cast<int>(stream_max_clusters<4, 256>(cluster, rows_per, n));
  if (tn == 512 && mt8 == 1) return static_cast<int>(stream_max_clusters<1, 512>(cluster, rows_per, n));
  if (tn == 512 && mt8 == 2) return static_cast<int>(stream_max_clusters<2, 512>(cluster, rows_per, n));
  if (tn == 512 && mt8 == 4) return static_cast<int>(stream_max_clusters<4, 512>(cluster, rows_per, n));
  return static_cast<int>(cudaErrorInvalidValue);
}
