// The body of the single-token (decode) attention kernels for Hopper, bf16
// K/V: shared by the dense cache (decode_attention.cu) and the paged block
// pool (decode_attention_paged.cu), which differ only in where a key's row
// lies (`Rows` below).
//
// What it computes: out[b, 0, h] = softmax(q[b, 0, h] . K[b, h // n_rep]^T * scale) V
// over the keys j with  kv_start[b] <= j < kv_valid[b]  and, with a window,
// j > kv_valid[b] - 1 - window (the window is measured from the last valid
// key, where the query sits). A sequence with no valid key gets zeros.
//
// What bounds it on this card: bytes. The call reads each visible K/V row once
// (kv_valid * D * 4 bytes a KV head) and does 4 * kv_valid * D FLOPs a query
// head: at most n_rep FLOPs a byte, far below the ~295 at which an H100 stops
// being bound by its 3.35 TB/s. At b = 1 the bytes are few (0.8 MB at ctx
// 1500), so what it must beat is latency: how many SMs pull bytes at once.
//
// What the design does about it (flash-decoding inside a thread-block cluster):
//  - One CTA per (b, KV head, key split): the n_rep query heads of the KV head
//    are the 16 rows of mma.sync m16n8k16 products (zero-padded), so each K/V
//    row is read by one CTA, not once per query head.
//  - The keys [lo, hi) are cut into equal runs of whole 64-key tiles, one run
//    per cluster rank (`decode_split_ranges` in ops/decode_attention.py states
//    the rule). Each CTA reads its sequence's lengths on the device: the host
//    never reads one. The host picks only the cluster size (`decode_splits`),
//    from B * H_kv and S, to fill the card; a rank with no tile leaves an
//    empty partial (m = kNegBig, l = 0, acc = 0).
//  - Loads: every K/V row of a tile is one `cp.async.bulk` into a padded
//    shared-memory row (conflict-free ldmatrix), four tiles in flight (three
//    over the paged pool), completed on an mbarrier (tile, stages and
//    cluster size: PERF.md, tools/attention_tune.py). Rows outside [lo, hi)
//    are never copied: they are written as zeros, so a NaN or inf left in
//    the cache by an earlier request never enters a product, and no read
//    passes the end of the cache.
//  - Each warp takes 16 keys of every tile and keeps its own (m, l, acc) in
//    registers: no block barrier inside the softmax. The four warps merge in
//    shared memory, then the cluster's ranks merge through distributed shared
//    memory in rank order after a cluster barrier; each rank writes its share
//    of the bf16 output. One launch a call, no global workspace, no atomics,
//    and an order of summation that does not depend on scheduling.
//  - Online softmax in f32, base 2, scale * log2(e) applied to the f32 score;
//    masked probabilities are exact zeros; probabilities enter P V as bf16 (as
//    the plain version rounds them), row sums l stay f32.
#pragma once

#include "hopper.cuh"

namespace mllm {
namespace dec {

// kTile, kStages and kPagedStages: measured against other values with
// tools/attention_tune.py (PERF.md)
constexpr int kTile = 64;    // keys per tile: 16 per warp
constexpr int kWarps = kTile / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 4;   // tiles in flight, dense cache
constexpr int kPagedStages = 3;  // paged pool: two CTAs an SM (at D = 128) where four stages fit one
// head_dim 256 (Gemma-2B): a stage of K and V with their padding is 67.5 KB,
// so four do not fit the SM's 227 KB: three (dense) and two (paged, whose
// table row also needs room)
constexpr int kStagesWide = 3;
constexpr int kPagedStagesWide = 2;
constexpr int kRows = 16;           // query heads a CTA (the m16 of mma.sync)
constexpr int kPad = 8;             // bf16 elements of row padding: conflict-free ldmatrix
constexpr int kMaxSplits = 8;       // the portable cluster size
constexpr int kPage = 128;          // rows of a pool block of the paged cache
static_assert(kTile % 16 == 0 && kThreads == 2 * kTile, "each thread copies one K or one V row of a tile");
static_assert(kPage % kTile == 0, "a tile never crosses a pool block");

struct DecodeParams {
  const bf16* q;            // [B, 1, H, D]
  const bf16* k;            // dense: [B, Hkv, S, D]; paged: the pool [NB, Hkv, kPage, D]
  const bf16* v;            // the same layout as k
  bf16* o;                  // [B, 1, H, D]
  const int* kv_valid_vec;  // [B], or null: every sequence has kv_valid
  const int* kv_start;      // [B], or null: no left pad (always null when paged)
  const int* table;         // paged: [B, MAXB] pool block of each logical block (-1: none)
  int B, H, Hkv, S;         // S: the keys a sequence can hold (paged: MAXB * kPage)
  int NB, MAXB;             // paged: pool blocks, table columns
  int kv_valid, window;
  int hgroups;              // CTAs a KV head needs for its n_rep query heads
  float scale_log2;         // scale * log2(e)
};

template <int D, int S>
struct Smem {
  static constexpr int kLds = D + kPad;
  bf16 k[S][kTile * kLds];
  bf16 v[S][kTile * kLds];
  uint64_t full[S];
  float wm[kWarps][kRows], wl[kWarps][kRows];  // each warp's (m, l)
  float m[kRows], l[kRows];                      // the CTA's partial, read by the cluster
};
// Tiles in flight of the kernel of a cache, at head_dim D.
template <bool kPaged, int D>
__host__ __device__ constexpr int stages_of() {
  return D > 128 ? (kPaged ? kPagedStagesWide : kStagesWide) : (kPaged ? kPagedStages : kStages);
}
// After the last tile the ring holds each warp's acc [kWarps][kRows][D] (f32),
// then the CTA's partial acc [kRows][D] in the slots of warp 0.
template <int D>
constexpr bool merge_fits() {
  return sizeof(float) * kWarps * kRows * D <= sizeof(bf16) * 2 * stages_of<true, D>() * kTile * (D + kPad);
}
static_assert(merge_fits<64>() && merge_fits<128>() && merge_fits<256>(), "the merge reuses the K/V ring");

// Where key j of sequence b, KV head hk lies: the row-address rule, the one
// thing the two caches do not share.
//  - dense: row j of the (b, hk) plane of [B, Hkv, S, D];
//  - paged: pool block clip(table[b, j / kPage], 0, NB - 1), row j % kPage, as
//    the Pallas kernel clips it: a retired slot (a -1 row with kv_valid > 0)
//    reads block 0 and faults nothing (the caller discards its output). The
//    slot's whole table row is read into shared memory (`tbl`, MAXB entries
//    after Smem) beside the length read, so the first copies wait on no more
//    dependent global reads than the dense kernel's.
template <int D, bool kPaged>
struct Rows {
  const bf16 *k, *v;
  const int* tbl;
  int hk, Hkv;

  __device__ __forceinline__ Rows(const DecodeParams& p, int b, int hk_, int* tbl_smem) : hk(hk_), Hkv(p.Hkv) {
    if constexpr (kPaged) {
      k = p.k;
      v = p.v;
      tbl = tbl_smem;
      for (int i = threadIdx.x; i < p.MAXB; i += kThreads)
        tbl_smem[i] = min(max(p.table[(long)b * p.MAXB + i], 0), p.NB - 1);
    } else {
      const long off = ((long)b * p.Hkv + hk) * p.S * D;
      k = p.k + off;
      v = p.v + off;
      tbl = nullptr;
    }
  }

  __device__ __forceinline__ const bf16* row(bool is_v, int j) const {
    const bf16* base = is_v ? v : k;
    if constexpr (kPaged)
      return base + (((long)tbl[j / kPage] * Hkv + hk) * kPage + j % kPage) * D;
    else
      return base + (long)j * D;
  }
};

// Dynamic shared memory of a CTA: Smem, then (paged) the table row.
template <int D, bool kPaged>
__host__ __device__ constexpr int smem_bytes(int maxb) {
  return (int)sizeof(Smem<D, stages_of<kPaged, D>()>) + (kPaged ? ((4 * maxb + 15) / 16) * 16 : 0);
}

template <int D, bool kPaged>
__device__ __forceinline__ void decode_body(const DecodeParams& p) {
  constexpr int kLds = D + kPad;
  constexpr int kSteps = D / 16;  // k-steps of Q K^T
  constexpr int kND = D / 8;      // 8-wide column blocks of O
  constexpr int S = stages_of<kPaged, D>();
  using Shared = Smem<D, S>;
  extern __shared__ __align__(16) unsigned char smem[];
  auto& s = *reinterpret_cast<Shared*>(smem);
  float* acc_smem = reinterpret_cast<float*>(s.k);  // the merge area, once the ring is idle

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rank = blockIdx.x, splits = gridDim.x;  // grid.x is one cluster
  const int hk = blockIdx.y / p.hgroups, b = blockIdx.z;
  const int n_rep = p.H / p.Hkv;
  const int h0 = hk * n_rep + (blockIdx.y % p.hgroups) * kRows;  // first query head
  const int rows = min(kRows, hk * n_rep + n_rep - h0);

  // The CTA's query heads as A fragments for all of D, straight from global
  // memory (head g and g + 8 of the CTA; padded heads are zeros). Issued
  // first, beside the length reads (and the table row), so the latencies
  // overlap.
  uint32_t qf[kSteps][4];
  {
    const uint32_t* q0 = reinterpret_cast<const uint32_t*>(p.q + ((long)b * p.H + h0 + g) * D);
    const uint32_t* q1 = reinterpret_cast<const uint32_t*>(p.q + ((long)b * p.H + h0 + g + 8) * D);
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      qf[kk][0] = g < rows ? q0[kk * 8 + t] : 0u;
      qf[kk][1] = g + 8 < rows ? q1[kk * 8 + t] : 0u;
      qf[kk][2] = g < rows ? q0[kk * 8 + 4 + t] : 0u;
      qf[kk][3] = g + 8 < rows ? q1[kk * 8 + 4 + t] : 0u;
    }
  }
  const Rows<D, kPaged> src(p, b, hk, reinterpret_cast<int*>(smem + sizeof(Shared)));

  // The visible keys [lo, hi), and this rank's tiles of them
  // (decode_split_ranges in ops/decode_attention.py).
  const int kv_valid = p.kv_valid_vec ? p.kv_valid_vec[b] : p.kv_valid;
  const int hi = min(kv_valid, p.S);
  int lo = max(p.kv_start ? p.kv_start[b] : 0, 0);
  if (p.window > 0) lo = max(lo, kv_valid - p.window);
  const int t0 = (lo / kTile) * kTile;
  const int ntiles = hi > lo ? (hi - t0 + kTile - 1) / kTile : 0;
  const int per = (ntiles + splits - 1) / splits;
  const int first = min(rank * per, ntiles);
  const int mine = min(first + per, ntiles) - first;

  if (tid == 0) {
    for (int i = 0; i < S; ++i) mbar_init(&s.full[i], kThreads);
    fence_mbar_init();
  }
  __syncthreads();  // the barriers (and the table row) are visible

  // Tile `it` of this rank into stage it % S: thread tid copies row
  // tid % kTile of K (tid < kTile) or V, or zeroes it when the key is not
  // visible. Every thread arrives once a tile; the phase completes when the
  // copies have landed.
  auto issue = [&](int it) {
    const int stage = it % S, r = tid % kTile;
    const int j = t0 + (first + it) * kTile + r;
    bf16* dst = (tid < kTile ? s.k[stage] : s.v[stage]) + r * kLds;
    if (j >= lo && j < hi) {
      fence_proxy_async();  // after this thread's earlier generic writes of the row
      mbar_arrive_expect_tx(&s.full[stage], D * 2);
      bulk_g2s(dst, src.row(tid >= kTile, j), D * 2, &s.full[stage]);
    } else {
#pragma unroll
      for (int c = 0; c < D / 8; ++c) *reinterpret_cast<uint4*>(dst + c * 8) = make_uint4(0, 0, 0, 0);
      mbar_arrive(&s.full[stage]);  // releases the zeros to the waiting threads
    }
  };
  for (int it = 0; it < min(mine, S); ++it) issue(it);

  float o[kND][4];
#pragma unroll
  for (int nd = 0; nd < kND; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  // Each thread holds heads g (index 0) and g + 8 (index 1).
  float m0 = kNegBig, m1 = kNegBig, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < mine; ++it) {
    const int stage = it % S;
    mbar_wait(&s.full[stage], (it / S) & 1);
    const bf16* kt = s.k[stage] + warp * 16 * kLds;  // this warp's 16 keys
    const bf16* vt = s.v[stage] + warp * 16 * kLds;
    const int key0 = t0 + (first + it) * kTile + warp * 16;

    // S = Q K^T: 16 heads x this warp's 16 keys.
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t kf[4];
      const int i = lane >> 3;
      ldmatrix_x4(kf, kt + ((lane & 7) + (i >> 1) * 8) * kLds + kk * 16 + (i & 1) * 8);
      mma_bf16_16816(sc[0], qf[kk], kf[0], kf[1]);
      mma_bf16_16816(sc[1], qf[kk], kf[2], kf[3]);
    }

    float mx0 = kNegBig, mx1 = kNegBig;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = key0 + nb * 8 + t * 2 + (c & 1);
        const float x = kpos >= lo && kpos < hi ? sc[nb][c] * p.scale_log2 : -INFINITY;
        sc[nb][c] = x;
        if (c < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      sc[nb][0] = exp2f(sc[nb][0] - mn0);  // masked: exp2(-inf) = 0
      sc[nb][1] = exp2f(sc[nb][1] - mn0);
      sc[nb][2] = exp2f(sc[nb][2] - mn1);
      sc[nb][3] = exp2f(sc[nb][3] - mn1);
      rs0 += sc[nb][0] + sc[nb][1];
      rs1 += sc[nb][2] + sc[nb][3];
    }
    l0 = l0 * a0 + rs0;  // thread-local partial sums; the quad is summed at the end
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int nd = 0; nd < kND; ++nd) {
      o[nd][0] *= a0;
      o[nd][1] *= a0;
      o[nd][2] *= a1;
      o[nd][3] *= a1;
    }

    // O += P V over this warp's 16 keys.
    const uint32_t pa[4] = {pack_bf16x2(sc[0][0], sc[0][1]), pack_bf16x2(sc[0][2], sc[0][3]),
                            pack_bf16x2(sc[1][0], sc[1][1]), pack_bf16x2(sc[1][2], sc[1][3])};
#pragma unroll
    for (int nd2 = 0; nd2 < D / 16; ++nd2) {
      uint32_t vf[4];
      const int i = lane >> 3;
      ldmatrix_x4_trans(vf, vt + ((lane & 7) + (i & 1) * 8) * kLds + nd2 * 16 + (i >> 1) * 8);
      mma_bf16_16816(o[2 * nd2], pa, vf[0], vf[1]);
      mma_bf16_16816(o[2 * nd2 + 1], pa, vf[2], vf[3]);
    }
    __syncthreads();  // every warp is done with this stage
    if (it + S < mine) issue(it + S);
  }

  // Merge the four warps: (m, l) and acc per warp into shared memory (the
  // ring is idle: every copy has landed and been read), then in warp order.
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  if (t == 0) {
    s.wm[warp][g] = m0;
    s.wl[warp][g] = l0;
    s.wm[warp][g + 8] = m1;
    s.wl[warp][g + 8] = l1;
  }
  float* wacc = acc_smem + warp * kRows * D;
#pragma unroll
  for (int nd = 0; nd < kND; ++nd) {
    const int col = nd * 8 + t * 2;
    if (g < rows) *reinterpret_cast<float2*>(wacc + g * D + col) = make_float2(o[nd][0], o[nd][1]);
    if (g + 8 < rows) *reinterpret_cast<float2*>(wacc + (g + 8) * D + col) = make_float2(o[nd][2], o[nd][3]);
  }
  __syncthreads();
  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D;
    float mx = kNegBig;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s.wm[w][r]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = exp2f(s.wm[w][r] - mx);
      l += s.wl[w][r] * e;
      a += acc_smem[w * kRows * D + i] * e;
    }
    acc_smem[i] = a;  // warp 0's slot of (r, col): read above by this thread only
    if (i % D == 0) {
      s.m[r] = mx;
      s.l[r] = l;
    }
  }

  // Merge the ranks in rank order through distributed shared memory; rank r
  // writes outputs [r * chunk, (r + 1) * chunk) of this CTA group's rows * D.
  cluster_sync();
  const int total = rows * D, chunk = (total + splits - 1) / splits;
  for (int i = rank * chunk + tid; i < min(total, (rank + 1) * chunk); i += kThreads) {
    const int r = i / D;
    // every remote load first (one round trip), then the sums in rank order
    float pm[kMaxSplits], pl[kMaxSplits], pa[kMaxSplits];
#pragma unroll
    for (int rr = 0; rr < kMaxSplits; ++rr) {
      if (rr < splits) {
        pm[rr] = ld_cluster_f32(map_rank(&s.m[r], rr));
        pl[rr] = ld_cluster_f32(map_rank(&s.l[r], rr));
        pa[rr] = ld_cluster_f32(map_rank(acc_smem + i, rr));
      }
    }
    float mx = kNegBig;
#pragma unroll
    for (int rr = 0; rr < kMaxSplits; ++rr)
      if (rr < splits) mx = fmaxf(mx, pm[rr]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int rr = 0; rr < kMaxSplits; ++rr) {
      if (rr < splits) {
        const float e = exp2f(pm[rr] - mx);
        l += pl[rr] * e;
        a += pa[rr] * e;
      }
    }
    p.o[((long)b * p.H + h0 + r) * D + i % D] = __float2bfloat16(l > 0.f ? a / l : 0.f);
  }
  cluster_sync();  // no CTA leaves while another still reads its shared memory
}

// Launches `kernel` (a __global__ wrapper of decode_body<D, kPaged>) as
// clusters of `splits` CTAs along x: grid (splits, Hkv * hgroups, B).
template <int D, bool kPaged>
cudaError_t launch_decode(void (*kernel)(DecodeParams), const DecodeParams& p, int splits, cudaStream_t stream) {
  const int smem = smem_bytes<D, kPaged>(p.MAXB);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, p.Hkv * p.hgroups, p.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace dec
}  // namespace mllm
