// The body of the single-token (decode) attention kernels for Hopper, bf16
// K/V: shared by the dense cache (decode_attention.cu) and the paged block
// pool (decode_attention_paged.cu), which differ only in where a tile's
// rows lie (the tensor maps of `launch_tma` and the plane of each tile's
// boxes in `decode_body_tma`).
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
//    from B * H_kv and S, to fill the card (two CTAs an SM at head_dim 64,
//    where a CTA's ring is small); a rank with no tile leaves an empty
//    partial (m = kNegBig, l = 0, acc = 0).
//  - Loads: one thread issues each 64-key tile as TMA boxes of 64 columns
//    in the 128-byte swizzle (D / 64 boxes of K and as many of V, read by
//    ldmatrix at the swizzled address), completed on an mbarrier, a few
//    tiles in flight (`stages_of`; tile, stages and cluster size: PERF.md,
//    tools/attention_tune.py). One cp.async.bulk a K or V row, into padded
//    rows, held a CTA at head_dim 64 (128 copies of 128 bytes a tile) to
//    ~1.45 us a tile whatever the cluster size, the boxes to ~0.47 us; at
//    128 and 256 and over the pool the boxes were timed against those copies
//    (PERF.md). A box copies the rows as they lie: keys outside [lo, hi) are
//    masked in the scores and their V rows zeroed in shared memory before
//    P V, so a NaN or inf left in the cache by an earlier request never
//    enters a product; dense rows past the end of the cache load as zeros.
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
// head_dim 256 (Gemma-2B): a stage of K and V is 64 KB, so four do not fit
// the SM's 227 KB: three (dense) and two (paged)
constexpr int kStagesWide = 3;
constexpr int kPagedStagesWide = 2;
constexpr int kRows = 16;           // query heads a CTA (the m16 of mma.sync)
constexpr int kMaxSplits = 8;       // the portable cluster size
constexpr int kPage = 128;          // rows of a pool block of the paged cache
static_assert(kTile % 16 == 0 && kTile == 64, "16 keys a warp; a tile is one box of 64 rows");
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

// Tiles in flight of the kernel of a cache, at head_dim D.
template <bool kPaged, int D>
__host__ __device__ constexpr int stages_of() {
  return D > 128 ? (kPaged ? kPagedStagesWide : kStagesWide) : (kPaged ? kPagedStages : kStages);
}

// A decode CTA's place in the grid: its cluster rank and size, its (b, KV
// head) and its query heads [h0, h0 + rows).
struct DecodeCta {
  int rank, splits, b, hk, h0, rows;
};
__device__ __forceinline__ DecodeCta decode_cta(const DecodeParams& p) {
  DecodeCta c;
  c.rank = blockIdx.x;
  c.splits = gridDim.x;  // grid.x is one cluster
  c.hk = blockIdx.y / p.hgroups;
  c.b = blockIdx.z;
  const int n_rep = p.H / p.Hkv;
  c.h0 = c.hk * n_rep + (blockIdx.y % p.hgroups) * kRows;  // first query head
  c.rows = min(kRows, c.hk * n_rep + n_rep - c.h0);
  return c;
}

// The visible keys [lo, hi) of the CTA's sequence, read on the device, and
// this rank's run of them: `mine` tiles from tile `first` of the grid that
// starts at t0 (decode_split_ranges in ops/decode_attention.py).
struct KeyRun {
  int lo, hi, t0, first, mine;
};
__device__ __forceinline__ KeyRun key_run(const DecodeParams& p, const DecodeCta& c) {
  KeyRun r;
  const int kv_valid = p.kv_valid_vec ? p.kv_valid_vec[c.b] : p.kv_valid;
  r.hi = min(kv_valid, p.S);
  r.lo = max(p.kv_start ? p.kv_start[c.b] : 0, 0);
  if (p.window > 0) r.lo = max(r.lo, kv_valid - p.window);
  r.t0 = (r.lo / kTile) * kTile;
  const int ntiles = r.hi > r.lo ? (r.hi - r.t0 + kTile - 1) / kTile : 0;
  const int per = (ntiles + c.splits - 1) / c.splits;
  r.first = min(c.rank * per, ntiles);
  r.mine = min(r.first + per, ntiles) - r.first;
  return r;
}

// The CTA's query heads as A fragments for all of D, straight from global
// memory (heads g and g + 8 of the CTA; padded heads are zeros).
template <int D>
__device__ __forceinline__ void load_q(uint32_t (&qf)[D / 16][4], const DecodeParams& p, const DecodeCta& c) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint32_t* q0 = reinterpret_cast<const uint32_t*>(p.q + ((long)c.b * p.H + c.h0 + g) * D);
  const uint32_t* q1 = reinterpret_cast<const uint32_t*>(p.q + ((long)c.b * p.H + c.h0 + g + 8) * D);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qf[kk][0] = g < c.rows ? q0[kk * 8 + t] : 0u;
    qf[kk][1] = g + 8 < c.rows ? q1[kk * 8 + t] : 0u;
    qf[kk][2] = g < c.rows ? q0[kk * 8 + 4 + t] : 0u;
    qf[kk][3] = g + 8 < c.rows ? q1[kk * 8 + 4 + t] : 0u;
  }
}

// A thread's share of its warp's partial: heads g (index 0) and g + 8
// (index 1); m in base 2, l a thread-local sum (the quad is summed at the end).
template <int D>
struct WarpAcc {
  float o[D / 8][4];
  float m0, m1, l0, l1;
};
template <int D>
__device__ __forceinline__ void init_acc(WarpAcc<D>& a) {
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) a.o[nd][0] = a.o[nd][1] = a.o[nd][2] = a.o[nd][3] = 0.f;
  a.m0 = a.m1 = kNegBig;
  a.l0 = a.l1 = 0.f;
}

// Where the 16-byte chunk `ch` of row `r` of a warp's K or V rows lies in
// TMA's boxes of 64 columns, 128-byte rows in the 128-byte swizzle: box
// ch / 8, at (ch % 8) ^ (r % 8) (a warp's rows start on a multiple of 8).
struct SwizzledRows {
  __device__ static __forceinline__ const bf16* at(const bf16* base, int r, int ch) {
    return base + (ch >> 3) * kTile * 64 + r * 64 + (((ch & 7) ^ (r & 7)) * 8);
  }
};

// One warp's 16 keys of a tile (kt, vt: its first K and V row; key0 its first
// key): S = Q K^T for the 16 heads, masked outside [lo, hi), the online
// softmax in base 2 (masked probabilities exact zeros), and O += P V with P
// rounded to bf16.
template <int D, class Layout>
__device__ __forceinline__ void warp_tile(WarpAcc<D>& a, const uint32_t (&qf)[D / 16][4], const bf16* kt,
                                          const bf16* vt, int key0, int lo, int hi, float scale_log2) {
  const int lane = threadIdx.x & 31, t = lane & 3, i8 = lane >> 3, r8 = lane & 7;
  float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t kf[4];
    ldmatrix_x4(kf, Layout::at(kt, r8 + (i8 >> 1) * 8, kk * 2 + (i8 & 1)));
    mma_bf16_16816(sc[0], qf[kk], kf[0], kf[1]);
    mma_bf16_16816(sc[1], qf[kk], kf[2], kf[3]);
  }

  float mx0 = kNegBig, mx1 = kNegBig;
#pragma unroll
  for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kpos = key0 + nb * 8 + t * 2 + (c & 1);
      const float x = kpos >= lo && kpos < hi ? sc[nb][c] * scale_log2 : -INFINITY;
      sc[nb][c] = x;
      if (c < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
    }
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(a.m0, mx0), mn1 = fmaxf(a.m1, mx1);  // finite
  const float a0 = exp2f(a.m0 - mn0), a1 = exp2f(a.m1 - mn1);
  a.m0 = mn0;
  a.m1 = mn1;
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
  a.l0 = a.l0 * a0 + rs0;
  a.l1 = a.l1 * a1 + rs1;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    a.o[nd][0] *= a0;
    a.o[nd][1] *= a0;
    a.o[nd][2] *= a1;
    a.o[nd][3] *= a1;
  }

  const uint32_t pa[4] = {pack_bf16x2(sc[0][0], sc[0][1]), pack_bf16x2(sc[0][2], sc[0][3]),
                          pack_bf16x2(sc[1][0], sc[1][1]), pack_bf16x2(sc[1][2], sc[1][3])};
#pragma unroll
  for (int nd2 = 0; nd2 < D / 16; ++nd2) {
    uint32_t vf[4];
    ldmatrix_x4_trans(vf, Layout::at(vt, r8 + (i8 & 1) * 8, nd2 * 2 + (i8 >> 1)));
    mma_bf16_16816(a.o[2 * nd2], pa, vf[0], vf[1]);
    mma_bf16_16816(a.o[2 * nd2 + 1], pa, vf[2], vf[3]);
  }
}

// The end of a decode CTA: merge the four warps' partials, (m, l) and acc
// per warp, in shared memory (`acc_smem`, over the idle ring: every copy has
// landed and been read), in warp order; then the cluster's ranks in rank
// order through distributed shared memory after a cluster barrier, rank r
// writing outputs [r chunk, (r + 1) chunk) of the CTA group's rows * D; a
// second barrier keeps each CTA until the others have read it. `s` holds the
// per-warp and per-CTA statistics (wm, wl, m, l).
template <int D, class Shared>
__device__ __forceinline__ void merge_partials(const DecodeParams& p, Shared& s, float* acc_smem,
                                               const WarpAcc<D>& acc, const DecodeCta& cta) {
  constexpr int kND = D / 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rank = cta.rank, splits = cta.splits, rows = cta.rows, b = cta.b, h0 = cta.h0;
  float l0 = acc.l0, l1 = acc.l1;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  if (t == 0) {
    s.wm[warp][g] = acc.m0;
    s.wl[warp][g] = l0;
    s.wm[warp][g + 8] = acc.m1;
    s.wl[warp][g + 8] = l1;
  }
  float* wacc = acc_smem + warp * kRows * D;
#pragma unroll
  for (int nd = 0; nd < kND; ++nd) {
    const int col = nd * 8 + t * 2;
    if (g < rows) *reinterpret_cast<float2*>(wacc + g * D + col) = make_float2(acc.o[nd][0], acc.o[nd][1]);
    if (g + 8 < rows) *reinterpret_cast<float2*>(wacc + (g + 8) * D + col) = make_float2(acc.o[nd][2], acc.o[nd][3]);
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

// The kernel body (every head_dim, dense cache and paged pool): the tiles as
// TMA boxes (the header's note). One thread loads each tile as D / 64 boxes
// of K and as many of V (64 rows of 64 columns in the 128-byte swizzle, read
// by ldmatrix at the swizzled address, no padding); a paged tile is one box
// a column block of its pool block (a tile never crosses one), whose table
// entry that thread reads as it issues the tile. A box copies the rows as they
// lie, so the V rows of a warp's keys outside [lo, hi) are zeroed in shared
// memory by that warp before its P V (0 * NaN would be NaN); K's are masked
// in the scores. Dense rows past the cache load as zeros (TMA's fill).
template <int D, int S>
struct TmaSmem {
  bf16 k[S][kTile * D];  // [D / 64][key][64]: 128-byte rows in the 128-byte swizzle; 1024-byte aligned
  bf16 v[S][kTile * D];
  uint64_t full[S];
  float wm[kWarps][kRows], wl[kWarps][kRows];
  float m[kRows], l[kRows];
};
template <int D, bool kPaged>
constexpr int tma_smem_bytes() {
  return (int)sizeof(TmaSmem<D, stages_of<kPaged, D>()>) + 1024;  // + the 1024-byte alignment
}

template <int D, bool kPaged>
__device__ __forceinline__ void decode_body_tma(const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                                const DecodeParams& p) {
  static_assert(D % 64 == 0, "whole 64-column boxes");
  constexpr int S = stages_of<kPaged, D>();
  static_assert(sizeof(float) * kWarps * kRows * D <= sizeof(bf16) * 2 * S * kTile * D,
                "the merge reuses the K/V ring");
  constexpr int kBox = kTile * 64;  // elements of one box
  extern __shared__ __align__(1024) unsigned char smem_tma[];
  unsigned char* base = smem_tma + ((1024 - (smem_addr(smem_tma) & 1023)) & 1023);
  auto& s = *reinterpret_cast<TmaSmem<D, S>*>(base);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const DecodeCta c = decode_cta(p);
  if (tid == 0) {
    tma_prefetch(tm_k);
    tma_prefetch(tm_v);
  }

  // The lengths first: thread 0 issues the first tiles as soon as it has them.
  const KeyRun r = key_run(p, c);
  const int* tbl = kPaged ? p.table + (long)c.b * p.MAXB : nullptr;  // paged: the slot's table row
  const int hk = c.hk, nb = p.NB, hkv = p.Hkv, dense_plane = c.b * p.Hkv + c.hk;
  auto issue = [&](int it) {  // tile `it` of this rank into stage it % S, by thread 0
    const int stage = it % S;
    const int kb = r.t0 + (r.first + it) * kTile;
    int row = kb, plane = dense_plane;  // dense: the (b, KV head) plane of the tensor maps
    if constexpr (kPaged) {  // the pool block's (block, KV head) plane, clipped as the Pallas kernel does
      row = kb % kPage;
      plane = min(max(__ldg(tbl + kb / kPage), 0), nb - 1) * hkv + hk;
    }
    mbar_arrive_expect_tx(&s.full[stage], 2 * kTile * D * 2);
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb) {
      tma_load_3d(s.k[stage] + cb * kBox, tm_k, &s.full[stage], cb * 64, row, plane);
      tma_load_3d(s.v[stage] + cb * kBox, tm_v, &s.full[stage], cb * 64, row, plane);
    }
  };
  if (tid == 0) {
    for (int i = 0; i < S; ++i) mbar_init(&s.full[i], 1);
    fence_mbar_init();
    for (int it = 0; it < min(r.mine, S); ++it) issue(it);
  }
  uint32_t qf[D / 16][4];
  load_q<D>(qf, p, c);
  __syncthreads();  // the barriers are initialised before anyone waits on them

  WarpAcc<D> acc;
  init_acc(acc);
  for (int it = 0; it < r.mine; ++it) {
    const int stage = it % S;
    mbar_wait(&s.full[stage], (it / S) & 1);
    const int key0 = r.t0 + (r.first + it) * kTile + warp * 16;
    bf16* vt = s.v[stage] + warp * 16 * 64;  // this warp's 16 keys (a multiple of 8 rows) of box 0
    if (key0 < r.lo || key0 + 16 > r.hi) {  // zero this warp's V rows outside [lo, hi)
      for (int i = lane; i < 16 * (D / 8); i += 32) {
        const int row = i / (D / 8), ch = i % (D / 8), key = key0 + row;
        if (key < r.lo || key >= r.hi)
          *reinterpret_cast<uint4*>(vt + (ch / 8) * kBox + row * 64 + (ch % 8) * 8) = make_uint4(0, 0, 0, 0);
      }
      fence_proxy_async();  // before a later TMA load rewrites the stage
      __syncwarp();
    }
    warp_tile<D, SwizzledRows>(acc, qf, s.k[stage] + warp * 16 * 64, vt, key0, r.lo, r.hi, p.scale_log2);
    __syncthreads();  // every warp is done with this stage
    if (tid == 0 && it + S < r.mine) issue(it + S);
  }

  merge_partials<D>(p, s, reinterpret_cast<float*>(s.k), acc, c);  // the merge area: the idle ring
}

// Launches `kernel(tm_k, tm_v, p)` (a __global__ wrapper of
// decode_body_tma) as clusters of `splits` CTAs along x: grid (splits, Hkv * hgroups, B). K and V are tensor
// maps of (D, rows, planes): the dense cache [B, Hkv, S, D] as (D, S, B * Hkv),
// the pool [NB, Hkv, kPage, D] as (D, kPage, NB * Hkv); boxes of 64 columns
// by a tile of rows in the 128-byte swizzle.
template <int D, bool kPaged, class Kernel>
cudaError_t launch_tma(Kernel kernel, const void* k, const void* v, const DecodeParams& p, int splits,
                       cudaStream_t stream) {
  CUtensorMap tk, tv;
  const cuuint64_t rows = kPaged ? kPage : p.S, planes = (cuuint64_t)(kPaged ? p.NB : p.B) * p.Hkv;
  const cuuint64_t dims[3] = {(cuuint64_t)D, rows, planes};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, rows * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)kTile, 1};
  if (!encode_tensor_map(&tk, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, k, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_tensor_map(&tv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, v, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  const int smem = tma_smem_bytes<D, kPaged>();
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
  err = cudaLaunchKernelEx(&cfg, kernel, tk, tv, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace dec
}  // namespace mllm
