// The consumer side of the prefill (flash) attention kernels for Hopper: two
// warpgroups of 64 query rows that issue wgmma products in turns on bf16
// tiles in shared memory. Shared by flash_attention.cu (bf16 K/V tiles that
// TMA writes) and flash_attention_quant.cu (int8 / int4 tiles that its
// producer warpgroup turns into bf16), which differ only in how a tile comes
// to lie in the ring (`Tiles` below) and in their producers.
//
// What it computes, for one CTA of 128 query rows of one (b, head):
// out[b, s, h] = softmax2(q[b, s, h] . K[b, h // n_rep]^T * scale_log2) V over
// the keys j that satisfy
//   kv_start[b] <= j < kv_valid[b]                      (left pad, cache fill)
//   and, when causal, j <= q_pos and j > q_pos - window  (q_pos = q_offset + s),
// softmax2 the base-2 softmax. Rows with no valid key are written as zeros;
// masked probabilities are exact zeros.
//
// The layout both producers fill: Q as [kDH][kBQ][64] and each ring stage of
// K and V as [kDH][kBK][64] bf16, boxes of 64 head-dim columns (128 bytes a
// row) in the 128-byte swizzle that wgmma reads (16-byte chunk c of row r at
// chunk c ^ (r % 8)), every box 1024-byte aligned. Stage `it % kStages` holds
// key tile `it`; `Tiles::wait_k(it)` returns when its K may be read (before
// S = Q K^T), `wait_v(it)` when its V may (before O += P V), and
// `release_k(it)` / `release_v(it)` hand each back to the producer once the
// products that read it are done. A producer may fill K and V as one (the bf16
// kernel: wait_v and release_k do nothing) or each on its own.
//
// The consumers' design (measured against other values with
// tools/attention_tune.py, PERF.md):
//  - S = Q K^T is wgmma m64n128k16 with both operands in shared memory
//    (K-major) and f32 accumulators; P is rounded to bf16 in registers (the
//    rounding point of the plain versions) and O += P V takes it as the
//    register A operand, with V read MN-major through the transpose bit.
//  - The two warpgroups issue their products in turns (ping-pong on named
//    barriers), so one's softmax runs while the other's products hold the
//    tensor cores. A warpgroup issues no product for a tile none of its rows
//    sees (a sliding window's far tiles), only its part in the turns.
//  - Online softmax in f32, base 2, scale_log2 folded into the f32 scores.
//  - The grid runs the last (heaviest) q-tiles of every head first:
//    blockIdx.x 0 is the last tile of head 0. GQA by index (h -> h / n_rep).
#pragma once

#include <type_traits>

#include "hopper.cuh"

namespace mllm {
namespace flash {

constexpr int kBQ = 128;     // query rows a CTA
constexpr int kBK = 128;     // keys a tile (head_dim 64 and 128)
constexpr int kStages = 2;   // bf16 K/V tiles in the ring
static_assert(kBK == 64 || kBK == 128, "wgmma n64 or n128 for S");
constexpr int kConsumers = 2;   // warpgroups of 64 query rows
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kSwz = 64;        // bf16 columns of one 128-byte swizzled box row

// head_dim 256 (Gemma-2B): Q is 64 KB and a stage of 128-key K and V tiles
// 128 KB, so two stages of them (320 KB) do not fit the SM's 227 KB; 64-key
// tiles do (64 + 2 x 64 = 192 KB). A consumer thread then holds O at 64 x 256
// f32 (128 registers) beside S (32) and P (16): more than the 168 registers
// ptxas gives a thread of a 384-thread block. With a producer warpgroup and
// setmaxnreg 240 it gave 168 registers and spilled (240 bytes of stack),
// with a producer warp alone (288 threads) the same: it sizes a wgmma
// kernel's block in whole warpgroups, and the spilling kernel ran 1.46x
// slower (the card, tools/attention_tune.py, PERF.md). So the kernel has
// no producer: the two consumer warpgroups (256 threads, 202 registers a
// thread) and their thread 0 issues the loads (InlineTiles,
// flash_attention.cu). What bounds it, and the key split over a cluster
// that answers it, are in flash_attention.cu.
constexpr int kBKWide = 64;
constexpr int kThreadsWide = 256;  // the consumer warpgroups only

template <int D>
__host__ __device__ constexpr int block_k() {
  return D > 128 ? kBKWide : kBK;
}
template <int D>
__host__ __device__ constexpr int threads_of() {
  return D > 128 ? kThreadsWide : kThreads;
}

struct FlashParams {
  bf16* o;                  // [B, Sq, H, D]
  const int* kv_valid_vec;  // [B], or null: every sequence has kv_valid
  const int* kv_start;      // [B], or null: no left pad
  int B, Sq, H, Hkv, Skv;
  int q_offset, kv_valid, causal, window;
  int n_qtiles;
  float scale_log2;  // the factor of the f32 scores: scale * log2(e), or 1 for a pre-scaled q
  const int* q_offset_dev;  // a device int32 read in place of q_offset, or null
  int splits;               // CTAs a q-tile (a cluster) that share its key tiles; 0 or 1: one
};

// The key split of a q-tile (head_dim 256): a cluster of `splits` CTAs owns
// one (b, head, q-tile); of its ntiles key tiles, `used` =
// min(splits, max(1, ntiles / kMinRun)) ranks take runs of whole tiles, rank
// r the tiles [r ntiles / used, (r + 1) ntiles / used), and the others leave
// at once. `flash_split_runs` in ops/flash_attention.py states the rule;
// `flash_splits` there picks `splits` from the shapes alone.
constexpr int kMinRun = 2;     // tiles a rank takes at least before a q-tile is split
constexpr int kMaxSplits = 8;  // the portable cluster size

__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_barrier_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// Named barriers: 1 for making a tile ready (the bf16 kernel's consumers
// zeroing stale V rows, the quantized kernel's converters), 2 + wg for
// warpgroup wg's turn to issue its products, 4 + wg for warpgroup wg's own
// rows of Q. The two consumer warpgroups take turns (ping-pong), so one's
// softmax runs while the other's products hold the tensor cores.
constexpr int kBarTile = 1, kBarTurn = 2, kBarQ = 4;
__device__ __forceinline__ void wait_turn(int wg) { named_barrier_sync(kBarTurn + wg, kConsumers * 128); }
__device__ __forceinline__ void pass_turn(int wg) {
  named_barrier_arrive(kBarTurn + (wg ^ 1), kConsumers * 128);
}

// The CTA's (b, head, q-tile) and the key tiles it loads: [lo, hi) holds
// every key that any of its rows may see, tiles of kBK keys from kb0.
struct CtaTiles {
  int b, h, hk, q0;
  int q_offset, kv_start, kv_valid;
  int lo, hi, kb0, ntiles;
  int rank, used;  // this CTA's rank in its cluster and the ranks that hold tiles (`used` 1: no merge)
};

// The (b, head, q-tile) of unit `cl` of the heaviest-first list (every
// head's last q-tile, then the one before) and its key tiles, unsplit.
template <int BK = kBK>
__device__ __forceinline__ CtaTiles unit_tiles(const FlashParams& p, unsigned cl) {  // unsigned: cheap divisions
  CtaTiles c;
  c.rank = 0;
  const int per_tile = p.H * p.B;
  const int qt = p.n_qtiles - 1 - cl / per_tile;
  c.h = cl % p.H;
  c.b = (cl / p.H) % p.B;
  c.q0 = qt * kBQ;
  c.hk = c.h / (p.H / p.Hkv);
  // a device q_offset (a captured decode loop's write head) is read here, so
  // the grid and every launch argument are the same whatever its value
  c.q_offset = p.q_offset_dev ? *p.q_offset_dev : p.q_offset;
  c.kv_valid = min(p.kv_valid_vec ? p.kv_valid_vec[c.b] : p.kv_valid, p.Skv);
  c.kv_start = max(p.kv_start ? p.kv_start[c.b] : 0, 0);
  c.lo = c.kv_start;
  c.hi = c.kv_valid;
  if (p.causal) {
    c.hi = min(c.hi, c.q_offset + min(c.q0 + kBQ, p.Sq));
    if (p.window > 0) c.lo = max(c.lo, c.q_offset + c.q0 - p.window + 1);
  }
  c.kb0 = (c.lo / BK) * BK;
  c.ntiles = c.hi > c.lo ? (c.hi - c.kb0 + BK - 1) / BK : 0;
  c.used = 1;
  return c;
}

// kSplit: the kernel carries the key split (p.splits CTAs a q-tile); the
// others take one CTA a q-tile and compile none of it.
template <int BK = kBK, bool kSplit = false>
__device__ __forceinline__ CtaTiles cta_tiles(const FlashParams& p) {
  // One cluster a (b, head, q-tile), the heaviest q-tiles first.
  const int splits = kSplit ? max(p.splits, 1) : 1;
  CtaTiles c = unit_tiles<BK>(p, kSplit ? blockIdx.x / splits : blockIdx.x);
  c.rank = kSplit ? blockIdx.x % splits : 0;
  if (kSplit && splits > 1) {  // this rank's run of the q-tile's tiles (see kMinRun)
    const int n = c.ntiles;
    c.used = min(splits, max(1, n / kMinRun));
    const int first = c.rank * n / c.used, last = (c.rank + 1) * n / c.used;
    c.kb0 += first * BK;
    c.ntiles = c.rank < c.used ? last - first : 0;
  }
  return c;
}

// Keys [klo, khi) that this thread's two rows (index 0: row g, 1: row g + 8)
// may see, and their running softmax statistics (m in base-2 space; l a
// thread-local partial sum over the keys this thread holds).
struct RowKeys {
  int klo0, khi0, klo1, khi1;
};
struct RowStats {
  float m0, m1, l0, l1;
};

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// S = Q K^T for tile `it`: this warpgroup's 64 rows x kBK keys, in k-steps
// of 16 columns (both operands K-major, 128-byte swizzled).
// A body whose D is not a multiple of 64 (80) keeps its last D % 64 columns
// in 16-column boxes in the 32-byte swizzle (rows of 32 bytes, 256 bytes an
// 8-row block) after its 64-column boxes: Q is [wide / 64][kBQ][64] then
// [(D - wide) / 16][kBQ][16], a ring stage likewise over BK rows (BK * D
// elements a stage), wide = wide_cols<D>. (Every column of 80 in 16-column
// boxes, P V then one m64n80k16 a k-step, was slower: PERF.md.)
template <int D>
__host__ __device__ constexpr int wide_cols() {
  return D / kSwz * kSwz;
}

// S = Q K^T for tile `it`: this warpgroup's 64 rows x kBK keys, in k-steps
// of 16 columns (both operands K-major).
template <int D, int BK = block_k<D>(), int NS = kStages>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2], const bf16* sQ, const bf16* sK, int it,
                                         int wg) {
  constexpr int kWide = wide_cols<D>();
  const bf16* kt = sK + (it % NS) * BK * D;
#pragma unroll
  for (int kk = 0; kk < kWide / 16; ++kk) {  // the 64-column boxes, 128-byte swizzled
    const int j = kk / 4, w = kk % 4;  // 64-column box, 16-column step inside it
    const uint64_t da = wgmma_desc(sQ + (j * kBQ + wg * 64) * kSwz + w * 16, 16, 1024);
    const uint64_t db = wgmma_desc(kt + j * BK * kSwz + w * 16, 16, 1024);
    wgmma_ss(s, da, db, kk > 0);
  }
#pragma unroll
  for (int i = 0; i < (D - kWide) / 16; ++i) {  // the 16-column boxes, 32-byte swizzled
    const uint64_t da = wgmma_desc_sw32(sQ + kWide * kBQ + (i * kBQ + wg * 64) * 16, 16, 256);
    const uint64_t db = wgmma_desc_sw32(kt + kWide * BK + i * BK * 16, 16, 256);
    wgmma_ss(s, da, db, kWide > 0 || i > 0);
  }
  wgmma_commit();
}

// O += P V for tile `it`: V is [keys][64-column boxes], MN-major for wgmma
// (transpose bit); LBO steps between the boxes, SBO between 8-key groups.
// At D = 80 the product is m64n64k16 over the 64-column box into o[0, 32)
// and m64n16k16 over the 16-column box into o[32, 40): the accumulator
// layout of one m64n80 product.
template <int D, int BK = block_k<D>(), int NS = kStages>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pf)[BK / 16][4],
                                         const bf16* sV, int it) {
  constexpr int kWide = wide_cols<D>();
  const bf16* vt = sV + (it % NS) * BK * D;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    if constexpr (kWide == D) {
      wgmma_rs(o, pf[kk], wgmma_desc(vt + kk * 16 * kSwz, BK * kSwz * 2, 1024));
    } else {
      static_assert(kWide == 64 && D == 80, "one 64-column box and a rest box of 16");
      wgmma_rs(reinterpret_cast<float(&)[32]>(o[0]), pf[kk], wgmma_desc(vt + kk * 16 * kSwz, BK * kSwz * 2, 1024));
      wgmma_rs_n16(reinterpret_cast<float(&)[8]>(o[32]), pf[kk],
                   wgmma_desc_sw32(vt + BK * kSwz + kk * 16 * 16, 32, 256));
    }
  }
  wgmma_commit();
}

// The online softmax of one tile in base 2 (x = s * scale_log2): masks the
// keys a row does not see (only on tiles that cut a row's range; s[i] is key
// kb + 8 (i / 4) + (i & 1), kb including this thread's 2 t), leaves the
// probabilities in s, updates the statistics and returns the factors (a0,
// a1) for O. Masked probabilities are exact zeros: exp2(-inf) = 0.
template <int BK>
__device__ __forceinline__ void online_softmax(float (&s)[BK / 2], int kb, const RowKeys& rk,
                                               float scale_log2, RowStats& st, float& a0, float& a1) {
  if (!(kb >= rk.klo0 && kb >= rk.klo1 && kb + BK - 7 < rk.khi0 && kb + BK - 7 < rk.khi1)) {
    const int lo0 = rk.klo0 - kb, hi0 = rk.khi0 - kb, lo1 = rk.klo1 - kb, hi1 = rk.khi1 - kb;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int c = (i / 4) * 8 + (i & 1);
      const bool ok = (i & 2) ? (c >= lo1 && c < hi1) : (c >= lo0 && c < hi0);
      if (!ok) s[i] = -INFINITY;
    }
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    if (i & 2) mx1 = fmaxf(mx1, s[i]); else mx0 = fmaxf(mx0, s[i]);
  }
  const float mn0 = fmaxf(st.m0, quad_max(mx0) * scale_log2);  // finite
  const float mn1 = fmaxf(st.m1, quad_max(mx1) * scale_log2);
  a0 = fast_exp2(st.m0 - mn0);
  a1 = fast_exp2(st.m1 - mn1);
  st.m0 = mn0;
  st.m1 = mn1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    if (i & 2) {
      s[i] = fast_exp2(fmaf(s[i], scale_log2, -mn1));
      rs1 += s[i];
    } else {
      s[i] = fast_exp2(fmaf(s[i], scale_log2, -mn0));
      rs0 += s[i];
    }
  }
  st.l0 = st.l0 * a0 + rs0;
  st.l1 = st.l1 * a1 + rs1;
}

// P as bf16 A fragments (the rounding point of the plain versions):
// k-step kk covers keys 16 kk .. 16 kk + 15.
template <int BK>
__device__ __forceinline__ void pack_p(const float (&s)[BK / 2], uint32_t (&pf)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pf[kk][0] = pack_bf16x2(s[8 * kk + 0], s[8 * kk + 1]);
    pf[kk][1] = pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
    pf[kk][2] = pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
    pf[kk][3] = pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// Whether a `Tiles` carries the key split (`Tiles::kSplit`): the bf16
// kernel's at head_dim 256 does; the others launch one CTA a q-tile.
template <class T, class = void>
struct split_of : std::false_type {};
template <class T>
struct split_of<T, std::void_t<decltype(T::kSplit)>> : std::integral_constant<bool, T::kSplit> {};

// Whether a `Tiles` runs the overlapped loop (`Tiles::kOverlap`, the narrow
// bf16 bodies at head_dim 64 and 80): tile it + 1's S is issued beside tile
// it's P V in one turn, and its softmax runs while that P V does.
template <class T, class = void>
struct overlap_of : std::false_type {};
template <class T>
struct overlap_of<T, std::void_t<decltype(T::kOverlap)>> : std::integral_constant<bool, T::kOverlap> {};

// Where a split q-tile's partials lie, over Q and the ring once both
// warpgroups are done with them: the unnormalised O of the CTA's 128 rows
// (f32, rows padded so that a warp's float2 stores meet two-way at most),
// each row's m (base 2) and l, and this rank's merge factors.
template <int D>
struct SplitSmem {
  static constexpr int kPS = D + 8;
  float o[kBQ][kPS];
  float m[kBQ], l[kBQ];
  float coef[kMaxSplits][kBQ];  // exp2(m_r - m) / l of each rank r, for this rank's rows
};

// The merge of a split q-tile (c.used > 1 ranks hold tiles): every rank
// leaves its partial in its own shared memory; after a cluster barrier rank
// r takes rows [r per, (r + 1) per) of the q-tile (per = ceil(rows / used)),
// reads every rank's partial of them through distributed shared memory and
// sums them in rank order (a fixed order, no atomics, no workspace); a
// second barrier keeps each CTA until the others have read it. A row that no
// rank saw a key of has l = 0 everywhere and is written as zeros.
template <int D>
__device__ __forceinline__ void merge_ranks(const FlashParams& p, const CtaTiles& c, const float (&o)[D / 2],
                                            float m0, float m1, float l0, float l1, void* area, int wg,
                                            int tid) {
  using Part = SplitSmem<D>;
  constexpr int kN = kConsumers * 128, kC4 = D / 4;
  auto& sp = *reinterpret_cast<Part*>(area);
  const int warp = (tid % 128) / 32, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = wg * 64 + warp * 16 + g;
  named_barrier_sync(kBarTile, kN);  // both warpgroups are done with Q and the ring
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) {
    const int col = nb * 8 + t * 2;
    *reinterpret_cast<float2*>(&sp.o[r0][col]) = make_float2(o[4 * nb], o[4 * nb + 1]);
    *reinterpret_cast<float2*>(&sp.o[r0 + 8][col]) = make_float2(o[4 * nb + 2], o[4 * nb + 3]);
  }
  if (t == 0) {
    sp.m[r0] = m0;
    sp.l[r0] = l0;
    sp.m[r0 + 8] = m1;
    sp.l[r0 + 8] = l1;
  }
  cluster_sync();
  const int rows = min(kBQ, p.Sq - c.q0), per = (rows + c.used - 1) / c.used;
  const int ra = min(rows, c.rank * per), rb = min(rows, ra + per);
  for (int i = tid; i < rb - ra; i += kN) {
    float pm[kMaxSplits], pl[kMaxSplits];
    float mx = kNegBig;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r)
      if (r < c.used) {
        pm[r] = ld_cluster_f32(map_rank(&sp.m[ra + i], r));
        pl[r] = ld_cluster_f32(map_rank(&sp.l[ra + i], r));
      }
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r)
      if (r < c.used) mx = fmaxf(mx, pm[r]);
    float l = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r)
      if (r < c.used) l += pl[r] * exp2f(pm[r] - mx);
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r)
      if (r < c.used) sp.coef[r][i] = exp2f(pm[r] - mx) * inv;
  }
  named_barrier_sync(kBarTile, kN);
  uint32_t part[kMaxSplits];
#pragma unroll
  for (int r = 0; r < kMaxSplits; ++r)
    if (r < c.used) part[r] = map_rank(&sp.o[0][0], r);
  const long q_stride = (long)p.H * D;
  bf16* obase = p.o + ((long)c.b * p.Sq * p.H + c.h) * D;
  for (int i = tid; i < (rb - ra) * kC4; i += kN) {
    const int row = ra + i / kC4, col = (i % kC4) * 4;
    float4 a[kMaxSplits];
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r)  // every remote load first (one round trip)
      if (r < c.used) a[r] = ld_cluster_f32x4(part[r] + (uint32_t)(row * Part::kPS + col) * 4);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r)
      if (r < c.used) {
        const float w = sp.coef[r][row - ra];
        acc.x += w * a[r].x;
        acc.y += w * a[r].y;
        acc.z += w * a[r].z;
        acc.w += w * a[r].w;
      }
    const __nv_bfloat162 lo = __floats2bfloat162_rn(acc.x, acc.y), hi = __floats2bfloat162_rn(acc.z, acc.w);
    uint2 packed;
    packed.x = *reinterpret_cast<const uint32_t*>(&lo);
    packed.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(obase + (c.q0 + row) * q_stride + col) = packed;
  }
  cluster_sync();  // no CTA leaves while another still reads its shared memory
}

// The overlapped loop of one warpgroup (`overlap_of<Tiles>`), tiles
// [0, ntiles) of which it computes [it_a, it_b) (tile it in ring slot
// tiles.base + it: a persistent CTA's earlier units took the slots before):
// one turn a tile plus one, the same count in both warpgroups whatever their
// ranges, and before turn t < ntiles `wait_k(t)`, as the plain loop orders
// them (both warpgroups meet in wait_k's stale-V pass). Turn it_a issues
// S of tile it_a; turn it (it_a < it < it_b) issues S of tile it and then P V
// of tile it - 1, and the softmax of tile it runs while that P V does
// (wgmma_wait<1>); turn it_b issues P V of tile it_b - 1. A turn of a tile
// outside the range issues nothing. Registers: O (D / 2), S (BK / 2) and
// the P in flight (BK / 4) live at once, 128 at D = 64 and 136 at 80.
template <int D, class Tiles, int BK, int NS>
__device__ __forceinline__ void consume_overlapped(const FlashParams& p, const Tiles& tiles, const bf16* sQ,
                                                   const bf16* sK, const bf16* sV, const RowKeys& rows,
                                                   float (&o)[D / 2], RowStats& st, int kb0, int ntiles,
                                                   int it_a, int it_b, int wg, int t) {
  auto skip_tile = [&](int it) {
    tiles.wait_k(it);
    wait_turn(wg);
    pass_turn(wg);
    tiles.release_k(it);
    tiles.refill(it);
    tiles.wait_v(it);
    tiles.release_v(it);
  };
  for (int it = 0; it < it_a; ++it) skip_tile(it);
  if (it_a < it_b) {
    float s[BK / 2];
    uint32_t pf[BK / 16][4];
    float a0, a1;
    tiles.wait_k(it_a);
    wait_turn(wg);
    wgmma_fence();
    issue_qk<D, BK, NS>(s, sQ, sK, tiles.base + it_a, wg);
    pass_turn(wg);
    wgmma_wait<0>();
    wgmma_fence_operands(s);
    tiles.release_k(it_a);
    online_softmax<BK>(s, kb0 + it_a * BK + 2 * t, rows, p.scale_log2, st, a0, a1);
    tiles.refill(it_a);
    pack_p<BK>(s, pf);  // O is still zero: nothing to rescale
    for (int it = it_a + 1; it < it_b; ++it) {
      tiles.wait_k(it);
      tiles.wait_v(it - 1);
      wait_turn(wg);
      wgmma_fence();
      issue_qk<D, BK, NS>(s, sQ, sK, tiles.base + it, wg);
      issue_pv<D, BK, NS>(o, pf, sV, tiles.base + it - 1);
      pass_turn(wg);
      wgmma_wait<1>();  // S of tile it; P V of tile it - 1 may still run
      wgmma_fence_operands(s);
      tiles.release_k(it);
      online_softmax<BK>(s, kb0 + it * BK + 2 * t, rows, p.scale_log2, st, a0, a1);
      tiles.refill(it);
      wgmma_wait<0>();
      wgmma_fence_operands(o);
      wgmma_fence_operands(pf);  // P's registers stay reserved until its product is done
      tiles.release_v(it - 1);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? a1 : a0;
      pack_p<BK>(s, pf);
    }
    if (it_b < ntiles) tiles.wait_k(it_b);
    tiles.wait_v(it_b - 1);
    wait_turn(wg);
    wgmma_fence();
    issue_pv<D, BK, NS>(o, pf, sV, tiles.base + it_b - 1);
    pass_turn(wg);
    wgmma_wait<0>();
    wgmma_fence_operands(o);
    wgmma_fence_operands(pf);
    tiles.release_v(it_b - 1);
    if (it_b < ntiles) {  // the rest of tile it_b's skip
      tiles.release_k(it_b);
      tiles.refill(it_b);
      tiles.wait_v(it_b);
      tiles.release_v(it_b);
    }
    for (int it = it_b + 1; it < ntiles; ++it) skip_tile(it);
    if (it_b == ntiles) return;  // its extra turn was tile it_b - 1's P V
  } else {
    for (int it = it_a; it < ntiles; ++it) skip_tile(it);
  }
  wait_turn(wg);  // the extra turn: nothing to issue
  pass_turn(wg);
}

// One consumer warpgroup (wg 0 or 1, 128 threads; tid the CTA's thread index)
// from Q's arrival to its rows of the output. `tiles` supplies `wait_k`,
// `release_k`, `wait_v`, `release_v` (above), `prepare_q(sQ, wg, wtid)`
// (called by every thread of the warpgroup once Q has landed, before its
// first product) and `refill(it)` (called after the softmax of tile `it`, or
// where it would be: a kernel without a producer loads the ring there).
// NS is the number of ring stages (tile `it` in stage (tiles.base + it) %
// NS: a persistent CTA's earlier units took the slots before); q_parity the
// phase of qbar that holds this Q.
template <int D, class Tiles, int BK = block_k<D>(), int NS = kStages>
__device__ __forceinline__ void consume(const FlashParams& p, const CtaTiles& c, bf16* sQ, const bf16* sK,
                                        const bf16* sV, uint64_t* qbar, const Tiles& tiles, int wg,
                                        int tid, uint32_t q_parity = 0) {
  const int wtid = tid % 128;
  const int warp = wtid / 32, lane = tid & 31, g = lane >> 2, t = lane & 3;
  // This thread's rows of the CTA: r0 and r0 + 8, and the keys each sees:
  // [klo, khi) = [kv_start, kv_valid), and when causal j <= q_pos and
  // j > q_pos - window.
  const int r0 = wg * 64 + warp * 16 + g;
  const int qpos0 = c.q_offset + c.q0 + r0, qpos1 = qpos0 + 8;
  const bool windowed = p.causal && p.window > 0;
  const int klo0 = windowed ? max(c.kv_start, qpos0 - p.window + 1) : c.kv_start;
  const int klo1 = windowed ? max(c.kv_start, qpos1 - p.window + 1) : c.kv_start;
  const int khi0 = p.causal ? min(c.kv_valid, qpos0 + 1) : c.kv_valid;
  const int khi1 = p.causal ? min(c.kv_valid, qpos1 + 1) : c.kv_valid;
  const RowKeys rows{klo0, khi0, klo1, khi1};
  // The tiles [it_a, it_b) that hold a key some row of this warpgroup (below
  // Sq) sees; the others (a sliding window's far tiles) cost it no product,
  // only its part in the turns and barriers.
  const int kb0 = c.kb0, ntiles = c.ntiles;
  const int qa = c.q_offset + c.q0 + wg * 64, qb = c.q_offset + min(c.q0 + wg * 64 + 64, p.Sq) - 1;
  const int wlo = windowed ? max(c.kv_start, qa - p.window + 1) : c.kv_start;
  const int whi = p.causal ? min(c.kv_valid, qb + 1) : c.kv_valid;
  const int it_a = min(ntiles, max(0, (wlo - kb0) / BK));
  const int it_b = max(it_a, min(ntiles, (whi - kb0 + BK - 1) / BK));

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  RowStats st{kNegBig, kNegBig, 0.f, 0.f};

  // Per tile: S, softmax, P V. The two warpgroups issue their products in
  // turns, so one's softmax runs while the other's products hold the tensor
  // cores. At D = 128 a tile's S is not issued beside the last tile's P V:
  // S, P and O live at once need ~180 registers, over the 168 that 384
  // threads leave (ptxas spilled it and the main row ran 30 % slower;
  // PERF.md). At D <= 80 O is 32 or 40 registers and they fit (128 / 136):
  // the narrow bodies' Tiles take the overlapped loop (`consume_overlapped`),
  // which at 64 took a tile from ~1.36 to ~1.1 µs.
  if (ntiles > 0) {
    mbar_wait(qbar, q_parity);
    tiles.prepare_q(sQ, wg, wtid);
    if (wg == 1) pass_turn(wg);  // warpgroup 0 issues first
    auto skip_tile = [&](int it) {
      tiles.wait_k(it);
      wait_turn(wg);
      pass_turn(wg);
      tiles.release_k(it);
      tiles.refill(it);
      tiles.wait_v(it);
      wait_turn(wg);
      pass_turn(wg);
      tiles.release_v(it);
    };
    if constexpr (overlap_of<Tiles>::value) {
      consume_overlapped<D, Tiles, BK, NS>(p, tiles, sQ, sK, sV, rows, o, st, kb0, ntiles, it_a, it_b, wg, t);
    } else {
      for (int it = 0; it < it_a; ++it) skip_tile(it);
      for (int it = it_a; it < it_b; ++it) {
        float s[BK / 2];
        uint32_t pf[BK / 16][4];
        float a0, a1;
        tiles.wait_k(it);
        wait_turn(wg);
        wgmma_fence();
        issue_qk<D, BK, NS>(s, sQ, sK, it, wg);
        pass_turn(wg);
        wgmma_wait<0>();
        wgmma_fence_operands(s);
        tiles.release_k(it);
        online_softmax<BK>(s, kb0 + it * BK + 2 * t, rows, p.scale_log2, st, a0, a1);
        tiles.refill(it);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? a1 : a0;
        pack_p<BK>(s, pf);
        tiles.wait_v(it);
        wait_turn(wg);
        wgmma_fence();
        issue_pv<D, BK, NS>(o, pf, sV, it);
        pass_turn(wg);
        wgmma_wait<0>();
        wgmma_fence_operands(o);
        tiles.release_v(it);
      }
      for (int it = it_b; it < ntiles; ++it) skip_tile(it);
    }
    if (wg == 0) wait_turn(wg);  // the turn warpgroup 1 passed last has no taker
  }

  const float l0 = quad_sum(st.l0), l1 = quad_sum(st.l1);
  if constexpr (split_of<Tiles>::value) {
    if (c.used > 1) {  // a split q-tile: the ranks merge (Q and the ring hold the partials)
      merge_ranks<D>(p, c, o, st.m0, st.m1, l0, l1, sQ, wg, tid);
      return;
    }
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  const long q_stride = (long)p.H * D;
  bf16* obase = p.o + ((long)c.b * p.Sq * p.H + c.h) * D;
  const int row0 = c.q0 + r0, row1 = row0 + 8;
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) {
    const int col = nb * 8 + t * 2;
    if (row0 < p.Sq)
      *reinterpret_cast<__nv_bfloat162*>(obase + row0 * q_stride + col) =
          __floats2bfloat162_rn(o[4 * nb] * inv0, o[4 * nb + 1] * inv0);
    if (row1 < p.Sq)
      *reinterpret_cast<__nv_bfloat162*>(obase + row1 * q_stride + col) =
          __floats2bfloat162_rn(o[4 * nb + 2] * inv1, o[4 * nb + 3] * inv1);
  }
}

// The TMA map of q [B, Sq, H, D] bf16 (strides of that layout), read in
// boxes of 64 columns x kBQ rows of one (b, head), 128-byte swizzled.
inline bool encode_q_map(CUtensorMap* map, const void* q, int B, int Sq, int H, int D) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)Sq, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2, (cuuint64_t)Sq * H * D * 2};
  const cuuint32_t box[4] = {kSwz, 1, kBQ, 1};
  return encode_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, q, dims, strides, box,
                           CU_TENSOR_MAP_SWIZZLE_128B);
}

// Launches `kernel(args...)` on `grid` CTAs in clusters of `cluster`, with
// `smem` bytes of dynamic shared memory; returns the launch's error.
template <int Threads = kThreads, class Kernel, class... Args>
cudaError_t launch_clusters(Kernel kernel, int grid, int cluster, int smem, cudaStream_t stream,
                            const Args&... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(Threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The most clusters of `cluster` CTAs of `kernel` (`threads` a CTA, `smem`
// bytes of dynamic shared memory) the card keeps resident at once, in *out
// (cudaOccupancyMaxActiveClusters: clusters pack into GPCs, so 2-CTA
// clusters of a one-CTA-an-SM kernel may fit fewer than sms / 2).
template <class Kernel>
cudaError_t max_active_clusters(Kernel kernel, int threads, int smem, int cluster, int* out) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}

// Launches `kernel(args...)` over one cluster of p.splits CTAs (one, if 0)
// a (b, head, q-tile) of `p`. With one CTA a cluster:
// at the main row (B=1, Sq=1536) the plain launch's time was bimodal (27.3 or
// 28.4 us between launches of one process), the cluster launch's steady at
// the lower mode (PERF.md).
template <int Threads = kThreads, class Kernel, class... Args>
cudaError_t launch_flash(Kernel kernel, const FlashParams& p, int smem, cudaStream_t stream, const Args&... args) {
  const int splits = max(p.splits, 1);
  return launch_clusters<Threads>(kernel, p.n_qtiles * p.H * p.B * splits, splits, smem, stream, args...);
}

}  // namespace flash
}  // namespace mllm
