// Single-token (decode) attention over the int8 or packed-int4 KV cache for
// Hopper, bf16 query and output, f32 statistics.
//
// Replaces: mllm_tpu/ops/decode_attention.py, `decode_attention_quant`
//   (Pallas kernel `_decode_quant_kernel`, int8 and `bits4`).
//
// What it computes: out[b, 0, h] = softmax(s) V over the keys j with
//   kv_start[b] <= j < min(kv_valid[b], S)  and, with a window,  j > kv_valid[b] - 1 - window,
// where, with the Pallas kernel's rounding points,
//   qs   = bf16(q[b, 0, h] * scale)
//   s_j  = (qs . Kq[j]) * ks[j]                 Kq: int8, or the planar nibble pair - 8
//   out  = sum_j bf16(p_j * vs[j]) * Vq[j] / sum_j p_j,   p_j = exp(s_j - max)
// The scales are folded into the score and the probability; the cache is never
// dequantized to memory. A sequence with no visible key gets zeros.
//
// What bounds it on this card: bytes. A (b, KV head) reads kv_valid * (D or
// D/2) bytes of K and of V plus 8 bytes of scales a key, and does 4 * D FLOPs
// a key for each of its n_rep query heads: a few FLOPs a byte, far below the
// ~295 at which an H100 stops being bound by its 3.35 TB/s. At the engine's
// shapes the bytes are few (1.9 MB at B=8), so what it must beat is latency:
// how many SMs pull bytes at once, and how few dependent steps a tile costs.
//
// What the design does about it (the design of decode_attention.cu):
//  - One CTA per (b, KV head, key split): the n_rep query heads of the KV head
//    are the 16 rows of mma.sync m16n8k16 products (zero-padded; `hgroups`
//    CTAs when n_rep > 16), so each K/V row is read by one CTA, not once per
//    query head.
//  - The keys [lo, hi) are cut into equal runs of whole 64-key tiles, one run
//    per cluster rank, by the rule of `decode_split_ranges` in
//    ops/decode_attention.py; each CTA reads its sequence's lengths on the
//    device, the host picks only the cluster size (`decode_splits`). When one
//    rank holds every tile (a sequence of one tile) it writes the output
//    itself and the other CTAs leave at once: no cluster barrier.
//  - Loads: every K/V row of a tile is one `cp.async.bulk` (128 bytes at int8
//    D=128, 64 at int4) and its key's scale one 4-byte cp.async, completed on
//    an mbarrier (the bulk bytes as its transaction count, the cp.async
//    copies by `cp.async.mbarrier.arrive`). Rows and scales outside [lo, hi)
//    are written as zeros by zero-filling cp.async, never copied, so a NaN or
//    inf left in a slot by an earlier request never reaches a product; no
//    thread waits on a global load to issue a tile.
//  - The integers become bf16 in the mma fragments, each once a tile, without
//    I2F: an int8 byte b is bf16(0x4300 | (b & 0x7f)) - bf16(0x4300 | (b & 0x80))
//    (128 + low bits, minus 128 or 256: exact), a nibble n is
//    bf16(0x4300 | n) - 136; both pairs by one bf16x2 subtraction. An mma's k
//    slots may stand for any head dims as long as q agrees, so a lane takes the
//    K bytes of a row that are contiguous in shared memory (one or two 16-byte
//    loads) and q's fragments are gathered in that order once; the V columns
//    are permuted the same way and put back in order at the merge.
//  - Scores: mma.sync of bf16 qs against the dequantized K, then x ks on the
//    f32 score (times log2 e: base 2). Probabilities enter P V as bf16(p * vs)
//    in the A fragment; row sums l stay f32 and unscaled.
//  - A CTA is two independent halves of four warps that take the rank's
//    tiles in turns, each with its own ring of two tiles and its own named
//    barrier, so two tiles' dependent chains (load, convert, mma, softmax)
//    run at once. Each warp takes 16 keys of its half's tiles and keeps its
//    own (m, l, acc) in registers; the eight warps merge in shared memory,
//    then the cluster's ranks merge in rank order through distributed shared
//    memory. One launch a call, no workspace, no atomics, an order of
//    summation that does not depend on scheduling.
#include "hopper.cuh"
#include "int4_stream.cuh"

namespace mllm {
namespace {

// kTile and kStages: measured against other values with
// tools/attention_tune.py --kernel decode_quant (PERF.md)
constexpr int kTile = 64;    // keys per tile: 16 per warp of a half
constexpr int kHalves = 2;   // independent 4-warp pipelines, taking the rank's tiles in turns
constexpr int kHalfWarps = kTile / 16;
constexpr int kHalfThreads = kHalfWarps * 32;
constexpr int kWarps = kHalves * kHalfWarps;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 2;   // tiles in flight in each half
constexpr int kRows = 16;    // query heads a CTA (the m16 of mma.sync)
constexpr int kMaxSplits = 8;  // the portable cluster size
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kHalfThreads == 2 * kTile, "each thread of a half copies one K or one V row of a tile");

struct QuantDecodeParams {
  const bf16* q;            // [B, 1, H, D]
  const uint8_t* k;         // [B, Hkv, S, RB]: int8 (RB = D) or packed nibbles (RB = D / 2)
  const uint8_t* v;         // [B, Hkv, S, RB]
  const float* ks;          // [B, Hkv, S] per-key K scales
  const float* vs;          // [B, Hkv, S] per-key V scales
  bf16* o;                  // [B, 1, H, D]
  const int* kv_valid_vec;  // [B], or null: every sequence has kv_valid
  const int* kv_start;      // [B], or null: no left pad
  int B, H, Hkv, S;
  int kv_valid, window;
  int hgroups;              // CTAs a KV head needs for its n_rep query heads
  float scale;              // the softmax scale, multiplied into q before it is rounded to bf16
};

// Shapes of a stored row and of its staged copies. Lane (g, t) reads the K
// bytes [t KB, (t + 1) KB) of key rows g and g + 8 of its warp's 16, and the
// V bytes [g VB, (g + 1) VB) of key rows 2t, 2t + 1, 2t + 8, 2t + 9; the row
// strides below make each load instruction's lanes fall in distinct banks.
template <int D, bool kInt4>
struct Geo {
  static constexpr int kRB = kInt4 ? D / 2 : D;          // bytes of a stored row
  static constexpr int kKB = kRB / 4, kVB = kRB / 8;    // bytes a lane takes of a K / V row
  static constexpr int kLdK = kRB == 128 ? 144 : kRB;   // staged row strides
  static constexpr int kLdV = kRB == 128 ? 144 : 80;
  static constexpr int kSteps = D / 16;                 // k-steps of Q K^T
  static constexpr int kND = D / 8;                     // 8-column blocks of O
  // one stage: K rows, V rows, K scales, V scales
  static constexpr int kStageBytes = kTile * (kLdK + kLdV) + 2 * kTile * 4;
  static constexpr int kRing = kHalves * kStages * kStageBytes;
  static constexpr int kMerge = kWarps * kRows * D * 4;  // each warp's acc, once the ring is idle
  static constexpr int kArea = kRing > kMerge ? kRing : kMerge;
};

template <int D, bool kInt4>
struct Smem {
  using G = Geo<D, kInt4>;
  alignas(16) uint8_t area[G::kArea];         // the ring [half][stage], then the merge
  uint4 qf[G::kSteps][32];                     // qs as each lane's A fragment of each k-step
  uint64_t full[kHalves][kStages];
  float wm[kWarps][kRows], wl[kWarps][kRows];  // each warp's (m, l)
  float m[kRows], l[kRows];                      // the CTA's partial, read by the cluster
};

// The head dim of k-step kk's slot pair p (0: slots 2t, 2t + 1; 1: slots
// 2t + 8, 2t + 9), first element (the second is 2 further): a lane's K word
// w holds bytes 0..3; (w) gives bytes 0 and 2 to pair 0, (w >> 8) bytes 1
// and 3 to pair 1. int4: the low nibbles are the first D/2 head dims, the
// high ones the rest.
template <int D, bool kInt4>
__device__ __forceinline__ int q_dim(int kk, int p, int t) {
  using G = Geo<D, kInt4>;
  if constexpr (kInt4) {
    constexpr int kHalf = G::kSteps / 2;
    return (kk / kHalf) * (D / 2) + t * G::kKB + (kk % kHalf) * 4 + p;
  } else {
    return t * G::kKB + kk * 4 + p;
  }
}

// The head dim of column n of the 8-column block nd of P V (lane g reads the
// V bytes [g VB, (g + 1) VB) of a row; byte i is block i, and at int4 its
// high nibble block VB + i).
template <int D, bool kInt4>
__device__ __forceinline__ int v_dim(int nd, int n) {
  using G = Geo<D, kInt4>;
  if constexpr (kInt4) return (nd / G::kVB) * (D / 2) + n * G::kVB + nd % G::kVB;
  else return n * G::kVB + nd;
}

// kWords u32 of shared memory at p (16-byte aligned for 4 and 8 words, 8 for 2).
template <int kWords>
__device__ __forceinline__ void lds_words(uint32_t (&w)[kWords], const uint8_t* p) {
  if constexpr (kWords % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kWords / 4; ++i) {
      const uint4 u = *reinterpret_cast<const uint4*>(p + 16 * i);
      w[4 * i] = u.x;
      w[4 * i + 1] = u.y;
      w[4 * i + 2] = u.z;
      w[4 * i + 3] = u.w;
    }
  } else if constexpr (kWords == 2) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x;
    w[1] = u.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

// c += A B with the A fragment of qs held in a 16-byte shared-memory slot.
__device__ __forceinline__ void mma_q(float (&c)[4], const uint4& q, uint32_t b0, uint32_t b1) {
  const uint32_t a[4] = {q.x, q.y, q.z, q.w};
  mma_bf16_16816(c, a, b0, b1);
}

__device__ __forceinline__ void half_sync(int half) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(1 + half), "r"(kHalfThreads) : "memory");
}

template <int D, bool kInt4>
__global__ void __launch_bounds__(kThreads, kHalves == 2 ? 2 : 3) decode_quant_kernel(const QuantDecodeParams p) {
  using G = Geo<D, kInt4>;
  constexpr int kSteps = G::kSteps, kND = G::kND;
  extern __shared__ __align__(16) unsigned char smem[];
  auto& s = *reinterpret_cast<Smem<D, kInt4>*>(smem);
  float* acc_smem = reinterpret_cast<float*>(s.area);  // the merge area, once the ring is idle

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int half = warp / kHalfWarps, hwarp = warp % kHalfWarps, htid = tid % kHalfThreads;
  const int g = lane >> 2, t = lane & 3;
  const int rank = blockIdx.x, splits = gridDim.x;  // grid.x is one cluster
  const int hk = blockIdx.y / p.hgroups, b = blockIdx.z;
  const int n_rep = p.H / p.Hkv;
  const int h0 = hk * n_rep + (blockIdx.y % p.hgroups) * kRows;  // first query head
  const int rows = min(kRows, hk * n_rep + n_rep - h0);

  // q of this CTA's heads for the k-steps this warp builds (heads g and
  // g + 8; padded heads are zeros), loaded first, beside the length reads.
  constexpr int kQPer = (kSteps + kWarps - 1) / kWarps;  // k-steps of qs a warp builds
  uint2 qraw[kQPer][2];
#pragma unroll
  for (int j = 0; j < kQPer; ++j) {
    const int kk = warp + j * kWarps;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = g + 8 * hh;
      qraw[j][hh] = kk < kSteps && r < rows
                        ? *reinterpret_cast<const uint2*>(p.q + ((long)b * p.H + h0 + r) * D + q_dim<D, kInt4>(kk, 0, t))
                        : make_uint2(0u, 0u);
    }
  }

  // The visible keys [lo, hi), and this rank's tiles of them
  // (decode_split_ranges in ops/decode_attention.py); half h takes the
  // rank's tiles h, h + 2, ...
  const int kv_valid = p.kv_valid_vec ? p.kv_valid_vec[b] : p.kv_valid;
  const int hi = min(kv_valid, p.S);
  int lo = max(p.kv_start ? p.kv_start[b] : 0, 0);
  if (p.window > 0) lo = max(lo, kv_valid - p.window);
  const int t0 = (lo / kTile) * kTile;
  const int ntiles = hi > lo ? (hi - t0 + kTile - 1) / kTile : 0;
  const int per = (ntiles + splits - 1) / splits;
  const int first = min(rank * per, ntiles);
  const int mine = min(first + per, ntiles) - first;
  const int my_tiles = mine > half ? (mine - half + kHalves - 1) / kHalves : 0;  // this half's
  const int busy_warps = min(mine, kHalves) * kHalfWarps;  // the warps whose half has a tile
  // Ranks [0, used) hold tiles. Every CTA of the cluster computes the same
  // count; when rank 0 alone holds them it writes the output from its own
  // partial, the others leave now, and nobody meets at a cluster barrier.
  const int used = per > 0 ? (ntiles + per - 1) / per : 0;
  if (used <= 1 && rank > 0) return;

  const long row0 = ((long)b * p.Hkv + hk) * p.S;  // first key row of this (b, KV head)
  if (tid == 0) {
    for (int h = 0; h < kHalves; ++h)
      for (int i = 0; i < kStages; ++i) mbar_init(&s.full[h][i], kHalfThreads);
    fence_mbar_init();
  }
  __syncthreads();

  // This half's tile li (the rank's tile 2 li + half) into its stage li %
  // kStages: thread htid copies row htid % kTile of K (htid < kTile) or V
  // and that key's scale; a row or scale outside [lo, hi) is written as
  // zeros by a zero-filling cp.async (no global read). Every thread arrives
  // once a tile, when its cp.async copies have landed; the phase completes
  // when the bulk copies have too.
  auto stage_ptr = [&](int li) {
    return s.area + (half * kStages + li % kStages) * G::kStageBytes;
  };
  auto issue = [&](int li) {
    uint8_t* st = stage_ptr(li);
    uint64_t* bar = &s.full[half][li % kStages];
    const int r = htid % kTile;
    const bool is_k = htid < kTile;
    const int j = t0 + (first + kHalves * li + half) * kTile + r;
    const bool ok = j >= lo && j < hi;
    uint8_t* dst = is_k ? st + r * G::kLdK : st + kTile * G::kLdK + r * G::kLdV;
    float* sdst = reinterpret_cast<float*>(st + kTile * (G::kLdK + G::kLdV)) + (is_k ? 0 : kTile) + r;
    const uint8_t* src = is_k ? p.k : p.v;
    if (ok) {
      fence_proxy_async();  // the slot's earlier reads by this CTA precede the bulk write
      mbar_expect_tx(bar, G::kRB);
      bulk_g2s(dst, src + (row0 + j) * G::kRB, G::kRB, bar);
    } else {
#pragma unroll
      for (int c = 0; c < G::kRB / 16; ++c) cp_async_16(dst + c * 16, src, false);
    }
    cp_async_4(sdst, (is_k ? p.ks : p.vs) + (ok ? row0 + j : 0), ok);
    cp_async_mbar_arrive(bar);
  };
  for (int li = 0; li < min(my_tiles, kStages); ++li) issue(li);

  // qs = bf16(q * scale) as A fragments for all of D, in the k order of the
  // K words (q_dim): warp w builds k-steps w, w + kWarps, ... into shared
  // memory, where every warp reads them (which keeps a thread's registers
  // for two CTAs an SM).
#pragma unroll
  for (int j = 0; j < kQPer; ++j) {
    const int kk = warp + j * kWarps;
    if (kk < kSteps) {
      uint32_t f[4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {  // head dims q_dim(kk, 0) + 0, 1, 2, 3
        const __nv_bfloat162 lo2 = *reinterpret_cast<const __nv_bfloat162*>(&qraw[j][hh].x);
        const __nv_bfloat162 hi2 = *reinterpret_cast<const __nv_bfloat162*>(&qraw[j][hh].y);
        f[hh] = pack_bf16x2(__low2float(lo2) * p.scale, __low2float(hi2) * p.scale);       // slots 2t, 2t + 1
        f[2 + hh] = pack_bf16x2(__high2float(lo2) * p.scale, __high2float(hi2) * p.scale);  // slots 2t + 8, 2t + 9
      }
      s.qf[kk][lane] = make_uint4(f[0], f[1], f[2], f[3]);
    }
  }
  __syncthreads();  // qs

  float o[kND][4];
#pragma unroll
  for (int nd = 0; nd < kND; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  // Each thread holds heads g (index 0) and g + 8 (index 1).
  float m0 = kNegBig, m1 = kNegBig, l0 = 0.f, l1 = 0.f;

  for (int li = 0; li < my_tiles; ++li) {
    mbar_wait(&s.full[half][li % kStages], (li / kStages) & 1);
    const uint8_t* st = stage_ptr(li);
    const uint8_t* kt = st + hwarp * 16 * G::kLdK;  // this warp's 16 keys
    const uint8_t* vt = st + kTile * G::kLdK + hwarp * 16 * G::kLdV;
    const float* kst = reinterpret_cast<const float*>(st + kTile * (G::kLdK + G::kLdV)) + hwarp * 16;
    const float* vst = kst + kTile;
    const int key0 = t0 + (first + kHalves * li + half) * kTile + hwarp * 16;

    // S = Q K^T: 16 heads x this warp's 16 keys (n-block nb: keys 8 nb + g).
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      uint32_t kw[G::kKB / 4];
      lds_words<G::kKB / 4>(kw, kt + (nb * 8 + g) * G::kLdK + t * G::kKB);
#pragma unroll
      for (int wi = 0; wi < G::kKB / 4; ++wi) {
        if constexpr (kInt4) {
          constexpr int kHalf = kSteps / 2;
          mma_q(sc[nb], s.qf[wi][lane], i4s::nibbles_to_bf16x2<false>(kw[wi]),
                i4s::nibbles_to_bf16x2<false>(kw[wi] >> 8));
          mma_q(sc[nb], s.qf[kHalf + wi][lane], i4s::nibbles_to_bf16x2<false>(kw[wi] >> 4),
                i4s::nibbles_to_bf16x2<false>(kw[wi] >> 12));
        } else {
          mma_q(sc[nb], s.qf[wi][lane], i4s::int8_to_bf16x2(kw[wi]), i4s::int8_to_bf16x2(kw[wi] >> 8));
        }
      }
    }

    float mx0 = kNegBig, mx1 = kNegBig;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kl = nb * 8 + t * 2 + (c & 1);  // the key within the warp's 16
        const int kpos = key0 + kl;
        const float x = kpos >= lo && kpos < hi ? sc[nb][c] * kst[kl] * kLog2e : -INFINITY;
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

    // O += bf16(P * vs) V over this warp's 16 keys: slot 2t + e is key 2t + e
    // (masked keys have p = 0 and a zeroed scale).
    const float v0 = vst[2 * t], v1 = vst[2 * t + 1], v8 = vst[2 * t + 8], v9 = vst[2 * t + 9];
    const uint32_t pa[4] = {pack_bf16x2(sc[0][0] * v0, sc[0][1] * v1), pack_bf16x2(sc[0][2] * v0, sc[0][3] * v1),
                            pack_bf16x2(sc[1][0] * v8, sc[1][1] * v9), pack_bf16x2(sc[1][2] * v8, sc[1][3] * v9)};
    uint32_t vw[4][G::kVB / 4 > 0 ? G::kVB / 4 : 1];  // rows 2t, 2t + 1, 2t + 8, 2t + 9
#pragma unroll
    for (int i = 0; i < 4; ++i)
      lds_words<G::kVB / 4>(vw[i], vt + (2 * t + (i & 1) + 8 * (i >> 1)) * G::kLdV + g * G::kVB);
#pragma unroll
    for (int i = 0; i < G::kVB; ++i) {  // byte i of the lane's V chunk
      const uint32_t sel = (i % 4) | ((4 + i % 4) << 8);  // byte i of the first row, of the second row
      const uint32_t x01 = i4s::prmt(vw[0][i / 4], vw[1][i / 4], sel);  // keys 2t, 2t + 1
      const uint32_t x89 = i4s::prmt(vw[2][i / 4], vw[3][i / 4], sel);  // keys 2t + 8, 2t + 9
      if constexpr (kInt4) {
        mma_bf16_16816(o[i], pa, i4s::nibbles_to_bf16x2<false>(x01), i4s::nibbles_to_bf16x2<false>(x89));
        mma_bf16_16816(o[G::kVB + i], pa, i4s::nibbles_to_bf16x2<false>(x01 >> 4),
                       i4s::nibbles_to_bf16x2<false>(x89 >> 4));
      } else {
        mma_bf16_16816(o[i], pa, i4s::int8_to_bf16x2(x01), i4s::int8_to_bf16x2(x89));
      }
    }
    half_sync(half);  // every warp of the half is done with this stage
    if (li + kStages < my_tiles) issue(li + kStages);
  }

  // Merge the eight warps: (m, l) and acc per warp into shared memory (once
  // both halves are done with the ring), then in warp order. acc is kept in
  // fragment order, column f = 8 nd + n of a row (v_dim gives its head dim).
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
  __syncthreads();  // the other half may still read its last stage
  float* wacc = acc_smem + warp * kRows * D;
  if (warp < busy_warps) {  // an idle warp's partial is empty: it is left out of the merge
#pragma unroll
    for (int nd = 0; nd < kND; ++nd) {
      const int col = nd * 8 + t * 2;
      if (g < rows) *reinterpret_cast<float2*>(wacc + g * D + col) = make_float2(o[nd][0], o[nd][1]);
      if (g + 8 < rows) *reinterpret_cast<float2*>(wacc + (g + 8) * D + col) = make_float2(o[nd][2], o[nd][3]);
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D;
    float mx = kNegBig;
    for (int w = 0; w < busy_warps; ++w) mx = fmaxf(mx, s.wm[w][r]);
    float l = 0.f, a = 0.f;
    for (int w = 0; w < busy_warps; ++w) {  // warp order
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

  if (used <= 1) {  // rank 0 alone: its partial is the result
    __syncthreads();
    for (int i = tid; i < rows * D; i += kThreads) {
      const int r = i / D, f = i % D;
      const float l = s.l[r];
      p.o[((long)b * p.H + h0 + r) * D + v_dim<D, kInt4>(f / 8, f % 8)] =
          __float2bfloat16(l > 0.f ? acc_smem[i] / l : 0.f);
    }
    return;
  }

  // Merge the ranks that hold tiles in rank order through distributed shared
  // memory; rank r writes outputs [r * chunk, (r + 1) * chunk) of this CTA
  // group's rows * D.
  cluster_sync();
  const int total = rows * D, chunk = (total + splits - 1) / splits;
  for (int i = rank * chunk + tid; i < min(total, (rank + 1) * chunk); i += kThreads) {
    const int r = i / D, f = i % D;
    // every remote load first (one round trip), then the sums in rank order
    float pm[kMaxSplits], pl[kMaxSplits], pa[kMaxSplits];
#pragma unroll
    for (int rr = 0; rr < kMaxSplits; ++rr) {
      if (rr < used) {
        pm[rr] = ld_cluster_f32(map_rank(&s.m[r], rr));
        pl[rr] = ld_cluster_f32(map_rank(&s.l[r], rr));
        pa[rr] = ld_cluster_f32(map_rank(acc_smem + i, rr));
      }
    }
    float mx = kNegBig;
#pragma unroll
    for (int rr = 0; rr < kMaxSplits; ++rr)
      if (rr < used) mx = fmaxf(mx, pm[rr]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int rr = 0; rr < kMaxSplits; ++rr) {
      if (rr < used) {
        const float e = exp2f(pm[rr] - mx);
        l += pl[rr] * e;
        a += pa[rr] * e;
      }
    }
    p.o[((long)b * p.H + h0 + r) * D + v_dim<D, kInt4>(f / 8, f % 8)] = __float2bfloat16(l > 0.f ? a / l : 0.f);
  }
  cluster_sync();  // no CTA leaves while another still reads its shared memory
}

template <int D, bool kInt4>
cudaError_t launch(const QuantDecodeParams& p, int splits, cudaStream_t stream) {
  constexpr int smem = sizeof(Smem<D, kInt4>);
  cudaError_t err = cudaFuncSetAttribute(decode_quant_kernel<D, kInt4>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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
  err = cudaLaunchKernelEx(&cfg, decode_quant_kernel<D, kInt4>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
}  // namespace mllm

// Returns the CUDA error code of the launch (0 on success). bits is 8 (int8
// K/V [B, Hkv, S, D]) or 4 (packed uint8 [B, Hkv, S, D/2]). kv_valid_vec and
// kv_start may be null. `splits` is the cluster size (1..8): the CTAs that
// share the keys of one (b, KV head). The kernel does not synchronise.
extern "C" int mllm_decode_attention_quant(const void* q, const void* k, const void* v,
                                           const void* ks, const void* vs, void* out,
                                           const void* kv_valid_vec, const void* kv_start, int B,
                                           int H, int Hkv, int S, int D, int bits, int kv_valid,
                                           int window, float scale, int splits, void* stream) {
  using namespace mllm;
  if (splits < 1 || splits > kMaxSplits || H % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int hgroups = (H / Hkv + kRows - 1) / kRows;
  const QuantDecodeParams p{static_cast<const bf16*>(q), static_cast<const uint8_t*>(k),
                            static_cast<const uint8_t*>(v), static_cast<const float*>(ks),
                            static_cast<const float*>(vs), static_cast<bf16*>(out),
                            static_cast<const int*>(kv_valid_vec),
                            static_cast<const int*>(kv_start), B, H, Hkv, S, kv_valid, window,
                            hgroups, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128 && bits == 8) return launch<128, false>(p, splits, s);
  if (D == 128 && bits == 4) return launch<128, true>(p, splits, s);
  if (D == 64 && bits == 8) return launch<64, false>(p, splits, s);
  if (D == 64 && bits == 4) return launch<64, true>(p, splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
