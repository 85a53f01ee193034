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
//  - Loads: one thread of a half issues each of its 64-key tiles as TMA
//    boxes (`Geo`): the stored rows of K and of V as boxes of 64 rows by the
//    swizzle span (128 bytes, or the whole row when it is shorter: 64 or 32
//    bytes in the 64- or 32-byte swizzle; int8 at D = 256 is two boxes a
//    row) from tensor maps over the [B * Hkv, S, row bytes] integers, and the
//    tile's 64 K and 64 V scales as one 1-D box each, all completed on the
//    stage's mbarrier. The first design issued one cp.async.bulk a row and
//    one 4-byte cp.async a scale from every thread of the half (256 copies
//    a tile at int8 D = 256); the boxes took the engine's 8-slot row from
//    0.01157 to 0.01021 ms and Gemma-2B's from 0.01523 to 0.01397 (PERF.md).
//    A box copies the rows and scales as they lie: a key outside [lo, hi)
//    may hold a stale slot's integers and a NaN or inf scale, so its score
//    is masked to -inf (p = 0) and its V scale is replaced by 0 before it
//    multiplies p; a K scale of such a key is never used. Rows past the
//    cache load as zeros (the map's end).
//  - Lane to bytes: a lane reads its K and V bytes from each box at their
//    swizzled places, and the warp's 16 keys are the box rows `key_row` maps
//    them to (the identity at 128-byte boxes; at 64 and 32 bytes a
//    permutation that spreads each load instruction's rows over both halves
//    of the bank window): every load instruction of a warp is free of bank
//    conflicts (tests/test_torch_quant_redesign.py checks each geometry).
//  - The integers become bf16 in the mma fragments, each once a tile, without
//    I2F: an int8 byte b is bf16(0x4300 | (b & 0x7f)) - bf16(0x4300 | (b & 0x80))
//    (128 + low bits, minus 128 or 256: exact), a nibble n is
//    bf16(0x4300 | n) - 136; both pairs by one bf16x2 subtraction. An mma's k
//    slots may stand for any head dims as long as q agrees, so a lane takes a
//    contiguous share of each box of a row (one or two 16-byte loads, or 8
//    bytes) and q's fragments are gathered in that order once (`q_dim`); the
//    V columns are permuted the same way (`v_dim`) and put back in order at
//    the merge.
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
//  - head_dim 256 (Gemma-2B; the reference runs its Pallas kernel there too):
//    the same design, O in 32 fragments (128 registers a thread) and a 128 KB
//    merge area: one CTA an SM, up to 255 registers a thread.
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
constexpr int kSwizzleSpan = 128;  // bytes: the widest box row TMA swizzles
constexpr float kLog2e = 1.4426950408889634f;

struct QuantDecodeParams {
  const bf16* q;            // [B, 1, H, D]
  bf16* o;                  // [B, 1, H, D]
  const int* kv_valid_vec;  // [B], or null: every sequence has kv_valid
  const int* kv_start;      // [B], or null: no left pad
  int B, H, Hkv, S;
  int kv_valid, window;
  int hgroups;              // CTAs a KV head needs for its n_rep query heads
  float scale;              // the softmax scale, multiplied into q before it is rounded to bf16
};

// Shapes of a stored row, of its boxes and of a ring stage. A row of kRB
// bytes is kNB boxes of kBW bytes. Lane (g, t) takes the K bytes [t KW,
// (t + 1) KW) of each box of key rows g and g + 8 of its warp's 16 (through
// key_row), and the V bytes [g VW, (g + 1) VW) of each box of key rows 2t,
// 2t + 1, 2t + 8, 2t + 9.
template <int D, bool kInt4>
struct Geo {
  static constexpr int kRB = kInt4 ? D / 2 : D;                       // bytes of a stored row
  static constexpr int kBW = kRB < kSwizzleSpan ? kRB : kSwizzleSpan;  // bytes of a box row
  static constexpr int kNB = kRB / kBW;                               // boxes of a row
  static constexpr int kKW = kBW / 4, kVW = kBW / 8;  // bytes a lane takes of each box of a K / V row
  static constexpr int kKWords = kNB * kKW / 4;       // u32 words a lane holds of a K row
  static constexpr int kVWords = kNB * kVW / 4 > 0 ? kNB * kVW / 4 : 1;  // of a V row
  static constexpr int kSteps = D / 16;               // k-steps of Q K^T
  static constexpr int kND = D / 8;                   // 8-column blocks of O
  static constexpr int kBox = kTile * kBW;            // bytes of one box
  static constexpr int kRowsBytes = kTile * kRB;      // a tile's K (or V) rows
  // one stage: K boxes, V boxes, K scales, V scales; stages 1024-byte aligned (the swizzle's span)
  static constexpr int kStageBytes = (2 * kRowsBytes + 2 * kTile * 4 + 1023) / 1024 * 1024;
  static constexpr int kTx = 2 * kRowsBytes + 2 * kTile * 4;  // bytes TMA writes a stage
  static constexpr int kRing = kHalves * kStages * kStageBytes;
  static constexpr int kMerge = kWarps * kRows * D * 4;  // each warp's acc, once the ring is idle
  static constexpr int kArea = kRing > kMerge ? kRing : kMerge;
  static_assert(kRB % kBW == 0 && kBW >= 32 && kVW >= 4, "whole boxes of 32, 64 or 128 bytes");
};

template <int D, bool kInt4>
struct Smem {
  using G = Geo<D, kInt4>;
  alignas(1024) uint8_t area[G::kArea];       // the ring [half][stage], then the merge
  uint4 qf[G::kSteps][32];                     // qs as each lane's A fragment of each k-step
  uint64_t full[kHalves][kStages];
  float wm[kWarps][kRows], wl[kWarps][kRows];  // each warp's (m, l)
  float m[kRows], l[kRows];                      // the CTA's partial, read by the cluster
};

// The byte offset of 16-byte chunk c of row r in a box of kBW-byte rows as
// TMA writes it in the swizzle of that width (CU_TENSOR_MAP_SWIZZLE_128B /
// 64B / 32B: the chunk's bits XOR the address bits 7-9, 7-8 or 7).
template <int kBW>
__device__ __forceinline__ int swizzled(int r, int c) {
  if constexpr (kBW == 128) return r * 128 + ((c ^ (r & 7)) << 4);
  else if constexpr (kBW == 64) return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
  else return r * 32 + ((c ^ ((r >> 2) & 1)) << 4);
}

// The box row (of the warp's 16) that the warp's key slot j (0..15: the n
// index of S = Q K^T, the k index of P V) stands for. At 128-byte rows the
// identity; at 64- and 32-byte rows a permutation of each 8, so that the
// rows each load instruction reaches fall in distinct banks.
template <int kBW>
__device__ __forceinline__ int key_row(int j) {
  constexpr uint32_t kPerm = kBW == 128 ? 0x76543210u : kBW == 64 ? 0x65742130u : 0x57463120u;
  return (j & 8) | ((kPerm >> (4 * (j & 7))) & 7);
}

// The head dim of k-step kk's slot pair p (0: slots 2t, 2t + 1; 1: slots
// 2t + 8, 2t + 9), first element (the second is 2 further): a lane's K word
// w holds bytes 0..3 of its share of a box; (w) gives bytes 0 and 2 to pair
// 0, (w >> 8) bytes 1 and 3 to pair 1. int4: the low nibbles are the first
// D/2 head dims, the high ones the rest.
template <int D, bool kInt4>
__device__ __forceinline__ int q_dim(int kk, int p, int t) {
  using G = Geo<D, kInt4>;
  constexpr int kPer = G::kKW / 4;  // words of one box
  const int half = kInt4 ? kk / G::kKWords : 0, wi = kInt4 ? kk % G::kKWords : kk;
  return half * (D / 2) + (wi / kPer) * G::kBW + t * G::kKW + (wi % kPer) * 4 + p;
}

// The head dim of column n of the 8-column block nd of P V: byte i of a
// lane's V share of box b is block b VW + i (at int4 its high nibble block
// RB / 8 + b VW + i).
template <int D, bool kInt4>
__device__ __forceinline__ int v_dim(int nd, int n) {
  using G = Geo<D, kInt4>;
  constexpr int kLow = G::kRB / 8;  // blocks of the low nibbles (int8: every block)
  const int half = nd / kLow, r = nd % kLow;
  return half * (D / 2) + (r / G::kVW) * G::kBW + n * G::kVW + r % G::kVW;
}

// A lane's K words of box row r of the stage's K boxes (lane t's bytes of
// each box), in box order.
template <int D, bool kInt4>
__device__ __forceinline__ void load_k(uint32_t (&w)[Geo<D, kInt4>::kKWords], const uint8_t* kbox, int r, int t) {
  using G = Geo<D, kInt4>;
#pragma unroll
  for (int b = 0; b < G::kNB; ++b) {
    const uint8_t* box = kbox + b * G::kBox;
    if constexpr (G::kKW >= 16) {
#pragma unroll
      for (int j = 0; j < G::kKW / 16; ++j) {
        const uint4 u = *reinterpret_cast<const uint4*>(box + swizzled<G::kBW>(r, t * (G::kKW / 16) + j));
        uint32_t* o = w + b * (G::kKW / 4) + 4 * j;
        o[0] = u.x;
        o[1] = u.y;
        o[2] = u.z;
        o[3] = u.w;
      }
    } else {  // 8 bytes: half of a chunk
      const uint2 u = *reinterpret_cast<const uint2*>(box + swizzled<G::kBW>(r, t >> 1) + (t & 1) * 8);
      w[b * 2] = u.x;
      w[b * 2 + 1] = u.y;
    }
  }
}

// A lane's V words of box row r (lane g's bytes of each box), in box order.
template <int D, bool kInt4>
__device__ __forceinline__ void load_v(uint32_t (&w)[Geo<D, kInt4>::kVWords], const uint8_t* vbox, int r, int g) {
  using G = Geo<D, kInt4>;
#pragma unroll
  for (int b = 0; b < G::kNB; ++b) {
    const uint8_t* box = vbox + b * G::kBox;
    if constexpr (G::kVW == 16) {
      const uint4 u = *reinterpret_cast<const uint4*>(box + swizzled<G::kBW>(r, g));
      w[b * 4] = u.x;
      w[b * 4 + 1] = u.y;
      w[b * 4 + 2] = u.z;
      w[b * 4 + 3] = u.w;
    } else if constexpr (G::kVW == 8) {
      const uint2 u = *reinterpret_cast<const uint2*>(box + swizzled<G::kBW>(r, g >> 1) + (g & 1) * 8);
      w[b * 2] = u.x;
      w[b * 2 + 1] = u.y;
    } else {
      w[b] = *reinterpret_cast<const uint32_t*>(box + swizzled<G::kBW>(r, g >> 2) + (g & 3) * 4);
    }
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

// head_dim 256 keeps O in 128 registers a thread and a merge area of 128 KB:
// one CTA an SM, up to 255 registers a thread.
template <int D, bool kInt4>
__global__ void __launch_bounds__(kThreads, D > 128 ? 1 : (kHalves == 2 ? 2 : 3))
    decode_quant_kernel(const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_ks, const __grid_constant__ CUtensorMap tm_vs,
                        const QuantDecodeParams p) {
  using G = Geo<D, kInt4>;
  constexpr int kSteps = G::kSteps, kND = G::kND;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // 1024-byte alignment: the swizzle of a box repeats every 1024 bytes at most
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  auto& s = *reinterpret_cast<Smem<D, kInt4>*>(base);
  float* acc_smem = reinterpret_cast<float*>(s.area);  // the merge area, once the ring is idle

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int half = warp / kHalfWarps, hwarp = warp % kHalfWarps, htid = tid % kHalfThreads;
  const int g = lane >> 2, t = lane & 3;
  const int rank = blockIdx.x, splits = gridDim.x;  // grid.x is one cluster
  const int hk = blockIdx.y / p.hgroups, b = blockIdx.z;
  const int n_rep = p.H / p.Hkv;
  const int h0 = hk * n_rep + (blockIdx.y % p.hgroups) * kRows;  // first query head
  const int rows = min(kRows, hk * n_rep + n_rep - h0);
  if (tid == 0) {
    tma_prefetch(&tm_k);
    tma_prefetch(&tm_v);
    tma_prefetch(&tm_ks);
    tma_prefetch(&tm_vs);
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
  auto tiles_of = [&](int h) { return mine > h ? (mine - h + kHalves - 1) / kHalves : 0; };
  const int my_tiles = tiles_of(half);  // this half's
  const int busy_warps = min(mine, kHalves) * kHalfWarps;  // the warps whose half has a tile
  // Ranks [0, used) hold tiles. Every CTA of the cluster computes the same
  // count; when rank 0 alone holds them it writes the output from its own
  // partial, the others leave now, and nobody meets at a cluster barrier.
  const int used = per > 0 ? (ntiles + per - 1) / per : 0;
  if (used <= 1 && rank > 0) return;

  // Half h's tile li (the rank's tile 2 li + h) into its stage li % kStages,
  // by one thread: the K and V boxes of the (b, KV head) plane and the two
  // scale boxes, on the stage's barrier.
  const int plane = b * p.Hkv + hk;
  auto stage_ptr = [&](int h, int li) { return s.area + (h * kStages + li % kStages) * G::kStageBytes; };
  auto issue = [&](int h, int li) {
    uint8_t* st = stage_ptr(h, li);
    uint64_t* bar = &s.full[h][li % kStages];
    const int row = t0 + (first + kHalves * li + h) * kTile;
    fence_proxy_async();  // the stage's earlier reads by this CTA precede the tensor copies' writes
    mbar_arrive_expect_tx(bar, G::kTx);
#pragma unroll
    for (int bx = 0; bx < G::kNB; ++bx) {
      tma_load_3d(st + bx * G::kBox, &tm_k, bar, bx * G::kBW, row, plane);
      tma_load_3d(st + G::kRowsBytes + bx * G::kBox, &tm_v, bar, bx * G::kBW, row, plane);
    }
    tma_load_1d(st + 2 * G::kRowsBytes, &tm_ks, bar, plane * p.S + row);
    tma_load_1d(st + 2 * G::kRowsBytes + kTile * 4, &tm_vs, bar, plane * p.S + row);
  };
  if (tid == 0) {  // the lengths are known: the first tiles of both halves go out at once
    for (int h = 0; h < kHalves; ++h)
      for (int i = 0; i < kStages; ++i) mbar_init(&s.full[h][i], 1);
    fence_mbar_init();
    for (int h = 0; h < kHalves; ++h)
      for (int li = 0; li < min(tiles_of(h), kStages); ++li) issue(h, li);
  }

  // q of this CTA's heads for the k-steps this warp builds (heads g and
  // g + 8; padded heads are zeros), in the k order of the K words (q_dim):
  // warp w builds k-steps w, w + kWarps, ... of qs = bf16(q * scale) as A
  // fragments into shared memory, where every warp reads them (which keeps
  // a thread's registers for two CTAs an SM).
  constexpr int kQPer = (kSteps + kWarps - 1) / kWarps;  // k-steps of qs a warp builds
#pragma unroll
  for (int j = 0; j < kQPer; ++j) {
    const int kk = warp + j * kWarps;
    if (kk < kSteps) {
      uint32_t f[4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {  // head dims q_dim(kk, 0) + 0, 1, 2, 3
        const int r = g + 8 * hh;
        const uint2 raw = r < rows
                              ? *reinterpret_cast<const uint2*>(p.q + ((long)b * p.H + h0 + r) * D + q_dim<D, kInt4>(kk, 0, t))
                              : make_uint2(0u, 0u);
        const __nv_bfloat162 lo2 = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
        const __nv_bfloat162 hi2 = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
        f[hh] = pack_bf16x2(__low2float(lo2) * p.scale, __low2float(hi2) * p.scale);       // slots 2t, 2t + 1
        f[2 + hh] = pack_bf16x2(__high2float(lo2) * p.scale, __high2float(hi2) * p.scale);  // slots 2t + 8, 2t + 9
      }
      s.qf[kk][lane] = make_uint4(f[0], f[1], f[2], f[3]);
    }
  }
  __syncthreads();  // qs, and the barriers initialised before anyone waits on them

  float o[kND][4];
#pragma unroll
  for (int nd = 0; nd < kND; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  // Each thread holds heads g (index 0) and g + 8 (index 1).
  float m0 = kNegBig, m1 = kNegBig, l0 = 0.f, l1 = 0.f;

  for (int li = 0; li < my_tiles; ++li) {
    mbar_wait(&s.full[half][li % kStages], (li / kStages) & 1);
    const uint8_t* st = stage_ptr(half, li);
    const uint8_t* kbox = st;
    const uint8_t* vbox = st + G::kRowsBytes;
    const float* kst = reinterpret_cast<const float*>(st + 2 * G::kRowsBytes) + hwarp * 16;  // this warp's 16 keys
    const float* vst = kst + kTile;
    const int r0 = hwarp * 16;  // the warp's first box row
    const int key0 = t0 + (first + kHalves * li + half) * kTile + r0;

    // S = Q K^T: 16 heads x this warp's 16 key slots (n-block nb: slots 8 nb + g).
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      uint32_t kw[G::kKWords];
      load_k<D, kInt4>(kw, kbox, r0 + key_row<G::kBW>(nb * 8 + g), t);
#pragma unroll
      for (int wi = 0; wi < G::kKWords; ++wi) {
        if constexpr (kInt4) {
          mma_q(sc[nb], s.qf[wi][lane], i4s::nibbles_to_bf16x2<false>(kw[wi]),
                i4s::nibbles_to_bf16x2<false>(kw[wi] >> 8));
          mma_q(sc[nb], s.qf[G::kKWords + wi][lane], i4s::nibbles_to_bf16x2<false>(kw[wi] >> 4),
                i4s::nibbles_to_bf16x2<false>(kw[wi] >> 12));
        } else {
          mma_q(sc[nb], s.qf[wi][lane], i4s::int8_to_bf16x2(kw[wi]), i4s::int8_to_bf16x2(kw[wi] >> 8));
        }
      }
    }

    // The scores: x ks x log2 e on the keys in [lo, hi), -inf elsewhere (a
    // stale key's scale is never multiplied).
    float mx0 = kNegBig, mx1 = kNegBig;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kr = key_row<G::kBW>(nb * 8 + t * 2 + (c & 1));  // the slot's box row in the warp's 16
        const int kpos = key0 + kr;
        const float x = kpos >= lo && kpos < hi ? sc[nb][c] * kst[kr] * kLog2e : -INFINITY;
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

    // O += bf16(P * vs) V over this warp's 16 key slots: slot 2t + e is box
    // row vr[e]; a key outside [lo, hi) has p = 0 and its scale replaced by 0
    // (0 * NaN would be NaN), its integers are finite.
    int vr[4];
    float vsc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      vr[i] = key_row<G::kBW>(2 * t + (i & 1) + 8 * (i >> 1));  // slots 2t, 2t + 1, 2t + 8, 2t + 9
      const int kpos = key0 + vr[i];
      vsc[i] = kpos >= lo && kpos < hi ? vst[vr[i]] : 0.f;
    }
    const uint32_t pa[4] = {pack_bf16x2(sc[0][0] * vsc[0], sc[0][1] * vsc[1]),
                            pack_bf16x2(sc[0][2] * vsc[0], sc[0][3] * vsc[1]),
                            pack_bf16x2(sc[1][0] * vsc[2], sc[1][1] * vsc[3]),
                            pack_bf16x2(sc[1][2] * vsc[2], sc[1][3] * vsc[3])};
    uint32_t vw[4][G::kVWords];
#pragma unroll
    for (int i = 0; i < 4; ++i) load_v<D, kInt4>(vw[i], vbox, r0 + vr[i], g);
    constexpr int kVBytes = G::kNB * G::kVW;  // bytes of the lane's V share of a row
#pragma unroll
    for (int i = 0; i < kVBytes; ++i) {  // byte i of the lane's V share
      const uint32_t sel = (i % 4) | ((4 + i % 4) << 8);  // byte i of the first row, of the second row
      const uint32_t x01 = i4s::prmt(vw[0][i / 4], vw[1][i / 4], sel);  // slots 2t, 2t + 1
      const uint32_t x89 = i4s::prmt(vw[2][i / 4], vw[3][i / 4], sel);  // slots 2t + 8, 2t + 9
      if constexpr (kInt4) {
        mma_bf16_16816(o[i], pa, i4s::nibbles_to_bf16x2<false>(x01), i4s::nibbles_to_bf16x2<false>(x89));
        mma_bf16_16816(o[kVBytes + i], pa, i4s::nibbles_to_bf16x2<false>(x01 >> 4),
                       i4s::nibbles_to_bf16x2<false>(x89 >> 4));
      } else {
        mma_bf16_16816(o[i], pa, i4s::int8_to_bf16x2(x01), i4s::int8_to_bf16x2(x89));
      }
    }
    half_sync(half);  // every warp of the half is done with this stage
    if (htid == 0 && li + kStages < my_tiles) issue(half, li + kStages);
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
cudaError_t launch(const void* k, const void* v, const void* ks, const void* vs, const QuantDecodeParams& p,
                   int splits, cudaStream_t stream) {
  using G = Geo<D, kInt4>;
  CUtensorMap tk, tv, tks, tvs;
  // the stored rows of each (b, KV head) plane, boxes of kBW bytes by a tile of rows
  const cuuint64_t dims[3] = {(cuuint64_t)G::kRB, (cuuint64_t)p.S, (cuuint64_t)p.B * p.Hkv};
  const cuuint64_t strides[2] = {(cuuint64_t)G::kRB, (cuuint64_t)p.S * G::kRB};
  const cuuint32_t box[3] = {(cuuint32_t)G::kBW, (cuuint32_t)kTile, 1};
  const CUtensorMapSwizzle swizzle = G::kBW == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : G::kBW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                    : CU_TENSOR_MAP_SWIZZLE_32B;
  // the scales as one run of B * Hkv * S floats, a tile a box
  const cuuint64_t sdims[1] = {(cuuint64_t)p.B * p.Hkv * p.S};
  const cuuint64_t sstrides[1] = {0};
  const cuuint32_t sbox[1] = {(cuuint32_t)kTile};
  if (!encode_tensor_map(&tk, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, k, dims, strides, box, swizzle) ||
      !encode_tensor_map(&tv, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, v, dims, strides, box, swizzle) ||
      !encode_tensor_map(&tks, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, ks, sdims, sstrides, sbox,
                         CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode_tensor_map(&tvs, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, vs, sdims, sstrides, sbox,
                         CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  constexpr int smem = sizeof(Smem<D, kInt4>) + 1024;  // + the 1024-byte alignment
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
  err = cudaLaunchKernelEx(&cfg, decode_quant_kernel<D, kInt4>, tk, tv, tks, tvs, p);
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
  if (splits < 1 || splits > kMaxSplits || Hkv < 1 || H % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int hgroups = (H / Hkv + kRows - 1) / kRows;
  const QuantDecodeParams p{static_cast<const bf16*>(q), static_cast<bf16*>(out),
                            static_cast<const int*>(kv_valid_vec), static_cast<const int*>(kv_start), B, H,
                            Hkv, S, kv_valid, window, hgroups, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128 && bits == 8) return launch<128, false>(k, v, ks, vs, p, splits, s);
  if (D == 128 && bits == 4) return launch<128, true>(k, v, ks, vs, p, splits, s);
  if (D == 64 && bits == 8) return launch<64, false>(k, v, ks, vs, p, splits, s);
  if (D == 64 && bits == 4) return launch<64, true>(k, v, ks, vs, p, splits, s);
  if (D == 256 && bits == 8) return launch<256, false>(k, v, ks, vs, p, splits, s);
  if (D == 256 && bits == 4) return launch<256, true>(k, v, ks, vs, p, splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
