// Prefill attention (flash) over the int8 or packed-int4 KV cache for Hopper,
// bf16 query and output, f32 statistics.
//
// Replaces: mllm_tpu/ops/flash_attention.py, `flash_attention_quant`
//   (Pallas kernel `_flash_kernel_q8`, int8 and `bits4`, with `_attn_tile`).
//
// What it computes: out[b, s, h] = softmax2(qt[b, s, h] . K^T) V over the keys j
//   kv_start[b] <= j < kv_valid   and, when causal, j <= q_pos, j > q_pos - window
// (q_pos = q_offset + s), at the Pallas kernel's rounding points:
//   qt   = bf16(f32(q) * q_scale),  q_scale = f32(bf16(scale * log2 e))
//          (the Pallas wrapper pre-scales q in its dtype);
//   K[j] = bf16(f32(Kq[j]) * ks[j]),  V[j] = bf16(f32(Vq[j]) * vs[j]),
//          Kq the int8 row or the planar nibble pair - 8;
// softmax2 the base-2 softmax, probabilities rounded to bf16 before P V, f32
// sums. A row with no visible key is zeros.
//
// What bounds it on this card: as the bf16 flash kernel, a causal prefill of S
// tokens does ~2 * S^2 * D FLOPs a head against O(S * D) bytes, so beyond a
// few hundred tokens it is bound by matrix math, reached only through wgmma
// fed from shared memory while the next tiles load; the int8 (int4) cache
// halves (quarters) the K/V bytes, which matters for short chunks over a long
// cache. wgmma reads bf16 operands from shared memory, so every key tile has
// to become bf16 there once per CTA: 32 K elements of K and V at D = 128, a
// few instructions each. Done by the whole block between its products (the
// first design: stage by cp.async, wait, convert, barrier, compute, on
// mma.sync), loads, conversion and math never overlapped: 6.4 % of its bound
// at the main row. Done by other warps a tile ahead, the conversion's issue
// still slows the consumers' softmax on the same schedulers: the kernel runs
// at ~1.4x the bf16 kernel on the same keys (NVIDIA H100 80GB HBM3, 700 W;
// PERF.md, tools/attention_tune.py --kernel flash_quant).
//
// What the design does about it: the consumer warpgroups of the bf16 kernel,
// unchanged (flash_attention.cuh: wgmma m64n128k16 in turns, online softmax,
// heaviest q-tiles first), fed by a producer warpgroup that both loads and
// converts, one or more tiles ahead of the products:
//  - Loading: one thread issues Q (a TMA box per 64 columns, 128-byte
//    swizzled) and, per raw stage, the stored rows of one tile's K or V as a
//    TMA box (a 3-D map over the [B * Hkv, Skv] rows of DS = D (int8) or D / 2
//    (int4) bytes, no swizzle; rows past the cache load as zeros) and their
//    scales as another (a 1-D map over all B * Hkv * Skv of them), both
//    completed on the stage's mbarrier. A raw stage holds one matrix of a
//    tile, so three fit at int8, D = 128 (a tile and a half in flight; a
//    stage of K and V together fits once) and four elsewhere (`Geo`). The
//    scales came first by 4-byte cp.async from the producer threads: their
//    issue on the converters' path cost ~8 % of the main row (PERF.md).
//  - Converting: the 128 producer threads write each matrix of a tile as
//    bf16 straight into the 128-byte-swizzled [kDH][kBK][64] stage that the
//    consumers' wgmma reads, an 8-byte unit a step, a batch of kBatch loads
//    before their conversions, interior stages without the range test: the
//    integers to exact bf16 by the prmt / lop3 tricks of int4_stream.cuh (no
//    I2F; each mask-and-or one lop3), to f32, times the key's scale, packed
//    by cvt.rn.bf16x2.f32. Units are dealt so that a quarter warp's 16-byte
//    stores hit eight distinct chunks of the swizzle and a half warp's raw
//    loads 128 contiguous bytes (no bank conflicts). Rows outside [lo, hi)
//    are written as zeros whatever their integers and scales hold (a stale
//    scale may be NaN or inf, and 0 * NaN in P V is NaN). Then
//    fence.proxy.async and one arrival a warp on the stage's full barrier
//    of that matrix.
//  - K and V of a ring stage are filled and released each on its own
//    (`Ring`): K of tile it is converted once both warpgroups have S of tile
//    it - 2, V once they have P V of it; one arrival a warp.
//  - q's pre-scale is folded in: once Q has landed each consumer warpgroup
//    rescales its own 64 rows in shared memory before its first product, and
//    the softmax runs with scale_log2 = 1. One launch a call.
//  - setmaxnreg: the producer warpgroup keeps kProducerRegs registers, the
//    consumers take kConsumerRegs (128 * 72 + 256 * 216 = 384 * 168, the
//    registers the CTA holds at launch; ptxas compiles every thread's code in
//    the 168 that 384 threads leave, and no split measured faster).
#include "flash_attention.cuh"

namespace mllm {
namespace {

using namespace flash;

// kRawRows, kRawStages, kBatch and the register split: measured
// against other values with tools/attention_tune.py --kernel flash_quant (PERF.md)
constexpr int kRawRows = 128;       // keys of K (or of V) a raw stage holds: a tile's K is kBK / kRawRows of them
constexpr int kRawStages = 4;       // raw stages in the ring, where they fit (Geo::kRaw)
constexpr int kBatch = 8;           // 8-byte units a converter loads before it converts them
constexpr int kProducerRegs = 72;   // setmaxnreg of the loading and converting warpgroup
constexpr int kConsumerRegs = 216;  // and of each consumer warpgroup
constexpr int kProducerThreads = 128;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may have (H100)
// The registers a thread holds at launch: 384 threads share the 65,536 of an
// SM in steps of 8. setmaxnreg moves registers within the CTA's own pool, so
// an increase that the decreases do not cover waits forever.
constexpr int kLaunchRegs = (65536 / kThreads) / 8 * 8;
static_assert(kProducerThreads * kProducerRegs + kConsumers * 128 * kConsumerRegs <= kThreads * kLaunchRegs,
              "the register split must fit the registers the CTA holds at launch");
static_assert(kBK % kRawRows == 0, "a tile's K (V) is whole raw stages");

// The shared-memory plan of one (D, bits) instance: Q and the bf16 ring of
// flash_attention.cuh, then kRaw raw stages (the stored rows of kRawRows keys
// of K or of V, and their scales), then the mbarriers; 1024 bytes of slack
// align the swizzled boxes.
template <int D, bool kInt4>
struct Geo {
  static constexpr int kDS = kInt4 ? D / 2 : D;   // bytes of a stored row
  static constexpr int kUnits = kDS / 8;          // 8-byte units of a stored row
  static constexpr int kRowStep = kProducerThreads / kUnits;  // rows apart of a converter's units
  static constexpr int kRawRowsBytes = kRawRows * kDS;
  static constexpr int kRawStage = kRawRowsBytes + kRawRows * 4;
  static constexpr int kParts = kBK / kRawRows;  // raw stages of a tile's K (or V)
  static constexpr int kBars = 8 * (1 + 4 * kStages + kRawStages);
  static constexpr int bytes(int raw) { return 1024 + (kBQ + 2 * kStages * kBK) * D * 2 + raw * kRawStage + kBars; }
  static constexpr int fit(int raw) { return raw <= 1 || bytes(raw) <= kSmemLimit ? raw : fit(raw - 1); }
  static constexpr int kRaw = fit(kRawStages);
  static constexpr int kSmem = bytes(kRaw);
  static_assert(kSmem <= kSmemLimit, "shared memory of a block");
  static_assert(kRawRowsBytes % 1024 == 0 && kRawStage % 128 == 0, "TMA destinations stay 128-byte aligned");
  static_assert(kRowStep % 8 == 0 && kRawRows % kRowStep == 0, "a converter's rows share their swizzle");
};

// bf16x2 -> bf16x2 of each times s, the product rounded to f32 and then to
// bf16 (bf16 to f32 is a shift of the bits).
__device__ __forceinline__ uint32_t times_scale(uint32_t x, float s) {
  return pack_bf16x2(__uint_as_float(x << 16) * s, __uint_as_float(x & 0xFFFF0000u) * s);
}

// (a & mask) | bits in one lop3 (ptxas emits two when both are immediates).
__device__ __forceinline__ uint32_t and_or(uint32_t a, uint32_t mask, uint32_t bits) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(d) : "r"(a), "r"(mask), "r"(bits));
  return d;
}

__device__ __forceinline__ uint32_t sub_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// int4_stream.cuh's bit constructions, each mask-and-or one lop3: the int8
// values in bits 0-7 and 16-23 of v, bf16(0x4300 | b & 0x7f) - bf16(0x4300 |
// b & 0x80) (`int8_to_bf16x2`), and the nibbles in bits 0-3 and 16-19 minus
// 8, bf16(0x4300 | n) - 136 (`nibbles_to_bf16x2<false>`), as exact bf16x2.
__device__ __forceinline__ uint32_t int8_pair(uint32_t v) {
  return sub_bf16x2(and_or(v, 0x007F007Fu, 0x43004300u), and_or(v, 0x00800080u, 0x43004300u));
}
__device__ __forceinline__ uint32_t nibble_pair(uint32_t v) {
  return sub_bf16x2(and_or(v, 0x000F000Fu, 0x43004300u), 0x43084308u);
}

// Four stored elements, given as exact bf16x2 integers of elements (0, 2)
// and (1, 3), times s: the bf16x2 words of elements (0, 1) and (2, 3).
__device__ __forceinline__ uint2 scaled_quad(uint32_t x02, uint32_t x13, float s) {
  const float f0 = __uint_as_float(x02 << 16), f2 = __uint_as_float(x02 & 0xFFFF0000u);
  const float f1 = __uint_as_float(x13 << 16), f3 = __uint_as_float(x13 & 0xFFFF0000u);
  return make_uint2(pack_bf16x2(f0 * s, f1 * s), pack_bf16x2(f2 * s, f3 * s));
}

// The 16 bytes of bf16 that stored elements 0..7 of a unit become.
__device__ __forceinline__ uint4 scaled_chunk(uint32_t x02, uint32_t x13, uint32_t x46, uint32_t x57, float s) {
  const uint2 a = scaled_quad(x02, x13, s), b = scaled_quad(x46, x57, s);
  return make_uint4(a.x, a.y, b.x, b.y);
}

// The element offset of 16-byte chunk `chunk` (head dims 8 chunk ..) of key
// row r in a [kDH][kBK][64] stage with the 128-byte swizzle.
__device__ __forceinline__ int swizzled(int chunk, int r) {
  return ((chunk / 8) * kBK + r) * kSwz + ((chunk % 8) ^ (r % 8)) * 8;
}

// Raw stage `st` (the K or V rows of keys key0 .., rows row0 .. of the tile)
// into the bf16 stage `dst`. Producer thread p takes unit p % kUnits of the
// rows p / kUnits + kRowStep j: a warp reads whole rows, and every row a
// thread takes has the same row % 8, so its swizzled places are one offset
// apart. kEdge: the stage cuts [lo, hi), whose outside is written as zeros.
template <int D, bool kInt4, bool kEdge>
__device__ __forceinline__ void convert_part(const uint8_t* st, bf16* dst, int row0, int key0, int lo, int hi,
                                             int ptid) {
  using G = Geo<D, kInt4>;
  constexpr int U = G::kUnits, RS = G::kRowStep, kSteps = kRawRows / RS;
  constexpr int kB = kBatch < kSteps ? kBatch : kSteps;
  const int u = ptid % U, r0 = ptid / U;
  const uint8_t* src = st + r0 * G::kDS + u * 8;
  const float* sc = reinterpret_cast<const float*>(st + G::kRawRowsBytes) + r0;
  const int at_lo = swizzled(u, row0 + r0), at_hi = swizzled(D / 16 + u, row0 + r0);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int j0 = 0; j0 < kSteps; j0 += kB) {
    uint2 w[kB];
    float s[kB];
#pragma unroll
    for (int k = 0; k < kB; ++k) {  // every load of the batch first
      w[k] = *reinterpret_cast<const uint2*>(src + (j0 + k) * RS * G::kDS);
      s[k] = sc[(j0 + k) * RS];
    }
#pragma unroll
    for (int k = 0; k < kB; ++k) {
      const int step = (j0 + k) * RS * kSwz;  // element offset of the row from row0 + r0
      const int key = key0 + r0 + (j0 + k) * RS;
      const bool ok = !kEdge || (key >= lo && key < hi);
      if constexpr (!kInt4) {
        const uint4 c = scaled_chunk(int8_pair(w[k].x), int8_pair(w[k].x >> 8), int8_pair(w[k].y),
                                     int8_pair(w[k].y >> 8), s[k]);
        *reinterpret_cast<uint4*>(dst + at_lo + step) = ok ? c : zero;
      } else {
        // byte e of the unit holds head dim 8u + e (low nibble) and D/2 + 8u + e (high)
        const uint4 lo_c = scaled_chunk(nibble_pair(w[k].x), nibble_pair(w[k].x >> 8), nibble_pair(w[k].y),
                                        nibble_pair(w[k].y >> 8), s[k]);
        const uint4 hi_c = scaled_chunk(nibble_pair(w[k].x >> 4), nibble_pair(w[k].x >> 12),
                                        nibble_pair(w[k].y >> 4), nibble_pair(w[k].y >> 12), s[k]);
        // Odd rows store their high chunk first: at D = 64 a quarter warp
        // holds two rows, and the two orders put its stores in distinct chunks.
        const bool odd = r0 & 1;
        *reinterpret_cast<uint4*>(dst + (odd ? at_hi : at_lo) + step) = ok ? (odd ? hi_c : lo_c) : zero;
        *reinterpret_cast<uint4*>(dst + (odd ? at_lo : at_hi) + step) = ok ? (odd ? lo_c : hi_c) : zero;
      }
    }
  }
}

// The bf16 ring's barriers: K and V of a stage are filled and released each
// on its own, so the converters may write K of tile it as soon as both
// warpgroups have S of tile it - kStages, long before their P V is done. One
// arrival a warp.
struct Ring {
  uint64_t* full_k;   // [kStages], kProducerThreads / 32 arrivals
  uint64_t* full_v;
  uint64_t* empty_k;  // [kStages], kConsumers * 4 arrivals
  uint64_t* empty_v;
};

// The producer warpgroup (ptid = its thread, 0..127): thread 0 issues Q and
// every raw stage's two TMA loads (rows and scales); all convert a share of
// each stage. Part q of the stream is part h of matrix m (K, then V) of tile
// it, for q = (2 it + m) kParts + h; it goes through raw slot q % kRaw, and
// tile it into bf16 stage it % kStages.
template <int D, bool kInt4>
__device__ __forceinline__ void produce(const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                        const CUtensorMap* tm_ks, const CUtensorMap* tm_vs, const FlashParams& p,
                                        const CtaTiles& c, bf16* sQ,
                                        bf16* sK, bf16* sV, uint8_t* raw, uint64_t* qbar, const Ring& ring,
                                        uint64_t* raw_full, int ptid) {
  using G = Geo<D, kInt4>;
  constexpr int R = G::kRaw, H = G::kParts, kDH = D / kSwz;
  const int plane = c.b * p.Hkv + c.hk;  // the (b, KV head) rows of K and V
  const int parts = c.ntiles * 2 * H;
  // Part q's loads, by thread 0: the rows and their scales, a TMA box each,
  // completed on the slot's barrier.
  auto issue = [&](int q) {
    uint8_t* st = raw + (q % R) * G::kRawStage;
    uint64_t* bar = &raw_full[q % R];
    const int m = (q / H) % 2, key0 = c.kb0 + (q / (2 * H)) * kBK + (q % H) * kRawRows;
    mbar_arrive_expect_tx(bar, G::kRawStage);
    tma_load_3d(st, m ? tm_v : tm_k, bar, 0, key0, plane);
    tma_load_1d(st + G::kRawRowsBytes, m ? tm_vs : tm_ks, bar, plane * p.Skv + key0);
  };

  if (ptid == 0) {
    mbar_arrive_expect_tx(qbar, kBQ * D * 2);
#pragma unroll
    for (int j = 0; j < kDH; ++j) tma_load_4d(sQ + j * kBQ * kSwz, tm_q, qbar, j * kSwz, c.h, c.q0, c.b);
  }
  if (ptid == 0)
    for (int q = 0; q < min(R, parts); ++q) issue(q);
  for (int it = 0; it < c.ntiles; ++it) {
    const int bs = it % kStages;
#pragma unroll 1
    for (int m = 0; m < 2; ++m) {
      bf16* dst = (m ? sV : sK) + bs * kBK * D;
      if (it >= kStages) mbar_wait(&(m ? ring.empty_v : ring.empty_k)[bs], (it / kStages - 1) & 1);
#pragma unroll 1
      for (int h = 0; h < H; ++h) {
        const int q = (2 * it + m) * H + h, key0 = c.kb0 + it * kBK + h * kRawRows;
        const uint8_t* st = raw + (q % R) * G::kRawStage;
        mbar_wait(&raw_full[q % R], (q / R) & 1);
        if (key0 >= c.lo && key0 + kRawRows <= c.hi)
          convert_part<D, kInt4, false>(st, dst, h * kRawRows, key0, c.lo, c.hi, ptid);
        else
          convert_part<D, kInt4, true>(st, dst, h * kRawRows, key0, c.lo, c.hi, ptid);
        if (h == H - 1) {
          fence_proxy_async();  // this thread's bf16 K (V) reaches wgmma's (async-proxy) reads
          __syncwarp();
          if (ptid % 32 == 0) mbar_arrive(&(m ? ring.full_v : ring.full_k)[bs]);  // one arrival a warp
        }
        if (q + R < parts) {
          named_barrier_sync(kBarTile, kProducerThreads);  // every converter is done with the slot
          if (ptid == 0) issue(q + R);
        }
      }
    }
  }
}

// The bf16 ring as the consumers see it: the converters' 128 arrivals make K
// (V) of tile `it` ready. prepare_q turns this warpgroup's rows of Q into
// bf16(f32(q) * q_scale) in place.
template <int D>
struct QuantTiles {
  Ring ring;
  float q_scale;
  bool lane0;  // this thread arrives for its warp (whose wgmma reads are done when any lane's are)

  __device__ __forceinline__ void wait_k(int it) const { mbar_wait(&ring.full_k[it % kStages], (it / kStages) & 1); }
  __device__ __forceinline__ void release_k(int it) const {
    if (lane0) mbar_arrive(&ring.empty_k[it % kStages]);
  }
  __device__ __forceinline__ void wait_v(int it) const { mbar_wait(&ring.full_v[it % kStages], (it / kStages) & 1); }
  __device__ __forceinline__ void release_v(int it) const {
    if (lane0) mbar_arrive(&ring.empty_v[it % kStages]);
  }
  __device__ __forceinline__ void prepare_q(bf16* sQ, int wg, int wtid) const {
#pragma unroll
    for (int j = 0; j < D / kSwz; ++j) {
      uint4* rows = reinterpret_cast<uint4*>(sQ + (j * kBQ + wg * 64) * kSwz);  // 64 rows of 128 bytes
#pragma unroll
      for (int i = wtid; i < 64 * 8; i += 128) {
        uint4 x = rows[i];
        x = make_uint4(times_scale(x.x, q_scale), times_scale(x.y, q_scale), times_scale(x.z, q_scale),
                       times_scale(x.w, q_scale));
        rows[i] = x;
      }
    }
    fence_proxy_async();  // the scaled rows reach wgmma's (async-proxy) reads
    named_barrier_sync(kBarQ + wg, 128);
  }
};

template <int D, bool kInt4>
__global__ void __launch_bounds__(kThreads, 1)
    flash_quant_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_ks,
                       const __grid_constant__ CUtensorMap tm_vs, const float q_scale, const FlashParams p) {
  using G = Geo<D, kInt4>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows of 128 bytes
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* sQ = reinterpret_cast<bf16*>(base);                     // [kDH][kBQ][64]
  bf16* sK = sQ + kBQ * D;                                      // [kStages][kDH][kBK][64]
  bf16* sV = sK + kStages * kBK * D;                            // [kStages][kDH][kBK][64]
  uint8_t* raw = reinterpret_cast<uint8_t*>(sV + kStages * kBK * D);  // [kRaw][rows | scales]
  uint64_t* qbar = reinterpret_cast<uint64_t*>(raw + G::kRaw * G::kRawStage);
  const Ring ring{qbar + 1, qbar + 1 + kStages, qbar + 1 + 2 * kStages, qbar + 1 + 3 * kStages};
  uint64_t* raw_full = qbar + 1 + 4 * kStages;

  const CtaTiles c = cta_tiles(p);
  const int tid = threadIdx.x;
  if (tid == kConsumers * 128) {  // the descriptors' first fetch overlaps the set-up
    tma_prefetch(&tm_q);
    tma_prefetch(&tm_k);
    tma_prefetch(&tm_v);
    tma_prefetch(&tm_ks);
    tma_prefetch(&tm_vs);
  }
  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&ring.full_k[i], kProducerThreads / 32);
      mbar_init(&ring.full_v[i], kProducerThreads / 32);
      mbar_init(&ring.empty_k[i], kConsumers * 4);
      mbar_init(&ring.empty_v[i], kConsumers * 4);
    }
    for (int i = 0; i < G::kRaw; ++i) mbar_init(&raw_full[i], 1);
    fence_mbar_init();
  }
  __syncthreads();

  // The warpgroup index, provably uniform across each warp (ptxas applies
  // setmaxnreg only to branches it can prove warpgroup-uniform).
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == kConsumers) {
    if constexpr (kProducerRegs < kLaunchRegs) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (c.ntiles > 0)
      produce<D, kInt4>(&tm_q, &tm_k, &tm_v, &tm_ks, &tm_vs, p, c, sQ, sK, sV, raw, qbar, ring, raw_full,
                        tid - kConsumers * 128);
  } else {
    if constexpr (kConsumerRegs > kLaunchRegs) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
    const QuantTiles<D> tiles{ring, q_scale, (tid & 31) == 0};
    consume<D>(p, c, sQ, sK, sV, qbar, tiles, wg, tid);
  }
}

template <int D, bool kInt4>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ks, const void* vs, float q_scale,
                   const FlashParams& p, cudaStream_t stream) {
  using G = Geo<D, kInt4>;
  CUtensorMap tq, tk, tv, tks, tvs;
  // the stored rows of each (b, KV head), DS bytes each; rows past the cache load as zeros
  const cuuint64_t dims[3] = {(cuuint64_t)G::kDS, (cuuint64_t)p.Skv, (cuuint64_t)p.B * p.Hkv};
  const cuuint64_t strides[2] = {(cuuint64_t)G::kDS, (cuuint64_t)p.Skv * G::kDS};
  const cuuint32_t box[3] = {(cuuint32_t)G::kDS, kRawRows, 1};
  // the scales as one run of B * Hkv * Skv floats, kRawRows a box (a 1-D map
  // puts no alignment on where a box starts)
  const cuuint64_t sdims[1] = {(cuuint64_t)p.B * p.Hkv * p.Skv};
  const cuuint64_t sstrides[1] = {0};
  const cuuint32_t sbox[1] = {kRawRows};
  if (!encode_q_map(&tq, q, p.B, p.Sq, p.H, D) ||
      !encode_tensor_map(&tk, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, k, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode_tensor_map(&tv, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, v, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode_tensor_map(&tks, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, ks, sdims, sstrides, sbox,
                         CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode_tensor_map(&tvs, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, vs, sdims, sstrides, sbox,
                         CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  return launch_flash(flash_quant_kernel<D, kInt4>, p, G::kSmem, stream, tq, tk, tv, tks, tvs, q_scale, p);
}

}  // namespace
}  // namespace mllm

// Returns the CUDA error code of the launch (0 on success). q is the raw
// query; q_scale = f32(bf16(scale * log2 e)), by which the kernel pre-scales
// it in bf16; bits is 8 (int8 K/V [B, Hkv, Skv, D]) or 4 (packed uint8
// [B, Hkv, Skv, D/2]); kv_start may be null. kv_valid_vec (device int32 [B])
// and q_offset_dev (a device int32) are read in place of kv_valid and
// q_offset when they are not null (a captured loop's write head): the grid,
// the tensor maps and every other argument stay what they are. The kernel
// does not synchronise.
extern "C" int mllm_flash_attention_quant(const void* q, const void* k, const void* v,
                                          const void* ks, const void* vs, void* out,
                                          const void* kv_start, const void* kv_valid_vec,
                                          const void* q_offset_dev, int B, int Sq, int H, int Hkv,
                                          int Skv, int D, int bits, int q_offset, int kv_valid,
                                          int causal, int window, float q_scale, void* stream) {
  using namespace mllm;
  using namespace mllm::flash;
  if (Hkv < 1 || H % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const FlashParams p{static_cast<bf16*>(out), static_cast<const int*>(kv_valid_vec),
                      static_cast<const int*>(kv_start), B, Sq, H, Hkv, Skv, q_offset, kv_valid, causal,
                      window, (Sq + kBQ - 1) / kBQ, 1.f, static_cast<const int*>(q_offset_dev)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128 && bits == 8) return launch<128, false>(q, k, v, ks, vs, q_scale, p, s);
  if (D == 128 && bits == 4) return launch<128, true>(q, k, v, ks, vs, q_scale, p, s);
  if (D == 64 && bits == 8) return launch<64, false>(q, k, v, ks, vs, q_scale, p, s);
  if (D == 64 && bits == 4) return launch<64, true>(q, k, v, ks, vs, q_scale, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
