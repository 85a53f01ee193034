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

#include "hopper.cuh"

namespace mllm {
namespace flash {

constexpr int kBQ = 128;     // query rows a CTA
constexpr int kBK = 128;     // keys a tile
constexpr int kStages = 2;   // bf16 K/V tiles in the ring
static_assert(kBK == 64 || kBK == 128, "wgmma n64 or n128 for S");
constexpr int kConsumers = 2;   // warpgroups of 64 query rows
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kSwz = 64;        // bf16 columns of one 128-byte swizzled box row

struct FlashParams {
  bf16* o;                  // [B, Sq, H, D]
  const int* kv_valid_vec;  // [B], or null: every sequence has kv_valid
  const int* kv_start;      // [B], or null: no left pad
  int B, Sq, H, Hkv, Skv;
  int q_offset, kv_valid, causal, window;
  int n_qtiles;
  float scale_log2;  // the factor of the f32 scores: scale * log2(e), or 1 for a pre-scaled q
  const int* q_offset_dev;  // a device int32 read in place of q_offset, or null
};

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
};

__device__ __forceinline__ CtaTiles cta_tiles(const FlashParams& p) {
  CtaTiles c;
  // The heaviest q-tiles first: every head's last tile, then the one before.
  const int per_tile = p.H * p.B;
  const int qt = p.n_qtiles - 1 - blockIdx.x / per_tile;
  c.h = blockIdx.x % p.H;
  c.b = (blockIdx.x / p.H) % p.B;
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
  c.kb0 = (c.lo / kBK) * kBK;
  c.ntiles = c.hi > c.lo ? (c.hi - c.kb0 + kBK - 1) / kBK : 0;
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

// S = Q K^T for tile `it`: this warpgroup's 64 rows x kBK keys, over D in
// k-steps of 16 (both operands K-major, 128-byte swizzled).
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[kBK / 2], const bf16* sQ, const bf16* sK, int it,
                                         int wg) {
  constexpr int kDH = D / kSwz;
  const bf16* kt = sK + (it % kStages) * kDH * kBK * kSwz;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int j = kk / 4, w = kk % 4;  // 64-column box, 16-column step inside it
    const uint64_t da = wgmma_desc(sQ + (j * kBQ + wg * 64) * kSwz + w * 16, 16, 1024);
    const uint64_t db = wgmma_desc(kt + j * kBK * kSwz + w * 16, 16, 1024);
    wgmma_ss(s, da, db, kk > 0);
  }
  wgmma_commit();
}

// O += P V for tile `it`: V is [keys][64-column boxes], MN-major for wgmma
// (transpose bit); LBO steps between the boxes, SBO between 8-key groups.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pf)[kBK / 16][4],
                                         const bf16* sV, int it) {
  constexpr int kDH = D / kSwz;
  const bf16* vt = sV + (it % kStages) * kDH * kBK * kSwz;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    wgmma_rs(o, pf[kk], wgmma_desc(vt + kk * 16 * kSwz, kBK * kSwz * 2, 1024));
  wgmma_commit();
}

// The online softmax of one tile in base 2 (x = s * scale_log2): masks the
// keys a row does not see (only on tiles that cut a row's range; s[i] is key
// kb + 8 (i / 4) + (i & 1), kb including this thread's 2 t), leaves the
// probabilities in s, updates the statistics and returns the factors (a0,
// a1) for O. Masked probabilities are exact zeros: exp2(-inf) = 0.
__device__ __forceinline__ void online_softmax(float (&s)[kBK / 2], int kb, const RowKeys& rk,
                                               float scale_log2, RowStats& st, float& a0, float& a1) {
  if (!(kb >= rk.klo0 && kb >= rk.klo1 && kb + kBK - 7 < rk.khi0 && kb + kBK - 7 < rk.khi1)) {
    const int lo0 = rk.klo0 - kb, hi0 = rk.khi0 - kb, lo1 = rk.klo1 - kb, hi1 = rk.khi1 - kb;
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      const int c = (i / 4) * 8 + (i & 1);
      const bool ok = (i & 2) ? (c >= lo1 && c < hi1) : (c >= lo0 && c < hi0);
      if (!ok) s[i] = -INFINITY;
    }
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) {
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
  for (int i = 0; i < kBK / 2; ++i) {
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
__device__ __forceinline__ void pack_p(const float (&s)[kBK / 2], uint32_t (&pf)[kBK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    pf[kk][0] = pack_bf16x2(s[8 * kk + 0], s[8 * kk + 1]);
    pf[kk][1] = pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
    pf[kk][2] = pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
    pf[kk][3] = pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// One consumer warpgroup (wg 0 or 1, 128 threads; tid the CTA's thread index)
// from Q's arrival to its rows of the output. `tiles` supplies `wait_k`,
// `release_k`, `wait_v`, `release_v` (above) and `prepare_q(sQ, wg, wtid)`
// (called by every thread of the warpgroup once Q has landed, before its
// first product).
template <int D, class Tiles>
__device__ __forceinline__ void consume(const FlashParams& p, const CtaTiles& c, bf16* sQ, const bf16* sK,
                                        const bf16* sV, uint64_t* qbar, const Tiles& tiles, int wg,
                                        int tid) {
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
  const int it_a = min(ntiles, max(0, (wlo - kb0) / kBK));
  const int it_b = max(it_a, min(ntiles, (whi - kb0 + kBK - 1) / kBK));

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  RowStats st{kNegBig, kNegBig, 0.f, 0.f};

  // Per tile: S, softmax, P V. The two warpgroups issue their products in
  // turns, so one's softmax runs while the other's products hold the tensor
  // cores. (Issuing S of the next tile beside P V of this one needs S, P and
  // O live at once, ~180 registers: under the 168 that 384 threads leave,
  // ptxas spilled it and the main row ran 30 % slower; PERF.md.)
  if (ntiles > 0) {
    mbar_wait(qbar, 0);
    tiles.prepare_q(sQ, wg, wtid);
    if (wg == 1) pass_turn(wg);  // warpgroup 0 issues first
    auto skip_tile = [&](int it) {
      tiles.wait_k(it);
      wait_turn(wg);
      pass_turn(wg);
      tiles.release_k(it);
      tiles.wait_v(it);
      wait_turn(wg);
      pass_turn(wg);
      tiles.release_v(it);
    };
    for (int it = 0; it < it_a; ++it) skip_tile(it);
    for (int it = it_a; it < it_b; ++it) {
      float s[kBK / 2];
      uint32_t pf[kBK / 16][4];
      float a0, a1;
      tiles.wait_k(it);
      wait_turn(wg);
      wgmma_fence();
      issue_qk<D>(s, sQ, sK, it, wg);
      pass_turn(wg);
      wgmma_wait<0>();
      wgmma_fence_operands(s);
      tiles.release_k(it);
      online_softmax(s, kb0 + it * kBK + 2 * t, rows, p.scale_log2, st, a0, a1);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? a1 : a0;
      pack_p(s, pf);
      tiles.wait_v(it);
      wait_turn(wg);
      wgmma_fence();
      issue_pv<D>(o, pf, sV, it);
      pass_turn(wg);
      wgmma_wait<0>();
      wgmma_fence_operands(o);
      tiles.release_v(it);
    }
    for (int it = it_b; it < ntiles; ++it) skip_tile(it);
    if (wg == 0) wait_turn(wg);  // the turn warpgroup 1 passed last has no taker
  }

  const float l0 = quad_sum(st.l0), l1 = quad_sum(st.l1);
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

// Launches `kernel(args...)` over one CTA a (b, head, q-tile) of `p`, as
// clusters of one CTA:
// at the main row (B=1, Sq=1536) the plain launch's time was bimodal (27.3 or
// 28.4 us between launches of one process), the cluster launch's steady at
// the lower mode (PERF.md).
template <class Kernel, class... Args>
cudaError_t launch_flash(Kernel kernel, const FlashParams& p, int smem, cudaStream_t stream, const Args&... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.n_qtiles * p.H * p.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace flash
}  // namespace mllm
