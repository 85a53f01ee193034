// Prefill attention (flash) for Hopper, bf16 in and out, f32 statistics.
//
// Replaces: mllm_tpu/ops/flash_attention.py, `flash_attention`
//   (Pallas kernel `_flash_kernel`, with `_attn_tile` and `_tile_run_predicate`).
//
// What it computes: out[b, s, h] = softmax(q[b, s, h] . K[b, h // n_rep]^T * scale) V
// over the keys j that satisfy
//   kv_start[b] <= j < kv_valid[b]                      (left pad, cache fill)
//   and, when causal, j <= q_pos and j > q_pos - window  (q_pos = q_offset + s).
// Rows with no valid key are written as zeros; masked probabilities are exact
// zeros, so stale or padded K/V never reach a valid row.
//
// What bounds it on this card: a causal prefill of S tokens does about
// 2 * S^2 * D FLOPs per head (two products, half the square) against
// O(S * D) bytes per head, so beyond a few hundred tokens it is bound by
// matrix math, and the tensor cores reach their rate only through wgmma fed
// from shared memory while the next tiles load.
//
// What the design does about it (warp-specialised, TMA + wgmma):
//  - A CTA owns 128 query rows of one (b, head): two consumer warpgroups of 64
//    rows each and a producer warpgroup whose one thread issues every load;
//    setmaxnreg moves registers from the producer (24) to the consumers (240).
//    The consumers issue their products in turns (ping-pong on named
//    barriers), so one warpgroup's softmax overlaps the other's products.
//  - Loads are TMA boxes of 64 head-dim columns (128 bytes, the 128-byte
//    swizzle wgmma reads): Q once, then K/V tiles of 128 keys into a ring of
//    two stages with full / empty mbarriers. Only the tiles in [lo, hi) that
//    some row of the CTA can see are loaded, and a warpgroup issues no
//    product for a tile none of its rows sees (a sliding window's far
//    tiles). The tensor maps are encoded on the host for each call
//    (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPointByVersion:
//    nothing links libcuda), prefetched by the producer and passed as
//    __grid_constant__ parameters; q's map follows its [B, Sq, H, D] strides.
//    Tile, stage and ordering choices: PERF.md (tools/attention_tune.py).
//  - S = Q K^T is wgmma m64n128k16 with both operands in shared memory (K-major)
//    and f32 accumulators; P is rounded to bf16 in registers (the rounding
//    point of flash_attention_ref) and O += P V takes it as the register A
//    operand, with V read MN-major through the transpose bit.
//  - TMA copies a tile as it lies in the cache, so rows outside
//    [kv_start, kv_valid) may hold a NaN or inf from an earlier request; the
//    masked score keeps K out. V rows past a batch-wide kv_valid lie outside
//    the tensor map (TMA writes zeros); on the other boundary tiles the
//    consumers zero the stale V rows in shared memory before P V (0 * NaN
//    would be NaN).
//  - Causal balance: the grid runs the last (heaviest) q-tiles of every head
//    first: blockIdx.x 0 is the last tile of head 0.
//  - Online softmax in f32, base 2, scale * log2(e) folded into the f32
//    scores; GQA by index (h -> h / n_rep).
#include "hopper.cuh"

namespace mllm {
namespace {

// kBK and kStages: measured against other values with
// tools/attention_tune.py (PERF.md)
constexpr int kBQ = 128;     // query rows a CTA
constexpr int kBK = 128;     // keys a tile
constexpr int kStages = 2;   // K/V tiles in flight
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
  float scale_log2;  // scale * log2(e)
};

__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_barrier_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// Named barriers: 1 for the stale-row zeroing, 2 + wg for warpgroup wg's turn
// to issue its products. The two consumer warpgroups take turns (ping-pong),
// so one's softmax runs while the other's products hold the tensor cores.
constexpr int kBarZero = 1, kBarTurn = 2;
__device__ __forceinline__ void wait_turn(int wg) { named_barrier_sync(kBarTurn + wg, kConsumers * 128); }
__device__ __forceinline__ void pass_turn(int wg) {
  named_barrier_arrive(kBarTurn + (wg ^ 1), kConsumers * 128);
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

// Waits for tile `it`; on a tile that cuts [kv_start, kv_valid), the two
// consumer warpgroups turn its stale V rows into zeros (0 * NaN would be NaN
// in P V), each a share of the rows, then meet. With one kv_valid for the
// batch (`tma_bounded`) the tensor map ends at it, so TMA itself writes
// zeros past it and only rows before kv_start need the pass.
template <int D>
__device__ __forceinline__ void wait_tile(int it, int kb0, bf16* sV, uint64_t* full, int kv_start,
                                          int kv_valid, bool tma_bounded, int tid) {
  constexpr int kDH = D / kSwz;
  const int stage = it % kStages, kb = kb0 + it * kBK;
  mbar_wait(&full[stage], (it / kStages) & 1);
  if (kb < kv_start || (!tma_bounded && kb + kBK > kv_valid)) {
    bf16* vt = sV + stage * kDH * kBK * kSwz;
    for (int i = tid; i < kBK * kDH * 8; i += kConsumers * 128) {
      const int r = i / (kDH * 8), c = i % (kDH * 8);  // key row, 16-byte chunk
      const int key = kb + r;
      if (key < kv_start || key >= kv_valid)
        *reinterpret_cast<uint4*>(vt + ((c / 8) * kBK + r) * kSwz + (c % 8) * 8) = make_uint4(0, 0, 0, 0);
    }
    fence_proxy_async();  // the zeros reach wgmma's (async-proxy) reads
    named_barrier_sync(kBarZero, kConsumers * 128);
  }
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

// P as bf16 A fragments (the rounding point of flash_attention_ref):
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

template <int D>
constexpr int smem_bytes() {
  return (kBQ + 2 * kStages * kBK) * D * 2 + 1024 /* alignment */ + 8 * (1 + 2 * kStages);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const FlashParams p) {
  constexpr int kDH = D / kSwz;  // 64-column boxes of a row
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows of 128 bytes
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* sQ = reinterpret_cast<bf16*>(base);  // [kDH][kBQ][64]
  bf16* sK = sQ + kBQ * D;                   // [kStages][kDH][kBK][64]
  bf16* sV = sK + kStages * kBK * D;         // [kStages][kDH][kBK][64]
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sV + kStages * kBK * D);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + kStages;

  // The heaviest q-tiles first: every head's last tile, then the one before.
  const int per_tile = p.H * p.B;
  const int qt = p.n_qtiles - 1 - blockIdx.x / per_tile;
  const int h = blockIdx.x % p.H, b = (blockIdx.x / p.H) % p.B;
  const int q0 = qt * kBQ;
  const int hk = h / (p.H / p.Hkv);

  // Keys [lo, hi) hold every key that any row of this CTA may see.
  const int kv_valid = min(p.kv_valid_vec ? p.kv_valid_vec[b] : p.kv_valid, p.Skv);
  const int kv_start = max(p.kv_start ? p.kv_start[b] : 0, 0);
  int lo = kv_start, hi = kv_valid;
  if (p.causal) {
    hi = min(hi, p.q_offset + min(q0 + kBQ, p.Sq));
    if (p.window > 0) lo = max(lo, p.q_offset + q0 - p.window + 1);
  }
  const int kb0 = (lo / kBK) * kBK;
  const int ntiles = hi > lo ? (hi - kb0 + kBK - 1) / kBK : 0;

  const int tid = threadIdx.x;
  if (tid == kConsumers * 128) {  // the descriptors' first fetch overlaps the set-up
    tma_prefetch(&tm_q);
    tma_prefetch(&tm_k);
    tma_prefetch(&tm_v);
  }
  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers * 128);
    }
    fence_mbar_init();
  }
  __syncthreads();

  // The warpgroup index, provably uniform across each warp (ptxas applies
  // setmaxnreg only to branches it can prove warpgroup-uniform).
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == kConsumers) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == kConsumers * 128 && ntiles > 0) {
      mbar_arrive_expect_tx(qbar, kBQ * D * 2);
#pragma unroll
      for (int j = 0; j < kDH; ++j) tma_load_4d(sQ + j * kBQ * kSwz, &tm_q, qbar, j * kSwz, h, q0, b);
      for (int it = 0; it < ntiles; ++it) {
        const int stage = it % kStages;
        if (it >= kStages) mbar_wait(&empty[stage], (it / kStages - 1) & 1);
        mbar_arrive_expect_tx(&full[stage], 2 * kBK * D * 2);
        const int kb = kb0 + it * kBK, row = b * p.Hkv + hk;
#pragma unroll
        for (int j = 0; j < kDH; ++j) {
          tma_load_3d(sK + (stage * kDH + j) * kBK * kSwz, &tm_k, &full[stage], j * kSwz, kb, row);
          tma_load_3d(sV + (stage * kDH + j) * kBK * kSwz, &tm_v, &full[stage], j * kSwz, kb, row);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wtid = tid % 128;
    const int warp = wtid / 32, lane = tid & 31, g = lane >> 2, t = lane & 3;
    // This thread's rows of the CTA: r0 and r0 + 8, and the keys each sees:
    // [klo, khi) = [kv_start, kv_valid), and when causal j <= q_pos and
    // j > q_pos - window.
    const int r0 = wg * 64 + warp * 16 + g;
    const int qpos0 = p.q_offset + q0 + r0, qpos1 = qpos0 + 8;
    const bool windowed = p.causal && p.window > 0;
    const int klo0 = windowed ? max(kv_start, qpos0 - p.window + 1) : kv_start;
    const int klo1 = windowed ? max(kv_start, qpos1 - p.window + 1) : kv_start;
    const int khi0 = p.causal ? min(kv_valid, qpos0 + 1) : kv_valid;
    const int khi1 = p.causal ? min(kv_valid, qpos1 + 1) : kv_valid;
    const RowKeys rows{klo0, khi0, klo1, khi1};
    // The tiles [it_a, it_b) that hold a key some row of this warpgroup (below
    // Sq) sees; the others (a sliding window's far tiles) cost it no product,
    // only its part in the turns and barriers.
    const int qa = p.q_offset + q0 + wg * 64, qb = p.q_offset + min(q0 + wg * 64 + 64, p.Sq) - 1;
    const int wlo = windowed ? max(kv_start, qa - p.window + 1) : kv_start;
    const int whi = p.causal ? min(kv_valid, qb + 1) : kv_valid;
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
      if (wg == 1) pass_turn(wg);  // warpgroup 0 issues first
      auto skip_tile = [&](int it) {
        wait_tile<D>(it, kb0, sV, full, kv_start, kv_valid, p.kv_valid_vec == nullptr, tid);
        wait_turn(wg);
        pass_turn(wg);
        wait_turn(wg);
        pass_turn(wg);
        mbar_arrive(&empty[it % kStages]);
      };
      for (int it = 0; it < it_a; ++it) skip_tile(it);
      for (int it = it_a; it < it_b; ++it) {
        float s[kBK / 2];
        uint32_t pf[kBK / 16][4];
        float a0, a1;
        wait_tile<D>(it, kb0, sV, full, kv_start, kv_valid, p.kv_valid_vec == nullptr, tid);
        wait_turn(wg);
        wgmma_fence();
        issue_qk<D>(s, sQ, sK, it, wg);
        pass_turn(wg);
        wgmma_wait<0>();
        wgmma_fence_operands(s);
        online_softmax(s, kb0 + it * kBK + 2 * t, rows, p.scale_log2, st, a0, a1);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? a1 : a0;
        pack_p(s, pf);
        wait_turn(wg);
        wgmma_fence();
        issue_pv<D>(o, pf, sV, it);
        pass_turn(wg);
        wgmma_wait<0>();
        wgmma_fence_operands(o);
        mbar_arrive(&empty[it % kStages]);
      }
      for (int it = it_b; it < ntiles; ++it) skip_tile(it);
      if (wg == 0) wait_turn(wg);  // the turn warpgroup 1 passed last has no taker
    }

    const float l0 = quad_sum(st.l0), l1 = quad_sum(st.l1);
    const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
    const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
    const long q_stride = (long)p.H * D;
    bf16* obase = p.o + ((long)b * p.Sq * p.H + h) * D;
    const int row0 = q0 + r0, row1 = row0 + 8;
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
}

// A bf16 map whose innermost dimension is D, read in boxes of 64 columns with
// the 128-byte swizzle; elements outside the tensor load as zeros.
bool encode(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
            const cuuint64_t* strides, const cuuint32_t* box) {
  return encode_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, ptr, dims, strides, box,
                           CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const FlashParams& p,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  const cuuint64_t qdims[4] = {(cuuint64_t)D, (cuuint64_t)p.H, (cuuint64_t)p.Sq, (cuuint64_t)p.B};
  const cuuint64_t qstrides[3] = {(cuuint64_t)D * 2, (cuuint64_t)p.H * D * 2,
                                  (cuuint64_t)p.Sq * p.H * D * 2};
  const cuuint32_t qbox[4] = {kSwz, 1, kBQ, 1};
  // one kv_valid for the batch: the key rows end there, and TMA fills the
  // rows past it with zeros (a per-sequence kv_valid is zeroed in the kernel)
  const int rows = p.kv_valid_vec ? p.Skv : max(1, min(p.kv_valid, p.Skv));
  const cuuint64_t kvdims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)p.B * p.Hkv};
  const cuuint64_t kvstrides[2] = {(cuuint64_t)D * 2, (cuuint64_t)p.Skv * D * 2};
  const cuuint32_t kvbox[3] = {kSwz, kBK, 1};
  if (!encode(&tq, q, 4, qdims, qstrides, qbox) || !encode(&tk, k, 3, kvdims, kvstrides, kvbox) ||
      !encode(&tv, v, 3, kvdims, kvstrides, kvbox))
    return cudaErrorInvalidValue;
  constexpr int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // Launched as clusters of one CTA: at the main row (B=1, Sq=1536) the
  // plain launch's time was bimodal (27.3 or 28.4 us between launches of one
  // process), the cluster launch's steady at the lower mode (PERF.md).
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
  err = cudaLaunchKernelEx(&cfg, flash_fwd_kernel<D>, tq, tk, tv, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
}  // namespace mllm

// Returns the CUDA error code of the launch (0 on success). kv_valid_vec and
// kv_start may be null. The kernel does not synchronise.
extern "C" int mllm_flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                         const void* kv_valid_vec, const void* kv_start, int B,
                                         int Sq, int H, int Hkv, int Skv, int D, int q_offset,
                                         int kv_valid, int causal, int window, float scale_log2,
                                         void* stream) {
  using namespace mllm;
  const FlashParams p{static_cast<bf16*>(out), static_cast<const int*>(kv_valid_vec),
                      static_cast<const int*>(kv_start), B, Sq, H, Hkv, Skv, q_offset, kv_valid,
                      causal, window, (Sq + kBQ - 1) / kBQ, scale_log2};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(q, k, v, p, s);
    case 128: return launch<128>(q, k, v, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
