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
// matrix math, not by HBM. This first version issues mma.sync (m16n8k16 bf16,
// f32 accumulation) from four warps and does not reach the wgmma rate.
//
// What the design does about it:
//  - The TPU grid runs the kv sweep as its innermost, sequential grid axis and
//    carries (m, l, acc) across it in VMEM scratch. Here one block owns
//    (b, h, 64 query rows) and loops over the 64-key tiles itself; (m, l, acc)
//    live in registers (each warp owns 16 query rows).
//  - Tiles that no row of the block can see (causal, window, cache fill,
//    left pad) are never loaded: the sweep runs over [lo, hi) only.
//  - GQA by index (h -> h / n_rep), so grouped heads are never materialised.
//  - scale * log2(e) is folded into the f32 scores inside the kernel; the
//    Pallas wrapper rounds it into q's dtype instead.
//  - No 128-row tiling and no shape asserts: ragged edges are zero-filled by
//    cp.async and masked in the kernel.
#include "common.cuh"

namespace mllm {
namespace {

constexpr int kBQ = 64;  // query rows per block, 16 per warp
constexpr int kBK = 64;  // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;  // bf16 elements of row padding: conflict-free ldmatrix

struct FlashParams {
  const bf16* q;            // [B, Sq, H, D]
  const bf16* k;            // [B, Hkv, Skv, D]
  const bf16* v;            // [B, Hkv, Skv, D]
  bf16* o;                  // [B, Sq, H, D]
  const int* kv_valid_vec;  // [B], or null: every sequence has kv_valid
  const int* kv_start;      // [B], or null: no left pad
  int B, Sq, H, Hkv, Skv;
  int q_offset, kv_valid, causal, window;
  float scale_log2;  // scale * log2(e)
};

// Copies rows [row0, row0 + ROWS) of a row-major [*, D] matrix into shared
// memory with a padded row stride; rows outside [lo, hi) are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base, long row_stride,
                                          int row0, int lo, int hi) {
  constexpr int kChunks = D / 8;
  constexpr int kLds = D + kPad;
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks, cc = c % kChunks;
    const int j = row0 + r;
    const bool ok = j >= lo && j < hi;
    const bf16* src = ok ? base + (long)j * row_stride + cc * 8 : base;
    cp_async_16(dst + r * kLds + cc * 8, src, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const FlashParams p) {
  constexpr int kLds = D + kPad;
  constexpr int kSteps = D / 16;  // k-steps of Q K^T
  constexpr int kNB = kBK / 8;    // 8-key column blocks of S
  constexpr int kND = D / 8;      // 8-wide column blocks of O
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kBQ * kLds;
  bf16* sV = sK + kBK * kLds;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int hk = h / (p.H / p.Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;

  // Keys [lo, hi) hold every key that any row of this block may see.
  const int kv_valid = min(p.kv_valid_vec ? p.kv_valid_vec[b] : p.kv_valid, p.Skv);
  const int kv_start = max(p.kv_start ? p.kv_start[b] : 0, 0);
  int lo = kv_start, hi = kv_valid;
  if (p.causal) {
    hi = min(hi, p.q_offset + min(q0 + kBQ, p.Sq));
    if (p.window > 0) lo = max(lo, p.q_offset + q0 - p.window + 1);
  }

  const long q_stride = (long)p.H * D;
  const bf16* qbase = p.q + ((long)b * p.Sq * p.H + h) * D;
  const bf16* kbase = p.k + ((long)b * p.Hkv + hk) * p.Skv * D;
  const bf16* vbase = p.v + ((long)b * p.Hkv + hk) * p.Skv * D;
  bf16* obase = p.o + ((long)b * p.Sq * p.H + h) * D;

  load_tile<D, kBQ>(sQ, qbase, q_stride, q0, 0, p.Sq);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // This warp's 16 query rows as A fragments, for all of D.
  uint32_t qf[kSteps][4];
  {
    const int i = lane >> 3;
    const bf16* row = sQ + (warp * 16 + (lane & 7) + (i & 1) * 8) * kLds + (i >> 1) * 8;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) ldmatrix_x4(qf[kk], row + kk * 16);
  }

  float o[kND][4];
#pragma unroll
  for (int nd = 0; nd < kND; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  // Each thread holds rows g (index 0) and g + 8 (index 1) of its warp's 16.
  float m0 = kNegBig, m1 = kNegBig, l0 = 0.f, l1 = 0.f;
  const int qpos0 = p.q_offset + q0 + warp * 16 + g;

  for (int kb = (lo / kBK) * kBK; kb < hi; kb += kBK) {
    load_tile<D, kBK>(sK, kbase, D, kb, lo, hi);
    load_tile<D, kBK>(sV, vbase, D, kb, lo, hi);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys.
    float s[kNB][4];
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
      for (int nb2 = 0; nb2 < kNB / 2; ++nb2) {
        uint32_t kf[4];
        const int i = lane >> 3;
        ldmatrix_x4(kf, sK + (nb2 * 16 + (lane & 7) + (i >> 1) * 8) * kLds + kk * 16 + (i & 1) * 8);
        mma_bf16_16816(s[2 * nb2], qf[kk], kf[0], kf[1]);
        mma_bf16_16816(s[2 * nb2 + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // Mask, scale into base-2 space, and take the row maxima.
    float mx0 = kNegBig, mx1 = kNegBig;
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = kb + nb * 8 + tig * 2 + (c & 1);
        const int qpos = qpos0 + (c >> 1) * 8;
        bool ok = kpos >= kv_start && kpos < kv_valid;
        if (p.causal) ok = ok && kpos <= qpos && (p.window <= 0 || kpos > qpos - p.window);
        const float x = ok ? s[nb][c] * p.scale_log2 : -INFINITY;
        s[nb][c] = x;
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
    for (int nb = 0; nb < kNB; ++nb) {
      s[nb][0] = exp2f(s[nb][0] - mn0);  // masked: exp2(-inf) = 0
      s[nb][1] = exp2f(s[nb][1] - mn0);
      s[nb][2] = exp2f(s[nb][2] - mn1);
      s[nb][3] = exp2f(s[nb][3] - mn1);
      rs0 += s[nb][0] + s[nb][1];
      rs1 += s[nb][2] + s[nb][3];
    }
    // Thread-local partial row sums; the quad is summed once at the end.
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int nd = 0; nd < kND; ++nd) {
      o[nd][0] *= a0;
      o[nd][1] *= a0;
      o[nd][2] *= a1;
      o[nd][3] *= a1;
    }

    // O += P V, with P re-packed from the S accumulators as bf16 A fragments.
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16x2(s[2 * kk][0], s[2 * kk][1]), pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nd2 = 0; nd2 < D / 16; ++nd2) {
        uint32_t vf[4];
        const int i = lane >> 3;
        ldmatrix_x4_trans(vf, sV + (kk * 16 + (lane & 7) + (i & 1) * 8) * kLds + nd2 * 16 + (i >> 1) * 8);
        mma_bf16_16816(o[2 * nd2], pa, vf[0], vf[1]);
        mma_bf16_16816(o[2 * nd2 + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // sK / sV are overwritten by the next tile
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int nd = 0; nd < kND; ++nd) {
    const int col = nd * 8 + tig * 2;
    if (r0 < p.Sq)
      *reinterpret_cast<__nv_bfloat162*>(obase + r0 * q_stride + col) =
          __floats2bfloat162_rn(o[nd][0] * inv0, o[nd][1] * inv0);
    if (r1 < p.Sq)
      *reinterpret_cast<__nv_bfloat162*>(obase + r1 * q_stride + col) =
          __floats2bfloat162_rn(o[nd][2] * inv1, o[nd][3] * inv1);
  }
}

template <int D>
cudaError_t launch(const FlashParams& p, cudaStream_t stream) {
  const int smem = (kBQ + 2 * kBK) * (D + kPad) * (int)sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.H, p.B);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(p);
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
  const FlashParams p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                      static_cast<const bf16*>(v), static_cast<bf16*>(out),
                      static_cast<const int*>(kv_valid_vec), static_cast<const int*>(kv_start),
                      B, Sq, H, Hkv, Skv, q_offset, kv_valid, causal, window, scale_log2};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(p, s);
    case 128: return launch<128>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
