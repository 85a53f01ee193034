// Prefill attention (flash) over the int8 or packed-int4 KV cache for Hopper,
// bf16 query and output, f32 statistics.
//
// Replaces: mllm_tpu/ops/flash_attention.py, `flash_attention_quant`
//   (Pallas kernel `_flash_kernel_q8`, int8 and `bits4`, with `_attn_tile`).
//
// What it computes: out[b, s, h] = softmax2(qt[b, s, h] . K^T) V over the keys j
//   kv_start[b] <= j < kv_valid   and, when causal, j <= q_pos, j > q_pos - window
// (q_pos = q_offset + s), where qt is q * (scale * log2 e) rounded to bf16 by
// the wrapper (as the Pallas wrapper pre-scales q in its dtype), softmax2 is
// the base-2 softmax, and each key row is dequantized as the Pallas kernel
// does: K[j] = bf16(f32(Kq[j]) * ks[j]), V[j] = bf16(f32(Vq[j]) * vs[j]),
// Kq the int8 row or the planar nibble pair - 8. Probabilities are rounded to
// bf16 before P V; sums are f32. A row with no visible key is zeros.
//
// What bounds it on this card: as the bf16 flash kernel, a causal prefill of S
// tokens does ~2 * S^2 * D FLOPs a head against O(S * D) bytes, so beyond a
// few hundred tokens it is bound by matrix math; the int8 (int4) cache halves
// (quarters) the K/V bytes, which matters only for short chunks over a long
// cache. This first version issues mma.sync (m16n8k16 bf16, f32 accumulation)
// from four warps and does not reach the wgmma rate.
//
// What the design does about it:
//  - The structure of csrc/flash_attention.cu: one block owns (b, h, 64 query
//    rows) and loops over 64-key tiles with (m, l, acc) in registers; tiles no
//    row can see are never loaded; GQA by index.
//  - Each tile's stored bytes and per-key scales are copied with cp.async
//    into a staging area, then dequantized once, by the whole block, into the
//    bf16 tiles that the mma fragments read: the cache is never dequantized
//    to memory, and the staged tile is half (int8) or a quarter (int4) of the
//    bf16 one.
//  - Rows outside [lo, hi) are zero-filled with their scales, so a staged
//    tile never holds a NaN that a masked probability of 0 would spread.
#include "common.cuh"

namespace mllm {
namespace {

constexpr int kBQ = 64;  // query rows per block, 16 per warp
constexpr int kBK = 64;  // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;  // bf16 elements of row padding: conflict-free ldmatrix

struct FlashQuantParams {
  const bf16* q;        // [B, Sq, H, D], pre-scaled by scale * log2(e)
  const uint8_t* k;     // [B, Hkv, Skv, DS]: int8 (DS = D) or packed nibbles (DS = D / 2)
  const uint8_t* v;     // [B, Hkv, Skv, DS]
  const float* ks;      // [B, Hkv, Skv]
  const float* vs;      // [B, Hkv, Skv]
  bf16* o;              // [B, Sq, H, D]
  const int* kv_start;  // [B], or null: no left pad
  int B, Sq, H, Hkv, Skv;
  int q_offset, kv_valid, causal, window;
};

template <int D, int ROWS>
__device__ __forceinline__ void load_q_tile(bf16* dst, const bf16* base, long row_stride, int row0,
                                            int hi) {
  constexpr int kChunks = D / 8;
  constexpr int kLds = D + kPad;
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks, cc = c % kChunks;
    const int j = row0 + r;
    const bool ok = j < hi;
    const bf16* src = ok ? base + (long)j * row_stride + cc * 8 : base;
    cp_async_16(dst + r * kLds + cc * 8, src, ok);
  }
}

// Stages the stored bytes and the scales of keys [kb, kb + kBK); rows outside
// [lo, hi) are zero-filled.
template <int DS>
__device__ __forceinline__ void stage_kv(uint8_t* raw_k, uint8_t* raw_v, float* sks, float* svs,
                                         const FlashQuantParams& p, long kv_row0, int kb, int lo,
                                         int hi) {
  constexpr int kChunks = DS / 16;
  for (int c = threadIdx.x; c < kBK * kChunks; c += kThreads) {
    const int r = c / kChunks, cc = c % kChunks;
    const int j = kb + r;
    const bool ok = j >= lo && j < hi;
    const long off = ok ? (kv_row0 + j) * DS + cc * 16 : 0;
    cp_async_16(raw_k + r * DS + cc * 16, p.k + off, ok);
    cp_async_16(raw_v + r * DS + cc * 16, p.v + off, ok);
  }
  for (int r = threadIdx.x; r < kBK; r += kThreads) {
    const int j = kb + r;
    const bool ok = j >= lo && j < hi;
    const long off = ok ? kv_row0 + j : 0;
    cp_async_4(sks + r, p.ks + off, ok);
    cp_async_4(svs + r, p.vs + off, ok);
  }
}

// bf16(f32(stored) * scale) for 8 consecutive elements d0 .. d0 + 7 of row r.
template <int D, bool kInt4>
__device__ __forceinline__ uint4 dequant8(const uint8_t* row, int d0, float s) {
  float f[8];
  if constexpr (kInt4) {
    const int shift = d0 < D / 2 ? 0 : 4;
    const uint2 raw = *reinterpret_cast<const uint2*>(row + d0 % (D / 2));
    const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = static_cast<float>(((bytes[i] >> shift) & 0x0F) - 8) * s;
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(row + d0);
    const int8_t* vals = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = static_cast<float>(vals[i]) * s;
  }
  uint4 out;
  out.x = pack_bf16x2(f[0], f[1]);
  out.y = pack_bf16x2(f[2], f[3]);
  out.z = pack_bf16x2(f[4], f[5]);
  out.w = pack_bf16x2(f[6], f[7]);
  return out;
}

template <int D, bool kInt4>
__global__ void __launch_bounds__(kThreads) flash_quant_kernel(const FlashQuantParams p) {
  constexpr int DS = kInt4 ? D / 2 : D;
  constexpr int kLds = D + kPad;
  constexpr int kSteps = D / 16;  // k-steps of Q K^T
  constexpr int kNB = kBK / 8;    // 8-key column blocks of S
  constexpr int kND = D / 8;      // 8-wide column blocks of O
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kBQ * kLds;
  bf16* sV = sK + kBK * kLds;
  uint8_t* rawK = reinterpret_cast<uint8_t*>(sV + kBK * kLds);  // [kBK][DS]
  uint8_t* rawV = rawK + kBK * DS;
  float* sKs = reinterpret_cast<float*>(rawV + kBK * DS);       // [kBK]
  float* sVs = sKs + kBK;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int hk = h / (p.H / p.Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;

  // Keys [lo, hi) hold every key that any row of this block may see.
  const int kv_valid = min(p.kv_valid, p.Skv);
  const int kv_start = max(p.kv_start ? p.kv_start[b] : 0, 0);
  int lo = kv_start, hi = kv_valid;
  if (p.causal) {
    hi = min(hi, p.q_offset + min(q0 + kBQ, p.Sq));
    if (p.window > 0) lo = max(lo, p.q_offset + q0 - p.window + 1);
  }

  const long q_stride = (long)p.H * D;
  const bf16* qbase = p.q + ((long)b * p.Sq * p.H + h) * D;
  const long kv_row0 = ((long)b * p.Hkv + hk) * p.Skv;
  bf16* obase = p.o + ((long)b * p.Sq * p.H + h) * D;

  load_q_tile<D, kBQ>(sQ, qbase, q_stride, q0, p.Sq);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

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
  float m0 = kNegBig, m1 = kNegBig, l0 = 0.f, l1 = 0.f;
  const int qpos0 = p.q_offset + q0 + warp * 16 + g;

  for (int kb = (lo / kBK) * kBK; kb < hi; kb += kBK) {
    stage_kv<DS>(rawK, rawV, sKs, sVs, p, kv_row0, kb, lo, hi);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // dequantize the staged tile into the bf16 tiles, 8 elements a step
    for (int c = threadIdx.x; c < kBK * (D / 8); c += kThreads) {
      const int r = c / (D / 8), d0 = (c % (D / 8)) * 8;
      *reinterpret_cast<uint4*>(sK + r * kLds + d0) = dequant8<D, kInt4>(rawK + r * DS, d0, sKs[r]);
      *reinterpret_cast<uint4*>(sV + r * kLds + d0) = dequant8<D, kInt4>(rawV + r * DS, d0, sVs[r]);
    }
    __syncthreads();

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

    // Mask (q is already in base-2 units) and take the row maxima.
    float mx0 = kNegBig, mx1 = kNegBig;
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = kb + nb * 8 + tig * 2 + (c & 1);
        const int qpos = qpos0 + (c >> 1) * 8;
        bool ok = kpos >= kv_start && kpos < kv_valid;
        if (p.causal) ok = ok && kpos <= qpos && (p.window <= 0 || kpos > qpos - p.window);
        const float x = ok ? s[nb][c] : -INFINITY;
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
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int nd = 0; nd < kND; ++nd) {
      o[nd][0] *= a0;
      o[nd][1] *= a0;
      o[nd][2] *= a1;
      o[nd][3] *= a1;
    }

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
    __syncthreads();  // the staging area and sK / sV are overwritten by the next tile
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

template <int D, bool kInt4>
cudaError_t launch(const FlashQuantParams& p, cudaStream_t stream) {
  constexpr int DS = kInt4 ? D / 2 : D;
  const int smem = (kBQ + 2 * kBK) * (D + kPad) * (int)sizeof(bf16) + 2 * kBK * DS
                   + 2 * kBK * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_quant_kernel<D, kInt4>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.H, p.B);
  flash_quant_kernel<D, kInt4><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mllm

// Returns the CUDA error code of the launch (0 on success). q is pre-scaled by
// scale * log2(e) in bf16; bits is 8 (int8 K/V [B, Hkv, Skv, D]) or 4 (packed
// uint8 [B, Hkv, Skv, D/2]); kv_start may be null. The kernel does not
// synchronise.
extern "C" int mllm_flash_attention_quant(const void* q, const void* k, const void* v,
                                          const void* ks, const void* vs, void* out,
                                          const void* kv_start, int B, int Sq, int H, int Hkv,
                                          int Skv, int D, int bits, int q_offset, int kv_valid,
                                          int causal, int window, void* stream) {
  using namespace mllm;
  const FlashQuantParams p{static_cast<const bf16*>(q), static_cast<const uint8_t*>(k),
                           static_cast<const uint8_t*>(v), static_cast<const float*>(ks),
                           static_cast<const float*>(vs), static_cast<bf16*>(out),
                           static_cast<const int*>(kv_start), B, Sq, H, Hkv, Skv,
                           q_offset, kv_valid, causal, window};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128 && bits == 8) return launch<128, false>(p, s);
  if (D == 128 && bits == 4) return launch<128, true>(p, s);
  if (D == 64 && bits == 8) return launch<64, false>(p, s);
  if (D == 64 && bits == 4) return launch<64, true>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
