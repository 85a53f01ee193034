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
// What bounds it on this card: bytes. Each (b, h) reads kv_valid * (D or D/2)
// bytes of K and of V plus 8 bytes of scales a key, against ~4 * D FLOPs a key:
// about two FLOPs a byte, far below the ~295 at which an H100 stops being
// bound by its 3.35 TB/s. The n_rep query heads of one KV head read the same
// bytes; the repeats are served by the 50 MB L2.
//
// What the design does about it:
//  - The int8 cache moves half the bytes of bf16 and int4 a quarter; the
//    kernel never widens them in memory: int8 -> f32 (exact) or the nibble
//    unpack happens on the values a thread has just read from shared memory.
//  - One block per (b, q-head), as the bf16 decode kernel: the Pallas grid
//    (B, H_kv) would give 16 blocks at b = 8 on 132 SMs.
//  - 128-key tiles double-buffered with cp.async (16 bytes a copy for K and
//    V, 4 for each key's two scales, which travel with their tile), early exit
//    at each sequence's own kv_valid, tiles before kv_start or the window
//    skipped. Rows outside [lo, hi) are zero-filled and masked.
//  - Online softmax in f32, base 2 (exp2 of the score times log2(e)).
#include "common.cuh"

namespace mllm {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;  // keys per tile: one key per thread in the score pass
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kTile == kThreads, "the score pass gives each thread one key");

struct QuantDecodeParams {
  const bf16* q;            // [B, 1, H, D]
  const uint8_t* k;         // [B, Hkv, S, DS]: int8 (DS = D) or packed nibbles (DS = D / 2)
  const uint8_t* v;         // [B, Hkv, S, DS]
  const float* ks;          // [B, Hkv, S] per-key K scales
  const float* vs;          // [B, Hkv, S] per-key V scales
  bf16* o;                  // [B, 1, H, D]
  const int* kv_valid_vec;  // [B], or null: every sequence has kv_valid
  const int* kv_start;      // [B], or null: no left pad
  int B, H, Hkv, S;
  int kv_valid, window;
  float scale;  // the softmax scale, multiplied into q before it is rounded to bf16
};

// Bytes of one stored key row, and its padded stride in shared memory
// (16 bytes of padding keep the score pass's 16-byte reads conflict-free).
template <int D, bool kInt4>
struct Rows {
  static constexpr int kBytes = kInt4 ? D / 2 : D;
  static constexpr int kStride = kBytes + 16;
};

// Stored element d of a row as a float: the int8 value, or the planar nibble
// pair (byte j holds d = j in the low nibble and d = j + D/2 in the high one,
// excess-8).
template <int D, bool kInt4>
__device__ __forceinline__ float stored(const uint8_t* row, int d) {
  if constexpr (kInt4) {
    const int byte = row[d % (D / 2)];
    return static_cast<float>(((d < D / 2) ? (byte & 0x0F) : (byte >> 4)) - 8);
  } else {
    return static_cast<float>(static_cast<int8_t>(row[d]));
  }
}

template <int D, bool kInt4>
__device__ __forceinline__ void load_tile(uint8_t* dst_k, uint8_t* dst_v, float* dst_ks,
                                          float* dst_vs, const QuantDecodeParams& p, long kv_row0,
                                          int t0, int lo, int hi) {
  using R = Rows<D, kInt4>;
  constexpr int kChunks = R::kBytes / 16;
  for (int c = threadIdx.x; c < kTile * kChunks; c += kThreads) {
    const int r = c / kChunks, cc = c % kChunks;
    const int j = t0 + r;
    const bool ok = j >= lo && j < hi;
    const long off = ok ? (kv_row0 + j) * R::kBytes + cc * 16 : 0;
    cp_async_16(dst_k + r * R::kStride + cc * 16, p.k + off, ok);
    cp_async_16(dst_v + r * R::kStride + cc * 16, p.v + off, ok);
  }
  const int j = t0 + threadIdx.x;
  const bool ok = j >= lo && j < hi;
  const long off = ok ? kv_row0 + j : 0;
  cp_async_4(dst_ks + threadIdx.x, p.ks + off, ok);
  cp_async_4(dst_vs + threadIdx.x, p.vs + off, ok);
}

template <int D, bool kInt4>
constexpr int smem_bytes() {
  return 4 * kTile * Rows<D, kInt4>::kStride                      // K and V, two buffers each
         + (4 * kTile + D + kTile + 2 * kWarps + kThreads) * 4;  // scales, q, p, reductions
}

template <int D, bool kInt4>
__global__ void __launch_bounds__(kThreads) decode_quant_kernel(const QuantDecodeParams p) {
  using R = Rows<D, kInt4>;
  constexpr int kGroups = kThreads / D;  // key groups in the P V pass
  static_assert(kThreads % D == 0, "D must divide the block");
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* sK = smem;                           // [2][kTile][kStride]
  uint8_t* sV = sK + 2 * kTile * R::kStride;    // [2][kTile][kStride]
  float* sKs = reinterpret_cast<float*>(sV + 2 * kTile * R::kStride);  // [2][kTile]
  float* sVs = sKs + 2 * kTile;                 // [2][kTile]
  float* sQ = sVs + 2 * kTile;                  // [D]
  float* sP = sQ + D;                           // [kTile]
  float* sMax = sP + kTile;                     // [kWarps]
  float* sSum = sMax + kWarps;                  // [kWarps]
  float* sAcc = sSum + kWarps;                  // [kThreads]

  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (p.H / p.Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const int kv_valid = p.kv_valid_vec ? p.kv_valid_vec[b] : p.kv_valid;
  const int hi = min(kv_valid, p.S);
  int lo = max(p.kv_start ? p.kv_start[b] : 0, 0);
  if (p.window > 0) lo = max(lo, kv_valid - p.window);

  const bf16* qrow = p.q + ((long)b * p.H + h) * D;
  for (int d = tid; d < D; d += kThreads)
    sQ[d] = __bfloat162float(__float2bfloat16(__bfloat162float(qrow[d]) * p.scale));
  const long kv_row0 = ((long)b * p.Hkv + hk) * p.S;  // first key row of this (b, kv head)

  const int t0 = (lo / kTile) * kTile;
  const int ntiles = hi > lo ? (hi - t0 + kTile - 1) / kTile : 0;
  if (ntiles > 0) {
    load_tile<D, kInt4>(sK, sV, sKs, sVs, p, kv_row0, t0, lo, hi);
    cp_async_commit();
  }

  const int d_own = tid % D, grp = tid / D;
  float m = kNegBig, l = 0.f, acc = 0.f;
  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < ntiles) {
      const int nxt = buf ^ 1;
      load_tile<D, kInt4>(sK + nxt * kTile * R::kStride, sV + nxt * kTile * R::kStride,
                          sKs + nxt * kTile, sVs + nxt * kTile, p, kv_row0,
                          t0 + (it + 1) * kTile, lo, hi);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile `it` has landed; sQ is visible
    const uint8_t* kt = sK + buf * kTile * R::kStride;
    const uint8_t* vt = sV + buf * kTile * R::kStride;

    // Score of key t0 + it * kTile + tid: the stored integers against bf16 q.
    const int kpos = t0 + it * kTile + tid;
    const uint8_t* krow = kt + tid * R::kStride;
    float sc = 0.f;
#pragma unroll
    for (int c = 0; c < R::kBytes / 16; ++c) {
      const uint4 raw = *reinterpret_cast<const uint4*>(krow + c * 16);
      const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&raw);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int j = c * 16 + i;
        if constexpr (kInt4) {
          sc += sQ[j] * static_cast<float>((bytes[i] & 0x0F) - 8);
          sc += sQ[j + D / 2] * static_cast<float>((bytes[i] >> 4) - 8);
        } else {
          sc += sQ[j] * static_cast<float>(static_cast<int8_t>(bytes[i]));
        }
      }
    }
    const bool ok = kpos >= lo && kpos < hi;
    const float x = ok ? sc * sKs[buf * kTile + tid] * kLog2e : -INFINITY;

    const float wm = warp_max(x);
    if (lane == 0) sMax[warp] = wm;
    __syncthreads();
    float tmax = sMax[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) tmax = fmaxf(tmax, sMax[w]);
    const float mn = fmaxf(m, tmax);  // finite
    const float alpha = exp2f(m - mn);
    const float pr = exp2f(x - mn);   // masked: exp2(-inf) = 0
    // the V scale folded into the probability, rounded to bf16 before P V
    sP[tid] = __bfloat162float(__float2bfloat16(pr * sVs[buf * kTile + tid]));
    const float ws = warp_sum(pr);
    if (lane == 0) sSum[warp] = ws;
    __syncthreads();
    float tsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) tsum += sSum[w];
    l = l * alpha + tsum;
    m = mn;

    acc *= alpha;
#pragma unroll 8
    for (int j = grp; j < kTile; j += kGroups)
      acc += sP[j] * stored<D, kInt4>(vt + j * R::kStride, d_own);
    __syncthreads();  // the next iteration refills this buffer and sP
  }

  if (kGroups > 1) {
    sAcc[tid] = acc;
    __syncthreads();
    if (grp == 0) {
#pragma unroll
      for (int gg = 1; gg < kGroups; ++gg) acc += sAcc[gg * D + d_own];
    }
  }
  if (grp == 0) p.o[((long)b * p.H + h) * D + d_own] = __float2bfloat16(l > 0.f ? acc / l : 0.f);
}

template <int D, bool kInt4>
cudaError_t launch(const QuantDecodeParams& p, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D, kInt4>();
  cudaError_t err = cudaFuncSetAttribute(decode_quant_kernel<D, kInt4>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, p.B);
  decode_quant_kernel<D, kInt4><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mllm

// Returns the CUDA error code of the launch (0 on success). bits is 8 (int8
// K/V [B, Hkv, S, D]) or 4 (packed uint8 [B, Hkv, S, D/2]). kv_valid_vec and
// kv_start may be null. The kernel does not synchronise.
extern "C" int mllm_decode_attention_quant(const void* q, const void* k, const void* v,
                                           const void* ks, const void* vs, void* out,
                                           const void* kv_valid_vec, const void* kv_start, int B,
                                           int H, int Hkv, int S, int D, int bits, int kv_valid,
                                           int window, float scale, void* stream) {
  using namespace mllm;
  const QuantDecodeParams p{static_cast<const bf16*>(q), static_cast<const uint8_t*>(k),
                            static_cast<const uint8_t*>(v), static_cast<const float*>(ks),
                            static_cast<const float*>(vs), static_cast<bf16*>(out),
                            static_cast<const int*>(kv_valid_vec),
                            static_cast<const int*>(kv_start), B, H, Hkv, S, kv_valid, window,
                            scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128 && bits == 8) return launch<128, false>(p, s);
  if (D == 128 && bits == 4) return launch<128, true>(p, s);
  if (D == 64 && bits == 8) return launch<64, false>(p, s);
  if (D == 64 && bits == 4) return launch<64, true>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
