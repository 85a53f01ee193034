// Single-token (decode) attention over the dense KV cache for Hopper, bf16.
//
// Replaces: mllm_tpu/ops/decode_attention.py, `decode_attention`
//   (Pallas kernel `_decode_kernel`).
//
// What it computes: out[b, 0, h] = softmax(q[b, 0, h] . K[b, h // n_rep]^T * scale) V
// over the keys j with  kv_start[b] <= j < kv_valid[b]  and, with a window,
// j > kv_valid[b] - 1 - window (the window is measured from the last valid
// key, where the query sits). A sequence with no valid key gets zeros.
//
// What bounds it on this card: bytes. Each (b, h) reads kv_valid * D * 4 bytes
// of K and V and does 4 * kv_valid * D FLOPs: one FLOP per byte, far below the
// ~295 FLOP/byte at which an H100 stops being bound by its 3.35 TB/s of HBM.
// The n_rep query heads of one KV head read the same bytes; the repeats are
// served by the 50 MB L2.
//
// What the design does about it:
//  - One block per (b, q-head): the Pallas grid (B, H_kv) would give only
//    16 blocks at b = 8 on 132 SMs. At b = 1 even this leaves most SMs idle;
//    splitting the key axis across blocks (flash-decoding) is the next step.
//  - The block streams K/V in 128-key tiles with cp.async, double-buffered,
//    and stops at each sequence's own kv_valid (the Pallas kernel's early
//    exit). Tiles before kv_start or the window are skipped.
//  - The TPU artefacts are gone: no s_max % 128 requirement, no clamped final
//    DMA; the ragged last tile is zero-filled by cp.async and masked.
//  - Online softmax in f32, base 2, with scale * log2(e) applied to the f32
//    scores; masked probabilities are exact zeros.
#include "common.cuh"

namespace mllm {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;  // keys per tile: one key per thread in the score pass
constexpr int kPad = 8;     // bf16 elements of row padding: conflict-free 16-byte reads
static_assert(kTile == kThreads, "the score pass gives each thread one key");

struct DecodeParams {
  const bf16* q;            // [B, 1, H, D]
  const bf16* k;            // [B, Hkv, S, D]
  const bf16* v;            // [B, Hkv, S, D]
  bf16* o;                  // [B, 1, H, D]
  const int* kv_valid_vec;  // [B], or null: every sequence has kv_valid
  const int* kv_start;      // [B], or null: no left pad
  int B, H, Hkv, S;
  int kv_valid, window;
  float scale_log2;  // scale * log2(e)
};

template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base, int row0, int lo, int hi) {
  constexpr int kChunks = D / 8;
  constexpr int kLds = D + kPad;
  for (int c = threadIdx.x; c < kTile * kChunks; c += kThreads) {
    const int r = c / kChunks, cc = c % kChunks;
    const int j = row0 + r;
    const bool ok = j >= lo && j < hi;
    const bf16* src = ok ? base + (long)j * D + cc * 8 : base;
    cp_async_16(dst + r * kLds + cc * 8, src, ok);
  }
}

template <int D>
constexpr int smem_bytes() {
  return 4 * kTile * (D + kPad) * (int)sizeof(bf16)  // K and V, two buffers each
         + (D + kTile + 2 * kWarps + kThreads) * (int)sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads) decode_kernel(const DecodeParams p) {
  constexpr int kLds = D + kPad;
  constexpr int kGroups = kThreads / D;  // key groups in the P V pass
  static_assert(kThreads % D == 0, "D must divide the block");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);   // [2][kTile][kLds]
  bf16* sV = sK + 2 * kTile * kLds;           // [2][kTile][kLds]
  float* sQ = reinterpret_cast<float*>(sV + 2 * kTile * kLds);  // [D]
  float* sP = sQ + D;                         // [kTile]
  float* sMax = sP + kTile;                   // [kWarps]
  float* sSum = sMax + kWarps;                // [kWarps]
  float* sAcc = sSum + kWarps;                // [kThreads]

  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (p.H / p.Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const int kv_valid = p.kv_valid_vec ? p.kv_valid_vec[b] : p.kv_valid;
  const int hi = min(kv_valid, p.S);
  int lo = max(p.kv_start ? p.kv_start[b] : 0, 0);
  if (p.window > 0) lo = max(lo, kv_valid - p.window);

  const bf16* qrow = p.q + ((long)b * p.H + h) * D;
  for (int d = tid; d < D; d += kThreads) sQ[d] = __bfloat162float(qrow[d]);
  const bf16* kbase = p.k + ((long)b * p.Hkv + hk) * p.S * D;
  const bf16* vbase = p.v + ((long)b * p.Hkv + hk) * p.S * D;

  const int t0 = (lo / kTile) * kTile;
  const int ntiles = hi > lo ? (hi - t0 + kTile - 1) / kTile : 0;
  if (ntiles > 0) {
    load_tile<D>(sK, kbase, t0, lo, hi);
    load_tile<D>(sV, vbase, t0, lo, hi);
    cp_async_commit();
  }

  const int d_own = tid % D, grp = tid / D;
  float m = kNegBig, l = 0.f, acc = 0.f;
  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < ntiles) {
      const int nxt = buf ^ 1;
      load_tile<D>(sK + nxt * kTile * kLds, kbase, t0 + (it + 1) * kTile, lo, hi);
      load_tile<D>(sV + nxt * kTile * kLds, vbase, t0 + (it + 1) * kTile, lo, hi);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile `it` has landed; sQ is visible
    const bf16* kt = sK + buf * kTile * kLds;
    const bf16* vt = sV + buf * kTile * kLds;

    // Score of key t0 + it * kTile + tid.
    const int kpos = t0 + it * kTile + tid;
    float sc = 0.f;
    const bf16* krow = kt + tid * kLds;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const uint4 raw = *reinterpret_cast<const uint4*>(krow + c * 8);
      const __nv_bfloat162* kp = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float4 qa = *reinterpret_cast<const float4*>(sQ + c * 8);
      const float4 qb = *reinterpret_cast<const float4*>(sQ + c * 8 + 4);
      const float2 k0 = __bfloat1622float2(kp[0]), k1 = __bfloat1622float2(kp[1]);
      const float2 k2 = __bfloat1622float2(kp[2]), k3 = __bfloat1622float2(kp[3]);
      sc += qa.x * k0.x + qa.y * k0.y + qa.z * k1.x + qa.w * k1.y;
      sc += qb.x * k2.x + qb.y * k2.y + qb.z * k3.x + qb.w * k3.y;
    }
    const bool ok = kpos >= lo && kpos < hi;
    const float x = ok ? sc * p.scale_log2 : -INFINITY;

    const float wm = warp_max(x);
    if (lane == 0) sMax[warp] = wm;
    __syncthreads();
    float tmax = sMax[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) tmax = fmaxf(tmax, sMax[w]);
    const float mn = fmaxf(m, tmax);  // finite
    const float alpha = exp2f(m - mn);
    const float pr = exp2f(x - mn);   // masked: exp2(-inf) = 0
    sP[tid] = pr;
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
    for (int j = grp; j < kTile; j += kGroups) acc += sP[j] * __bfloat162float(vt[j * kLds + d_own]);
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

template <int D>
cudaError_t launch(const DecodeParams& p, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(decode_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, p.B);
  decode_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mllm

// Returns the CUDA error code of the launch (0 on success). kv_valid_vec and
// kv_start may be null. The kernel does not synchronise.
extern "C" int mllm_decode_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                          const void* kv_valid_vec, const void* kv_start, int B,
                                          int H, int Hkv, int S, int D, int kv_valid, int window,
                                          float scale_log2, void* stream) {
  using namespace mllm;
  const DecodeParams p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                       static_cast<const bf16*>(v), static_cast<bf16*>(out),
                       static_cast<const int*>(kv_valid_vec), static_cast<const int*>(kv_start),
                       B, H, Hkv, S, kv_valid, window, scale_log2};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(p, s);
    case 128: return launch<128>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
