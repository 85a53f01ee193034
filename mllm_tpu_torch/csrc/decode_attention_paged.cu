// Single-token (decode) attention over the paged KV cache for Hopper, bf16.
//
// Replaces: mllm_tpu/ops/decode_attention.py, `decode_attention_paged`
//   (Pallas kernel `_decode_paged_kernel`).
//
// What it computes: out[b, 0, h] = softmax(q[b, 0, h] . K_b^T * scale) V_b over
// the logical keys j < min(kv_valid[b], MAXB * BS) (and, with a window,
// j > kv_valid[b] - 1 - window), where logical key j of slot b lies in pool
// block table[b, j / BS], row j % BS. A table entry is clipped to [0, NB - 1]
// as the Pallas kernel does, so a retired slot (a -1 row with kv_valid > 0)
// reads block 0 and faults nothing; its output is discarded by the caller.
// A slot with no visible key gets zeros.
//
// What bounds it on this card: bytes, as the dense decode kernel
// (csrc/decode_attention.cu): kv_valid * D * 4 bytes of K and V a (b, h)
// against 4 * kv_valid * D FLOPs. The table adds 4 bytes a block.
//
// What the design does about it:
//  - The dense kernel's design (one block per (b, q-head), 128-key tiles
//    double-buffered with cp.async, early exit at each slot's own kv_valid,
//    online softmax in f32 base 2) with BS = 128 = the tile: each tile is one
//    pool block, and the block reads its own table entry before it issues the
//    copies (the Pallas kernel's scalar-prefetched table).
//  - Only the allocated prefix of each slot is read: tiles past the valid
//    length are never loaded.
#include "common.cuh"

namespace mllm {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;  // keys per tile = rows of a pool block
constexpr int kPad = 8;     // bf16 elements of row padding: conflict-free 16-byte reads
static_assert(kTile == kThreads, "the score pass gives each thread one key");

struct PagedParams {
  const bf16* q;            // [B, 1, H, D]
  const bf16* k;            // [NB, Hkv, BS, D] pool
  const bf16* v;            // [NB, Hkv, BS, D] pool
  const int* table;         // [B, MAXB] physical block of each logical block, -1 = none
  bf16* o;                  // [B, 1, H, D]
  const int* kv_valid_vec;  // [B], or null: every slot has kv_valid
  int B, H, Hkv, NB, MAXB;
  int kv_valid, window;
  float scale_log2;  // scale * log2(e)
};

// Copies logical block `blk` of slot b (kv head hk) into shared memory; rows
// whose logical position lies outside [lo, hi) are zero-filled.
template <int D>
__device__ __forceinline__ void load_block(bf16* dst, const bf16* pool, const PagedParams& p, int b,
                                           int hk, int blk, int lo, int hi) {
  constexpr int kChunks = D / 8;
  constexpr int kLds = D + kPad;
  const int phys = min(max(p.table[(long)b * p.MAXB + blk], 0), p.NB - 1);
  const bf16* base = pool + ((long)phys * p.Hkv + hk) * kTile * D;
  for (int c = threadIdx.x; c < kTile * kChunks; c += kThreads) {
    const int r = c / kChunks, cc = c % kChunks;
    const int j = blk * kTile + r;
    const bool ok = j >= lo && j < hi;
    cp_async_16(dst + r * kLds + cc * 8, ok ? base + (long)r * D + cc * 8 : base, ok);
  }
}

template <int D>
constexpr int smem_bytes() {
  return 4 * kTile * (D + kPad) * (int)sizeof(bf16)
         + (D + kTile + 2 * kWarps + kThreads) * (int)sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(const PagedParams p) {
  constexpr int kLds = D + kPad;
  constexpr int kGroups = kThreads / D;
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
  const int hi = min(kv_valid, p.MAXB * kTile);
  const int lo = p.window > 0 ? max(kv_valid - p.window, 0) : 0;

  const bf16* qrow = p.q + ((long)b * p.H + h) * D;
  for (int d = tid; d < D; d += kThreads) sQ[d] = __bfloat162float(qrow[d]);

  const int blk0 = lo / kTile;
  const int ntiles = hi > lo ? (hi - blk0 * kTile + kTile - 1) / kTile : 0;
  if (ntiles > 0) {
    load_block<D>(sK, p.k, p, b, hk, blk0, lo, hi);
    load_block<D>(sV, p.v, p, b, hk, blk0, lo, hi);
    cp_async_commit();
  }

  const int d_own = tid % D, grp = tid / D;
  float m = kNegBig, l = 0.f, acc = 0.f;
  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < ntiles) {
      const int nxt = buf ^ 1;
      load_block<D>(sK + nxt * kTile * kLds, p.k, p, b, hk, blk0 + it + 1, lo, hi);
      load_block<D>(sV + nxt * kTile * kLds, p.v, p, b, hk, blk0 + it + 1, lo, hi);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // block `it` has landed; sQ is visible
    const bf16* kt = sK + buf * kTile * kLds;
    const bf16* vt = sV + buf * kTile * kLds;

    const int kpos = (blk0 + it) * kTile + tid;
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
cudaError_t launch(const PagedParams& p, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, p.B);
  paged_decode_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mllm

// Returns the CUDA error code of the launch (0 on success). The pool blocks
// hold BS = 128 rows; kv_valid_vec may be null. The kernel does not
// synchronise.
extern "C" int mllm_decode_attention_paged_bf16(const void* q, const void* k_pool,
                                                const void* v_pool, const void* table, void* out,
                                                const void* kv_valid_vec, int B, int H, int Hkv,
                                                int NB, int MAXB, int D, int kv_valid, int window,
                                                float scale_log2, void* stream) {
  using namespace mllm;
  const PagedParams p{static_cast<const bf16*>(q), static_cast<const bf16*>(k_pool),
                      static_cast<const bf16*>(v_pool), static_cast<const int*>(table),
                      static_cast<bf16*>(out), static_cast<const int*>(kv_valid_vec),
                      B, H, Hkv, NB, MAXB, kv_valid, window, scale_log2};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(p, s);
    case 128: return launch<128>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
