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
// The consumer warpgroups' code (products, softmax, turns, tile ranges and
// the epilogue) is flash_attention.cuh, which flash_attention_quant.cu shares;
// this file holds the TMA producer and the stale-V-row pass.
#include "flash_attention.cuh"

namespace mllm {
namespace {

using namespace flash;

// The bf16 ring as the consumers see it: tile `it` (K and V as one) is ready
// when its TMA loads have landed. On a tile that cuts [kv_start, kv_valid), the two
// consumer warpgroups turn its stale V rows into zeros (0 * NaN would be NaN
// in P V), each a share of the rows, then meet. With one kv_valid for the
// batch (`tma_bounded`) the tensor map ends at it, so TMA itself writes
// zeros past it and only rows before kv_start need the pass.
template <int D>
struct TmaTiles {
  bf16* sV;
  uint64_t* full;
  uint64_t* empty;
  int kb0, kv_start, kv_valid;
  bool tma_bounded;
  int tid;

  __device__ __forceinline__ void wait_k(int it) const {
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
      named_barrier_sync(kBarTile, kConsumers * 128);
    }
  }
  __device__ __forceinline__ void release_k(int) const {}
  __device__ __forceinline__ void wait_v(int) const {}
  __device__ __forceinline__ void release_v(int it) const { mbar_arrive(&empty[it % kStages]); }
  __device__ __forceinline__ void prepare_q(bf16*, int, int) const {}
};

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

  const CtaTiles c = cta_tiles(p);
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
    if (tid == kConsumers * 128 && c.ntiles > 0) {
      mbar_arrive_expect_tx(qbar, kBQ * D * 2);
#pragma unroll
      for (int j = 0; j < kDH; ++j) tma_load_4d(sQ + j * kBQ * kSwz, &tm_q, qbar, j * kSwz, c.h, c.q0, c.b);
      for (int it = 0; it < c.ntiles; ++it) {
        const int stage = it % kStages;
        if (it >= kStages) mbar_wait(&empty[stage], (it / kStages - 1) & 1);
        mbar_arrive_expect_tx(&full[stage], 2 * kBK * D * 2);
        const int kb = c.kb0 + it * kBK, row = c.b * p.Hkv + c.hk;
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
    const TmaTiles<D> tiles{sV, full, empty, c.kb0, c.kv_start, c.kv_valid, p.kv_valid_vec == nullptr, tid};
    consume<D>(p, c, sQ, sK, sV, qbar, tiles, wg, tid);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const FlashParams& p,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  // one kv_valid for the batch: the key rows end there, and TMA fills the
  // rows past it with zeros (a per-sequence kv_valid is zeroed in the kernel)
  const int rows = p.kv_valid_vec ? p.Skv : max(1, min(p.kv_valid, p.Skv));
  const cuuint64_t kvdims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)p.B * p.Hkv};
  const cuuint64_t kvstrides[2] = {(cuuint64_t)D * 2, (cuuint64_t)p.Skv * D * 2};
  const cuuint32_t kvbox[3] = {kSwz, kBK, 1};
  // bf16 maps whose innermost dimension is D, read in boxes of 64 columns
  // with the 128-byte swizzle; elements outside the tensor load as zeros
  if (!encode_q_map(&tq, q, p.B, p.Sq, p.H, D) ||
      !encode_tensor_map(&tk, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, k, kvdims, kvstrides, kvbox,
                         CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_tensor_map(&tv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, v, kvdims, kvstrides, kvbox,
                         CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  return launch_flash(flash_fwd_kernel<D>, p, smem_bytes<D>(), stream, tq, tk, tv, p);
}

}  // namespace
}  // namespace mllm

// Returns the CUDA error code of the launch (0 on success). kv_valid_vec and
// kv_start may be null; q_offset_dev, a device int32, is read in place of
// q_offset when it is not null (a captured loop's write head). The kernel does
// not synchronise.
extern "C" int mllm_flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                         const void* kv_valid_vec, const void* kv_start,
                                         const void* q_offset_dev, int B, int Sq, int H, int Hkv,
                                         int Skv, int D, int q_offset, int kv_valid, int causal,
                                         int window, float scale_log2, void* stream) {
  using namespace mllm;
  using namespace mllm::flash;
  const FlashParams p{static_cast<bf16*>(out), static_cast<const int*>(kv_valid_vec),
                      static_cast<const int*>(kv_start), B, Sq, H, Hkv, Skv, q_offset, kv_valid,
                      causal, window, (Sq + kBQ - 1) / kBQ, scale_log2,
                      static_cast<const int*>(q_offset_dev)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(q, k, v, p, s);
    case 128: return launch<128>(q, k, v, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
