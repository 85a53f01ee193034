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
//  - head_dim 256 (Gemma-2B, which the reference runs through this Pallas
//    kernel too): 64-key tiles (S = wgmma m64n64k16, O += P V m64n256k16) so
//    Q and two stages fit shared memory (192 KB), and no producer warpgroup
//    (256 threads, no setmaxnreg), so a consumer thread may hold O (128
//    registers) beside S and P (flash_attention.cuh): thread 0 issues Q and
//    the first two tiles, then refills a stage after its softmax of the next
//    tile, once both warpgroups are done with it (`InlineTiles`).
//    What bounds it there: one CTA an SM runs a 64-key tile of its 128 rows
//    in ~2.1 us (about half an SM's share of the tensor-core peak) after a
//    fixed ~7 us, so with one CTA a q-tile a causal prefill is as slow as its
//    last q-tile (Gemma-2B's 1536 tokens: 96 CTAs on 132 SMs, the last one 24
//    tiles), and a short chunk over a long cache runs a few CTAs on a few
//    SMs. So a cluster of `splits` CTAs (1-8, `flash_splits` in
//    ops/flash_attention.py, from the shapes, the host q_offset and kv_valid
//    where the caller passes ints, and the clusters the card keeps resident)
//    shares each q-tile's key tiles: each rank takes a run of whole tiles,
//    worked out on the card from the device q_offset, kv_valid and kv_start
//    (`cta_tiles`), leaves its unnormalised O and (m, l) where Q and the ring
//    lay, and the ranks merge through distributed shared memory in rank
//    order (`merge_ranks`): one launch, no workspace, no atomics. A q-tile of
//    fewer than 2 * kMinRun tiles stays on rank 0, unmerged; the other ranks
//    leave at once. A launch of one CTA a q-tile runs an instantiation that
//    carries none of the split (`kSplit` false). A producer warpgroup (384
//    threads, setmaxnreg 24 / 240) was measured again: ptxas caps the block
//    at 168 registers and puts 240 bytes on the stack, and the main row ran
//    1.46x slower (PERF.md).
//  - head_dim 80 (the Qwen2-VL / Qwen2.5-VL vision towers, non-causal): the
//    D = 128 body over rows of 80 columns (`launch<128, 80>`): the tensor
//    maps describe the rows as they lie and TMA zero-fills columns 80-127 of
//    the second box in shared memory, Q K^T issues 5 k-steps instead of 8,
//    and the epilogue stores 80 columns. No padded copy reaches memory. (The
//    reference pads q/k/v to 128 lanes in memory, `attend_padded_head`; that
//    design, timed beside this one, is in PERF.md.)
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
template <int D, int BK = block_k<D>(), bool kSplitKeys = false>
struct TmaTiles {
  static constexpr bool kSplit = kSplitKeys;  // a q-tile's keys split over a cluster (head_dim 256)
  bf16* sV;
  uint64_t* full;
  uint64_t* empty;
  int kb0, kv_start, kv_valid;
  bool tma_bounded;
  int tid;

  __device__ __forceinline__ void wait_k(int it) const {
    constexpr int kDH = D / kSwz;
    const int stage = it % kStages, kb = kb0 + it * BK;
    mbar_wait(&full[stage], (it / kStages) & 1);
    if (kb < kv_start || (!tma_bounded && kb + BK > kv_valid)) {
      bf16* vt = sV + stage * kDH * BK * kSwz;
      for (int i = tid; i < BK * kDH * 8; i += kConsumers * 128) {
        const int r = i / (kDH * 8), c = i % (kDH * 8);  // key row, 16-byte chunk
        const int key = kb + r;
        if (key < kv_start || key >= kv_valid)
          *reinterpret_cast<uint4*>(vt + ((c / 8) * BK + r) * kSwz + (c % 8) * 8) = make_uint4(0, 0, 0, 0);
      }
      fence_proxy_async();  // the zeros reach wgmma's (async-proxy) reads
      named_barrier_sync(kBarTile, kConsumers * 128);
    }
  }
  __device__ __forceinline__ void release_k(int) const {}
  __device__ __forceinline__ void wait_v(int) const {}
  __device__ __forceinline__ void release_v(int it) const { mbar_arrive(&empty[it % kStages]); }
  __device__ __forceinline__ void prepare_q(bf16*, int, int) const {}
  __device__ __forceinline__ void refill(int) const {}
};

// TMA loads of tile `it` (K and V: keys kb0 + it * BK on, of K/V row `row`
// = b * Hkv + hk) into its stage, on full[stage]; issued by one thread.
template <int D, int BK>
__device__ __forceinline__ void load_tile(const CUtensorMap* tm_k, const CUtensorMap* tm_v, bf16* sK, bf16* sV,
                                          uint64_t* full, int kb0, int row, int it) {
  constexpr int kDH = D / kSwz;
  const int stage = it % kStages;
  mbar_arrive_expect_tx(&full[stage], 2 * BK * D * 2);
  const int kb = kb0 + it * BK;
#pragma unroll
  for (int j = 0; j < kDH; ++j) {
    tma_load_3d(sK + (stage * kDH + j) * BK * kSwz, tm_k, &full[stage], j * kSwz, kb, row);
    tma_load_3d(sV + (stage * kDH + j) * BK * kSwz, tm_v, &full[stage], j * kSwz, kb, row);
  }
}

// The head_dim 256 kernel's ring (no producer warpgroup): thread 0 loads
// tile it - 1 + kStages into the stage of tile it - 1 after its softmax of
// tile `it`, once both warpgroups have released it (the other warpgroup's
// P V on it was issued before this warpgroup's S of tile `it`, by the turns).
template <int D, int BK, bool kSplitKeys>
struct InlineTiles : TmaTiles<D, BK, kSplitKeys> {
  const CUtensorMap *tm_k, *tm_v;
  bf16* sK;
  int row, ntiles;

  __device__ __forceinline__ void refill(int it) const {
    const int next = it - 1 + kStages;
    if (this->tid == 0 && it >= 1 && next < ntiles) {
      mbar_wait(&this->empty[(it - 1) % kStages], ((it - 1) / kStages) & 1);
      load_tile<D, BK>(tm_k, tm_v, sK, this->sV, this->full, this->kb0, row, next);
    }
    __syncwarp();
  }
};

template <int D>
constexpr int smem_bytes() {
  return (kBQ + 2 * kStages * block_k<D>()) * D * 2 + 1024 /* alignment */ + 8 * (1 + 2 * kStages);
}
static_assert(smem_bytes<256>() <= 232448, "head_dim 256: Q and two stages of 64-key tiles fit");
static_assert(sizeof(SplitSmem<256>) <= (kBQ + 2 * kStages * block_k<256>()) * 256 * 2,
              "a split q-tile's partials fit where Q and the ring lay");

// kSplit: the head_dim 256 kernel of a launch with more than one CTA a
// q-tile (p.splits > 1); with one, the kernel that carries none of it.
template <int D, int DR, bool kSplit>
__global__ void __launch_bounds__(threads_of<D>(), 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const FlashParams p) {
  constexpr int kDH = D / kSwz;  // 64-column boxes of a row
  constexpr int BK = block_k<D>();
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows of 128 bytes
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* sQ = reinterpret_cast<bf16*>(base);  // [kDH][kBQ][64]
  bf16* sK = sQ + kBQ * D;                   // [kStages][kDH][BK][64]
  bf16* sV = sK + kStages * BK * D;          // [kStages][kDH][BK][64]
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sV + kStages * BK * D);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + kStages;

  const CtaTiles c = cta_tiles<BK, kSplit>(p);
  if (kSplit && c.rank >= c.used) return;  // a rank of a split q-tile with no run: no merge waits on it
  const int tid = threadIdx.x;
  constexpr bool kInline = threads_of<D>() == kConsumers * 128;  // no producer warpgroup
  if (tid == (kInline ? 0 : kConsumers * 128)) {  // the descriptors' first fetch overlaps the set-up
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
  const int loader = kInline ? 0 : kConsumers * 128;  // the thread that issues Q and the first tiles
  if (tid == loader && c.ntiles > 0) {
    mbar_arrive_expect_tx(qbar, kBQ * D * 2);
#pragma unroll
    for (int j = 0; j < kDH; ++j) tma_load_4d(sQ + j * kBQ * kSwz, &tm_q, qbar, j * kSwz, c.h, c.q0, c.b);
  }
  const TmaTiles<D, BK, kSplit> ring{sV, full, empty, c.kb0, c.kv_start, c.kv_valid, p.kv_valid_vec == nullptr, tid};
  if constexpr (kInline) {
    const int row = c.b * p.Hkv + c.hk;
    if (tid == 0)
      for (int it = 0; it < min(kStages, c.ntiles); ++it) load_tile<D, BK>(&tm_k, &tm_v, sK, sV, full, c.kb0, row, it);
    __syncwarp();
    const InlineTiles<D, BK, kSplit> tiles{ring, &tm_k, &tm_v, sK, row, c.ntiles};
    consume<D, DR>(p, c, sQ, sK, sV, qbar, tiles, wg, tid);
  } else if (wg == kConsumers) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == loader)
      for (int it = 0; it < c.ntiles; ++it) {
        if (it >= kStages) mbar_wait(&empty[it % kStages], (it / kStages - 1) & 1);
        load_tile<D, BK>(&tm_k, &tm_v, sK, sV, full, c.kb0, c.b * p.Hkv + c.hk, it);
      }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    consume<D, DR>(p, c, sQ, sK, sV, qbar, ring, wg, tid);
  }
}

// D is the body's head width, DR the width of a q/k/v/out row in memory:
// D, or 80 on the D = 128 body. A row of 80 columns is described to TMA as
// it lies (a 160-byte stride, a multiple of 16 as TMA needs); its second
// 64-column box then covers columns 64-127, of which 80-127 lie outside the
// tensor and land in shared memory as zeros (TMA still counts the whole box
// toward the barrier's bytes). So no padded copy is made in memory, Q K^T
// skips the k-steps of zeros, and P V runs the D = 128 product whose
// columns 80-127 are dropped at the store.
template <int D, int DR = D>
cudaError_t launch(const void* q, const void* k, const void* v, const FlashParams& p,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  // one kv_valid for the batch: the key rows end there, and TMA fills the
  // rows past it with zeros (a per-sequence kv_valid is zeroed in the kernel)
  const int rows = p.kv_valid_vec ? p.Skv : max(1, min(p.kv_valid, p.Skv));
  const cuuint64_t kvdims[3] = {(cuuint64_t)DR, (cuuint64_t)rows, (cuuint64_t)p.B * p.Hkv};
  const cuuint64_t kvstrides[2] = {(cuuint64_t)DR * 2, (cuuint64_t)p.Skv * DR * 2};
  const cuuint32_t kvbox[3] = {kSwz, block_k<D>(), 1};
  // bf16 maps whose innermost dimension is D, read in boxes of 64 columns
  // with the 128-byte swizzle; elements outside the tensor load as zeros
  if (!encode_q_map(&tq, q, p.B, p.Sq, p.H, DR) ||
      !encode_tensor_map(&tk, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, k, kvdims, kvstrides, kvbox,
                         CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_tensor_map(&tv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, v, kvdims, kvstrides, kvbox,
                         CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  if constexpr (D > 128)
    if (p.splits > 1)
      return launch_flash<threads_of<D>()>(flash_fwd_kernel<D, DR, true>, p, smem_bytes<D>(), stream, tq, tk, tv, p);
  return launch_flash<threads_of<D>()>(flash_fwd_kernel<D, DR, false>, p, smem_bytes<D>(), stream, tq, tk, tv, p);
}

}  // namespace
}  // namespace mllm

// The most clusters of `cluster` CTAs (1..8) of the head_dim 256 kernel the
// card keeps resident at once (its SMs, shared memory and GPC layout), in
// *out; `flash_splits` schedules its grid on them. Returns the CUDA error code.
extern "C" int mllm_flash_max_clusters(int cluster, int* out) {
  using namespace mllm;
  using namespace mllm::flash;
  constexpr int kSmem = smem_bytes<256>();
  const auto kernel = flash_fwd_kernel<256, 256, true>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads_of<256>());
  cfg.dynamicSmemBytes = kSmem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, kernel, &cfg));
}

// Returns the CUDA error code of the launch (0 on success). kv_valid_vec and
// kv_start may be null; q_offset_dev, a device int32, is read in place of
// q_offset when it is not null (a captured loop's write head). `splits` is
// the cluster size that shares a q-tile's keys at head_dim 256 (1..8; the
// wrapper's `flash_splits`), 1 at the other head dims. The kernel does not
// synchronise.
extern "C" int mllm_flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                         const void* kv_valid_vec, const void* kv_start,
                                         const void* q_offset_dev, int B, int Sq, int H, int Hkv,
                                         int Skv, int D, int q_offset, int kv_valid, int causal,
                                         int window, float scale_log2, int splits, void* stream) {
  using namespace mllm;
  using namespace mllm::flash;
  // the key split is the head_dim 256 body's (splits 1 elsewhere)
  if (splits < 1 || splits > kMaxSplits || (D != 256 && splits != 1)) return static_cast<int>(cudaErrorInvalidValue);
  const FlashParams p{static_cast<bf16*>(out), static_cast<const int*>(kv_valid_vec),
                      static_cast<const int*>(kv_start), B, Sq, H, Hkv, Skv, q_offset, kv_valid,
                      causal, window, (Sq + kBQ - 1) / kBQ, scale_log2,
                      static_cast<const int*>(q_offset_dev), splits};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(q, k, v, p, s);
    case 80: return launch<128, 80>(q, k, v, p, s);  // the vision towers' heads (Qwen2-VL)
    case 128: return launch<128>(q, k, v, p, s);
    case 256: return launch<256>(q, k, v, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
