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
//  - head_dim 64 (OpenELM, TinyLlama, the Qwen MoE 0.8B prefills, causal) and
//    80 (the Qwen2-VL / Qwen2.5-VL vision towers, non-causal): a body of
//    their own (`flash_narrow_kernel`). What bounds them at their main rows
//    (1536 causal rows of 32 heads; 1444 rows of 16 heads): a 128 x 128 tile
//    took ~1.36 µs at 64 and ~1.57 at 80 on the 128 body, 2.4x and 1.7x its
//    products at one SM's share of the peak (PERF.md), and every CTA paid
//    ~3-4 µs fixed (launch, Q, the ring's first fill, the store) with
//    nothing beside it. The consumer warps are bound by the instructions they
//    issue, not by the MUFU (FMA-pipe exponentials and split reduction chains
//    were slower, PERF.md). So: (1) O at D / 2 = 32 or 40 registers leaves
//    room for S, P and O at once under the 168 a thread of 384 gets, and the
//    overlapped loop (`consume_overlapped`) issues tile it + 1's S beside
//    tile it's P V in one turn and runs its softmax while that P V does;
//    three ring stages keep its loads ahead. (2) 80 is one 64-column box
//    (128-byte swizzle) and a 16-column rest box (32-byte swizzle) read
//    through maps of their own; P V is m64n64k16 plus m64n16k16, so no work
//    lands on zero columns and no padded copy reaches memory. (The
//    reference pads q/k/v to 128 lanes in memory, `attend_padded_head`.)
//    (3) A launch of one CTA a q-tile is a persistent grid: one CTA an SM
//    walks its units of the heaviest-first list in alternating rounds
//    (`narrow_unit`), its producer loading the next unit's Q (two buffers)
//    and tiles while the current unit runs, so a CTA's fixed cost is paid
//    once. Neither narrow body splits a q-tile's keys over a cluster: a
//    short chunk over a long cache (`demo_llm --chunked`) runs one CTA a
//    unit on as many SMs as it has units (PERF.md).
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
template <int D, int BK = block_k<D>(), bool kSplitKeys = false, int NS = kStages>
struct TmaTiles {
  static constexpr bool kSplit = kSplitKeys;  // a q-tile's keys split over a cluster (head_dim 256)
  bf16* sV;
  uint64_t* full;
  uint64_t* empty;
  int kb0, kv_start, kv_valid;
  bool tma_bounded;
  int tid;
  int base = 0;  // the ring slot of tile 0 (a persistent CTA's earlier units took the slots before)

  __device__ __forceinline__ void wait_k(int it) const {
    const int stage = (base + it) % NS, kb = kb0 + it * BK;
    mbar_wait(&full[stage], ((base + it) / NS) & 1);
    if (kb < kv_start || (!tma_bounded && kb + BK > kv_valid)) {
      bf16* vt = sV + stage * BK * D;
      constexpr int kChunks = D / 8;  // 16-byte chunks a key row
      constexpr int kWide8 = wide_cols<D>() / 8;  // of them in the 64-column boxes
      for (int i = tid; i < BK * kChunks; i += kConsumers * 128) {
        const int r = i / kChunks, c = i % kChunks;  // key row, 16-byte chunk
        const int key = kb + r;
        if (key < kv_start || key >= kv_valid) {
          bf16* at = vt + ((c / 8) * BK + r) * kSwz + (c % 8) * 8;
          if constexpr (D % kSwz != 0)  // a chunk of a 16-column box
            if (c >= kWide8) at = vt + kWide8 * 8 * BK + (((c - kWide8) / 2) * BK + r) * 16 + (c - kWide8) % 2 * 8;
          *reinterpret_cast<uint4*>(at) = make_uint4(0, 0, 0, 0);
        }
      }
      fence_proxy_async();  // the zeros reach wgmma's (async-proxy) reads
      named_barrier_sync(kBarTile, kConsumers * 128);
    }
  }
  __device__ __forceinline__ void release_k(int) const {}
  __device__ __forceinline__ void wait_v(int) const {}
  __device__ __forceinline__ void release_v(int it) const { mbar_arrive(&empty[(base + it) % NS]); }
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
template <int D, bool kSplit>
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
    consume<D>(p, c, sQ, sK, sV, qbar, tiles, wg, tid);
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
    consume<D>(p, c, sQ, sK, sV, qbar, ring, wg, tid);
  }
}

// The narrow bodies: head_dim 64, and 80 as one 64-column box and a rest box
// of 16 columns (flash_attention.cuh) read through maps of their own in the
// 32-byte swizzle. The producer warpgroup and the consumers' turns as the
// 128 body, with the overlapped loop (`kOverlap`). The grid is persistent:
// one CTA an SM walks its units of the heaviest-first list (`narrow_unit`),
// its producer loading the next unit's Q (two Q buffers) and first tiles
// while the consumers finish the current one; the ring's slots run on
// across units.
constexpr int kNarrowStages = 3;  // bf16 K/V tiles in the narrow bodies' ring

template <int D>
struct NarrowTiles : TmaTiles<D, kBK, false, kNarrowStages> {
  static constexpr bool kOverlap = true;
};

template <int D>
constexpr int narrow_smem_bytes() {
  return (2 * kBQ + 2 * kNarrowStages * kBK) * D * 2 + 1024 /* alignment */ + 8 * (2 * 2 + 2 * kNarrowStages);
}
static_assert(narrow_smem_bytes<80>() <= 232448, "head_dim 80: two Q buffers and the narrow ring fit");

// The k-th unit of CTA `cta` of a persistent grid of `ctas`: rounds of
// `ctas` units of the heaviest-first list (`unit_tiles`), forward in even
// rounds and backward in odd ones, so that a CTA's heavy units pair with
// light ones. A unit past the list's end: the CTA is done.
// `flash_persistent_units` in ops/flash_attention.py states the same.
__device__ __forceinline__ int narrow_unit(int k, int cta, int ctas) {
  return k * ctas + ((k & 1) ? ctas - 1 - cta : cta);
}

// Tile `it` of a narrow unit (keys kb0 + it * kBK on) into ring slot `slot`:
// its K and V boxes of 64 columns, then of 16 (wide_cols).
template <int D>
__device__ __forceinline__ void load_narrow_tile(const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                                 const CUtensorMap* tm_kr, const CUtensorMap* tm_vr, bf16* sK,
                                                 bf16* sV, uint64_t* full, int kb0, int row, int it, int slot) {
  constexpr int kWide = wide_cols<D>();
  const int stage = slot % kNarrowStages, kb = kb0 + it * kBK;
  mbar_arrive_expect_tx(&full[stage], 2 * kBK * D * 2);
  bf16* kt = sK + stage * kBK * D;
  bf16* vt = sV + stage * kBK * D;
#pragma unroll
  for (int j = 0; j < kWide / kSwz; ++j) {
    tma_load_3d(kt + j * kBK * kSwz, tm_k, &full[stage], j * kSwz, kb, row);
    tma_load_3d(vt + j * kBK * kSwz, tm_v, &full[stage], j * kSwz, kb, row);
  }
#pragma unroll
  for (int i = 0; i < (D - kWide) / 16; ++i) {
    tma_load_3d(kt + kWide * kBK + i * kBK * 16, tm_kr, &full[stage], kWide + i * 16, kb, row);
    tma_load_3d(vt + kWide * kBK + i * kBK * 16, tm_vr, &full[stage], kWide + i * 16, kb, row);
  }
}

// A unit's Q (its boxes of 64 columns, then of 16) into sQ on `bar`.
template <int D>
__device__ __forceinline__ void load_narrow_q(const CUtensorMap* tm_q, const CUtensorMap* tm_qr, bf16* sQ,
                                              uint64_t* bar, const CtaTiles& c) {
  constexpr int kWide = wide_cols<D>();
  mbar_arrive_expect_tx(bar, kBQ * D * 2);
#pragma unroll
  for (int j = 0; j < kWide / kSwz; ++j) tma_load_4d(sQ + j * kBQ * kSwz, tm_q, bar, j * kSwz, c.h, c.q0, c.b);
#pragma unroll
  for (int i = 0; i < (D - kWide) / 16; ++i)
    tma_load_4d(sQ + kWide * kBQ + i * kBQ * 16, tm_qr, bar, kWide + i * 16, c.h, c.q0, c.b);
}

// tm_qr / tm_kr / tm_vr: the maps of the 16-column boxes (head_dim 80; at 64 unused).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_narrow_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_qr,
                        const __grid_constant__ CUtensorMap tm_kr, const __grid_constant__ CUtensorMap tm_vr,
                        const FlashParams p) {
  constexpr int kQBufs = 2;
  constexpr int NS = kNarrowStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* sQ = reinterpret_cast<bf16*>(base);  // [kQBufs][kBQ * D] (wide_cols)
  bf16* sK = sQ + kQBufs * kBQ * D;          // [NS][kBK * D]
  bf16* sV = sK + NS * kBK * D;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(sV + NS * kBK * D);  // [2]: a Q buffer landed
  uint64_t* qempty = qfull + 2;                                      // [2]: the consumers are done with it
  uint64_t* full = qempty + 2;
  uint64_t* empty = full + NS;

  const int n_units = p.n_qtiles * p.H * p.B;
  const int tid = threadIdx.x;
  const int loader = kConsumers * 128;  // the producer warpgroup's first thread
  if (tid == loader) {
    tma_prefetch(&tm_q);
    tma_prefetch(&tm_k);
    tma_prefetch(&tm_v);
    if constexpr (D % kSwz != 0) {
      tma_prefetch(&tm_qr);
      tma_prefetch(&tm_kr);
      tma_prefetch(&tm_vr);
    }
  }
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&qfull[i], 1);
      mbar_init(&qempty[i], kConsumers * 128);
    }
    for (int i = 0; i < NS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers * 128);
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const bool bounded = p.kv_valid_vec == nullptr;
  if (wg == kConsumers) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid != loader) return;
    int slot = 0;
    for (int k = 0;; ++k) {
      const int u = narrow_unit(k, blockIdx.x, gridDim.x);
      if (u >= n_units) break;
      const CtaTiles c = unit_tiles<kBK>(p, u);
      if (k >= 2) mbar_wait(&qempty[k & 1], ((k >> 1) - 1) & 1);
      load_narrow_q<D>(&tm_q, &tm_qr, sQ + (k & 1) * kBQ * D, &qfull[k & 1], c);  // every unit's, seen or not
      for (int it = 0; it < c.ntiles; ++it, ++slot) {
        if (slot >= NS) mbar_wait(&empty[slot % NS], (slot / NS - 1) & 1);
        load_narrow_tile<D>(&tm_k, &tm_v, &tm_kr, &tm_vr, sK, sV, full, c.kb0, c.b * p.Hkv + c.hk, it, slot);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    int slot = 0;
    for (int k = 0;; ++k) {
      const int u = narrow_unit(k, blockIdx.x, gridDim.x);
      if (u >= n_units) break;
      const CtaTiles c = unit_tiles<kBK>(p, u);
      mbar_wait(&qfull[k & 1], (k >> 1) & 1);  // also a unit with no tile: its Q landed before the buffer is freed
      const NarrowTiles<D> ring{{sV, full, empty, c.kb0, c.kv_start, c.kv_valid, bounded, tid, slot}};
      consume<D, NarrowTiles<D>, kBK, NS>(p, c, sQ + (k & 1) * kBQ * D, sK, sV, &qfull[k & 1], ring, wg, tid,
                                          (k >> 1) & 1);
      mbar_arrive(&qempty[k & 1]);
      slot += c.ntiles;
    }
  }
}

// A narrow body's launch: maps over rows of D columns as they lie, read in
// 64-column boxes in the 128-byte swizzle, and at head_dim 80 the rest maps
// (16-column boxes from column 64, 32-byte swizzle).
template <int D>
cudaError_t launch_narrow(const void* q, const void* k, const void* v, const FlashParams& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tqr, tkr, tvr;
  const int rows = p.kv_valid_vec ? p.Skv : max(1, min(p.kv_valid, p.Skv));
  const cuuint64_t kvdims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)p.B * p.Hkv};
  const cuuint64_t kvstrides[2] = {(cuuint64_t)D * 2, (cuuint64_t)p.Skv * D * 2};
  const cuuint32_t kvbox[3] = {kSwz, kBK, 1};
  if (!encode_q_map(&tq, q, p.B, p.Sq, p.H, D) ||
      !encode_tensor_map(&tk, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, k, kvdims, kvstrides, kvbox,
                         CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_tensor_map(&tv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, v, kvdims, kvstrides, kvbox,
                         CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  tqr = tq;
  tkr = tk;
  tvr = tv;
  if constexpr (D % kSwz != 0) {  // boxes of 16 columns, 32-byte swizzle
    const cuuint64_t qdims[4] = {(cuuint64_t)D, (cuuint64_t)p.H, (cuuint64_t)p.Sq, (cuuint64_t)p.B};
    const cuuint64_t qstrides[3] = {(cuuint64_t)D * 2, (cuuint64_t)p.H * D * 2, (cuuint64_t)p.Sq * p.H * D * 2};
    const cuuint32_t qbox[4] = {16, 1, kBQ, 1};
    const cuuint32_t rbox[3] = {16, kBK, 1};
    if (!encode_tensor_map(&tqr, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, q, qdims, qstrides, qbox,
                           CU_TENSOR_MAP_SWIZZLE_32B) ||
        !encode_tensor_map(&tkr, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, k, kvdims, kvstrides, rbox,
                           CU_TENSOR_MAP_SWIZZLE_32B) ||
        !encode_tensor_map(&tvr, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, v, kvdims, kvstrides, rbox,
                           CU_TENSOR_MAP_SWIZZLE_32B))
      return cudaErrorInvalidValue;
  }
  // the persistent grid: one CTA an SM, or one a unit where there are fewer
  // (one-CTA clusters, as launch_flash: the steadier times)
  int device = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  return launch_clusters(flash_narrow_kernel<D>, min(p.n_qtiles * p.H * p.B, sms), 1, narrow_smem_bytes<D>(), stream,
                         tq, tk, tv, tqr, tkr, tvr, p);
}

// The 128 and 256 bodies' launch: maps over rows of D columns, read in
// 64-column boxes with the 128-byte swizzle.
template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const FlashParams& p,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  // one kv_valid for the batch: the key rows end there, and TMA fills the
  // rows past it with zeros (a per-sequence kv_valid is zeroed in the kernel)
  const int rows = p.kv_valid_vec ? p.Skv : max(1, min(p.kv_valid, p.Skv));
  const cuuint64_t kvdims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)p.B * p.Hkv};
  const cuuint64_t kvstrides[2] = {(cuuint64_t)D * 2, (cuuint64_t)p.Skv * D * 2};
  const cuuint32_t kvbox[3] = {kSwz, block_k<D>(), 1};
  // bf16 maps whose innermost dimension is D, read in boxes of 64 columns
  // with the 128-byte swizzle; elements outside the tensor load as zeros
  if (!encode_q_map(&tq, q, p.B, p.Sq, p.H, D) ||
      !encode_tensor_map(&tk, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, k, kvdims, kvstrides, kvbox,
                         CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_tensor_map(&tv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, v, kvdims, kvstrides, kvbox,
                         CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  if constexpr (D > 128)
    if (p.splits > 1)
      return launch_flash<threads_of<D>()>(flash_fwd_kernel<D, true>, p, smem_bytes<D>(), stream, tq, tk, tv, p);
  return launch_flash<threads_of<D>()>(flash_fwd_kernel<D, false>, p, smem_bytes<D>(), stream, tq, tk, tv, p);
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
  const auto kernel = flash_fwd_kernel<256, true>;
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
    case 64: return launch_narrow<64>(q, k, v, p, s);  // OpenELM, TinyLlama, Qwen MoE 0.8B
    case 80: return launch_narrow<80>(q, k, v, p, s);  // the vision towers' heads (Qwen2-VL)
    case 128: return launch<128>(q, k, v, p, s);
    case 256: return launch<256>(q, k, v, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
