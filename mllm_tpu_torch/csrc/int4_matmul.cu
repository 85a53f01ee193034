// int4 weight-only matrix product for Hopper at decode shapes (m <= 32), f32 out.
//
// Replaces: mllm_tpu/ops/quant_matmul.py, `int4_matmul` (Pallas kernels
//   `_int4_gb_kernel`, affine, and `_int4_gb_kernel_sym`, symmetric).
//
// What it computes: y[m, n] = sum_k bf16(x[m, k]) * w[k, n] over the canonical
// planar layout of `prepare_int4`: packed row j < K/2 holds k = j in its low
// nibble and k = K/2 + j in its high nibble, rows [K/2, khp) are padding and are
// never read. Group g (32 rows) of the low half takes scale row g, of the high
// half scale row khp/32 + g. w = (q - 8) * s (symmetric, z = null) or q * s + z
// (affine); each group's product is summed in f32 and then scaled (plus z times
// the group's sum of x), as the TPU kernel orders it.
//
// What bounds it on this card: one byte holds two weights and is used for 4m
// FLOPs, so at m <= 32 the kernel is bound by HBM: the weights and their f32
// scales (a fifth of the bytes at group 32). The head of a decode step
// (K = 1536, N = 152064) moves 146 MB: 0.0438 ms at 3.35 TB/s.
//
// What the design does about it (the stream itself is int4_stream.cuh):
//  - A persistent grid (the SMs times the blocks that fit on one) walks work
//    items of 512 columns, so each packed row is read as a 512-byte run; each
//    block keeps 3 stages of 32 packed rows in flight (64 KB with their
//    scales) through 16-byte cp.async; two blocks an SM below 32 rows of x,
//    one at 32 rows or for the affine law (`int4_grid` in the plan).
//  - Tensor cores (mma.sync m16n8k16) with the nibbles turned into bf16 by
//    prmt / lop3 and one bf16x2 subtraction; up to 32 rows of x read each
//    weight once.
//  - x is staged once per chunk of packed rows, 8 rows a 16-byte load (all
//    of K for the head: the block keeps it while it walks its column tiles).
//  - Whole column tiles fill as many full waves of the grid as they can; the
//    tiles left over (the head: 297 tiles, 264 blocks, 33 left) are divided
//    along K so that their splits spread over every block, not 33 of them.
//    Each split writes its partial; the split blocks of a tile meet at an
//    integer counter (a cooperative launch keeps them all resident) and each
//    adds its share of the tile's outputs over the splits in split order (no
//    float atomics), so results repeat exactly. A product with fewer tiles
//    than blocks (o_proj: N = 1536, 3 tiles) is all split tiles.
#include "int4_stream.cuh"

namespace mllm {
namespace {

using namespace i4s;

constexpr int kTileN = 512;  // output columns a work item covers
constexpr int kStages = 4;   // ring stages of 32 packed rows

struct Int4Params {
  const bf16* x;       // [M, K]
  const uint8_t* q;    // [khp, N] planar: excess-8 (symmetric) or raw 0..15 (affine) nibbles
  const float* s;      // [2 * khp / 32, N]
  const float* z;      // [2 * khp / 32, N], or null: symmetric
  float* out;          // [M, N]
  float* ws;           // [splits, M, (tiles - full) * kTileN] partial sums of the split tiles
  unsigned* counters;  // [2 (tiles - full)]: arrivals, departures; zero, and left at zero
  int M, K, N, khp;
  int full;                            // column tiles done whole (items 0 .. full - 1)
  int splits, split_rows, chunk_rows;  // the other tiles' K splits; packed rows a staged x chunk covers
};

// Work item `it`: the first `full` items are whole column tiles (all K/2
// packed rows); the rest are (split tile, split) pairs, tile-fastest, so one
// wave of the grid does the whole tiles and the last, partial wave is spread
// over every block instead of leaving most of them idle.
struct Item {
  int tile, split;  // split -1: a whole tile
  int j0, j1;       // its packed rows
};

__device__ __forceinline__ Item item_of(const Int4Params& p, int it) {
  const int khalf = p.K / 2;
  if (it < p.full) return Item{it, -1, 0, khalf};
  const int rest = (p.N + kTileN - 1) / kTileN - p.full, i = it - p.full;
  const int split = i / rest, j0 = split * p.split_rows;
  return Item{p.full + i % rest, split, j0, min(j0 + p.split_rows, khalf)};
}

template <int MT8, bool kAffine>
int smem_bytes(const Int4Params& p) {
  return kStages * stage_bytes<float, kAffine, kTileN>() + x_words(p.chunk_rows, MT8) * 4;
}

template <int MT8, bool kAffine>
__global__ void __launch_bounds__(kThreads, MT8 <= 2 ? 2 : 1) int4_mm_kernel(const Int4Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int SB = stage_bytes<float, kAffine, kTileN>();
  uint8_t* ring = smem;
  uint32_t* xs = reinterpret_cast<uint32_t*>(smem + kStages * SB);

  const int khalf = p.K / 2, ngh = p.khp / 32;
  const int tiles = (p.N + kTileN - 1) / kTileN, rest = tiles - p.full;
  const int items = p.full + rest * p.splits;
  // A cursor over this block's (item, stage) sequence: items blockIdx.x,
  // blockIdx.x + gridDim.x, ..., each item's rows in stages of 32.
  struct Cursor {
    int it, st;
  };
  auto advance = [&](Cursor& c) {
    const Item w = item_of(p, c.it);
    if (++c.st == (w.j1 - w.j0 + kStageRows - 1) / kStageRows) {
      c.st = 0;
      c.it += gridDim.x;
    }
  };
  auto issue = [&](const Cursor& c, int slot) {
    if (c.it >= items) return;
    const Item w = item_of(p, c.it);
    const int n0 = w.tile * kTileN, j0 = w.j0 + c.st * kStageRows;
    const long N = p.N;
    const int g = j0 / 32;
    issue_stage<float, kAffine, kTileN>(ring + slot * SB, p.q + j0 * N + n0, N, min(kTileN, p.N - n0),
                                p.s + g * N + n0, p.s + (ngh + g) * N + n0,
                                kAffine ? p.z + g * N + n0 : nullptr,
                                kAffine ? p.z + (ngh + g) * N + n0 : nullptr);
  };

  Cursor prod{(int)blockIdx.x, 0}, cons = prod;
  int issued = 0, consumed = 0;
  for (int i = 0; i < kStages - 1; ++i) {
    issue(prod, issued++ % kStages);
    cp_async_commit();
    if (prod.it < items) advance(prod);
  }
  // x of packed rows [staged, staged_end) of both halves: at most chunk_rows
  // rows, never past the item's end (a one-stage split stages 32 rows).
  int staged = 0, staged_end = 0;
  Acc<MT8, kTileN> acc;
  while (cons.it < items) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this stage landed for every thread; the slot issued next is free
    issue(prod, issued++ % kStages);
    cp_async_commit();
    if (prod.it < items) advance(prod);

    const Item w = item_of(p, cons.it);
    const int j0 = w.j0 + cons.st * kStageRows;
    if (cons.st == 0) zero_acc<MT8, kTileN>(acc);
    if (j0 < staged || j0 + kStageRows > staged_end) {
      const int rows = min(p.chunk_rows, w.j1 - j0);
      stage_x_bf16<MT8>(xs, rows, p.M, p.x, p.K, khalf, j0);
      staged = j0;
      staged_end = j0 + rows;
      __syncthreads();
    }
    consume_stage<MT8, float, kAffine, kTileN>(ring + (consumed % kStages) * SB, xs, (j0 - staged) / 16, acc);
    ++consumed;

    if (j0 + kStageRows >= w.j1) {  // the item's last stage: write it out
      const int n0 = w.tile * kTileN;
      if (w.split < 0) {
        store_acc<MT8, kTileN>(acc, [&](int m, int col, float4 v) {
          if (m < p.M && n0 + col < p.N) *reinterpret_cast<float4*>(p.out + (long)m * p.N + n0 + col) = v;
        });
      } else {
        const long wide = (long)rest * kTileN;  // a row of a split's partials
        float* dst = p.ws + (long)w.split * p.M * wide + (long)(w.tile - p.full) * kTileN;
        store_acc<MT8, kTileN>(acc, [&](int m, int col, float4 v) {
          if (m < p.M) *reinterpret_cast<float4*>(dst + m * wide + col) = v;
        });
        const int nt = min(kTileN, p.N - n0), rest_i = w.tile - p.full;
        const float* part = p.ws + (long)rest_i * kTileN;
        // Every split block of the tile arrives, waits for the others (the
        // launch is cooperative: all of them are resident), and adds its share
        // of the tile's outputs, each in split order; the last to leave resets
        // the two counters for the next call.
        unsigned* arrived = p.counters + rest_i;
        unsigned* left = p.counters + rest + rest_i;
        __syncthreads();
        if (threadIdx.x == 0) {
          __threadfence();  // after the block's barrier: cumulative over its partial
          atomicAdd(arrived, 1u);
          wait_count(arrived, (unsigned)p.splits);
        }
        __syncthreads();
        const int per = (p.M * nt + p.splits - 1) / p.splits, lo = w.split * per;
        ordered_sums(
            part, (long)p.M * wide, p.splits, max(0, min(per, p.M * nt - lo)),
            [&](int i) { return (long)((lo + i) / nt) * wide + (lo + i) % nt; },
            [&](int i, float v) { p.out[(long)((lo + i) / nt) * p.N + n0 + (lo + i) % nt] = v; });
        __syncthreads();
        if (threadIdx.x == 0 && atomicAdd(left, 1u) == (unsigned)p.splits - 1) {
          *arrived = 0u;
          *left = 0u;
        }
      }
    }
    advance(cons);
  }
  cp_async_wait<0>();
}

template <int MT8, bool kAffine>
cudaError_t launch(const Int4Params& p, cudaStream_t stream) {
  const int smem = smem_bytes<MT8, kAffine>(p);
  cudaError_t err = cudaFuncSetAttribute(int4_mm_kernel<MT8, kAffine>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, int4_mm_kernel<MT8, kAffine>, kThreads,
                                                           smem)) != cudaSuccess)
    return err;
  const int tiles = (p.N + kTileN - 1) / kTileN;
  const int items = p.full + (tiles - p.full) * p.splits;
  const int grid = min(items, max(per_sm, 1) * sms);
  if (p.full == tiles) {  // whole tiles only: nothing waits
    int4_mm_kernel<MT8, kAffine><<<grid, kThreads, smem, stream>>>(p);
    return cudaGetLastError();
  }
  // The split blocks of a tile wait for each other: each needs a resident
  // block of its own (the plan's grid), and the launch must be cooperative.
  if (per_sm < 1 || (tiles - p.full) * p.splits > grid) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {const_cast<Int4Params*>(&p)};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(int4_mm_kernel<MT8, kAffine>), dim3(grid),
                                     dim3(kThreads), args, smem, stream);
}

template <bool kAffine>
cudaError_t launch_rows(const Int4Params& p, int mt8, cudaStream_t stream) {
  switch (mt8) {
    case 1: return launch<1, kAffine>(p, stream);
    case 2: return launch<2, kAffine>(p, stream);
    case 4: return launch<4, kAffine>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace mllm

// Returns the CUDA error code of the launch (0 on success). z null selects the
// symmetric law. The plan (`int4_plan` in ops/quant_matmul.py): mt8 (1, 2 or
// 4) tiles of 8 rows of x; the first `full` column tiles of 512 done whole,
// each other tile's K/2 packed rows in `splits` splits of `split_rows`; x
// staged `chunk_rows` packed rows at a time (both multiples of 32). When a
// tile is split, ws is [splits, M, (tiles - full) * 512] f32 scratch and
// counters 2 (tiles - full) zeroed u32 that the kernel leaves zeroed (null
// otherwise); x is 16-byte aligned. K % 64 == 0, N % 4 == 0, M <= 8 mt8. The kernel does not
// synchronise.
extern "C" int mllm_int4_matmul_bf16(const void* x, const void* q, const void* s, const void* z,
                                     void* out, void* ws, void* counters, int M, int K, int N, int khp,
                                     int full, int splits, int split_rows, int chunk_rows, int mt8,
                                     void* stream) {
  using namespace mllm;
  const Int4Params p{static_cast<const bf16*>(x), static_cast<const uint8_t*>(q),
                     static_cast<const float*>(s), static_cast<const float*>(z),
                     static_cast<float*>(out), static_cast<float*>(ws), static_cast<unsigned*>(counters),
                     M, K, N, khp, full, splits, split_rows, chunk_rows};
  const int tiles = (N + kTileN - 1) / kTileN;
  if (K % 64 != 0 || N % 4 != 0 || khp < K / 2 || M < 1 || M > 8 * mt8 || full < 0 || full > tiles ||
      splits < 1 || split_rows % 32 != 0 || chunk_rows % 32 != 0 || split_rows < 32 || chunk_rows < 32 ||
      (long)splits * split_rows < K / 2 || (full < tiles && (ws == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(z != nullptr ? launch_rows<true>(p, mt8, st) : launch_rows<false>(p, mt8, st));
}
