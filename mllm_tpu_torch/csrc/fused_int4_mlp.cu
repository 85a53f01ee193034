// Fused int4 gated MLP for Hopper at decode shapes (m <= 32):
// y = down(act(gate(x)) * up(x)), f32 out, in one launch.
//
// Replaces: mllm_tpu/ops/fused_mlp.py, `fused_int4_mlp` (Pallas kernels
//   `_fused_mlp_kernel`, affine, and `_fused_mlp_kernel_sym`, symmetric).
//
// What it computes, with the layouts of `prepare_int4` / `prepare_int4_ff`:
//   gate, up: canonical planar over K = d (packed [khp, ff], scales [2 khp/32, ff]);
//   down:     block-planar over K = ff: in slab s of block_f = F hidden units,
//             packed row s*F/2 + r holds f = s*F + r (low nibble) and
//             f = s*F + F/2 + r (high nibble); scales [ff/32, d_out] in natural
//             f order.
//   h[m, f] = bf16(act(x . gate[:, f]) * (x . up[:, f]))   (the Pallas kernel's rounding)
//   y[m, n] = sum_f h[m, f] * down[f, n]
// Weights are (q - 8) * s (symmetric) or q * s + z (affine); each 32-row
// stage's product is summed in f32 on the tensor core and then scaled, as in
// int4_matmul.cu (the Pallas kernel's order without its bf16 group sum of x).
//
// What bounds it on this card: the three weights and their f32 scales (25.8 MB
// at d 1536, ff 8960) are each read once for 4m FLOPs a byte, so at m <= 32
// the op is bound by HBM: 0.0077 ms at 3.35 TB/s.
//
// What the design does about it: both products run on the int4 weight stream
// of int4_stream.cuh (512-column tiles, a ring of 32-row stages by 16-byte
// cp.async, nibbles to bf16 by prmt and one subtraction, mma.sync with up to
// 32 rows of x, so every weight is read once at every m <= 32) inside one
// persistent cooperative launch, with no grid barrier:
//  - Items. Gate and up are `tiles_a` column tiles of 512 hidden units each
//    (a tile's gate and up together: a "gate/up tile"), each matrix's K = d
//    split into `splits_a` runs of `rows_a` packed rows (A items, tile-major);
//    down is `tiles_b` column tiles of d_out, its K = ff split into `splits_b`
//    chunks of `rows_b` packed rows (B items). Block b takes A items b,
//    b + grid, ... and then B item grid - 1 - b (the plan, `fused_mlp_plan`
//    in ops/fused_mlp.py, keeps splits_b * tiles_b <= grid). A block's ring
//    runs on from its last A item into its B item: the down weights do not
//    depend on h, so they stream while the gate/up items finish.
//  - Gate/up. Each A item writes its f32 partial [M, 512]; after its last A
//    item a block arrives at the tiles of all of them at once (one fence).
//  - Down. A B item waits until every item of the gate/up tiles that hold its
//    hidden units has arrived (two runs of rows_b units half a slab apart),
//    loads their partials (one round trip), and makes its h = bf16(act(g) *
//    u) itself, g and u each the sum of the tile's splits in split order,
//    straight into its staged x: h never goes to global memory, and no block
//    waits for another's h. Then the chunks of a down tile meet at the tile's
//    counter and each adds its share of the tile's outputs over the chunks in
//    chunk order. No float atomics: results repeat exactly.
//  - Why it cannot deadlock: no block waits before its A items have arrived,
//    so every arrival happens; B items wait only on those, and each chunk of a
//    down tile is on a block of its own. The launch is cooperative, so every
//    block is resident.
//  - The counters are a zeroed buffer the kernel leaves zeroed: the last block
//    to leave a down tile resets its two, and the last B item of the launch
//    (every B item has then passed its waits) resets the gate/up tiles'. No
//    memset launch, and a replayed launch (a CUDA graph) needs nothing from
//    the host.
#include "int4_stream.cuh"

namespace mllm {
namespace {

using namespace i4s;

constexpr int kTileN = 512;  // output columns a work item covers
constexpr int kStages = 3;   // ring stages of 32 packed rows: room for x and h at two blocks an SM

#ifdef MLLM_MLP_STAMPS
// The per-block timeline (tools/mlp_phases.py builds this file with
// -DMLLM_MLP_STAMPS; the default build has none of it): thread 0 of each
// block writes %globaltimer at step k of its work as stamps[block][k]
// (kStampSteps a block, the MlpStep order).
constexpr int kStampSteps = 16;
__device__ unsigned long long* g_stamps;
#define MLP_STAMP(k) \
  if (threadIdx.x == 0 && g_stamps != nullptr) g_stamps[blockIdx.x * kStampSteps + (k)] = global_timer_ns()
#else
#define MLP_STAMP(k)
#endif
// start, ring primed, last gate/up item's partial written, arrived at the
// gate/up tiles, the down chunk's tiles all arrived, its h made, its partial
// written, arrived at the down tile, the down tile's chunks all arrived, end
enum MlpStep { kStart, kPrimed, kLastA, kArrivedA, kTilesIn, kHMade, kPartialB, kArrivedB, kBarrierB, kEnd };

struct MlpParams {
  const bf16* x;             // [M, d]
  const uint8_t *gq, *uq;    // [khp, ff] planar, excess-8 (symmetric) or raw (affine) nibbles
  const float *gs, *us;      // [2 khp / 32, ff]
  const float *gz, *uz;      // [2 khp / 32, ff], or null: symmetric
  const uint8_t* dq;         // [ff / 2, d_out] block-planar
  const float* ds;           // [ff / 32, d_out]
  const float* dz;           // [ff / 32, d_out], or null: symmetric
  float* ws_a;               // [2 (gate, up), splits_a, M, tiles_a * 512] partials of the A items
  float* ws_b;               // [splits_b, M, tiles_b * 512] partials of the B items
  unsigned* counters;        // arrived_a [tiles_a]; arrived_b, left_b [tiles_b]; done [1]
  float* out;                // [M, d_out]
  int M, d, khp, ff, d_out, block_f, act;
  int splits_a, rows_a, splits_b, rows_b, chunk_rows;
};

struct Item {
  bool down;   // a B item
  int tile;    // gate/up tile (A) or down column tile (B)
  int mat;     // A: 0 gate, 1 up
  int split;   // A: K split; B: chunk
  int j0, j1;  // its packed rows
};

__device__ __forceinline__ int tiles_a(const MlpParams& p) { return (p.ff + kTileN - 1) / kTileN; }
__device__ __forceinline__ int tiles_b(const MlpParams& p) { return (p.d_out + kTileN - 1) / kTileN; }
__device__ __forceinline__ int items_a(const MlpParams& p) { return 2 * tiles_a(p) * p.splits_a; }

// This block's A items, then its B item (if any).
__device__ __forceinline__ int count_a(const MlpParams& p) {
  const int n = items_a(p), b = blockIdx.x;
  return b < n ? (n - 1 - b) / (int)gridDim.x + 1 : 0;
}
__device__ __forceinline__ bool has_b(const MlpParams& p) {
  return (int)gridDim.x - 1 - (int)blockIdx.x < tiles_b(p) * p.splits_b;
}

// The block's item number `idx` (A items first, tile-major: a tile's gate
// splits, then its up splits; then the B item, tile-fastest).
__device__ __forceinline__ Item item_of(const MlpParams& p, int idx) {
  const int na = count_a(p);
  if (idx < na) {
    const int i = blockIdx.x + idx * gridDim.x, per_tile = 2 * p.splits_a;
    const int split = i % p.splits_a, j0 = split * p.rows_a;
    return Item{false, i / per_tile, (i / p.splits_a) % 2, split, j0, min(j0 + p.rows_a, p.d / 2)};
  }
  const int jb = gridDim.x - 1 - blockIdx.x, tb = tiles_b(p);
  const int chunk = jb / tb, j0 = chunk * p.rows_b;
  return Item{true, jb % tb, 0, chunk, j0, min(j0 + p.rows_b, p.ff / 2)};
}

// Issues stage `st` (32 packed rows) of item w into a ring slot.
template <bool kAffine>
__device__ __forceinline__ void issue_item(const MlpParams& p, const Item& w, int st, uint8_t* slot) {
  const int j0 = w.j0 + st * kStageRows;
  if (!w.down) {
    const long N = p.ff;
    const int n0 = w.tile * kTileN, g = j0 / 32, ngh = p.khp / 32;
    const uint8_t* q = w.mat ? p.uq : p.gq;
    const float* s = w.mat ? p.us : p.gs;
    const float* z = w.mat ? p.uz : p.gz;
    issue_stage<float, kAffine, kTileN>(slot, q + j0 * N + n0, N, min(kTileN, p.ff - n0), s + g * N + n0,
                                        s + (ngh + g) * N + n0, kAffine ? z + g * N + n0 : nullptr,
                                        kAffine ? z + (ngh + g) * N + n0 : nullptr);
  } else {
    const long N = p.d_out;
    const int n0 = w.tile * kTileN, fh = p.block_f / 2;
    const int klo = (j0 / fh) * p.block_f + j0 % fh;  // the unit of the stage's first low nibble
    issue_stage<float, kAffine, kTileN>(slot, p.dq + j0 * N + n0, N, min(kTileN, p.d_out - n0),
                                        p.ds + (klo / 32) * N + n0, p.ds + ((klo + fh) / 32) * N + n0,
                                        kAffine ? p.dz + (klo / 32) * N + n0 : nullptr,
                                        kAffine ? p.dz + ((klo + fh) / 32) * N + n0 : nullptr);
  }
}

// After the block's last A item: it arrives at the tiles of all of them at
// once (one fence for their partials). Nothing waits before this.
__device__ void arrive_a(const MlpParams& p, int na) {
  if (na == 0) return;
  __syncthreads();  // every partial of the block's A items is written
  if (threadIdx.x == 0) {
    __threadfence();  // after the block's barrier: cumulative over its partials
    for (int idx = 0; idx < na; ++idx) atomicAdd(p.counters + item_of(p, idx).tile, 1u);
    MLP_STAMP(kArrivedA);
  }
}

// The most packed rows a B item makes h for at once (a multiple of 32) in
// the staged-x area of xcap words: their staged h (8 MT8 words a row) and the
// gate/up partials of their units (4 splits_a M words a row). The plan keeps
// 32 rows within the area.
template <int MT8>
__device__ __forceinline__ int h_rows(const MlpParams& p, int xcap) {
  return max(1, xcap / (8 * MT8 + 4 * p.splits_a * p.M) / 32) * 32;
}

// h of the down chunk's packed rows [j0, j0 + rows) (inside one slab s), made
// into the staged-x layout at xs: the units f = s F + r0 + r (low) and
// f + F/2 (high), r < rows, each bf16(act(g) * u), g and u the sums of the
// gate/up tile's splits in split order (the tile's items have all arrived).
// Every partial of those units is copied into `gbuf` (after the staged rows;
// [split][half][row of x][r], runs of rows floats as they lie in the
// workspace) by 16-byte cp.async, all in flight at once: one round trip.
template <int MT8>
__device__ void make_h(const MlpParams& p, int j0, int rows, uint32_t* xs) {
  float* gbuf = reinterpret_cast<float*>(xs) + x_words(rows, MT8);
  const int fh = p.block_f / 2, f0 = (j0 / fh) * p.block_f + j0 % fh;
  const int sa = p.splits_a, runs = 2 * sa * 2 * p.M, per_run = rows / 4;
  const long wide = (long)tiles_a(p) * kTileN;
  for (int i = threadIdx.x; i < runs * per_run; i += kThreads) {
    const int run = i / per_run, c = (i % per_run) * 4;  // run = (split * 2 + half) * M + m
    const int m = run % p.M, half = (run / p.M) % 2, q = run / p.M / 2;
    cp_async_16(gbuf + run * rows + c, p.ws_a + ((long)q * p.M + m) * wide + f0 + half * fh + c, true);
  }
  cp_async_commit();
  // the padding rows of x (M .. 8 MT8) of the staged layout are zeros
  constexpr int M8 = 8 * MT8;
  const int ksteps = rows / 16;
  for (int i = threadIdx.x; i < ksteps * 2 * (M8 - p.M) * 8; i += kThreads) {
    const int e = i % 8, m = p.M + (i / 8) % (M8 - p.M), kh = i / 8 / (M8 - p.M);
    xs[(kh * M8 + m) * 8 + e] = 0u;
  }
  cp_async_wait<0>();  // also every ring stage in flight: the chunk's next ones
  __syncthreads();
  // word e of (k-step, half, row m of x) holds the rows (r0, r0 + 4) of the
  // k-step, r0 = e / 2 + 8 (e % 2) (i4s::stage_x's order)
  const int plane = 2 * p.M * rows;  // gbuf floats a split
#pragma unroll 1
  for (int i = threadIdx.x; i < ksteps * 2 * p.M * 8; i += kThreads) {
    const int e = i % 8, m = (i / 8) % p.M, kh = i / 8 / p.M;
    const float* v = gbuf + ((kh % 2) * p.M + m) * rows + (kh / 2) * 16 + e / 2 + (e % 2) * 8;
    float g0 = 0.f, u0 = 0.f, g1 = 0.f, u1 = 0.f;
#pragma unroll 4
    for (int q = 0; q < sa; ++q) {
      g0 += v[q * plane];
      u0 += v[(sa + q) * plane];
      g1 += v[q * plane + 4];
      u1 += v[(sa + q) * plane + 4];
    }
    xs[(kh * M8 + m) * 8 + e] = pack_bf16x2(activation(g0, p.act) * u0, activation(g1, p.act) * u1);
  }
}

template <int MT8, bool kAffine>
int smem_bytes(int chunk_rows) {
  return kStages * stage_bytes<float, kAffine, kTileN>() + x_words(chunk_rows, MT8) * 4;
}

template <int MT8, bool kAffine>
__global__ void __launch_bounds__(kThreads, MT8 <= 2 ? 2 : 1) fused_mlp_kernel(const MlpParams p) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int SB = stage_bytes<float, kAffine, kTileN>();
  uint8_t* ring = smem;
  uint32_t* xs = reinterpret_cast<uint32_t*>(smem + kStages * SB);

  const int ta = tiles_a(p), tb = tiles_b(p);
  const int na = count_a(p), nitems = na + (has_b(p) ? 1 : 0);
  const int xcap = x_words(p.chunk_rows, MT8);  // u32 words of the staged-x area
  MLP_STAMP(kStart);
  if (nitems == 0) return;
  unsigned* arrived_a = p.counters;
  unsigned* arrived_b = p.counters + ta;
  unsigned* left_b = arrived_b + tb;
  unsigned* done = left_b + tb;
  const int hrows = h_rows<MT8>(p, xcap);  // a B item's h is made this many packed rows at a time

  // A cursor over this block's (item, stage) sequence.
  struct Cursor {
    int idx, st;
  };
  auto advance = [&](Cursor& c) {
    const Item w = item_of(p, c.idx);
    if (++c.st == (w.j1 - w.j0) / kStageRows) {
      c.st = 0;
      ++c.idx;
    }
  };
  int issued = 0, consumed = 0;
  auto issue = [&](Cursor& c) {
    if (c.idx < nitems) {
      issue_item<kAffine>(p, item_of(p, c.idx), c.st, ring + (issued % kStages) * SB);
      advance(c);
    }
    ++issued;
    cp_async_commit();
  };

  Cursor prod{0, 0}, cons{0, 0};
  for (int i = 0; i < kStages - 1; ++i) issue(prod);
  MLP_STAMP(kPrimed);
  // x (A items) or h (the B item) of packed rows [staged, staged_end)
  int staged = 0, staged_end = 0;
  Acc<MT8, kTileN> acc;
  while (cons.idx < nitems) {
    const Item w = item_of(p, cons.idx);
    if (w.down && cons.st == 0) {
      // The block's gate/up items arrive; then the chunk waits until every
      // item of the gate/up tiles that hold its hidden units has arrived.
      arrive_a(p, na);
      if (threadIdx.x == 0) {
        const int fh = p.block_f / 2;
        for (int j = w.j0; j < w.j1;) {  // each slab the chunk touches
          const int slab = j / fh, r0 = j % fh, rows = min(w.j1 - j, fh - r0);
          for (int half = 0; half < 2; ++half) {
            const int f0 = slab * p.block_f + half * fh + r0;
            for (int t = f0 / kTileN; t <= (f0 + rows - 1) / kTileN; ++t)
              wait_count(arrived_a + t, 2u * p.splits_a);
          }
          j += rows;
        }
        MLP_STAMP(kTilesIn);
      }
      staged = staged_end = 0;  // what is staged is x, not h
    }
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this stage landed for every thread; the slot issued next is free
    issue(prod);

    const int j0 = w.j0 + cons.st * kStageRows;
    if (cons.st == 0) zero_acc<MT8, kTileN>(acc);
    if (j0 < staged || j0 + kStageRows > staged_end) {
      const int fh = p.block_f / 2;
      if (!w.down) {
        const int rows = min(p.chunk_rows, w.j1 - j0);
        stage_x_bf16<MT8>(xs, rows, p.M, p.x, p.d, p.d / 2, j0);
        staged = j0;
        staged_end = j0 + rows;
      } else {  // h, made here, within one slab: its low units, then (half a slab on) its high units
        const int rows = min(min(hrows, w.j1 - j0), fh - j0 % fh);
        make_h<MT8>(p, j0, rows, xs);
        staged = j0;
        staged_end = j0 + rows;
      }
      __syncthreads();
      if (w.down) {
        MLP_STAMP(kHMade);
      }
    }
    consume_stage<MT8, float, kAffine, kTileN>(ring + (consumed % kStages) * SB, xs, (j0 - staged) / 16, acc);
    ++consumed;

    if (j0 + kStageRows >= w.j1) {  // the item's last stage: its partial
      if (!w.down) {  // it arrives at the tile after its last A item (arrive_a)
        const long wide = (long)ta * kTileN;
        float* dst = p.ws_a + ((long)(w.mat * p.splits_a + w.split) * p.M) * wide + w.tile * kTileN;
        store_acc<MT8, kTileN>(acc, [&](int m, int col, float4 v) {
          if (m < p.M) *reinterpret_cast<float4*>(dst + m * wide + col) = v;
        });
        MLP_STAMP(kLastA);
      } else {
        const long wide = (long)tb * kTileN;
        float* dst = p.ws_b + (long)w.split * p.M * wide + w.tile * kTileN;
        store_acc<MT8, kTileN>(acc, [&](int m, int col, float4 v) {
          if (m < p.M) *reinterpret_cast<float4*>(dst + m * wide + col) = v;
        });
        // The chunks of the down tile meet (each on a block of its own), and
        // each adds its share of the tile's outputs over the chunks in order.
        __syncthreads();
        MLP_STAMP(kPartialB);
        if (threadIdx.x == 0) {
          __threadfence();
          atomicAdd(arrived_b + w.tile, 1u);
          MLP_STAMP(kArrivedB);
          wait_count(arrived_b + w.tile, (unsigned)p.splits_b);
          MLP_STAMP(kBarrierB);
        }
        __syncthreads();
        // its share: every (chunk, output) copied into the idle ring by
        // 4-byte cp.async, all in flight at once (a round trip a batch), then
        // each output summed in chunk order
        const int n0 = w.tile * kTileN, nt = min(kTileN, p.d_out - n0), sb = p.splits_b;
        const int per = (p.M * nt + sb - 1) / sb, lo = w.split * per, hi = min(lo + per, p.M * nt);
        const int batch = max(1, kStages * SB / 4 / sb);
        float* buf = reinterpret_cast<float*>(ring);
        for (int v0 = lo; v0 < hi; v0 += batch) {
          const int nv = min(batch, hi - v0);
          for (int i = threadIdx.x; i < nv * sb; i += kThreads) {  // i = chunk * nv + output
            const int v = v0 + i % nv;
            cp_async_4(buf + i, p.ws_b + ((long)(i / nv) * p.M + v / nt) * wide + n0 + v % nt, true);
          }
          cp_async_commit();
          cp_async_wait<0>();
          __syncthreads();
          for (int i = threadIdx.x; i < nv; i += kThreads) {
            float a = 0.f;
            for (int c = 0; c < sb; ++c) a += buf[c * nv + i];
            const int v = v0 + i;
            p.out[(long)(v / nt) * p.d_out + n0 + v % nt] = a;
          }
          __syncthreads();
        }
        if (threadIdx.x == 0) {
          if (atomicAdd(left_b + w.tile, 1u) == (unsigned)p.splits_b - 1) {
            arrived_b[w.tile] = 0u;
            left_b[w.tile] = 0u;
          }
          // the launch's last B item: every gate/up item has arrived and been waited on
          if (atomicAdd(done, 1u) == (unsigned)(tb * p.splits_b) - 1) {
            for (int t = 0; t < ta; ++t) arrived_a[t] = 0u;
            *done = 0u;
          }
        }
      }
    }
    advance(cons);
  }
  cp_async_wait<0>();
  if (!has_b(p)) arrive_a(p, na);
  MLP_STAMP(kEnd);
}

template <int MT8, bool kAffine>
cudaError_t launch(const MlpParams& p, int grid, cudaStream_t stream) {
  const int smem = smem_bytes<MT8, kAffine>(p.chunk_rows);
  cudaError_t err = cudaFuncSetAttribute(fused_mlp_kernel<MT8, kAffine>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  void* args[] = {const_cast<MlpParams*>(&p)};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(fused_mlp_kernel<MT8, kAffine>), dim3(grid),
                                     dim3(kThreads), args, smem, stream);
}

template <int MT8, bool kAffine>
cudaError_t blocks_per_sm(int chunk_rows, int* out) {
  const int smem = smem_bytes<MT8, kAffine>(chunk_rows);
  cudaError_t err = cudaFuncSetAttribute(fused_mlp_kernel<MT8, kAffine>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, fused_mlp_kernel<MT8, kAffine>, kThreads, smem);
}

template <bool kAffine>
cudaError_t launch_rows(const MlpParams& p, int mt8, int grid, cudaStream_t stream) {
  switch (mt8) {
    case 1: return launch<1, kAffine>(p, grid, stream);
    case 2: return launch<2, kAffine>(p, grid, stream);
    case 4: return launch<4, kAffine>(p, grid, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace mllm

#ifdef MLLM_MLP_STAMPS
// The stamped build only: stamps [1024][16] u64 (device), or null to stop.
extern "C" int mllm_mlp_stamps(void* stamps) {
  return static_cast<int>(cudaMemcpyToSymbol(mllm::g_stamps, &stamps, sizeof(stamps)));
}
#endif

// The blocks of fused_int4_mlp's kernel <mt8, affine> that one SM keeps
// resident with chunk_rows packed rows of x staged (the card's occupancy
// query), into *out. Returns the CUDA error code.
extern "C" int mllm_fused_int4_mlp_blocks(int mt8, int affine, int chunk_rows, void* out) {
  using namespace mllm;
  int* o = static_cast<int*>(out);
  switch (mt8 * 2 + (affine ? 1 : 0)) {
    case 2: return static_cast<int>(blocks_per_sm<1, false>(chunk_rows, o));
    case 3: return static_cast<int>(blocks_per_sm<1, true>(chunk_rows, o));
    case 4: return static_cast<int>(blocks_per_sm<2, false>(chunk_rows, o));
    case 5: return static_cast<int>(blocks_per_sm<2, true>(chunk_rows, o));
    case 8: return static_cast<int>(blocks_per_sm<4, false>(chunk_rows, o));
    case 9: return static_cast<int>(blocks_per_sm<4, true>(chunk_rows, o));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Returns the CUDA error code of the launch (0 on success). gz, uz and dz are
// all null (symmetric) or all set (affine). The plan (`fused_mlp_plan` in
// ops/fused_mlp.py): mt8 (1, 2 or 4) tiles of 8 rows of x; gate and up's K =
// d in splits_a runs of rows_a packed rows, down's K = ff in splits_b chunks
// of rows_b; x staged at most chunk_rows packed rows at a time, in an area
// of chunk_rows rows that also holds a down chunk's h and the partials it
// gathers (all multiples of 32); `grid` blocks, every
// one resident (the launch is cooperative), at least tiles_b * splits_b of
// them. ws is f32 scratch of [2, splits_a, M, tiles_a * 512] then
// [splits_b, M, tiles_b * 512] (tiles_a = ceil(ff / 512), tiles_b =
// ceil(d_out / 512)); counters tiles_a + 2 tiles_b + 1 zeroed u32 that the
// kernel leaves zeroed; out [M, d_out] f32; x 16-byte
// aligned. act: 0 silu, 1 gelu, 2 gelu_new (both the tanh form), 3 relu.
// d % 64 == 0, block_f % 64 == 0, ff % block_f == 0, d_out % 4 == 0,
// M <= 8 mt8. The kernel does not synchronise.
extern "C" int mllm_fused_int4_mlp_bf16(const void* x, const void* gq, const void* gs,
                                        const void* gz, const void* uq, const void* us,
                                        const void* uz, const void* dq, const void* ds,
                                        const void* dz, void* ws, void* counters, void* out, int M,
                                        int d, int khp, int ff, int d_out, int block_f, int act,
                                        int mt8, int splits_a, int rows_a, int splits_b, int rows_b,
                                        int chunk_rows, int grid, void* stream) {
  using namespace mllm;
  const bool affine = gz != nullptr;
  const int ta = (ff + kTileN - 1) / kTileN, tb = (d_out + kTileN - 1) / kTileN;
  if (d % 64 != 0 || block_f % 64 != 0 || ff % block_f != 0 || d_out % 4 != 0 || khp < d / 2 ||
      affine != (uz != nullptr) || affine != (dz != nullptr) || act < kSilu || act > kRelu || M < 1 ||
      M > 8 * mt8 || rows_a < 32 || rows_a % 32 != 0 || (long)splits_a * rows_a < d / 2 ||
      (long)(splits_a - 1) * rows_a >= d / 2 || rows_b < 32 || rows_b % 32 != 0 ||
      (long)splits_b * rows_b < ff / 2 || (long)(splits_b - 1) * rows_b >= ff / 2 || chunk_rows < 32 ||
      chunk_rows % 32 != 0 || tb * splits_b > grid ||
      32 * (8 * mt8 + 4 * splits_a * M) > x_words(chunk_rows, mt8))
    return static_cast<int>(cudaErrorInvalidValue);
  float* ws_a = static_cast<float*>(ws);
  float* ws_b = ws_a + 2L * splits_a * M * ta * kTileN;
  const MlpParams p{static_cast<const bf16*>(x),     static_cast<const uint8_t*>(gq),
                    static_cast<const uint8_t*>(uq), static_cast<const float*>(gs),
                    static_cast<const float*>(us),   static_cast<const float*>(gz),
                    static_cast<const float*>(uz),   static_cast<const uint8_t*>(dq),
                    static_cast<const float*>(ds),   static_cast<const float*>(dz),
                    ws_a, ws_b, static_cast<unsigned*>(counters), static_cast<float*>(out),
                    M, d, khp, ff, d_out, block_f, act, splits_a, rows_a, splits_b, rows_b, chunk_rows};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(affine ? launch_rows<true>(p, mt8, grid, st) : launch_rows<false>(p, mt8, grid, st));
}
