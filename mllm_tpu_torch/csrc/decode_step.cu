// Whole-trunk int4 decode step for Hopper: every decoder layer of one decode
// step (b <= 32 sequences, one token each) in ONE launch.
//
// Replaces: mllm_tpu/ops/decode_step.py, `fused_decode_step` (Pallas kernel
//   `_mega_kernel`, b = 1, RoPE as an [hd, hd] rotation matrix) and
//   `fused_decode_step_batched` (`_mega_kernel_b`, b <= 32, a position and a
//   kv_start per slot, RoPE from per-slot cos/sin rows). One kernel body serves
//   both entry points.
//
// What it computes, per layer l, for each slot r (the JAX rounding points):
//   xn   = bf16(rms(x) * norm1)                     x: the f32 residual stream
//   qkv  = xn @ Wqkv + bias                          f32
//   q    = rope(q) * scale, k = rope(k), v           f32; k, v are returned per layer
//   attention over the cached keys kv_start <= t < pos, seeded with the current
//   token (m0 = q.k, l0 = 1, acc0 = v): scores use bf16(q) against the bf16 cache,
//   p is rounded to bf16 before P.V, the output is rounded to bf16
//   x   += rm * (o @ Wo)
//   xn   = bf16(rms(x) * norm2)
//   h    = bf16(act(xn @ Wgate) * (xn @ Wup))
//   x   += rm * (h @ Wdown)
// and returns y = x after the last layer. The new token's K/V are outputs: the
// caller writes them into the cache, so the kernel never reads a row it writes.
//
// Weights, as `MegaDecodeLM.from_float` lays them out: qkv/o/gate/up planar
// excess-8 over K (packed [L, K/2, N]: row j holds k = j in the low nibble and
// k = j + K/2 in the high nibble), bf16 scales [L, K/Ga, N] in natural k-group
// order; down block-planar over ff (`prepare_int4_ff`: in slab s of block_f
// units, packed row s*F/2 + i holds f = s*F + i low and f = s*F + F/2 + i high),
// bf16 scales [L, ff/Gd, N]. Every product runs the int4 stream of
// int4_stream.cuh: each 32-row stage's integer product summed in f32 on the
// tensor core, then scaled once (a stage lies inside one group), so the
// Pallas kernel's bf16 group sum of x has no counterpart here.
//
// What bounds it on this card: the weight stream. At the Qwen2-VL-2B geometry
// a step reads 694 MB of int4 weights and bf16 scales (24.8 MB a layer) for
// about 2 FLOPs a weight per sequence, so at b <= 32 it is bound by HBM
// (0.21 ms at 3.35 TB/s), plus the live KV rows.
//
// What the design does about it:
//  - One cooperative launch of a persistent grid (every block resident:
//    occupancy x SMs, at most two blocks an SM). The phases are separated by a
//    hand-written grid barrier (arrival counter + generation word), so no -rdc
//    device link is needed. The launch fails, and the wrapper raises, if the
//    grid cannot be resident; a barrier that waits more than five seconds
//    traps instead of hanging the card.
//  - Five barriers a layer (and one before the first): qkv | attention | o |
//    gate+up | down. A product's work item is (512 output columns, so each
//    packed row is read as a 512-byte run; a chunk of packed rows; all b rows
//    of x: b <= 32 reads every weight once); the plan gives a block one item
//    where the grid allows (`item_begin`). Its partial goes to a workspace;
//    the blocks of a column tile meet at the tile's integer counter (a block
//    arrives once for all of its chunks of the tile), and each then finishes
//    its chunks' share of the tile's (row of x, head) units, adding the
//    unit's partials in chunk order
//    (no float atomics, so results repeat exactly): qkv adds the bias,
//    applies RoPE and the q scale and writes k_new / v_new; o and down update
//    the residual stream and each head's sum of squares; gate and up are kept
//    for the down projection. So the norms, the merge of the attention splits
//    and the gated hidden need no phase of their own: a product computes its
//    input from them while it stages x.
//  - Weights never depend on the activations: before it arrives at a barrier
//    a block issues the first ring stages of the next product's items, so the
//    barrier's wait overlaps the weight stream.
//  - Attention: an item is (slot, q head, key split), the keys of all slots
//    dealt evenly over about one item a block. Each warp runs its own online
//    softmax over groups of 4 keys (K and V rows read as 256 contiguous bytes
//    a warp); the block merges its warps in order, and the o projection
//    merges the splits in order when it stages its input.
//  - Everything written earlier in the same launch is read with __ldcg (L2,
//    never a stale L1 line); only inputs take __ldg.
#include "int4_stream.cuh"

namespace mllm {
namespace {

using i4s::kThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kHd = 128;      // head_dim
constexpr int kTileN = 512;   // output columns a product item covers
constexpr int kSub = 128;     // a head: the residual stream's sums of squares are kept per 128 columns
constexpr int kStages = 4;    // ring stages of 32 packed rows
constexpr int kPrime = kStages - 1;  // stages of the next product issued before a grid barrier
constexpr int kMergeFloats = 4096;   // the o projection's split products, when they fit
constexpr int kStageBytes = i4s::stage_bytes<bf16, false, kTileN>();
constexpr unsigned long long kBarrierTimeoutNs = 5000000000ull;

enum Kind { kQKV = 0, kO = 1, kGU = 2, kDown = 3 };

struct MegaParams {
  const float* x;        // [b, d] input hidden (f32)
  const float* rope_r;   // [hd, hd] rotation matrix (b = 1 entry), or null
  const float* cos;      // [b, hd/2] (batched entry)
  const float* sin;
  const int* pos_vec;    // [b] per-slot positions, or null: every slot at `pos`
  const int* kvs_vec;    // [b] per-slot kv_start, or null: every slot at `kv_start`
  int pos, kv_start;
  const uint8_t *qkv_q, *o_q, *g_q, *u_q, *d_q;
  const bf16 *qkv_s, *o_s, *g_s, *u_s, *d_s;
  const float* qkv_b;    // [L, n_qkv] or null
  const float *n1, *n2;  // [L, d]
  const bf16 *k_cache, *v_cache;  // [L, b, hkv, S, hd]
  float* y;              // [b, d]
  float *k_new, *v_new;  // [L, b, hkv, hd]
  // workspace
  float *x_res, *ss;               // [b, d] residual stream, [b, d/128] its 128-column sums of squares
  float *qkv, *gu;                 // [b, n_qkv] roped and scaled q, roped k, v; [b, 2 ff] gate, up
  float* ws[4];                    // product partials [chunks, b, columns (both matrices for kGU)], by Kind
  float *att_m, *att_l, *att_acc;  // [b, h, nsplit], same, [b, h, nsplit, hd]
  unsigned* counters[4];           // one per column tile, by Kind
  unsigned* bar;                   // [2]: arrivals, generation
  int L, b, d, ff, h, hkv, S, group_a, group_d, block_f, act;
  int rows[4], nsplit;             // packed rows per chunk, by Kind; key splits
  float eps, rm, scale;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

#ifdef MLLM_MEGA_STAMPS
// The phase timeline (tools/mega_phases.py builds this file with
// -DMLLM_MEGA_STAMPS; the default build has none of it): thread 0 of each
// block writes %globaltimer when its block arrives at a grid barrier and when
// it leaves, as stamps[seq][block][0 / 1] (kStampBlocks block slots); seq 0
// is the kernel's start (both entries), then one per barrier, then the
// kernel's end (entry 0). Entries 2 .. 15 of the barrier that ends a phase
// are marks inside that phase (MEGA_MARK): where a block's time went.
constexpr int kStampBlocks = 1024;
constexpr int kStampSlots = 16;
__device__ unsigned long long* g_stamps;
__device__ int g_stamp_cap;

__device__ __forceinline__ void stamp(int seq, int which, unsigned long long t) {
  if (g_stamps != nullptr && seq < g_stamp_cap)
    g_stamps[((long)seq * kStampBlocks + blockIdx.x) * kStampSlots + which] = t;
}
// Mark k of the phase after barrier `seq` (thread 0; the last write wins).
#define MEGA_MARK(seq, k) \
  if (threadIdx.x == 0) stamp((seq) + 1, 2 + (k), global_ns())
#else
#define MEGA_MARK(seq, k)
#endif

// Every block of the (co-resident) grid arrives before any leaves. The writes
// of all threads before the barrier are visible to all threads after it.
// `seq` counts the barriers of the launch (used by the stamped build only).
__device__ void grid_sync(unsigned* bar, int& seq) {
  __syncthreads();
  ++seq;
  if (threadIdx.x == 0) {  // one fence, after the block's barrier: it is cumulative
    unsigned* count = bar;
    unsigned* gen = bar + 1;
#ifdef MLLM_MEGA_STAMPS
    stamp(seq, 0, global_ns());
#endif
    __threadfence();
    const unsigned g = ld_acquire(gen);
    if (atomicAdd(count, 1u) == gridDim.x - 1) {
      atomicExch(count, 0u);
      __threadfence();
      atomicAdd(gen, 1u);
    } else {
      const unsigned long long t0 = global_ns();
      while (ld_acquire(gen) == g) {
        __nanosleep(64);
        if (global_ns() - t0 > kBarrierTimeoutNs) __trap();
      }
    }
    __threadfence();
#ifdef MLLM_MEGA_STAMPS
    stamp(seq, 1, global_ns());
#endif
  }
  __syncthreads();
}

// Sum over the block in a fixed order; every thread gets the result.
__device__ float block_sum(float v, float* sred) {
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) sred[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += sred[w];
  __syncthreads();
  return t;
}

__device__ __forceinline__ void load_bf16x4(float (&d)[4], const bf16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  d[0] = __low2float(a);
  d[1] = __high2float(a);
  d[2] = __low2float(b);
  d[3] = __high2float(b);
}

// ss[m, sub0 + u] = sum of sv[m, 128 u + c]^2 over c < 128, for m < rows and
// the nt / 128 heads of a row of sv (nt columns): a warp a (row, head), each
// lane four columns, then the warp's sum (a fixed order).
__device__ void sumsq_heads(const float* sv, int rows, int nt, float* ss, int subs, int sub0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, heads = nt / kSub;
  for (int w = warp; w < rows * heads; w += kWarps) {
    const int m = w / heads, u = w % heads;
    float a = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float v = sv[m * nt + u * kSub + lane * 4 + c];
      a = fmaf(v, v, a);
    }
    a = warp_sum(a);
    if (lane == 0) ss[m * subs + sub0 + u] = a;
  }
}

// Slot r's keys kv_start <= t < pos. The wrappers range-check host windows; a
// window read from a device vector is clamped to the head's rows [0, S), as
// the plain version's mask is.
__device__ __forceinline__ int2 key_window(const MegaParams& p, int r) {
  const int pos = min(p.pos_vec != nullptr ? p.pos_vec[r] : p.pos, p.S);
  const int kvs = max(p.kvs_vec != nullptr ? p.kvs_vec[r] : p.kv_start, 0);
  return make_int2(kvs, max(pos, kvs));
}

// The key splits of every slot, from the slots' key counts alone (so the
// attention phase and the o projection's merge agree): about as many
// (slot, q head, split) items as blocks, each over about the same number of
// keys, at most nsplit splits a slot. sn[r] = splits of slot r, spre[r] =
// items before slot r (spre[b] = all items). Warp 0 computes; the caller
// syncs.
__device__ void split_counts(const MegaParams& p, int* sn, int* spre) {
  if (threadIdx.x >= 32) return;
  const int r = threadIdx.x;
  int keys = 0;
  if (r < p.b) {
    const int2 w = key_window(p, r);
    keys = w.y - w.x;
  }
  int total = keys;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) total += __shfl_xor_sync(0xffffffffu, total, o);
  const int units = p.b * p.h, room = max((int)gridDim.x - units, units);
  const int span = max(1, (int)(((long)total * p.h + room - 1) / room));
  const int n = r < p.b ? min(p.nsplit, max(1, (keys + span - 1) / span)) : 0;
  int pre = n * p.h;  // inclusive scan of the slots' items
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, pre, o);
    if (r >= o) pre += v;
  }
  if (r < p.b) {
    sn[r] = n;
    spre[r + 1] = pre;
  }
  if (r == 0) spre[0] = 0;
}

// ---------------------------------------------------------------------------
// Products
// ---------------------------------------------------------------------------

// One product phase of layer l: `tiles` column tiles (gate's, then up's for
// kGU; the last of a matrix may be ragged) times `chunks` chunks of `rows`
// packed rows.
struct Prod {
  int kind, l;
  const uint8_t *q0, *q1;  // this layer's packed weights (q1: up, kGU only)
  const bf16 *s0, *s1;
  int K, N;                // one matrix: input width, output columns
  int G, block_f;          // scale group; slab (0: planar over K)
  int rows, per_mat, tiles, chunks;
};

// Column tile `tile` of P: (its first column n0 in its matrix, the matrix's
// offset in the output columns: 0, or N for up).
__device__ __forceinline__ int2 tile_cols(const Prod& P, int tile) {
  return make_int2((tile % P.per_mat) * kTileN, (tile / P.per_mat) * P.N);
}

__host__ __device__ inline int tiles_of(int n) { return (n + kTileN - 1) / kTileN; }

__device__ Prod make_prod(const MegaParams& p, int kind, int l) {
  const int n_q = p.h * kHd, n_qkv = (p.h + 2 * p.hkv) * kHd;
  Prod P{};
  P.kind = kind;
  P.l = l;
  P.rows = p.rows[kind];
  P.G = kind == kDown ? p.group_d : p.group_a;
  switch (kind) {
    case kQKV: P.K = p.d; P.N = n_qkv; break;
    case kO: P.K = n_q; P.N = p.d; break;
    case kGU: P.K = p.d; P.N = p.ff; break;
    default: P.K = p.ff; P.N = p.d; P.block_f = p.block_f; break;
  }
  const long wl = (long)l * (P.K / 2) * P.N, sl = (long)l * (P.K / P.G) * P.N;
  switch (kind) {
    case kQKV: P.q0 = p.qkv_q + wl; P.s0 = p.qkv_s + sl; break;
    case kO: P.q0 = p.o_q + wl; P.s0 = p.o_s + sl; break;
    case kGU: P.q0 = p.g_q + wl; P.s0 = p.g_s + sl; P.q1 = p.u_q + wl; P.s1 = p.u_s + sl; break;
    default: P.q0 = p.d_q + wl; P.s0 = p.d_s + sl; break;
  }
  P.per_mat = tiles_of(P.N);
  P.tiles = P.per_mat * (kind == kGU ? 2 : 1);
  P.chunks = P.K / 2 / P.rows;
  return P;
}

// k of the low nibble of packed row j; the high nibble's is klo + khi_off.
__device__ __forceinline__ int klo_of(const Prod& P, int j) {
  if (P.block_f == 0) return j;
  const int fh = P.block_f / 2;
  return (j / fh) * P.block_f + j % fh;
}
__device__ __forceinline__ int khi_off(const Prod& P) { return P.block_f == 0 ? P.K / 2 : P.block_f / 2; }

// The first of block blk's items: each block takes a contiguous run of the
// tile-major items (item it is chunk it % chunks of tile it / chunks). The
// plan gives a block one item where the grid allows; where it does not (more
// items than blocks), a block may own several chunks of one tile, and it
// arrives at that tile's barrier once, after the last of them. A block then
// waits at tile t only after its arrivals at every tile it owns before t, and
// only for the blocks that own chunks of t, each of which has waited at
// earlier tiles alone: so every barrier is reached (by induction over the
// tiles), and no block waits for an item of its own.
__device__ __forceinline__ int item_begin(const Prod& P, int blk) {
  return (int)((long)blk * P.tiles * P.chunks / gridDim.x);
}

struct Cursor {
  int it, st;
};

struct Ring {
  uint8_t* buf;
  int issued, consumed;  // stages issued / consumed by this block so far
  Cursor prod;           // the next stage to issue
  int end;               // the end of this block's items in the product being issued
};

// Issues the next stage of P's items (nothing once they are all issued).
__device__ __forceinline__ void issue(const Prod& P, Ring& R) {
  if (R.prod.it >= R.end) return;
  const int tile = R.prod.it / P.chunks, chunk = R.prod.it % P.chunks;
  const bool second = tile >= P.per_mat;
  const int n0 = tile_cols(P, tile).x;
  const int j0 = chunk * P.rows + R.prod.st * i4s::kStageRows;
  const long N = P.N;
  const bf16* s = second ? P.s1 : P.s0;
  const int klo = klo_of(P, j0);
  i4s::issue_stage<bf16, false, kTileN>(R.buf + (R.issued % kStages) * kStageBytes,
                                        (second ? P.q1 : P.q0) + j0 * N + n0, N, min(kTileN, P.N - n0),
                                        s + (long)(klo / P.G) * N + n0,
                                        s + (long)((klo + khi_off(P)) / P.G) * N + n0, nullptr, nullptr);
  ++R.issued;
  if (++R.prod.st == P.rows / i4s::kStageRows) {
    R.prod.st = 0;
    ++R.prod.it;
  }
}

// Issues the first kPrime stages of P's items (before a grid barrier).
__device__ void prime(const Prod& P, Ring& R, int seq) {
  __syncthreads();  // every warp is done with the slots these stages overwrite
  MEGA_MARK(seq, 5);
  R.prod = Cursor{item_begin(P, blockIdx.x), 0};
  R.end = item_begin(P, blockIdx.x + 1);
  for (int i = 0; i < kPrime; ++i) {
    issue(P, R);
    cp_async_commit();
  }
  MEGA_MARK(seq, 6);
}

// Shared memory of the product phases beyond the ring.
struct ProdSmem {
  uint32_t* xs;  // staged x; also a finishing tile's values [b][512] and the attention scratch
  float* swt;    // [b, h, nsplit] the attention splits' weights (o projection)
  float* sll;    // [b, h] their denominators
  float* sinv;   // [32] 1 / rms of each row of x (qkv, gate+up)
  int *sn, *spre;  // [32], [33] the attention's splits a slot and items before it (o)
};

// Stages x for packed rows [j0, j0 + rows) in the B-fragment order of
// i4s::stage_x: the b real rows of x, the padding rows zero. The caller syncs.
template <int MT8>
__device__ void stage_rows(const MegaParams& p, const Prod& P, const ProdSmem& sm, int j0, int rows) {
  const int b = p.b;
  // The o projection at small b: every (value, split) product of the chunk
  // first, spread over all threads (one round of loads, not one a split),
  // then each value is their sum in split order.
  int ns_max = 0;
  if (P.kind == kO)
    for (int r = 0; r < b; ++r) ns_max = max(ns_max, sm.sn[r]);
  const int nv = 2 * rows * b;  // values: (half, row, row of x)
  const bool merged = P.kind == kO && nv * (ns_max + 1) <= kMergeFloats;
  float* mt = reinterpret_cast<float*>(sm.xs) + i4s::x_words(rows, MT8);  // [nv][ns_max] products
  float* mv = mt + nv * ns_max;                                          // [nv] merged values
  if (merged) {
    const int total = nv * ns_max;
    for (int q0 = threadIdx.x; q0 < total; q0 += 8 * kThreads) {
      float w[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {  // every load unconditional (a clamped split), so all 8 overlap
        const int q = q0 + u * kThreads < total ? q0 + u * kThreads : q0;
        const int v = q / ns_max, sp = q % ns_max, m = v % b, r = (v / b) % rows, h = v / b / rows;
        const int k = j0 + r + h * (P.K / 2), qh = k / kHd, ns = sm.sn[m];
        const long base = ((long)m * p.h + qh) * p.nsplit + min(sp, ns - 1);
        const float a = __ldcg(p.att_acc + base * kHd + k % kHd) * sm.swt[base];
        w[u] = sp < ns ? a : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (q0 + u * kThreads < total) mt[q0 + u * kThreads] = w[u];
    }
    __syncthreads();
    for (int v = threadIdx.x; v < nv; v += kThreads) {  // each value's splits in split order
      const int m = v % b, r = (v / b) % rows, h = v / b / rows;
      float aa = 0.f;
      for (int sp = 0; sp < sm.sn[m]; ++sp) aa += mt[v * ns_max + sp];
      mv[v] = aa / sm.sll[m * p.h + (j0 + r + h * (P.K / 2)) / kHd];
    }
    __syncthreads();
  }
  // One value lambda a kind, so that the loads of a thread's eight values
  // overlap (no branch on the kind between them).
  auto k_of = [&](int h, int r) { return klo_of(P, j0 + r) + h * khi_off(P); };
  switch (P.kind) {
    case kQKV:
    case kGU: {
      const float* w = (P.kind == kQKV ? p.n1 : p.n2) + (long)P.l * p.d;
      i4s::stage_x<MT8>(sm.xs, rows, b, [&](int h, int r, int m) {
        const int k = k_of(h, r);
        return __ldcg(p.x_res + (long)m * p.d + k) * sm.sinv[m] * __ldg(w + k);
      });
      break;
    }
    case kO:
      if (merged) {
        i4s::stage_x<MT8>(sm.xs, rows, b, [&](int h, int r, int m) { return mv[(h * rows + r) * b + m]; });
      } else {  // the splits merged in split order, loads eight at a time
        i4s::stage_x<MT8>(sm.xs, rows, b, [&](int h, int r, int m) {
          const int k = k_of(h, r), qh = k / kHd, ns = sm.sn[m];
          const long base = ((long)m * p.h + qh) * p.nsplit;
          const float* acc = p.att_acc + base * kHd + k % kHd;
          float aa = 0.f;
          for (int sp = 0; sp < ns; sp += 8) {
            float v[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) v[u] = __ldcg(acc + min(sp + u, ns - 1) * kHd);
#pragma unroll
            for (int u = 0; u < 8; ++u)
              if (sp + u < ns) aa += v[u] * sm.swt[base + sp + u];
          }
          return aa / sm.sll[m * p.h + qh];
        });
      }
      break;
    default:
      i4s::stage_x<MT8>(sm.xs, rows, b, [&](int h, int r, int m) {
        const int k = k_of(h, r);
        const float* row = p.gu + (long)m * 2 * p.ff;
        return activation(__ldcg(row + k), p.act) * __ldcg(row + p.ff + k);
      });
  }
}

// The tile's barrier: every block of column tile `tile` arrives once, when the
// partials of its `mine` chunks of the tile are written, adding `mine`, and
// waits until all `chunks` have arrived. The counters only grow (zeroed before
// the first layer), so layer l waits for chunks x (l + 1).
__device__ void tile_sync(const MegaParams& p, const Prod& P, int tile, int mine) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned* c = p.counters[P.kind] + tile;
    __threadfence();  // after the block's barrier: cumulative over its writes
    atomicAdd(c, (unsigned)mine);
    i4s::wait_count(c, (unsigned)(P.chunks * (P.l + 1)));
  }
  __syncthreads();
}

// Finishing column tile `tile` is spread over the blocks of its chunks: the
// block of chunk c takes the (row of x, 128-column head) units c, c + chunks,
// ..., two at a time (a half block each). A unit adds its 128 columns'
// partials in chunk order (16 loads in flight a thread) and finishes them:
// qkv adds the bias, applies RoPE (from `rs`, the rotation staged in shared
// memory, when given) and the q scale and writes k_new / v_new; o and down
// update the residual stream and write the head's sum of squares; gate and up
// are kept for the down projection.
__device__ void finish_units(const MegaParams& p, const Prod& P, const ProdSmem& sm, int tile, int chunk,
                             const float* rs) {
  const int ncols = (P.kind == kGU ? 2 : 1) * P.N, b = p.b;
  const int2 tc = tile_cols(P, tile);
  const int heads = min(kTileN, P.N - tc.x) / kSub, units = b * heads;
  const int half = threadIdx.x / kSub, j = threadIdx.x % kSub, lw = j / 32;
  float* sv = reinterpret_cast<float*>(sm.xs) + half * kSub;  // [2][128]
  float* sred = reinterpret_cast<float*>(sm.xs) + 2 * kSub + half * 4;
  const int n_qkv = (p.h + 2 * p.hkv) * kHd;
  const long plane = (long)b * ncols;
  for (int u0 = chunk; u0 < units; u0 += 2 * P.chunks) {
    const int u = u0 + half * P.chunks;
    const bool live = u < units;
    const int m = live ? u / heads : 0, hh = live ? u % heads : 0;
    const int col = tc.x + hh * kSub + j;  // within its matrix
    float a = 0.f;
    if (live) {
      const float* ws = p.ws[P.kind] + (long)m * ncols + tc.y + col;
      for (int c = 0; c < P.chunks; c += 16) {
        float v[16];
#pragma unroll
        for (int q = 0; q < 16; ++q) v[q] = __ldcg(ws + min(c + q, P.chunks - 1) * plane);  // unconditional: all 16 overlap
#pragma unroll
        for (int q = 0; q < 16; ++q)
          if (c + q < P.chunks) a += v[q];
      }
    }
    if (P.kind == kQKV) {
      const int head = col / kHd;
      const bool is_q = head < p.h, is_k = !is_q && head < p.h + p.hkv;
      if (p.qkv_b != nullptr && live) a += __ldg(p.qkv_b + (long)P.l * n_qkv + col);
      sv[j] = a;
      __syncthreads();
      float o = a;
      if (live && (is_q || is_k)) {
        if (p.rope_r != nullptr) {  // x @ rope_r, as the b = 1 entry point defines it
          float r[4] = {0.f, 0.f, 0.f, 0.f};
          if (rs != nullptr) {
#pragma unroll 8
            for (int k = 0; k < kHd; k += 4)
#pragma unroll
              for (int q = 0; q < 4; ++q) r[q] = fmaf(sv[k + q], rs[(k + q) * kHd + j], r[q]);
          } else {
#pragma unroll 8
            for (int k = 0; k < kHd; k += 4)
#pragma unroll
              for (int q = 0; q < 4; ++q) r[q] = fmaf(sv[k + q], __ldg(p.rope_r + (k + q) * kHd + j), r[q]);
          }
          o = (r[0] + r[1]) + (r[2] + r[3]);
        } else {
          const int hf = kHd / 2, jj = j % hf;
          const float cs = __ldg(p.cos + m * hf + jj), sn = __ldg(p.sin + m * hf + jj);
          o = j < hf ? sv[j] * cs + sv[j + hf] * -sn : sv[j] * cs + sv[j - hf] * sn;
        }
      }
      if (live) {
        if (is_q) o *= p.scale;
        p.qkv[(long)m * n_qkv + col] = o;
        if (!is_q) {
          const int hk = is_k ? head - p.h : head - p.h - p.hkv;
          float* dst = is_k ? p.k_new : p.v_new;
          dst[(((long)P.l * b + m) * p.hkv + hk) * kHd + j] = o;
        }
      }
      __syncthreads();
    } else if (P.kind == kGU) {
      if (live) p.gu[(long)m * ncols + tc.y + col] = a;
    } else {  // o, down: the residual stream, and the head's sum of squares
      float v = 0.f;
      if (live) {
        const long o = (long)m * p.d + col;
        v = __ldcg(p.x_res + o) + a * p.rm;
        p.x_res[o] = v;
        if (P.kind == kDown && P.l == p.L - 1) p.y[o] = v;
      }
      const float w = warp_sum(v * v);
      if (j % 32 == 0) sred[lw] = w;
      __syncthreads();
      if (live && j == 0) p.ss[m * (p.d / kSub) + col / kSub] = (sred[0] + sred[1]) + (sred[2] + sred[3]);
      __syncthreads();
    }
  }
}

// Before a product stages x: the rows' 1 / rms (qkv, gate+up) or the
// attention splits' merge weights (o), from what the previous phases wrote.
__device__ void product_setup(const MegaParams& p, const Prod& P, const ProdSmem& sm) {
  if (P.kind == kQKV || P.kind == kGU) {
    const int tiles = p.d / kSub;
    for (int m = threadIdx.x; m < p.b; m += kThreads) {
      sm.sinv[m] = rsqrtf(i4s::ordered_sum(p.ss + m * tiles, 1, tiles) / p.d + p.eps);
    }
  } else if (P.kind == kO) {
    const int n = p.b * p.h * p.nsplit;
    float* sl = reinterpret_cast<float*>(sm.xs);  // the splits' l, until x is staged
    for (int i = threadIdx.x; i < n; i += kThreads) {
      if (i % p.nsplit < sm.sn[i / p.nsplit / p.h]) {
        sm.swt[i] = __ldcg(p.att_m + i);
        sl[i] = __ldcg(p.att_l + i);
      }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < p.b * p.h; t += kThreads) {
      const int ns = sm.sn[t / p.h];
      float mm = kNegBig;
      for (int s = 0; s < ns; ++s) mm = fmaxf(mm, sm.swt[t * p.nsplit + s]);
      float ll = 0.f;
      for (int s = 0; s < ns; ++s) {
        const float e = expf(sm.swt[t * p.nsplit + s] - mm);
        ll += sl[t * p.nsplit + s] * e;
        sm.swt[t * p.nsplit + s] = e;
      }
      sm.sll[t] = ll;
    }
  }
  __syncthreads();
}

// Runs product P (its first stages already issued by prime()).
template <int MT8>
__device__ void product(const MegaParams& p, const Prod& P, Ring& R, const ProdSmem& sm, int seq) {
  const int begin = item_begin(P, blockIdx.x), end = item_begin(P, blockIdx.x + 1);
  Cursor cons{begin, 0};
  if (cons.it >= end) return;  // no item: nothing to set up
  product_setup(p, P, sm);
  MEGA_MARK(seq, 0);
  const int nst = P.rows / i4s::kStageRows, ncols = (P.kind == kGU ? 2 : 1) * P.N;
  i4s::Acc<MT8, kTileN> acc;
  while (cons.it < end) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this stage landed for every thread; the slot issued next is free
    issue(P, R);
    cp_async_commit();
    const int tile = cons.it / P.chunks, chunk = cons.it % P.chunks;
    if (cons.st == 0) {
      i4s::zero_acc<MT8, kTileN>(acc);
      stage_rows<MT8>(p, P, sm, chunk * P.rows, P.rows);
      __syncthreads();
      MEGA_MARK(seq, 1);
    }
    i4s::consume_stage<MT8, bf16, false, kTileN>(R.buf + (R.consumed++ % kStages) * kStageBytes, sm.xs,
                                                 cons.st * 2, acc);
    if (++cons.st == nst) {  // the item's last stage: its partial
      MEGA_MARK(seq, 2);
      const int2 tc = tile_cols(P, tile);
      float* ws = p.ws[P.kind] + (long)chunk * p.b * ncols + tc.y + tc.x;
      const int valid = P.N - tc.x;
      i4s::store_acc<MT8, kTileN>(acc, [&](int m, int col, float4 v) {
        if (m < p.b && col < valid) *reinterpret_cast<float4*>(ws + (long)m * ncols + col) = v;
      });
      if (cons.it + 1 == end || (cons.it + 1) / P.chunks != tile) {
        // The block's last item of this tile: the tile's barrier, for all of
        // the block's chunks of it at once, then their units.
        const int first = max(begin, tile * P.chunks) - tile * P.chunks;  // its first chunk of the tile
        // The b = 1 rotation, for a block that finishes q or k heads after
        // its last item: copied into the ring (every stage of it consumed,
        // none in flight) while the block waits at the tile's barrier.
        const bool stage_r = P.kind == kQKV && p.rope_r != nullptr && cons.it + 1 == end &&
                             first < p.b * (min(kTileN, valid) / kSub);
        if (stage_r) {
          __syncthreads();  // every warp is done with the ring's last stage
          for (int i = threadIdx.x; i < kHd * kHd / 4; i += kThreads)
            cp_async_16(R.buf + i * 16, p.rope_r + i * 4, true);
          cp_async_commit();
        }
        tile_sync(p, P, tile, chunk - first + 1);
        if (stage_r) {
          cp_async_wait<0>();
          __syncthreads();
        }
        MEGA_MARK(seq, 3);
        for (int c = first; c <= chunk; ++c)
          finish_units(p, P, sm, tile, c, stage_r ? reinterpret_cast<const float*>(R.buf) : nullptr);
        MEGA_MARK(seq, 4);
      }
      cons.st = 0;
      ++cons.it;
    }
  }
}

// ---------------------------------------------------------------------------
// Attention
// ---------------------------------------------------------------------------

// One (slot, q head, key split) item: the roped, scaled q and the roped k and
// v of the current token from the qkv phase, and an online softmax over the
// split's cached keys (`split_counts` deals the keys of all slots evenly over
// the items). Each warp takes groups of 4 keys (K and V rows read as 256
// contiguous bytes a warp); the block merges its warps in order. Writes the
// split's (m, l, acc).
__device__ void attention(const MegaParams& p, int l, const ProdSmem& sm, int seq) {
  const int h = p.h, hkv = p.hkv, gq = h / hkv, n_q = h * kHd, n_qkv = (h + 2 * hkv) * kHd;
  const int *sn = sm.sn, *spre = sm.spre;  // the key splits (the kernel's start)
  float* sq = reinterpret_cast<float*>(sm.xs);  // [hd] roped, scaled q
  float* sk = sq + kHd;                    // [hd] roped k
  float* vcur = sk + kHd;                  // [hd] v
  float* wm = vcur + kHd;                  // [kWarps]
  float* wl = wm + kWarps;                 // [kWarps]
  float* wacc = wl + kWarps;               // [kWarps][hd]
  float* sred = wacc + kWarps * kHd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int items = spre[p.b];
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    int r = 0;
    while (spre[r + 1] <= it) ++r;
    const int n = sn[r], qh = (it - spre[r]) / n, split = (it - spre[r]) % n, hk = qh / gq;
    for (int t = threadIdx.x; t < 3 * kHd; t += kThreads) {  // sq, sk, vcur are consecutive
      const int which = t / kHd, j = t % kHd;
      const int col = which == 0 ? qh * kHd + j : n_q + (which == 1 ? hk : hkv + hk) * kHd + j;
      sq[t] = __ldcg(p.qkv + (long)r * n_qkv + col);
    }
    __syncthreads();
    MEGA_MARK(seq, 0);
    const float s0 = block_sum(threadIdx.x < kHd ? sq[threadIdx.x] * sk[threadIdx.x] : 0.f, sred);

    const int2 win = key_window(p, r);
    const int span = (win.y - win.x + n - 1) / n;
    const int start = win.x + split * span, end = min(start + span, win.y);
    const bool seed = split == 0 && warp == 0;
    float m = seed ? s0 : kNegBig, lsum = seed ? 1.f : 0.f;
    float acc[4], qb[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc[c] = seed ? vcur[lane * 4 + c] : 0.f;
      qb[c] = round_bf16(sq[lane * 4 + c]);  // the cache's dtype
    }
    const long head = (((long)l * p.b + r) * hkv + hk) * p.S;
    for (int t = start + warp * 4; t < end; t += kWarps * 4) {
      const int nk = min(4, end - t);
      float kf[4][4], vf[4][4], s[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long row = head + t + min(u, nk - 1);  // past the split: a live row, masked below
        load_bf16x4(kf[u], p.k_cache + row * kHd + lane * 4);
        load_bf16x4(vf[u], p.v_cache + row * kHd + lane * 4);
      }
      float mt = kNegBig;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float d = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) d = fmaf(qb[c], kf[u][c], d);
        s[u] = warp_sum(d);
        if (u < nk) mt = fmaxf(mt, s[u]);
      }
      const float m_new = fmaxf(m, mt), alpha = expf(m - m_new);
      float psum = 0.f, pb[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float pu = u < nk ? expf(s[u] - m_new) : 0.f;
        psum += pu;
        pb[u] = round_bf16(pu);
      }
      lsum = lsum * alpha + psum;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float a = acc[c] * alpha;
#pragma unroll
        for (int u = 0; u < 4; ++u) a = fmaf(pb[u], vf[u][c], a);
        acc[c] = a;
      }
      m = m_new;
    }
    if (lane == 0) {
      wm[warp] = m;
      wl[warp] = lsum;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) wacc[warp * kHd + lane * 4 + c] = acc[c];
    __syncthreads();
    if (threadIdx.x < kHd) {
      float mm = kNegBig;
      for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, wm[w]);
      float ll = 0.f, aa = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        const float e = expf(wm[w] - mm);
        ll += wl[w] * e;
        aa += wacc[w * kHd + threadIdx.x] * e;
      }
      const long o = ((long)r * h + qh) * p.nsplit + split;
      p.att_acc[o * kHd + threadIdx.x] = aa;
      if (threadIdx.x == 0) {
        p.att_m[o] = mm;
        p.att_l[o] = ll;
      }
    }
    __syncthreads();
    MEGA_MARK(seq, 2);
  }
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// Floats of the x buffer: the largest staged chunk, the finishing scratch
// (two heads and their warp sums), the o projection's staged chunk and split
// products, the attention scratch and the splits' l.
__host__ __device__ inline int xs_floats(const MegaParams& p, int mt8) {
  int rows = 0;
  for (int k = 0; k < 4; ++k) rows = max(rows, p.rows[k]);
  const int attn = 3 * kHd + 2 * kWarps + kWarps * kHd + kWarps;
  const int finish = 2 * kSub + 8, merge = i4s::x_words(p.rows[kO], mt8) + kMergeFloats;
  return max(max(max(i4s::x_words(rows, mt8), finish), merge), max(attn, p.b * p.h * p.nsplit));
}

size_t smem_bytes(const MegaParams& p, int mt8) {
  const int floats = xs_floats(p, mt8) + p.b * p.h * p.nsplit + p.b * p.h + 32 + 65;
  return (size_t)kStages * kStageBytes + (size_t)floats * 4;
}

template <int MT8>
__global__ void __launch_bounds__(kThreads, MT8 <= 2 ? 2 : 1) mega_kernel(const MegaParams p) {
  extern __shared__ __align__(16) uint8_t smem[];
  ProdSmem sm;
  sm.xs = reinterpret_cast<uint32_t*>(smem + kStages * kStageBytes);
  sm.swt = reinterpret_cast<float*>(sm.xs) + xs_floats(p, MT8);
  sm.sll = sm.swt + p.b * p.h * p.nsplit;
  sm.sinv = sm.sll + p.b * p.h;
  sm.sn = reinterpret_cast<int*>(sm.sinv + 32);
  sm.spre = sm.sn + 32;
  Ring R{smem, 0, 0, Cursor{0, 0}, 0};
  int seq = 0;
#ifdef MLLM_MEGA_STAMPS
  if (threadIdx.x == 0) {
    const unsigned long long t = global_ns();
    stamp(0, 0, t);
    stamp(0, 1, t);
  }
#endif
  // Before the first layer: the attention's key splits (the same in every
  // layer), the tile counters zeroed, the residual stream and its heads' sums
  // of squares.
  split_counts(p, sm.sn, sm.spre);
  if (blockIdx.x == 0) {
    const int counts[4] = {tiles_of((p.h + 2 * p.hkv) * kHd), tiles_of(p.d), 2 * tiles_of(p.ff), tiles_of(p.d)};
    for (int k = 0; k < 4; ++k)
      for (int i = threadIdx.x; i < counts[k]; i += kThreads) p.counters[k][i] = 0u;
  }
  {
    float* sv = reinterpret_cast<float*>(sm.xs);
    const int tiles = p.d / kSub;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      for (int i = threadIdx.x; i < p.b * kSub; i += kThreads) {
        const long o = (long)(i / kSub) * p.d + tile * kSub + i % kSub;
        const float v = __ldg(p.x + o);
        p.x_res[o] = v;
        sv[i] = v;
      }
      __syncthreads();
      sumsq_heads(sv, p.b, kSub, p.ss, tiles, tile);
      __syncthreads();
    }
  }
  prime(make_prod(p, kQKV, 0), R, seq);
  grid_sync(p.bar, seq);
  for (int l = 0; l < p.L; ++l) {
    product<MT8>(p, make_prod(p, kQKV, l), R, sm, seq);
    prime(make_prod(p, kO, l), R, seq);
    grid_sync(p.bar, seq);
    attention(p, l, sm, seq);
    grid_sync(p.bar, seq);
    product<MT8>(p, make_prod(p, kO, l), R, sm, seq);
    prime(make_prod(p, kGU, l), R, seq);
    grid_sync(p.bar, seq);
    product<MT8>(p, make_prod(p, kGU, l), R, sm, seq);
    prime(make_prod(p, kDown, l), R, seq);
    grid_sync(p.bar, seq);
    product<MT8>(p, make_prod(p, kDown, l), R, sm, seq);
    if (l + 1 < p.L) {
      prime(make_prod(p, kQKV, l + 1), R, seq);
      grid_sync(p.bar, seq);
    }
  }
  cp_async_wait<0>();
#ifdef MLLM_MEGA_STAMPS
  __syncthreads();
  if (threadIdx.x == 0) stamp(seq + 1, 0, global_ns());
#endif
}

template <int MT8>
cudaError_t launch(const MegaParams& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p, MT8);
  cudaError_t err = cudaFuncSetAttribute(mega_kernel<MT8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mega_kernel<MT8>, kThreads, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const dim3 grid(min(per_sm, 2) * sms);
  if ((err = cudaMemsetAsync(p.bar, 0, 2 * sizeof(unsigned), stream)) != cudaSuccess) return err;
  void* args[] = {const_cast<MegaParams*>(&p)};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(mega_kernel<MT8>), grid, dim3(kThreads), args,
                                     smem, stream);
}

bool valid(const MegaParams& p) {
  const int n_q = p.h * kHd;
  auto divides = [](int rows, int khalf) { return rows >= 32 && rows % 32 == 0 && khalf % rows == 0; };
  return p.b >= 1 && p.b <= 32 && p.hkv >= 1 && p.h % p.hkv == 0 && p.d % 256 == 0 && p.ff % 128 == 0 &&
         p.group_a > 0 && p.group_a % 32 == 0 && (p.d / 2) % p.group_a == 0 && (n_q / 2) % p.group_a == 0 &&
         p.group_d > 0 && p.group_d % 32 == 0 && p.block_f > 0 && p.ff % p.block_f == 0 &&
         (p.block_f / 2) % 32 == 0 && (p.block_f / 2) % p.group_d == 0 && p.nsplit >= 1 &&
         p.act >= kSilu && p.act <= kRelu && divides(p.rows[kQKV], p.d / 2) && divides(p.rows[kO], n_q / 2) &&
         divides(p.rows[kGU], p.d / 2) && divides(p.rows[kDown], p.ff / 2) &&
         (p.rope_r != nullptr || (p.cos != nullptr && p.sin != nullptr));
}

cudaError_t dispatch(const MegaParams& p, cudaStream_t stream) {
  if (!valid(p)) return cudaErrorInvalidValue;
  if (p.b <= 8) return launch<1>(p, stream);
  if (p.b <= 16) return launch<2>(p, stream);
  return launch<4>(p, stream);
}

// The workspace, carved from one f32 buffer in the wrapper's order
// (`decode_step_workspace` in ops/decode_step.py).
void carve(MegaParams& p, float* ws) {
  const int n_q = p.h * kHd, n_qkv = (p.h + 2 * p.hkv) * kHd;
  auto take = [&ws](long n) {
    float* out = ws;
    ws += (n + 3) / 4 * 4;  // keep every piece 16-byte aligned
    return out;
  };
  p.x_res = take((long)p.b * p.d);
  p.ss = take((long)p.b * (p.d / kSub));
  p.qkv = take((long)p.b * n_qkv);
  p.gu = take((long)p.b * 2 * p.ff);
  p.ws[kQKV] = take((long)(p.d / 2 / p.rows[kQKV]) * p.b * n_qkv);
  p.ws[kO] = take((long)(n_q / 2 / p.rows[kO]) * p.b * p.d);
  p.ws[kGU] = take((long)(p.d / 2 / p.rows[kGU]) * p.b * 2 * p.ff);
  p.ws[kDown] = take((long)(p.ff / 2 / p.rows[kDown]) * p.b * p.d);
  p.att_m = take((long)p.b * p.h * p.nsplit);
  p.att_l = take((long)p.b * p.h * p.nsplit);
  p.att_acc = take((long)p.b * p.h * p.nsplit * kHd);
  p.counters[kQKV] = reinterpret_cast<unsigned*>(take(tiles_of(n_qkv)));
  p.counters[kO] = reinterpret_cast<unsigned*>(take(tiles_of(p.d)));
  p.counters[kGU] = reinterpret_cast<unsigned*>(take(2 * tiles_of(p.ff)));
  p.counters[kDown] = reinterpret_cast<unsigned*>(take(tiles_of(p.d)));
  p.bar = reinterpret_cast<unsigned*>(take(4));
}

}  // namespace
}  // namespace mllm

// Both entry points return the CUDA error code of the launch (0 on success) and
// do not synchronise. `plan` holds rows_qkv, rows_o, rows_gu, rows_d (packed rows
// per product chunk: multiples of 32 dividing each product's K/2) and nsplit
// (key splits per (slot, q head)); `ws` is the f32 workspace of
// `decode_step_workspace` in ops/decode_step.py. Every pointer is 16-byte
// aligned; scales are bf16, in groups that are multiples of 32; qkv_b may be
// null. head_dim is 128.
#define MLLM_MEGA_COMMON_ARGS                                                                          \
  const void *qkv_q, const void *qkv_s, const void *qkv_b, const void *o_q, const void *o_s,           \
      const void *g_q, const void *g_s, const void *u_q, const void *u_s, const void *d_q,             \
      const void *d_s, const void *n1, const void *n2, const void *k_cache, const void *v_cache,       \
      void *y, void *k_new, void *v_new, void *ws, const int *plan, int L, int d, int ff, int h,       \
      int hkv, int S, int group_a, int group_d, int block_f, int act, float eps, float rm, float scale, \
      void *stream

namespace {

mllm::MegaParams common(const void* x, int b, MLLM_MEGA_COMMON_ARGS) {
  using namespace mllm;
  MegaParams p{};
  p.x = static_cast<const float*>(x);
  p.qkv_q = static_cast<const uint8_t*>(qkv_q);
  p.o_q = static_cast<const uint8_t*>(o_q);
  p.g_q = static_cast<const uint8_t*>(g_q);
  p.u_q = static_cast<const uint8_t*>(u_q);
  p.d_q = static_cast<const uint8_t*>(d_q);
  p.qkv_s = static_cast<const bf16*>(qkv_s);
  p.o_s = static_cast<const bf16*>(o_s);
  p.g_s = static_cast<const bf16*>(g_s);
  p.u_s = static_cast<const bf16*>(u_s);
  p.d_s = static_cast<const bf16*>(d_s);
  p.qkv_b = static_cast<const float*>(qkv_b);
  p.n1 = static_cast<const float*>(n1);
  p.n2 = static_cast<const float*>(n2);
  p.k_cache = static_cast<const bf16*>(k_cache);
  p.v_cache = static_cast<const bf16*>(v_cache);
  p.y = static_cast<float*>(y);
  p.k_new = static_cast<float*>(k_new);
  p.v_new = static_cast<float*>(v_new);
  p.L = L;
  p.b = b;
  p.d = d;
  p.ff = ff;
  p.h = h;
  p.hkv = hkv;
  p.S = S;
  p.group_a = group_a;
  p.group_d = group_d;
  p.block_f = block_f;
  p.act = act;
  for (int k = 0; k < 4; ++k) p.rows[k] = plan[k];
  p.nsplit = plan[4];
  p.eps = eps;
  p.rm = rm;
  p.scale = scale;
  return p;
}

}  // namespace

// b = 1: x [1, d] f32, rope_r [128, 128] f32, keys kv_start <= t < pos visible;
// pos_dev, a device int32, is read in place of pos when it is not null (a
// captured loop's write head; the body reads the one-entry pos_vec).
extern "C" int mllm_fused_decode_step_bf16(const void* x, const void* rope_r, const void* pos_dev, int pos,
                                           int kv_start, MLLM_MEGA_COMMON_ARGS) {
  using namespace mllm;
  MegaParams p = common(x, 1, qkv_q, qkv_s, qkv_b, o_q, o_s, g_q, g_s, u_q, u_s, d_q, d_s, n1, n2, k_cache,
                        v_cache, y, k_new, v_new, ws, plan, L, d, ff, h, hkv, S, group_a, group_d, block_f,
                        act, eps, rm, scale, stream);
  p.rope_r = static_cast<const float*>(rope_r);
  p.pos_vec = static_cast<const int*>(pos_dev);
  p.pos = pos;
  p.kv_start = kv_start;
  carve(p, static_cast<float*>(ws));
  return static_cast<int>(dispatch(p, static_cast<cudaStream_t>(stream)));
}

// b <= 32: x [b, d] f32, cos/sin [b, 64] f32 at each slot's position; pos_vec /
// kvs_vec int32 [b] per slot, or null for the scalars pos / kv_start.
extern "C" int mllm_fused_decode_step_batched_bf16(const void* x, const void* cos, const void* sin,
                                                   const void* pos_vec, const void* kvs_vec, int pos,
                                                   int kv_start, int b, MLLM_MEGA_COMMON_ARGS) {
  using namespace mllm;
  MegaParams p = common(x, b, qkv_q, qkv_s, qkv_b, o_q, o_s, g_q, g_s, u_q, u_s, d_q, d_s, n1, n2, k_cache,
                        v_cache, y, k_new, v_new, ws, plan, L, d, ff, h, hkv, S, group_a, group_d, block_f,
                        act, eps, rm, scale, stream);
  p.cos = static_cast<const float*>(cos);
  p.sin = static_cast<const float*>(sin);
  p.pos_vec = static_cast<const int*>(pos_vec);
  p.kvs_vec = static_cast<const int*>(kvs_vec);
  p.pos = pos;
  p.kv_start = kv_start;
  carve(p, static_cast<float*>(ws));
  return static_cast<int>(dispatch(p, static_cast<cudaStream_t>(stream)));
}

#ifdef MLLM_MEGA_STAMPS
// The stamped build only: stamps [cap][1024][16] u64 (device), or null to stop.
extern "C" int mllm_mega_stamps(void* stamps, int cap) {
  cudaError_t err = cudaMemcpyToSymbol(mllm::g_stamps, &stamps, sizeof(stamps));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(mllm::g_stamp_cap, &cap, sizeof(cap));
  return static_cast<int>(err);
}
#endif
