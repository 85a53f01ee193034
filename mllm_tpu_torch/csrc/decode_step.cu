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
// bf16 scales [L, ff/Gd, N]. Each weight dequantizes as (q - 8) * s in f32 and
// every product sums in f32, so the Pallas kernel's bf16 group sum of x has no
// counterpart here.
//
// What bounds it on this card: the weight stream. At the Qwen2-VL-2B geometry
// a step reads 694 MB of int4 weights and bf16 scales (24.8 MB a layer) for
// about 2 FLOPs a weight per sequence, so at b <= 32 it is bound by HBM
// (0.21 ms at 3.35 TB/s), plus the live KV rows. What the eager path pays
// instead is ~1600 launches a step.
//
// What the design does about it (simple and right first; speed is later work):
//  - One cooperative launch of a persistent grid (every block resident:
//    occupancy x SMs, at most two blocks an SM). The phases of a layer are
//    separated by a hand-written grid barrier (arrival counter + generation
//    word), so no -rdc device link is needed. The launch fails, and the
//    wrapper raises, if the grid cannot be resident; a barrier that waits more
//    than five seconds traps instead of hanging the card.
//  - Products: a work item is (128 output columns, a chunk of packed rows, up
//    to MT rows of x). A warp covers the 128 columns with one 4-byte load of
//    packed weights a lane per row (128 bytes a warp), the 8 warps of a block
//    take different packed rows, and the block adds its warps' sums in warp
//    order into one partial per chunk. The consumer of a product adds the
//    partials in chunk order: no float atomics, so results repeat exactly.
//  - Attention: an item is (slot, q head, key split). Each warp runs its own
//    online softmax over groups of 4 keys (K and V rows read as 256 contiguous
//    bytes a warp); the block merges its warps in order, and a separate phase
//    merges the splits in order and rounds the output to bf16.
//  - Activations that cross blocks (residual stream, normed input, qkv and
//    product partials, attention partials, the MLP hidden) live in a global
//    workspace. Everything written earlier in the same launch is read with
//    __ldcg (L2, never a stale L1 line); only inputs take __ldg.
#include "common.cuh"

namespace mllm {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileN = 128;  // output columns per product item: 32 lanes x 4
constexpr int kHd = 128;     // head_dim
constexpr int kMaxRows = 512;  // packed rows per product chunk, at most
constexpr unsigned long long kBarrierTimeoutNs = 5000000000ull;

struct Prod {
  const float* x;    // [b, K] activations (bf16-rounded values), written earlier in this launch
  const uint8_t* q;  // [K/2, N]
  const bf16* s;     // [K/G, N]
  float* ws;         // [K/2 / rows, b, N] partial products, one per chunk
  int K, N, G;
  int block_f;       // 0: planar over K; else block-planar with slabs of block_f
  int rows;          // packed rows per chunk (multiple of kWarps, divides K/2)
};

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
  float *x_res, *xn, *attn_o, *hmid;        // [b, d], [b, d], [b, n_q], [b, ff]
  float *ws_qkv, *ws_o, *ws_gu, *ws_d;      // product partials
  float *att_m, *att_l, *att_acc;           // [b, h, nsplit], same, [b, h, nsplit, hd]
  unsigned* bar;                            // [2]: arrivals, generation
  int L, b, d, ff, h, hkv, S, group_a, group_d, block_f, act;
  int rows_qkv, rows_o, rows_gu, rows_d, nsplit;
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

// Every block of the (co-resident) grid arrives before any leaves. The writes
// of all threads before the barrier are visible to all threads after it.
__device__ void grid_sync(unsigned* bar) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned* count = bar;
    unsigned* gen = bar + 1;
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

// k of the low and high nibble of packed row j.
__device__ __forceinline__ void row_ks(const Prod& p, int j, int& klo, int& khi) {
  if (p.block_f == 0) {
    klo = j;
    khi = j + p.K / 2;
  } else {
    const int fh = p.block_f / 2;
    klo = (j / fh) * p.block_f + j % fh;
    khi = klo + fh;
  }
}

// ws[chunk, r, n] = sum over the chunk's packed rows of x[r, k] * w[k, n].
template <int MT>
__device__ void product(const Prod& p, int b, float* smem) {
  const int khalf = p.K / 2;
  const int tiles = (p.N + kTileN - 1) / kTileN;
  const int chunks = khalf / p.rows;
  const int rchunks = (b + MT - 1) / MT;
  const int items = tiles * chunks * rchunks;
  float* xs = smem;                     // [rows][2][MT]
  float* red = xs + p.rows * 2 * MT;    // [kWarps][MT][kTileN]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int per_warp = p.rows / kWarps;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int tile = it % tiles;
    const int chunk = (it / tiles) % chunks;
    const int r0 = (it / tiles / chunks) * MT;
    const int j0 = chunk * p.rows;
    for (int i = threadIdx.x; i < p.rows * 2 * MT; i += kThreads) {
      const int r = i % MT, half = (i / MT) % 2, jj = i / (2 * MT);
      int klo, khi;
      row_ks(p, j0 + jj, klo, khi);
      const int k = half ? khi : klo;
      xs[i] = r0 + r < b ? __ldcg(p.x + (long)(r0 + r) * p.K + k) : 0.f;
    }
    __syncthreads();
    const int n = tile * kTileN + lane * 4;
    float acc[MT][4];
#pragma unroll
    for (int r = 0; r < MT; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
    if (n < p.N) {
#pragma unroll 4
      for (int jj = warp * per_warp; jj < (warp + 1) * per_warp; ++jj) {
        const int j = j0 + jj;
        int klo, khi;
        row_ks(p, j, klo, khi);
        const uint32_t bq = __ldg(reinterpret_cast<const uint32_t*>(p.q + (long)j * p.N + n));
        float slo[4], shi[4];
        load_bf16x4(slo, p.s + (long)(klo / p.G) * p.N + n);
        load_bf16x4(shi, p.s + (long)(khi / p.G) * p.N + n);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint32_t byte = (bq >> (8 * c)) & 0xffu;
          const float wl = (float)((int)(byte & 0x0fu) - 8) * slo[c];
          const float wh = (float)((int)(byte >> 4) - 8) * shi[c];
#pragma unroll
          for (int r = 0; r < MT; ++r) {
            acc[r][c] = fmaf(xs[(jj * 2) * MT + r], wl, acc[r][c]);
            acc[r][c] = fmaf(xs[(jj * 2 + 1) * MT + r], wh, acc[r][c]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < MT; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) red[(warp * MT + r) * kTileN + lane * 4 + c] = acc[r][c];
    __syncthreads();
    for (int i = threadIdx.x; i < MT * kTileN; i += kThreads) {
      const int r = i / kTileN, col = i % kTileN;
      const int nn = tile * kTileN + col;
      if (r0 + r < b && nn < p.N) {
        float sum = 0.f;
        for (int w = 0; w < kWarps; ++w) sum += red[(w * MT + r) * kTileN + col];
        p.ws[((long)chunk * b + r0 + r) * p.N + nn] = sum;
      }
    }
    __syncthreads();
  }
}

// Row r of the residual stream: x_res = x_in (layer 0) or x_res + rm * (sum of
// the partials in chunk order); then xn = bf16(rms(x_res) * w).
__device__ void residual_norm(const MegaParams& p, const float* x_in, const float* ws, int parts,
                              const float* w, float* smem) {
  float* sv = smem;          // [d]
  float* sred = sv + p.d;    // [kWarps]
  for (int r = blockIdx.x; r < p.b; r += gridDim.x) {
    float ss = 0.f;
    for (int k = threadIdx.x; k < p.d; k += kThreads) {
      float v;
      if (x_in != nullptr) {
        v = __ldg(x_in + (long)r * p.d + k);
      } else {
        float a = 0.f;
        for (int c = 0; c < parts; ++c) a += __ldcg(ws + ((long)c * p.b + r) * p.d + k);
        v = __ldcg(p.x_res + (long)r * p.d + k) + a * p.rm;
      }
      p.x_res[(long)r * p.d + k] = v;
      sv[k] = v;
      ss += v * v;
    }
    const float inv = rsqrtf(block_sum(ss, sred) / p.d + p.eps);
    for (int k = threadIdx.x; k < p.d; k += kThreads)
      p.xn[(long)r * p.d + k] = round_bf16(sv[k] * inv * __ldg(w + k));
    __syncthreads();
  }
}

// One (slot, q head, key split) item: q/k/v of the current token from the qkv
// partials, RoPE, and an online softmax over the split's cached keys. Writes the
// split's (m, l, acc) and, from the first q head of each kv head's first split,
// the layer's roped k and v.
__device__ void attention(const MegaParams& p, int l, float* smem) {
  const int h = p.h, hkv = p.hkv, gq = h / hkv, n_q = h * kHd, n_qkv = (h + 2 * hkv) * kHd;
  const int parts = p.d / 2 / p.rows_qkv;
  float* raw = smem;              // [3][hd]: q, k, v before RoPE
  float* sq = raw + 3 * kHd;      // [hd] roped, scaled q
  float* sk = sq + kHd;           // [hd] roped k
  float* wm = sk + kHd;           // [kWarps]
  float* wl = wm + kWarps;        // [kWarps]
  float* wacc = wl + kWarps;      // [kWarps][hd]
  float* sred = wacc + kWarps * kHd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int items = p.b * h * p.nsplit;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int split = it % p.nsplit, qh = (it / p.nsplit) % h, r = it / p.nsplit / h;
    const int hk = qh / gq;
    for (int t = threadIdx.x; t < 3 * kHd; t += kThreads) {
      const int which = t / kHd, j = t % kHd;
      const int col = which == 0 ? qh * kHd + j
                                 : n_q + (which == 1 ? hk : hkv + hk) * kHd + j;
      float a = 0.f;
      for (int c = 0; c < parts; ++c) a += __ldcg(p.ws_qkv + ((long)c * p.b + r) * n_qkv + col);
      if (p.qkv_b != nullptr) a += __ldg(p.qkv_b + (long)l * n_qkv + col);
      raw[t] = a;
    }
    __syncthreads();
    {
      const int which = threadIdx.x / kHd, j = threadIdx.x % kHd;  // 0: q, 1: k
      const float* xv = raw + which * kHd;
      float o;
      if (p.rope_r != nullptr) {
        o = 0.f;
        for (int i = 0; i < kHd; ++i) o = fmaf(xv[i], __ldg(p.rope_r + i * kHd + j), o);
      } else {
        const int half = kHd / 2, jj = j % half;
        const float c = __ldg(p.cos + r * half + jj), s = __ldg(p.sin + r * half + jj);
        o = j < half ? xv[j] * c + xv[j + half] * -s : xv[j] * c + xv[j - half] * s;
      }
      if (which == 0)
        sq[j] = o * p.scale;
      else
        sk[j] = o;
    }
    __syncthreads();
    const float* vcur = raw + 2 * kHd;
    if (split == 0 && qh % gq == 0 && threadIdx.x < kHd) {
      const long o = (((long)l * p.b + r) * hkv + hk) * kHd + threadIdx.x;
      p.k_new[o] = sk[threadIdx.x];
      p.v_new[o] = vcur[threadIdx.x];
    }
    const float s0 = block_sum(threadIdx.x < kHd ? sq[threadIdx.x] * sk[threadIdx.x] : 0.f, sred);

    // The wrappers range-check host windows; a window read from a device
    // vector is clamped to the head's rows [0, S), as the plain version's mask is.
    const int pos = min(p.pos_vec != nullptr ? p.pos_vec[r] : p.pos, p.S);
    const int kvs = max(p.kvs_vec != nullptr ? p.kvs_vec[r] : p.kv_start, 0);
    const int n_keys = max(0, pos - kvs);
    const int span = (n_keys + p.nsplit - 1) / p.nsplit;
    const int start = kvs + split * span, end = min(start + span, pos);
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
        if (u < nk) {
          load_bf16x4(kf[u], p.k_cache + (head + t + u) * kHd + lane * 4);
          load_bf16x4(vf[u], p.v_cache + (head + t + u) * kHd + lane * 4);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) kf[u][c] = vf[u][c] = 0.f;
        }
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
  }
}

// attn_o[r, qh*hd + j] = bf16(acc / l) over the splits, merged in split order.
__device__ void merge_splits(const MegaParams& p) {
  const int n_q = p.h * kHd;
  const long total = (long)p.b * n_q;
  for (long i = (long)blockIdx.x * kThreads + threadIdx.x; i < total; i += (long)gridDim.x * kThreads) {
    const long rh = i / kHd;  // r * h + qh
    const int j = i % kHd;
    const long base = rh * p.nsplit;
    float mm = kNegBig;
    for (int s = 0; s < p.nsplit; ++s) mm = fmaxf(mm, __ldcg(p.att_m + base + s));
    float ll = 0.f, aa = 0.f;
    for (int s = 0; s < p.nsplit; ++s) {
      const float e = expf(__ldcg(p.att_m + base + s) - mm);
      ll += __ldcg(p.att_l + base + s) * e;
      aa += __ldcg(p.att_acc + (base + s) * kHd + j) * e;
    }
    p.attn_o[i] = round_bf16(aa / ll);
  }
}

// hmid[r, f] = bf16(act(gate) * up), each the sum of its partials in chunk order.
__device__ void gated_hidden(const MegaParams& p) {
  const int parts = p.d / 2 / p.rows_gu;
  const long total = (long)p.b * p.ff, plane = (long)parts * p.b * p.ff;
  for (long i = (long)blockIdx.x * kThreads + threadIdx.x; i < total; i += (long)gridDim.x * kThreads) {
    float g = 0.f, u = 0.f;
    for (int c = 0; c < parts; ++c) {
      g += __ldcg(p.ws_gu + c * total + i);
      u += __ldcg(p.ws_gu + plane + c * total + i);
    }
    p.hmid[i] = round_bf16(activation(g, p.act) * u);
  }
}

template <int MT>
__global__ void __launch_bounds__(kThreads) mega_kernel(const MegaParams p) {
  extern __shared__ __align__(16) float smem[];
  const int n_q = p.h * kHd, n_qkv = (p.h + 2 * p.hkv) * kHd;
  const int d = p.d, ff = p.ff;
  const int parts_d = ff / 2 / p.rows_d, parts_o = n_q / 2 / p.rows_o;
  const int gu_parts = d / 2 / p.rows_gu;
  for (int l = 0; l < p.L; ++l) {
    residual_norm(p, l == 0 ? p.x : nullptr, p.ws_d, parts_d, p.n1 + (long)l * d, smem);
    grid_sync(p.bar);
    product<MT>(Prod{p.xn, p.qkv_q + (long)l * (d / 2) * n_qkv, p.qkv_s + (long)l * (d / p.group_a) * n_qkv,
                     p.ws_qkv, d, n_qkv, p.group_a, 0, p.rows_qkv}, p.b, smem);
    grid_sync(p.bar);
    attention(p, l, smem);
    grid_sync(p.bar);
    merge_splits(p);
    grid_sync(p.bar);
    product<MT>(Prod{p.attn_o, p.o_q + (long)l * (n_q / 2) * d, p.o_s + (long)l * (n_q / p.group_a) * d,
                     p.ws_o, n_q, d, p.group_a, 0, p.rows_o}, p.b, smem);
    grid_sync(p.bar);
    residual_norm(p, nullptr, p.ws_o, parts_o, p.n2 + (long)l * d, smem);
    grid_sync(p.bar);
    const long gu_off = (long)l * (d / 2) * ff, gus_off = (long)l * (d / p.group_a) * ff;
    product<MT>(Prod{p.xn, p.g_q + gu_off, p.g_s + gus_off, p.ws_gu, d, ff, p.group_a, 0, p.rows_gu},
                p.b, smem);
    product<MT>(Prod{p.xn, p.u_q + gu_off, p.u_s + gus_off, p.ws_gu + (long)gu_parts * p.b * ff, d, ff,
                     p.group_a, 0, p.rows_gu}, p.b, smem);
    grid_sync(p.bar);
    gated_hidden(p);
    grid_sync(p.bar);
    product<MT>(Prod{p.hmid, p.d_q + (long)l * (ff / 2) * d, p.d_s + (long)l * (ff / p.group_d) * d,
                     p.ws_d, ff, d, p.group_d, p.block_f, p.rows_d}, p.b, smem);
    grid_sync(p.bar);
  }
  const long total = (long)p.b * d;
  for (long i = (long)blockIdx.x * kThreads + threadIdx.x; i < total; i += (long)gridDim.x * kThreads) {
    const long r = i / d, k = i % d;
    float a = 0.f;
    for (int c = 0; c < parts_d; ++c) a += __ldcg(p.ws_d + (c * p.b + r) * d + k);
    p.y[i] = __ldcg(p.x_res + i) + a * p.rm;
  }
}

int smem_floats(const MegaParams& p, int mt) {
  const int rows = max(max(p.rows_qkv, p.rows_o), max(p.rows_gu, p.rows_d));
  const int prod = rows * 2 * mt + kWarps * mt * kTileN;
  const int norm = p.d + kWarps;
  const int attn = 5 * kHd + 2 * kWarps + kWarps * kHd + kWarps;
  return max(prod, max(norm, attn));
}

template <int MT>
cudaError_t launch(const MegaParams& p, cudaStream_t stream) {
  const size_t smem = (size_t)smem_floats(p, MT) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(mega_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mega_kernel<MT>, kThreads, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const dim3 grid(min(per_sm, 2) * sms);
  if ((err = cudaMemsetAsync(p.bar, 0, 2 * sizeof(unsigned), stream)) != cudaSuccess) return err;
  void* args[] = {const_cast<MegaParams*>(&p)};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(mega_kernel<MT>), grid, dim3(kThreads), args,
                                     smem, stream);
}

bool valid(const MegaParams& p) {
  const int n_q = p.h * kHd;
  auto divides = [](int rows, int khalf) { return rows >= 64 && rows <= kMaxRows && rows % kWarps == 0 &&
                                                  khalf % rows == 0; };
  return p.b >= 1 && p.b <= 32 && p.hkv >= 1 && p.h % p.hkv == 0 && p.d % 256 == 0 && p.ff % 128 == 0 &&
         p.group_a >= 1 && (p.d / 2) % p.group_a == 0 && (n_q / 2) % p.group_a == 0 && p.group_d >= 1 &&
         p.block_f % 2 == 0 && p.block_f > 0 && p.ff % p.block_f == 0 && (p.block_f / 2) % p.group_d == 0 &&
         p.nsplit >= 1 && p.act >= kSilu && p.act <= kRelu && divides(p.rows_qkv, p.d / 2) &&
         divides(p.rows_o, n_q / 2) && divides(p.rows_gu, p.d / 2) && divides(p.rows_d, p.ff / 2) &&
         (p.rope_r != nullptr || (p.cos != nullptr && p.sin != nullptr));
}

cudaError_t dispatch(const MegaParams& p, cudaStream_t stream) {
  if (!valid(p)) return cudaErrorInvalidValue;
  if (p.b == 1) return launch<1>(p, stream);
  if (p.b == 2) return launch<2>(p, stream);
  if (p.b <= 4) return launch<4>(p, stream);
  return launch<8>(p, stream);
}

// The workspace, carved from one f32 buffer in the wrapper's order.
void carve(MegaParams& p, float* ws) {
  const int n_q = p.h * kHd, n_qkv = (p.h + 2 * p.hkv) * kHd;
  auto take = [&ws](long n) {
    float* out = ws;
    ws += (n + 3) / 4 * 4;  // keep every piece 16-byte aligned
    return out;
  };
  p.x_res = take((long)p.b * p.d);
  p.xn = take((long)p.b * p.d);
  p.attn_o = take((long)p.b * n_q);
  p.hmid = take((long)p.b * p.ff);
  p.ws_qkv = take((long)(p.d / 2 / p.rows_qkv) * p.b * n_qkv);
  p.ws_o = take((long)(n_q / 2 / p.rows_o) * p.b * p.d);
  p.ws_gu = take(2L * (p.d / 2 / p.rows_gu) * p.b * p.ff);
  p.ws_d = take((long)(p.ff / 2 / p.rows_d) * p.b * p.d);
  p.att_m = take((long)p.b * p.h * p.nsplit);
  p.att_l = take((long)p.b * p.h * p.nsplit);
  p.att_acc = take((long)p.b * p.h * p.nsplit * kHd);
  p.bar = reinterpret_cast<unsigned*>(take(4));
}

}  // namespace
}  // namespace mllm

// Both entry points return the CUDA error code of the launch (0 on success) and
// do not synchronise. `plan` holds rows_qkv, rows_o, rows_gu, rows_d (packed rows
// per product chunk: multiples of 8, 64..512, dividing each product's K/2) and
// nsplit (key splits per (slot, q head)); `ws` is the f32 workspace of
// `decode_step_workspace` in ops/decode_step.py. Every pointer is 16-byte
// aligned; scales are bf16; qkv_b may be null. head_dim is 128.
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
  p.rows_qkv = plan[0];
  p.rows_o = plan[1];
  p.rows_gu = plan[2];
  p.rows_d = plan[3];
  p.nsplit = plan[4];
  p.eps = eps;
  p.rm = rm;
  p.scale = scale;
  return p;
}

}  // namespace

// b = 1: x [1, d] f32, rope_r [128, 128] f32, keys kv_start <= t < pos visible.
extern "C" int mllm_fused_decode_step_bf16(const void* x, const void* rope_r, int pos, int kv_start,
                                           MLLM_MEGA_COMMON_ARGS) {
  using namespace mllm;
  MegaParams p = common(x, 1, qkv_q, qkv_s, qkv_b, o_q, o_s, g_q, g_s, u_q, u_s, d_q, d_s, n1, n2, k_cache,
                        v_cache, y, k_new, v_new, ws, plan, L, d, ff, h, hkv, S, group_a, group_d, block_f,
                        act, eps, rm, scale, stream);
  p.rope_r = static_cast<const float*>(rope_r);
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
