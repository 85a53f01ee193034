// The int4 weight stream shared by int4_matmul.cu, fused_int4_mlp.cu and
// decode_step.cu: planar int4 weights on tensor cores, fed by a ring of
// 16-byte async copies.
//
// The canonical planar layout: packed row j of a weight [K/2 (or khp), N]
// holds two k of each column, in its low and its high nibble (k = j and
// k = K/2 + j for the planar products; two k half a slab apart for the
// block-planar down projection). The two lie in different scale groups, so
// the low nibbles of a byte feed one product and the high nibbles another,
// each accumulated on the tensor core in f32 over a ring stage of 32 packed
// rows; the scale multiplies each stage's partial once (and z times the
// stage's sum of x is added for the affine law). At group 32 a stage is a
// group; a larger group takes one scaled partial per stage, since holding one
// accumulator per group across stages would double the registers of the
// accumulators. The integers are exact in bf16, so every product of x and an
// integer is exact and only the f32 sums round: the TPU kernel's order,
// without its bf16 group sum of x.
//
// A block is kThreads = 256 threads, 8 warps, and works on a tile of TN output
// columns (a template argument: 512 in both kernels), so every packed row of a
// stage is read as TN contiguous bytes: HBM streams long runs of a row well,
// and 128-byte runs badly (PERF.md). Warp w takes the 32-column strips w,
// w + 8, ... and both 16-row k-steps of every ring stage of kStageRows = 32
// packed rows (so one stage never crosses a scale group when the group is a
// multiple of 32). The products run on mma.sync m16n8k16 with the dequantized
// weights as the 16-row operand (16 output columns) and x as the 8-column
// operand (8 rows of x, zeros past the real ones): up to 32 rows of x take
// four 8-row tiles and read every weight once.
//
// Fragments. An mma's 16 k "slots" may stand for any 16 k, as long as the two
// operands agree. Lane (g = lane / 4, t = lane % 4) takes the rows t, 4 + t,
// 8 + t and 12 + t of a 16-row k-step (slots 2t, 2t + 1, 2t + 8, 2t + 9) and
// the 4-byte word of columns 4g .. 4g + 3 of its strip from each: one 32-bit
// shared load a row, and 16 weights of each half from 4 loads. Of the two
// n-tiles of a strip, tile T's row g is column 4g + 2T and its row g + 8 is
// column 4g + 2T + 1. `prmt` pairs the bytes of two rows; a nibble ORed into
// the bf16 pattern of 128 (0x4300) is 128 + q exactly, and one bf16x2
// subtraction of 136 (symmetric: q - 8) or 128 (affine: q) finishes the
// conversion: no I2F. Rows of the staged tile are TN + 32 bytes apart, so the
// four rows a load instruction touches fall in distinct banks.
//
// x is staged once per chunk of packed rows, as bf16 pairs in the order the
// B fragments want them (`stage_x`): one 64-bit shared load gives a lane both
// registers of an 8-row tile of x.
#pragma once

#include "common.cuh"

namespace mllm {
namespace i4s {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStageRows = 32;  // packed rows per ring stage

// A staged row: TN bytes of weights and 32 of padding.
__host__ __device__ constexpr int row_bytes(int tn) { return tn + 32; }
__host__ __device__ constexpr int q_bytes(int tn) { return kStageRows * row_bytes(tn); }

// Bytes of one ring stage: the packed tile, then the low and the high half's
// scale row (and zero row) of the tile's columns.
template <typename S, bool kAffine, int TN>
__host__ __device__ constexpr int stage_bytes() {
  return q_bytes(TN) + (kAffine ? 4 : 2) * TN * (int)sizeof(S);
}

// u32 words of staged x for `rows` packed rows and MT8 tiles of 8 rows of x:
// [rows / 16 k-steps][2 halves][8 MT8 rows of x][8 words].
__host__ __device__ constexpr int x_words(int rows, int mt8) { return rows / 16 * 2 * 8 * mt8 * 8; }

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// Two nibbles (bits 0-3 and 16-19 of v after the mask) -> bf16x2 (q - bias).
template <bool kAffine>
__device__ __forceinline__ uint32_t nibbles_to_bf16x2(uint32_t v) {
  const uint32_t magic = (v & 0x000F000Fu) | 0x43004300u;  // 128 + q, exact
  const uint32_t bias = kAffine ? 0x43004300u : 0x43084308u;  // 128 or 136
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(magic), "r"(bias));
  return d;
}

// Two int8 values (bits 0-7 and 16-23 of v; the other bits are ignored) ->
// bf16x2, exactly and without I2F: bf16 has an 8-bit significand, so the
// nibble trick above takes the low 7 bits, 0x4300 | (b & 0x7f) = 128 + (b & 0x7f),
// and the sign bit selects what is subtracted, 0x4300 | (b & 0x80) = 128 or
// 256 (the sign bit is bit 7 of both): b - 128 * sign, which every result is.
__device__ __forceinline__ uint32_t int8_to_bf16x2(uint32_t v) {
  const uint32_t magic = (v & 0x007F007Fu) | 0x43004300u;
  const uint32_t bias = (v & 0x00800080u) | 0x43004300u;
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(magic), "r"(bias));
  return d;
}

// ---------------------------------------------------------------------------
// Producer: one ring stage by 16-byte (or, for N % 16 != 0, 4-byte) cp.async
// ---------------------------------------------------------------------------

// 16-byte global -> shared copy that asks L2 to fetch the whole 256-byte
// block around it: the weights are read in runs of TN bytes, and the larger
// DRAM requests stream them faster. Zero-fills (no global read) when !valid.
__device__ __forceinline__ void cp_async_16_pf(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

// The 32 packed rows at q (row 0, column n0 already applied; rows N bytes
// apart) and the low / high scale (and zero) rows of the same columns; ncols
// <= TN columns exist, the others are zero-filled. Every thread of the block
// calls it; the caller commits the group.
template <typename S, bool kAffine, int TN>
__device__ __forceinline__ void issue_stage(uint8_t* stage, const uint8_t* q, long N, int ncols,
                                            const S* s_lo, const S* s_hi, const S* z_lo, const S* z_hi) {
  constexpr int RB = row_bytes(TN);
  const int tid = threadIdx.x;
  if (N % 16 == 0) {
    for (int i = tid; i < kStageRows * (TN / 16); i += kThreads) {
      const int r = i / (TN / 16), c = (i % (TN / 16)) * 16;
      cp_async_16_pf(stage + r * RB + c, q + r * N + c, c < ncols);
    }
  } else {
    for (int i = tid; i < kStageRows * (TN / 4); i += kThreads) {
      const int r = i / (TN / 4), c = (i % (TN / 4)) * 4;
      cp_async_4(stage + r * RB + c, q + r * N + c, c < ncols);
    }
  }
  S* sc = reinterpret_cast<S*>(stage + q_bytes(TN));
  constexpr int per16 = 16 / sizeof(S);
  const int rows = kAffine ? 4 : 2;
  if ((N * (long)sizeof(S)) % 16 == 0) {
    for (int i = tid; i < rows * TN / per16; i += kThreads) {
      const int row = i / (TN / per16), c = (i % (TN / per16)) * per16;
      const S* src = row == 0 ? s_lo : row == 1 ? s_hi : row == 2 ? z_lo : z_hi;
      cp_async_16(sc + row * TN + c, src + c, c < ncols);
    }
  } else {
    for (int i = tid; i < rows * TN; i += kThreads) {  // one scale a thread, plain loads
      const int row = i / TN, c = i % TN;
      const S* src = row == 0 ? s_lo : row == 1 ? s_hi : row == 2 ? z_lo : z_hi;
      sc[row * TN + c] = c < ncols ? src[c] : S(0.f);
    }
  }
}

// ---------------------------------------------------------------------------
// x: staged as B-fragment pairs
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) { return pack_bf16x2(lo, hi); }

// xs[((ks * 2 + h) * 8 MT8 + m) * 8 + e]: word e = 2t holds (slot 2t, 2t + 1) =
// rows (t, 4 + t) of k-step ks, word 2t + 1 rows (8 + t, 12 + t); each word's
// low half is the first row. value(h, row, m) gives x (f32, rounded to bf16
// here) of half h at packed row `row` of the chunk for row m < mrows of x;
// rows [mrows, 8 MT8) are zero. The mrows real rows spread over every thread,
// four words (eight values) a thread loaded before any is stored, so their
// loads overlap. The block calls it together; the caller synchronises after.
template <int MT8, class F>
__device__ __forceinline__ void stage_x(uint32_t* xs, int rows, int mrows, F value) {
  constexpr int M = 8 * MT8;
  const int ksteps = rows / 16;
  const int pad = ksteps * 2 * (M - mrows) * 8;
  for (int i = threadIdx.x; i < pad; i += kThreads) {
    const int e = i % 8, m = mrows + (i / 8) % (M - mrows), kh = i / 8 / (M - mrows);
    xs[(kh * M + m) * 8 + e] = 0u;
  }
  const int n = ksteps * 2 * mrows * 8;
  for (int i0 = threadIdx.x; i0 < n; i0 += 4 * kThreads) {
    float v[4][2];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kThreads < n ? i0 + u * kThreads : i0;
      const int e = i % 8, m = (i / 8) % mrows, kh = i / 8 / mrows;
      const int r0 = (kh / 2) * 16 + e / 2 + (e % 2) * 8;
      v[u][0] = value(kh % 2, r0, m);
      v[u][1] = value(kh % 2, r0 + 4, m);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n) {
        const int e = i % 8, m = (i / 8) % mrows, kh = i / 8 / mrows;
        xs[(kh * M + m) * 8 + e] = pack_bf16(v[u][0], v[u][1]);
      }
    }
  }
}

// stage_x for x already in bf16 rows (int4_matmul, fused_int4_mlp): packed
// row j0 + r of half h for row m is x[m * ld + h * khalf + j0 + r]. One
// 16-byte load gives 8 consecutive rows r0 .. r0 + 7 (r0 = 0 or 8 of a k-step)
// of one (m, h), and prmt pairs them into the words e = 2i + r0 / 8 for i < 4.
// Every address is a multiple of 8 elements (ld, khalf, j0 are), so x must be
// 16-byte aligned.
template <int MT8>
__device__ __forceinline__ void stage_x_bf16(uint32_t* xs, int rows, int mrows, const bf16* x, long ld, int khalf,
                                             int j0) {
  constexpr int M = 8 * MT8;
  const int ksteps = rows / 16;
  const int pad = ksteps * 2 * (M - mrows) * 8;
  for (int i = threadIdx.x; i < pad; i += kThreads) {
    const int e = i % 8, m = mrows + (i / 8) % (M - mrows), kh = i / 8 / (M - mrows);
    xs[(kh * M + m) * 8 + e] = 0u;
  }
  const int n = ksteps * 2 * 2 * mrows;  // 16-byte loads: (k-step, half, r0, m)
  for (int i0 = threadIdx.x; i0 < n; i0 += 4 * kThreads) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kThreads < n ? i0 + u * kThreads : i0;
      const int o = i % 2, m = (i / 2) % mrows, h = (i / 2 / mrows) % 2, ks = i / 2 / mrows / 2;
      v[u] = *reinterpret_cast<const uint4*>(x + m * ld + h * khalf + j0 + ks * 16 + 8 * o);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n) {
        const int o = i % 2, m = (i / 2) % mrows, kh = i / 2 / mrows;
        uint32_t* w = xs + (kh * M + m) * 8 + o;
        w[0] = prmt(v[u].x, v[u].z, 0x5410u);  // rows (r0, r0 + 4)
        w[2] = prmt(v[u].x, v[u].z, 0x7632u);  // (r0 + 1, r0 + 5)
        w[4] = prmt(v[u].y, v[u].w, 0x5410u);  // (r0 + 2, r0 + 6)
        w[6] = prmt(v[u].y, v[u].w, 0x7632u);  // (r0 + 3, r0 + 7)
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Consumer
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  c[0] = c[1] = c[2] = c[3] = 0.f;
  mma_bf16_16816(c, a, b0, b1);
}

template <typename S>
__device__ __forceinline__ void load_s4(float (&d)[4], const S* p);

template <>
__device__ __forceinline__ void load_s4<float>(float (&d)[4], const float* p) {
  load_f32x4(d, p);
}

template <>
__device__ __forceinline__ void load_s4<bf16>(float (&d)[4], const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  d[0] = __low2float(a);
  d[1] = __high2float(a);
  d[2] = __low2float(b);
  d[3] = __high2float(b);
}

// The accumulator of a warp: acc[sp][T][mt][c] is column
// 32 (warp + 8 sp) + 4g + 2T + c/2 of the tile, row 8 mt + 2t + c%2 of x.
template <int MT8, int TN>
using Acc = float[TN / 256][2][MT8][4];

template <int MT8, int TN>
__device__ __forceinline__ void zero_acc(Acc<MT8, TN>& acc) {
#pragma unroll
  for (int sp = 0; sp < TN / 256; ++sp)
#pragma unroll
    for (int T = 0; T < 2; ++T)
#pragma unroll
      for (int mt = 0; mt < MT8; ++mt) acc[sp][T][mt][0] = acc[sp][T][mt][1] = acc[sp][T][mt][2] = acc[sp][T][mt][3] = 0.f;
}

// One stage for this warp: its 32 packed rows (k-steps ks0 and ks0 + 1 of the
// staged x), both halves, its strips. The two k-steps of a half accumulate on
// the tensor core, and the stage's f32 product is scaled once (and z times the
// stage's sum of x added): a stage never crosses a scale group, so at group 32
// that is once a group.
template <int MT8, typename S, bool kAffine, int TN>
__device__ __forceinline__ void consume_stage(const uint8_t* stage, const uint32_t* xs, int ks0,
                                              Acc<MT8, TN>& acc) {
  constexpr int M = 8 * MT8, RB = row_bytes(TN);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const S* sc = reinterpret_cast<const S*>(stage + q_bytes(TN));
#pragma unroll
  for (int sp = 0; sp < TN / 256; ++sp) {
    const int col = (warp + 8 * sp) * 32 + 4 * g;
    uint32_t w[2][4];  // [k-step][rows t, 4 + t, 8 + t, 12 + t]
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[ks][i] = *reinterpret_cast<const uint32_t*>(stage + (ks * 16 + 4 * i + t) * RB + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s[4], z[4];
      load_s4<S>(s, sc + h * TN + col);
      if (kAffine) load_s4<S>(z, sc + (2 + h) * TN + col);
      uint32_t a[2][2][4];  // [k-step][T][reg] of this half
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int P = 0; P < 2; ++P)
#pragma unroll
          for (int T = 0; T < 2; ++T) {
            const uint32_t v = prmt(w[ks][2 * P], w[ks][2 * P + 1], T == 0 ? 0x5410u : 0x7632u);
            a[ks][T][2 * P] = nibbles_to_bf16x2<kAffine>(v >> (4 * h));
            a[ks][T][2 * P + 1] = nibbles_to_bf16x2<kAffine>(v >> (8 + 4 * h));
          }
#pragma unroll
      for (int mt = 0; mt < MT8; ++mt) {
        uint2 b[2];
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
          b[ks] = *reinterpret_cast<const uint2*>(xs + (((ks0 + ks) * 2 + h) * M + mt * 8 + g) * 8 + 2 * t);
        float gs0 = 0.f, gs1 = 0.f;  // the stage's sums of x for rows 8 mt + 2t, + 1 (affine)
        if (kAffine) {
          float part = 0.f;
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            const __nv_bfloat162 p0 = *reinterpret_cast<const __nv_bfloat162*>(&b[ks].x);
            const __nv_bfloat162 p1 = *reinterpret_cast<const __nv_bfloat162*>(&b[ks].y);
            part += (__low2float(p0) + __high2float(p0)) + (__low2float(p1) + __high2float(p1));
          }
          part += __shfl_xor_sync(0xffffffffu, part, 1);
          part += __shfl_xor_sync(0xffffffffu, part, 2);  // row 8 mt + g, in all 4 lanes of g
          gs0 = __shfl_sync(0xffffffffu, part, (2 * t) * 4);
          gs1 = __shfl_sync(0xffffffffu, part, (2 * t + 1) * 4);
        }
#pragma unroll
        for (int T = 0; T < 2; ++T) {
          float c[4];
          mma_16816(c, a[0][T], b[0].x, b[0].y);
          mma_bf16_16816(c, a[1][T], b[1].x, b[1].y);
          float* d = acc[sp][T][mt];
          // c[0], c[1]: column 4g + 2T; c[2], c[3]: column 4g + 2T + 1
          d[0] = fmaf(c[0], s[2 * T], d[0]);
          d[1] = fmaf(c[1], s[2 * T], d[1]);
          d[2] = fmaf(c[2], s[2 * T + 1], d[2]);
          d[3] = fmaf(c[3], s[2 * T + 1], d[3]);
          if (kAffine) {
            d[0] = fmaf(gs0, z[2 * T], d[0]);
            d[1] = fmaf(gs1, z[2 * T], d[1]);
            d[2] = fmaf(gs0, z[2 * T + 1], d[2]);
            d[3] = fmaf(gs1, z[2 * T + 1], d[3]);
          }
        }
      }
    }
  }
}

// store(m, col, v) once for every (row of x, 4 columns of the tile) this
// warp holds: v is a float4 of columns col .. col + 3 (col a multiple of 4),
// so a warp's stores of one row of x are 128 contiguous bytes.
template <int MT8, int TN, class F>
__device__ __forceinline__ void store_acc(const Acc<MT8, TN>& acc, F store) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int sp = 0; sp < TN / 256; ++sp)
#pragma unroll
    for (int mt = 0; mt < MT8; ++mt)
#pragma unroll
      for (int par = 0; par < 2; ++par)  // c = par, par + 2 of n-tiles T = 0, 1: columns 4g .. 4g + 3
        store(8 * mt + 2 * t + par, (warp + 8 * sp) * 32 + 4 * g,
              make_float4(acc[sp][0][mt][par], acc[sp][0][mt][par + 2], acc[sp][1][mt][par],
                          acc[sp][1][mt][par + 2]));
}

__device__ __forceinline__ unsigned ld_acquire_u32(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_timer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Thread 0 of a block: spins until *p >= target; five seconds of waiting is a
// lost arrival, which traps instead of hanging the card.
__device__ __forceinline__ void wait_count(const unsigned* p, unsigned target) {
  const unsigned long long t0 = global_timer_ns();
  while (ld_acquire_u32(p) < target) {
    __nanosleep(32);
    if (global_timer_ns() - t0 > 5000000000ull) __trap();
  }
}

// sum of p[i * stride] for i < n, in index order, through L2; the loads are
// issued sixteen at a time, so their latencies overlap.
__device__ __forceinline__ float ordered_sum(const float* p, long stride, int n) {
  float a = 0.f;
  int i = 0;
  for (; i + 16 <= n; i += 16) {
    float v[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) v[u] = __ldcg(p + (i + u) * stride);
#pragma unroll
    for (int u = 0; u < 16; ++u) a += v[u];
  }
  for (; i < n; ++i) a += __ldcg(p + i * stride);
  return a;
}

template <int KE, int U, class Off, class Out>
__device__ __forceinline__ void ordered_sums_t(const float* p, long stride, int chunks, int n, Off off, Out out) {
  for (int i0 = threadIdx.x; i0 < n; i0 += KE * kThreads) {
    float a[KE];
    long o[KE];
#pragma unroll
    for (int k = 0; k < KE; ++k) {
      a[k] = 0.f;
      o[k] = i0 + k * kThreads < n ? off(i0 + k * kThreads) : -1;
    }
    for (int c = 0; c < chunks; c += U) {
      float v[KE][U];
#pragma unroll
      for (int k = 0; k < KE; ++k)
#pragma unroll
        for (int u = 0; u < U; ++u)
          v[k][u] = c + u < chunks && o[k] >= 0 ? __ldcg(p + o[k] + (c + u) * stride) : 0.f;
#pragma unroll
      for (int k = 0; k < KE; ++k)
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (c + u < chunks) a[k] += v[k][u];
    }
#pragma unroll
    for (int k = 0; k < KE; ++k)
      if (o[k] >= 0) out(i0 + k * kThreads, a[k]);
  }
}

// For every i < n (spread over the block's threads): out(i, the sum of
// p[off(i) + c * stride] over c < chunks, added in c order), through L2. A
// thread keeps 32 loads in flight: its (up to 8) sums times as many chunks
// as make 32, so a finishing block waits for few round trips whatever the
// shape.
template <class Off, class Out>
__device__ __forceinline__ void ordered_sums(const float* p, long stride, int chunks, int n, Off off, Out out) {
  const int ke = (n + kThreads - 1) / kThreads;
  if (ke <= 1) ordered_sums_t<1, 32>(p, stride, chunks, n, off, out);
  else if (ke <= 2) ordered_sums_t<2, 16>(p, stride, chunks, n, off, out);
  else if (ke <= 4) ordered_sums_t<4, 8>(p, stride, chunks, n, off, out);
  else ordered_sums_t<8, 4>(p, stride, chunks, n, off, out);
}

}  // namespace i4s
}  // namespace mllm
