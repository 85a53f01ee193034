// int4 weight-only matrix product for Hopper at decode shapes (m <= 32), f32 out.
//
// Replaces: mllm_tpu/ops/quant_matmul.py, `int4_matmul` (Pallas kernels
//   `_int4_gb_kernel`, affine, and `_int4_gb_kernel_sym`, symmetric).
//
// What it computes: y[m, n] = sum_k bf16(x[m, k]) * w[k, n] over the canonical
// planar layout of `prepare_int4`: packed row j < K/2 holds k = j in its low
// nibble and k = K/2 + j in its high nibble, rows [K/2, khp) are padding and are
// never read. Group g (32 rows) of the low half takes scale row g, of the high
// half scale row khp/32 + g. w = q * s + z (affine) or (q - 8) * s (symmetric,
// z = null), computed in f32 per weight; products and sums in f32.
//
// What bounds it on this card: one byte holds two weights and is used for 4m
// FLOPs, so at m = 1..8 the kernel is bound by HBM (a quarter of bf16's bytes).
// Towards m = 32 it becomes bound by the CUDA cores.
//
// What the design does about it:
//  - CUDA cores, no tensor cores: a thread owns four adjacent output columns
//    (one 4-byte load per packed row, 128 bytes a warp) and up to 16 rows of x,
//    and dequantizes each weight once for all its rows. m > 16 takes several
//    row tiles (grid z).
//  - The TPU kernel applies scales to per-group partial sums because its vector
//    unit set the pace; here the per-weight fma (q * s + z, z = -8 s when
//    symmetric) is one instruction, and the group sum of x that the Pallas
//    kernel takes in bf16 is not needed at all.
//  - The x values of one group (both halves) are staged in shared memory as
//    f32; the kernel reads the unpadded x [m, K] and maps indices itself, so the
//    padded x of the JAX wrapper is never built.
//  - o_proj has 1536 columns (6 blocks of 256), so the K axis is split across
//    blocks to about two blocks per SM; `sum_splits` adds the partial sums in
//    split order (deterministic, no atomics).
#include "common.cuh"

namespace mllm {
namespace {

constexpr int kGroup = 32;
constexpr int kThreads = 64;
constexpr int kCols = 4;                // output columns per thread
constexpr int kBN = kThreads * kCols;   // columns per block

struct Int4Params {
  const bf16* x;       // [M, K]
  const uint8_t* q;    // [khp, N] planar: excess-8 (symmetric) or raw 0..15 (affine) nibbles
  const float* s;      // [2 * khp / 32, N]
  const float* z;      // [2 * khp / 32, N], or null: symmetric
  float* out;          // [M, N] when the grid has one split
  float* ws;           // [splits, M, N] partial sums otherwise
  int M, K, N, khp;
  int groups_per_split;
};

template <int MT, bool kAffine>
__global__ void __launch_bounds__(kThreads) int4_mm_kernel(const Int4Params p) {
  __shared__ float sx[2][kGroup][MT];  // one group of x: [half][packed row][row of x]
  const int tid = threadIdx.x;
  const int n = blockIdx.x * kBN + tid * kCols;
  const int m0 = blockIdx.z * MT;
  const int khalf = p.K / 2, ngh = p.khp / kGroup;
  const int g0 = blockIdx.y * p.groups_per_split;
  const int g1 = min(g0 + p.groups_per_split, khalf / kGroup);
  const bool col_ok = n < p.N;

  float acc[MT][kCols];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;

  for (int g = g0; g < g1; ++g) {
    __syncthreads();  // the previous group's x is no longer read
    for (int i = tid; i < 2 * kGroup * MT; i += kThreads) {
      const int r = i / (2 * kGroup), h = (i / kGroup) % 2, j = i % kGroup;
      const int row = m0 + r;
      sx[h][j][r] = row < p.M ? __bfloat162float(p.x[(long)row * p.K + h * khalf + g * kGroup + j])
                              : 0.f;
    }
    __syncthreads();
    if (!col_ok) continue;
    float slo[kCols], shi[kCols], zlo[kCols], zhi[kCols];
    load_f32x4(slo, p.s + (long)g * p.N + n);
    load_f32x4(shi, p.s + (long)(ngh + g) * p.N + n);
    if (kAffine) {
      load_f32x4(zlo, p.z + (long)g * p.N + n);
      load_f32x4(zhi, p.z + (long)(ngh + g) * p.N + n);
    } else {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        zlo[c] = -8.f * slo[c];  // exact: fma(q, s, -8 s) rounds (q - 8) * s once
        zhi[c] = -8.f * shi[c];
      }
    }
    const uint8_t* qrow = p.q + (long)g * kGroup * p.N + n;
#pragma unroll 8
    for (int j = 0; j < kGroup; ++j) {
      const uint32_t b = __ldg(reinterpret_cast<const uint32_t*>(qrow + (long)j * p.N));
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const uint32_t byte = (b >> (8 * c)) & 0xffu;
        const float wl = fmaf((float)(byte & 0x0fu), slo[c], zlo[c]);
        const float wh = fmaf((float)(byte >> 4), shi[c], zhi[c]);
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          acc[r][c] = fmaf(sx[0][j][r], wl, acc[r][c]);
          acc[r][c] = fmaf(sx[1][j][r], wh, acc[r][c]);
        }
      }
    }
  }

  if (!col_ok) return;
  float* dst = gridDim.y == 1 ? p.out : p.ws + (long)blockIdx.y * p.M * p.N;
#pragma unroll
  for (int r = 0; r < MT; ++r) {
    const int row = m0 + r;
    if (row < p.M)
      *reinterpret_cast<float4*>(dst + (long)row * p.N + n) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

template <int MT, bool kAffine>
cudaError_t launch(const Int4Params& p, int splits, cudaStream_t stream) {
  const dim3 grid((p.N + kBN - 1) / kBN, splits, (p.M + MT - 1) / MT);
  int4_mm_kernel<MT, kAffine><<<grid, kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return sum_splits(p.ws, nullptr, p.out, p.M, p.N, splits, stream);
}

template <bool kAffine>
cudaError_t launch_rows(const Int4Params& p, int splits, int mt, cudaStream_t stream) {
  switch (mt) {
    case 1: return launch<1, kAffine>(p, splits, stream);
    case 2: return launch<2, kAffine>(p, splits, stream);
    case 4: return launch<4, kAffine>(p, splits, stream);
    case 8: return launch<8, kAffine>(p, splits, stream);
    case 16: return launch<16, kAffine>(p, splits, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace mllm

// Returns the CUDA error code of the launches (0 on success). z null selects
// the symmetric law. ws is [splits, M, N] f32 scratch when splits > 1 (null
// otherwise); each split covers groups_per_split groups of 32 packed rows. mt
// (1, 2, 4, 8 or 16) rows of x per block. K % 64 == 0, N % 4 == 0. The kernels
// do not synchronise.
extern "C" int mllm_int4_matmul_bf16(const void* x, const void* q, const void* s, const void* z,
                                     void* out, void* ws, int M, int K, int N, int khp,
                                     int splits, int groups_per_split, int mt, void* stream) {
  using namespace mllm;
  const Int4Params p{static_cast<const bf16*>(x), static_cast<const uint8_t*>(q),
                     static_cast<const float*>(s), static_cast<const float*>(z),
                     static_cast<float*>(out), static_cast<float*>(ws),
                     M, K, N, khp, groups_per_split};
  if (K % (2 * kGroup) != 0 || N % 4 != 0 || khp < K / 2 || (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(z != nullptr ? launch_rows<true>(p, splits, mt, st)
                                       : launch_rows<false>(p, splits, mt, st));
}
