// int8 weight-only matrix product for Hopper: y = (x @ q) * s, f32 out.
//
// Replaces: mllm_tpu/ops/quant_matmul.py, `int8_matmul` (Pallas kernel `_int8_kernel`).
//
// What it computes: y[m, n] = s[n] * sum_k bf16(x[m, k]) * q[k, n], with q int8
// [K, N] (k-major, as `repack_float_to_int8` and `_q8_device` store it) and s f32
// [N]; the sum is taken in f32. Every int8 value converts to bf16 exactly, so the
// products are those of the Pallas kernel.
//
// What bounds it on this card: at decode (m = 1..8) each weight byte is read once
// for 2m FLOPs, so the product is bound by HBM, at half the bytes of bf16. At
// prefill (m in the hundreds or thousands) it is bound by matrix math.
//
// What the design does about it:
//  - One kernel for every m: bf16 mma.sync m16n8k16 tiles with f32 accumulation.
//    The int8 tile is converted to bf16 while it is staged from registers into
//    shared memory, and the next tile's global loads are issued before the
//    current tile's products, so one tile is always in flight.
//  - A block owns 16 * MT rows (MT = 1 at decode, 4 otherwise) by 128 columns;
//    each of its four warps owns 32 of the columns for all the rows.
//  - Decode outputs have few column tiles (16 at N = 2048), so the K axis is
//    split across blocks until the grid holds about two blocks per SM. The
//    partial sums go to a workspace and `sum_splits` adds them in split order
//    and applies the scale (deterministic, no atomics).
//  - The TPU kernel's (256, 512, 512) VMEM blocks and its sequential k grid axis
//    do not carry over: tiles are small and k is a loop inside the block.
#include "common.cuh"

namespace mllm {
namespace {

constexpr int kBN = 128;  // columns per block
constexpr int kBK = 64;   // k depth of a tile
constexpr int kThreads = 128;
constexpr int kLdsA = kBK + 8;  // padded shared rows (bf16 elements): conflict-free ldmatrix
constexpr int kLdsB = kBN + 8;

struct Int8Params {
  const bf16* x;      // [M, K]
  const int8_t* q;    // [K, N]
  const float* s;     // [N]
  float* out;         // [M, N], written scaled when the grid has one split
  float* ws;          // [splits, M, N] unscaled partial sums otherwise
  int M, K, N;
  int kt_per_split;   // k tiles per split
};

// Sixteen int8 values -> sixteen bf16 values (exact), as two 16-byte words.
__device__ __forceinline__ void int8x16_to_bf16(const uint4& v, uint4& lo, uint4& hi) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&v);
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = pack_bf16x2((float)b[2 * i], (float)b[2 * i + 1]);
  lo = make_uint4(w[0], w[1], w[2], w[3]);
  hi = make_uint4(w[4], w[5], w[6], w[7]);
}

template <int MT>
__global__ void __launch_bounds__(kThreads) int8_mm_kernel(const Int8Params p) {
  constexpr int BM = 16 * MT;
  constexpr int kAChunks = BM * (kBK / 8) / kThreads;   // 16-byte chunks of x per thread
  constexpr int kBChunks = kBK * (kBN / 16) / kThreads;  // 16-byte chunks of q per thread
  static_assert(kAChunks >= 1 && kBChunks >= 1, "tile too small for the block");
  __shared__ __align__(16) bf16 sA[BM * kLdsA];
  __shared__ __align__(16) bf16 sB[kBK * kLdsB];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int k_tiles = (p.K + kBK - 1) / kBK;
  const int kt0 = blockIdx.z * p.kt_per_split;
  const int kt1 = min(kt0 + p.kt_per_split, k_tiles);

  uint4 ra[kAChunks], rb[kBChunks];
  auto load = [&](int kt) {
#pragma unroll
    for (int i = 0; i < kAChunks; ++i) {
      const int c = tid + i * kThreads, r = c / (kBK / 8), cc = c % (kBK / 8);
      const int row = m0 + r, col = kt * kBK + cc * 8;
      ra[i] = (row < p.M && col < p.K)
                  ? *reinterpret_cast<const uint4*>(p.x + (long)row * p.K + col)
                  : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < kBChunks; ++i) {
      const int c = tid + i * kThreads, r = c / (kBN / 16), cc = c % (kBN / 16);
      const int row = kt * kBK + r, col = n0 + cc * 16;
      rb[i] = (row < p.K && col < p.N)
                  ? __ldg(reinterpret_cast<const uint4*>(p.q + (long)row * p.N + col))
                  : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < kAChunks; ++i) {
      const int c = tid + i * kThreads, r = c / (kBK / 8), cc = c % (kBK / 8);
      *reinterpret_cast<uint4*>(sA + r * kLdsA + cc * 8) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < kBChunks; ++i) {
      const int c = tid + i * kThreads, r = c / (kBN / 16), cc = c % (kBN / 16);
      uint4 lo, hi;
      int8x16_to_bf16(rb[i], lo, hi);
      *reinterpret_cast<uint4*>(sB + r * kLdsB + cc * 16) = lo;
      *reinterpret_cast<uint4*>(sB + r * kLdsB + cc * 16 + 8) = hi;
    }
  };

  float acc[MT][4][4];  // [m tile][8-column tile of this warp][fragment]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  if (kt0 < kt1) load(kt0);
  for (int kt = kt0; kt < kt1; ++kt) {
    stage();
    __syncthreads();
    if (kt + 1 < kt1) load(kt + 1);  // in flight during this tile's products
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(af[mt], sA + (mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdsA + kk * 16 +
                                (lane >> 4) * 8);
#pragma unroll
      for (int nb2 = 0; nb2 < 2; ++nb2) {
        uint32_t bfr[4];
        ldmatrix_x4_trans(bfr, sB + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdsB +
                                   warp * 32 + nb2 * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16_16816(acc[mt][2 * nb2], af[mt], bfr[0], bfr[1]);
          mma_bf16_16816(acc[mt][2 * nb2 + 1], af[mt], bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();  // sA / sB are overwritten by the next tile
  }

  const int g = lane >> 2, tig = lane & 3;
  const bool direct = gridDim.z == 1;
  float* dst = direct ? p.out : p.ws + (long)blockIdx.z * p.M * p.N;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = n0 + warp * 32 + nt * 8 + tig * 2;
    if (col >= p.N) continue;
    const float s0 = direct ? p.s[col] : 1.f, s1 = direct ? p.s[col + 1] : 1.f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + mt * 16 + g + half * 8;
        if (row < p.M)
          *reinterpret_cast<float2*>(dst + (long)row * p.N + col) =
              make_float2(acc[mt][nt][2 * half] * s0, acc[mt][nt][2 * half + 1] * s1);
      }
    }
  }
}

template <int MT>
cudaError_t launch(const Int8Params& p, int splits, cudaStream_t stream) {
  const dim3 grid((p.N + kBN - 1) / kBN, (p.M + 16 * MT - 1) / (16 * MT), splits);
  int8_mm_kernel<MT><<<grid, kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return sum_splits(p.ws, p.s, p.out, p.M, p.N, splits, stream);
}

}  // namespace
}  // namespace mllm

// Returns the CUDA error code of the launches (0 on success). ws is
// [splits, M, N] f32 scratch when splits > 1 (null otherwise); mt is 1 or 4
// (16 or 64 rows of x per block). K % 8 == 0 and N % 16 == 0. The kernels do
// not synchronise.
extern "C" int mllm_int8_matmul_bf16(const void* x, const void* q, const void* s, void* out,
                                     void* ws, int M, int K, int N, int splits,
                                     int kt_per_split, int mt, void* stream) {
  using namespace mllm;
  const Int8Params p{static_cast<const bf16*>(x), static_cast<const int8_t*>(q),
                     static_cast<const float*>(s), static_cast<float*>(out),
                     static_cast<float*>(ws), M, K, N, kt_per_split};
  if (K % 8 != 0 || N % 16 != 0 || (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mt) {
    case 1: return launch<1>(p, splits, st);
    case 4: return launch<4>(p, splits, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
