// The second pass of the split-K products in int8_matmul.cu, int4_matmul.cu and
// fused_int4_mlp.cu: the partial sums of the blocks that shared one output
// tile are added in split order, and the per-column scale is applied.
//
// The TPU kernels carry their sum across the sequential k grid axis in VMEM.
// Blocks on the card run in no order, and f32 atomics would add in a different
// order on each run (greedy tokens could then change from run to run), so the
// partial sums go to a workspace and this kernel adds them.
#include "common.cuh"

namespace mllm {
namespace {

__global__ void sum_splits_kernel(const float4* __restrict__ ws, const float4* __restrict__ scale,
                                  float4* __restrict__ out, long n4, int cols4, int splits) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 acc = ws[i];
  for (int s = 1; s < splits; ++s) {
    const float4 v = ws[(long)s * n4 + i];
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  if (scale != nullptr) {
    const float4 c = scale[i % cols4];
    acc.x *= c.x;
    acc.y *= c.y;
    acc.z *= c.z;
    acc.w *= c.w;
  }
  out[i] = acc;
}

}  // namespace

cudaError_t sum_splits(const float* ws, const float* scale, float* out, int rows, int cols,
                       int splits, cudaStream_t stream) {
  const long n4 = (long)rows * cols / 4;
  const int threads = 256;
  const long blocks = (n4 + threads - 1) / threads;
  sum_splits_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      reinterpret_cast<const float4*>(ws), reinterpret_cast<const float4*>(scale),
      reinterpret_cast<float4*>(out), n4, cols / 4, splits);
  return cudaGetLastError();
}

}  // namespace mllm
