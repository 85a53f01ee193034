// Small device helpers shared by the attention kernels: cp.async copies,
// ldmatrix / mma.sync fragments for bf16, and warp reductions.
//
// Everything here targets sm_90a through plain PTX available since sm_80;
// the kernels that include it are deliberately simple (no TMA, no wgmma).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mllm {

using bf16 = __nv_bfloat16;

// Finite "minus infinity" for running maxima: a row whose keys are all masked
// keeps m = kNegBig, so m_prev - m_new never becomes inf - inf.
constexpr float kNegBig = -1e30f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; when `valid` is false the 16 bytes are
// zero-filled and global memory is not read.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  const int src_size = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_size));
}

// 4-byte global -> shared copy (a per-key scale); zero-filled when `valid` is false.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool valid) {
  const int src_size = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_size));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Four 8x8 b16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c[16x8] += a[16x16] (row) * b[16x8] (col), bf16 inputs, f32 accumulation.
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The gated MLP's activations, numbered as the wrappers pass them.
enum Act { kSilu = 0, kGelu = 1, kGeluNew = 2, kRelu = 3 };

__device__ __forceinline__ float gelu_tanh(float v) {
  return 0.5f * v * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
}

// The JAX package's `_ACT` map of fused_mlp.py: there `jax.nn.gelu` defaults to
// the tanh form, so "gelu" and "gelu_new" are the same function.
__device__ __forceinline__ float activation(float v, int act) {
  switch (act) {
    case kSilu: return v / (1.f + expf(-v));
    case kGelu:
    case kGeluNew: return gelu_tanh(v);
    default: return fmaxf(v, 0.f);
  }
}

// Four consecutive floats (16-byte aligned) into registers.
__device__ __forceinline__ void load_f32x4(float (&d)[4], const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}

}  // namespace mllm
