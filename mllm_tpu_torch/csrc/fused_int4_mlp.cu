// Fused int4 gated MLP for Hopper at decode shapes (m <= 32):
// y = down(act(gate(x)) * up(x)), f32 out.
//
// Replaces: mllm_tpu/ops/fused_mlp.py, `fused_int4_mlp` (Pallas kernels
//   `_fused_mlp_kernel`, affine, and `_fused_mlp_kernel_sym`, symmetric).
//
// What it computes, with the layouts of `prepare_int4` / `prepare_int4_ff`:
//   gate, up: canonical planar over K = d (packed [khp_d, ff], scales [2 khp_d/32, ff]);
//   down:     block-planar over K = ff: in block (slab) j of block_f = F hidden
//             units, packed row j*F/2 + r holds f = j*F + r (low nibble) and
//             f = j*F + F/2 + r (high nibble); scales [ff/32, d_out] in natural
//             f order.
//   h[m, f] = bf16(act(x . gate[:, f]) * (x . up[:, f]))   (the Pallas kernel's rounding)
//   y[m, n] = sum_f h[m, f] * down[f, n]
// Weights dequantize as in int4_matmul.cu (q * s + z, or (q - 8) * s), in f32.
//
// What bounds it on this card: the three weights (20.6 MB at d 1536, ff 8960)
// are each read once for 4m FLOPs a byte, so at m = 1..8 the op is bound by HBM;
// towards m = 32 by the CUDA cores. Launches matter too: one op replaces three
// products and the activation.
//
// What the design does about it:
//  - The Pallas grid walks the ff slabs in order and accumulates y in one VMEM
//    buffer. Here the slabs run in parallel: block b owns packed rows
//    [32 b, 32 b + 32) of the down matrix, i.e. hidden units f_lo + [0, 32) and
//    f_hi + [0, 32) (f_lo = j F + r0, f_hi = f_lo + F/2) of slab j. It computes
//    those 64 units' gate and up columns over all of d (128 threads: one column
//    of one matrix each), rounds act(gate) * up to bf16 in shared memory, and
//    multiplies them into its 32 rows of down for every output column. The
//    hidden never leaves the SM.
//  - Each block writes its partial [m, d_out] product to a workspace; the
//    second launch (`sum_splits`) adds the ff/64 partials in block order
//    (deterministic, no atomics). The op counts as one launch of the wrapper.
//  - The 32 down rows of a block are one scale group of each half, so the
//    block loads its down scales once per column.
//  - x (m <= 16 rows per block, more rows in grid y) is staged in shared memory
//    as f32 in [half][packed row][row] order; padded rows of gate/up are skipped.
#include "common.cuh"

namespace mllm {
namespace {

constexpr int kGroup = 32;
constexpr int kRows = 32;  // down packed rows per block: 2 * kRows hidden units
constexpr int kUnits = 2 * kRows;
constexpr int kThreads = 2 * kUnits;  // one (matrix, hidden unit) column per thread

enum Act { kSilu = 0, kGelu = 1, kGeluNew = 2, kRelu = 3 };

struct FusedParams {
  const bf16* x;             // [M, d]
  const uint8_t *gq, *uq;    // [khp_d, ff]
  const float *gs, *us;      // [2 * khp_d / 32, ff]
  const float *gz, *uz;      // [2 * khp_d / 32, ff], or null: symmetric
  const uint8_t* dq;         // [ff / 2, d_out]
  const float* ds;           // [ff / 32, d_out]
  const float* dz;           // [ff / 32, d_out], or null: symmetric
  float* ws;                 // [ff / 64, M, d_out] partial products of the blocks
  int M, d, khp_d, ff, d_out, block_f, act;
};

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

template <int MT>
__device__ __forceinline__ void load_rows(float (&d)[MT], const float* p) {
  if constexpr (MT % 4 == 0) {
#pragma unroll
    for (int r = 0; r < MT; r += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + r);
      d[r] = v.x;
      d[r + 1] = v.y;
      d[r + 2] = v.z;
      d[r + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < MT; ++r) d[r] = p[r];
  }
}

template <int MT, bool kAffine>
__global__ void __launch_bounds__(kThreads) fused_mlp_kernel(const FusedParams p) {
  extern __shared__ __align__(16) float smem[];
  const int khalf = p.d / 2, ngh = p.khp_d / kGroup, fh = p.block_f / 2;
  float* sx = smem;                         // [2 * khalf][MT]: x, k = h * khalf + j at row h*khalf + j
  float* sgu = sx + 2 * khalf * MT;         // [2][kUnits][MT]: gate, then up
  float* sh = sgu + 2 * kUnits * MT;        // [kUnits][MT]: bf16-rounded hidden

  const int tid = threadIdx.x;
  const int chunk = blockIdx.x, m0 = blockIdx.y * MT;
  const int rho0 = chunk * kRows;             // first packed row of down
  const int slab = rho0 / fh, r0 = rho0 % fh;
  const int f_lo = slab * p.block_f + r0, f_hi = f_lo + fh;

  for (int i = tid; i < MT * p.d; i += kThreads) {
    const int r = i / p.d, k = i % p.d;
    const int row = m0 + r;
    sx[k * MT + r] = row < p.M ? __bfloat162float(p.x[(long)row * p.d + k]) : 0.f;
  }
  __syncthreads();

  // Gate and up: thread -> (matrix, unit); units [0, 32) are f_lo + u, [32, 64) f_hi + u - 32.
  {
    const int mat = tid / kUnits, u = tid % kUnits;
    const int f = u < kRows ? f_lo + u : f_hi + u - kRows;
    const uint8_t* q = (mat ? p.uq : p.gq) + f;
    const float* s = (mat ? p.us : p.gs) + f;
    const float* z = mat ? p.uz : p.gz;
    float acc[MT];
#pragma unroll
    for (int r = 0; r < MT; ++r) acc[r] = 0.f;
    for (int g = 0; g < khalf / kGroup; ++g) {
      const float sl = s[(long)g * p.ff], sh_ = s[(long)(ngh + g) * p.ff];
      const float zl = kAffine ? z[(long)g * p.ff + f] : -8.f * sl;
      const float zh = kAffine ? z[(long)(ngh + g) * p.ff + f] : -8.f * sh_;
#pragma unroll 8
      for (int jj = 0; jj < kGroup; ++jj) {
        const int j = g * kGroup + jj;
        const uint32_t b = __ldg(q + (long)j * p.ff);
        const float wl = fmaf((float)(b & 0x0fu), sl, zl);
        const float wh = fmaf((float)(b >> 4), sh_, zh);
        float xl[MT], xh[MT];
        load_rows<MT>(xl, sx + j * MT);
        load_rows<MT>(xh, sx + (khalf + j) * MT);
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          acc[r] = fmaf(xl[r], wl, acc[r]);
          acc[r] = fmaf(xh[r], wh, acc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < MT; ++r) sgu[(mat * kUnits + u) * MT + r] = acc[r];
  }
  __syncthreads();
  for (int i = tid; i < kUnits * MT; i += kThreads)
    sh[i] = __bfloat162float(__float2bfloat16(activation(sgu[i], p.act) * sgu[kUnits * MT + i]));
  __syncthreads();

  // Down: this block's 32 packed rows, every output column; one scale group per half.
  const int glo = f_lo / kGroup, ghi = f_hi / kGroup;
  float* dst = p.ws + (long)chunk * p.M * p.d_out;
  for (int n = tid * 4; n < p.d_out; n += kThreads * 4) {
    float slo[4], shi[4], zlo[4], zhi[4];
    load_f32x4(slo, p.ds + (long)glo * p.d_out + n);
    load_f32x4(shi, p.ds + (long)ghi * p.d_out + n);
    if (kAffine) {
      load_f32x4(zlo, p.dz + (long)glo * p.d_out + n);
      load_f32x4(zhi, p.dz + (long)ghi * p.d_out + n);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        zlo[c] = -8.f * slo[c];
        zhi[c] = -8.f * shi[c];
      }
    }
    float acc[MT][4];
#pragma unroll
    for (int r = 0; r < MT; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
#pragma unroll 4
    for (int i = 0; i < kRows; ++i) {
      const uint32_t b = __ldg(reinterpret_cast<const uint32_t*>(p.dq + (long)(rho0 + i) * p.d_out + n));
      float hl[MT], hh[MT];
      load_rows<MT>(hl, sh + i * MT);
      load_rows<MT>(hh, sh + (kRows + i) * MT);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t byte = (b >> (8 * c)) & 0xffu;
        const float wl = fmaf((float)(byte & 0x0fu), slo[c], zlo[c]);
        const float wh = fmaf((float)(byte >> 4), shi[c], zhi[c]);
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          acc[r][c] = fmaf(hl[r], wl, acc[r][c]);
          acc[r][c] = fmaf(hh[r], wh, acc[r][c]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      const int row = m0 + r;
      if (row < p.M)
        *reinterpret_cast<float4*>(dst + (long)row * p.d_out + n) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
  }
}

template <int MT, bool kAffine>
cudaError_t launch(const FusedParams& p, float* out, cudaStream_t stream) {
  const int smem = (p.d * MT + 3 * kUnits * MT) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fused_mlp_kernel<MT, kAffine>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int chunks = p.ff / (2 * kRows);
  const dim3 grid(chunks, (p.M + MT - 1) / MT);
  fused_mlp_kernel<MT, kAffine><<<grid, kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_splits(p.ws, nullptr, out, p.M, p.d_out, chunks, stream);
}

template <bool kAffine>
cudaError_t launch_rows(const FusedParams& p, float* out, int mt, cudaStream_t stream) {
  switch (mt) {
    case 1: return launch<1, kAffine>(p, out, stream);
    case 2: return launch<2, kAffine>(p, out, stream);
    case 4: return launch<4, kAffine>(p, out, stream);
    case 8: return launch<8, kAffine>(p, out, stream);
    case 16: return launch<16, kAffine>(p, out, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace mllm

// Returns the CUDA error code of the launches (0 on success). gz, uz and dz are
// all null (symmetric) or all set (affine). ws is [ff / 64, M, d_out] f32
// scratch; out is [M, d_out] f32. act: 0 silu, 1 gelu, 2 gelu_new (both the tanh
// form), 3 relu. mt (1, 2, 4, 8 or 16) rows of x per block. d % 64 == 0,
// block_f % 64 == 0, ff % block_f == 0, d_out % 4 == 0. The kernels do not
// synchronise.
extern "C" int mllm_fused_int4_mlp_bf16(const void* x, const void* gq, const void* gs,
                                        const void* gz, const void* uq, const void* us,
                                        const void* uz, const void* dq, const void* ds,
                                        const void* dz, void* ws, void* out, int M, int d,
                                        int khp_d, int ff, int d_out, int block_f, int act,
                                        int mt, void* stream) {
  using namespace mllm;
  const bool affine = gz != nullptr;
  if (d % (2 * kGroup) != 0 || block_f % (2 * kRows) != 0 || ff % block_f != 0 ||
      d_out % 4 != 0 || khp_d < d / 2 || affine != (uz != nullptr) || affine != (dz != nullptr) ||
      act < kSilu || act > kRelu)
    return static_cast<int>(cudaErrorInvalidValue);
  const FusedParams p{static_cast<const bf16*>(x),     static_cast<const uint8_t*>(gq),
                      static_cast<const uint8_t*>(uq), static_cast<const float*>(gs),
                      static_cast<const float*>(us),   static_cast<const float*>(gz),
                      static_cast<const float*>(uz),   static_cast<const uint8_t*>(dq),
                      static_cast<const float*>(ds),   static_cast<const float*>(dz),
                      static_cast<float*>(ws),         M, d, khp_d, ff, d_out, block_f, act};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(affine ? launch_rows<true>(p, static_cast<float*>(out), mt, st)
                                 : launch_rows<false>(p, static_cast<float*>(out), mt, st));
}
