// Single-token (decode) attention over the dense KV cache for Hopper, bf16.
//
// Replaces: mllm_tpu/ops/decode_attention.py, `decode_attention`
//   (Pallas kernel `_decode_kernel`).
//
// The kernel body, what bounds it and what its design does about it are in
// decode_attention.cuh, which decode_attention_paged.cu shares: key j of
// sequence b, KV head hk is row j of the (b, hk) plane of K and V [B, Hkv, S, D],
// and keys before kv_start[b] are not visible.
#include "decode_attention.cuh"

namespace mllm {
namespace {

template <int D>
__global__ void __launch_bounds__(dec::kThreads) decode_kernel(const dec::DecodeParams p) {
  dec::decode_body<D, false>(p);
}

}  // namespace
}  // namespace mllm

// Returns the CUDA error code of the launch (0 on success). kv_valid_vec and
// kv_start may be null. `splits` is the cluster size (1..8): the CTAs that
// share the keys of one (b, KV head). The kernel does not synchronise.
extern "C" int mllm_decode_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                          const void* kv_valid_vec, const void* kv_start, int B,
                                          int H, int Hkv, int S, int D, int kv_valid, int window,
                                          float scale_log2, int splits, void* stream) {
  using namespace mllm;
  using namespace mllm::dec;
  if (splits < 1 || splits > kMaxSplits || H % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int hgroups = (H / Hkv + kRows - 1) / kRows;
  const DecodeParams p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                       static_cast<const bf16*>(v), static_cast<bf16*>(out),
                       static_cast<const int*>(kv_valid_vec), static_cast<const int*>(kv_start),
                       nullptr, B, H, Hkv, S, 0, 0, kv_valid, window, hgroups, scale_log2};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_decode<64, false>(decode_kernel<64>, p, splits, s);
    case 128: return launch_decode<128, false>(decode_kernel<128>, p, splits, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
