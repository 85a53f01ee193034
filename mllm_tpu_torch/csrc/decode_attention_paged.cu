// Single-token (decode) attention over the paged KV cache for Hopper, bf16.
//
// Replaces: mllm_tpu/ops/decode_attention.py, `decode_attention_paged`
//   (Pallas kernel `_decode_paged_kernel`).
//
// What it computes: out[b, 0, h] = softmax(q[b, 0, h] . K_b^T * scale) V_b over
// the logical keys j < min(kv_valid[b], MAXB * 128) (and, with a window,
// j > kv_valid[b] - 1 - window), where logical key j of slot b lies in pool
// block table[b, j / 128], row j % 128. A table entry is clipped to [0, NB - 1]
// as the Pallas kernel does, so a retired slot (a -1 row with kv_valid > 0)
// reads block 0 and faults nothing; its output is discarded by the caller.
// A slot with no visible key gets zeros. There is no kv_start.
//
// What bounds it on this card: bytes, as the dense decode kernel: kv_valid * D
// * 4 bytes of K and V a (b, KV head) against 4 * kv_valid * D FLOPs a query
// head. The table adds 4 bytes a block.
//
// What the design does about it: it is the dense kernel (decode_attention.cuh:
// a cluster of CTAs per (b, KV head) splitting the keys, the n_rep query heads
// as mma.sync rows, 64-key tiles of bulk-copied rows, rank-order DSMEM merge),
// addressed through the table, as the Pallas kernel is the dense one with an
// indirection on the DMA source. A 64-key tile never crosses a 128-row pool
// block, so every row is still one bulk copy; the slot's table row is read
// into shared memory once, beside its length, and each copy's source is one
// shared-memory load away.
#include "decode_attention.cuh"

namespace mllm {
namespace {

template <int D>
__global__ void __launch_bounds__(dec::kThreads) paged_decode_kernel(const dec::DecodeParams p) {
  dec::decode_body<D, true>(p);
}

}  // namespace
}  // namespace mllm

// Returns the CUDA error code of the launch (0 on success). The pool blocks
// hold 128 rows; kv_valid_vec may be null. `splits` is the cluster size
// (1..8): the CTAs that share the keys of one (slot, KV head). The kernel does
// not synchronise.
extern "C" int mllm_decode_attention_paged_bf16(const void* q, const void* k_pool,
                                                const void* v_pool, const void* table, void* out,
                                                const void* kv_valid_vec, int B, int H, int Hkv,
                                                int NB, int MAXB, int D, int kv_valid, int window,
                                                float scale_log2, int splits, void* stream) {
  using namespace mllm;
  using namespace mllm::dec;
  if (splits < 1 || splits > kMaxSplits || H % Hkv != 0 || NB < 1 || MAXB < 1 ||
      smem_bytes<128, true>(MAXB) > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  const int hgroups = (H / Hkv + kRows - 1) / kRows;
  const DecodeParams p{static_cast<const bf16*>(q), static_cast<const bf16*>(k_pool),
                       static_cast<const bf16*>(v_pool), static_cast<bf16*>(out),
                       static_cast<const int*>(kv_valid_vec), nullptr, static_cast<const int*>(table),
                       B, H, Hkv, MAXB * kPage, NB, MAXB, kv_valid, window, hgroups, scale_log2};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_decode<64, true>(paged_decode_kernel<64>, p, splits, s);
    case 128: return launch_decode<128, true>(paged_decode_kernel<128>, p, splits, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
