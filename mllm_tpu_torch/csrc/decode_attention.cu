// Single-token (decode) attention over the dense KV cache for Hopper, bf16.
//
// Replaces: mllm_tpu/ops/decode_attention.py, `decode_attention`
//   (Pallas kernel `_decode_kernel`).
//
// What it computes: out[b, 0, h] = softmax(q[b, 0, h] . K[b, h // n_rep]^T * scale) V
// over the keys j with  kv_start[b] <= j < kv_valid[b]  and, with a window,
// j > kv_valid[b] - 1 - window (the window is measured from the last valid
// key, where the query sits). A sequence with no valid key gets zeros.
//
// What bounds it on this card: bytes. The call reads each visible K/V row once
// (kv_valid * D * 4 bytes a KV head) and does 4 * kv_valid * D FLOPs a query
// head: at most n_rep FLOPs a byte, far below the ~295 at which an H100 stops
// being bound by its 3.35 TB/s. At b = 1 the bytes are few (0.8 MB at ctx
// 1500), so what it must beat is latency: how many SMs pull bytes at once.
//
// What the design does about it (flash-decoding inside a thread-block cluster):
//  - One CTA per (b, KV head, key split): the n_rep query heads of the KV head
//    are the 16 rows of mma.sync m16n8k16 products (zero-padded), so each K/V
//    row is read by one CTA, not once per query head.
//  - The keys [lo, hi) are cut into equal runs of whole 64-key tiles, one run
//    per cluster rank (`decode_split_ranges` in ops/decode_attention.py states
//    the rule). Each CTA reads its sequence's lengths on the device: the host
//    never reads one. The host picks only the cluster size (`decode_splits`),
//    from B * H_kv and S, to fill the card; a rank with no tile leaves an
//    empty partial (m = kNegBig, l = 0, acc = 0).
//  - Loads: every K/V row of a tile is one `cp.async.bulk` into a padded
//    shared-memory row (conflict-free ldmatrix), four tiles in flight,
//    completed on an mbarrier (tile, stages and cluster size: PERF.md,
//    tools/attention_tune.py). Rows outside [lo, hi) are never copied: they
//    are written as zeros, so a NaN or inf left in the cache by an earlier
//    request never enters a product, and no read passes the end of the cache.
//  - Each warp takes 16 keys of every tile and keeps its own (m, l, acc) in
//    registers: no block barrier inside the softmax. The four warps merge in
//    shared memory, then the cluster's ranks merge through distributed shared
//    memory in rank order after a cluster barrier; each rank writes its share
//    of the bf16 output. One launch a call, no global workspace, no atomics,
//    and an order of summation that does not depend on scheduling.
//  - Online softmax in f32, base 2, scale * log2(e) applied to the f32 score;
//    masked probabilities are exact zeros; probabilities enter P V as bf16 (as
//    the plain version rounds them), row sums l stay f32.
#include "hopper.cuh"

namespace mllm {
namespace {

// kTile and kStages: measured against other values with
// tools/attention_tune.py (PERF.md)
constexpr int kTile = 64;    // keys per tile: 16 per warp
constexpr int kWarps = kTile / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 4;   // tiles in flight
constexpr int kRows = 16;           // query heads a CTA (the m16 of mma.sync)
constexpr int kPad = 8;             // bf16 elements of row padding: conflict-free ldmatrix
constexpr int kMaxSplits = 8;       // the portable cluster size
static_assert(kTile % 16 == 0 && kThreads == 2 * kTile, "each thread copies one K or one V row of a tile");

struct DecodeParams {
  const bf16* q;            // [B, 1, H, D]
  const bf16* k;            // [B, Hkv, S, D]
  const bf16* v;            // [B, Hkv, S, D]
  bf16* o;                  // [B, 1, H, D]
  const int* kv_valid_vec;  // [B], or null: every sequence has kv_valid
  const int* kv_start;      // [B], or null: no left pad
  int B, H, Hkv, S;
  int kv_valid, window;
  int hgroups;              // CTAs a KV head needs for its n_rep query heads
  float scale_log2;         // scale * log2(e)
};

template <int D>
struct Smem {
  static constexpr int kLds = D + kPad;
  bf16 k[kStages][kTile * kLds];
  bf16 v[kStages][kTile * kLds];
  uint64_t full[kStages];
  float wm[kWarps][kRows], wl[kWarps][kRows];  // each warp's (m, l)
  float m[kRows], l[kRows];                      // the CTA's partial, read by the cluster
};
// After the last tile the ring holds each warp's acc [kWarps][kRows][D] (f32),
// then the CTA's partial acc [kRows][D] in the slots of warp 0.
static_assert(sizeof(float) * kWarps * kRows * 64 <= sizeof(bf16) * 2 * kStages * kTile * (64 + kPad),
              "the merge reuses the K/V ring");

template <int D>
__global__ void __launch_bounds__(kThreads) decode_kernel(const DecodeParams p) {
  constexpr int kLds = D + kPad;
  constexpr int kSteps = D / 16;  // k-steps of Q K^T
  constexpr int kND = D / 8;      // 8-wide column blocks of O
  extern __shared__ __align__(16) unsigned char smem[];
  auto& s = *reinterpret_cast<Smem<D>*>(smem);
  float* acc_smem = reinterpret_cast<float*>(s.k);  // the merge area, once the ring is idle

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rank = blockIdx.x, splits = gridDim.x;  // grid.x is one cluster
  const int hk = blockIdx.y / p.hgroups, b = blockIdx.z;
  const int n_rep = p.H / p.Hkv;
  const int h0 = hk * n_rep + (blockIdx.y % p.hgroups) * kRows;  // first query head
  const int rows = min(kRows, hk * n_rep + n_rep - h0);

  // The CTA's query heads as A fragments for all of D, straight from global
  // memory (head g and g + 8 of the CTA; padded heads are zeros). Issued
  // first, beside the length reads, so the two latencies overlap.
  uint32_t qf[kSteps][4];
  {
    const uint32_t* q0 = reinterpret_cast<const uint32_t*>(p.q + ((long)b * p.H + h0 + g) * D);
    const uint32_t* q1 = reinterpret_cast<const uint32_t*>(p.q + ((long)b * p.H + h0 + g + 8) * D);
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      qf[kk][0] = g < rows ? q0[kk * 8 + t] : 0u;
      qf[kk][1] = g + 8 < rows ? q1[kk * 8 + t] : 0u;
      qf[kk][2] = g < rows ? q0[kk * 8 + 4 + t] : 0u;
      qf[kk][3] = g + 8 < rows ? q1[kk * 8 + 4 + t] : 0u;
    }
  }

  // The visible keys [lo, hi), and this rank's tiles of them
  // (decode_split_ranges in ops/decode_attention.py).
  const int kv_valid = p.kv_valid_vec ? p.kv_valid_vec[b] : p.kv_valid;
  const int hi = min(kv_valid, p.S);
  int lo = max(p.kv_start ? p.kv_start[b] : 0, 0);
  if (p.window > 0) lo = max(lo, kv_valid - p.window);
  const int t0 = (lo / kTile) * kTile;
  const int ntiles = hi > lo ? (hi - t0 + kTile - 1) / kTile : 0;
  const int per = (ntiles + splits - 1) / splits;
  const int first = min(rank * per, ntiles);
  const int mine = min(first + per, ntiles) - first;

  const long kv_off = ((long)b * p.Hkv + hk) * p.S * D;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(&s.full[i], kThreads);
    fence_mbar_init();
  }
  __syncthreads();

  // Tile `it` of this rank into stage it % kStages: thread tid copies row
  // tid % kTile of K (tid < kTile) or V, or zeroes it when the key is not
  // visible. Every thread arrives once a tile; the phase completes when the
  // copies have landed.
  auto issue = [&](int it) {
    const int stage = it % kStages, r = tid % kTile;
    const int j = t0 + (first + it) * kTile + r;
    bf16* dst = (tid < kTile ? s.k[stage] : s.v[stage]) + r * kLds;
    if (j >= lo && j < hi) {
      fence_proxy_async();  // after this thread's earlier generic writes of the row
      mbar_arrive_expect_tx(&s.full[stage], D * 2);
      bulk_g2s(dst, (tid < kTile ? p.k : p.v) + kv_off + (long)j * D, D * 2, &s.full[stage]);
    } else {
#pragma unroll
      for (int c = 0; c < D / 8; ++c) *reinterpret_cast<uint4*>(dst + c * 8) = make_uint4(0, 0, 0, 0);
      mbar_arrive(&s.full[stage]);  // releases the zeros to the waiting threads
    }
  };
  for (int it = 0; it < min(mine, kStages); ++it) issue(it);

  float o[kND][4];
#pragma unroll
  for (int nd = 0; nd < kND; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  // Each thread holds heads g (index 0) and g + 8 (index 1).
  float m0 = kNegBig, m1 = kNegBig, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < mine; ++it) {
    const int stage = it % kStages;
    mbar_wait(&s.full[stage], (it / kStages) & 1);
    const bf16* kt = s.k[stage] + warp * 16 * kLds;  // this warp's 16 keys
    const bf16* vt = s.v[stage] + warp * 16 * kLds;
    const int key0 = t0 + (first + it) * kTile + warp * 16;

    // S = Q K^T: 16 heads x this warp's 16 keys.
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t kf[4];
      const int i = lane >> 3;
      ldmatrix_x4(kf, kt + ((lane & 7) + (i >> 1) * 8) * kLds + kk * 16 + (i & 1) * 8);
      mma_bf16_16816(sc[0], qf[kk], kf[0], kf[1]);
      mma_bf16_16816(sc[1], qf[kk], kf[2], kf[3]);
    }

    float mx0 = kNegBig, mx1 = kNegBig;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = key0 + nb * 8 + t * 2 + (c & 1);
        const float x = kpos >= lo && kpos < hi ? sc[nb][c] * p.scale_log2 : -INFINITY;
        sc[nb][c] = x;
        if (c < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      sc[nb][0] = exp2f(sc[nb][0] - mn0);  // masked: exp2(-inf) = 0
      sc[nb][1] = exp2f(sc[nb][1] - mn0);
      sc[nb][2] = exp2f(sc[nb][2] - mn1);
      sc[nb][3] = exp2f(sc[nb][3] - mn1);
      rs0 += sc[nb][0] + sc[nb][1];
      rs1 += sc[nb][2] + sc[nb][3];
    }
    l0 = l0 * a0 + rs0;  // thread-local partial sums; the quad is summed at the end
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int nd = 0; nd < kND; ++nd) {
      o[nd][0] *= a0;
      o[nd][1] *= a0;
      o[nd][2] *= a1;
      o[nd][3] *= a1;
    }

    // O += P V over this warp's 16 keys.
    const uint32_t pa[4] = {pack_bf16x2(sc[0][0], sc[0][1]), pack_bf16x2(sc[0][2], sc[0][3]),
                            pack_bf16x2(sc[1][0], sc[1][1]), pack_bf16x2(sc[1][2], sc[1][3])};
#pragma unroll
    for (int nd2 = 0; nd2 < D / 16; ++nd2) {
      uint32_t vf[4];
      const int i = lane >> 3;
      ldmatrix_x4_trans(vf, vt + ((lane & 7) + (i & 1) * 8) * kLds + nd2 * 16 + (i >> 1) * 8);
      mma_bf16_16816(o[2 * nd2], pa, vf[0], vf[1]);
      mma_bf16_16816(o[2 * nd2 + 1], pa, vf[2], vf[3]);
    }
    __syncthreads();  // every warp is done with this stage
    if (it + kStages < mine) issue(it + kStages);
  }

  // Merge the four warps: (m, l) and acc per warp into shared memory (the
  // ring is idle: every copy has landed and been read), then in warp order.
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  if (t == 0) {
    s.wm[warp][g] = m0;
    s.wl[warp][g] = l0;
    s.wm[warp][g + 8] = m1;
    s.wl[warp][g + 8] = l1;
  }
  float* wacc = acc_smem + warp * kRows * D;
#pragma unroll
  for (int nd = 0; nd < kND; ++nd) {
    const int col = nd * 8 + t * 2;
    if (g < rows) *reinterpret_cast<float2*>(wacc + g * D + col) = make_float2(o[nd][0], o[nd][1]);
    if (g + 8 < rows) *reinterpret_cast<float2*>(wacc + (g + 8) * D + col) = make_float2(o[nd][2], o[nd][3]);
  }
  __syncthreads();
  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D;
    float mx = kNegBig;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s.wm[w][r]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = exp2f(s.wm[w][r] - mx);
      l += s.wl[w][r] * e;
      a += acc_smem[w * kRows * D + i] * e;
    }
    acc_smem[i] = a;  // warp 0's slot of (r, col): read above by this thread only
    if (i % D == 0) {
      s.m[r] = mx;
      s.l[r] = l;
    }
  }

  // Merge the ranks in rank order through distributed shared memory; rank r
  // writes outputs [r * chunk, (r + 1) * chunk) of this CTA group's rows * D.
  cluster_sync();
  const int total = rows * D, chunk = (total + splits - 1) / splits;
  for (int i = rank * chunk + tid; i < min(total, (rank + 1) * chunk); i += kThreads) {
    const int r = i / D;
    // every remote load first (one round trip), then the sums in rank order
    float pm[kMaxSplits], pl[kMaxSplits], pa[kMaxSplits];
#pragma unroll
    for (int rr = 0; rr < kMaxSplits; ++rr) {
      if (rr < splits) {
        pm[rr] = ld_cluster_f32(map_rank(&s.m[r], rr));
        pl[rr] = ld_cluster_f32(map_rank(&s.l[r], rr));
        pa[rr] = ld_cluster_f32(map_rank(acc_smem + i, rr));
      }
    }
    float mx = kNegBig;
#pragma unroll
    for (int rr = 0; rr < kMaxSplits; ++rr)
      if (rr < splits) mx = fmaxf(mx, pm[rr]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int rr = 0; rr < kMaxSplits; ++rr) {
      if (rr < splits) {
        const float e = exp2f(pm[rr] - mx);
        l += pl[rr] * e;
        a += pa[rr] * e;
      }
    }
    p.o[((long)b * p.H + h0 + r) * D + i % D] = __float2bfloat16(l > 0.f ? a / l : 0.f);
  }
  cluster_sync();  // no CTA leaves while another still reads its shared memory
}

template <int D>
cudaError_t launch(const DecodeParams& p, int splits, cudaStream_t stream) {
  constexpr int smem = sizeof(Smem<D>);
  cudaError_t err = cudaFuncSetAttribute(decode_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, p.Hkv * p.hgroups, p.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, decode_kernel<D>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
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
  if (splits < 1 || splits > kMaxSplits || H % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int hgroups = (H / Hkv + kRows - 1) / kRows;
  const DecodeParams p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                       static_cast<const bf16*>(v), static_cast<bf16*>(out),
                       static_cast<const int*>(kv_valid_vec), static_cast<const int*>(kv_start),
                       B, H, Hkv, S, kv_valid, window, hgroups, scale_log2};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(p, splits, s);
    case 128: return launch<128>(p, splits, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
