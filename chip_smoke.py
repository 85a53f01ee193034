"""End-to-end check of the PyTorch port (mllm_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (each prints JSON lines; any failure raises and exits non-zero):
  1. device: needs a CUDA card; prints its name and power limit as nvidia-smi
     reports them; TF32 off for matmuls and convolutions.
  2. build: compiles the CUDA kernels in mllm_tpu_torch/csrc with nvcc.
  3. kernel vs plain: each kernel against its plain PyTorch version on the
     same inputs at the slice's shapes, and both times (CUDA events, after
     warm-up). Attention (bf16, H=12, H_kv=2, D=128, cache 2048): max
     |kernel - plain| <= 2e-2 (bf16 output rounding plus another summation
     order). Quantized products: max |kernel - plain| / max |plain| <= 2e-3
     (int8_matmul, int4_matmul: f32 sums in another order) and <= 1e-2
     (fused_int4_mlp: the kernel rounds the hidden activation to bf16, the
     plain version keeps f32); each row also prints the weight bytes read
     over the kernel time, against the H100's 3.35 TB/s. The two megakernels
     (28 layers, cache 2048, random int4 operand stacks; then b=16 and b=32
     at Qwen2-7B's widths, 4 layers, where blocks own several chunks of a
     column tile): max |kernel - plain|
     / max |plain| <= 1e-2 over y, k_new and v_new (bf16 rounding points
     that flip differently, f32 sums in another order; observed <= 6.6e-3).
     The quantized- and paged-cache attention kernels (int8 and int4 K/V
     quantized by the caches' quantizer; a shuffled pool of 128-row blocks,
     PAGED_ROWS: the engine's 8 slots, a retired -1 row, one 1531-key slot, a
     window, and a pool with NaN / inf in every row no slot sees and in its
     spare blocks): max |kernel - plain| <= 2e-2, as the bf16 ones; no
     PyTorch call takes their layouts (`library_ms` null), and
     `dense_sdpa_ms` times SDPA over the same keys in a dense bf16 cache, a
     different function kept for context; the paged rows also time the dense
     decode_attention kernel over the dense view of the same blocks
     (`dense_decode_ms`, the yardstick of the paged kernel).
     The fused MLP rows (FUSED_MLP_ROWS: Qwen2-VL-2B's MLP at m = 1, 4
     affine, 8, 16, 32, gelu_new, and TinyLlama's at m = 1) also time the
     unfused route through the port's kernels (`unfused_ms`: int4_matmul on
     gate and up, the activation, int4_matmul on down).
     The quantized decode rows (QUANT_DECODE_ROWS) include rows whose
     integers and scales outside [kv_start, kv_valid) hold 127 and NaN / inf
     (plain version on them zeroed), and time the bf16 decode_attention
     kernel over the same keys dequantized (`bf16_decode_ms`, the yardstick).
     The quantized prefill rows (QUANT_FLASH_ROWS: the 1536-token prompt, a
     batched admission, a chunk over a long cache, a left-padded batch, a
     sliding window, a poisoned batch, head_dim 64 with 8/8 heads) time the
     bf16 flash_attention kernel over the same keys dequantized
     (`bf16_flash_ms`, the yardstick).
     Every row carries its bound: the larger of its bytes over 3.35 TB/s and
     its FLOPs over 989 TFLOP/s (bf16); the attention main rows also time
     scaled_dot_product_attention on the same inputs (`library_ms`), every
     int8 row torch._weight_int8pack_mm and the int4 main rows
     torch._weight_int4pack_mm on the same weights, repacked outside the
     timed window (`library_ms`; the port never calls either), and the int8
     prefill rows torch.mm on the weight already in bf16 (`cublas_bf16_ms`,
     a yardstick of another function). The bf16
     attention rows (FLASH_ROWS, DECODE_ROWS) include the engine's batched
     admission and rows whose K/V hold NaN and inf outside [kv_start,
     kv_valid), as a slot may after an earlier request: the kernel's output
     must be finite and within the tolerance of the plain version run on the
     same tensors with those rows zeroed. `kernel_geometry` checks both
     kernels at head_dim 64 and 128 with 8/8, 40/2 and 4/1 heads.
     `kernel_check_device_scalars`: the three entries whose scalars may live
     on the card (a captured loop's write head) at B=1 over the 2048 cache:
     flash_attention (q_offset) and flash_attention_quant at int8 and int4
     (q_offset and kv_valid_len) at the speculative verify shape (Sq 9 at
     q_offset 1531) and a 256-row chunk at 1280, and fused_decode_step (pos
     1531), each launched with one-element int32 tensors directly and from a
     CUDA graph replayed with the scalars changed between replays: every
     output bit-equal to the host-int launch at the same values and within
     the tolerance of the plain version; the three kernels' main rows within
     3 % of the final smoke of the tree before the device-scalar entries
     (commit c967662; `kernel_check_main_row_vs_host_entry`).
  4. slice: a Qwen2-VL-2B-geometry LM (28 layers, random bf16 weights from a
     seeded generator) through generate, ragged_batched_generate and a
     sampled generate.
  5. slice_int8 / slice_int4: the same bf16 model after fuse_projections +
     quantize_model("int8" / "int4", on_device=True) on the card, through the
     same entry points (ragged batch of 8 for int8, 4 for int4).
  6. slice_kvq: the int8 model over int8 and int4 KV caches
     (init_cache(kv_dtype=...)) through the same entry points, ragged batch
     of 8; only the quantized attention kernels launch.
  7. slice_engine: ContinuousEngine(slots=8, max_len=2048, decode_window=32,
     pipeline=True) over the int8 model, once per slot cache (bf16 on the
     loop thread, int8, int4, and a paged pool 4 blocks short of what the
     first eight requests reserve, which must requeue): 12 requests of 17-300
     prompt tokens, 48 new tokens each, 2 sampled (top-k 50, top-p 0.9);
     every request returns 48 in-vocabulary tokens, 4 greedy ones lie within
     0.1 x max |logit| of the top of a teacher-forced prefill over a cache of
     the same type, and the launch counts are exact (28 prefill launches an
     admission, 28 decode launches a step, none of the other attention
     kernels). Each run prints tok/s over wall time, windows, decode steps,
     KV-cache bytes and peak memory.
  8. slice_mega: MegaDecodeLM.from_float of the bf16 model on the card, then
     generate at b=1 (prompts 100 and 1500) and batched_generate at b=8
     lockstep on the megakernel, and ragged_batched_generate through its int4
     base; exact launch counts (one megakernel and one head int4_matmul a
     step, no decode_attention or fused_int4_mlp), the last decode step and 8
     teacher-forced steps against the base model (<= 0.1 x max |logit|);
     then the slice_engine run on it over a bf16 slot cache, every decode
     step one fused_decode_step_batched launch.
  slice_compiled (in phases 4, 5, 6 and 8): generate_compiled, whose decode
     loop replays a CUDA graph of 32 steps a window (the host reads `done`
     once a window), on the bf16, int8, int4 and megakernel models and the
     int8 model over int8 KV: prompts of 100 and 1500 tokens, 256 new tokens,
     greedy tokens equal to the eager generate on the same model, a sampled
     bf16 run equal to the eager sampled run with the same seed, and exactly
     one graph replay a window; it prints tok/s of both, wall ms a token and
     device ms a step (CUDA events around one replay / 32).
  slice_sd (int8 model): bench.py's bench_sd prompts (a 16-token pattern x 8,
     max_draft 8; Zipf(1.3) over 8192 ids, max_draft 4), 128 new tokens each
     through speculative_generate_compiled (one graph of 8 verify steps a
     window), speculative_generate and speculative_generate_tree (max_draft
     6, 3 traces): every token within 0.1 x max |logit| of the top of a
     teacher-forced prefill; prints lossless (equal to generate_compiled),
     the first divergence, steps, drafted, accepted and tok/s against
     generate_compiled.
  slice_prefill (int8 model): chunked_prefill of a 1500-token prompt in
     chunks of 256 over bf16 and int8 KV against a one-shot prefill (last
     logits within 0.1 x max |logit|); prefill_with_prompt_cache of a second
     prompt sharing the first 1024 tokens (matched exactly 1024) and of the
     same prompt again (a full hit), within the same tolerance; prints ms.
  The engine runs replay a captured window graph for every window (one for
     greedy windows, one for sampled ones, captured at first use after a
     warm-up model call that changes no state), and slice_engine adds
     `engine_prefix`: prefix_cache=8 on the int8 model, bench_engine("prefix")
     traffic (a shared 128-token prefix and a distinct 128-token tail, 8
     requests x 48 new tokens): exactly 7 hits and 896 reused rows, the
     teacher-forced check of 4 greedy requests, tok/s beside the bf16 engine
     with eager windows (85.7, commit c967662's final smoke).
  Launch counts with graphs: a wrapper counts where it launches, so inside a
  capture once per recorded launch; the phases that replay graphs restate
  them as launches on the card (`graphs.device_launches`: the counters less
  the captures' recorded launches, plus each graph's launches times its
  replays), and steps of a window past the end of a loop count too.
  Every slice phase checks finite logits and tokens inside the vocabulary;
  phases 4-6 also ragged-vs-alone prefill logits, the last greedy decode
  step's logits against a fresh prefill of the same tokens (<= 0.1 x max
  |logit|), and that each kernel of the path launched at least as often as
  the path needs. The counters are set to 0 just before a phase drives its
  path and read just after.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX or mllm_tpu.
"""

from __future__ import annotations

import json
import re
import subprocess
import time

import numpy as np
import torch

QWEN2VL_2B_LM = dict(  # the language model of Qwen2-VL-2B (bench.py's headline geometry)
    vocab_size=151936, hidden_size=1536, intermediate_size=8960, num_hidden_layers=28,
    num_attention_heads=12, num_key_value_heads=2, head_dim=128,
    max_position_embeddings=32768, eos_token_id=-2,  # -2: never stop early
)
H, HKV, D, S_CACHE = 12, 2, 128, 2048
TOL = 2e-2
QUANT_TOL = {"int8_matmul": 2e-3, "int4_matmul": 2e-3, "fused_int4_mlp": 1e-2}  # relative
RAGGED_TOL = 1e-1  # x max |logit|
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# the kernel-check rows whose times go into the {"kernels": ...} line: for
# attention the shapes of the 1500-token prompt (its prefill, its last decode
# step); for the products the headline shapes of their phases; for the
# megakernels the b=1 step at ctx 1531 and the b=8 step at unequal positions
MAIN_ROW = {"flash_attention": 5, "decode_attention": 1, "int8_matmul": 1, "int4_matmul": 4,
            "fused_int4_mlp": 0, "fused_decode_step": 2, "fused_decode_step_batched": 0,
            # int8 K/V: the 1536-token prefill; the engine's 8 slots at unequal lengths
            "flash_attention_quant": 0, "decode_attention_quant": 1, "decode_attention_paged": 0}
SOURCES = {
    "flash_attention": ("mllm_tpu_torch/csrc/flash_attention.cu",
                        "mllm_tpu/ops/flash_attention.py:230"),
    "decode_attention": ("mllm_tpu_torch/csrc/decode_attention.cu",
                         "mllm_tpu/ops/decode_attention.py:317"),
    "int8_matmul": ("mllm_tpu_torch/csrc/int8_matmul.cu", "mllm_tpu/ops/quant_matmul.py:89"),
    "int4_matmul": ("mllm_tpu_torch/csrc/int4_matmul.cu", "mllm_tpu/ops/quant_matmul.py:322"),
    "fused_int4_mlp": ("mllm_tpu_torch/csrc/fused_int4_mlp.cu", "mllm_tpu/ops/fused_mlp.py:169"),
    "fused_decode_step": ("mllm_tpu_torch/csrc/decode_step.cu", "mllm_tpu/ops/decode_step.py:300"),
    "fused_decode_step_batched": ("mllm_tpu_torch/csrc/decode_step.cu",
                                  "mllm_tpu/ops/decode_step.py:717"),
    "flash_attention_quant": ("mllm_tpu_torch/csrc/flash_attention_quant.cu",
                              "mllm_tpu/ops/flash_attention.py:309"),
    "decode_attention_quant": ("mllm_tpu_torch/csrc/decode_attention_quant.cu",
                               "mllm_tpu/ops/decode_attention.py:244"),
    "decode_attention_paged": ("mllm_tpu_torch/csrc/decode_attention_paged.cu",
                               "mllm_tpu/ops/decode_attention.py:461"),
}
MEGA_TOL = 1e-2  # relative, on y and on k_new/v_new
BF16_FLOP_PER_S = 989e12  # H100 SXM, dense tensor cores


def emit(**kw):
    print(json.dumps(kw), flush=True)


def time_ms(fn, iters: int) -> float:
    """Device time per call of `fn`, launched back to back.

    The calls are queued behind a ~50 ms GPU spin, so the card finds them all
    waiting: the events then time the kernels, not the wrapper's host
    overhead (tens of microseconds a call, longer than the small kernels)."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # cycles: ~50 ms at the H100's 1.98 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over the bf16 tensor-core rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return dict(bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def wrappers() -> dict:
    """Kernel name -> its wrapper (each counts its launches in `.launches`)."""
    from mllm_tpu_torch.ops.decode_attention import (decode_attention, decode_attention_paged,
                                                     decode_attention_quant)
    from mllm_tpu_torch.ops.decode_step import fused_decode_step, fused_decode_step_batched
    from mllm_tpu_torch.ops.flash_attention import flash_attention, flash_attention_quant
    from mllm_tpu_torch.ops.fused_mlp import fused_int4_mlp
    from mllm_tpu_torch.ops.quant_matmul import int4_matmul, int8_matmul

    return {"flash_attention": flash_attention, "decode_attention": decode_attention,
            "int8_matmul": int8_matmul, "int4_matmul": int4_matmul,
            "fused_int4_mlp": fused_int4_mlp, "fused_decode_step": fused_decode_step,
            "fused_decode_step_batched": fused_decode_step_batched,
            "flash_attention_quant": flash_attention_quant,
            "decode_attention_quant": decode_attention_quant,
            "decode_attention_paged": decode_attention_paged}


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    emit(phase="device", kind=name, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    return name


def phase_build():
    from mllm_tpu_torch.ops import _build

    path, log, seconds = _build.build()
    _build.library()
    emit(phase="build", seconds=round(seconds, 3), library=path, ptxas=ptxas_summary(log))


def ptxas_summary(log: str) -> list:
    """[kernel, registers, spill stores, spill loads] for each kernel that
    `nvcc -Xptxas -v` reports (the kernel named by its mangled source and
    function, shortened)."""
    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            tail = re.split(r"_cu_[0-9a-f]{8}", m.group(1))[-1]
            cur = [re.sub(r"^\d+", "", tail)[:48], None, None, None]
            out.append(cur)
        elif cur is not None and "spill stores" in ln:
            nums = re.findall(r"(\d+) bytes spill", ln)
            cur[2], cur[3] = int(nums[0]), int(nums[1])
        elif cur is not None and "Used" in ln and "registers" in ln:
            cur[1] = int(re.search(r"Used (\d+) registers", ln).group(1))
    return out


def attention_bound(shape: dict, key_bytes=None) -> dict:
    """Bytes and FLOPs an attention row needs: q and the output once, each K/V
    row that some query sees once (key_bytes a key and KV head, K and V
    together; bf16 by default), and QK plus PV for every visible pair."""
    b, h, d = shape["B"], shape["H"], shape["D"]
    sq = shape.get("Sq", 1)
    kvl = shape["kv_valid"] if isinstance(shape["kv_valid"], list) else [shape["kv_valid"]] * b
    starts = shape["kv_start"] or [0] * b
    window = shape["window"] or 0
    pairs = rows = 0
    for i in range(b):  # query positions: q_offset + t (flash), the last valid key (decode)
        qpos = [shape["q_offset"] + t for t in range(sq)] if "Sq" in shape else [kvl[i] - 1]
        lo = lambda p: max(starts[i], p - window + 1 if window else 0)  # noqa: E731
        hi = lambda p: min(p, kvl[i] - 1)  # noqa: E731
        pairs += sum(max(0, hi(p) - lo(p) + 1) for p in qpos)
        rows += max(0, hi(qpos[-1]) - lo(qpos[0]) + 1)
    key_bytes = d * 2 * 2 if key_bytes is None else key_bytes
    return bound(2 * b * sq * h * d * 2 + rows * shape["Hkv"] * key_bytes, 4 * pairs * h * d)


# flash: (B, Sq, q_offset, kv_valid (an int, or one per sequence), kv_start, window, poisoned)
FLASH_ROWS = [
    (1, 128, 0, 128, None, None, False),
    (1, 200, 0, 200, None, None, False),
    (1, 128, 256, 384, None, None, False),            # chunk of a chunked prefill
    (4, 200, 0, 200, [0, 17, 64, 150], None, False),  # left-padded ragged batch
    (1, 200, 0, 200, None, 64, False),                # sliding window
    (1, 1536, 0, 1536, None, None, False),            # the 1500-token prompt's bucket
    (8, 128, 0, [128, 17, 100, 64, 128, 90, 33, 120], None, None, False),  # the engine's batched admission
    (4, 256, 0, [256, 200, 131, 250], [0, 17, 64, 150], None, True),     # stale NaN / inf rows
]
# decode: (B, kv_valid per sequence, kv_start, window, poisoned)
DECODE_ROWS = [
    (1, [2048], None, None, False),
    (1, [1531], None, None, False),  # the 1500-token prompt's last decode step
    (4, [1, 511, 513, 2048], None, None, False),
    (4, [231, 231, 231, 231], [183, 136, 72, 0], None, False),  # the ragged batch's last step
    (8, [1, 511, 513, 2048, 100, 1000, 1531, 777], [0, 0, 5, 100, 0, 50, 0, 3], None, False),
    (4, [1, 511, 513, 2048], [0, 3, 7, 9], 256, False),
    (4, [0, 77, 2083, 1531], [0, 13, 100, 700], None, True),  # stale NaN / inf rows; a slot past the cache
]


def poison_outside(x, lo, hi):
    """K or V [B, H_kv, S, D] with the rows outside [lo[b], hi[b]) filled with
    NaN and inf (alternating), as an earlier request may leave them in a slot;
    returns (poisoned, the same with those rows zeroed)."""
    j = torch.arange(x.shape[2], device=x.device)
    lo_t, hi_t = (torch.tensor(xs, device=x.device)[:, None] for xs in (lo, hi))
    bad = ((j[None] < lo_t) | (j[None] >= hi_t))[:, None, :, None]
    fill = torch.where(j % 2 == 0, float("nan"), float("inf")).to(x.dtype)[None, None, :, None]
    return torch.where(bad, fill, x), torch.where(bad, torch.zeros_like(x), x)


def attention_inputs(kind: str, row: tuple, dev, g):
    """Random bf16 inputs of one row of FLASH_ROWS / DECODE_ROWS (H=12,
    H_kv=2, D=128, cache S_CACHE): (q, k, v, k_plain, v_plain, kwargs, shape).
    A poisoned row's kernel inputs hold NaN / inf outside [kv_start, kv_valid);
    k_plain / v_plain have those rows zeroed (else they are k, v)."""
    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=g).to(torch.bfloat16)

    def ivec(xs):
        return torch.tensor(xs, device=dev, dtype=torch.int32)

    if kind == "flash_attention":
        b, sq, qoff, kvl, start, window, poisoned = row
        q = rnd(b, sq, H, D)
        kw = dict(q_offset=qoff, kv_valid_len=ivec(kvl) if isinstance(kvl, list) else kvl,
                  kv_start=None if start is None else ivec(start), window=window)
        shape = dict(B=b, Sq=sq, H=H, Hkv=HKV, D=D, S=S_CACHE, q_offset=qoff, kv_valid=kvl,
                     kv_start=start, window=window)
    else:
        b, kvl, start, window, poisoned = row
        q = rnd(b, 1, H, D)
        kw = dict(kv_valid_len=ivec(kvl), kv_start=None if start is None else ivec(start), window=window)
        shape = dict(B=b, H=H, Hkv=HKV, D=D, S=S_CACHE, kv_valid=[min(n, S_CACHE) for n in kvl],
                     kv_start=start, window=window)
        if max(kvl) > S_CACHE:
            shape["kv_valid_given"] = kvl
    k, v = rnd(b, HKV, S_CACHE, D), rnd(b, HKV, S_CACHE, D)
    kp, vp = k, v
    if poisoned:
        hi = kvl if isinstance(kvl, list) else [kvl] * b
        lo = start or [0] * b
        (k, kp), (v, vp) = poison_outside(k, lo, hi), poison_outside(v, lo, hi)
        shape["poisoned"] = "NaN / inf outside [kv_start, kv_valid); plain version on the rows zeroed"
    return q, k, v, kp, vp, kw, shape


def phase_kernels(dev) -> dict:
    from mllm_tpu_torch.ops.decode_attention import decode_attention, decode_attention_ref
    from mllm_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref

    g = torch.Generator(device=dev).manual_seed(1234)

    def check(name, kernel, plain, shape, library=None):
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        # every row is compared: both versions write zeros where a row sees no key
        err = (out.float() - ref.float()).abs().max().item()
        finite = bool(torch.isfinite(out.float()).all())
        row = dict(phase="kernel_check", kernel=name, shape=shape, max_abs_err=err,
                   finite=finite, ms=time_ms(kernel, 20), plain_ms=time_ms(plain, 5),
                   library_ms=time_ms(library, 20) if library is not None else None,
                   **attention_bound(shape))
        emit(**row)
        if not finite or not err <= TOL:
            raise AssertionError(f"{name} {shape}: max |kernel - plain| {err} (tolerance {TOL}), "
                                 f"finite={finite}")
        return row

    def sdpa(q, k, v, kvl, causal):
        """The library call for a main row: one SDPA over the valid keys (GQA)."""
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k[:, :, :kvl], v[:, :, :kvl], is_causal=causal, enable_gqa=True)

    rows = {"flash_attention": [], "decode_attention": []}
    for kind, kernel, plain, row_list in (("flash_attention", flash_attention, flash_attention_ref, FLASH_ROWS),
                                          ("decode_attention", decode_attention, decode_attention_ref,
                                           DECODE_ROWS)):
        for row in row_list:
            q, k, v, kp, vp, kw, shape = attention_inputs(kind, row, dev, g)
            main = len(rows[kind]) == MAIN_ROW[kind]
            kvl = shape["kv_valid"] if kind == "flash_attention" else shape["kv_valid"][0]
            rows[kind].append(check(
                kind, lambda: kernel(q, k, v, **kw), lambda: plain(q, kp, vp, **kw), shape,
                sdpa(q, k, v, kvl, kind == "flash_attention") if main else None))
    attention_geometry_checks(dev, g)
    sdpa_route_checks(dev, g)
    rows.update(kv_kernel_rows(dev, g))
    rows.update(quant_kernel_rows(dev, g))
    rows.update(mega_kernel_rows(dev, g))
    device_scalar_rows(dev, g, rows)
    return rows


# The entries that take their scalars from device memory (a captured loop's
# write head): B=1 over a 2048-row cache, the speculative verify window (9
# queries at q_offset 1531) and a 256-row chunk at q_offset 1280, each with
# the q_offsets its replays are given; the megakernel at pos 1531 and its
# replay positions.
SCALAR_FLASH_ROWS = [(9, (1531, 100, 2039)), (256, (1280, 0, 1792))]
SCALAR_MEGA_POS = (1531, 7, 2047)
# The main-row ms of the three kernels whose entries take device scalars, in
# the final smoke of the tree before that change (commit c967662; NVIDIA H100
# 80GB HBM3, 700.00 W): their main rows (host ints, as before) must stay
# within 3 % of these
HOST_ENTRY_MAIN_MS = {"flash_attention": 0.02762, "flash_attention_quant": 0.03831, "fused_decode_step": 2.401}
MAIN_MS_SLACK = 1.03


def replay_outputs(launch, scalars, values):
    """`launch()` captured once in a CUDA graph whose scalars are the device
    tensors `scalars`; for each tuple in `values` the scalars are set in
    place and the graph replayed. Returns each replay's outputs (copies)."""
    launch()  # builds the library and the plans outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = launch()
    outs = []
    for vals in values:
        for t, v in zip(scalars, vals):
            t.fill_(v)
        graph.replay()
        outs.append(tuple(o.clone() for o in (out if isinstance(out, tuple) else (out,))))
    torch.cuda.synchronize()
    return outs


def device_scalar_rows(dev, g, rows) -> None:
    """The three device-scalar entries: flash_attention (q_offset),
    flash_attention_quant at int8 and int4 (q_offset and kv_valid_len) and
    fused_decode_step (pos), each launched with one-element int32 tensors on
    the card, directly and from a CUDA graph replayed with the scalars
    changed between replays. Every output must be bit-equal to the launch
    with host ints at the same values, and within the tolerance of the plain
    version; the kernels' main rows (host ints) stay within 3 % of
    HOST_ENTRY_MAIN_MS."""
    from mllm_tpu_torch.core.config import TextConfig
    from mllm_tpu_torch.nn.layers import RotaryEmbedding
    from mllm_tpu_torch.ops import decode_step as ds
    from mllm_tpu_torch.ops.flash_attention import (flash_attention, flash_attention_quant,
                                                    flash_attention_quant_ref, flash_attention_ref)

    def i32(v):
        return torch.full((), v, dtype=torch.int32, device=dev)

    def gate(name, shape, direct_equal, replays_equal, err, tol):
        emit(phase="kernel_check_device_scalars", kernel=name, shape=shape, direct_bit_equal=direct_equal,
             replays_bit_equal=replays_equal, max_abs_err_vs_plain=err, tolerance=tol)
        if not (direct_equal and all(replays_equal) and err <= tol):
            raise AssertionError(f"{name} {shape}: device scalars bit-equal {direct_equal} / {replays_equal}, "
                                 f"vs plain {err} (tolerance {tol})")

    for sq, offsets in SCALAR_FLASH_ROWS:
        q = torch.randn(1, sq, H, D, device=dev, generator=g).to(torch.bfloat16)
        k, v = (torch.randn(1, HKV, S_CACHE, D, device=dev, generator=g).to(torch.bfloat16) for _ in range(2))
        off = i32(offsets[0])
        host = flash_attention(q, k, v, q_offset=offsets[0], kv_valid_len=offsets[0] + sq)
        direct = flash_attention(q, k, v, q_offset=off, kv_valid_len=off + sq)
        reps = replay_outputs(lambda: flash_attention(q, k, v, q_offset=off, kv_valid_len=off + sq), [off],
                              [(o,) for o in offsets])
        same = [torch.equal(r[0], flash_attention(q, k, v, q_offset=o, kv_valid_len=o + sq))
                for r, o in zip(reps, offsets)]
        ref = flash_attention_ref(q, k, v, q_offset=offsets[0], kv_valid_len=offsets[0] + sq)
        gate("flash_attention", dict(B=1, Sq=sq, S=S_CACHE, q_offsets=list(offsets)), torch.equal(host, direct),
             same, (host.float() - ref.float()).abs().max().item(), TOL)
        for bits in (8, 4):
            (kq, ks, _), (vq, vs, _) = quant_kv(1, S_CACHE, bits, dev, g)
            ops = (kq, vq, ks, vs)
            off, kvl = i32(offsets[0]), i32(offsets[0] + sq)
            host = flash_attention_quant(q, *ops, q_offset=offsets[0], kv_valid_len=offsets[0] + sq)
            direct = flash_attention_quant(q, *ops, q_offset=off, kv_valid_len=kvl)
            reps = replay_outputs(lambda: flash_attention_quant(q, *ops, q_offset=off, kv_valid_len=kvl),
                                  [off, kvl], [(o, o + sq) for o in offsets])
            same = [torch.equal(r[0], flash_attention_quant(q, *ops, q_offset=o, kv_valid_len=o + sq))
                    for r, o in zip(reps, offsets)]
            ref = flash_attention_quant_ref(q, *ops, q_offset=offsets[0], kv_valid_len=offsets[0] + sq)
            gate("flash_attention_quant", dict(B=1, Sq=sq, S=S_CACHE, bits=bits, q_offsets=list(offsets)),
                 torch.equal(host, direct), same, (host.float() - ref.float()).abs().max().item(), TOL)

    cfg = TextConfig(**QWEN2VL_2B_LM)
    ops, _ = mega_operands(dev, g, cfg)
    rope = RotaryEmbedding.make(D, S_CACHE, cfg.rope_theta, device=dev)
    kv = mega_cache(cfg, 1, dev, g)
    x = torch.randn(1, cfg.hidden_size, device=dev, generator=g)
    kw = dict(act=cfg.hidden_act, eps=cfg.rms_norm_eps, **mega_kw(cfg))

    def rot(p):
        return ds.rope_rotation_matrix(rope.sin[p], rope.cos[p])

    pos = i32(SCALAR_MEGA_POS[0])
    rot_dev = rot(pos.long().reshape(1))
    host = ds.fused_decode_step(x, SCALAR_MEGA_POS[0], rot(SCALAR_MEGA_POS[0]), *ops, *kv, **kw)
    direct = ds.fused_decode_step(x, pos, rot_dev, *ops, *kv, **kw)

    def launch():
        rot_dev.copy_(rot(pos.long().reshape(1)))
        return ds.fused_decode_step(x, pos, rot_dev, *ops, *kv, **kw)

    reps = replay_outputs(launch, [pos], [(p,) for p in SCALAR_MEGA_POS])
    same = [all(torch.equal(a, b) for a, b in zip(r, ds.fused_decode_step(x, p, rot(p), *ops, *kv, **kw)))
            for r, p in zip(reps, SCALAR_MEGA_POS)]
    ref = ds.fused_decode_step_ref(x, SCALAR_MEGA_POS[0], rot(SCALAR_MEGA_POS[0]), *ops, *kv, **kw)
    err = max(((o.float() - r.float()).abs().max() / r.float().abs().max()).item() for o, r in zip(host, ref))
    gate("fused_decode_step", dict(b=1, L=cfg.num_hidden_layers, S=S_CACHE, pos=list(SCALAR_MEGA_POS)),
         all(torch.equal(a, b) for a, b in zip(host, direct)), same, err, MEGA_TOL)
    del kv

    for name, before in HOST_ENTRY_MAIN_MS.items():
        ms = rows[name][MAIN_ROW[name]]["ms"]
        emit(phase="kernel_check_main_row_vs_host_entry", kernel=name, ms=ms, host_entry_ms=before,
             ratio=ms / before, limit=MAIN_MS_SLACK)
        if ms > before * MAIN_MS_SLACK:
            raise AssertionError(f"{name}: main row {ms} ms > {MAIN_MS_SLACK} x {before} ms, its time "
                                 "before the device-scalar entries")


def attention_geometry_checks(dev, g) -> None:
    """The bf16 attention kernels away from the model's geometry, checked only
    (no timing): head_dim 64 and 128, MHA (8/8), GQA with 20 query heads a KV
    head (two head groups in decode) and MQA (4/1), over a 640-row cache:
    decode with a slot past the cache and a window, causal flash over a left
    pad, non-causal flash with per-sequence lengths. max |kernel - plain| <=
    TOL, finite."""
    from mllm_tpu_torch.ops.decode_attention import decode_attention, decode_attention_ref
    from mllm_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=g).to(torch.bfloat16)

    def ivec(xs):
        return torch.tensor(xs, device=dev, dtype=torch.int32)

    s_cache, worst = 640, 0.0
    for d in (64, 128):
        for h, hkv in ((8, 8), (40, 2), (4, 1)):
            cases = [("decode", 3, 1, dict(kv_valid_len=ivec([640, 1, 333]))),
                     ("decode", 2, 1, dict(kv_valid_len=ivec([700, 129]), kv_start=ivec([5, 64]), window=100)),
                     ("flash", 2, 300, dict(kv_valid_len=300, kv_start=ivec([0, 40]))),
                     ("flash", 2, 100, dict(kv_valid_len=ivec([100, 37]), causal=False))]
            for kind, b, sq, kw in cases:
                q, k, v = rnd(b, sq, h, d), rnd(b, hkv, s_cache, d), rnd(b, hkv, s_cache, d)
                kernel, plain = ((decode_attention, decode_attention_ref) if kind == "decode"
                                 else (flash_attention, flash_attention_ref))
                out = kernel(q, k, v, **kw)
                err = (out.float() - plain(q, k, v, **kw).float()).abs().max().item()
                if not (err <= TOL and bool(torch.isfinite(out.float()).all())):
                    raise AssertionError(f"{kind}_attention D={d} H={h} H_kv={hkv} {kw}: max |kernel - plain| "
                                         f"{err} (tolerance {TOL}) or not finite")
                worst = max(worst, err)
    emit(phase="kernel_geometry", checks=24, head_dims=[64, 128], heads=[[8, 8], [40, 2], [4, 1]],
         max_abs_err=worst, tolerance=TOL)


def sdpa_route_checks(dev, g) -> None:
    """The attention calls the reference serves through XLA sdpa, run on the
    card through the port's routes against the same calls on the CPU: an
    additive bias, a logit softcap, and a prefill over an int8 cache with
    per-slot lengths. max |card - CPU| <= TOL, finite."""
    from mllm_tpu_torch.kv.cache import QuantKVCache
    from mllm_tpu_torch.nn.attention import attend, attend_from_cache, attention_route

    cpu = torch.device("cpu")
    b, sq, skv = 2, 48, 320
    q = torch.randn(b, sq, H, D, device=dev, generator=g).to(torch.bfloat16)
    k, v = (torch.randn(b, HKV, skv, D, device=dev, generator=g).to(torch.bfloat16) for _ in range(2))
    bias = torch.randn(b, H, sq, skv, device=dev, generator=g)
    cache = QuantKVCache.init(1, b, skv, HKV, D, device=dev)
    cache.update_layer(0, *(torch.randn(b, skv, HKV, D, device=dev, generator=g) for _ in range(2)))
    kvl = torch.tensor([skv, 201], device=dev, dtype=torch.int32)
    calls = {
        "bias": lambda t: attend(t(q), t(k), t(v), q_offset=skv - sq, kv_valid_len=skv, bias=t(bias)),
        "softcap": lambda t: attend(t(q), t(k), t(v), q_offset=skv - sq, kv_valid_len=skv, logit_softcap=20.0),
        "quant_cache_per_slot_prefill": lambda t: attend_from_cache(
            t(q), QuantKVCache(*(t(x) for x in (cache.k, cache.v, cache.k_scale, cache.v_scale)), cache.pos), 0,
            q_offset=skv - sq, kv_valid_len=t(kvl)),
    }
    routes = {"bias": attention_route(sq, bias=bias), "softcap": attention_route(sq, logit_softcap=20.0),
              "quant_cache_per_slot_prefill": attention_route(sq, cache="quant", kv_valid_len=kvl)}
    for name, call in calls.items():
        out = call(lambda x: x)
        ref = call(lambda x: x.to(cpu))
        torch.cuda.synchronize()
        err = (out.float().cpu() - ref.float()).abs().max().item()
        finite = bool(torch.isfinite(out.float()).all())
        emit(phase="sdpa_route_check", call=name, route=routes[name], shape=dict(B=b, Sq=sq, Skv=skv, H=H, Hkv=HKV),
             max_abs_err=err, tolerance=TOL, finite=finite, device=str(out.device))
        if routes[name] != "sdpa" or out.device.type != "cuda" or not finite or not err <= TOL:
            raise AssertionError(f"{name}: route {routes[name]}, max |card - CPU| {err} (tolerance {TOL}), "
                                 f"finite={finite}")


# quantized decode: (B, kv_valid per slot, kv_start, window, poisoned); cache S_CACHE
QUANT_DECODE_ROWS = [
    (1, [1531], None, None, False),
    (8, [17, 100, 511, 513, 1000, 1531, 2000, 777], None, None, False),  # the engine's 8 slots
    (4, [1, 511, 513, 2048], [0, 3, 7, 9], 256, False),
    (4, [231, 231, 231, 231], [183, 136, 72, 0], None, False),          # a ragged batch's step
    (2, [2083, 900], None, None, False),                                  # an idle slot past the cache
    # stale rows: integers and scales outside [kv_start, kv_valid) hold 127 and NaN / inf
    (4, [0, 77, 2083, 1531], [0, 13, 100, 700], None, True),
    (8, [17, 100, 511, 513, 1000, 1531, 2000, 777], [0, 5, 100, 0, 50, 0, 3, 9], 300, True),
]


def quant_kv(b, s, bits, dev, g, hkv=HKV, d=D):
    """Random K and V [B, H_kv, s, D] quantized over D by the caches' own
    quantizer: [(integers, scales, dense bf16 dequantization)] for K and V."""
    from mllm_tpu_torch.kv.cache import quantize_kv

    out = []
    for _ in range(2):
        x = torch.randn(b, hkv, s, d, device=dev, generator=g)
        q, sc = quantize_kv(x, bits)
        vals = q.float() if bits == 8 else torch.cat([(q & 15).float(), (q >> 4).float()], -1) - 8
        out.append((q, sc, (vals * sc[..., None]).to(torch.bfloat16)))
    return out


def poison_quant(kq, vq, ks, vs, kd, vd, lo, hi):
    """Quantized K/V with the keys outside [lo[b], hi[b]) holding 127 and NaN /
    inf scales (alternating by key), as an earlier request may leave a slot:
    (kernel operands (k, v, k_scale, v_scale), plain operands with those
    integers and scales zeroed, dense K and V with those rows zeroed)."""
    dev = kq.device
    j = torch.arange(kq.shape[2], device=dev)
    lo_t, hi_t = (torch.tensor(xs, device=dev, dtype=torch.int32)[:, None] for xs in (lo, hi))
    bad = ((j[None] < lo_t) | (j[None] >= hi_t))[:, None, :]  # [B, 1, S]
    fill = torch.where(j % 2 == 0, float("nan"), float("inf"))[None, None, :]
    kernel_ops = tuple(torch.where(bad[..., None], torch.full_like(t, 127), t) for t in (kq, vq)) + tuple(
        torch.where(bad, fill, t) for t in (ks, vs))
    plain_ops = tuple(torch.where(bad[..., None], torch.zeros_like(t), t) for t in (kq, vq)) + tuple(
        torch.where(bad, torch.zeros_like(t), t) for t in (ks, vs))
    dense = tuple(torch.where(bad[..., None], torch.zeros_like(t), t) for t in (kd, vd))
    return kernel_ops, plain_ops, dense


# quantized flash: (B, Sq, Skv, q_offset, kv_valid, kv_start, window, poisoned, (H, H_kv, D))
QUANT_FLASH_ROWS = [
    (1, 1536, 1536, 0, 1536, None, None, False, (H, HKV, D)),           # the 1500-token prompt's prefill
    (8, 128, 128, 0, 128, None, None, False, (H, HKV, D)),              # a batched admission of 8 buckets
    (1, 128, 1536, 1408, 1536, None, None, False, (H, HKV, D)),         # the last chunk of a chunked prefill
    (4, 256, 256, 0, 256, [0, 17, 64, 150], None, False, (H, HKV, D)),  # a left-padded ragged batch
    (1, 512, 1536, 1024, 1536, None, 256, False, (H, HKV, D)),          # a sliding window over a chunk
    # stale rows: integers and scales outside [kv_start, kv_valid) hold 127 and NaN / inf
    (4, 256, 256, 0, 200, [0, 17, 64, 150], None, True, (H, HKV, D)),
    (2, 384, 384, 0, 384, [0, 40], None, False, (8, 8, 64)),            # head_dim 64, MHA
]


def quant_flash_inputs(row, bits, dev, g):
    """One QUANT_FLASH_ROWS row at `bits`: (q, kernel operands (k, v, k_scale,
    v_scale), plain operands, kwargs, shape, dense bf16 K and V of the plain
    operands). A poisoned row's kernel operands hold 127 and NaN / inf scales
    outside [kv_start, kv_valid); its plain operands have them zeroed (else
    they are the kernel's)."""
    b, sq, skv, qoff, kvl, start, window, poisoned, (h, hkv, d) = row
    q = torch.randn(b, sq, h, d, device=dev, generator=g).to(torch.bfloat16)
    (kq, ks, kd), (vq, vs, vd) = quant_kv(b, skv, bits, dev, g, hkv, d)
    kw = dict(q_offset=qoff, kv_valid_len=kvl, window=window,
              kv_start=None if start is None else torch.tensor(start, device=dev, dtype=torch.int32))
    shape = dict(B=b, Sq=sq, H=h, Hkv=hkv, D=d, S=skv, q_offset=qoff, kv_valid=kvl, kv_start=start,
                 window=window, bits=bits)
    kernel_ops = plain_ops = (kq, vq, ks, vs)
    if poisoned:
        kernel_ops, plain_ops, (kd, vd) = poison_quant(kq, vq, ks, vs, kd, vd, start or [0] * b, [kvl] * b)
        shape["poisoned"] = "127 and NaN / inf scales outside [kv_start, kv_valid); plain version on them zeroed"
    return q, kernel_ops, plain_ops, kw, shape, (kd, vd)


def quant_decode_inputs(row, bits, dev, g):
    """One QUANT_DECODE_ROWS row at `bits`: (q, kernel operands (k, v, k_scale,
    v_scale), plain operands, kwargs, shape, dense bf16 K and V of the plain
    operands). A poisoned row's kernel operands hold 127 and NaN / inf scales
    outside [kv_start, kv_valid); its plain operands have those integers and
    scales zeroed (else they are the kernel's)."""
    b, kvl, start, window, poisoned = row
    q = torch.randn(b, 1, H, D, device=dev, generator=g).to(torch.bfloat16)
    (kq, ks, kd), (vq, vs, vd) = quant_kv(b, S_CACHE, bits, dev, g)
    ivec = lambda xs: torch.tensor(xs, device=dev, dtype=torch.int32)  # noqa: E731
    kw = dict(kv_valid_len=ivec(kvl), kv_start=None if start is None else ivec(start), window=window)
    shape = dict(B=b, H=H, Hkv=HKV, D=D, S=S_CACHE, kv_valid=[min(n, S_CACHE) for n in kvl],
                 kv_valid_given=kvl, kv_start=start, window=window, bits=bits)
    kernel_ops = plain_ops = (kq, vq, ks, vs)
    if poisoned:
        kernel_ops, plain_ops, (kd, vd) = poison_quant(kq, vq, ks, vs, kd, vd, start or [0] * b, kvl)
        shape["poisoned"] = "127 and NaN / inf scales outside [kv_start, kv_valid); plain version on them zeroed"
    return q, kernel_ops, plain_ops, kw, shape, (kd, vd)


# paged: (kv_valid per slot, retired slot or None, window or None, poisoned),
# MAXB 16 over a shuffled pool holding the blocks the lengths need plus 8 spare
PAGED_ROWS = [
    ([17, 100, 511, 513, 1000, 1531, 2000, 777], None, None, False),  # the engine's 8 slots
    ([300, 1200, 64, 600], 3, None, False),                           # a retired slot: -1 row, kv_valid > 0
    ([1531], None, None, False),                                      # the 1500-token prompt's last step
    ([1, 511, 513, 2048], None, 256, False),
    # stale rows: NaN / inf in the pool rows outside each slot's visible keys and in the spare blocks
    ([17, 100, 511, 513, 1000, 1531, 2000, 777], None, 700, True),
]
PAGED_MAXB = 16


def paged_inputs(row, dev, g):
    """One PAGED_ROWS row: (q, k_pool, v_pool, table, kwargs, shape, (plain
    k_pool, plain v_pool), (dense K, dense V)). A poisoned row's pools hold
    NaN and inf (alternating by row) in every row no slot sees and in the
    spare blocks; its plain pools have them zeroed (else they are the
    kernel's). The dense views are the plain pools through `gather_pages`
    (bf16 [B, H_kv, MAXB * 128, D]), made here, outside any timed window."""
    from mllm_tpu_torch.ops.decode_attention import PAGE, gather_pages

    kvl, retired, window, poisoned = row
    b = len(kvl)
    need = [-(-n // PAGE) for n in kvl]
    nb = sum(need) + 8
    perm = torch.randperm(nb, device=dev, generator=g).tolist()
    table = torch.full((b, PAGED_MAXB), -1, dtype=torch.int32)
    for i, n in enumerate(need):
        table[i, :n] = torch.tensor(perm[sum(need[:i]) : sum(need[: i + 1])])
    if retired is not None:
        table[retired] = -1  # a retired slot: -1 row, kv_valid > 0
    kp, vp = (torch.randn(nb, HKV, PAGE, D, device=dev, generator=g).to(torch.bfloat16) for _ in range(2))
    kpp, vpp = kp, vp
    shape = dict(B=b, H=H, Hkv=HKV, D=D, S=PAGED_MAXB * PAGE, kv_valid=kvl, kv_start=None, window=window,
                 pool_blocks=nb, retired_slot=retired)
    if poisoned:
        bad = torch.ones(nb, PAGE, dtype=torch.bool)  # [block, row]: seen by no slot
        for i, n in enumerate(kvl):
            lo = max(n - window, 0) if window else 0
            for j in range(lo, n):
                bad[table[i, j // PAGE], j % PAGE] = False
        bad = bad.to(dev)[:, None, :, None]
        fill = torch.where(torch.arange(PAGE, device=dev) % 2 == 0, float("nan"), float("inf"))
        fill = fill.to(torch.bfloat16)[None, None, :, None]
        kp, vp, kpp, vpp = (torch.where(bad, fill, kp), torch.where(bad, fill, vp),
                            torch.where(bad, torch.zeros_like(kp), kp), torch.where(bad, torch.zeros_like(vp), vp))
        shape["poisoned"] = "NaN / inf in every pool row no slot sees and in the spare blocks; plain version on them zeroed"
    table = table.to(dev)
    q = torch.randn(b, 1, H, D, device=dev, generator=g).to(torch.bfloat16)
    kw = dict(kv_valid_len=torch.tensor(kvl, device=dev, dtype=torch.int32), window=window)
    return q, kp, vp, table, kw, shape, (kpp, vpp), (gather_pages(kpp, table), gather_pages(vpp, table))


def kv_kernel_rows(dev, g) -> dict:
    """The kernels of the quantized and paged caches against their plain
    versions (H=12, H_kv=2, D=128, one quantized prefill row at D=64 with 8/8
    heads; max |kernel - plain| <= TOL): the int8 and
    int4 kernels on K/V quantized by the caches' own quantizer, the paged one
    over a shuffled pool. Bytes: q, the output, and each visible key's K/V
    bytes with its two f32 scales (paged: bf16 K/V). No single PyTorch call
    takes these layouts (library_ms null); `dense_sdpa_ms` times SDPA over the
    same keys in a dense bf16 cache, a different function kept for context,
    and on the quantized prefill (decode) rows `bf16_flash_ms`
    (`bf16_decode_ms`) the bf16 flash_attention (decode_attention) kernel over
    that dense cache (twice the bytes at int8), its yardstick; on
    the paged rows `dense_decode_ms` the same kernel over the dense view of the
    slots' blocks (the same bytes), the paged kernel's yardstick."""
    from mllm_tpu_torch.ops.decode_attention import (decode_attention, decode_attention_paged,
                                                     decode_attention_paged_ref, decode_attention_quant,
                                                     decode_attention_quant_ref)
    from mllm_tpu_torch.ops.flash_attention import flash_attention, flash_attention_quant, flash_attention_quant_ref

    sdpa = torch.nn.functional.scaled_dot_product_attention

    def ivec(xs):
        return torch.tensor(xs, device=dev, dtype=torch.int32)

    def mask(kvl, s, start=None, window=None):  # [B, 1, 1, S] keys one decode query sees
        j = torch.arange(s, device=dev)
        kv = ivec(kvl)[:, None]
        ok = j[None] < kv
        if start is not None:
            ok &= j[None] >= ivec(start)[:, None]
        if window:
            ok &= j[None] > kv - 1 - window
        return ok[:, None, None, :]

    def check(name, kernel, plain, shape, key_bytes, dense, extra=None):
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        finite = bool(torch.isfinite(out.float()).all())
        row = dict(phase="kernel_check", kernel=name, shape=shape, max_abs_err=err, finite=finite,
                   ms=time_ms(kernel, 20), plain_ms=time_ms(plain, 5), library_ms=None,
                   dense_sdpa_ms=time_ms(dense, 20), **{k: time_ms(f, 20) for k, f in (extra or {}).items()},
                   **attention_bound(shape, key_bytes))
        emit(**row)
        if not finite or not err <= TOL:
            raise AssertionError(f"{name} {shape}: max |kernel - plain| {err} (tolerance {TOL}), "
                                 f"finite={finite}")
        return row

    rows = {"flash_attention_quant": [], "decode_attention_quant": [], "decode_attention_paged": []}
    for bits in (8, 4):
        kb = 2 * (D if bits == 8 else D // 2) + 8
        for row in QUANT_FLASH_ROWS:
            q, kops, pops, kw, shape, (kd, vd) = quant_flash_inputs(row, bits, dev, g)
            kvl, qoff, d = shape["kv_valid"], shape["q_offset"], shape["D"]
            rows["flash_attention_quant"].append(check(
                "flash_attention_quant", lambda: flash_attention_quant(q, *kops, **kw),
                lambda: flash_attention_quant_ref(q, *pops, **kw), shape, 2 * (d if bits == 8 else d // 2) + 8,
                lambda: sdpa(q.transpose(1, 2), kd[:, :, :kvl], vd[:, :, :kvl], is_causal=qoff == 0,
                             enable_gqa=True),
                {"bf16_flash_ms": lambda: flash_attention(q, kd, vd, **kw)}))
        for row in QUANT_DECODE_ROWS:
            q, kops, pops, kw, shape, (kd, vd) = quant_decode_inputs(row, bits, dev, g)
            m = mask(shape["kv_valid"], S_CACHE, row[2], row[3])
            rows["decode_attention_quant"].append(check(
                "decode_attention_quant", lambda: decode_attention_quant(q, *kops, **kw),
                lambda: decode_attention_quant_ref(q, *pops, **kw), shape, kb,
                lambda: sdpa(q.transpose(1, 2), kd, vd, attn_mask=m, enable_gqa=True),
                {"bf16_decode_ms": lambda: decode_attention(q, kd, vd, **kw)}))
    for row in PAGED_ROWS:
        q, kp, vp, table, kw, shape, (kpp, vpp), (kd, vd) = paged_inputs(row, dev, g)
        m = mask(kw["kv_valid_len"].tolist(), kd.shape[2], window=row[2])
        rows["decode_attention_paged"].append(check(
            "decode_attention_paged", lambda: decode_attention_paged(q, kp, vp, table, **kw),
            lambda: decode_attention_paged_ref(q, kpp, vpp, table, **kw), shape, None,
            lambda: sdpa(q.transpose(1, 2), kd, vd, attn_mask=m, enable_gqa=True),
            {"dense_decode_ms": lambda: decode_attention(q, kd, vd, **kw)}))
    return rows


def int4pack_call(x, packed_e8, scales_p, k):
    """torch._weight_int4pack_mm on the same symmetric int4 weight (the
    library yardstick of int4_matmul; the port never calls it): the canonical
    operands repacked, outside the timed window, into its [N, K/2] nibble
    pairs (innerKTiles 2, the fastest of 2, 4 and 8 on the H100) and bf16
    (scale, zero = 0) pairs; it computes (q - 8) * scale, as the kernel."""
    from mllm_tpu_torch.ops import quant_matmul as qm

    kh, ng, ngh = k // 2, k // 2 // qm.GROUP, packed_e8.shape[0] // qm.GROUP
    q = torch.cat([packed_e8[:kh] & 15, packed_e8[:kh] >> 4], 0).t()  # [N, K], values 0..15
    packed = torch._convert_weight_to_int4pack(((q[:, ::2] << 4) | q[:, 1::2]).contiguous(), 2)
    sc = torch.cat([scales_p[:ng], scales_p[ngh:ngh + ng]], 0)  # [K/G, N]
    sz = torch.stack([sc, torch.zeros_like(sc)], -1).to(torch.bfloat16).contiguous()
    return lambda: torch._weight_int4pack_mm(x, packed, qm.GROUP, sz)


# int8_matmul: (m, K, N): the int8 path's qkv, gate||up (main row), down and
# head at decode (b = 1, 8), prefill (the wgmma kernel): 128 tokens of qkv
# and the 1536-token gate||up, then gate||up at m = 16 and 32 (the largest
# stream rows), the b=1 head, and the 1536-token down projection (K split
# over clusters that each take two tiles)
INT8_ROWS = [(1, 1536, 2048), (8, 1536, 17920), (8, 8960, 1536), (8, 1536, 151936),
             (128, 1536, 2048), (1536, 1536, 17920), (16, 1536, 17920), (32, 1536, 17920),
             (1, 1536, 151936), (1536, 8960, 1536)]


def int8_library_calls(x, q, s):
    """(library, cublas) for an int8 row: ("torch._weight_int8pack_mm", call)
    on the same weight in its [N, K] layout (the same function; the port never
    calls it), and torch.mm of x against the weight already dequantized to
    bf16 [K, N] with f32 output (cuBLAS, a yardstick of another function:
    its weight bytes are twice as many). Both operands are made outside the
    timed window."""
    wq = q.t().contiguous()
    wb = (q.float() * s).to(torch.bfloat16)
    return (("torch._weight_int8pack_mm", lambda: torch._weight_int8pack_mm(x, wq, s)),
            lambda: torch.mm(x, wb, out_dtype=torch.float32))


# int4_matmul: (m, K, N, affine): the int4 path's qkv, o, gate||up and down at
# decode, the padded int4 lm_head at b = 1, 8, 32 and 16 (the head of the b=1,
# b=8, b=32 and b=16 megakernel steps), affine rows, and K/2 = 480 padded to 512
INT4_ROWS = [(1, 1536, 2048, False), (1, 1536, 1536, False), (8, 1536, 2048, False),
             (32, 8960, 1536, False), (1, 1536, 152064, False), (1, 1536, 2048, True),
             (4, 8960, 1536, True), (8, 960, 2048, False), (8, 1536, 152064, False),
             (32, 1536, 152064, False), (16, 1536, 152064, False)]


def int4_bytes(k, n, affine):
    """Weight bytes of an int4 product: the nibbles and the f32 scales (and zeros)."""
    return k // 2 * n + (2 if affine else 1) * (k // 32) * n * 4


def int4_operands(m, k, n, affine, dev, g):
    """(packed, scales, zeros or None, x) of one INT4_ROWS row: a random weight
    quantized on the card (symmetric), or random nibbles, scales and zeros
    (affine; the padded rows stay zero); x random bf16 [m, K]."""
    from mllm_tpu_torch.ops import quant_matmul as qm
    from mllm_tpu_torch.ops.quantize_model import _q4_device

    p, s, z = qm.prepare_int4(*_q4_device(torch.randn(n, k, device=dev, generator=g) * 0.02), qm.GROUP)
    if affine:
        live = s != 0
        p = torch.randint(0, 256, p.shape, device=dev, generator=g, dtype=torch.uint8)
        p[k // 2:] = 0
        s = torch.rand(s.shape, device=dev, generator=g) * 0.02 * live
        z = torch.randn(s.shape, device=dev, generator=g) * 0.05 * live
    else:
        z = None
    return p, s, z, torch.randn(m, k, device=dev, generator=g).to(torch.bfloat16)


def quant_kernel_rows(dev, g) -> dict:
    """The quantized products against their plain versions, at the shapes of
    the int8 and int4 phases (Qwen2-VL-2B: qkv 1536->2048, o 1536->1536,
    gate||up 1536->17920, down 8960->1536, head 1536->151936 (int4: padded
    to 152064); m = decode batch, or prefill tokens for int8), and the fused
    int4 MLP at FUSED_MLP_ROWS."""
    from mllm_tpu_torch.ops import quant_matmul as qm
    from mllm_tpu_torch.ops.fused_mlp import pick_block_f
    from mllm_tpu_torch.ops.quantize_model import _q8_device

    def weight(n, k):
        return torch.randn(n, k, device=dev, generator=g) * 0.02

    def x_rows(m, k):
        return torch.randn(m, k, device=dev, generator=g).to(torch.bfloat16)

    def check(name, kernel, plain, shape, weight_bytes, library=None, cublas=None, extra=None):
        m, k, n = shape.get("m"), shape.get("K", shape.get("d")), shape.get("N", shape.get("d"))
        weights = k * n if name != "fused_int4_mlp" else 3 * shape["d"] * shape["ff"]
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        rel = err / ref.float().abs().max().item()
        finite = bool(torch.isfinite(out).all())
        ms = time_ms(kernel, 20)
        lib = dict(library_ms=None)
        if library is not None:  # (name, call): one PyTorch call of the same product
            try:
                lib_out = library[1]().float()
                lib = dict(library=library[0], library_ms=time_ms(library[1], 20),
                           library_rel_err=((lib_out - ref.float()).abs().max()
                                            / ref.float().abs().max()).item())
            except RuntimeError as e:  # a yardstick only: the port never calls it
                lib = dict(library=library[0], library_ms=None, library_error=str(e)[:200])
        if cublas is not None:  # a yardstick of another function: bf16 weights already in memory
            lib["cublas_bf16_ms"] = time_ms(cublas, 20)
        for key, call in (extra or {}).items():  # the same function by another route of the port
            lib[key] = time_ms(call, 20)
        row = dict(phase="kernel_check", kernel=name, shape=shape, max_abs_err=err, rel_err=rel,
                   tolerance=QUANT_TOL[name], finite=finite, ms=ms, plain_ms=time_ms(plain, 5),
                   weight_bytes=weight_bytes, weight_tb_per_s=weight_bytes / ms / 1e9,
                   hbm_tb_per_s=HBM_BYTES_PER_S / 1e12, **lib,
                   **bound(weight_bytes + m * k * 2 + m * n * 4, 2 * m * weights))
        emit(**row)
        if not finite or not rel <= QUANT_TOL[name]:
            raise AssertionError(f"{name} {shape}: max |kernel - plain| / max |plain| {rel} "
                                 f"(tolerance {QUANT_TOL[name]}), finite={finite}")
        return row

    rows = {"int8_matmul": [], "int4_matmul": [], "fused_int4_mlp": []}
    for m, k, n in INT8_ROWS:
        q, s = _q8_device(weight(n, k))
        x = x_rows(m, k)
        library, cublas = int8_library_calls(x, q, s)
        rows["int8_matmul"].append(check(
            "int8_matmul", lambda: qm.int8_matmul(x, q, s), lambda: qm.int8_matmul_ref(x, q, s),
            dict(m=m, K=k, N=n), k * n + 4 * n, library,
            cublas if m > qm.INT8_STREAM_MAX_M else None))
        del q, s, library, cublas

    for m, k, n, affine in INT4_ROWS:
        p, s, z, x = int4_operands(m, k, n, affine, dev, g)
        library = None if affine else ("torch._weight_int4pack_mm", int4pack_call(x, p, s, k))
        rows["int4_matmul"].append(check(
            "int4_matmul", lambda: qm.int4_matmul(x, p, s, qm.GROUP, z),
            lambda: qm.int4_matmul_ref(x, p, s, qm.GROUP, z),
            dict(m=m, K=k, N=n, affine=affine, khp=p.shape[0]), int4_bytes(k, n, affine), library))
        del p, s, z, library

    operands = {}
    for m, act, affine, (d, ff) in FUSED_MLP_ROWS:
        if (d, ff) not in operands:
            operands = {(d, ff): fused_mlp_operands(d, ff, dev, g)}  # one width's weights at a time
        block_f = pick_block_f(ff)
        x = x_rows(m, d)
        kernel, plain, unfused = fused_mlp_calls(x, operands[(d, ff)], act, affine, block_f)
        rows["fused_int4_mlp"].append(check(
            "fused_int4_mlp", kernel, plain, dict(m=m, d=d, ff=ff, block_f=block_f, act=act, affine=affine),
            2 * int4_bytes(d, ff, affine) + int4_bytes(ff, d, affine), extra={"unfused_ms": unfused}))
    return rows


# fused_int4_mlp: (m, act, affine, (d, ff)): the int4 decode step's MLP at
# b = 1, 8, 32, an affine row, gelu_new, b = 16, and TinyLlama's widths (its
# own pick_block_f, 512: a second plan)
QWEN2VL_2B_MLP, TINYLLAMA_MLP = (1536, 8960), (2048, 5632)
FUSED_MLP_ROWS = [(1, "silu", False, QWEN2VL_2B_MLP), (8, "silu", False, QWEN2VL_2B_MLP),
                  (32, "silu", False, QWEN2VL_2B_MLP), (4, "silu", True, QWEN2VL_2B_MLP),
                  (1, "gelu_new", False, QWEN2VL_2B_MLP), (16, "silu", False, QWEN2VL_2B_MLP),
                  (1, "silu", False, TINYLLAMA_MLP)]


def fused_mlp_operands(d, ff, dev, g):
    """Random gate, up and down weights quantized on the card (symmetric,
    group 32): (gate, up, down, down_planar), each (packed, scales): gate and
    up canonical over K = d, down block-planar over K = ff (pick_block_f) and
    the same down canonical over K = ff, for the unfused route."""
    from mllm_tpu_torch.ops import quant_matmul as qm
    from mllm_tpu_torch.ops.fused_mlp import pick_block_f, prepare_int4_ff
    from mllm_tpu_torch.ops.quantize_model import _q4_device

    gate, up = (tuple(qm.prepare_int4(*_q4_device(torch.randn(ff, d, device=dev, generator=g) * 0.02),
                                      qm.GROUP)[:2]) for _ in range(2))
    planar = _q4_device(torch.randn(d, ff, device=dev, generator=g) * 0.02)
    return (gate, up, tuple(prepare_int4_ff(*planar, None, pick_block_f(ff))[:2]),
            tuple(qm.prepare_int4(*planar, qm.GROUP)[:2]))


def fused_mlp_calls(x, operands, act, affine, block_f):
    """(kernel, plain, unfused) no-argument calls of one fused MLP row; affine
    rows take the same weights with their zeros stored (-8 * scales). The
    unfused route is the same function through the port's own kernels:
    int4_matmul on gate and on up, the activation, h rounded to bf16,
    int4_matmul on down (canonical over K = ff)."""
    from mllm_tpu_torch.ops import quant_matmul as qm
    from mllm_tpu_torch.ops.fused_mlp import _ACT, fused_int4_mlp, fused_int4_mlp_ref

    gate, up, down, down_planar = ((*op, (-8.0 * op[1]) if affine else None) for op in operands)

    def unfused():
        h = _ACT[act](qm.int4_matmul(x, gate[0], gate[1], qm.GROUP, gate[2])) * qm.int4_matmul(
            x, up[0], up[1], qm.GROUP, up[2])
        return qm.int4_matmul(h.to(torch.bfloat16), down_planar[0], down_planar[1], qm.GROUP, down_planar[2])

    return (lambda: fused_int4_mlp(x, gate, up, down, act=act, block_f=block_f),
            lambda: fused_int4_mlp_ref(x, gate, up, down, act=act, block_f=block_f), unfused)


def mega_operands(dev, g, cfg):
    """Random operand stacks of the megakernel at cfg's geometry: uniform
    nibbles, bf16 scales, small qkv bias, norms near 1. Returns (ops tuple,
    bytes of the stacks). The scales keep the residual stream O(10) over 28
    layers: with scales 4x larger this random trunk grows |y| to ~6e3 and
    amplifies last-bit differences, so kernel and plain version, equal at
    layer 0, part by up to 115 % at layer 6 (`tools/mega_amplification.py`,
    PERF.md)."""
    L, d, ff = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
    n_q = cfg.num_attention_heads * D
    n_qkv = (cfg.num_attention_heads + 2 * cfg.num_key_value_heads) * D

    def weight(k, n, group):
        packed = torch.randint(0, 256, (L, k // 2, n), device=dev, dtype=torch.uint8, generator=g)
        scales = torch.rand(L, k // group, n, device=dev, generator=g) * (0.5 / (4.6 * k**0.5))
        return packed, scales.to(torch.bfloat16)

    def norm():
        return 1.0 + 0.1 * torch.randn(L, 1, d, device=dev, generator=g)

    ops = ((*weight(d, n_qkv, 128), 0.1 * torch.randn(L, 1, n_qkv, device=dev, generator=g)),
           weight(n_q, d, 128), weight(d, ff, 128), weight(d, ff, 128), weight(ff, d, 32),
           norm(), norm())
    nbytes = sum(t.numel() * t.element_size() for op in ops for t in (op if isinstance(op, tuple) else (op,)))
    return ops, nbytes


# the megakernel rows: (kernel, pos, kv_start); b=1 at pos 0 / 100 / 1531,
# b=8 at unequal positions (the engine's shape), b=32 lockstep at 200
# b=8 at unequal positions (the engine's shape), b=32 lockstep at 200, and
# b=16 at unequal positions (the kernel's 9..16-row instance)
MEGA_ROWS = [("fused_decode_step", 0, 0), ("fused_decode_step", 100, 0), ("fused_decode_step", 1531, 200),
             ("fused_decode_step_batched", [1, 17, 100, 511, 513, 1000, 1531, 2000], [0, 0, 5, 100, 0, 50, 0, 3]),
             ("fused_decode_step_batched", [200] * 32, None),
             ("fused_decode_step_batched", [40 + 125 * i for i in range(16)], [0, 7] * 8)]
MEGA_MAIN_ROWS = (2, 3)  # fused_decode_step's and fused_decode_step_batched's main rows
# The Qwen2-7B language model's widths (hidden 3584, ffn 18944, 28/4 heads),
# depth cut to 4 layers: at b=16 its gate+up product has 296 work items for
# 264 resident blocks, at b=32 518 for 132, so blocks own several chunks of
# one column tile and meet at its barrier once (csrc/decode_step.cu).
QWEN2_7B_LM_4L = dict(vocab_size=152064, hidden_size=3584, intermediate_size=18944, num_hidden_layers=4,
                      num_attention_heads=28, num_key_value_heads=4, head_dim=128,
                      max_position_embeddings=32768, rope_theta=1e6)
MEGA_WIDE_ROWS = [("fused_decode_step_batched", [40 + 125 * i for i in range(16)], None),
                  ("fused_decode_step_batched", [300] * 32, None)]


def mega_kw(cfg) -> dict:
    """The megakernel's geometry arguments for cfg, as MegaDecodeLM.from_float lays it out."""
    from mllm_tpu_torch.models.megadecode import BLOCK_F_CAP
    from mllm_tpu_torch.ops.fused_mlp import pick_block_f

    return dict(n_heads=cfg.num_attention_heads, n_kv_heads=cfg.num_key_value_heads, head_dim=D, group_a=128,
                group_d=32, block_f=pick_block_f(cfg.intermediate_size, cap=BLOCK_F_CAP))


def mega_cache(cfg, b, dev, g):
    return [torch.randn(cfg.num_hidden_layers, b, cfg.num_key_value_heads, S_CACHE, D, device=dev,
                        generator=g).to(torch.bfloat16) for _ in range(2)]


def mega_keys(pos, start) -> int:
    """Cached keys the step's attention reads, over all slots (one layer)."""
    if isinstance(pos, list):
        return sum(pos) - (sum(start) if start else 0)
    return pos - start


def mega_call(name, x, pos, start, rope, ops, kv, cfg):
    """(kernel wrapper, plain version, args, kwargs) of one MEGA_ROWS row."""
    from mllm_tpu_torch.ops import decode_step as ds

    kw = dict(kv_start=start, act=cfg.hidden_act, eps=cfg.rms_norm_eps, **mega_kw(cfg))
    if name == "fused_decode_step":
        rot = ds.rope_rotation_matrix(rope.sin[pos], rope.cos[pos])
        return ds.fused_decode_step, ds.fused_decode_step_ref, (x, pos, rot, *ops, *kv), kw
    p = torch.tensor(pos, device=x.device)
    return (ds.fused_decode_step_batched, ds.fused_decode_step_batched_ref,
            (x, pos, rope.sin[p], rope.cos[p], *ops, *kv), kw)


def mega_bound(cfg, weight_bytes, b, keys) -> dict:
    """Bytes: the weight stacks, the visible KV rows, x, y and the new K/V;
    operations: 2 a weight and row of x, 4 a visible key, head dim and q head."""
    L, d, hkv = cfg.num_hidden_layers, cfg.hidden_size, cfg.num_key_value_heads
    n_weights = 2 * weight_bytes_int4(cfg)
    nbytes = weight_bytes + keys * L * hkv * D * 2 * 2 + b * d * 4 * 2 + 2 * L * b * hkv * D * 4
    return bound(nbytes, 2 * b * n_weights + 4 * keys * L * cfg.num_attention_heads * D)


def weight_bytes_int4(cfg) -> int:
    """Packed bytes of the megakernel's five weight stacks (two weights a byte)."""
    d, ff = cfg.hidden_size, cfg.intermediate_size
    n_q, n_qkv = cfg.num_attention_heads * D, (cfg.num_attention_heads + 2 * cfg.num_key_value_heads) * D
    return cfg.num_hidden_layers * (d * n_qkv + n_q * d + 3 * d * ff) // 2


def mega_kernel_rows(dev, g) -> dict:
    """Both megakernels against their plain versions at the full Qwen2-VL-2B
    geometry (28 layers, cache 2048), then the batched one at Qwen2-7B's
    widths (4 layers): error = max |kernel - plain| / max |plain| over y,
    k_new and v_new; the bound is mega_bound's."""
    rows = {"fused_decode_step": [], "fused_decode_step_batched": []}
    for lm, mrows in ((QWEN2VL_2B_LM, MEGA_ROWS), (QWEN2_7B_LM_4L, MEGA_WIDE_ROWS)):
        for name, row in mega_geometry_rows(dev, g, lm, mrows):
            rows[name].append(row)
    return rows


def mega_geometry_rows(dev, g, lm: dict, mrows):
    """(kernel name, checked row) for each of mrows at the geometry lm."""
    from mllm_tpu_torch.core.config import TextConfig
    from mllm_tpu_torch.nn.layers import RotaryEmbedding

    cfg = TextConfig(**lm)
    ops, weight_bytes = mega_operands(dev, g, cfg)
    rope = RotaryEmbedding.make(D, S_CACHE, cfg.rope_theta, device=dev)
    for name, pos, start in mrows:
        b = len(pos) if isinstance(pos, list) else 1
        kv = mega_cache(cfg, b, dev, g)
        x = torch.randn(b, cfg.hidden_size, device=dev, generator=g)
        kernel, plain, args, kw = mega_call(name, x, pos, start, rope, ops, kv, cfg)
        out, ref = kernel(*args, **kw), plain(*args, **kw)
        torch.cuda.synchronize()
        err = max(((o.float() - r.float()).abs().max() / r.float().abs().max()).item()
                  for o, r in zip(out, ref))
        abs_err = max((o.float() - r.float()).abs().max().item() for o, r in zip(out, ref))
        finite = all(bool(torch.isfinite(o).all()) for o in out)
        ms = time_ms(lambda: kernel(*args, **kw), 20)
        bnd = mega_bound(cfg, weight_bytes, b, mega_keys(pos, start))
        row = dict(phase="kernel_check", kernel=name,
                   shape=dict(b=b, pos=pos, kv_start=start, L=cfg.num_hidden_layers, d=cfg.hidden_size,
                   ff=cfg.intermediate_size, S=S_CACHE),
                   max_abs_err=abs_err, rel_err=err, tolerance=MEGA_TOL, finite=finite, ms=ms,
                   plain_ms=time_ms(lambda: plain(*args, **kw), 3), library_ms=None,
                   tb_per_s=bnd["bytes"] / ms / 1e9, hbm_tb_per_s=HBM_BYTES_PER_S / 1e12, **bnd)
        emit(**row)
        if not finite or not err <= MEGA_TOL:
            raise AssertionError(f"{name} {row['shape']}: max |kernel - plain| / max |plain| {err} "
                                 f"(tolerance {MEGA_TOL}), finite={finite}")
        del kv, out, ref
        yield name, row


def drive(model, cfg, dev, phase: str, ragged_lens, expected_per, kv_dtype: str = "bf16") -> dict:
    """Run the main path of one slice phase through the user entry points and
    check it, over caches of `kv_dtype`. expected_per(prefills, steps) ->
    {kernel: least launches}, where 0 means none at all."""
    from mllm_tpu_torch.generation.generate import (
        generate, left_pad, pad_to_bucket, prefill, ragged_batched_generate)
    from mllm_tpu_torch.generation.sampling import SamplingConfig

    kernels = wrappers()
    # every logits call of the run is checked for finite values, on the device
    finite = torch.ones((), dtype=torch.bool, device=dev)
    last = {}
    plain_logits = model.logits

    def checked_logits(hidden):
        nonlocal finite
        out = plain_logits(hidden)
        finite = finite & torch.isfinite(out).all()
        last["logits"] = out
        return out

    model.logits = checked_logits
    rng = np.random.default_rng(0)
    greedy = SamplingConfig(max_new_tokens=64)
    torch.cuda.reset_peak_memory_stats()

    for fn in kernels.values():
        fn.launches = 0
    prefills, steps = 0, 0

    def init_cache(b):
        return model.init_cache(b, S_CACHE, kv_dtype=kv_dtype)

    def run_generate(prompt, scfg, seed=0):
        nonlocal prefills, steps
        res, _ = generate(model, prompt, init_cache(1), scfg, seed=seed)
        prefills += 1
        steps += len(res.tokens) - 1
        return res

    run_generate(rng.integers(0, cfg.vocab_size, 100), SamplingConfig(max_new_tokens=8))  # warm-up
    prompt100 = rng.integers(0, cfg.vocab_size, 100)
    res100 = run_generate(prompt100, greedy)
    last_step = last["logits"][:, -1].float()  # the last greedy decode step's logits
    res1500 = run_generate(rng.integers(0, cfg.vocab_size, 1500), SamplingConfig(max_new_tokens=32))

    # decode vs prefill: the last decode step against a fresh prefill of the same tokens
    ids = np.concatenate([prompt100, res100.tokens[:-1]])
    lg_fresh, _ = prefill(model, init_cache(1),
                          torch.as_tensor(pad_to_bucket(ids[None]), device=dev), len(ids))
    prefills += 1
    decode_vs_prefill = ((last_step - lg_fresh.float()).abs().max()
                         / lg_fresh.float().abs().max()).item()
    emit(phase=f"{phase}_decode_vs_prefill", max_abs_diff_over_max_logit=decode_vs_prefill,
         tolerance=RAGGED_TOL, tokens=len(ids))
    if not decode_vs_prefill <= RAGGED_TOL:
        raise AssertionError(f"{phase}: last decode step differs from a fresh prefill: "
                             f"{decode_vs_prefill} > {RAGGED_TOL}")

    def timed_prefill(n):
        ids = torch.as_tensor(pad_to_bucket(rng.integers(0, cfg.vocab_size, (1, n))), device=dev)
        cache = init_cache(1)
        torch.cuda.synchronize()
        t = time.perf_counter()
        prefill(model, cache, ids, n)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    prefill_ms_100 = float(np.median([timed_prefill(100) for _ in range(3)]))
    prefill_ms_1500 = float(np.median([timed_prefill(1500) for _ in range(3)]))
    prefills += 6

    # ragged batch: prefill logits of each row against the prompt alone
    b = len(ragged_lens)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in ragged_lens]
    ids, pad = left_pad(prompts)
    width = ids.shape[1]
    torch.cuda.synchronize()
    t = time.perf_counter()
    lg_ragged, _ = prefill(model, init_cache(b), torch.as_tensor(ids, device=dev),
                           width, torch.as_tensor(pad, device=dev))
    torch.cuda.synchronize()
    ragged_prefill_s = time.perf_counter() - t
    prefills += 1
    worst = 0.0
    for i, p in enumerate(prompts):
        ids1 = torch.as_tensor(pad_to_bucket(p[None]), device=dev)
        lg_alone, _ = prefill(model, init_cache(1), ids1, len(p))
        prefills += 1
        ratio = ((lg_ragged[i].float() - lg_alone[0].float()).abs().max()
                 / lg_alone[0].float().abs().max()).item()
        worst = max(worst, ratio)
    emit(phase=f"{phase}_ragged_vs_alone", max_abs_diff_over_max_logit=worst, tolerance=RAGGED_TOL)
    if not worst <= RAGGED_TOL:
        raise AssertionError(f"{phase}: ragged prefill logits differ from single-stream: "
                             f"{worst} > {RAGGED_TOL}")

    torch.cuda.synchronize()
    t = time.perf_counter()
    toks, _, _ = ragged_batched_generate(model, prompts, init_cache(b),
                                         SamplingConfig(max_new_tokens=32))
    torch.cuda.synchronize()
    ragged_s = time.perf_counter() - t
    prefills += 1
    steps += toks.shape[1] - 1
    if toks.shape != (b, 32):
        raise AssertionError(f"ragged_batched_generate returned {toks.shape}, expected ({b}, 32)")
    decode_tps_ragged = b * (toks.shape[1] - 1) / (ragged_s - ragged_prefill_s)

    sampled = run_generate(rng.integers(0, cfg.vocab_size, 100),
                           SamplingConfig(max_new_tokens=16, do_sample=True, top_k=50, top_p=0.9),
                           seed=7)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}
    expected = expected_per(prefills, steps)
    all_finite = bool(finite)
    model.logits = plain_logits
    for name, res in (("greedy_100", res100), ("greedy_1500", res1500), ("sampled", sampled)):
        if not all(0 <= t < cfg.vocab_size for t in res.tokens):
            raise AssertionError(f"{phase} {name}: token out of vocabulary")
    if not ((0 <= toks) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"{phase} ragged: token out of vocabulary")
    emit(phase=phase, prompt_tokens=[100, 1500, list(ragged_lens), 100],
         new_tokens=[len(res100.tokens), len(res1500.tokens), int(toks.shape[1]),
                     len(sampled.tokens)],
         prefill_ms_100_tokens=prefill_ms_100, prefill_ms_1500_tokens=prefill_ms_1500,
         ttft_ms_1500_tokens=res1500.ttft_s * 1e3,
         decode_tok_s_b1_ctx100=res100.decode_tps, decode_tok_s_b1_ctx1500=res1500.decode_tps,
         **{f"decode_tok_s_b{b}_ragged": decode_tps_ragged},
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
         prefills=prefills, decode_steps=steps,
         launches=launches, launches_expected_at_least=expected, logits_finite=all_finite)
    if not all_finite:
        raise AssertionError(f"{phase}: non-finite logits on the main path")
    for name, want in expected.items():
        if launches[name] < want or (want == 0) != (launches[name] == 0):
            raise AssertionError(f"{phase} {name}: {launches[name]} launches, expected "
                                 f"{'none' if want == 0 else f'>= {want}'}")
    return {name: launches[name] for name in expected}


# slice_compiled: generate_compiled against the eager generate on the same
# model, prompts of 100 and 1500 tokens, 256 new tokens (eos never hit)
COMPILED_PROMPTS = (100, 1500)
COMPILED_NEW = 256


def first_divergence(a, b) -> int:
    """The first index where two token lists differ (-1: equal)."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return -1 if len(a) == len(b) else min(len(a), len(b))


def timed(fn):
    """(fn(), wall seconds) with the card synchronised on both sides."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def replay_ms(name: str) -> float:
    """Device ms of one replay of the StepGraph `name` replayed since the
    last reset_counts (CUDA events around it; a finished loop's replay runs
    the same launches as a live one, and writes nothing)."""
    from mllm_tpu_torch.generation import graphs

    (g,) = [x for x in graphs.all_graphs(name) if x.replays > 0]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    g.graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def compiled_run(model, dev, name: str, kv_dtype: str = "bf16", sampled: bool = False) -> dict:
    """slice_compiled on one model: generate_compiled (prompts of 100 and
    1500 tokens, 256 new, eos never hit) against the eager generate on the
    same model and cache type, and with sampled=True a sampled run (top-k
    50, top-p 0.9, seed 7) against the eager sampled run. Gates: equal
    tokens (the kernels and their arguments are the same, so a difference is
    a capture bug) and one graph replay a window of COMPILED_WINDOW steps
    (after a warm-up call that ran the loop's eager step and its capture).
    Prints tok/s of both over wall time, wall ms a token, device ms a step
    (CUDA events around one replay / COMPILED_WINDOW) and the card's busy
    share (device ms a step / graph wall ms a token). Returns the launches on
    the card (graphs.device_launches)."""
    from mllm_tpu_torch.generation import graphs
    from mllm_tpu_torch.generation.generate import COMPILED_WINDOW, generate, generate_compiled, pad_to_bucket
    from mllm_tpu_torch.generation.sampling import SamplingConfig

    V, W = model.cfg.vocab_size, COMPILED_WINDOW
    rng = np.random.default_rng(17)
    greedy = SamplingConfig(max_new_tokens=COMPILED_NEW)
    sample = SamplingConfig(max_new_tokens=64, do_sample=True, top_k=50, top_p=0.9)

    def cache():
        return model.init_cache(1, S_CACHE, kv_dtype=kv_dtype)

    def compiled(prompt, scfg, n_new, seed=0):
        ids = pad_to_bucket(np.asarray(prompt)[None])
        (toks, n), t = timed(lambda: generate_compiled(model, ids, cache(), len(prompt), n_new, scfg, seed=seed))
        return toks.cpu().numpy()[: int(n)].tolist(), t

    for scfg in (greedy, sample) if sampled else (greedy,):  # the loops' eager steps and captures
        compiled(rng.integers(0, V, 100), scfg, 2 * W)
    kernels = wrappers()
    for fn in kernels.values():
        fn.launches = 0
    graphs.reset_counts()
    runs, ok = [], True
    for n_prompt in COMPILED_PROMPTS:
        prompt = rng.integers(0, V, n_prompt)
        before = graphs.replays("generate_compiled")
        toks, t_graph = compiled(prompt, greedy, COMPILED_NEW)
        reps = graphs.replays("generate_compiled") - before
        (res, _), t_eager = timed(lambda: generate(model, prompt, cache(), greedy))
        want_reps = -(-(COMPILED_NEW - 1) // W)
        runs.append(dict(prompt_tokens=n_prompt, new_tokens=len(toks), equal=toks == res.tokens,
                         first_divergence=first_divergence(toks, res.tokens), graph_replays=reps,
                         expected_replays=want_reps, graph_tok_s=len(toks) / t_graph,
                         eager_tok_s=len(res.tokens) / t_eager, graph_wall_ms_per_token=t_graph / len(toks) * 1e3,
                         eager_wall_ms_per_token=t_eager / len(res.tokens) * 1e3,
                         eager_decode_tok_s=res.decode_tps))
        ok &= toks == res.tokens and len(toks) == COMPILED_NEW and reps == want_reps
    step_ms = replay_ms("generate_compiled") / W
    sampled_run = None
    if sampled:
        prompt = rng.integers(0, V, 100)
        toks, _ = compiled(prompt, sample, 64, seed=7)
        res, _ = generate(model, prompt, cache(), sample, seed=7)
        sampled_run = dict(prompt_tokens=100, new_tokens=len(toks), equal=toks == res.tokens,
                           first_divergence=first_divergence(toks, res.tokens))
        ok &= toks == res.tokens and len(toks) == 64
    counted = {k: fn.launches for k, fn in kernels.items()}
    launches = graphs.device_launches(counted)
    emit(phase="slice_compiled", model=name, kv_dtype=kv_dtype, window=W, runs=runs, sampled=sampled_run,
         device_ms_per_step=step_ms, busy_share=step_ms / runs[0]["graph_wall_ms_per_token"],
         launches=launches, launches_counted=counted,
         launch_note="launches on the card: the counters less each capture's recorded launches, plus each "
                     "graph's launches times its replays (steps past the end of a loop run too)")
    if not ok:
        raise AssertionError(f"slice_compiled {name}: generate_compiled differs from eager generate, or "
                             f"not one replay a window: {runs} {sampled_run}")
    return launches


def init_model(cfg, dev):
    from mllm_tpu_torch.models.transformer import CausalLM

    return CausalLM.init(cfg, device=dev, dtype=torch.bfloat16,
                         generator=torch.Generator(device=dev).manual_seed(0))


def state_bytes(model) -> int:
    return sum(t.numel() * t.element_size() for t in model.state_dict().values())


def phase_slice(dev) -> dict:
    from mllm_tpu_torch.core.config import TextConfig

    cfg = TextConfig(**QWEN2VL_2B_LM)
    L = cfg.num_hidden_layers
    t0 = time.perf_counter()
    model = init_model(cfg, dev)
    torch.cuda.synchronize()
    emit(phase="slice_init", seconds=time.perf_counter() - t0,
         params=sum(p.numel() for p in model.parameters()), weight_bytes=state_bytes(model))
    launches = drive(model, cfg, dev, "slice", (17, 64, 128, 200),
                     lambda prefills, steps: {"flash_attention": L * prefills,
                                              "decode_attention": L * steps})
    return add_launches(launches, compiled_run(model, dev, "bf16", sampled=True))


def add_launches(total: dict, more: dict) -> dict:
    for k, n in more.items():
        total[k] = total.get(k, 0) + n
    return total


def phase_slice_quant(dev, mode: str, keep: bool = False):
    """fuse_projections + quantize_model(mode, on_device=True) of the bf16
    model on the card, then the main path through the quantized model.
    Returns the launches, and with keep=True the model too."""
    from mllm_tpu_torch.core.config import TextConfig
    from mllm_tpu_torch.generation.generate import pad_to_bucket, prefill
    from mllm_tpu_torch.ops.quantize_model import fuse_projections, quantize_model

    cfg = TextConfig(**QWEN2VL_2B_LM)
    L = cfg.num_hidden_layers
    model = init_model(cfg, dev)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 100))
    ids = torch.as_tensor(pad_to_bucket(prompt), device=dev)
    lg_bf16, _ = prefill(model, model.init_cache(1, S_CACHE), ids, 100)
    bf16_bytes = state_bytes(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    quantize_model(fuse_projections(model), mode, on_device=True)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    lg_q, _ = prefill(model, model.init_cache(1, S_CACHE), ids, 100)
    vs_bf16 = ((lg_q.float() - lg_bf16.float()).abs().max() / lg_bf16.float().abs().max()).item()
    layers = {type(m).__name__ for m in model.modules()}
    emit(phase=f"slice_{mode}_quantize", seconds=quant_s, bf16_weight_bytes=bf16_bytes,
         weight_bytes=state_bytes(model), logits_vs_bf16_max_abs_diff_over_max_logit=vs_bf16,
         layers=sorted(layers))
    want = ({"QuantLinear", "QuantEmbedHead"} if mode == "int8"
            else {"Int4Linear", "FusedInt4MLP", "Int4EmbedHead"})
    if not want <= layers or "Linear" in layers:
        raise AssertionError(f"slice_{mode}: quantize_model left {sorted(layers)}")

    if mode == "int8":  # 4 products a layer (qkv, o, gate||up, down) and the head, per forward
        def expected(prefills, steps):
            return {"flash_attention": L * prefills, "decode_attention": L * steps,
                    "int8_matmul": (4 * L + 1) * (prefills + steps)}
        lens = (17, 40, 64, 90, 128, 150, 180, 200)
    else:  # decode: qkv and o a layer and the head; prefill: the head (m = batch)
        def expected(prefills, steps):
            return {"flash_attention": L * prefills, "decode_attention": L * steps,
                    "int4_matmul": (2 * L + 1) * steps + prefills,
                    "fused_int4_mlp": L * steps}
        lens = (17, 64, 128, 200)
    launches = add_launches(drive(model, cfg, dev, f"slice_{mode}", lens, expected),
                            compiled_run(model, dev, mode))
    if keep:
        return launches, model
    del model
    torch.cuda.empty_cache()
    return launches


def phase_slice_kvq(dev, model) -> dict:
    """The int8-weight model over int8 and int4 KV caches
    (`init_cache(kv_dtype=...)`): generate at b=1 (prompts 100 and 1500),
    ragged_batched_generate at b=8 (left padding: kv_start reaches both
    quantized kernels) and a sampled generate, with drive()'s checks. Every
    prefill is 28 flash_attention_quant launches and every decode step 28
    decode_attention_quant; the bf16 attention kernels never launch."""
    L = model.cfg.num_hidden_layers
    lens = (17, 40, 64, 90, 128, 150, 180, 200)

    def expected(prefills, steps):
        return {"flash_attention_quant": L * prefills, "decode_attention_quant": L * steps,
                "int8_matmul": (4 * L + 1) * (prefills + steps), "flash_attention": 0,
                "decode_attention": 0}

    launches = {}
    for kv in ("int8", "int4"):
        add_launches(launches, drive(model, model.cfg, dev, f"slice_kvq_{kv}", lens, expected, kv))
    return add_launches(launches, compiled_run(model, dev, "int8_kv_int8", kv_dtype="int8"))


# slice_sd: bench.py's bench_sd prompts (numpy default_rng(0)), 128 new tokens
SD_NEW = 128


def phase_slice_sd(dev, model) -> dict:
    """The int8 model through the three speculative decoders on bench_sd's
    two prompts: a 16-token pattern x 8 (max_draft 8) and Zipf(1.3) over 8192
    ids, 128 tokens (max_draft 4); speculative_generate_compiled and
    speculative_generate at that max_draft, speculative_generate_tree at
    max_draft 6 and 3 traces. Gate: every token within RAGGED_TOL x max
    |logit| of the top of a teacher-forced prefill (the verify runs flash
    attention and greedy decode runs decode attention, so near-ties may
    differ). Prints whether each equals generate_compiled's greedy tokens
    (`lossless`), the first divergence, steps, drafted, accepted and tok/s
    against generate_compiled on the same prompt."""
    from mllm_tpu_torch.generation import graphs
    from mllm_tpu_torch.generation.generate import COMPILED_WINDOW, generate_compiled
    from mllm_tpu_torch.generation.sampling import SamplingConfig
    from mllm_tpu_torch.generation.speculative import (speculative_generate, speculative_generate_compiled,
                                                       speculative_generate_tree)

    V = model.cfg.vocab_size
    pattern = np.tile(np.random.default_rng(0).integers(0, V, 16), 8)
    zipf = np.minimum(np.random.default_rng(0).zipf(1.3, size=128), 8192) - 1
    greedy = SamplingConfig(max_new_tokens=SD_NEW)

    def cache():
        return model.init_cache(1, S_CACHE)

    generate_compiled(model, pattern[None], cache(), 128, 2 * COMPILED_WINDOW, greedy)  # warm-ups
    for md in (8, 4):
        speculative_generate_compiled(model, pattern[None], cache(), 128, 24, max_draft=md)
    kernels = wrappers()
    for fn in kernels.values():
        fn.launches = 0
    graphs.reset_counts()
    worst = 0.0
    for name, prompt, md in (("pattern", pattern, 8), ("zipf", zipf, 4)):
        ids = prompt[None]
        (ref, n_ref), t_ref = timed(lambda: generate_compiled(model, ids, cache(), 128, SD_NEW, greedy,
                                                              eos_token_id=-7))
        ref = ref.cpu().numpy()[: int(n_ref)].tolist()
        (toks, n, steps, drafted, accepted), t_c = timed(lambda: speculative_generate_compiled(
            model, ids, cache(), 128, SD_NEW, eos_token_id=-7, max_draft=md, ngram=3))
        compiled_out = toks.cpu().numpy()[: int(n)].tolist()
        (host_out, _, hs), t_h = timed(lambda: speculative_generate(model, ids, cache(), SD_NEW, eos_token_id={-7},
                                                                    max_draft=md))
        (tree_out, _, ts), t_t = timed(lambda: speculative_generate_tree(model, ids, cache(), SD_NEW,
                                                                         eos_token_id={-7}, max_draft=6,
                                                                         max_traces=3))
        decoders = [("compiled", compiled_out, (int(steps), int(drafted), int(accepted)), t_c, md),
                    ("host", host_out, (hs.steps, hs.drafted, hs.accepted), t_h, md),
                    ("tree", tree_out, (ts.steps, ts.drafted, ts.accepted), t_t, 6)]
        for dec, out, (st, dr, ac), t, draft in decoders:
            gap = teacher_forced_gap(model, dev, prompt, out)
            worst = max(worst, gap)
            emit(phase="slice_sd", prompt=name, decoder=dec, max_draft=draft, new_tokens=len(out),
                 lossless=out == ref, first_divergence=first_divergence(out, ref), steps=st, drafted=dr,
                 accepted=ac, acceptance=ac / dr if dr else 0.0, tok_s=len(out) / t,
                 generate_compiled_tok_s=len(ref) / t_ref, speedup=t_ref / t * len(out) / len(ref),
                 teacher_forced_gap_over_max_logit=gap, tolerance=RAGGED_TOL)
            if len(out) != SD_NEW or not all(0 <= x < V for x in out) or not gap <= RAGGED_TOL:
                raise AssertionError(f"slice_sd {name} {dec}: {len(out)} tokens, teacher-forced gap {gap}")
    return graphs.device_launches({k: fn.launches for k, fn in kernels.items()})


def phase_slice_prefill(dev, model) -> dict:
    """chunked_prefill of a 1500-token prompt in chunks of 256 over bf16 and
    int8 KV caches against a one-shot prefill (last logits within RAGGED_TOL x
    max |logit|); then prefill_with_prompt_cache of a second prompt sharing
    the first 1024 tokens with a stored prefix (matched exactly 1024, logits
    within the same tolerance of a one-shot prefill of it), and the same
    prompt again (a full hit: matched 1500). Prints each prefill's ms."""
    from mllm_tpu_torch.generation.generate import pad_to_bucket, prefill
    from mllm_tpu_torch.generation.prefill import PromptCache, chunked_prefill, prefill_with_prompt_cache

    V = model.cfg.vocab_size
    rng = np.random.default_rng(9)
    a = rng.integers(0, V, 1500)
    b = np.concatenate([a[:1024], rng.integers(0, V, 476)])
    kernels = wrappers()
    for fn in kernels.values():
        fn.launches = 0

    def ratio(x, ref):
        return ((x.float() - ref.float()).abs().max() / ref.float().abs().max()).item()

    for kv in ("bf16", "int8"):
        def cache():
            return model.init_cache(1, S_CACHE, kv_dtype=kv)

        def one_shot(p):
            return prefill(model, cache(), torch.as_tensor(pad_to_bucket(p[None]), device=dev), len(p))[0]

        one_shot(a)  # warm-up
        chunked_prefill(model, cache(), a[None], 1500, chunk=256)
        ref_a, t_one = timed(lambda: one_shot(a))
        (lg_a, _), t_chunked = timed(lambda: chunked_prefill(model, cache(), a[None], 1500, chunk=256))
        pc = PromptCache(4)
        _, t_store = timed(lambda: prefill_with_prompt_cache(model, cache(), a[None, :1024], 1024, pc, chunk=256))
        (lg_b, _, matched), t_hit = timed(lambda: prefill_with_prompt_cache(model, cache(), b[None], 1500, pc,
                                                                             chunk=256))
        (lg_full, _, matched_full), t_full = timed(lambda: prefill_with_prompt_cache(model, cache(), b[None], 1500,
                                                                                      pc, chunk=256))
        ref_b = one_shot(b)
        gaps = dict(chunked=ratio(lg_a, ref_a), prefix_hit=ratio(lg_b, ref_b), full_hit=ratio(lg_full, ref_b))
        emit(phase="slice_prefill", kv_dtype=kv, prompt_tokens=1500, chunk=256, one_shot_ms=t_one * 1e3,
             chunked_ms=t_chunked * 1e3, store_prefix_1024_ms=t_store * 1e3, prefix_hit_ms=t_hit * 1e3,
             full_hit_ms=t_full * 1e3, matched=matched, matched_full=matched_full,
             logits_gap_over_max_logit=gaps, tolerance=RAGGED_TOL)
        if matched != 1024 or matched_full != 1500 or not max(gaps.values()) <= RAGGED_TOL:
            raise AssertionError(f"slice_prefill {kv}: matched {matched} / {matched_full}, gaps {gaps}")
    return {k: fn.launches for k, fn in kernels.items()}


# the engine runs: 12 requests for 8 slots (slots are reused), prompts of
# 17-300 tokens (those over one 128-token bucket are admitted one by one),
# 48 new tokens each, requests 10 and 11 sampled
ENGINE_LENS = (17, 40, 64, 100, 128, 150, 200, 256, 300, 90, 33, 180)
ENGINE_NEW = 48
ENGINE_KW = dict(slots=8, max_len=S_CACHE, prompt_bucket=128, decode_window=32, pipeline=True,
                 eos_token_id=-2)


def paged_blocks_short_of(lens, short: int) -> int:
    """A pool `short` blocks smaller than the first eight requests reserve
    together, counted as ContinuousEngine._paged_reserve counts them."""
    need = [max(-(-(n + ENGINE_NEW) // 128), -(-n // 128)) for n in lens[:8]]
    return sum(need) - short


def serve(model, dev, name: str, engine_kw: dict, expected_per, start_thread=False) -> dict:
    """One engine run of ENGINE_LENS through submit / step (or the loop thread)
    / collect, checked: every request returns ENGINE_NEW in-vocabulary
    tokens; 4 greedy requests' tokens lie within RAGGED_TOL x max |logit| of
    the top logit of a teacher-forced single-stream prefill of prompt +
    tokens over a cache of the same type; the launch counts are
    expected_per(admissions, decode steps), 0 meaning none."""
    from mllm_tpu_torch.generation.engine import ContinuousEngine, collect
    from mllm_tpu_torch.generation.sampling import SamplingConfig

    V = model.cfg.vocab_size
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, V, n) for n in ENGINE_LENS]
    sampled = SamplingConfig(max_new_tokens=ENGINE_NEW, do_sample=True, top_k=50, top_p=0.9)
    from mllm_tpu_torch.generation import graphs

    kernels = wrappers()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = ContinuousEngine(model, start_thread=start_thread, **ENGINE_KW, **engine_kw)
    cache_bytes = sum(t.numel() * t.element_size() for t in vars(eng.cache).values()
                      if isinstance(t, torch.Tensor) and t.dim() >= 4)
    for fn in kernels.values():
        fn.launches = 0
    graphs.reset_counts()
    t0 = time.perf_counter()
    qs = [eng.submit(p, ENGINE_NEW, sampled if i >= 10 else None) for i, p in enumerate(prompts)]
    if start_thread:
        outs = [collect(q, timeout=600) for q in qs]
        eng.stop()
    else:
        while any(r is not None for r in eng.req) or not eng.pending.empty() or eng._inflight is not None:
            eng.step()
        outs = [collect(q, timeout=5) for q in qs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counted = {k: fn.launches for k, fn in kernels.items()}
    launches = graphs.device_launches(counted)
    # decode steps: every window's, and each window graph's warm-up model call
    steps = eng.steps * eng.window + len(eng._windows)
    expected = expected_per(eng.admissions, steps)
    peak = torch.cuda.max_memory_allocated()
    if not all(len(o) == ENGINE_NEW and all(0 <= t < V for t in o) for o in outs):
        raise AssertionError(f"{name}: lengths {[len(o) for o in outs]} (expected {ENGINE_NEW} each) "
                             "or a token out of the vocabulary")
    kv_dtype = engine_kw.get("kv_dtype", "bf16") if "paged" not in engine_kw else "bf16"
    gap = max(teacher_forced_gap(model, dev, prompts[i], outs[i], kv_dtype)
              for i in (0, 3, 7, 8))  # greedy; prompts of 17, 100, 256 and 300 tokens
    replays = sum(g.replays for g in eng._windows.values())
    capture_s = sum(g.capture_s for g in eng._windows.values())
    emit(phase="slice_engine", run=name, requests=len(prompts), new_tokens=ENGINE_NEW,
         prompt_tokens=list(ENGINE_LENS), wall_s=wall, tok_s=len(prompts) * ENGINE_NEW / wall,
         capture_s=capture_s, tok_s_less_capture=len(prompts) * ENGINE_NEW / (wall - capture_s),
         windows=eng.steps, graph_replays=replays,
         decode_steps=steps, admissions=eng.admissions, requeued=eng.requeued,
         kv_cache_bytes=cache_bytes, max_memory_allocated_bytes=peak,
         teacher_forced_gap_over_max_logit=gap, tolerance=RAGGED_TOL, launches=launches,
         launches_counted=counted, launches_expected=expected, loop_thread=start_thread,
         launch_note="launches on the card: the counters (one per launch made eagerly or recorded "
                     "in a capture) less each capture's recorded launches, plus each graph's "
                     "launches times its replays")
    if replays != eng.steps:
        raise AssertionError(f"{name}: {eng.steps - replays} of {eng.steps} windows ran eagerly; every "
                             "window is a graph replay")
    if not gap <= RAGGED_TOL:
        raise AssertionError(f"{name}: an emitted greedy token sits {gap} x max |logit| below the "
                             f"top of a teacher-forced prefill (tolerance {RAGGED_TOL})")
    for k, want in expected.items():
        if launches[k] != want:
            raise AssertionError(f"{name} {k}: {launches[k]} launches, expected {want}")
    if "paged" in engine_kw and eng.requeued == 0:
        raise AssertionError(f"{name}: no request waited for pool blocks while a slot was free")
    del eng
    torch.cuda.empty_cache()
    return {k: launches[k] for k in expected}


def teacher_forced_gap(model, dev, prompt, toks, kv_dtype: str = "bf16") -> float:
    """How far below the top of a teacher-forced prefill of prompt + toks[:-1]
    the emitted tokens sit: max over positions of (max logit - logit of the
    token) / max |logit|, over a cache of `kv_dtype`."""
    ids = np.concatenate([np.asarray(prompt), np.asarray(toks[:-1])])
    logits, _ = model(torch.as_tensor(ids[None], device=dev),
                      model.init_cache(1, S_CACHE, kv_dtype=kv_dtype), last_only=False)
    lg = logits[0, len(prompt) - 1 :].float()
    chosen = lg.gather(1, torch.as_tensor(np.asarray(toks), device=dev)[:, None])[:, 0]
    return ((lg.max(-1).values - chosen) / lg.abs().max(-1).values).max().item()


# the prefix-cache engine run (bench.py's bench_engine("prefix")): a shared
# 128-token prefix and a distinct 128-token tail, 8 requests x 48 new tokens;
# the first admission stores its prompt, the other seven reuse the prefix
PREFIX_REQUESTS, PREFIX_NEW = 8, 48
# the bf16 engine with eager windows: commit c967662's final smoke, engine_bf16
# (NVIDIA H100 80GB HBM3, 700.00 W)
EAGER_ENGINE_BF16_TOK_S = 85.7


def serve_prefix(model, dev) -> dict:
    """ContinuousEngine(prefix_cache=8) over a bf16 slot cache on `model`:
    exact prefix_hits (7) and prefix_tokens_reused (7 x 128), 48
    in-vocabulary tokens a request, 4 greedy requests within RAGGED_TOL x
    max |logit| of a teacher-forced prefill, exact launch counts (one
    flash_attention prefill a layer and admission: whole prompts and
    suffixes alike)."""
    from mllm_tpu_torch.generation import graphs
    from mllm_tpu_torch.generation.engine import ContinuousEngine, collect

    L, V = model.cfg.num_hidden_layers, model.cfg.vocab_size
    rng = np.random.default_rng(0)
    shared = rng.integers(0, V, 128)
    prompts = [np.concatenate([shared, rng.integers(0, V, 128)]) for _ in range(PREFIX_REQUESTS)]
    kernels = wrappers()
    torch.cuda.synchronize()
    eng = ContinuousEngine(model, start_thread=False, prefix_cache=8, **ENGINE_KW)
    for fn in kernels.values():
        fn.launches = 0
    graphs.reset_counts()
    t0 = time.perf_counter()
    qs = [eng.submit(p, PREFIX_NEW) for p in prompts]
    while any(r is not None for r in eng.req) or not eng.pending.empty() or eng._inflight is not None:
        eng.step()
    outs = [collect(q, timeout=5) for q in qs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = graphs.device_launches({k: fn.launches for k, fn in kernels.items()})
    steps = eng.steps * eng.window + len(eng._windows)  # and each window graph's warm-up call
    expected = {"flash_attention": L * eng.admissions, "decode_attention": L * steps,
                **{k: 0 for k in ("flash_attention_quant", "decode_attention_quant", "decode_attention_paged")}}
    gap = max(teacher_forced_gap(model, dev, prompts[i], outs[i]) for i in (0, 1, 4, 7))
    want_hits, want_reused = PREFIX_REQUESTS - 1, (PREFIX_REQUESTS - 1) * 128
    replays = sum(g.replays for g in eng._windows.values())
    capture_s = sum(g.capture_s for g in eng._windows.values())
    emit(phase="slice_engine", run="engine_prefix", requests=PREFIX_REQUESTS, new_tokens=PREFIX_NEW,
         prompt_tokens="128 shared + 128 distinct", wall_s=wall, tok_s=PREFIX_REQUESTS * PREFIX_NEW / wall,
         capture_s=capture_s, tok_s_less_capture=PREFIX_REQUESTS * PREFIX_NEW / (wall - capture_s),
         eager_windows_engine_bf16_tok_s=EAGER_ENGINE_BF16_TOK_S, windows=eng.steps, graph_replays=replays,
         admissions=eng.admissions,
         prefix_hits=eng.prefix_hits, prefix_tokens_reused=eng.prefix_tokens_reused,
         expected_hits=want_hits, expected_reused=want_reused, teacher_forced_gap_over_max_logit=gap,
         tolerance=RAGGED_TOL, launches=launches, launches_expected=expected)
    if not all(len(o) == PREFIX_NEW and all(0 <= t < V for t in o) for o in outs):
        raise AssertionError(f"engine_prefix: lengths {[len(o) for o in outs]} or a token out of the vocabulary")
    if replays != eng.steps:
        raise AssertionError(f"engine_prefix: {eng.steps - replays} of {eng.steps} windows ran eagerly")
    if (eng.prefix_hits, eng.prefix_tokens_reused) != (want_hits, want_reused):
        raise AssertionError(f"engine_prefix: hits {eng.prefix_hits}, reused {eng.prefix_tokens_reused}; "
                             f"expected {want_hits}, {want_reused}")
    if not gap <= RAGGED_TOL:
        raise AssertionError(f"engine_prefix: teacher-forced gap {gap} > {RAGGED_TOL}")
    for k, want in expected.items():
        if launches[k] != want:
            raise AssertionError(f"engine_prefix {k}: {launches[k]} launches, expected {want}")
    del eng
    torch.cuda.empty_cache()
    return {k: launches[k] for k in expected}


def phase_slice_engine(dev, model) -> dict:
    """ContinuousEngine over the int8-weight model, once per slot cache: bf16
    SlotKVCache (on the loop thread), int8 and int4 SlotQuantKVCache, and a
    PagedKVCache whose pool is 4 blocks short of what the first eight
    requests reserve (admission has to requeue)."""
    L = model.cfg.num_hidden_layers
    runs = [
        ("bf16", {}, ("flash_attention", "decode_attention"), True),
        ("int8", {"kv_dtype": "int8"}, ("flash_attention_quant", "decode_attention_quant"), False),
        ("int4", {"kv_dtype": "int4"}, ("flash_attention_quant", "decode_attention_quant"), False),
        ("paged", {"paged": paged_blocks_short_of(ENGINE_LENS, 4)},
         ("flash_attention", "decode_attention_paged"), False),
    ]
    launches = {}
    for name, kw, (prefill_k, decode_k), thread in runs:
        others = {"flash_attention", "decode_attention", "flash_attention_quant",
                  "decode_attention_quant", "decode_attention_paged"} - {prefill_k, decode_k}

        def expected(admissions, steps, prefill_k=prefill_k, decode_k=decode_k, others=others):
            return {prefill_k: L * admissions, decode_k: L * steps, **{k: 0 for k in others}}

        for k, n in serve(model, dev, f"engine_{name}", kw, expected, start_thread=thread).items():
            launches[k] = launches.get(k, 0) + n
    for k, n in serve_prefix(model, dev).items():
        launches[k] = launches.get(k, 0) + n
    return launches


def unique_bytes(module) -> int:
    """Bytes of the distinct storages behind a module's tensors (views count once)."""
    storages = {}
    for t in module.state_dict().values():
        st = t.untyped_storage()
        storages[st.data_ptr()] = st.nbytes()
    return sum(storages.values())


def phase_slice_mega(dev) -> dict:
    """MegaDecodeLM.from_float of the full-width random bf16 model on the card,
    then the main path: generate at b=1 (prompts 100 and 1500) and
    batched_generate at b=8 lockstep, every decode step one megakernel launch
    and the int4 head; then ragged_batched_generate, which goes through the
    int4 base model. Checks finite logits, tokens in the vocabulary, the last
    b=1 decode step against a fresh base prefill, 8 teacher-forced steps of
    mega against base (b=1, and 3 at b=8), and the exact launch counts."""
    from mllm_tpu_torch.core.config import TextConfig
    from mllm_tpu_torch.generation.generate import (batched_generate, generate, pad_to_bucket,
                                                    prefill, ragged_batched_generate)
    from mllm_tpu_torch.generation.sampling import SamplingConfig
    from mllm_tpu_torch.models.megadecode import MegaDecodeLM

    cfg = TextConfig(**QWEN2VL_2B_LM)
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    model = init_model(cfg, dev)
    bf16_bytes = state_bytes(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mega = MegaDecodeLM.from_float(model)
    torch.cuda.synchronize()
    from_float_s = time.perf_counter() - t0
    del model
    torch.cuda.empty_cache()
    stack_bytes = sum(t.numel() * t.element_size() for k, t in mega.state_dict().items()
                      if not k.startswith("base."))
    emit(phase="slice_mega_from_float", seconds=from_float_s, bf16_weight_bytes=bf16_bytes,
         kernel_stack_bytes=stack_bytes, weight_bytes=unique_bytes(mega))

    base = mega.base
    finite = torch.ones((), dtype=torch.bool, device=dev)
    last = {}
    plain_logits = base.logits

    def checked_logits(hidden):
        nonlocal finite
        out = plain_logits(hidden)
        finite = finite & torch.isfinite(out).all()
        last["logits"] = out
        return out

    base.logits = checked_logits
    kernels = wrappers()
    rng = np.random.default_rng(3)

    def ratio(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()

    def timed_prefill(b, n):
        ids = torch.as_tensor(pad_to_bucket(rng.integers(0, V, (b, n))), device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        prefill(mega, mega.init_cache(b, S_CACHE), ids, n)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    generate(mega, rng.integers(0, V, 100), mega.init_cache(1, S_CACHE), SamplingConfig(max_new_tokens=4))
    prefill_b8_s = float(np.median([timed_prefill(8, 100) for _ in range(3)]))
    torch.cuda.reset_peak_memory_stats()

    # the main path: counts set to 0 just before, read just after
    for fn in kernels.values():
        fn.launches = 0
    prompt100 = rng.integers(0, V, 100)
    res100, _ = generate(mega, prompt100, mega.init_cache(1, S_CACHE), SamplingConfig(max_new_tokens=64))
    last_step = last["logits"][:, -1].float()
    res1500, _ = generate(mega, rng.integers(0, V, 1500), mega.init_cache(1, S_CACHE),
                          SamplingConfig(max_new_tokens=32))
    ids8 = rng.integers(0, V, (8, 100))
    torch.cuda.synchronize()
    t = time.perf_counter()
    toks8, _ = batched_generate(mega, ids8, np.full(8, 100), mega.init_cache(8, S_CACHE),
                                SamplingConfig(max_new_tokens=32))
    torch.cuda.synchronize()
    b8_s = time.perf_counter() - t
    launches = {name: fn.launches for name, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    steps_b1 = len(res100.tokens) - 1 + len(res1500.tokens) - 1
    steps_b8 = toks8.shape[1] - 1
    prefills = 3
    none = {k: 0 for k in ("flash_attention_quant", "decode_attention_quant", "decode_attention_paged")}
    expected = {"flash_attention": L * prefills, "decode_attention": 0, "int8_matmul": 0,
                "int4_matmul": steps_b1 + steps_b8 + prefills, "fused_int4_mlp": 0,
                "fused_decode_step": steps_b1, "fused_decode_step_batched": steps_b8, **none}

    # ragged batch: left padding goes through the int4 base model
    for fn in kernels.values():
        fn.launches = 0
    prompts = [rng.integers(0, V, n) for n in (17, 64, 128, 200)]
    toks_r, _, _ = ragged_batched_generate(mega, prompts, mega.init_cache(4, S_CACHE),
                                           SamplingConfig(max_new_tokens=16))
    launches_r = {name: fn.launches for name, fn in kernels.items()}
    steps_r = toks_r.shape[1] - 1
    expected_r = {"flash_attention": L, "decode_attention": L * steps_r, "int8_matmul": 0,
                  "int4_matmul": (2 * L + 1) * steps_r + 1, "fused_int4_mlp": L * steps_r,
                  "fused_decode_step": 0, "fused_decode_step_batched": 0, **none}

    # the last b=1 decode step against a fresh base prefill of the same tokens
    ids = np.concatenate([prompt100, res100.tokens[:-1]])
    lg_fresh, _ = prefill(base, base.init_cache(1, S_CACHE),
                          torch.as_tensor(pad_to_bucket(ids[None]), device=dev), len(ids))
    vs_prefill = ratio(last_step, lg_fresh)
    # teacher-forced: the same tokens through mega and base, step by step
    teacher = 0.0
    for b, toks, n_steps in ((1, np.array([res100.tokens]), 8), (8, toks8, 3)):
        ids = torch.as_tensor(pad_to_bucket(np.asarray(prompt100 if b == 1 else ids8).reshape(b, -1)),
                              device=dev)
        _, cm = prefill(base, base.init_cache(b, S_CACHE), ids, 100)
        _, cb = prefill(base, base.init_cache(b, S_CACHE), ids, 100)
        for i in range(n_steps):
            tok = torch.as_tensor(toks[:, i : i + 1], device=dev)
            lm, cm = mega(tok, cm)
            lb, cb = base(tok, cb)
            teacher = max(teacher, ratio(lm, lb))
    torch.cuda.synchronize()
    base.logits = plain_logits
    all_finite = bool(finite)
    emit(phase="slice_mega", prompt_tokens=[100, 1500, "8 x 100", [17, 64, 128, 200]],
         new_tokens=[len(res100.tokens), len(res1500.tokens), int(toks8.shape[1]), int(toks_r.shape[1])],
         decode_tok_s_b1_ctx100=res100.decode_tps, decode_tok_s_b1_ctx1500=res1500.decode_tps,
         decode_tok_s_b8_lockstep=8 * steps_b8 / (b8_s - prefill_b8_s),
         ttft_ms_1500_tokens=res1500.ttft_s * 1e3,
         max_memory_allocated_bytes=peak, last_decode_vs_prefill=vs_prefill,
         teacher_forced_mega_vs_base=teacher, tolerance=RAGGED_TOL, logits_finite=all_finite,
         launches=launches, launches_expected=expected, ragged_launches=launches_r,
         ragged_launches_expected=expected_r)
    if not all_finite:
        raise AssertionError("slice_mega: non-finite logits")
    outs = [np.array(res100.tokens), np.array(res1500.tokens), toks8, toks_r]
    if not all(((0 <= o) & (o < V)).all() for o in outs):
        raise AssertionError("slice_mega: token out of vocabulary")
    if not (vs_prefill <= RAGGED_TOL and teacher <= RAGGED_TOL):
        raise AssertionError(f"slice_mega: mega vs base {vs_prefill}, {teacher} > {RAGGED_TOL}")
    if launches != expected or launches_r != expected_r:
        raise AssertionError(f"slice_mega: launches {launches} / {launches_r}, expected {expected} / "
                             f"{expected_r}")
    # serving on the batched megakernel: admissions through the int4 base,
    # every decode step one launch with the slots at their own positions
    launches_e = serve(mega, dev, "engine_int4mega", {}, lambda admissions, steps: {
        "flash_attention": L * admissions, "fused_decode_step_batched": steps,
        "fused_decode_step": 0, "decode_attention": 0})
    launches_c = compiled_run(mega, dev, "mega")  # b=1: every step one fused_decode_step, device pos
    if launches_c["fused_decode_step"] == 0 or launches_c["decode_attention"] != 0:
        raise AssertionError(f"slice_compiled mega: launches {launches_c}")
    del mega, base
    torch.cuda.empty_cache()
    return {name: launches[name] + launches_r[name] + launches_e.get(name, 0) + launches_c.get(name, 0)
            for name in launches}


def main():
    kind = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    rows = phase_kernels(dev)
    launches = {name: 0 for name in SOURCES}
    results = [phase_slice(dev)]
    int8_launches, model8 = phase_slice_quant(dev, "int8", keep=True)
    results += [int8_launches, phase_slice_kvq(dev, model8), phase_slice_sd(dev, model8),
                phase_slice_prefill(dev, model8), phase_slice_engine(dev, model8)]
    del model8
    torch.cuda.empty_cache()
    results += [phase_slice_quant(dev, "int4"), phase_slice_mega(dev)]
    for phase_launches in results:
        for name, n in phase_launches.items():
            launches[name] += n
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        main_row = rows[name][MAIN_ROW[name]]
        kernel = dict(name=name, route="cuda", source=src, replaces=replaces,
                      launches=launches[name],
                      max_abs_err=max(r["max_abs_err"] for r in rows[name]),
                      ms=main_row["ms"], plain_ms=main_row["plain_ms"], bound_ms=main_row["bound_ms"],
                      bound_by=main_row["bound_by"], library_ms=main_row["library_ms"])
        if "rel_err" in main_row:
            kernel["max_rel_err"] = max(r["rel_err"] for r in rows[name])
        for extra in ("dense_sdpa_ms", "bf16_flash_ms", "bf16_decode_ms", "dense_decode_ms", "unfused_ms"):
            if extra in main_row:
                kernel[extra] = main_row[extra]
        kernels.append(kernel)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
