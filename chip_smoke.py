"""End-to-end check of the PyTorch port (mllm_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (each prints JSON lines; any failure raises and exits non-zero):
  1. device: needs a CUDA card; prints its name and power limit as nvidia-smi
     reports them; TF32 off for matmuls and convolutions.
  2. build: compiles the CUDA kernels in mllm_tpu_torch/csrc with nvcc.
  3. kernel vs plain: each kernel against its plain PyTorch version on the
     same bf16 inputs at the slice's shapes (H=12, H_kv=2, D=128, cache
     2048), max |kernel - plain| <= 2e-2 (bf16 output rounding plus another
     summation order), and both times (CUDA events, after warm-up).
  4. slice: a Qwen2-VL-2B-geometry LM (28 layers, random bf16 weights from a
     seeded generator) through generate, ragged_batched_generate and a
     sampled generate, with launch counters, finite logits and ragged-vs-alone
     prefill logits checked.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX or mllm_tpu.
"""

from __future__ import annotations

import json
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
RAGGED_TOL = 1e-1  # x max |logit|
# the kernel-check rows whose times go into the {"kernels": ...} line: the
# shapes of the 1500-token prompt (its prefill, and its last decode step)
MAIN_ROW = {"flash_attention": 5, "decode_attention": 1}


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
    emit(phase="build", seconds=round(seconds, 3), library=path,
         ptxas=[ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln])


def phase_kernels(dev) -> dict:
    from mllm_tpu_torch.ops.decode_attention import decode_attention, decode_attention_ref
    from mllm_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref

    g = torch.Generator(device=dev).manual_seed(1234)

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=g).to(torch.bfloat16)

    def ivec(xs):
        return torch.tensor(xs, device=dev, dtype=torch.int32)

    def check(name, kernel, plain, shape):
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        # every row is compared: both versions write zeros where a row sees no key
        err = (out.float() - ref.float()).abs().max().item()
        finite = bool(torch.isfinite(out.float()).all())
        row = dict(phase="kernel_check", kernel=name, shape=shape, max_abs_err=err,
                   finite=finite, ms=time_ms(kernel, 20), plain_ms=time_ms(plain, 5))
        emit(**row)
        if not finite or not err <= TOL:
            raise AssertionError(f"{name} {shape}: max |kernel - plain| {err} (tolerance {TOL}), "
                                 f"finite={finite}")
        return row

    rows = {"flash_attention": [], "decode_attention": []}
    # flash: (B, Sq, q_offset, kv_valid, kv_start, window)
    for b, sq, qoff, kvl, start, window in [
        (1, 128, 0, 128, None, None),
        (1, 200, 0, 200, None, None),
        (1, 128, 256, 384, None, None),            # chunk of a chunked prefill
        (4, 200, 0, 200, [0, 17, 64, 150], None),  # left-padded ragged batch
        (1, 200, 0, 200, None, 64),                # sliding window
        (1, 1536, 0, 1536, None, None),            # the 1500-token prompt's bucket
    ]:
        q, k, v = rnd(b, sq, H, D), rnd(b, HKV, S_CACHE, D), rnd(b, HKV, S_CACHE, D)
        kw = dict(q_offset=qoff, kv_valid_len=kvl,
                  kv_start=None if start is None else ivec(start), window=window)
        rows["flash_attention"].append(check(
            "flash_attention", lambda: flash_attention(q, k, v, **kw),
            lambda: flash_attention_ref(q, k, v, **kw),
            dict(B=b, Sq=sq, H=H, Hkv=HKV, D=D, S=S_CACHE, q_offset=qoff, kv_valid=kvl,
                 kv_start=start, window=window)))
    # decode: (B, kv_valid per sequence, kv_start, window)
    for b, kvl, start, window in [
        (1, [2048], None, None),
        (1, [1531], None, None),  # the 1500-token prompt's last decode step
        (4, [1, 511, 513, 2048], None, None),
        (4, [231, 231, 231, 231], [183, 136, 72, 0], None),  # the ragged batch's last step
        (8, [1, 511, 513, 2048, 100, 1000, 1531, 777], [0, 0, 5, 100, 0, 50, 0, 3], None),
        (4, [1, 511, 513, 2048], [0, 3, 7, 9], 256),
    ]:
        q, k, v = rnd(b, 1, H, D), rnd(b, HKV, S_CACHE, D), rnd(b, HKV, S_CACHE, D)
        kw = dict(kv_valid_len=ivec(kvl), kv_start=None if start is None else ivec(start),
                  window=window)
        rows["decode_attention"].append(check(
            "decode_attention", lambda: decode_attention(q, k, v, **kw),
            lambda: decode_attention_ref(q, k, v, **kw),
            dict(B=b, H=H, Hkv=HKV, D=D, S=S_CACHE, kv_valid=kvl, kv_start=start,
                 window=window)))
    return rows


def phase_slice(dev) -> dict:
    from mllm_tpu_torch.core.config import TextConfig
    from mllm_tpu_torch.generation.generate import (
        generate, left_pad, pad_to_bucket, prefill, ragged_batched_generate)
    from mllm_tpu_torch.generation.sampling import SamplingConfig
    from mllm_tpu_torch.models.transformer import CausalLM
    from mllm_tpu_torch.ops.decode_attention import decode_attention
    from mllm_tpu_torch.ops.flash_attention import flash_attention

    cfg = TextConfig(**QWEN2VL_2B_LM)
    t0 = time.perf_counter()
    model = CausalLM.init(cfg, device=dev, dtype=torch.bfloat16,
                          generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    emit(phase="slice_init", seconds=time.perf_counter() - t0, params=n_params,
         weight_bytes=sum(p.numel() * p.element_size() for p in model.parameters()))

    # every logits call of the run is checked for finite values, on the device
    finite = torch.ones((), dtype=torch.bool, device=dev)
    plain_logits = model.logits

    def checked_logits(hidden):
        nonlocal finite
        out = plain_logits(hidden)
        finite = finite & torch.isfinite(out).all()
        return out

    model.logits = checked_logits
    rng = np.random.default_rng(0)
    L = cfg.num_hidden_layers
    greedy = SamplingConfig(max_new_tokens=64)
    torch.cuda.reset_peak_memory_stats()

    flash_attention.launches = 0
    decode_attention.launches = 0
    prefills, steps = 0, 0

    def run_generate(prompt, scfg, seed=0):
        nonlocal prefills, steps
        res, _ = generate(model, prompt, model.init_cache(1, S_CACHE), scfg, seed=seed)
        prefills += 1
        steps += len(res.tokens) - 1
        return res

    run_generate(rng.integers(0, cfg.vocab_size, 100), SamplingConfig(max_new_tokens=8))  # warm-up
    res100 = run_generate(rng.integers(0, cfg.vocab_size, 100), greedy)
    res1500 = run_generate(rng.integers(0, cfg.vocab_size, 1500), SamplingConfig(max_new_tokens=32))

    def timed_prefill(n):
        ids = torch.as_tensor(pad_to_bucket(rng.integers(0, cfg.vocab_size, (1, n))), device=dev)
        cache = model.init_cache(1, S_CACHE)
        torch.cuda.synchronize()
        t = time.perf_counter()
        prefill(model, cache, ids, n)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    prefill_ms_100 = float(np.median([timed_prefill(100) for _ in range(3)]))
    prefill_ms_1500 = float(np.median([timed_prefill(1500) for _ in range(3)]))
    prefills += 6

    # ragged batch: prefill logits of each row against the prompt alone
    lens = (17, 64, 128, 200)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    ids, pad = left_pad(prompts)
    width = ids.shape[1]
    torch.cuda.synchronize()
    t = time.perf_counter()
    lg_ragged, _ = prefill(model, model.init_cache(4, S_CACHE), torch.as_tensor(ids, device=dev),
                           width, torch.as_tensor(pad, device=dev))
    torch.cuda.synchronize()
    ragged_prefill_s = time.perf_counter() - t
    prefills += 1
    worst = 0.0
    for i, p in enumerate(prompts):
        ids1 = torch.as_tensor(pad_to_bucket(p[None]), device=dev)
        lg_alone, _ = prefill(model, model.init_cache(1, S_CACHE), ids1, len(p))
        prefills += 1
        ratio = ((lg_ragged[i] - lg_alone[0]).abs().max() / lg_alone[0].abs().max()).item()
        worst = max(worst, ratio)
    emit(phase="ragged_vs_alone", max_abs_diff_over_max_logit=worst, tolerance=RAGGED_TOL)
    if not worst <= RAGGED_TOL:
        raise AssertionError(f"ragged prefill logits differ from single-stream: {worst} > {RAGGED_TOL}")

    torch.cuda.synchronize()
    t = time.perf_counter()
    toks, _, _ = ragged_batched_generate(model, prompts, model.init_cache(4, S_CACHE),
                                               SamplingConfig(max_new_tokens=32))
    torch.cuda.synchronize()
    ragged_s = time.perf_counter() - t
    prefills += 1
    steps += toks.shape[1] - 1
    if toks.shape != (4, 32):
        raise AssertionError(f"ragged_batched_generate returned {toks.shape}, expected (4, 32)")
    decode_tps_b4 = 4 * (toks.shape[1] - 1) / (ragged_s - ragged_prefill_s)

    sampled = run_generate(rng.integers(0, cfg.vocab_size, 100),
                           SamplingConfig(max_new_tokens=16, do_sample=True, top_k=50, top_p=0.9),
                           seed=7)
    torch.cuda.synchronize()
    launches = {"flash_attention": flash_attention.launches,
                "decode_attention": decode_attention.launches}
    expected = {"flash_attention": L * prefills, "decode_attention": L * steps}
    all_finite = bool(finite)
    for name, res in (("greedy_100", res100), ("greedy_1500", res1500), ("sampled", sampled)):
        if not all(0 <= t < cfg.vocab_size for t in res.tokens):
            raise AssertionError(f"{name}: token out of vocabulary")
    emit(phase="slice", prompt_tokens=[100, 1500, list(lens), 100],
         new_tokens=[len(res100.tokens), len(res1500.tokens), int(toks.shape[1]),
                     len(sampled.tokens)],
         prefill_ms_100_tokens=prefill_ms_100, prefill_ms_1500_tokens=prefill_ms_1500,
         ttft_ms_1500_tokens=res1500.ttft_s * 1e3,
         decode_tok_s_b1_ctx100=res100.decode_tps, decode_tok_s_b1_ctx1500=res1500.decode_tps,
         decode_tok_s_b4_ragged=decode_tps_b4,
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
         launches=launches, launches_expected_at_least=expected, logits_finite=all_finite)
    if not all_finite:
        raise AssertionError("non-finite logits on the main path")
    for name in launches:
        if launches[name] < expected[name] or launches[name] == 0:
            raise AssertionError(f"{name}: {launches[name]} launches, expected >= {expected[name]}")
    return launches


def main():
    kind = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    rows = phase_kernels(dev)
    launches = phase_slice(dev)
    sources = {"flash_attention": ("mllm_tpu_torch/csrc/flash_attention.cu",
                                   "mllm_tpu/ops/flash_attention.py:230"),
               "decode_attention": ("mllm_tpu_torch/csrc/decode_attention.cu",
                                    "mllm_tpu/ops/decode_attention.py:317")}
    kernels = []
    for name, (src, replaces) in sources.items():
        main_row = rows[name][MAIN_ROW[name]]
        kernels.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                            launches=launches[name],
                            max_abs_err=max(r["max_abs_err"] for r in rows[name]),
                            ms=main_row["ms"], plain_ms=main_row["plain_ms"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
