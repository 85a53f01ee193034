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
     over the kernel time, against the H100's 3.35 TB/s.
  4. slice: a Qwen2-VL-2B-geometry LM (28 layers, random bf16 weights from a
     seeded generator) through generate, ragged_batched_generate and a
     sampled generate.
  5. slice_int8 / slice_int4: the same bf16 model after fuse_projections +
     quantize_model("int8" / "int4", on_device=True) on the card, through the
     same entry points (ragged batch of 8 for int8, 4 for int4).
  Every slice phase checks finite logits, tokens inside the vocabulary,
  ragged-vs-alone prefill logits, the last greedy decode step's logits
  against a fresh prefill of the same tokens (<= 0.1 x max |logit|), and
  that each kernel of the path launched at least as often as the path needs;
  the counters are set to 0 just before a phase drives its path and read
  just after.
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
QUANT_TOL = {"int8_matmul": 2e-3, "int4_matmul": 2e-3, "fused_int4_mlp": 1e-2}  # relative
RAGGED_TOL = 1e-1  # x max |logit|
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# the kernel-check rows whose times go into the {"kernels": ...} line: for
# attention the shapes of the 1500-token prompt (its prefill, its last decode
# step); for the products the headline shapes of their phases
MAIN_ROW = {"flash_attention": 5, "decode_attention": 1, "int8_matmul": 1, "int4_matmul": 4,
            "fused_int4_mlp": 0}
SOURCES = {
    "flash_attention": ("mllm_tpu_torch/csrc/flash_attention.cu",
                        "mllm_tpu/ops/flash_attention.py:230"),
    "decode_attention": ("mllm_tpu_torch/csrc/decode_attention.cu",
                         "mllm_tpu/ops/decode_attention.py:317"),
    "int8_matmul": ("mllm_tpu_torch/csrc/int8_matmul.cu", "mllm_tpu/ops/quant_matmul.py:89"),
    "int4_matmul": ("mllm_tpu_torch/csrc/int4_matmul.cu", "mllm_tpu/ops/quant_matmul.py:322"),
    "fused_int4_mlp": ("mllm_tpu_torch/csrc/fused_int4_mlp.cu", "mllm_tpu/ops/fused_mlp.py:169"),
}


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


def wrappers() -> dict:
    """Kernel name -> its wrapper (each counts its launches in `.launches`)."""
    from mllm_tpu_torch.ops.decode_attention import decode_attention
    from mllm_tpu_torch.ops.flash_attention import flash_attention
    from mllm_tpu_torch.ops.fused_mlp import fused_int4_mlp
    from mllm_tpu_torch.ops.quant_matmul import int4_matmul, int8_matmul

    return {"flash_attention": flash_attention, "decode_attention": decode_attention,
            "int8_matmul": int8_matmul, "int4_matmul": int4_matmul,
            "fused_int4_mlp": fused_int4_mlp}


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
    rows.update(quant_kernel_rows(dev, g))
    return rows


def quant_kernel_rows(dev, g) -> dict:
    """The quantized products against their plain versions, at the shapes of
    the int8 and int4 phases (Qwen2-VL-2B: qkv 1536->2048, o 1536->1536,
    gate||up 1536->17920, down 8960->1536, head 1536->151936 (int4: padded
    to 152064); m = decode batch, or prefill tokens for int8)."""
    from mllm_tpu_torch.ops import quant_matmul as qm
    from mllm_tpu_torch.ops.fused_mlp import (fused_int4_mlp, fused_int4_mlp_ref,
                                              pick_block_f, prepare_int4_ff)
    from mllm_tpu_torch.ops.quantize_model import _q4_device, _q8_device

    def weight(n, k):
        return torch.randn(n, k, device=dev, generator=g) * 0.02

    def x_rows(m, k):
        return torch.randn(m, k, device=dev, generator=g).to(torch.bfloat16)

    def check(name, kernel, plain, shape, weight_bytes):
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        rel = err / ref.float().abs().max().item()
        finite = bool(torch.isfinite(out).all())
        ms = time_ms(kernel, 20)
        row = dict(phase="kernel_check", kernel=name, shape=shape, max_abs_err=err, rel_err=rel,
                   tolerance=QUANT_TOL[name], finite=finite, ms=ms, plain_ms=time_ms(plain, 5),
                   weight_bytes=weight_bytes, weight_tb_per_s=weight_bytes / ms / 1e9,
                   hbm_tb_per_s=HBM_BYTES_PER_S / 1e12)
        emit(**row)
        if not finite or not rel <= QUANT_TOL[name]:
            raise AssertionError(f"{name} {shape}: max |kernel - plain| / max |plain| {rel} "
                                 f"(tolerance {QUANT_TOL[name]}), finite={finite}")
        return row

    rows = {"int8_matmul": [], "int4_matmul": [], "fused_int4_mlp": []}
    for m, k, n in [(1, 1536, 2048), (8, 1536, 17920), (8, 8960, 1536), (8, 1536, 151936),
                    (128, 1536, 2048), (1536, 1536, 17920)]:
        q, s = _q8_device(weight(n, k))
        x = x_rows(m, k)
        rows["int8_matmul"].append(check(
            "int8_matmul", lambda: qm.int8_matmul(x, q, s), lambda: qm.int8_matmul_ref(x, q, s),
            dict(m=m, K=k, N=n), k * n + 4 * n))
        del q, s

    def int4_bytes(k, n, affine):
        return k // 2 * n + (2 if affine else 1) * (k // 32) * n * 4

    for m, k, n, affine in [(1, 1536, 2048, False), (1, 1536, 1536, False),
                            (8, 1536, 2048, False), (32, 8960, 1536, False),
                            (1, 1536, 152064, False),  # the padded int4 lm_head
                            (1, 1536, 2048, True), (4, 8960, 1536, True),
                            (8, 960, 2048, False)]:  # K/2 = 480 padded to 512
        p, s, z = qm.prepare_int4(*_q4_device(weight(n, k)), qm.GROUP)
        if affine:  # random nibbles, scales and zeros; padded rows stay zero
            live = s != 0
            p = torch.randint(0, 256, p.shape, device=dev, generator=g, dtype=torch.uint8)
            p[k // 2:] = 0
            s = torch.rand(s.shape, device=dev, generator=g) * 0.02 * live
            z = torch.randn(s.shape, device=dev, generator=g) * 0.05 * live
        else:
            z = None
        x = x_rows(m, k)
        rows["int4_matmul"].append(check(
            "int4_matmul", lambda: qm.int4_matmul(x, p, s, qm.GROUP, z),
            lambda: qm.int4_matmul_ref(x, p, s, qm.GROUP, z),
            dict(m=m, K=k, N=n, affine=affine, khp=p.shape[0]), int4_bytes(k, n, affine)))
        del p, s, z

    d, ff = QWEN2VL_2B_LM["hidden_size"], QWEN2VL_2B_LM["intermediate_size"]
    block_f = pick_block_f(ff)
    gate = tuple(qm.prepare_int4(*_q4_device(weight(ff, d)), qm.GROUP)[:2])
    up = tuple(qm.prepare_int4(*_q4_device(weight(ff, d)), qm.GROUP)[:2])
    down = tuple(prepare_int4_ff(*_q4_device(weight(d, ff)), None, block_f)[:2])
    for m, act, affine in [(1, "silu", False), (8, "silu", False), (32, "silu", False),
                           (4, "silu", True), (1, "gelu_new", False)]:
        # affine: the same weights with their zeros stored (-8 * scales)
        ops = [op + ((-8.0 * op[1]) if affine else None,) for op in (gate, up, down)]
        x = x_rows(m, d)
        rows["fused_int4_mlp"].append(check(
            "fused_int4_mlp", lambda: fused_int4_mlp(x, *ops, act=act, block_f=block_f),
            lambda: fused_int4_mlp_ref(x, *ops, act=act, block_f=block_f),
            dict(m=m, d=d, ff=ff, block_f=block_f, act=act, affine=affine),
            2 * int4_bytes(d, ff, affine) + int4_bytes(ff, d, affine)))
    return rows


def drive(model, cfg, dev, phase: str, ragged_lens, expected_per) -> dict:
    """Run the main path of one slice phase through the user entry points and
    check it. expected_per(prefills, steps) -> {kernel: least launches}."""
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

    def run_generate(prompt, scfg, seed=0):
        nonlocal prefills, steps
        res, _ = generate(model, prompt, model.init_cache(1, S_CACHE), scfg, seed=seed)
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
    lg_fresh, _ = prefill(model, model.init_cache(1, S_CACHE),
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
    b = len(ragged_lens)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in ragged_lens]
    ids, pad = left_pad(prompts)
    width = ids.shape[1]
    torch.cuda.synchronize()
    t = time.perf_counter()
    lg_ragged, _ = prefill(model, model.init_cache(b, S_CACHE), torch.as_tensor(ids, device=dev),
                           width, torch.as_tensor(pad, device=dev))
    torch.cuda.synchronize()
    ragged_prefill_s = time.perf_counter() - t
    prefills += 1
    worst = 0.0
    for i, p in enumerate(prompts):
        ids1 = torch.as_tensor(pad_to_bucket(p[None]), device=dev)
        lg_alone, _ = prefill(model, model.init_cache(1, S_CACHE), ids1, len(p))
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
    toks, _, _ = ragged_batched_generate(model, prompts, model.init_cache(b, S_CACHE),
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
        if launches[name] < want or launches[name] == 0:
            raise AssertionError(f"{phase} {name}: {launches[name]} launches, expected >= {want}")
    return {name: launches[name] for name in expected}


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
    return drive(model, cfg, dev, "slice", (17, 64, 128, 200),
                 lambda prefills, steps: {"flash_attention": L * prefills,
                                          "decode_attention": L * steps})


def phase_slice_quant(dev, mode: str) -> dict:
    """fuse_projections + quantize_model(mode, on_device=True) of the bf16
    model on the card, then the main path through the quantized model."""
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
    launches = drive(model, cfg, dev, f"slice_{mode}", lens, expected)
    del model
    torch.cuda.empty_cache()
    return launches


def main():
    kind = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    rows = phase_kernels(dev)
    launches = {name: 0 for name in SOURCES}
    for phase_launches in (phase_slice(dev), phase_slice_quant(dev, "int8"),
                           phase_slice_quant(dev, "int4")):
        for name, n in phase_launches.items():
            launches[name] += n
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        main_row = rows[name][MAIN_ROW[name]]
        kernel = dict(name=name, route="cuda", source=src, replaces=replaces,
                      launches=launches[name],
                      max_abs_err=max(r["max_abs_err"] for r in rows[name]),
                      ms=main_row["ms"], plain_ms=main_row["plain_ms"])
        if "rel_err" in main_row:
            kernel["max_rel_err"] = max(r["rel_err"] for r in rows[name])
        kernels.append(kernel)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
