"""Generic chat demo: counterpart of `examples/demo_llm.py` of the JAX repo
(the reference's demo_qwen / demo_llama CLIs):

  python -m mllm_tpu_torch.examples.demo_llm -m <model_dir> [-l kv_limit] [-q int8|int8-a8|int4|int4-mixed] \\
      [--prompt "..."] [--max-new 100] [--temperature 0.7 --top-k 40] [--device cuda|cpu]

Model dir = HF-style directory (config.json + safetensors + tokenizer.json)
or a directory of .mllm files + tokenizer.json. Runs on the card unless
`--device cpu`. `main(argv)` returns what it generated (token ids) and the
run's timings.

`-q` offers every quantization mode of the JAX demo, quantizing the
checkpoint's float Linears at load: `int8`, `int8-a8` (int8 activations on
prefill), `int4`, and `int4-mixed` (the attention projections int8, every
other Linear int4).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ._demo_common import device, std_parser, stream_fn

DTYPE = torch.bfloat16  # the weights' and the bf16 cache's dtype


def parser() -> argparse.ArgumentParser:
    ap = std_parser(__doc__.split("\n\n")[0],
                    default_prompt="Give me a short introduction to large language models.")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=0.0)
    ap.add_argument("--no-chat-template", action="store_true")
    ap.add_argument("--chunked", type=int, default=0, metavar="CHUNK",
                    help="chunked prefill with this chunk size (one chunk shape for any prompt length)")
    ap.add_argument("--turns", type=int, default=1,
                    help=">1: repeat generation reusing the prompt cache (prefix-reuse demo)")
    ap.add_argument("--kv", choices=["bf16", "int8", "int4"], default="bf16",
                    help="KV cache dtype (int8 = 2x context, int4 = 4x; fused quant decode kernels; "
                         "reference KVCache_TYPE knob, int4 beyond its q8 floor)")
    ap.add_argument("--elastic", type=float, default=0, metavar="RATIO",
                    help="elastic inference: activate only the first RATIO fraction of heads/FFN "
                         "neurons (reference demo_elastic_llama activate_dims)")
    ap.add_argument("--batch", type=int, default=1,
                    help=">1: batched generation of this many prompts (ragged left-pad; reference "
                         "demo_qwen_batch)")
    ap.add_argument("--mbp", type=int, default=0, metavar="N_RESIDENT",
                    help="MoE models only: MBP expert offload - experts live in host RAM, at most "
                         "N_RESIDENT are cached on the device, routed experts stream in with "
                         "next-layer prefetch (reference demo_minicpm_moe_mbp)")
    ap.add_argument("--sparse", type=float, default=None, metavar="THRESH",
                    help="predictor-sparse FFN with this threshold (reference modeling_sparse_llama; "
                         "predictors are random unless shipped with the checkpoint)")
    return ap


def alias_main(argv, defaults: tuple) -> dict:
    """`main` of an alias module: argv (sys.argv[1:] if None) with the
    alias's `defaults` (a flag and its value) put in front unless the flag is
    given, as the JAX wrappers insert theirs."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if defaults and defaults[0] not in argv:
        argv[0:0] = list(defaults)
    return main(argv)


def _sampler_gen(dev, seed: int) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


@torch.no_grad()
def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    dev = device(args.device)

    from ..generation.generate import generate
    from ..generation.sampling import SamplingConfig
    from ..models.registry import auto_model
    from ..utils.profiling import Profiler

    t0 = time.perf_counter()
    model, tok, cfg = auto_model(args.model, dtype=DTYPE, quant=args.quant, device=dev)
    if args.elastic:
        from ..models.elastic import elastic_model

        model = elastic_model(model, args.elastic, args.elastic)
        down = model.blocks[0].mlp.down_proj
        print(f"[elastic] ratio {args.elastic}: heads {cfg.num_attention_heads}"
              f"->{model.cfg.num_attention_heads}, ffn {cfg.intermediate_size}"
              f"->{down.weight.shape[1] if hasattr(down, 'weight') else '?'}")
        cfg = model.cfg
    if args.sparse is not None:
        from ..models.elastic import make_predictors, sparse_model

        model = sparse_model(model, make_predictors(model, generator=_sampler_gen(dev, 0)),
                             threshold=args.sparse)
        print(f"[sparse] predictor-gated FFN, threshold {args.sparse}")
    prof = Profiler(load_s=time.perf_counter() - t0)
    if tok is None:
        print("no tokenizer.json found in model dir", file=sys.stderr)
        sys.exit(1)

    from ..tokenizers.chat_templates import render

    text = args.prompt if args.no_chat_template else render(cfg.model_type, args.prompt)
    ids = np.asarray(tok.encode(text, bos=True), np.int64)[None, :]
    print(f"[{cfg.model_type}] prompt tokens: {ids.shape[1]}")

    cache = model.init_cache(1, args.limits, DTYPE, kv_dtype=args.kv)
    scfg = SamplingConfig(
        max_new_tokens=args.max_new,
        do_sample=args.temperature > 0,
        temperature=args.temperature or 1.0,
        top_k=args.top_k, top_p=args.top_p,
    )
    stream = stream_fn(tok)

    if args.mbp:
        from ..models.moe import mbp_forward, to_mbp

        model, store = to_mbp(model, max_device_entries=args.mbp)
        print(f"[mbp] {len(store.host)} experts host-resident, device budget {args.mbp}")
        # MBP routes data-dependently through the host store: a host-driven
        # loop, greedy whatever the sampling flags say (as in the JAX demo)
        t0 = time.perf_counter()
        logits, cache = mbp_forward(model, torch.as_tensor(ids, device=dev), cache)
        tokv = int(torch.argmax(logits[0, -1]))
        ttft = time.perf_counter() - t0
        stream(tokv)
        out = [tokv]
        t0 = time.perf_counter()
        for _ in range(scfg.max_new_tokens - 1):
            logits, cache = mbp_forward(model, torch.tensor([[tokv]], device=dev), cache)
            tokv = int(torch.argmax(logits[0, -1]))
            if tokv == tok.eos_token_id:
                break
            stream(tokv)
            out.append(tokv)
        dt = time.perf_counter() - t0
        print(f"\n[mbp] ttft {ttft*1e3:.0f} ms, {len(out) / dt:.1f} tok/s, "
              f"expert cache hit rate {store.hit_rate:.1%} ({store.hits} hits / {store.misses} misses)")
        prof.ttft_s = ttft
        prof.decode_tps = len(out) / dt
        prof.report(args.model)
        return dict(ids=out, prompt_len=ids.shape[1], ttft_s=ttft, prefill_tps=ids.shape[1] / ttft,
                    decode_tps=prof.decode_tps, hit_rate=store.hit_rate)
    if args.batch > 1:
        from ..generation.generate import ragged_batched_generate

        prompts = [ids[0]]
        for i in range(1, args.batch):  # vary lengths to exercise ragged padding
            prompts.append(prompts[0][: max(1, len(prompts[0]) - i % 5)])
        cache = model.init_cache(args.batch, args.limits, DTYPE, kv_dtype=args.kv)
        t0 = time.perf_counter()
        toks, n_valid, _ = ragged_batched_generate(model, prompts, cache, scfg)
        dt = time.perf_counter() - t0
        for i in range(args.batch):
            print(f"[seq {i}] {tok.decode(toks[i, : n_valid[i]].tolist())!r}")
        total = int(n_valid.sum())
        print(f"batch={args.batch}: {total} tokens in {dt:.2f} s ({total / dt:.1f} tok/s aggregate)")
        prof.report(args.model)
        return dict(ids=[toks[i, : n_valid[i]].tolist() for i in range(args.batch)],
                    prompt_lens=[len(p) for p in prompts], seconds=dt, tok_s=total / dt)
    if args.chunked or args.turns > 1:
        from ..generation.generate import decode_step
        from ..generation.prefill import PromptCache, prefill_with_prompt_cache
        from ..generation.sampling import sample_token

        pcache = PromptCache()
        chunk = args.chunked or 256
        turns = []
        for turn in range(args.turns):
            cache = model.init_cache(1, args.limits, DTYPE)  # the JAX demo's: --kv is not read here
            t0 = time.perf_counter()
            logits, cache, matched = prefill_with_prompt_cache(model, cache, ids, ids.shape[1], pcache,
                                                               chunk=chunk)
            tokv = sample_token(logits, scfg, _sampler_gen(dev, turn))
            t = int(tokv[0])
            ttft = time.perf_counter() - t0
            out = [t]
            stream(t)
            td = time.perf_counter()
            for _ in range(scfg.max_new_tokens - 1):
                logits, cache = decode_step(model, cache, tokv)
                tokv = sample_token(logits, scfg, _sampler_gen(dev, turn * 1000 + len(out)))
                t = int(tokv[0])
                if t == tok.eos_token_id:
                    break
                stream(t)
                out.append(t)
            dt = time.perf_counter() - td
            print(f"\n[turn {turn}] prefix-cache hit: {matched}/{ids.shape[1]} tokens, "
                  f"ttft {ttft*1000:.0f} ms")
            turns.append(dict(ids=out, matched=matched, ttft_s=ttft, prefill_tps=ids.shape[1] / ttft,
                              decode_tps=(len(out) - 1) / dt if dt > 0 else 0.0))
        prof.ttft_s = ttft
        prof.report(args.model)
        return dict(turns=turns, prompt_len=ids.shape[1])
    res, cache = generate(model, ids, cache, scfg, callback=stream, eos_token_id=tok.eos_token_id)
    print()
    prof.prefill_tps = res.prefill_tps
    prof.ttft_s = res.ttft_s
    prof.decode_tps = res.decode_tps
    prof.report(args.model)
    return dict(ids=res.tokens, prompt_len=ids.shape[1], ttft_s=res.ttft_s, prefill_tps=res.prefill_tps,
                decode_tps=res.decode_tps)


if __name__ == "__main__":
    main()
