"""Sweep the window of the captured decode loop (decode steps a CUDA-graph
replay) of `generate_compiled` on the card.

    python3 tools/graph_window.py [--model bf16,int8,int4] [--windows 4,8,16,32,64]

For each model (the Qwen2-VL-2B language model's geometry, 28 layers, random
weights from a seeded generator; int8 / int4 after fuse_projections and
quantize_model on the card) and window W: a warm-up call (its eager step and
the capture), then generate_compiled of a 100-token prompt to 256 new tokens,
three times. Prints one JSON line per (model, W): the median wall tok/s, the
device ms of one replay / W (CUDA events), the host's reads (one a window)
and the card's name and power limit. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

QWEN2VL_2B_LM = dict(vocab_size=151936, hidden_size=1536, intermediate_size=8960, num_hidden_layers=28,
                     num_attention_heads=12, num_key_value_heads=2, head_dim=128,
                     max_position_embeddings=32768, eos_token_id=-2)


def model_of(kind: str, dev):
    from mllm_tpu_torch.core.config import TextConfig
    from mllm_tpu_torch.models.transformer import CausalLM
    from mllm_tpu_torch.ops.quantize_model import fuse_projections, quantize_model

    model = CausalLM.init(TextConfig(**QWEN2VL_2B_LM), device=dev, dtype=torch.bfloat16,
                          generator=torch.Generator(device=dev).manual_seed(0))
    if kind != "bf16":
        quantize_model(fuse_projections(model), kind, on_device=True)
    return model


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="bf16,int8")
    ap.add_argument("--windows", default="4,8,16,32,64")
    ap.add_argument("--new", type=int, default=256)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from mllm_tpu_torch.generation import graphs
    from mllm_tpu_torch.generation.generate import generate_compiled, pad_to_bucket
    from mllm_tpu_torch.generation.sampling import SamplingConfig

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    scfg = SamplingConfig(max_new_tokens=args.new)
    prompt = np.random.default_rng(0).integers(0, QWEN2VL_2B_LM["vocab_size"], 100)
    ids = pad_to_bucket(prompt[None])
    for kind in args.model.split(","):
        model = model_of(kind, dev)
        for w in (int(x) for x in args.windows.split(",")):
            def run():
                cache = model.init_cache(1, 2048)
                torch.cuda.synchronize()
                t = time.perf_counter()
                toks, n = generate_compiled(model, ids, cache, 100, args.new, scfg, window=w)
                int(n)
                return time.perf_counter() - t

            run()  # the eager step and the capture
            graphs.reset_counts()
            walls = [run() for _ in range(3)]
            (g,) = [x for x in graphs.all_graphs("generate_compiled") if x.replays > 0]
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            g.graph.replay()
            end.record()
            end.synchronize()
            print(json.dumps(dict(tool="graph_window", model=kind, window=w, new_tokens=args.new,
                                  tok_s=args.new / float(np.median(walls)), walls_s=walls,
                                  device_ms_per_step=start.elapsed_time(end) / w,
                                  host_reads=g.replays // 3 + 1, card=smi)), flush=True)
            del g
        del model
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
