"""Qwen2.5-VL demo: counterpart of `examples/demo_qwen2_5_vl.py` of the JAX
repo (windowed vision attention tower + M-RoPE LM):

  python -m mllm_tpu_torch.examples.demo_qwen2_5_vl -m <model_dir> -i image.jpg \\
      [--prompt "Describe this image."] [-q int8|int8-a8|int4] [--device cuda|cpu]

bf16 weights and cache, on the card unless `--device cpu`. `main(argv)`
returns the generated ids and the run's timings.
"""

from __future__ import annotations

import time

import torch

from ._demo_common import device, std_parser, timed_stream

DTYPE = torch.bfloat16


def parser():
    return std_parser(__doc__.split("\n\n")[0], image=True, default_prompt="Describe this image.")


@torch.no_grad()
def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    dev = device(args.device)

    from ..models.qwen2_5_vl import load_qwen2_5_vl, qwen2_5_vl_configs_from_hf
    from ..models.qwen2_vl import vl_generate
    from ..models.registry import open_loader
    from ..processor.qwen2_vl import Qwen2VLProcessor
    from ..tokenizers.hf_json import auto_tokenizer

    t0 = time.perf_counter()
    base, vcfg = qwen2_5_vl_configs_from_hf(args.model)
    model = load_qwen2_5_vl(open_loader(args.model), base, vcfg, device=dev, dtype=DTYPE, quant=args.quant)
    tok = auto_tokenizer(args.model)
    load_s = time.perf_counter() - t0
    print(f"load: {load_s:.1f} s")

    proc = Qwen2VLProcessor(tok, image_token_id=base.image_token_id, video_token_id=base.video_token_id)
    out = proc(proc.chat_text(args.prompt), images=args.image)
    print(f"prompt tokens: {out.input_ids.shape[1]}, image grid: {out.grid_thw}")

    cache = model.init_cache(1, args.limits, DTYPE)
    box = {}
    t1 = time.perf_counter()
    tokens, cache = vl_generate(model, out, cache, args.max_new, eos_token_id=tok.eos_token_id,
                                callback=timed_stream(tok, box))
    dt = time.perf_counter() - t1
    tps = (len(tokens) - 1) / dt if dt > 0 else 0.0
    print(f"\n{tps:.1f} tok/s" if dt > 0 else "")
    return dict(ids=tokens, prompt_len=int(out.input_ids.shape[1]), grid_thw=out.grid_thw, load_s=load_s,
                seconds=dt, ttft_s=box["first"] - t1, decode_tps=tps)


if __name__ == "__main__":
    main()
