"""Qwen2-VL demo: counterpart of `examples/demo_qwen2_vl.py` of the JAX repo
(the reference's demo_qwen2_vl):

  python -m mllm_tpu_torch.examples.demo_qwen2_vl -m <model_dir> -i image.jpg \\
      [--prompt "Describe this image."] [--max-new 128] [-l 2048] [-q int8|int4] [--device cuda|cpu]

The model directory is an HF Qwen2-VL checkpoint (config.json, safetensors,
tokenizer.json). Runs on the card unless `--device cpu`; the weights and the
cache are bf16, as in the JAX demo. `main(argv)` returns the generated ids
and the run's timings.
"""

from __future__ import annotations

import argparse
import time

import torch

from ._demo_common import add_device_arg, device, timed_stream

DTYPE = torch.bfloat16


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-i", "--image", required=True)
    ap.add_argument("-l", "--limits", type=int, default=2048)
    ap.add_argument("-q", "--quant", choices=["int8", "int4"], default=None)
    ap.add_argument("--prompt", default="Describe this image.")
    ap.add_argument("--max-new", type=int, default=128)
    add_device_arg(ap)
    return ap


@torch.no_grad()
def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    dev = device(args.device)

    from ..core.param_loader import SafetensorsLoader
    from ..models.qwen2_vl import load_qwen2_vl, qwen2_vl_config_from_hf, vl_generate
    from ..processor.qwen2_vl import Qwen2VLProcessor
    from ..tokenizers.hf_json import auto_tokenizer
    from ..utils.profiling import Profiler

    t0 = time.perf_counter()
    cfg = qwen2_vl_config_from_hf(args.model)
    model = load_qwen2_vl(SafetensorsLoader(args.model), cfg, device=dev, dtype=DTYPE, quant=args.quant)
    tok = auto_tokenizer(args.model)
    prof = Profiler(load_s=time.perf_counter() - t0)

    proc = Qwen2VLProcessor(tok, image_token_id=cfg.image_token_id, video_token_id=cfg.video_token_id)
    out = proc(proc.chat_text(args.prompt), images=args.image)
    print(f"prompt tokens: {out.input_ids.shape[1]}, image grid: {out.grid_thw}")

    cache = model.init_cache(1, args.limits, DTYPE)
    box = {}
    t1 = time.perf_counter()
    tokens, cache = vl_generate(model, out, cache, args.max_new, eos_token_id=tok.eos_token_id,
                                callback=timed_stream(tok, box))
    dt = time.perf_counter() - t1
    print()
    prof.decode_tps = (len(tokens) - 1) / dt if dt > 0 else 0
    prof.report(args.model)
    return dict(ids=tokens, prompt_len=int(out.input_ids.shape[1]), grid_thw=out.grid_thw, load_s=prof.load_s,
                seconds=dt, ttft_s=box["first"] - t1, decode_tps=prof.decode_tps)


if __name__ == "__main__":
    main()
