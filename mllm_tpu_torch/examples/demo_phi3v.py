"""Phi-3-Vision demo: counterpart of `examples/demo_phi3v.py` of the JAX repo
(image placeholders + the HD transform + streaming greedy decode):

  python -m mllm_tpu_torch.examples.demo_phi3v -m <phi3v_dir> -i cat.jpg \\
      [--prompt "What's in this image?"] [--device cuda|cpu]

bf16 weights and cache, on the card unless `--device cpu`. `main(argv)`
returns the generated ids and the run's timings.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ._demo_common import device, std_parser, timed_stream, vl_decode_loop

DTYPE = torch.bfloat16


def parser():
    return std_parser(__doc__.split("\n\n")[0], image=True, default_prompt="What's in this image?")


@torch.no_grad()
def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    dev = device(args.device)

    from ..models.phi3v import load_phi3v, phi3v_config_from_hf
    from ..models.registry import open_loader
    from ..processor.image import ClipImageProcessor
    from ..tokenizers.hf_json import auto_tokenizer

    t0 = time.perf_counter()
    cfg = phi3v_config_from_hf(args.model)
    model = load_phi3v(open_loader(args.model), cfg, device=dev, dtype=DTYPE, quant=args.quant)
    tok = auto_tokenizer(args.model)
    load_s = time.perf_counter() - t0
    print(f"load: {load_s:.1f} s")

    pixel = ClipImageProcessor(size=cfg.vision.image_size, crop=cfg.vision.image_size)(args.image)

    # phi3v convention: negative ids mark image positions (one per image token)
    text = f"<|user|>\n{args.prompt}<|end|>\n<|assistant|>\n"
    n_img = model.num_image_tokens
    ids = np.asarray([-1] * n_img + tok.encode(text), np.int64)[None, :]
    print(f"prompt tokens: {ids.shape[1]} ({n_img} image tokens)")

    cache = model.init_cache(1, args.limits, DTYPE)
    t1 = time.perf_counter()
    logits, cache = model(torch.as_tensor(ids, device=dev), cache,
                          pixel_values=torch.as_tensor(pixel, device=dev))
    box = {}
    out, _ = vl_decode_loop(model, tok, logits, cache, args.max_new, stream=timed_stream(tok, box))
    return dict(ids=out, prompt_len=ids.shape[1], load_s=load_s, ttft_s=box["first"] - t1,
                seconds=time.perf_counter() - t1)


if __name__ == "__main__":
    main()
