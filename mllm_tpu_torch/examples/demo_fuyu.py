"""Fuyu-8B captioning demo: counterpart of `examples/demo_fuyu.py` of the JAX
repo (FuyuProcessor patchify + the image splice + streaming greedy decode):

  python -m mllm_tpu_torch.examples.demo_fuyu -m <fuyu_dir> -i bus.png \\
      [--prompt "Generate a coco-style caption."] [--device cuda|cpu]

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
    return std_parser(__doc__.split("\n\n")[0], image=True, default_prompt="Generate a coco-style caption.\n")


@torch.no_grad()
def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    dev = device(args.device)

    from ..models.fuyu import fuyu_config_from_hf, load_fuyu, patchify_image
    from ..models.registry import open_loader
    from ..processor.image import load_image
    from ..tokenizers.hf_json import auto_tokenizer

    t0 = time.perf_counter()
    cfg = fuyu_config_from_hf(args.model)
    model = load_fuyu(open_loader(args.model), cfg, device=dev, dtype=DTYPE, quant=args.quant)
    tok = auto_tokenizer(args.model)
    load_s = time.perf_counter() - t0
    print(f"load: {load_s:.1f} s")

    img = load_image(args.image)  # [H, W, C] uint8
    chw = img.transpose(2, 0, 1).astype(np.float32) / 255.0 * 2 - 1
    patches = patchify_image(chw, cfg.patch_size)  # [P, C*ps*ps]

    # reference FuyuProcessor: image placeholders, then the text prompt
    ids = np.asarray([cfg.image_token_id] * patches.shape[0] + tok.encode(args.prompt), np.int64)[None, :]
    print(f"prompt tokens: {ids.shape[1]} ({patches.shape[0]} image patches)")

    cache = model.init_cache(1, args.limits, DTYPE)
    t1 = time.perf_counter()
    logits, cache = model(torch.as_tensor(ids, device=dev), cache,
                          image_patches=torch.as_tensor(patches, device=dev))
    box = {}
    out, _ = vl_decode_loop(model, tok, logits, cache, args.max_new, stream=timed_stream(tok, box))
    return dict(ids=out, prompt_len=ids.shape[1], load_s=load_s, ttft_s=box["first"] - t1,
                seconds=time.perf_counter() - t1)


if __name__ == "__main__":
    main()
