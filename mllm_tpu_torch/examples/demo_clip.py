"""CLIP image-text scoring demo: counterpart of `examples/demo_clip.py` of the
JAX repo:

  python -m mllm_tpu_torch.examples.demo_clip -m <clip_model_dir> -i image.jpg \\
      --texts "a photo of a cat" "a photo of a dog" [--device cuda|cpu]

f32 weights, as in the JAX demo, on the card unless `--device cpu`.
`main(argv)` returns each text's probability.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ._demo_common import add_device_arg, device


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-i", "--image", required=True)
    ap.add_argument("--texts", nargs="+", default=["a photo of a cat", "a photo of a dog"])
    add_device_arg(ap)
    return ap


@torch.no_grad()
def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    dev = device(args.device)

    from ..core.param_loader import SafetensorsLoader
    from ..models.clip import clip_config_from_hf, load_clip
    from ..processor.image import ClipImageProcessor
    from ..tokenizers.hf_json import auto_tokenizer

    cfg = clip_config_from_hf(args.model)
    model = load_clip(SafetensorsLoader(args.model), cfg, device=dev, dtype=torch.float32)
    tok = auto_tokenizer(args.model)

    # CLIP text: <|startoftext|> tokens <|endoftext|>, padded to max length
    bos = tok.token_to_id.get("<|startoftext|>", 49406)
    eos = tok.token_to_id.get("<|endoftext|>", cfg.text.eos_token_id)
    seqs = [[bos] + tok.encode(t.lower()) + [eos] for t in args.texts]
    width = max(len(s) for s in seqs)
    ids = np.full((len(seqs), width), eos, np.int64)
    for i, s in enumerate(seqs):
        ids[i, : len(s)] = s

    pixel = ClipImageProcessor(size=cfg.vision.image_size, crop=cfg.vision.image_size)(args.image)
    t0 = time.perf_counter()
    logits = model(torch.as_tensor(ids, device=dev), torch.as_tensor(pixel, device=dev))
    probs = torch.softmax(logits, dim=-1)[0].cpu().numpy()
    score_s = time.perf_counter() - t0
    for t, p in zip(args.texts, probs):
        print(f"  {p:6.3f}  {t}")
    return dict(probs=probs.tolist(), ids=ids.tolist(), score_s=score_s)


if __name__ == "__main__":
    main()
