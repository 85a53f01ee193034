"""ImageBind tri-modal demo: counterpart of `examples/demo_imagebind.py` of the
JAX repo: score an image against texts and audio clips in the shared
embedding space.

  python -m mllm_tpu_torch.examples.demo_imagebind -m <dir-with-weights-or-random> \\
      -i img.jpg --texts "a dog" "a car" --audio clip.wav [--device cuda|cpu]

`-m random` (the default) builds ImageBind-huge from a `torch.Generator`
seeded 0, in f32; a weights directory is refused, as in the JAX demo. The
text ids are the JAX demo's whitespace hash, `abs(hash(w)) % (vocab - 2)`:
Python salts `hash` per process, so they change from one process to the
next (in both packages). On the card unless `--device cpu`. `main(argv)`
returns both score rows.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ._demo_common import add_device_arg, device


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-m", "--model", default="random", help="'random' or weights dir")
    ap.add_argument("-i", "--image", required=True)
    ap.add_argument("--texts", nargs="+", default=["a dog.", "a car", "a bird"])
    ap.add_argument("--audio", default=None)
    add_device_arg(ap)
    return ap


def text_ids(texts, cfg) -> tuple[np.ndarray, np.ndarray]:
    """The JAX demo's whitespace-hash tokenizer for the random demo: ids
    [n, 8] (at most 7 words, then the end token vocab - 1) and each text's
    end position."""
    ids = np.zeros((len(texts), 8), np.int64)
    eot = np.zeros(len(texts), np.int64)
    for i, t in enumerate(texts):
        toks = [abs(hash(w)) % (cfg.vocab_size - 2) for w in t.split()][:7]
        ids[i, : len(toks)] = toks
        ids[i, len(toks)] = cfg.vocab_size - 1
        eot[i] = len(toks)
    return ids, eot


@torch.no_grad()
def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    dev = device(args.device)

    from ..models.imagebind import ImageBindConfig, ImageBindModel, patchify_video
    from ..processor.audio import ImageBindAudioProcessor
    from ..processor.image import ClipImageProcessor

    cfg = ImageBindConfig()
    if args.model == "random":
        print("(random weights demo — scores are meaningless, pipeline is real)")
        model = ImageBindModel.init(cfg, device=dev, dtype=torch.float32,
                                    generator=torch.Generator(device=dev).manual_seed(0))
    else:
        raise SystemExit("checkpoint loading for ImageBind lands with the convertor")

    # vision: image -> 2 repeated frames -> 3D patches
    pix = ClipImageProcessor(size=cfg.img_hw, crop=cfg.img_hw)(args.image)  # [1,3,H,W]
    frames = np.repeat(pix[:, :, None], cfg.time_frames, axis=2)  # [1,3,T,H,W]
    patches = patchify_video(frames, cfg.patch, cfg.patch_time)

    ids, eot = text_ids(args.texts, cfg)
    if args.audio:
        fb = ImageBindAudioProcessor()(args.audio)  # [3,1,128,204]
    else:
        fb = np.zeros((cfg.audio_clips, 1, cfg.audio_h, cfg.audio_w), np.float32)

    t0 = time.perf_counter()
    vt, va = model(*(torch.as_tensor(a, device=dev) for a in (ids, eot, patches, fb)))
    vt, va = vt.cpu().numpy(), va.cpu().numpy()
    score_s = time.perf_counter() - t0
    print("vision x text:", vt[0])
    print("vision x audio:", va[0])
    return dict(vision_text=vt[0].tolist(), vision_audio=va[0].tolist(), ids=ids.tolist(), score_s=score_s)


if __name__ == "__main__":
    main()
