"""ViT ImageNet classification demo: counterpart of `examples/demo_vit.py` of
the JAX repo (ViTProcessor + argmax over the checkpoint's id2label):

  python -m mllm_tpu_torch.examples.demo_vit -m <vit_dir> -i cat.jpg [dog.jpg ...] [--top-k 3] [--device cuda|cpu]

f32 weights, as in the JAX demo, on the card unless `--device cpu`.
`main(argv)` returns each image's top-k (label, probability) pairs.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ._demo_common import device, std_parser


def parser():
    ap = std_parser(__doc__.split("\n\n")[0])
    ap.add_argument("-i", "--images", nargs="+", required=True)
    ap.add_argument("--top-k", type=int, default=3)
    return ap


@torch.no_grad()
def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    dev = device(args.device)

    from ..models.registry import open_loader
    from ..models.vit import load_vit_classifier, vit_config_from_hf
    from ..processor.image import load_image, rescale_normalize, resize

    t0 = time.perf_counter()
    cfg, n_labels, id2label = vit_config_from_hf(args.model)
    model = load_vit_classifier(open_loader(args.model), cfg, n_labels, device=dev, dtype=torch.float32,
                                id2label=id2label)
    print(f"load: {time.perf_counter() - t0:.1f} s ({n_labels} labels)")

    # HF ViTImageProcessor: direct resize to 224x224, normalize mean/std 0.5
    def proc(path):
        x = resize(load_image(path), cfg.image_size, cfg.image_size, "bilinear")
        x = rescale_normalize(x, (0.5, 0.5, 0.5), (0.5, 0.5, 0.5))
        return x.transpose(2, 0, 1)[None]

    pixel = np.concatenate([proc(p) for p in args.images], axis=0)
    t1 = time.perf_counter()
    preds = model.classify(torch.as_tensor(pixel, device=dev), args.top_k)
    score_s = time.perf_counter() - t1
    for path, top in zip(args.images, preds):
        best = ", ".join(f"{lbl} ({p:.3f})" for lbl, p in top)
        print(f"{path}: {best}")
    return dict(preds=preds, score_s=score_s)


if __name__ == "__main__":
    main()
