"""BERT sentence-embedding demo: counterpart of `examples/demo_bert.py` of the
JAX repo (mean-pooled, L2-normalised embeddings + cosine similarity):

  python -m mllm_tpu_torch.examples.demo_bert -m <bert_dir> \\
      --texts "Help me set an alarm at 21:30" "What time is it?" [--device cuda|cpu]

f32 weights, as in the JAX demo, on the card unless `--device cpu`.
`main(argv)` returns the cosine matrix.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ._demo_common import device, std_parser


def parser():
    ap = std_parser(__doc__.split("\n\n")[0])
    ap.add_argument("--texts", nargs="+",
                    default=["Help me set an alarm at 21:30",
                             "Set an alarm at half past nine tonight",
                             "What is the weather today?"])
    return ap


@torch.no_grad()
def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    dev = device(args.device)

    from ..models.bert import bert_config_from_hf, load_bert
    from ..models.registry import open_loader
    from ..tokenizers.hf_json import auto_tokenizer

    t0 = time.perf_counter()
    cfg = bert_config_from_hf(args.model)
    model = load_bert(open_loader(args.model), cfg, device=dev, dtype=torch.float32)
    tok = auto_tokenizer(args.model)
    print(f"load: {time.perf_counter() - t0:.1f} s")

    cls = tok.token_to_id.get("[CLS]", 101)
    sep = tok.token_to_id.get("[SEP]", 102)
    seqs = [[cls] + tok.encode(t) + [sep] for t in args.texts]
    width = max(len(s) for s in seqs)
    ids = np.zeros((len(seqs), width), np.int64)
    mask = np.zeros((len(seqs), width), np.int64)
    for i, s in enumerate(seqs):
        ids[i, : len(s)] = s
        mask[i, : len(s)] = 1

    t1 = time.perf_counter()
    emb = model.sentence_embedding(torch.as_tensor(ids, device=dev), torch.as_tensor(mask, device=dev))
    emb = emb.float().cpu().numpy()
    score_s = time.perf_counter() - t1
    sim = emb @ emb.T
    print("cosine similarity:")
    for i, t in enumerate(args.texts):
        print(f"  [{i}] {t!r}")
    for i in range(len(args.texts)):
        print("  " + "  ".join(f"{sim[i, j]:6.3f}" for j in range(len(args.texts))))
    return dict(cosine=sim.tolist(), ids=ids.tolist(), mask=mask.tolist(), score_s=score_s)


if __name__ == "__main__":
    main()
