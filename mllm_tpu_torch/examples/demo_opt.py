"""OPT text-generation demo: counterpart of `examples/demo_opt.py` of the JAX
repo:

  python -m mllm_tpu_torch.examples.demo_opt -m <opt_dir> [--prompt "Hello, who are you?"] [--device cuda|cpu]

bf16 weights and cache, on the card unless `--device cpu` (`-q` is parsed
and not read, as in the JAX demo). `main(argv)` returns the generated ids
and the run's timings.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ._demo_common import device, std_parser, timed_stream, vl_decode_loop

DTYPE = torch.bfloat16


def parser():
    return std_parser(__doc__.split("\n\n")[0], default_prompt="Hello, who are you?")


@torch.no_grad()
def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    dev = device(args.device)

    from ..models.opt import load_opt, opt_config_from_hf
    from ..models.registry import open_loader
    from ..tokenizers.hf_json import auto_tokenizer

    t0 = time.perf_counter()
    cfg = opt_config_from_hf(args.model)
    model = load_opt(open_loader(args.model), cfg, device=dev, dtype=DTYPE)
    tok = auto_tokenizer(args.model)
    load_s = time.perf_counter() - t0
    print(f"load: {load_s:.1f} s")

    # OPT prepends </s> (bos id 2)
    ids = np.asarray([cfg.bos_token_id] + tok.encode(args.prompt), np.int64)[None, :]
    cache = model.init_cache(1, args.limits, DTYPE)
    t1 = time.perf_counter()
    logits, cache = model(torch.as_tensor(ids, device=dev), cache)
    box = {}
    out, _ = vl_decode_loop(model, tok, logits, cache, args.max_new, stream=timed_stream(tok, box))
    return dict(ids=out, prompt_len=ids.shape[1], load_s=load_s, ttft_s=box["first"] - t1,
                seconds=time.perf_counter() - t1)


if __name__ == "__main__":
    main()
