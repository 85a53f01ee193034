"""Speculative-decoding demo: counterpart of `examples/demo_sd.py` of the
JAX repo (the reference's demo_qwen_sd, suffix-automaton drafting):

  python -m mllm_tpu_torch.examples.demo_sd -m <model_dir> --prompt "..." [--max-draft 8] \\
      [--compiled] [--device cuda|cpu]

Prints the generation plus draft-acceptance statistics. `--compiled` runs
the loop on the device (`speculative_generate_compiled`: prompt-lookup
drafts, on the card a window of verify steps replayed as one CUDA graph).
Runs on the card unless `--device cpu`; `main(argv)` returns the token ids
and the statistics.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ._demo_common import add_device_arg, device

DTYPE = torch.bfloat16  # the weights' and the cache's dtype


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-l", "--limits", type=int, default=2048)
    ap.add_argument("--prompt", default="Repeat after me: the cat sat on the mat. the cat sat on")
    ap.add_argument("--max-new", type=int, default=64)
    ap.add_argument("--max-draft", type=int, default=8)
    ap.add_argument("--compiled", action="store_true",
                    help="SD with the loop on the device: on-device prompt-lookup drafting, a window of "
                         "verify steps one CUDA graph replay")
    add_device_arg(ap)
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    dev = device(args.device)

    from ..generation.speculative import speculative_generate
    from ..models.registry import auto_model

    model, tok, cfg = auto_model(args.model, dtype=DTYPE, device=dev)
    ids = np.asarray(tok.encode(args.prompt, bos=True), np.int64)[None, :]
    cache = model.init_cache(1, args.limits, DTYPE)

    if args.compiled:
        from ..generation.generate import pad_to_bucket
        from ..generation.speculative import speculative_generate_compiled

        padded = torch.as_tensor(pad_to_bucket(ids, 128), device=dev)
        t0 = time.perf_counter()
        toks, n, steps, drafted, accepted = speculative_generate_compiled(
            model, padded, cache, ids.shape[1], args.max_new,
            eos_token_id=tok.eos_token_id, max_draft=args.max_draft)
        out = toks[: int(n)].tolist()
        dt = time.perf_counter() - t0
        print(tok.detokenize_all(out) if hasattr(tok, "detokenize_all")
              else "".join(tok.detokenize(t) for t in out))
        steps, drafted, accepted = int(steps), int(drafted), int(accepted)
        print(f"tokens: {len(out)}  verify-steps: {steps}  drafted: {drafted}  "
              f"accepted: {accepted} "
              f"(acceptance {accepted / max(drafted, 1):.1%})  "
              f"{len(out)/dt:.1f} tok/s (capture included)")
        return dict(ids=out, steps=steps, drafted=drafted, accepted=accepted, seconds=dt,
                    tok_s=len(out) / dt)

    def stream(t):
        sys.stdout.write(tok.detokenize(t))
        sys.stdout.flush()

    t0 = time.perf_counter()
    out, cache, stats = speculative_generate(
        model, ids, cache, args.max_new, eos_token_id=tok.eos_token_id,
        max_draft=args.max_draft, callback=stream,
    )
    dt = time.perf_counter() - t0
    print()
    print(f"tokens: {stats.tokens}  verify-steps: {stats.steps}  "
          f"drafted: {stats.drafted}  accepted: {stats.accepted} "
          f"(acceptance {stats.acceptance:.1%})  {len(out)/dt:.1f} tok/s")
    return dict(ids=out, steps=stats.steps, drafted=stats.drafted, accepted=stats.accepted, seconds=dt,
                tok_s=len(out) / dt)


if __name__ == "__main__":
    main()
