"""Shared plumbing for the demo CLIs: counterpart of
`examples/_demo_common.py` of the JAX repo.

`std_parser` gives the `-m/-l/-q` flags of every demo plus `--device`,
`device` resolves that flag (the card unless `--device cpu`; no card
raises), `stream_fn` writes each token's text as it comes (`timed_stream`
also notes when the first one came), and `vl_decode_loop` decodes greedily
after a prefill for models whose call is (input_ids, cache) -> (logits,
cache).
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ..ops.quantize_model import MODES
from ..utils.runtime import default_device


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default): the first CUDA card, an error without one; cpu: the CPU")


def device(name: str) -> torch.device:
    """The device a `--device` value names: the card (raises when there is
    none) or the CPU."""
    return torch.device("cpu") if name == "cpu" else default_device()


def std_parser(description: str, image: bool = False, default_prompt: str = None):
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("-m", "--model", required=True, help="model directory")
    ap.add_argument("-l", "--limits", type=int, default=2048,
                    help="KV cache limit (reference cmdline 'limits')")
    ap.add_argument("-q", "--quant", choices=MODES, default=None)
    add_device_arg(ap)
    if image:
        ap.add_argument("-i", "--image", required=True)
    if default_prompt is not None:
        ap.add_argument("--prompt", default=default_prompt)
        ap.add_argument("--max-new", type=int, default=128)
    return ap


def stream_fn(tok):
    def stream(t):
        sys.stdout.write(tok.detokenize(t))
        sys.stdout.flush()
        return True
    return stream


def timed_stream(tok, box: dict):
    """`stream_fn(tok)` that also records the host time of the first token in
    box["first"] (the end of the prefill)."""
    stream = stream_fn(tok)

    def cb(t):
        box.setdefault("first", time.perf_counter())
        return stream(t)
    return cb


@torch.no_grad()
def vl_decode_loop(model, tok, logits, cache, max_new: int, stream=None):
    """Greedy streaming decode for models whose call is (input_ids, cache)
    -> (logits, cache); the prefill is done and `logits` are its output.
    `stream` (default `stream_fn(tok)`) takes each token, the prefill's
    first. Returns (tokens, cache); stops at the tokenizer's eos, which is
    not emitted."""
    stream = stream or stream_fn(tok)
    dev = logits.device
    tokv = int(torch.argmax(logits[0, -1]))
    stream(tokv)
    out = [tokv]
    t0 = time.perf_counter()
    for _ in range(max_new - 1):
        logits, cache = model(torch.tensor([[tokv]], dtype=torch.long, device=dev), cache)
        tokv = int(torch.argmax(logits[0, -1]))
        if tokv == tok.eos_token_id:
            break
        stream(tokv)
        out.append(tokv)
    dt = time.perf_counter() - t0
    print(f"\n{len(out) / dt:.1f} tok/s decode" if dt > 0 else "")
    return out, cache
