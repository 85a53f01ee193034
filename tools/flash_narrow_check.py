"""Check the narrow flash bodies (head_dim 64 and 80) on the card, case by case.

    python3 tools/flash_narrow_check.py

Each case launches `flash_attention` once and holds it against
`flash_attention_ref` (<= chip_smoke.TOL, finite): GQA 32/8, 16/16 (head_dim
80), 32/4 and 16/8; causal prompts of 128, 200 and 1536 rows; a non-causal
1444-row image; a 512-row chunk at q_offset 1024 and the 256-row chunk of
`demo_llm --chunked 256` at 1280 (fewer units than SMs); a window; B=4 with
kv_start and NaN / inf K/V outside the valid keys; kv_valid short of S with
NaN / inf past it; two non-causal sequences of 130 rows. A launch that has
not finished after 20 s ends the process, so a hang does not hold the
card. Prints one JSON line a case, then a summary;
exits 1 if a case is off.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from mllm_tpu_torch.ops import flash_attention as fa  # noqa: E402

GEOS = ((32, 8, 64), (16, 16, 80), (32, 4, 64), (16, 8, 64))  # (H, H_kv, head_dim)
# (B, Sq, q_offset, kv_valid, kv_start, window, causal, poisoned)
CASES = [
    (1, 128, 0, 128, None, None, True, False),
    (1, 200, 0, 200, None, None, True, False),
    (1, 1536, 0, 1536, None, None, True, False),
    (1, 1444, 0, 1444, None, None, False, False),
    (1, 512, 1024, 1536, None, None, True, False),
    (1, 256, 1280, 1536, None, None, True, False),
    (1, 200, 0, 200, None, 64, True, False),
    (4, 256, 0, [256, 200, 131, 250], [0, 17, 64, 150], None, True, True),
    (1, 1444, 0, 1300, None, None, False, True),
    (2, 130, 0, 130, None, None, False, False),
]
HANG_S = 20.0


def finished(what) -> None:
    """Waits for the launches queued so far; ends the process on a hang."""
    ev = torch.cuda.Event()
    ev.record()
    t0 = time.time()
    while not ev.query():
        if time.time() - t0 > HANG_S:
            print(json.dumps(dict(hang=what)), flush=True)
            os._exit(3)
        time.sleep(0.001)


def main() -> int:
    cs.phase_device()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(7)
    worst = 0.0
    for h, hkv, d in GEOS:
        for b, sq, qoff, kvl, start, window, causal, poisoned in CASES:
            skv = max(sq + qoff, 2048 if causal else sq)
            q = torch.randn(b, sq, h, d, device=dev, generator=g).to(torch.bfloat16)
            k, v = (torch.randn(b, hkv, skv, d, device=dev, generator=g).to(torch.bfloat16) for _ in range(2))
            kp, vp = k, v
            if poisoned:
                hi = kvl if isinstance(kvl, list) else [kvl] * b
                (k, kp), (v, vp) = (cs.poison_outside(x, start or [0] * b, hi) for x in (k, v))
            ivec = lambda xs: torch.tensor(xs, device=dev, dtype=torch.int32)  # noqa: E731
            kw = dict(q_offset=qoff, kv_valid_len=ivec(kvl) if isinstance(kvl, list) else kvl,
                      kv_start=None if start is None else ivec(start), window=window, causal=causal)
            out = fa.flash_attention(q, k, v, **kw)
            finished([h, hkv, d, b, sq, qoff])
            err = (out.float() - fa.flash_attention_ref(q, kp, vp, **kw).float()).abs().max().item()
            finite = bool(torch.isfinite(out.float()).all())
            worst = max(worst, err if finite else float("inf"))
            print(json.dumps(dict(geo=[h, hkv, d], b=b, sq=sq, q_offset=qoff, causal=causal, window=window,
                                  poisoned=poisoned, err=err, finite=finite)), flush=True)
    ok = worst <= cs.TOL
    print(json.dumps(dict(narrow_check="done", worst=worst, tolerance=cs.TOL, ok=ok)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
