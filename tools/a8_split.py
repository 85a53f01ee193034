"""Where the time of the port's W8A8 product goes, on one CUDA card.

    python3 tools/a8_split.py [--iters 20]

At chip_smoke.A8_ROWS (the 17-row admission product and the 1536-row
prefill products of the Qwen2-VL-2B LM) it times, with chip_smoke.time_ms
(CUDA events over back-to-back calls queued behind a GPU spin):
  quantize   ops.quant_matmul.a8_quantize(x) (per-token amax, scale, round, int8)
  int_mm_nk  torch._int_mm on the weight's K-contiguous [N, K] copy (rows padded past 16)
  int_mm_kn  torch._int_mm on the [K, N] weight
  rescale    the two f32 passes over [m, N]: f32(acc) * x_scale, then * scales
  a8         the whole int8_matmul_a8 (what QuantLinearA8 calls)
  int8       the weight-only int8_matmul kernel on the same weight
  bf16_mm    torch.mm on the weight in bf16 (a yardstick of another function)
and prints one JSON line a row, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from mllm_tpu_torch.ops import quant_matmul as qm  # noqa: E402
from mllm_tpu_torch.ops.quantize_model import _q8_device  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("a8_split.py needs a CUDA card")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(8)
    for m, k, n in chip_smoke.A8_ROWS:
        x = torch.randn(m, k, device=dev, generator=g).to(torch.bfloat16)
        w = ((torch.rand(n, k, device=dev, generator=g) * 2 - 1) / k ** 0.5).to(torch.bfloat16)
        qv, sc = _q8_device(w)
        nk = qv.t().contiguous()
        xq, xs = qm.a8_quantize(x, k)
        xq_pad = torch.cat([xq, xq.new_zeros(max(0, qm.A8_MIN_ROWS - m), k)])
        acc = torch._int_mm(xq_pad, nk.t())[:m]
        row = dict(m=m, k=k, n=n, **{name: chip_smoke.time_ms(fn, args.iters) for name, fn in (
            ("quantize", lambda: qm.a8_quantize(x, k)),
            ("int_mm_nk", lambda: torch._int_mm(xq_pad, nk.t())),
            ("int_mm_kn", lambda: torch._int_mm(xq_pad, qv)),
            ("rescale", lambda: torch.mul(acc, xs).mul_(sc[None, :])),
            ("a8", lambda: qm.int8_matmul_a8(x, nk, sc)),
            ("int8", lambda: qm.int8_matmul(x, qv, sc)),
            ("bf16_mm", lambda: torch.mm(x, w.t())),
        )}, **chip_smoke.a8_bound(m, k, n))
        print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)


if __name__ == "__main__":
    main()
