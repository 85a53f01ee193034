"""Where the time of one decode step goes on the card, for the PyTorch port.

    python3 tools/profile_torch_decode.py        # on a CUDA card, from the repo root

Builds the full-width random-weight Qwen2-VL-2B-geometry LM of chip_smoke.py,
makes it an int4 model two ways (`quantize_model("int4")`, the eager path;
`MegaDecodeLM.from_float`, the megakernel path), and for each case decodes
at a fixed context (the cache's write head is rewound every step) and prints
one JSON line: wall ms a step (host clock, synchronised; with and without the
profiler), device ms a step (the summed time of the CUDA kernels, memsets and
copies `torch.profiler` records), the busy share (device / profiled wall),
kernels a step, and the kernels that take the most time.
"""

from __future__ import annotations

import json
import os
import sys
import time
from collections import defaultdict

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

STEPS = 10


def profile_case(name, model, b, ctx):
    from mllm_tpu_torch.generation.generate import decode_step, pad_to_bucket, prefill

    dev = model.device
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(pad_to_bucket(rng.integers(0, model.cfg.vocab_size, (b, ctx))), device=dev)
    _, cache = prefill(model, model.init_cache(b, chip_smoke.S_CACHE), ids, ctx)
    tok = torch.as_tensor(rng.integers(0, model.cfg.vocab_size, b), device=dev)

    def steps(n):
        for _ in range(n):
            decode_step(model, cache.with_pos(ctx), tok)
        torch.cuda.synchronize()

    steps(3)
    t = time.perf_counter()
    steps(STEPS)
    wall_ms = (time.perf_counter() - t) * 1e3 / STEPS
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        steps(STEPS)
        prof_wall_ms = (time.perf_counter() - t) * 1e3 / STEPS
    per_name, count, total_us = defaultdict(float), 0, 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            per_name[e.name[:60]] += us
            total_us += us
            count += 1
    if not count:
        raise RuntimeError("torch.profiler recorded no device activity")
    device_ms = total_us / 1e3 / STEPS
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:4]
    chip_smoke.emit(case=name, b=b, ctx=ctx, wall_ms=wall_ms, profiled_wall_ms=prof_wall_ms,
                    device_ms=device_ms, busy_share=device_ms / prof_wall_ms,
                    kernels_per_step=count / STEPS,
                    top_ms_per_step={k: v / 1e3 / STEPS for k, v in top})


def main():
    from mllm_tpu_torch.core.config import TextConfig
    from mllm_tpu_torch.models.megadecode import MegaDecodeLM
    from mllm_tpu_torch.ops.quantize_model import fuse_projections, quantize_model

    chip_smoke.phase_device()
    chip_smoke.phase_build()
    dev = torch.device("cuda", 0)
    cfg = TextConfig(**chip_smoke.QWEN2VL_2B_LM)
    model = quantize_model(fuse_projections(chip_smoke.init_model(cfg, dev)), "int4", on_device=True)
    profile_case("int4 eager", model, 1, 1500)
    profile_case("int4 eager", model, 8, 200)
    del model
    torch.cuda.empty_cache()
    mega = MegaDecodeLM.from_float(chip_smoke.init_model(cfg, dev))
    for b, ctx in ((1, 100), (1, 1500), (8, 200), (32, 200)):
        profile_case("megakernel", mega, b, ctx)
    print(json.dumps({"ok": True}), flush=True)


if __name__ == "__main__":
    main()
