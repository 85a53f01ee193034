"""Profiling report: counterpart of `mllm_tpu/utils/profiling.py`.

`Profiler.report` prints load time, prefill speed, time to first token and
decode speed in the JAX package's text, `timer` times a block on the host
clock, and `torch_trace` records a `torch.profiler` trace (the counterpart
of `jax_trace`).
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass


@dataclass
class Profiler:
    load_s: float = 0.0
    prefill_tps: float = 0.0
    ttft_s: float = 0.0
    decode_tps: float = 0.0
    compile_s: float = 0.0

    def report(self, tag: str = ""):
        print("===========================================================")
        if tag:
            print(f"  {tag}")
        print(f"  Load time: {self.load_s:.3f} s")
        if self.compile_s:
            print(f"  Compile time (first call): {self.compile_s:.2f} s")
        print(f"  Prefill speed: {self.prefill_tps:.1f} tokens/s")
        print(f"  Time to first token: {self.ttft_s:.3f} s")
        print(f"  Decode speed: {self.decode_tps:.1f} tokens/s")
        print("===========================================================")


@contextlib.contextmanager
def timer():
    """Yields a dict whose "s" holds the block's host seconds on exit."""
    t0 = time.perf_counter()
    box = {}
    try:
        yield box
    finally:
        box["s"] = time.perf_counter() - t0


@contextlib.contextmanager
def torch_trace(logdir: str):
    """Record a `torch.profiler` trace of the block (host and, where a card
    is present, CUDA activity) and write it as a Chrome trace,
    `<logdir>/trace.json` (chrome://tracing, Perfetto). The counterpart of the
    JAX package's `jax_trace`, which writes a TensorBoard / XProf trace.
    Yields the trace file's path."""
    from torch.profiler import ProfilerActivity, profile

    import torch

    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield path
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(path)
