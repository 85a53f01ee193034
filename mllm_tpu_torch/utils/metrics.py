"""Metrics & observability.

The reference's observability is profiling printouts + per-op latency tables
(SURVEY §5: Module::profiling, DEBUGOPTIME).  Here:
  - `Metrics`: process-wide counters/gauges/histograms with JSON and
    Prometheus-text export (structured metrics the reference lacks);
  - `GenerationMetrics`: per-request serving metrics into a registry.

Copied from `mllm_tpu/utils/metrics.py`, but for `cost_table`: there XLA's
cost analysis of the compiled program, here the aten operations of one eager
call counted as it runs (see its docstring).
"""

from __future__ import annotations

import json
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Optional


class Metrics:
    """Thread-safe metrics registry."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = defaultdict(float)
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, list[float]] = defaultdict(list)

    def inc(self, name: str, value: float = 1.0):
        with self._lock:
            self._counters[name] += value

    def set(self, name: str, value: float):
        with self._lock:
            self._gauges[name] = value

    def observe(self, name: str, value: float):
        with self._lock:
            self._hists[name].append(value)

    def timer(self, name: str):
        return _Timer(self, name)

    def snapshot(self) -> dict:
        with self._lock:
            out = {"counters": dict(self._counters), "gauges": dict(self._gauges)}
            hists = {}
            for k, v in self._hists.items():
                if v:
                    vs = sorted(v)
                    hists[k] = {
                        "count": len(vs),
                        "sum": sum(vs),
                        "mean": sum(vs) / len(vs),
                        "p50": vs[len(vs) // 2],
                        "p99": vs[min(len(vs) - 1, int(len(vs) * 0.99))],
                        "max": vs[-1],
                    }
            out["histograms"] = hists
            return out

    def to_json(self) -> str:
        return json.dumps(self.snapshot())

    def to_prometheus(self) -> str:
        """Prometheus text exposition format."""
        snap = self.snapshot()
        lines = []
        for k, v in snap["counters"].items():
            lines.append(f"# TYPE {_san(k)} counter")
            lines.append(f"{_san(k)} {v}")
        for k, v in snap["gauges"].items():
            lines.append(f"# TYPE {_san(k)} gauge")
            lines.append(f"{_san(k)} {v}")
        for k, h in snap["histograms"].items():
            base = _san(k)
            lines.append(f"# TYPE {base} summary")
            lines.append(f'{base}{{quantile="0.5"}} {h["p50"]}')
            lines.append(f'{base}{{quantile="0.99"}} {h["p99"]}')
            lines.append(f"{base}_sum {h['sum']}")
            lines.append(f"{base}_count {h['count']}")
        return "\n".join(lines) + "\n"

    def reset(self):
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


def _san(name: str) -> str:
    return name.replace(".", "_").replace("-", "_").replace("/", "_")


class _Timer:
    def __init__(self, m: Metrics, name: str):
        self.m = m
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.m.observe(self.name, time.perf_counter() - self.t0)


GLOBAL = Metrics()


# ---------------------------------------------------------------------------
# Cost analysis of one call (DEBUGOPTIME analogue)
# ---------------------------------------------------------------------------

# the H100 SXM's peaks (PERF.md uses the same): HBM bandwidth, dense bf16 tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = 989e12


def _aten_bytes_mode():
    """A dispatch mode that sums the bytes of every aten operation's tensor
    inputs and outputs (each counted once an operation), the counterpart of
    XLA's "bytes accessed". Views move nothing and are not counted; an
    operation that reads part of an input (an embedding lookup, a row
    written in place) counts the whole input."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class _Bytes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.bytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.is_view:
                return out
            for t in tree_flatten((args, kwargs or {}, out))[0]:
                if isinstance(t, torch.Tensor):
                    self.bytes += t.numel() * t.element_size()
            return out

    return _Bytes()


def cost_table(fn, *args, **kwargs) -> dict:
    """Run `fn(*args, **kwargs)` once and report its FLOPs
    (`torch.utils.flop_counter.FlopCounterMode`), the bytes its aten
    operations read and write, and the implied roofline time on an H100
    (3.35 TB/s, bf16 989 TFLOP/s); the JAX `cost_table`'s keys.

    As XLA's cost analysis sees nothing inside a Pallas custom call, these
    counters see nothing inside the port's CUDA kernels (ctypes launches, no
    aten operation): a call that runs them counts only its aten part."""
    from torch.utils.flop_counter import FlopCounterMode

    nbytes = _aten_bytes_mode()
    with FlopCounterMode(display=False) as flop_mode, nbytes:
        fn(*args, **kwargs)
    flops = float(flop_mode.get_total_flops())
    bytes_ = float(nbytes.bytes)
    return {
        "flops": flops,
        "bytes_accessed": bytes_,
        "roofline_compute_ms": flops / PEAK_FLOP_PER_S * 1e3,
        "roofline_memory_ms": bytes_ / PEAK_BYTES_PER_S * 1e3,
        "bound": "memory" if bytes_ / PEAK_BYTES_PER_S > flops / PEAK_FLOP_PER_S else "compute",
    }


@dataclass
class GenerationMetrics:
    """Per-request serving metrics, exported into a Metrics registry."""

    registry: Metrics = field(default_factory=lambda: GLOBAL)

    def record(self, prompt_tokens: int, new_tokens: int, ttft_s: float, total_s: float):
        r = self.registry
        r.inc("mllm_requests_total")
        r.inc("mllm_prompt_tokens_total", prompt_tokens)
        r.inc("mllm_generated_tokens_total", new_tokens)
        r.observe("mllm_ttft_seconds", ttft_s)
        decode_s = max(total_s - ttft_s, 1e-9)
        if new_tokens > 1:
            r.observe("mllm_decode_tokens_per_second", (new_tokens - 1) / decode_s)
