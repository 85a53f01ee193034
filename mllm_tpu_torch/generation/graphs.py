"""Captured decode loops: a window of decode steps recorded once as a CUDA
graph and replayed, the port's counterpart of the JAX package's jitted
`lax.while_loop` / `fori_loop` (one device program instead of a host-driven
string of launches).

`StepGraph(fn, warmup)` wraps a callable whose work reads and writes only
tensors at fixed addresses: static buffers (a write head, the current token,
the scheduler state, an output buffer) and the cache storage. On the card its
first call runs `warmup` eagerly, which builds everything the kernels need
outside the capture: the kernel library, each wrapper's plans and cached
buffers, the cuBLAS workspace of the capture stream. The warm-up is either
real work of the loop (one decode step: `warmup_is_work`, and the call ends
there) or work that changes no state (one model call whose writes the
window's first step repeats), and then the same call captures `fn` and
replays it. Every later call replays it. A capture or replay that fails
raises: nothing falls back to eager launches. On the CPU `fn` runs eagerly
every time, the same step code.

Kernel wrappers count `.launches` where they launch, so inside a capture they
count once per captured launch, not per replay. Each StepGraph records those
counts (`captured`) and its replays (`replays`); `device_launches` turns a
set of counters into launches on the card.
"""

from __future__ import annotations

import contextlib
import time
import weakref
from typing import Callable, Optional

import torch

_GRAPHS: "weakref.WeakSet[StepGraph]" = weakref.WeakSet()
_EPOCH = [0]  # bumped by reset_counts: a graph captured since then counted its capture
_STREAMS: dict = {}


def kernel_wrappers() -> dict:
    """Kernel name -> the wrapper that counts its launches."""
    from ..ops.decode_attention import decode_attention, decode_attention_paged, decode_attention_quant
    from ..ops.decode_step import fused_decode_step, fused_decode_step_batched
    from ..ops.flash_attention import flash_attention, flash_attention_quant
    from ..ops.fused_mlp import fused_int4_mlp
    from ..ops.quant_matmul import int4_matmul, int8_matmul

    return {fn.__name__: fn for fn in (
        flash_attention, decode_attention, int8_matmul, int4_matmul, fused_int4_mlp,
        fused_decode_step, fused_decode_step_batched, flash_attention_quant, decode_attention_quant,
        decode_attention_paged)}


def _counts() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """One side stream per card on which every warm-up and capture runs (so
    the capture finds the cuBLAS workspace of its stream already made)."""
    key = torch.device(device).index or 0
    if key not in _STREAMS:
        _STREAMS[key] = torch.cuda.Stream(device=device)
    return _STREAMS[key]


@contextlib.contextmanager
def _on_side_stream(device):
    side, main = capture_stream(device), torch.cuda.current_stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        yield side
    main.wait_stream(side)


class StepGraph:
    """`fn` captured once as a CUDA graph on `device` and replayed; on the
    CPU, `fn` run eagerly. `generators` are the torch.Generators the steps
    draw from: each is registered with the graph, so a replay advances it
    as the same eager calls would."""

    def __init__(self, fn: Callable[[], None], device, *, warmup: Optional[Callable[[], None]] = None,
                 generators=(), name: str = "step", warmup_is_work: bool = True):
        self.fn = fn
        self.warmup = warmup or fn
        self.warmup_is_work = warmup_is_work
        self.device = torch.device(device)
        self.generators = tuple(generators)
        self.name = name
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.warm = False
        self.captured: dict = {}  # kernel -> launches in one replay
        self.captured_epoch = -1
        self.replays = 0
        self.capture_s = 0.0  # host seconds the capture took (recording and instantiation)
        _GRAPHS.add(self)

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def __call__(self) -> str:
        """Run the loop's next piece of work; returns what ran: "eager" (the
        CPU, or the warm-up on the card), or "replay"."""
        if not self.on_card:
            self.fn()
            return "eager"
        if not self.warm:
            with _on_side_stream(self.device):
                self.warmup()
            self.warm = True
            if self.warmup_is_work:
                return "eager"
        if self.graph is None:
            self._capture()
        self.graph.replay()
        self.replays += 1
        return "replay"

    def _capture(self) -> None:
        t0 = time.perf_counter()
        before = _counts()
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")  # a host sync inside the step raises here
        try:
            with torch.cuda.graph(graph, stream=capture_stream(self.device)):
                self.fn()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        after = _counts()
        self.captured = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        self.captured_epoch = _EPOCH[0]
        self.graph = graph
        self.capture_s = time.perf_counter() - t0


# model -> {key: loop state}: the captures on the card, reused across calls
# as jax.jit reuses a program
_LOOPS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _weights_key(model) -> int:
    """Changes when the model's tensors do (quantize_model swaps them in place)."""
    return hash(tuple((k, t.data_ptr(), tuple(t.shape)) for k, t in model.state_dict().items()))


def loop_for(model, cache, key, make: Callable):
    """The state of a captured loop for this call: on the CPU a new one,
    `make(cache)`, over the caller's storage; on the card the cached one for
    the model's tensors, the cache's type and geometry and `key`, made by
    `make(cache)` at first use. Its storage takes the caller's contents (the
    caller's cache is consumed, as JAX donates it), so a capture serves every
    later call with a cache of the same geometry."""
    from ..kv.cache import storage

    if cache.pos.device.type != "cuda":
        return make(cache)
    full = (type(cache), tuple((tuple(t.shape), t.dtype) for t in storage(cache)), key,
            _weights_key(model))
    loops = _LOOPS.setdefault(model, {})
    if full not in loops:
        loops[full] = make(cache)
    loop = loops[full]
    for dst, src in zip(storage(loop.cache), storage(cache)):
        if dst.data_ptr() != src.data_ptr():
            dst.copy_(src)
    return loop


def reset_counts() -> None:
    """Start a new count: every graph's replays to 0 (set with the kernel
    wrappers' counters)."""
    _EPOCH[0] += 1
    for g in list(_GRAPHS):
        g.replays = 0


def device_launches(counts: dict) -> dict:
    """Launches on the card since `reset_counts`, per kernel, from the
    wrappers' counters `counts` read now: the counts less the launches that
    captures made since then (recorded, not run), plus each graph's
    captured launches times its replays."""
    out = dict(counts)
    for g in list(_GRAPHS):
        for k, n in g.captured.items():
            if g.captured_epoch == _EPOCH[0]:
                out[k] = out.get(k, 0) - n
            out[k] = out.get(k, 0) + n * g.replays
    return out


def replays(name: Optional[str] = None) -> int:
    """Graph replays since `reset_counts`, over every StepGraph (of `name`)."""
    return sum(g.replays for g in all_graphs(name))


def all_graphs(name: Optional[str] = None) -> list:
    """The live StepGraphs (of `name`)."""
    return [g for g in list(_GRAPHS) if name is None or g.name == name]
