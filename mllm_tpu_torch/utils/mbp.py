"""MBP (memory-bounded pipelining) for MoE expert weights: counterpart of
`mllm_tpu/utils/mbp.py`.

Expert weights live in host memory and are copied to the card when a token
routes to them, with the next layer's likely experts prefetched on a thread
(the reference's expert-offload worker, which reuses layer L's routed set for
layer L + 1). A bounded LRU keyed by (layer, expert) holds the experts on
the card.

On a card the host copies sit in pinned memory and are copied with
`non_blocking=True` on a side stream of the store's own, each entry carrying
the CUDA event recorded after its copies. Where the JAX package's
`device_put` orders everything itself, three things are explicit here:
  - `fetch` makes the caller's current stream wait on the entry's event, and
    marks the tensors as used on that stream (`record_stream`), so they are
    not reused while its work still reads them;
  - an entry evicted while its copy is in flight is kept alive (`_retired`)
    until its event has completed, so nothing frees memory the copy still
    writes;
  - the prefetch thread issues its copies inside a `torch.cuda.stream`
    context of the side stream (the current stream is per thread).
On the CPU the host tensors are the "device" copies and nothing is copied.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np
import torch


def _host_tensor(a, pin: bool) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    t = t.detach().to("cpu").contiguous()
    return t.pin_memory() if pin else t


class _Entry:
    __slots__ = ("tensors", "event")

    def __init__(self, tensors: tuple, event: Optional[torch.cuda.Event]):
        self.tensors = tensors
        self.event = event


class HostExpertStore:
    """Host-resident expert weights with an LRU cache on `device` and a
    prefetcher. weights[(layer, expert)] -> (gate [ff, d], up [ff, d], down
    [d, ff]) as numpy arrays or tensors; they are pinned when `device` is a
    card (only then: pinning needs a CUDA build)."""

    def __init__(self, weights: dict, device, max_device_entries: int = 16):
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self.host = {key: tuple(_host_tensor(a, self.on_card) for a in arrays) for key, arrays in weights.items()}
        self.max_entries = max_device_entries
        self._cache: OrderedDict[tuple, _Entry] = OrderedDict()
        self._retired: list[_Entry] = []
        self._lock = threading.Lock()
        self._prefetch_thread: Optional[threading.Thread] = None
        self._stream = torch.cuda.Stream(device=self.device) if self.on_card else None
        self.hits = 0
        self.misses = 0
        self.bytes_copied = 0  # host -> card bytes of every copy issued

    def _put(self, key) -> _Entry:
        """Start the copies of one expert (under the lock)."""
        if not self.on_card:
            return _Entry(self.host[key], None)
        with torch.cuda.stream(self._stream):
            tensors = tuple(t.to(self.device, non_blocking=True) for t in self.host[key])
            event = torch.cuda.Event()
            event.record(self._stream)
        self.bytes_copied += sum(t.numel() * t.element_size() for t in tensors)
        return _Entry(tensors, event)

    def _insert(self, key, entry: _Entry) -> None:
        """Add an entry and evict the least recently used past the bound
        (under the lock); an evicted entry whose copy may still run is kept
        until its event completes."""
        self._cache[key] = entry
        while len(self._cache) > self.max_entries:
            _, old = self._cache.popitem(last=False)
            if old.event is not None and not old.event.query():
                self._retired.append(old)
        self._retired = [e for e in self._retired if not e.event.query()]

    def fetch(self, layer: int, expert: int) -> tuple:
        """The expert's (gate, up, down) on the device, ready for work queued
        on the caller's current stream."""
        key = (layer, expert)
        with self._lock:
            entry = self._cache.get(key)
            if entry is not None:
                self.hits += 1
                self._cache.move_to_end(key)
            else:
                self.misses += 1
                entry = self._put(key)
                self._insert(key, entry)
        if entry.event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(entry.event)
            for t in entry.tensors:
                t.record_stream(stream)
        return entry.tensors

    def prefetch(self, keys: list[tuple[int, int]]) -> None:
        """Stage experts for upcoming layers on a background thread."""

        def work():
            for key in keys:
                key = tuple(key)
                with self._lock:
                    if key in self._cache or key not in self.host:
                        continue
                    self._insert(key, self._put(key))

        t = threading.Thread(target=work, daemon=True)
        t.start()
        self._prefetch_thread = t

    def wait(self) -> None:
        if self._prefetch_thread is not None:
            self._prefetch_thread.join()

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0


def _expert_apply(y, x, wg, wu, wd, top_p, top_i, e: int, act_fn: Callable):
    """y += expert_e(x) * the token's routing weight, in place: the products
    in the promoted dtype of x and the weights (as JAX promotes them), the
    expert's output added in f32."""
    w_tok = torch.where(top_i == e, top_p, torch.zeros_like(top_p)).sum(dim=-1)  # [T]
    dt = torch.promote_types(x.dtype, wg.dtype)
    xc = x.to(dt)
    h = act_fn(xc @ wg.to(dt).T) * (xc @ wu.to(dt).T)
    return y.add_((h @ wd.to(dt).T).float() * w_tok[:, None])


def mbp_moe_forward(x, router_weight, store: HostExpertStore, layer: int, n_layers: int, top_k: int,
                    act_fn: Callable, norm_topk: bool = True):
    """A MoE layer over host-streamed experts, x [T, d]: route on the device
    (softmax top-k, `models.moe.route`), read only the [T, k] routed ids on
    the host, prefetch the same experts for layer + 1, and apply each routed
    expert fetched from the store (copied on a miss)."""
    from ..models.moe import route

    top_p, top_i = route(x, router_weight, top_k, norm_topk)
    routed = sorted(set(top_i.reshape(-1).tolist()))
    if layer + 1 < n_layers:
        store.prefetch([(layer + 1, e) for e in routed])
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in routed:
        wg, wu, wd = store.fetch(layer, e)
        _expert_apply(y, x, wg, wu, wd, top_p, top_i, e, act_fn)
    return y.to(x.dtype)
