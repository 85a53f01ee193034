"""Chunked prefill and the prompt (prefix) cache: counterpart of
`mllm_tpu/generation/prefill.py`.

`chunked_prefill` runs a prompt through the model in fixed-size chunks, so
one chunk shape serves any prompt length; the logits are taken at the true
last token of the last (padded) chunk. `PromptCache` keeps copies of the KV
state of earlier prompts (LRU) and `prefill_with_prompt_cache` resumes after
the longest cached prefix. The engine's prefix cache
(`ContinuousEngine(prefix_cache=N)`) uses `lookup_common` and
`lookup_prefix_rows`.

Cache entries are copies (`tensor.clone`): the caller goes on writing into
its own cache in place, and a hit hands out a copy, so an entry stays
reusable, as the JAX package's copies keep it from donation.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from ..kv.cache import KVCache, storage


def _copy(cache, rows: Optional[int] = None, pos=None):
    """A cache of the same type over copies of `cache`'s storage (its first
    `rows` sequence rows, all if None), head `pos` (the cache's if None)."""
    cut = [t[:, :, :, : min(rows, t.shape[3])] if rows is not None else t for t in storage(cache)]
    return type(cache)(*(t.clone() for t in cut), cache.pos.clone() if pos is None else pos)


@torch.no_grad()
def _chunk_step(model, cache, chunk_ids: torch.Tensor, last_idx: int):
    """One prompt chunk; logits at position `last_idx` of the chunk, so the
    final (padded) chunk gives the true last token's logits directly."""
    hidden, cache = model.hidden_states(chunk_ids, cache)
    return model.logits(hidden[:, last_idx : last_idx + 1])[:, 0, :], cache


def chunked_prefill(model, cache: KVCache, input_ids: np.ndarray, true_len: int, chunk: int = 256):
    """Prefill `input_ids[:, :true_len]` in chunks of `chunk` tokens at the
    cache's head. Returns (logits [B, V] at the true last token, cache with
    pos = start + true_len). The head is read once, before the first chunk,
    to check that the padded chunks fit."""
    ids = np.asarray(input_ids, np.int64)
    b, s = ids.shape
    start = int(cache.pos)
    n_chunks = -(-true_len // chunk)
    padded_len = n_chunks * chunk
    if start + padded_len > cache.max_len:
        raise ValueError(f"KV cache overflow: chunked prefill of {padded_len} rows at pos {start} > "
                         f"max_len {cache.max_len}")
    if padded_len > s:
        ids = np.concatenate([ids, np.zeros((b, padded_len - s), np.int64)], axis=1)
    dev = cache.pos.device
    logits = None
    for c in range(n_chunks):
        piece = torch.as_tensor(ids[:, c * chunk : (c + 1) * chunk], device=dev)
        logits, cache = _chunk_step(model, cache, piece, min(true_len - 1 - c * chunk, chunk - 1))
    return logits, cache.with_pos(start + true_len)  # rewind the padding slack


class PromptCache:
    """LRU prefix cache of KV states keyed by token prefixes (JAX
    `PromptCache`). `lookup` returns a copy of the longest cached prefix's
    state; `store` keeps a copy of a cache."""

    def __init__(self, max_entries: int = 4):
        self.max_entries = max_entries
        self._entries: OrderedDict = OrderedDict()

    def store(self, ids, cache, length: Optional[int] = None):
        key = tuple(int(t) for t in np.asarray(ids).reshape(-1)[: length or None])
        if length is not None:
            key = key[:length]
        self._entries[key] = _copy(cache)
        self._entries.move_to_end(key)
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)

    def lookup_raw(self, ids):
        """(entry, matched) of the longest cached full prefix of `ids`,
        WITHOUT copying (the caller must not write into it)."""
        seq = tuple(int(t) for t in np.asarray(ids).reshape(-1))
        best_key = None
        for key in self._entries:
            if len(key) <= len(seq) and seq[: len(key)] == key:
                if best_key is None or len(key) > len(best_key):
                    best_key = key
        if best_key is None:
            return None, 0
        self._entries.move_to_end(best_key)
        return self._entries[best_key], len(best_key)

    def lookup(self, ids):
        c, matched = self.lookup_raw(ids)
        if c is None:
            return None, 0
        return _copy(c), matched

    def lookup_common(self, ids):
        """(entry, n) of the entry with the longest token-level COMMON
        prefix with `ids` (the stored prompt need not be a full prefix of the
        new one). No copy."""
        seq = tuple(int(t) for t in np.asarray(ids).reshape(-1))
        best_key, best_n = None, 0
        for key in self._entries:
            n = 0
            for a, b in zip(key, seq):
                if a != b:
                    break
                n += 1
            if n > best_n:
                best_key, best_n = key, n
        if best_key is None:
            return None, 0
        self._entries.move_to_end(best_key)
        return self._entries[best_key], best_n

    def lookup_prefix_rows(self, ids, m: int):
        """A copy of the first `m` KV rows of the best common-prefix entry,
        head m (the engine's prefix-reuse fetch); None if no entry shares >= m
        tokens."""
        c, common = self.lookup_common(ids)
        if c is None or common < m:
            return None
        return _copy(c, rows=m, pos=m)

    def __len__(self):
        return len(self._entries)


@torch.no_grad()
def prefill_with_prompt_cache(model, cache: KVCache, input_ids: np.ndarray, true_len: int,
                              pcache: PromptCache, chunk: int = 256, store: bool = True):
    """Prefix-cache-aware prefill: reuse the longest cached prefix, prefill
    only the suffix (in chunks), optionally store the full prompt's state.
    Returns (logits [B, V], cache, matched)."""
    ids = np.asarray(input_ids, np.int64)
    hit, matched = pcache.lookup(ids[0, :true_len])
    if hit is not None and matched > 0:
        cache = hit
        if matched == true_len:  # full hit: the last token again, for its logits
            tok = torch.as_tensor(ids[:, true_len - 1 : true_len], device=cache.pos.device)
            logits, cache = model(tok, cache.with_pos(true_len - 1), last_only=True)
            return logits[:, 0, :], cache, matched
        logits, cache = chunked_prefill(model, cache, ids[:, matched:true_len], true_len - matched, chunk)
    else:
        logits, cache = chunked_prefill(model, cache, ids, true_len, chunk)
        matched = 0
    if store:
        pcache.store(ids[0, :true_len], cache)
    return logits, cache, matched
