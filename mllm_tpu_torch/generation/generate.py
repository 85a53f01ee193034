"""Generation loops: counterpart of `mllm_tpu/generation/generate.py`.

  - `generate`                : streaming loop with a per-token callback (batch 1
                                semantics for the callback and eos).
  - `batched_generate`        : equal-length prompts, lockstep decode.
  - `ragged_batched_generate` : unequal prompts, LEFT padded; rope positions
                                shift back per sequence and the pad prefix is
                                masked.

PyTorch runs eagerly: the cache is updated in place and each decode step is a
sequence of kernel launches; the host reads one token per step back. The
fully on-device loop (`generate_compiled`) is a later slice, as a CUDA graph.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..kv.cache import KVCache
from .sampling import SamplingConfig, sample_token


def pad_to_bucket(ids: np.ndarray, multiple: int = 128, pad_id: int = 0) -> np.ndarray:
    """Pad a prompt (at the end) to a multiple of `multiple` tokens."""
    s = ids.shape[-1]
    target = max(multiple, -(-s // multiple) * multiple)
    if target == s:
        return ids
    pad = np.full(ids.shape[:-1] + (target - s,), pad_id, dtype=ids.dtype)
    return np.concatenate([ids, pad], axis=-1)


def left_pad(prompts: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """Unequal prompts -> (ids [B, width] left padded with 0, pad_lens [B])."""
    lens = np.array([len(p) for p in prompts], np.int32)
    width = int(lens.max())
    ids = np.zeros((len(prompts), width), np.int64)
    for i, p in enumerate(prompts):
        ids[i, width - len(p):] = p
    return ids, (width - lens).astype(np.int32)


@torch.no_grad()
def prefill(model, cache: KVCache, input_ids: torch.Tensor, true_len: int, pad_lens=None):
    """Run a (padded) prompt; logits [B, V] at the true last token, and the
    cache write head set to true_len so decode overwrites the padding slack."""
    hidden, cache = model.hidden_states(input_ids, cache, pad_lens=pad_lens)
    logits = model.logits(hidden[:, true_len - 1 : true_len, :])
    return logits[:, 0, :], cache.with_pos(true_len)


@torch.no_grad()
def decode_step(model, cache: KVCache, token: torch.Tensor, pad_lens=None):
    """One token per sequence: token [B] -> (logits [B, V], cache)."""
    logits, cache = model(token[:, None], cache, last_only=True, pad_lens=pad_lens)
    return logits[:, 0, :], cache


@dataclass
class GenerationResult:
    tokens: list[int]
    ttft_s: float = 0.0
    prefill_tps: float = 0.0
    decode_tps: float = 0.0


def _eos_ids(model, eos_token_id=None) -> set:
    if eos_token_id is None:
        e = model.cfg.eos_token_id
        return set(e) if isinstance(e, (tuple, list)) else {e}
    return {eos_token_id} if isinstance(eos_token_id, int) else set(eos_token_id)


def generate(
    model,
    input_ids: np.ndarray,  # [B, S] or [S]
    cache: KVCache,
    cfg: SamplingConfig,
    *,
    eos_token_id=None,
    callback: Optional[Callable[[int], bool]] = None,
    seed: int = 0,
    bucket: int = 128,
):
    """Streaming generation (batch 1 semantics for the callback).
    Returns (GenerationResult, cache)."""
    input_ids = np.asarray(input_ids, np.int64)
    if input_ids.ndim == 1:
        input_ids = input_ids[None]
    true_len = input_ids.shape[1]
    dev = model.device
    padded = torch.as_tensor(pad_to_bucket(input_ids, bucket), device=dev)
    eos = _eos_ids(model, eos_token_id)
    gen = torch.Generator(device=dev).manual_seed(seed)

    t0 = time.perf_counter()
    logits, cache = prefill(model, cache, padded, true_len)
    tok = sample_token(logits, cfg, gen)
    first = int(tok[0])
    t1 = time.perf_counter()

    out = [first]
    if callback is not None and callback(first) is False:
        return GenerationResult(out, ttft_s=t1 - t0), cache
    if first in eos and len(out) >= cfg.min_new_tokens:
        return GenerationResult(out, ttft_s=t1 - t0, prefill_tps=true_len / (t1 - t0)), cache

    td0 = time.perf_counter()
    for _ in range(cfg.max_new_tokens - 1):
        logits, cache = decode_step(model, cache, tok)
        tok = sample_token(logits, cfg, gen)
        t = int(tok[0])
        out.append(t)
        if callback is not None and callback(t) is False:
            break
        if t in eos and len(out) >= cfg.min_new_tokens:
            break
    td1 = time.perf_counter()
    n_dec = len(out) - 1
    return (
        GenerationResult(
            out,
            ttft_s=t1 - t0,
            prefill_tps=true_len / (t1 - t0) if t1 > t0 else 0.0,
            decode_tps=n_dec / (td1 - td0) if td1 > td0 and n_dec else 0.0,
        ),
        cache,
    )


def ragged_batched_generate(
    model,
    prompts: list[np.ndarray],  # per-sequence token ids (different lengths)
    cache: KVCache,
    cfg: SamplingConfig,
    *,
    seed: int = 0,
):
    """Batched generation over unequal-length prompts via LEFT padding: all
    sequences share the cache write head. Returns (tokens [B, T], n_valid [B],
    cache); n_valid counts tokens up to and including each row's first eos."""
    dev = model.device
    ids, pad = left_pad(prompts)
    b, width = ids.shape
    pad_lens = torch.as_tensor(pad, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)

    logits, cache = prefill(model, cache, torch.as_tensor(ids, device=dev), width, pad_lens)
    tok = sample_token(logits, cfg, gen)
    eos_ids = tuple(_eos_ids(model))
    out = [tok]
    finished = np.zeros(b, bool)
    for _ in range(cfg.max_new_tokens - 1):
        logits, cache = decode_step(model, cache, tok, pad_lens)
        tok = sample_token(logits, cfg, gen)
        finished |= np.isin(out[-1].cpu().numpy(), eos_ids)
        out.append(tok)
        if finished.all():
            break
    toks = torch.stack(out, dim=1).cpu().numpy()  # [B, T]
    n_valid = np.full(b, toks.shape[1], np.int32)
    for i in range(b):
        hits = np.where(np.isin(toks[i], eos_ids))[0]
        if hits.size:
            n_valid[i] = hits[0] + 1
    return toks, n_valid, cache


def batched_generate(
    model,
    input_ids: np.ndarray,  # [B, S] already padded to equal length
    lengths: np.ndarray,  # [B] true lengths (S for all: lockstep, as the JAX package)
    cache: KVCache,
    cfg: SamplingConfig,
    *,
    seed: int = 0,
):
    """Lockstep batched decode over equal-length prompts; per-sequence eos
    marks completion. Returns (tokens [B, T], cache)."""
    input_ids = np.asarray(input_ids, np.int64)
    b, s = input_ids.shape
    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    logits, cache = prefill(model, cache, torch.as_tensor(input_ids, device=dev), s)
    tok = sample_token(logits, cfg, gen)
    eos_ids = tuple(_eos_ids(model))
    out = [tok]
    finished = np.zeros(b, bool)
    for _ in range(cfg.max_new_tokens - 1):
        logits, cache = decode_step(model, cache, tok)
        tok = sample_token(logits, cfg, gen)
        finished |= np.isin(tok.cpu().numpy(), eos_ids)
        out.append(tok)
        if finished.all():
            break
    return torch.stack(out, dim=1).cpu().numpy(), cache
