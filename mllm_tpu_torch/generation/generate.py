"""Generation loops: counterpart of `mllm_tpu/generation/generate.py`.

  - `generate`                : streaming loop with a per-token callback (batch 1
                                semantics for the callback and eos).
  - `batched_generate`        : equal-length prompts, lockstep decode.
  - `ragged_batched_generate` : unequal prompts, LEFT padded; rope positions
                                shift back per sequence and the pad prefix is
                                masked.

  - `generate_compiled`       : the whole decode loop on the device, as the JAX
                                package's jitted `lax.while_loop`: on the card
                                a window of decode steps is captured once as
                                a CUDA graph and replayed until eos or the
                                budget (`graphs.StepGraph`); the host reads
                                one flag a window.

The first three run eagerly: the cache is updated in place and each decode
step is a sequence of kernel launches; the host reads one token per step
back. Every loop checks up front that its tokens fit the cache: the cache
does not read its device write head back to check each append.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..kv.cache import KVCache
from .graphs import StepGraph, loop_for
from .sampling import SamplingConfig, sample_token

# decode steps a replay of generate_compiled's graph (PERF.md: the window
# sweep of tools/graph_window.py)
COMPILED_WINDOW = 32


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


def check_room(cache, need: int, what: str) -> None:
    """Raise unless `need` cache rows fit: the loops know their lengths up
    front, and the cache does not read its device head back."""
    if need > cache.max_len:
        raise ValueError(f"KV cache overflow: {what} needs {need} rows > max_len {cache.max_len}")


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
    check_room(cache, max(padded.shape[1], true_len + cfg.max_new_tokens - 1), "generate")
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
    check_room(cache, width + cfg.max_new_tokens - 1, "ragged_batched_generate")
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
    check_room(cache, s + cfg.max_new_tokens - 1, "batched_generate")
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


class _DecodeLoop:
    """The state of one compiled decode loop, in tensors at fixed addresses:
    the cache (the given storage and a head of its own), the token buffer,
    the step index i, the budget `limit`, the current token, `done` and the
    eos id, and the generator the sampler draws from. `graph` runs a window
    of `step`s (one step eagerly first, on the card, as its warm-up)."""

    def __init__(self, model, cache, scfg: SamplingConfig, window: int):
        dev = cache.k.device
        self.cache = cache.with_pos(torch.zeros((), dtype=torch.int32, device=dev))
        self.tokens = torch.full((self.cache.max_len,), -1, dtype=torch.int32, device=dev)
        self.i = torch.zeros((), dtype=torch.int32, device=dev)
        self.limit = torch.zeros((), dtype=torch.int32, device=dev)
        self.tok = torch.zeros(1, dtype=torch.int64, device=dev)
        self.done = torch.zeros((), dtype=torch.bool, device=dev)
        self.eos = torch.zeros((), dtype=torch.int64, device=dev)
        self.gen = torch.Generator(device=dev)
        model = weakref.ref(model)  # the loops cache is keyed weakly by the model
        step = lambda: self.step(model(), scfg)  # noqa: E731
        self.graph = StepGraph(lambda: [step() for _ in range(window)], dev, warmup=step,
                               generators=[self.gen], name="generate_compiled")

    def step(self, model, scfg: SamplingConfig) -> None:
        """The body of JAX's while loop on the static state, in place: model
        call, sample, write token i, set done on eos. A step after `done` (or
        past the budget) computes but writes nothing and moves neither i nor
        the head, so a window may run past the end."""
        live = ~self.done & (self.i < self.limit)
        logits, cache = model(self.tok[:, None], self.cache, last_only=True)
        nxt = sample_token(logits[:, 0], scfg, self.gen)
        at = self.i.clamp(max=self.tokens.shape[0] - 1).long().reshape(1)
        self.tokens.index_put_((at,), torch.where(live, nxt.to(torch.int32), self.tokens[at]))
        self.done |= live & (nxt[0] == self.eos)
        self.tok.copy_(torch.where(live, nxt, self.tok))
        self.cache.pos.copy_(torch.where(live, cache.pos, self.cache.pos))
        self.i += live.to(torch.int32)


@torch.no_grad()
def generate_compiled(
    model,
    input_ids,  # [1, S_padded]
    cache: KVCache,
    true_len: int,
    max_new_tokens: int,
    scfg: SamplingConfig = SamplingConfig(),
    eos_token_id: int = -1,
    seed: int = 0,
    *,
    window: int = COMPILED_WINDOW,
):
    """Whole generation with the decode loop on the device (JAX
    `generate_compiled`): prefill and the first sample run eagerly, then
    windows of `window` decode steps replay as one CUDA graph until eos or
    max_new_tokens, the host reading `done` once a window. On the CPU the
    same step code runs eagerly, a window at a time.

    Returns (tokens [max_new_tokens] int32 padded with -1, n_generated), as
    tensors on the cache's device. Needs max_len >= S_padded and
    max_len >= true_len + max_new_tokens - 1 (checked: the head is not read
    back)."""
    ids = torch.as_tensor(np.asarray(input_ids) if not isinstance(input_ids, torch.Tensor) else input_ids)
    if ids.dim() != 2 or ids.shape[0] != 1:
        raise ValueError(f"generate_compiled: input_ids must be [1, S], got {tuple(ids.shape)}")
    if max_new_tokens < 1:
        raise ValueError("generate_compiled: max_new_tokens must be >= 1")
    check_room(cache, max(ids.shape[1], true_len + max_new_tokens - 1), "generate_compiled")
    loop = loop_for(model, cache, ("generate_compiled", window,
                                   dataclasses.replace(scfg, max_new_tokens=0, min_new_tokens=0)),
                    lambda c: _DecodeLoop(model, c, scfg, window))
    dev = loop.tokens.device
    loop.cache.pos.copy_(cache.pos)
    hidden, _ = model.hidden_states(ids.to(dev), loop.cache)
    logits = model.logits(hidden[:, true_len - 1 : true_len])[:, 0]
    loop.cache.pos.fill_(true_len)
    loop.gen.manual_seed(seed)
    tok0 = sample_token(logits, scfg, loop.gen)
    loop.tokens.fill_(-1)
    loop.tokens[:1].copy_(tok0)
    loop.tok.copy_(tok0)
    loop.i.fill_(1)
    loop.limit.fill_(max_new_tokens)
    loop.eos.fill_(eos_token_id)
    loop.done.copy_(tok0[0] == loop.eos)
    while not bool(loop.done | (loop.i >= loop.limit)):  # the one host read a window
        loop.graph()
    return loop.tokens[:max_new_tokens].clone(), loop.i.clone()
