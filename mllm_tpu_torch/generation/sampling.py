"""Samplers: greedy / temperature / top-k / top-p, with a `torch.Generator`.
Counterpart of `mllm_tpu/generation/sampling.py` (`sample_token`, and
`sample_tokens_batched` for the serving engine's per-slot configs).

`keep_mask` gives the set of tokens a config may draw; `sample_token` draws
from the softmax of the temperature-scaled logits restricted to that set.
top_k and top_p together intersect the two keep-sets (the JAX package's
joint rule). JAX's and PyTorch's random streams differ, so the two packages
agree on the keep-sets, not on the tokens drawn.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SamplingConfig:
    max_new_tokens: int = 100
    do_sample: bool = False
    temperature: float = 0.7
    top_k: int = 0
    top_p: float = 0.0
    min_new_tokens: int = 0


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """logits [..., V] -> token ids [...] (first maximum on ties)."""
    return torch.argmax(logits, dim=-1)


def keep_mask(logits: torch.Tensor, cfg: SamplingConfig) -> torch.Tensor:
    """[..., V] bool: the tokens `sample_token` may draw under `cfg`."""
    scaled = logits.float() / cfg.temperature
    v = scaled.shape[-1]
    use_k = bool(cfg.top_k) and cfg.top_k > 0
    use_p = bool(cfg.top_p) and cfg.top_p > 0.0
    if not (use_k or use_p):
        return torch.ones_like(scaled, dtype=torch.bool)
    sorted_desc, sorted_idx = torch.sort(scaled, dim=-1, descending=True)
    if use_k and use_p:  # joint rule: scaled >= k-th largest and >= smallest nucleus logit
        kth = sorted_desc[..., min(cfg.top_k, v) - 1, None]
        sp = torch.softmax(sorted_desc, dim=-1)
        keep_sorted = (torch.cumsum(sp, dim=-1) - sp) < cfg.top_p  # first always kept
        minkeep = torch.where(keep_sorted, sorted_desc, math.inf).amin(dim=-1, keepdim=True)
        return (scaled >= kth) & (scaled >= minkeep)
    if use_k:  # exactly the k largest
        keep_sorted = torch.arange(v, device=scaled.device) < min(cfg.top_k, v)
        keep_sorted = keep_sorted.expand_as(scaled)
    else:  # nucleus: exclusive cumulative probability < p
        sp = torch.softmax(sorted_desc, dim=-1)
        keep_sorted = (torch.cumsum(sp, dim=-1) - sp) < cfg.top_p
    return torch.zeros_like(keep_sorted).scatter(-1, sorted_idx, keep_sorted)


def sample_token(logits: torch.Tensor, cfg: SamplingConfig,
                 generator: torch.Generator) -> torch.Tensor:
    """logits [B, V] -> token ids [B] (int64)."""
    if not cfg.do_sample:
        return greedy(logits)
    scaled = logits.float() / cfg.temperature
    masked = scaled.masked_fill(~keep_mask(logits, cfg), -math.inf)
    probs = torch.softmax(masked, dim=-1)
    return torch.multinomial(probs, 1, generator=generator).squeeze(-1)


def batched_keep_mask(logits: torch.Tensor, temperature: torch.Tensor, top_k: torch.Tensor,
                      top_p: torch.Tensor) -> torch.Tensor:
    """[B, V] bool: the tokens each slot may draw under its own (temperature,
    top_k, top_p), where top_k <= 0 and top_p <= 0 turn a filter off. The JAX
    `sample_tokens_batched` keep-set: scaled >= the k-th largest, and scaled
    >= the smallest logit of the nucleus (exclusive cumulative probability
    < p, so the first token is always kept)."""
    v = logits.shape[-1]
    scaled = logits.float() / temperature.float().clamp_min(1e-6)[:, None]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = sorted_desc.gather(1, (top_k.long().clamp(1, v) - 1)[:, None])
    keep = torch.where((top_k > 0)[:, None], scaled >= kth, True)
    sp = torch.softmax(sorted_desc, dim=-1)
    keep_sorted = (torch.cumsum(sp, dim=-1) - sp) < top_p.float()[:, None]
    minkeep = torch.where(keep_sorted, sorted_desc, math.inf).amin(dim=-1, keepdim=True)
    return keep & torch.where((top_p > 0)[:, None], scaled >= minkeep, True)


def sample_tokens_batched(logits: torch.Tensor, temperature: torch.Tensor, top_k: torch.Tensor,
                          top_p: torch.Tensor, generator: torch.Generator, *,
                          all_greedy: bool = False) -> torch.Tensor:
    """Per-slot sampling on the logits' device (JAX `sample_tokens_batched`):
    logits [B, V]; temperature, top_k, top_p [B]; temperature <= 0 is greedy.
    Returns int64 [B] without a host round trip. Draws are Gumbel-max, as
    `jax.random.categorical`, from `generator`'s stream.

    all_greedy: the caller knows every slot is greedy (from the requests'
    configs, on the host) and skips the sort over the vocabulary."""
    if all_greedy:
        return greedy(logits)
    scaled = logits.float() / temperature.float().clamp_min(1e-6)[:, None]
    masked = scaled.masked_fill(~batched_keep_mask(logits, temperature, top_k, top_p), -math.inf)
    u = torch.rand(masked.shape, generator=generator, device=masked.device)
    gumbel = -torch.log(-torch.log(u))
    sampled = torch.argmax(masked + gumbel, dim=-1)
    return torch.where(temperature <= 0, greedy(logits), sampled)
