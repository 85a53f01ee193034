"""Speculative decoding: counterpart of `mllm_tpu/generation/speculative.py`.

  - `speculative_generate`          : a suffix automaton drafts, one forward of
                                      max_draft + 1 tokens verifies, the longest
                                      matching prefix is accepted and the write
                                      head rewinds (host loop).
  - `speculative_generate_tree`     : several draft traces verified in one
                                      forward through the real decoder blocks
                                      with a tree-attention bias
                                      (causal=False), then `rollback_accept`
                                      compacts the accepted rows.
  - `speculative_generate_compiled` : prompt-lookup drafting over a device
                                      token buffer, the verify forward,
                                      acceptance and the rewind all on the
                                      device: on the card a window of steps is
                                      one CUDA graph, replayed until done (the
                                      host reads one flag a window).

All are greedy, as the reference's SD, and token-for-token equal to greedy
decoding of the same model (up to near-ties between the verify forward, a
prefill-shaped attention, and a decode step). The verify window is fixed at
max_draft + 1 tokens (1 + max_traces * max_draft for the tree), so its
launches are the same every step.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass

import numpy as np
import torch

from ..kv.cache import KVCache
from .draft import SuffixAutomaton, TracePool
from .generate import check_room, pad_to_bucket, prefill
from .graphs import StepGraph, loop_for

# verify steps a replay of speculative_generate_compiled's graph
SD_WINDOW = 8


@dataclass
class SpecStats:
    steps: int = 0
    drafted: int = 0
    accepted: int = 0
    tokens: int = 0

    @property
    def acceptance(self) -> float:
        return self.accepted / self.drafted if self.drafted else 0.0


def _eos_set(model, eos_token_id) -> set:
    if eos_token_id is None:
        e = model.cfg.eos_token_id
        return set(e) if isinstance(e, (list, tuple)) else {e}
    return {eos_token_id} if isinstance(eos_token_id, int) else set(eos_token_id)


@torch.no_grad()
def _verify_step(model, cache, ids: torch.Tensor):
    """Forward [1, W] draft-window tokens; argmax at every position."""
    logits, cache = model(ids, cache, last_only=False)
    return torch.argmax(logits, dim=-1), cache


@torch.no_grad()
def _prefill_first(model, cache, input_ids: np.ndarray, true_len: int):
    """Prefill a [1, S] prompt (padded to 128) and its greedy first token."""
    dev = cache.pos.device
    logits, cache = prefill(model, cache, torch.as_tensor(pad_to_bucket(input_ids, 128), device=dev),
                            true_len)
    return int(torch.argmax(logits[0])), cache


def speculative_generate(model, input_ids: np.ndarray, cache: KVCache, max_new_tokens: int = 128, *,
                         eos_token_id=None, max_draft: int = 8, min_match: int = 2, callback=None):
    """Greedy speculative decoding (JAX `speculative_generate`).
    Returns (tokens, cache, SpecStats)."""
    input_ids = np.asarray(input_ids, np.int64)
    true_len = input_ids.shape[1]
    w = max_draft + 1  # verify window: [last_token, d1..d_max]
    check_room(cache, max(pad_to_bucket(input_ids, 128).shape[1], true_len + max_new_tokens + max_draft),
               "speculative_generate")
    eos = _eos_set(model, eos_token_id)
    sa = SuffixAutomaton()
    sa.add_tokens(input_ids[0])
    t0, cache = _prefill_first(model, cache, input_ids, true_len)
    out = [t0]
    sa.add_token(t0)
    if callback:
        callback(t0)
    stats = SpecStats()
    base = true_len  # where out[-1] will be written: the head, tracked on the host
    dev = cache.pos.device
    while len(out) < max_new_tokens and out[-1] not in eos:
        draft = sa.lookup(max_draft, min_match)[:max_draft]
        stats.steps += 1
        stats.drafted += len(draft)
        ids = np.zeros((1, w), np.int64)
        ids[0, 0] = out[-1]
        if draft:
            ids[0, 1 : 1 + len(draft)] = draft
        preds, cache = _verify_step(model, cache, torch.as_tensor(ids, device=dev))
        preds = preds[0].tolist()
        acc = 0  # the longest prefix of the draft that the greedy predictions match
        while acc < len(draft) and preds[acc] == draft[acc]:
            acc += 1
        new_tokens = list(draft[:acc]) + [int(preds[acc])]
        stats.accepted += acc
        base += acc + 1  # valid entries: out[-1] and the accepted drafts
        cache = cache.with_pos(base)
        for t in new_tokens:
            out.append(t)
            sa.add_token(t)
            if callback:
                callback(t)
            if t in eos or len(out) >= max_new_tokens:
                break
    stats.tokens = len(out)
    return out, cache, stats


# ---------------------------------------------------------------------------
# Tree-mode speculative decoding (several traces verified in one forward)
# ---------------------------------------------------------------------------


@torch.no_grad()
def _tree_verify_step(model, cache, ids: torch.Tensor, positions: torch.Tensor, bias, bias_win):
    """Forward [1, w] tree tokens through the model's own decoder blocks with
    an additive attention bias (tree ancestry, and the window cut for
    sliding-window layers) and causal=False, so every config-driven behavior
    matches normal decoding. update_layer does not advance the head; the
    loop sets it after acceptance."""
    lm = getattr(model, "base", model)  # MegaDecodeLM verifies through its base model
    x = lm.embed_tokens(ids)
    if lm.cfg.embedding_multiplier != 1.0:
        from ..models.transformer import in_dtype

        x = x * in_dtype(lm.cfg.embedding_multiplier, x.dtype)
    for blk in lm.blocks:
        b = bias_win if blk.attn._window() is not None else bias
        x, cache = blk(x, lm.rope, cache, positions, bias=b, causal=False)
    return torch.argmax(lm.logits(lm.norm(x)), dim=-1)[0], cache


def _tree_bias_full(ancestors: np.ndarray, base: int, s_max: int, positions=None,
                    window=None) -> np.ndarray:
    """[w, s_max] additive bias: the cache prefix visible, the draft region
    tree-masked, the tail masked; slot base + 0 is the last accepted token
    (the root). With `window` (and `positions`, each tree row's absolute
    position), keys `window` or more positions older are masked too (JAX
    `_tree_bias_full`)."""
    w = len(ancestors) + 1
    bias = np.full((w, s_max), -1e30, np.float32)
    bias[:, :base] = 0.0  # committed prefix
    bias[0, base] = 0.0  # the root sees itself
    for i, a in enumerate(ancestors):
        row = i + 1
        bias[row, base + row] = 0.0  # self
        bias[row, base] = 0.0  # root
        anc = a
        while anc != -1:
            bias[row, base + 1 + anc] = 0.0
            anc = ancestors[anc]
    if window is not None:
        if positions is None:
            positions = np.full(w, base, np.int64)
        slot_abs = np.concatenate([np.arange(base), np.asarray(positions[:w])])
        slot_abs = np.concatenate([slot_abs, np.full(s_max - len(slot_abs), 1 << 30)])
        q_abs = np.asarray(positions[:w])[:, None]
        bias = np.where(q_abs - slot_abs[None, :] >= window, -1e30, bias)
    return bias.astype(np.float32)


def speculative_generate_tree(model, input_ids: np.ndarray, cache: KVCache, max_new_tokens: int = 128,
                              *, eos_token_id=None, max_draft: int = 6, max_traces: int = 3,
                              min_match: int = 2, callback=None):
    """Greedy speculative decoding verifying several draft traces a step by
    tree attention (JAX `speculative_generate_tree`); fixed verify width
    1 + max_traces * max_draft. Returns (tokens, cache, SpecStats)."""
    input_ids = np.asarray(input_ids, np.int64)
    true_len = input_ids.shape[1]
    w = 1 + max_traces * max_draft
    check_room(cache, max(pad_to_bucket(input_ids, 128).shape[1], true_len + max_new_tokens + w),
               "speculative_generate_tree")
    eos = _eos_set(model, eos_token_id)
    sa = SuffixAutomaton()
    sa.add_tokens(input_ids[0])
    t0, cache = _prefill_first(model, cache, input_ids, true_len)
    out = [t0]
    sa.add_token(t0)
    if callback:
        callback(t0)
    stats = SpecStats()
    s_max = cache.max_len
    base = true_len
    dev = cache.pos.device
    lm = getattr(model, "base", model)
    while len(out) < max_new_tokens and out[-1] not in eos:
        pool = TracePool(max_traces)
        for tr in sa.lookup_multi(max_draft, min_match, max_traces):
            pool.add_trace(tr)
        tree_ids, tree_pos, anc = pool.build_tree(base_pos=base + 1)
        n = len(tree_ids)
        stats.steps += 1
        stats.drafted += n

        ids = np.zeros((1, w), np.int64)
        pos = np.full((1, w), base, np.int64)
        ids[0, 0] = out[-1]
        if n:
            ids[0, 1 : 1 + n] = tree_ids
            pos[0, 1 : 1 + n] = tree_pos
        anc_pad = np.full(w - 1, -2, np.int32)  # -2: padding
        anc_pad[:n] = anc

        def full_bias(window=None):
            b_ = _tree_bias_full(anc_pad[:n], base, s_max, positions=pos[0], window=window)
            if w - 1 - n:
                pad_rows = np.full((w - 1 - n, s_max), -1e30, np.float32)
                pad_rows[:, : base + 1] = 0.0  # harmless: pad rows see the prefix
                b_ = np.concatenate([b_, pad_rows], axis=0)
            return torch.as_tensor(b_, device=dev)

        bias = full_bias()
        win = lm.cfg.sliding_window
        bias_win = full_bias(window=win) if win is not None else bias
        preds, cache = _tree_verify_step(model, cache, torch.as_tensor(ids, device=dev),
                                         torch.as_tensor(pos, device=dev), bias, bias_win)
        preds = preds.tolist()

        best_trace, n_acc = 0, 0
        if pool.traces:
            # the root's prediction must match a trace's first token, else 0 accepted
            best_trace, best_n = 0, -1
            off = 0
            for ti, tr in enumerate(pool.traces):
                acc = 0
                if preds[0] == tr.tokens[0]:
                    acc = 1
                    j = 0
                    while acc < len(tr.tokens) and preds[1 + off + j] == tr.tokens[j + 1]:
                        acc += 1
                        j += 1
                if acc > best_n:
                    best_n, best_trace = acc, ti
                off += len(tr.tokens)
            n_acc = max(best_n, 0)
        stats.accepted += n_acc

        # the bonus token: the prediction at the last accepted node
        trace_off = sum(len(t.tokens) for t in pool.traces[:best_trace])
        if n_acc == 0:
            new_tokens = [int(preds[0])]
            keep_rel = []
        else:
            tr = pool.traces[best_trace]
            new_tokens = list(tr.tokens[:n_acc]) + [int(preds[trace_off + n_acc])]
            keep_rel = [1 + trace_off + j for j in range(n_acc)]

        # compact the cache: keep slot 0 (the root) and the accepted trace's slots
        keep = np.zeros(w, np.int64)
        for i, r in enumerate(keep_rel):
            keep[1 + i] = r
        cache = cache.rollback_accept(base, keep, 1 + n_acc)
        base += 1 + n_acc

        for t in new_tokens:
            out.append(t)
            sa.add_token(t)
            if callback:
                callback(t)
            if t in eos or len(out) >= max_new_tokens:
                break
    stats.tokens = len(out)
    return out, cache, stats


# ---------------------------------------------------------------------------
# Speculative decoding on the device (prompt-lookup drafting)
# ---------------------------------------------------------------------------


class _SpecLoop:
    """The state of one compiled speculative loop at fixed addresses: the
    cache (the given storage, a head of its own), the token history `buf`
    (capacity max_len + max_draft + 1), n (tokens in buf), m (tokens
    generated), the budget `limit`, `done`, the eos id and the counters; the
    constant index vectors of the body. `graph` runs a window of `step`s."""

    def __init__(self, model, cache, max_draft: int, ngram: int, window: int):
        dev = cache.pos.device
        self.max_draft, self.ngram, self.w = max_draft, ngram, max_draft + 1
        self.cache = cache.with_pos(torch.zeros((), dtype=torch.int32, device=dev))
        cap = self.cache.max_len + self.w
        self.buf = torch.zeros(cap, dtype=torch.int32, device=dev)

        def z(dtype=torch.int32):
            return torch.zeros((), dtype=dtype, device=dev)

        self.n, self.m, self.limit, self.eos = z(), z(), z(), z()
        self.steps, self.drafted, self.accepted = z(), z(), z()
        self.done = z(torch.bool)
        self.ii = torch.arange(cap - ngram, dtype=torch.int32, device=dev)
        self.kk = torch.arange(max_draft, dtype=torch.int32, device=dev)
        self.jj = torch.arange(self.w, dtype=torch.int32, device=dev)
        self.gg = torch.arange(ngram, dtype=torch.int32, device=dev)
        model = weakref.ref(model)
        step = lambda: self.step(model())  # noqa: E731
        self.graph = StepGraph(lambda: [step() for _ in range(window)], dev, warmup=step,
                               name="speculative_generate_compiled")

    def step(self, model) -> None:
        """The body of JAX's while loop on the static state, in place. A step
        after `done` computes but writes nothing and moves no counter (its
        verify forward writes K/V rows past the head, which nothing reads)."""
        buf, n, m, ngram, max_draft, w = self.buf, self.n, self.m, self.ngram, self.max_draft, self.w
        ii, kk, jj = self.ii, self.kk, self.jj
        live = ~self.done
        lw = ii.shape[0]
        # draft: the most recent earlier occurrence of the last `ngram` tokens;
        # prefer one whose continuation is a full max_draft window of history
        key = buf[(n - ngram + self.gg).long()]
        wins = torch.stack([buf[k : k + lw] for k in range(ngram)], dim=1)  # [lw, ngram]
        hit = (wins == key[None, :]).all(dim=1) & (ii + ngram <= n - 1)
        full = hit & (ii + ngram + max_draft <= n)
        idx_full = torch.where(full, ii, -1).amax()
        idx = torch.where(idx_full >= 0, idx_full, torch.where(hit, ii, -1).amax())
        src = idx.clamp_min(0) + ngram
        draft = buf[(src + kk).long()]
        draft_len = torch.where(idx >= 0, torch.minimum(torch.full_like(src, max_draft), n - src), 0)

        # verify [last token, draft] in one forward; the head is n - 1 (KV for
        # every token but the newest)
        ids = torch.cat([buf[(n - 1).reshape(1).long()], draft])[None].long()
        base = self.cache.pos
        logits, cache = model(ids, self.cache, last_only=False)
        preds = torch.argmax(logits, dim=-1)[0].to(torch.int32)  # [w]

        # accept the longest matched draft prefix; preds[acc] is the bonus token
        match = (preds[:max_draft] == draft) & (kk < draft_len)
        acc = torch.cumprod(match.to(torch.int32), dim=0).sum(dtype=torch.int32)
        blk = acc + 1
        is_eos = (preds == self.eos) & (jj < blk)
        first_eos = torch.where(is_eos, jj, w).amin()
        n_take = torch.minimum(blk, torch.minimum(first_eos + 1, self.limit - m))
        done = (first_eos < n_take) | (m + n_take >= self.limit)

        at = (n + jj).long()
        buf.index_put_((at,), torch.where(live, preds, buf[at]))  # junk past n_take is masked by n
        took = torch.where(live, n_take, 0)
        self.cache.pos.copy_(base + took)
        n += took
        m += took
        self.steps += live.to(torch.int32)
        self.drafted += torch.where(live, draft_len, 0)
        self.accepted += torch.where(live, torch.minimum(acc, n_take), 0)
        self.done |= live & done


@torch.no_grad()
def speculative_generate_compiled(model, input_ids, cache: KVCache, true_len: int, max_new_tokens: int,
                                  eos_token_id: int = -1, max_draft: int = 8, ngram: int = 3, *,
                                  window: int = SD_WINDOW):
    """Greedy speculative generation with the loop on the device (JAX
    `speculative_generate_compiled`): the draft is prompt lookup, the most
    recent earlier occurrence of the last `ngram` tokens in the token
    history; the verify forward, longest-prefix acceptance, the rewind of
    the write head and eos handling run in the step. On the card a window
    of `window` steps is one CUDA graph, replayed until done; on the CPU the
    same steps run eagerly.

    Needs cache.max_len >= true_len + max_new_tokens + max_draft + 1 (checked:
    JAX's clamped writes would shift the verify window) and true_len >=
    ngram. Returns (tokens [max_new_tokens] int32 (junk beyond n_gen), n_gen,
    steps, drafted, accepted), as tensors on the cache's device."""
    ids = torch.as_tensor(np.asarray(input_ids) if not isinstance(input_ids, torch.Tensor) else input_ids)
    if true_len < ngram:
        raise ValueError(f"prompt ({true_len}) shorter than ngram ({ngram})")
    check_room(cache, max(ids.shape[1], true_len + max_new_tokens + max_draft + 1),
               "speculative_generate_compiled")
    loop = loop_for(model, cache, ("speculative_generate_compiled", max_draft, ngram, window),
                    lambda c: _SpecLoop(model, c, max_draft, ngram, window))
    dev = loop.buf.device
    ids = ids.to(dev)
    loop.cache.pos.copy_(cache.pos)
    hidden, _ = model.hidden_states(ids, loop.cache)
    t0 = torch.argmax(model.logits(hidden[:, true_len - 1 : true_len])[0, 0]).to(torch.int32)
    loop.cache.pos.fill_(true_len)
    loop.buf.zero_()
    loop.buf[: ids.shape[1]].copy_(ids[0])
    loop.buf[true_len : true_len + 1].copy_(t0)
    loop.n.fill_(true_len + 1)
    loop.m.fill_(1)
    loop.limit.fill_(max_new_tokens)
    loop.eos.fill_(eos_token_id)
    for c in (loop.steps, loop.drafted, loop.accepted):
        c.zero_()
    loop.done.copy_((t0 == loop.eos) | (max_new_tokens <= 1))
    while not bool(loop.done):  # the one host read a window
        loop.graph()
    return (loop.buf[true_len : true_len + max_new_tokens].clone(), loop.m.clone(), loop.steps.clone(),
            loop.drafted.clone(), loop.accepted.clone())
