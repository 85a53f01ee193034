"""The port's chunked prefill and prompt cache (generation/prefill.py)
against mllm_tpu on the same weights: the counterparts of
tests/test_prefill_prompt_cache.py (chunked prefill, prefix reuse, LRU
eviction). A tiny f32 JAX model (2 layers, 4 query / 2 KV heads) is bridged
into the port.

Tolerances: logits within 1e-4 x max |logit| of JAX's `chunked_prefill`
(f32 on both sides, sums in other orders); matched counts and heads exactly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mllm_tpu.core.config import TextConfig as JaxTextConfig
from mllm_tpu.generation import prefill as jpre
from mllm_tpu.models.transformer import CausalLM as JaxCausalLM
from mllm_tpu_torch.core.config import TextConfig
from mllm_tpu_torch.generation import prefill as tpre
from mllm_tpu_torch.models.bridge import causal_lm_from_jax_params

CPU = torch.device("cpu")
CFG_KW = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
              eos_token_id=-3, rope_theta=10000.0)
TOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    jm = JaxCausalLM.init(jax.random.PRNGKey(5), JaxTextConfig(**CFG_KW))
    params = {k: np.asarray(v) for k, v in jm.parameters().items()}
    return jm, causal_lm_from_jax_params(params, TextConfig(**CFG_KW), CPU)


def _close(t, j):
    t, j = t.numpy(), np.asarray(j)
    assert np.max(np.abs(t - j)) <= TOL * np.max(np.abs(j))


def _caches(jm, tm, max_len=128):
    return jm.init_cache(1, max_len, jnp.float32), tm.init_cache(1, max_len, torch.float32)


@pytest.mark.parametrize("n,chunk", [(21, 8), (16, 8), (5, 8), (40, 16)])
def test_chunked_prefill_matches_jax(pair, n, chunk):
    """A partial last chunk, an exact multiple, one short chunk, and more chunks."""
    jm, tm = pair
    ids = np.random.default_rng(0).integers(0, 64, (1, 40)).astype(np.int32)[:, :n]
    jc, tc = _caches(jm, tm)
    jl, jc = jpre.chunked_prefill(jm, jc, ids, n, chunk=chunk)
    tl, tc = tpre.chunked_prefill(tm, tc, ids, n, chunk=chunk)
    _close(tl, jl)
    assert int(tc.pos) == int(jc.pos) == n


def test_chunked_prefill_at_a_head(pair):
    """Chunks appended after an existing prefix (the prompt cache's suffix
    path): positions and attention lengths come from the device head."""
    jm, tm = pair
    ids = np.random.default_rng(1).integers(0, 64, (1, 30)).astype(np.int32)
    jc, tc = _caches(jm, tm)
    _, jc = jpre.chunked_prefill(jm, jc, ids[:, :12], 12, chunk=8)
    _, tc = tpre.chunked_prefill(tm, tc, ids[:, :12], 12, chunk=8)
    jl, jc = jpre.chunked_prefill(jm, jc, ids[:, 12:], 18, chunk=8)
    tl, tc = tpre.chunked_prefill(tm, tc, ids[:, 12:], 18, chunk=8)
    _close(tl, jl)
    assert int(tc.pos) == int(jc.pos) == 30


def test_chunked_prefill_checks_room(pair):
    _, tm = pair
    with pytest.raises(ValueError, match="overflow"):
        tpre.chunked_prefill(tm, tm.init_cache(1, 24, torch.float32), np.zeros((1, 20), np.int64), 20, chunk=16)


def _snapshot(m, prefix, torch_side):
    if torch_side:
        cache = m.init_cache(1, 128, torch.float32)
        _, cache = m(torch.as_tensor(prefix[None]), cache, last_only=True)
    else:
        cache = m.init_cache(1, 128, jnp.float32)
        _, cache = m(jnp.asarray(prefix[None], jnp.int32), cache, last_only=True)
    return cache


def test_prompt_cache_prefix_reuse_matches_jax(pair):
    jm, tm = pair
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, 64, 12).astype(np.int32)
    ids_a = np.concatenate([prefix, rng.integers(0, 64, 5).astype(np.int32)])[None]
    ids_b = np.concatenate([prefix, rng.integers(0, 64, 7).astype(np.int32)])[None]
    jpc, tpc = jpre.PromptCache(max_entries=2), tpre.PromptCache(max_entries=2)

    jc, tc = _caches(jm, tm)
    jl, _, jm_a = jpre.prefill_with_prompt_cache(jm, jc, ids_a, ids_a.shape[1], jpc, chunk=8)
    tl, _, tm_a = tpre.prefill_with_prompt_cache(tm, tc, ids_a, ids_a.shape[1], tpc, chunk=8)
    assert tm_a == jm_a == 0 and len(tpc) == len(jpc) == 1
    _close(tl, jl)

    jpc.store(prefix, _snapshot(jm, prefix, False))
    tpc.store(prefix, _snapshot(tm, prefix, True))
    jc, tc = _caches(jm, tm)
    jl, jcb, jm_b = jpre.prefill_with_prompt_cache(jm, jc, ids_b, ids_b.shape[1], jpc, chunk=8)
    tl, tcb, tm_b = tpre.prefill_with_prompt_cache(tm, tc, ids_b, ids_b.shape[1], tpc, chunk=8)
    assert tm_b == jm_b == len(prefix)
    assert int(tcb.pos) == int(jcb.pos) == ids_b.shape[1]
    _close(tl, jl)

    # the full-hit path: the same prompt again
    jc, tc = _caches(jm, tm)
    jl, _, jm_f = jpre.prefill_with_prompt_cache(jm, jc, ids_b, ids_b.shape[1], jpc, chunk=8)
    tl, _, tm_f = tpre.prefill_with_prompt_cache(tm, tc, ids_b, ids_b.shape[1], tpc, chunk=8)
    assert tm_f == jm_f == ids_b.shape[1]
    _close(tl, jl)


def test_prompt_cache_entries_are_copies(pair):
    """A hit is a copy: writing into it leaves the entry as it was."""
    _, tm = pair
    prefix = np.arange(6, dtype=np.int32)
    pc = tpre.PromptCache()
    pc.store(prefix, _snapshot(tm, prefix, True))
    hit, n = pc.lookup(np.arange(9))
    assert n == 6 and int(hit.pos) == 6
    hit.k.fill_(7.0)
    again, _ = pc.lookup(np.arange(9))
    assert not again.k.eq(7.0).all()
    rows = pc.lookup_prefix_rows(np.arange(9), 4)
    assert rows.k.shape[3] == 4 and int(rows.pos) == 4
    torch.testing.assert_close(rows.k, again.k[:, :, :, :4], rtol=0, atol=0)


def test_prompt_cache_lru_eviction(pair):
    _, tm = pair
    pc = tpre.PromptCache(max_entries=2)
    c = tm.init_cache(1, 16, torch.float32)
    pc.store(np.array([1, 2]), c)
    pc.store(np.array([3, 4]), c)
    pc.store(np.array([5, 6]), c)
    assert len(pc) == 2
    hit, n = pc.lookup(np.array([1, 2, 9]))
    assert hit is None and n == 0  # the oldest is evicted
    assert pc.lookup_common(np.array([3, 9]))[1] == 1
