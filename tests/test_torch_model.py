"""The port's CausalLM, generation loops and samplers against mllm_tpu on
the same weights: a tiny JAX model (2 layers, 4 query / 2 KV heads,
head_dim 64) is bridged into the port with causal_lm_from_jax_params.

Tolerances: f32 logits 1e-4 relative to the largest |logit| (the two sides
sum in different orders); bf16 logits 2e-2 relative (one bf16 rounding per
op, in different places); greedy tokens and sampler keep-sets exactly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mllm_tpu.core.config import TextConfig as JaxTextConfig
from mllm_tpu.generation import generate as jgen
from mllm_tpu.generation.sampling import SamplingConfig as JaxSamplingConfig
from mllm_tpu.generation.sampling import sample_token as jax_sample_token
from mllm_tpu.models.transformer import CausalLM as JaxCausalLM
from mllm_tpu_torch.core.config import TextConfig
from mllm_tpu_torch.generation import generate as tgen
from mllm_tpu_torch.generation.sampling import SamplingConfig, keep_mask, sample_token
from mllm_tpu_torch.models.bridge import causal_lm_from_jax_params

CPU = torch.device("cpu")
CFG_KW = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, head_dim=64,
              max_position_embeddings=256, rope_theta=10000.0, eos_token_id=127)


# one compiled program per call shape, instead of op-by-op dispatch
_jax_forward = jax.jit(lambda m, ids, c: m(ids, c, last_only=False))
_jax_step = jax.jit(lambda m, ids, c: m(ids, c, last_only=True))


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def _pair(layout="unrolled", jdtype=jnp.float32, tdtype=torch.float32, **cfg_kw):
    jcfg = JaxTextConfig(**{**CFG_KW, **cfg_kw})
    jm = JaxCausalLM.init(jax.random.PRNGKey(0), jcfg, dtype=jdtype)
    if layout == "stacked":
        jm = jm.stack()
    params = {k: np.asarray(v) for k, v in jm.parameters().items()}
    tm = causal_lm_from_jax_params(params, TextConfig(**{**CFG_KW, **cfg_kw}), CPU, tdtype)
    return jm, tm


@pytest.fixture(scope="module")
def f32_pair():
    return _pair()


@pytest.mark.parametrize("layout,cfg_kw", [
    ("unrolled", {}),
    ("stacked", {}),
    ("unrolled", dict(qk_norm=True, attention_bias=False, sliding_window=5,
                      tie_word_embeddings=False)),
], ids=["unrolled", "stacked", "qknorm_window_untied"])
def test_prefill_and_decode_logits(layout, cfg_kw):
    jm, tm = _pair(layout, **cfg_kw)
    ids = np.random.default_rng(0).integers(0, 128, (2, 11))
    jc = jm.init_cache(2, 32, jnp.float32)
    tc = tm.init_cache(2, 32, torch.float32)
    jl, jc = _jax_forward(jm, jnp.asarray(ids, jnp.int32), jc)
    tl, tc = tm(torch.from_numpy(ids), tc, last_only=False)
    assert tc.pos == int(jc.pos) == 11
    assert _rel(tl, jl) < 1e-4
    tok = np.array([3, 77])
    for _ in range(3):  # decode steps read the cache the previous steps wrote
        jl, jc = _jax_step(jm, jnp.asarray(tok[:, None], jnp.int32), jc)
        tl, tc = tm(torch.from_numpy(tok[:, None]), tc)
        assert _rel(tl, jl) < 1e-4
        tok = np.array(jnp.argmax(jl[:, 0], -1))


def test_bf16_logits():
    jm, tm = _pair(jdtype=jnp.bfloat16, tdtype=torch.bfloat16)
    ids = np.random.default_rng(1).integers(0, 128, (1, 9))
    jl, jc = _jax_step(jm, jnp.asarray(ids, jnp.int32), jm.init_cache(1, 32, jnp.bfloat16))
    tl, tc = tm(torch.from_numpy(ids), tm.init_cache(1, 32, torch.bfloat16))
    assert tl.dtype == torch.float32
    assert _rel(tl, jl) < 2e-2
    jl, _ = _jax_step(jm, jnp.asarray([[5]], jnp.int32), jc)
    tl, _ = tm(torch.tensor([[5]]), tc)
    assert _rel(tl, jl) < 2e-2


def test_generate_greedy_tokens_match(f32_pair):
    jm, tm = f32_pair
    ids = np.random.default_rng(2).integers(0, 127, (1, 13)).astype(np.int32)
    jres, _ = jgen.generate(jm, ids, jm.init_cache(1, 64, jnp.float32),
                            JaxSamplingConfig(max_new_tokens=12), bucket=16)
    tres, tc = tgen.generate(tm, ids, tm.init_cache(1, 64, torch.float32),
                             SamplingConfig(max_new_tokens=12), bucket=16)
    assert tres.tokens == jres.tokens
    assert tc.pos == 13 + len(tres.tokens) - 1


def test_ragged_batched_generate_matches(f32_pair):
    jm, tm = f32_pair
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 127, n).astype(np.int32) for n in (3, 9, 6)]
    jt, jn, _ = jgen.ragged_batched_generate(jm, prompts, jm.init_cache(3, 48, jnp.float32),
                                             JaxSamplingConfig(max_new_tokens=10))
    tt, tn, _ = tgen.ragged_batched_generate(tm, prompts, tm.init_cache(3, 48, torch.float32),
                                             SamplingConfig(max_new_tokens=10))
    np.testing.assert_array_equal(tt, np.asarray(jt))
    np.testing.assert_array_equal(tn, jn)
    # each left-padded row decodes as its prompt does alone
    for i, p in enumerate(prompts):
        solo, _ = tgen.generate(tm, p, tm.init_cache(1, 48, torch.float32),
                                SamplingConfig(max_new_tokens=10), bucket=16)
        assert tt[i, : tn[i]].tolist() == solo.tokens[: tn[i]]


def test_batched_generate_matches(f32_pair):
    jm, tm = f32_pair
    ids = np.random.default_rng(4).integers(0, 127, (2, 7)).astype(np.int32)
    jt, _ = jgen.batched_generate(jm, ids, np.array([7, 7]), jm.init_cache(2, 32, jnp.float32),
                                  JaxSamplingConfig(max_new_tokens=6))
    tt, _ = tgen.batched_generate(tm, ids, np.array([7, 7]), tm.init_cache(2, 32, torch.float32),
                                  SamplingConfig(max_new_tokens=6))
    np.testing.assert_array_equal(tt, np.asarray(jt))


SAMPLER_CASES = {
    "top_k": dict(top_k=4, temperature=0.8),
    "top_p": dict(top_p=0.7, temperature=1.0),
    "top_k_and_top_p": dict(top_k=6, top_p=0.6, temperature=0.9),
}


@pytest.mark.parametrize("case", list(SAMPLER_CASES))
def test_sampler_keep_sets_match(case):
    """The tokens JAX's sample_token draws over many keys form the same set
    as the port's keep_mask, and the port's draws stay inside it. Kept
    tokens have probability >= ~1%, so 20000 JAX draws and 2000 port draws
    (one call over the logits repeated 2000 times: rows draw independently)
    miss none of them."""
    kw = SAMPLER_CASES[case]
    logits = np.random.default_rng(5).standard_normal((2, 16)).astype(np.float32)
    jcfg = JaxSamplingConfig(do_sample=True, **kw)
    keys = jax.random.split(jax.random.PRNGKey(0), 20000)
    jdraws = np.asarray(jax.vmap(lambda kk: jax_sample_token(kk, jnp.asarray(logits), jcfg))(keys))
    tcfg = SamplingConfig(do_sample=True, **kw)
    mask = keep_mask(torch.from_numpy(logits), tcfg).numpy()
    gen = torch.Generator().manual_seed(0)
    tdraws = sample_token(torch.from_numpy(logits).repeat(2000, 1), tcfg, gen)
    tdraws = tdraws.numpy().reshape(2000, 2)
    for row in range(2):
        keep = set(np.flatnonzero(mask[row]).tolist())
        assert set(jdraws[:, row].tolist()) == keep
        assert set(tdraws[:, row].tolist()) == keep


def test_greedy_is_first_argmax():
    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0]])
    assert sample_token(logits, SamplingConfig(), torch.Generator()).tolist() == [1]


def test_kv_cache_writes_in_place_and_rejects_overflow():
    from mllm_tpu_torch.kv.cache import KVCache

    cache = KVCache.init(2, 1, 4, 2, 8, device=CPU, dtype=torch.float32).with_pos(1)
    new = torch.ones(1, 3, 2, 8)  # [B, S, H_kv, D]
    assert cache.update_layer(1, new, 2 * new) is cache
    assert cache.k[1, 0, :, 1:4].eq(1).all() and cache.v[1, 0, :, 1:4].eq(2).all()
    assert cache.k[1, 0, :, 0].eq(0).all() and cache.k[0].eq(0).all()
    moved = cache.advance(3)
    assert moved.pos == 4 and moved.k is cache.k and cache.pos == 1
    with pytest.raises(ValueError, match="overflow"):
        moved.update_layer(0, new[:, :1], new[:, :1])
