"""The port's speculative decoding (generation/speculative.py, draft.py)
against mllm_tpu on the same weights: the counterparts of
tests/test_speculative.py. A tiny f32 JAX model (2 layers, 4 query / 2 KV
heads, head_dim 8) is bridged into the port; every decoder runs on the CPU.

Tolerances: tokens and SpecStats exactly (f32 on both sides: the verify
forward and the greedy decode pick the same argmax); the draft structures
(suffix automaton, trace pool, tree bias) exactly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mllm_tpu.core.config import TextConfig as JaxTextConfig
from mllm_tpu.generation import draft as jdraft
from mllm_tpu.generation import speculative as jspec
from mllm_tpu.generation.generate import pad_to_bucket
from mllm_tpu.models.transformer import CausalLM as JaxCausalLM
from mllm_tpu_torch.core.config import TextConfig
from mllm_tpu_torch.generation import draft as tdraft
from mllm_tpu_torch.generation import speculative as tspec
from mllm_tpu_torch.generation.generate import generate
from mllm_tpu_torch.generation.sampling import SamplingConfig
from mllm_tpu_torch.models.bridge import causal_lm_from_jax_params

CPU = torch.device("cpu")
CFG_KW = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512,
              eos_token_id=-3, rope_theta=10000.0)


def _pair(key=3, **cfg_kw):
    jm = JaxCausalLM.init(jax.random.PRNGKey(key), JaxTextConfig(**{**CFG_KW, **cfg_kw}))
    params = {k: np.asarray(v) for k, v in jm.parameters().items()}
    return jm, causal_lm_from_jax_params(params, TextConfig(**{**CFG_KW, **cfg_kw}), CPU)


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _caches(jm, tm, max_len=256):
    return jm.init_cache(1, max_len, jnp.float32), tm.init_cache(1, max_len, torch.float32)


def _stats(s):
    return (s.steps, s.drafted, s.accepted, s.tokens)


def test_suffix_automaton_match_and_draft():
    for mod in (jdraft, tdraft):
        sa = mod.SuffixAutomaton()
        sa.add_tokens([1, 2, 3, 9, 1, 2, 3])
        assert sa.match_len == 3 and sa.lookup(max_draft=4)[:1] == [9]


def test_suffix_automaton_no_match():
    sa = tdraft.SuffixAutomaton()
    sa.add_tokens([1, 2, 3, 4, 5])
    assert sa.lookup(min_match=1) == []


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_draft_structures_equal_jax(seed):
    """The copied draft module against the JAX one on random streams: lookups,
    multi-trace lookups, the flattened tree, its bias and the posterior."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 6, 60).tolist()
    js, ts = jdraft.SuffixAutomaton(), tdraft.SuffixAutomaton()
    for t in toks:
        js.add_token(t)
        ts.add_token(t)
        assert (ts.match_state, ts.match_len) == (js.match_state, js.match_len)
        assert ts.lookup(5, 2) == js.lookup(5, 2)
        assert ts.lookup_multi(4, 1, 3) == js.lookup_multi(4, 1, 3)
    jp, tp = jdraft.TracePool(3), tdraft.TracePool(3)
    for tr in js.lookup_multi(4, 1, 3):
        jp.add_trace(tr)
        tp.add_trace(tr)
    for a, b in zip(tp.build_tree(40), jp.build_tree(40)):
        np.testing.assert_array_equal(a, b)
    anc = tp.build_tree(40)[2]
    np.testing.assert_array_equal(tdraft.TracePool.tree_bias(anc), jdraft.TracePool.tree_bias(anc))
    preds = rng.integers(0, 6, len(anc))
    assert tp.eval_posterior(preds) == jp.eval_posterior(preds)


def test_trace_pool_tree():
    tp = tdraft.TracePool()
    tp.add_trace([5, 6, 7])
    tp.add_trace([5, 8])
    ids, pos, anc = tp.build_tree(base_pos=10)
    np.testing.assert_array_equal(ids, [5, 6, 7, 5, 8])
    np.testing.assert_array_equal(pos, [10, 11, 12, 10, 11])
    np.testing.assert_array_equal(anc, [-1, 0, 1, -1, 3])
    bias = tdraft.TracePool.tree_bias(anc)
    assert bias[2, 0] == 0.0 and bias[2, 1] == 0.0 and bias[2, 3] < -1e20
    assert tp.eval_posterior(np.array([6, 7, 99, 9, 9])) == (0, 2)


def test_lookup_multi():
    sa = tdraft.SuffixAutomaton()
    sa.add_tokens([1, 2, 9, 1, 2, 8, 1, 2])
    firsts = [t[0] for t in sa.lookup_multi(max_draft=3, min_match=1, max_traces=4)]
    assert firsts and len(set(firsts)) == len(firsts)


@pytest.mark.parametrize("window", [None, 4])
def test_tree_bias_equals_jax(window):
    anc = np.array([-1, 0, 1, -1, 3], np.int32)
    pos = np.array([20, 21, 22, 23, 21, 22])
    np.testing.assert_array_equal(tspec._tree_bias_full(anc, 20, 64, positions=pos, window=window),
                                  jspec._tree_bias_full(anc, 20, 64, positions=pos, window=window))


@pytest.mark.parametrize("ids,max_new,max_draft", [
    ([5, 9, 2, 7, 5, 9, 2], 40, 6),  # test_speculative_equals_greedy
    ([1, 2, 3, 1, 2, 3, 1, 2], 24, 8),  # test_speculative_stats
])
def test_speculative_equals_jax_and_greedy(pair, ids, max_new, max_draft):
    jm, tm = pair
    ids = np.array([ids], np.int32)
    jc, tc = _caches(jm, tm)
    jout, _, jst = jspec.speculative_generate(jm, ids, jc, max_new_tokens=max_new, eos_token_id={-9},
                                              max_draft=max_draft)
    tout, _, tst = tspec.speculative_generate(tm, ids, tc, max_new_tokens=max_new, eos_token_id={-9},
                                              max_draft=max_draft)
    assert tout == jout and _stats(tst) == _stats(jst)
    res, _ = generate(tm, ids, tm.init_cache(1, 256, torch.float32), SamplingConfig(max_new_tokens=max_new),
                      eos_token_id={-9})
    assert tout == res.tokens
    assert tst.tokens == len(tout) and 0.0 <= tst.acceptance <= 1.0 and tst.drafted > 0


def test_tree_speculative_equals_jax_and_greedy(pair):
    jm, tm = pair
    ids = np.array([[5, 9, 2, 7, 5, 9, 2, 7, 5, 9]], np.int32)
    jc, tc = _caches(jm, tm)
    jout, _, jst = jspec.speculative_generate_tree(jm, ids, jc, max_new_tokens=30, eos_token_id={-9},
                                                   max_draft=5, max_traces=3)
    tout, _, tst = tspec.speculative_generate_tree(tm, ids, tc, max_new_tokens=30, eos_token_id={-9},
                                                   max_draft=5, max_traces=3)
    assert tout == jout and _stats(tst) == _stats(jst) and tst.drafted > 0
    res, _ = generate(tm, ids, tm.init_cache(1, 256, torch.float32), SamplingConfig(max_new_tokens=30),
                      eos_token_id={-9})
    assert tout == res.tokens


def test_tree_speculative_window_cut_mistral():
    """In place of the gemma2-flavoured JAX test (gemma norms are not ported):
    a mistral config whose sliding window (6 keys, every layer) is shorter
    than the context, so the window-cut bias decides what the tree rows see;
    tokens and stats equal JAX's and the port's greedy decode."""
    jm, tm = _pair(key=7, model_type="mistral", sliding_window=6, num_hidden_layers=3)
    ids = np.array([[5, 9, 2, 7, 5, 9, 2, 7, 5, 9]], np.int32)
    jc, tc = _caches(jm, tm)
    jout, _, jst = jspec.speculative_generate_tree(jm, ids, jc, max_new_tokens=24)
    tout, _, tst = tspec.speculative_generate_tree(tm, ids, tc, max_new_tokens=24)
    assert tout == jout and _stats(tst) == _stats(jst)
    res, _ = generate(tm, ids, tm.init_cache(1, 256, torch.float32), SamplingConfig(max_new_tokens=24))
    assert tout == res.tokens


def _compiled(jm, tm, ids, max_new, eos, **kw):
    padded = pad_to_bucket(ids, 128)
    jc, tc = _caches(jm, tm)
    j = jspec.speculative_generate_compiled(jm, jnp.asarray(padded), jc, ids.shape[1], max_new,
                                            eos_token_id=eos, **kw)
    t = tspec.speculative_generate_compiled(tm, padded, tc, ids.shape[1], max_new, eos_token_id=eos,
                                            window=3, **kw)
    jn, tn = int(j[1]), int(t[1])
    return ((list(np.asarray(j[0])[:jn]), *(int(x) for x in j[1:])),
            (t[0][:tn].tolist(), *(int(x) for x in t[1:])))


def _greedy(tm, ids, max_new, eos):
    res, _ = generate(tm, ids, tm.init_cache(1, 256, torch.float32),
                      SamplingConfig(max_new_tokens=max_new), eos_token_id={eos})
    return res.tokens


def test_compiled_sd_equals_jax_and_accepts(pair):
    jm, tm = pair
    ids = np.array([[5, 9, 2, 7, 5, 9, 2]], np.int32)
    j, t = _compiled(jm, tm, ids, 40, -9, max_draft=6)
    assert t == j
    out, n, steps, drafted, accepted = t
    assert out == _greedy(tm, ids, 40, -9) and n == len(out)
    assert accepted > 0 and drafted > 0 and steps < n


def test_compiled_sd_no_match_prompt(pair):
    jm, tm = pair
    ids = np.array([[11, 3, 29, 8, 17, 2]], np.int32)
    j, t = _compiled(jm, tm, ids, 24, -9, max_draft=4, ngram=2)
    assert t == j and t[0] == _greedy(tm, ids, 24, -9) and 0 <= t[4] <= t[3]


def test_compiled_sd_eos_mid_block(pair):
    jm, tm = pair
    ids = np.array([[1, 2, 3, 1, 2, 3, 1, 2]], np.int32)
    free = _greedy(tm, ids, 30, -9)
    eos = free[min(10, len(free) - 1)]
    ref = _greedy(tm, ids, 30, eos)
    assert ref[-1] == eos and len(ref) < 30
    j, t = _compiled(jm, tm, ids, 30, eos)
    assert t == j and t[0] == ref


def test_compiled_sd_respects_max_new(pair):
    jm, tm = pair
    ids = np.array([[1, 2, 3, 1, 2, 3, 1, 2]], np.int32)
    j, t = _compiled(jm, tm, ids, 7, -9, max_draft=8)
    assert t == j and t[1] == 7 and t[0] == _greedy(tm, ids, 7, -9)


def test_compiled_sd_checks_room(pair):
    """The verify window must fit: JAX's clamped writes would shift it."""
    _, tm = pair
    ids = np.array([[1, 2, 3, 1, 2, 3, 1, 2]], np.int32)
    with pytest.raises(ValueError, match="overflow"):
        tspec.speculative_generate_compiled(tm, pad_to_bucket(ids, 128), tm.init_cache(1, 140, torch.float32),
                                            8, 128, max_draft=8)
