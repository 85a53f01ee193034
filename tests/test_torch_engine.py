"""The port's continuous-batching engine (generation/engine.py) on the CPU:
the counterparts of tests/test_engine.py, greedy token equality with the JAX
`ContinuousEngine` on the same weights (bridged), the per-slot sampler's
keep-set against JAX's, and `MegaDecodeLM` over a `SlotKVCache` against the
JAX `MegaDecodeLM` (Pallas interpret mode).

Tolerances: greedy tokens exactly (f32 model and caches; the quantized
caches against the port's own single stream, which runs the same plain
kernels, and against the JAX engine with its quantized attention routed
through the Pallas kernels in interpret mode, whose arithmetic the port's
plain versions follow: tests/test_torch_kvcache.py); keep-sets exactly;
the megakernel over per-slot positions within rtol = atol = 0.05 of the JAX
one, the tolerance of tests/test_torch_megadecode.py (the Pallas bf16 group
sum of x, ROADMAP Queue 3), with equal greedy tokens.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mllm_tpu.models.transformer as jax_transformer
from mllm_tpu.core.config import TextConfig as JaxTextConfig
from mllm_tpu.generation import engine as jeng
from mllm_tpu.generation.sampling import sample_tokens_batched as jax_sample_tokens_batched
from mllm_tpu.kv import cache as jcache
from mllm_tpu.models.megadecode import MegaDecodeLM as JaxMegaDecodeLM
from mllm_tpu.models.transformer import CausalLM as JaxCausalLM
from mllm_tpu_torch.core.config import TextConfig
from mllm_tpu_torch.generation import engine as teng
from mllm_tpu_torch.generation.engine import ContinuousEngine, collect
from mllm_tpu_torch.generation.generate import generate
from mllm_tpu_torch.generation.sampling import (SamplingConfig, batched_keep_mask, greedy,
                                                sample_tokens_batched)
from mllm_tpu_torch.kv.cache import KVCache, PagedKVCache, QuantKVCache, SlotKVCache, SlotQuantKVCache
from mllm_tpu_torch.models.bridge import causal_lm_from_jax_params
from mllm_tpu_torch.models.megadecode import MegaDecodeLM
from mllm_tpu_torch.nn import attention as port_attention

from test_torch_kvcache import _kernel_arithmetic_attend

CPU = torch.device("cpu")
CFG_KW = dict(vocab_size=97, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
              eos_token_id=-9)  # never sampled: fixed-length outputs


@pytest.fixture(scope="module", autouse=True)
def kernel_route_at_small_head_dim():
    """This file's models have head_dim 16, which the port's route sends
    to `sdpa` (the kernels take 64 and 128): here it reaches the kernels'
    plain versions, so the loops drive the wrappers as they do on the card.
    So does the f32 of its models (the kernels take bf16 only)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_attention, "KERNEL_HEAD_DIMS", (16, 64, 128))
        mp.setattr(port_attention, "KERNEL_DTYPES", (torch.bfloat16, torch.float32))
        yield


@pytest.fixture(scope="module")
def pair():
    """(JAX CausalLM, the port's CausalLM on the same f32 weights)."""
    jm = JaxCausalLM.init(jax.random.PRNGKey(3), JaxTextConfig(**CFG_KW))
    params = {k: np.asarray(v) for k, v in jm.parameters().items()}
    return jm, causal_lm_from_jax_params(params, TextConfig(**CFG_KW), CPU)


def _engine(tm, **kw):
    kw = {"slots": 2, "max_len": 64, "prompt_bucket": 16, "kv_dtype": torch.float32,
          "start_thread": False, **kw}
    return ContinuousEngine(tm, **kw)


def _jax_engine(jm, **kw):
    kw = {"slots": 2, "max_len": 64, "prompt_bucket": 16, "kv_dtype": jnp.float32,
          "start_thread": False, **kw}
    return jeng.ContinuousEngine(jm, **kw)


def _single_stream(tm, ids, n, kv="bf16"):
    cache = tm.init_cache(1, 64, torch.float32, kv_dtype=kv)
    res, _ = generate(tm, ids[None, :], cache, SamplingConfig(max_new_tokens=n), bucket=16)
    return res.tokens


def _serve(eng, prompts, budgets, steps, coll=collect):
    qs = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
    for _ in range(steps):
        eng.step()
    return [coll(q, timeout=5) for q in qs]


PROMPTS = [np.arange(5) % 97, (np.arange(9) * 3) % 97, (np.arange(3) + 40) % 97,
           (np.arange(7) + 11) % 97]


def test_interleaved_admission_matches_single_stream_and_jax(pair):
    jm, tm = pair
    want = [_single_stream(tm, p, 6) for p in PROMPTS[:3]]

    def run(eng, coll):
        q0, q1 = eng.submit(PROMPTS[0], 6), eng.submit(PROMPTS[1], 6)
        eng.step()  # admits both, first window
        eng.step()
        q2 = eng.submit(PROMPTS[2], 6)  # joins while 0 and 1 are mid-flight
        for _ in range(12):
            eng.step()
        return [coll(q, timeout=5) for q in (q0, q1, q2)]

    assert run(_engine(tm, slots=4), collect) == want
    assert run(_jax_engine(jm, slots=4), jeng.collect) == want


def test_slot_reuse(pair):
    _, tm = pair
    prompts = [(np.arange(4) + i) % 97 for i in range(4)]  # 4 requests through 2 slots
    got = _serve(_engine(tm), prompts, [4] * 4, 30)
    assert got == [_single_stream(tm, p, 4) for p in prompts]


def test_loop_thread(pair):
    _, tm = pair
    eng = _engine(tm, start_thread=True)
    try:
        out = collect(eng.submit(np.arange(6) % 97, 5), timeout=60)
    finally:
        eng.stop()
    assert out == _single_stream(tm, np.arange(6) % 97, 5)
    assert eng._thread is None


def test_sampled_top_k1_matches_greedy(pair):
    """top_k = 1 reduces to argmax, next to a greedy slot with temperature 0."""
    _, tm = pair
    eng = _engine(tm, decode_window=4)
    p = np.arange(5) % 97
    q0 = eng.submit(p, 6, SamplingConfig(max_new_tokens=6, do_sample=True, top_k=1, temperature=0.8))
    q1 = eng.submit(p, 6)
    for _ in range(8):
        eng.step()
    want = _single_stream(tm, p, 6)
    assert collect(q0, timeout=5) == want and collect(q1, timeout=5) == want


def test_capacity_guard(pair):
    _, tm = pair
    eng = _engine(tm, max_len=32)
    with pytest.raises(ValueError):
        eng.submit(np.zeros(40, np.int64), 4)
    # a 30-token prompt: max_tokens clamped to 2
    assert len(_serve(eng, [np.arange(30) % 97], [64], 12)[0]) == 2


def test_pipelined_matches_single_stream(pair):
    """pipeline=True stays token-exact, slot reuse across the in-flight window included."""
    _, tm = pair
    eng = _engine(tm, decode_window=4, pipeline=True)
    assert _serve(eng, PROMPTS, [6] * 4, 24) == [_single_stream(tm, p, 6) for p in PROMPTS]


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_quant_kv_matches_single_stream(pair, kv):
    _, tm = pair
    eng = _engine(tm, kv_dtype=kv)
    assert isinstance(eng.cache, SlotQuantKVCache) and eng.cache.bits == (8 if kv == "int8" else 4)
    got = _serve(eng, PROMPTS[:2] + [(np.arange(20) + 7) % 97], [6] * 3, 14)  # the last: two buckets
    assert got == [_single_stream(tm, p, 6, kv) for p in PROMPTS[:2] + [(np.arange(20) + 7) % 97]]


@pytest.fixture
def jax_kernel_arithmetic(monkeypatch):
    jax.clear_caches()  # programs traced before the patch would keep the CPU path
    monkeypatch.setattr(jax_transformer, "attend_from_cache",
                        functools.partial(_kernel_arithmetic_attend, jax_transformer.attend_from_cache))
    yield
    jax.clear_caches()


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_quant_kv_engine_matches_jax(pair, jax_kernel_arithmetic, kv):
    jm, tm = pair
    prompts = PROMPTS[:3]
    got = _serve(_engine(tm, kv_dtype=kv), prompts, [5] * 3, 12)
    want = _serve(_jax_engine(jm, kv_dtype=kv), prompts, [5] * 3, 12, jeng.collect)
    assert got == want


def test_paged_exactness_and_jax(pair):
    """Paged serving is token-exact vs the single stream and the JAX paged
    engine, with slot reuse through the block allocator."""
    jm, tm = pair
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, 97, rng.integers(2, 30)) for _ in range(6)]
    budgets = [int(rng.integers(2, 8)) for _ in range(6)]
    eng = _engine(tm, paged=64, decode_window=4)
    assert isinstance(eng.cache, PagedKVCache)
    got = _serve(eng, prompts, budgets, 80)
    assert got == [_single_stream(tm, p, b) for p, b in zip(prompts, budgets)]
    jgot = _serve(_jax_engine(jm, paged=64, decode_window=4), [p.astype(np.int32) for p in prompts],
                  budgets, 80, jeng.collect)
    assert got == jgot


def test_paged_pool_exhaustion_requeues(pair):
    """A pool of 2 blocks holds two one-block requests for three slots:
    admission requeues while a slot is free, and everything completes."""
    _, tm = pair
    rng = np.random.default_rng(19)
    prompts = [rng.integers(0, 97, 5) for _ in range(4)]
    eng = _engine(tm, slots=3, max_len=2 * PagedKVCache.BS, paged=2, decode_window=4)
    qs = [eng.submit(p, 4) for p in prompts]
    for _ in range(120):
        eng.step()
        if all(r is None for r in eng.req) and eng.pending.empty() and eng._inflight is None:
            break
    assert [collect(q, timeout=5) for q in qs] == [_single_stream(tm, p, 4) for p in prompts]
    assert eng.requeued > 0


def test_randomized_load(pair):
    """12 greedy requests with random lengths (some over one bucket) and
    budgets, submitted at random times over 3 slots, pipelined."""
    _, tm = pair
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, 97, rng.integers(2, 30)) for _ in range(12)]
    budgets = [int(rng.integers(1, 10)) for _ in range(12)]
    eng = _engine(tm, slots=3, decode_window=4, pipeline=True)
    qs, nxt = [], 0
    for _ in range(200):
        if nxt < len(prompts) and rng.random() < 0.5:
            qs.append(eng.submit(prompts[nxt], budgets[nxt]))
            nxt += 1
        eng.step()
        if nxt == len(prompts) and all(r is None for r in eng.req) and eng._inflight is None \
                and eng.pending.empty():
            break
    assert [collect(q, timeout=5) for q in qs] == [_single_stream(tm, p, b) for p, b in zip(prompts, budgets)]


def test_unported_options_raise(pair):
    _, tm = pair
    assert _engine(tm, prefix_cache=4)._pcache is not None  # ported: no longer raises
    with pytest.raises(NotImplementedError, match="paged pool"):  # mesh= is ported, but not over a paged pool
        _engine(tm, mesh=object(), paged=8)
    with pytest.raises(ValueError, match="no vision tower"):  # ported: a text model takes no images
        _engine(tm).submit_vl(None)


@pytest.mark.parametrize("kind", ["dense", "int8"])
def test_pad_small_seq_matches_jax(kind):
    rng = np.random.default_rng(21)
    k, v = (rng.standard_normal((1, 2, 5, 2, 16)).astype(np.float32) for _ in range(2))
    if kind == "dense":
        jc = jcache.KVCache.init(1, 2, 16, 2, 16, jnp.float32).update_layer(0, jnp.asarray(k[0]), jnp.asarray(v[0]))
        tc = KVCache.init(1, 2, 16, 2, 16, device=CPU, dtype=torch.float32).update_layer(
            0, torch.from_numpy(k[0]), torch.from_numpy(v[0]))
    else:
        jc = jax.jit(lambda c, a, b: c.update_layer(0, a, b))(jcache.QuantKVCache.init(1, 2, 16, 2, 16),
                                                            jnp.asarray(k[0]), jnp.asarray(v[0]))
        tc = QuantKVCache.init(1, 2, 16, 2, 16, device=CPU).update_layer(
            0, torch.from_numpy(k[0]), torch.from_numpy(v[0]))
    jp, tp = jeng._pad_small_seq(jc.with_pos(5), 256), teng._pad_small_seq(tc.with_pos(5), 256)
    names = ("k", "v") if kind == "dense" else ("k", "v", "k_scale", "v_scale")
    for n in names:
        np.testing.assert_array_equal(getattr(tp, n).numpy(), np.asarray(getattr(jp, n)))
    assert tp.pos == int(jp.pos) == 5


# ---------------------------------------------------------------------------
# the per-slot sampler
# ---------------------------------------------------------------------------

# per row: (temperature, top_k, top_p)
SLOT_PARAMS = [(0.8, 4, 0.0), (1.0, 0, 0.7), (0.9, 6, 0.6), (1.3, 0, 0.0), (0.0, 5, 0.5)]


def test_keep_mask_matches_jax():
    """The tokens JAX's sample_tokens_batched draws over 20000 keys form the
    port's keep-set row by row (a greedy row: its argmax), and the port's
    draws stay inside it. Kept tokens have probability >= ~1 %."""
    logits = np.random.default_rng(5).standard_normal((len(SLOT_PARAMS), 16)).astype(np.float32)
    t, k, p = (np.array(c) for c in zip(*SLOT_PARAMS))
    args = (jnp.asarray(t, jnp.float32), jnp.asarray(k, jnp.int32), jnp.asarray(p, jnp.float32))
    keys = jax.random.split(jax.random.PRNGKey(0), 20000)
    jdraws = np.asarray(jax.jit(jax.vmap(
        lambda kk: jax_sample_tokens_batched(kk, jnp.asarray(logits), *args)))(keys))
    targs = (torch.tensor(t, dtype=torch.float32), torch.tensor(k), torch.tensor(p, dtype=torch.float32))
    mask = batched_keep_mask(torch.from_numpy(logits), *targs).numpy()
    gen = torch.Generator().manual_seed(0)
    tdraws = np.stack([sample_tokens_batched(torch.from_numpy(logits), *targs, gen).numpy()
                       for _ in range(2000)])
    for row, (temp, _, _) in enumerate(SLOT_PARAMS):
        keep = {int(np.argmax(logits[row]))} if temp <= 0 else set(np.flatnonzero(mask[row]).tolist())
        assert set(jdraws[:, row].tolist()) == keep
        assert set(tdraws[:, row].tolist()) == keep


def test_all_greedy_shortcut():
    logits = torch.from_numpy(np.random.default_rng(6).standard_normal((3, 16)).astype(np.float32))
    zeros = torch.zeros(3)
    gen = torch.Generator().manual_seed(0)
    full = sample_tokens_batched(logits, zeros, zeros.int(), zeros, gen)
    assert torch.equal(full, greedy(logits))
    assert torch.equal(sample_tokens_batched(logits, zeros + 1, zeros.int(), zeros, gen, all_greedy=True),
                       greedy(logits))


# ---------------------------------------------------------------------------
# MegaDecodeLM over a SlotKVCache
# ---------------------------------------------------------------------------

MEGA_KW = dict(vocab_size=512, hidden_size=512, intermediate_size=512, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, head_dim=128,
               max_position_embeddings=256, attention_bias=True, tie_word_embeddings=True,
               model_type="qwen2")  # the CFG of tests/test_decode_step.py


@pytest.fixture(scope="module")
def megas():
    jm = JaxCausalLM.init(jax.random.PRNGKey(0), JaxTextConfig(**MEGA_KW))
    params = {k: np.asarray(v) for k, v in jm.parameters().items()}
    return (JaxMegaDecodeLM.from_float(jm.stack(), interpret=True),
            MegaDecodeLM.from_float(causal_lm_from_jax_params(params, TextConfig(**MEGA_KW), CPU)))


def test_mega_over_slot_cache_matches_jax(megas):
    """Two batched megakernel steps with the slots at unequal positions: the
    logits, the new K/V rows at each slot's own head, and the heads."""
    jmega, tmega = megas
    rng = np.random.default_rng(22)
    s, b = 256, 3
    kc, vc = (rng.standard_normal((2, b, 2, s, 128)).astype(np.float32) for _ in range(2))
    pos = np.array([5, 40, 17], np.int32)
    jc = jcache.SlotKVCache(jnp.asarray(kc, jnp.bfloat16), jnp.asarray(vc, jnp.bfloat16), jnp.asarray(pos))
    tc = SlotKVCache(torch.from_numpy(kc).bfloat16(), torch.from_numpy(vc).bfloat16(), torch.from_numpy(pos))
    tok = rng.integers(0, 512, (b, 1))
    for step in range(2):
        jl, jc = jmega(jnp.asarray(tok), jc, last_only=True)
        tl, tc = tmega(torch.from_numpy(tok), tc)
        np.testing.assert_allclose(tl[:, 0].float().numpy(), np.asarray(jl[:, 0], np.float32),
                                   rtol=0.05, atol=0.05)
        assert tl[:, 0].argmax(-1).tolist() == np.argmax(np.asarray(jl[:, 0]), -1).tolist()
        for i, p in enumerate(pos + step):
            for new, jnew in ((tc.k, jc.k), (tc.v, jc.v)):
                np.testing.assert_allclose(new[:, i, :, p].float().numpy(),
                                           np.asarray(jnew[:, i, :, p], np.float32), rtol=0.05, atol=0.05)
        np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
        tok = np.argmax(np.asarray(jl[:, 0]), -1)[:, None]


def test_mega_slot_cache_clamps_past_the_cache(megas):
    """An idle slot whose head passed the cache writes its last row, as
    `_slot_append` does, and the live slots are unaffected."""
    _, tmega = megas
    rng = np.random.default_rng(23)
    kc, vc = (torch.from_numpy(rng.standard_normal((2, 2, 2, 32, 128)).astype(np.float32)).bfloat16()
              for _ in range(2))
    tok = torch.tensor([[7], [9]])
    far = SlotKVCache(kc.clone(), vc.clone(), torch.tensor([10, 45], dtype=torch.int32))
    last = SlotKVCache(kc.clone(), vc.clone(), torch.tensor([10, 31], dtype=torch.int32))
    lf, far = tmega(tok, far)
    ll, last = tmega(tok, last)
    torch.testing.assert_close(lf, ll, rtol=0, atol=0)
    torch.testing.assert_close(far.k, last.k, rtol=0, atol=0)
    assert far.pos.tolist() == [11, 46]


def test_engine_on_mega_matches_its_single_stream(megas):
    """The engine over MegaDecodeLM (admission through the int4 base, decode
    windows on the batched megakernel at per-slot positions) gives the
    tokens of `generate` on the same model."""
    _, tmega = megas
    rng = np.random.default_rng(24)
    prompts = [rng.integers(0, 512, n) for n in (5, 11, 3)]
    eng = ContinuousEngine(tmega, slots=2, max_len=64, prompt_bucket=16, start_thread=False,
                           decode_window=2, eos_token_id=-2)
    assert isinstance(eng.cache, SlotKVCache) and eng.cache.k.dtype == torch.bfloat16
    got = _serve(eng, prompts, [3] * 3, 10)
    want = [generate(tmega, p[None], tmega.init_cache(1, 64), SamplingConfig(max_new_tokens=3),
                     eos_token_id=-2, bucket=16)[0].tokens for p in prompts]
    assert got == want


# -- the prefix cache (counterparts of tests/test_engine.py:174-226) -----------


def _two_phase(eng, p_a, p_b, coll=collect):
    """Request a, ten scheduler steps, then request b (which finds a's prefix)."""
    qa = eng.submit(p_a, 6)
    for _ in range(10):
        eng.step()
    qb = eng.submit(p_b, 6)
    for _ in range(10):
        eng.step()
    return coll(qa, timeout=5), coll(qb, timeout=5)


def test_engine_prefix_cache_exact_and_jax(pair):
    """Two requests sharing a 20-token prefix (over one 16-token bucket): the
    second admission reuses the bucket-aligned 16 rows, its tokens equal the
    single stream's and the JAX engine's, and the counters are exact."""
    jm, tm = pair
    rng = np.random.default_rng(6)
    system = rng.integers(0, 97, 20)
    p_a = np.concatenate([system, rng.integers(0, 97, 4)])
    p_b = np.concatenate([system, rng.integers(0, 97, 5)])
    eng = _engine(tm, prefix_cache=4)
    got = _two_phase(eng, p_a, p_b)
    assert got == (_single_stream(tm, p_a, 6), _single_stream(tm, p_b, 6))
    assert (eng.prefix_hits, eng.prefix_tokens_reused) == (1, 16)
    jeng_ = _jax_engine(jm, prefix_cache=4)
    assert _two_phase(jeng_, p_a.astype(np.int32), p_b.astype(np.int32), jeng.collect) == got
    assert (jeng_.prefix_hits, jeng_.prefix_tokens_reused) == (1, 16)


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_engine_prefix_cache_quant_kv_and_jax(pair, jax_kernel_arithmetic, kv):
    """Prefix reuse over the quantized slot cache (the quantized small caches
    are cut, grown and installed again): tokens equal the engine without the
    prefix cache and the JAX engine with it (its quantized attention through
    the Pallas kernels' arithmetic), hits and reused rows exact."""
    jm, tm = pair
    rng = np.random.default_rng(8)
    system = rng.integers(0, 97, 18)
    p_a = np.concatenate([system, rng.integers(0, 97, 3)])
    p_b = np.concatenate([system, rng.integers(0, 97, 6)])
    plain = _two_phase(_engine(tm, kv_dtype=kv), p_a, p_b)
    eng = _engine(tm, kv_dtype=kv, prefix_cache=4)
    got = _two_phase(eng, p_a, p_b)
    assert got == plain
    assert (eng.prefix_hits, eng.prefix_tokens_reused) == (1, 16)
    jeng_ = _jax_engine(jm, kv_dtype=kv, prefix_cache=4)
    assert _two_phase(jeng_, p_a.astype(np.int32), p_b.astype(np.int32), jeng.collect) == got
    assert (jeng_.prefix_hits, jeng_.prefix_tokens_reused) == (eng.prefix_hits, eng.prefix_tokens_reused)


def test_engine_prefix_cache_randomized_load(pair):
    """12 greedy requests, every third sharing a 20-token prefix, random
    lengths and budgets, submitted at random times over 3 slots with the
    prefix cache on: every stream equals its single-stream run, and the
    hits and reused rows equal the JAX engine's on the same schedule."""
    jm, tm = pair
    rng = np.random.default_rng(13)
    shared = rng.integers(0, 97, 20)
    prompts, budgets = [], []
    for i in range(12):
        if i % 3 == 0:
            p = np.concatenate([shared, rng.integers(0, 97, rng.integers(1, 6))])
        else:
            p = rng.integers(0, 97, rng.integers(2, 30))
        prompts.append(p)
        budgets.append(int(rng.integers(2, 8)))
    arrivals = np.random.default_rng(14).random(400) < 0.5

    def run(eng, coll, cast):
        qs, nxt = [], 0
        for step in range(400):
            if nxt < len(prompts) and arrivals[step]:
                qs.append(eng.submit(cast(prompts[nxt]), budgets[nxt]))
                nxt += 1
            eng.step()
            if nxt == len(prompts) and all(r is None for r in eng.req) and eng.pending.empty():
                break
        return [coll(q, timeout=5) for q in qs]

    eng = _engine(tm, slots=3, prefix_cache=4)
    got = run(eng, collect, lambda p: p)
    assert got == [_single_stream(tm, p, b) for p, b in zip(prompts, budgets)]
    assert eng.prefix_hits > 0
    jeng_ = _jax_engine(jm, slots=3, prefix_cache=4)
    assert run(jeng_, jeng.collect, lambda p: p.astype(np.int32)) == got
    assert (jeng_.prefix_hits, jeng_.prefix_tokens_reused) == (eng.prefix_hits, eng.prefix_tokens_reused)
