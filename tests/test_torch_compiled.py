"""The port's on-device loops (generation/generate.py `generate_compiled`,
generation/graphs.py, the engine's static window) and the device write head
of the dense caches (kv/cache.py) against mllm_tpu, on the CPU: the same step
code that the card captures as a CUDA graph runs eagerly here, a window at a
time. A tiny JAX model (2 layers, 4 heads) is bridged into the port.

Tolerances: tokens, `n`, cache storage and heads exactly (f32 models; the
storage tests write the same K/V through both packages' caches); the
megakernel step with a device head against the same step with a host int,
bit for bit (the plain version reads the same values).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mllm_tpu.core.config import TextConfig as JaxTextConfig
from mllm_tpu.generation import engine as jeng
from mllm_tpu.generation import generate as jgen
from mllm_tpu.generation.sampling import SamplingConfig as JaxSamplingConfig
from mllm_tpu.kv import cache as jcache
from mllm_tpu.models.transformer import CausalLM as JaxCausalLM
from mllm_tpu_torch.core.config import TextConfig
from mllm_tpu_torch.generation import generate as tgen
from mllm_tpu_torch.generation import graphs
from mllm_tpu_torch.generation.engine import ContinuousEngine, collect
from mllm_tpu_torch.generation.sampling import SamplingConfig
from mllm_tpu_torch.kv import cache as tcache
from mllm_tpu_torch.models.bridge import causal_lm_from_jax_params
from mllm_tpu_torch.models.megadecode import MegaDecodeLM
from mllm_tpu_torch.models.transformer import CausalLM
from mllm_tpu_torch.nn import attention as port_attention
from mllm_tpu_torch.ops import decode_step as tds

CPU = torch.device("cpu")
CFG_KW = dict(vocab_size=97, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
              eos_token_id=96, rope_theta=10000.0)  # the JAX test_generate model, with GQA


@pytest.fixture(scope="module", autouse=True)
def kernel_route_at_small_head_dim():
    """This file's models have head_dim 8, which the port's route sends
    to `sdpa` (the kernels take 64 and 128): here it reaches the kernels'
    plain versions, so the loops drive the wrappers as they do on the card."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_attention, "KERNEL_HEAD_DIMS", (8, 64, 128))
        yield


@pytest.fixture(scope="module")
def pair():
    jm = JaxCausalLM.init(jax.random.PRNGKey(7), JaxTextConfig(**CFG_KW))
    params = {k: np.asarray(v) for k, v in jm.parameters().items()}
    return jm, causal_lm_from_jax_params(params, TextConfig(**CFG_KW), CPU)


def _jax_compiled(jm, ids, n_new, eos, kv):
    padded = jnp.asarray(tgen.pad_to_bucket(ids, 8))
    cache = jm.init_cache(1, 64, jnp.float32) if kv == "bf16" else jm.init_cache(1, 64, kv_dtype=kv)
    toks, n = jgen.generate_compiled(jm, padded, cache, ids.shape[1], n_new,
                                     JaxSamplingConfig(max_new_tokens=n_new), eos_token_id=eos)
    return np.asarray(toks).tolist(), int(n)


def _compiled(tm, ids, n_new, eos, kv, window=3):
    cache = tm.init_cache(1, 64, torch.float32, kv_dtype=kv)
    toks, n = tgen.generate_compiled(tm, tgen.pad_to_bucket(ids, 8), cache, ids.shape[1], n_new,
                                     SamplingConfig(max_new_tokens=n_new), eos_token_id=eos, window=window)
    return toks.tolist(), int(n)


@pytest.mark.parametrize("kv", ["bf16", "int8", "int4"])
def test_generate_compiled_equals_jax_with_eos_mid_sequence(pair, kv):
    """Tokens (padded with -1) and n equal JAX's generate_compiled, with an
    eos that fires mid-sequence and one that never does (the counterpart of
    tests/test_generate.py's compiled loop). The quantized caches' JAX side
    runs its CPU path (XLA attention over the dequantized cache)."""
    jm, tm = pair
    ids = np.array([[5, 9, 2, 7]], np.int32)
    free, n_free = _jax_compiled(jm, ids, 12, -1, kv)
    assert n_free == 12
    eos = free[5]
    for e in (eos, -1):
        want = _jax_compiled(jm, ids, 12, e, kv)
        assert _compiled(tm, ids, 12, e, kv) == want
    assert _compiled(tm, ids, 12, eos, kv)[1] == free.index(eos) + 1 < 12


@pytest.mark.parametrize("kv,window", [("bf16", 1), ("bf16", 4), ("int8", 5), ("int4", 32)])
def test_generate_compiled_equals_eager_generate(pair, kv, window):
    """The compiled loop against the port's own eager `generate`: any window,
    greedy and sampled (the same generator draws in the same order)."""
    _, tm = pair
    ids = np.array([[3, 1, 4, 1, 5, 9, 2, 6]], np.int32)
    for scfg, seed in ((SamplingConfig(max_new_tokens=10), 0),
                       (SamplingConfig(max_new_tokens=10, do_sample=True, top_k=20, top_p=0.9), 5)):
        res, _ = tgen.generate(tm, ids, tm.init_cache(1, 64, torch.float32, kv_dtype=kv), scfg,
                               eos_token_id=-1, seed=seed, bucket=8)
        toks, n = tgen.generate_compiled(tm, tgen.pad_to_bucket(ids, 8),
                                         tm.init_cache(1, 64, torch.float32, kv_dtype=kv), 8, 10, scfg,
                                         seed=seed, window=window)
        assert int(n) == 10 and toks.tolist() == res.tokens


def test_generate_compiled_checks_room(pair):
    _, tm = pair
    with pytest.raises(ValueError, match="overflow"):
        tgen.generate_compiled(tm, np.zeros((1, 8), np.int64), tm.init_cache(1, 16, torch.float32), 8, 10)


def test_step_graph_runs_eagerly_on_the_cpu():
    """On the CPU a StepGraph is its function, run every call; the launch
    counters pass through device_launches unchanged."""
    calls = []
    g = graphs.StepGraph(lambda: calls.append(1), CPU, warmup=lambda: calls.append(0))
    assert [g(), g()] == ["eager", "eager"] and calls == [1, 1]
    graphs.reset_counts()
    assert g.replays == 0 and graphs.device_launches({"flash_attention": 3}) == {"flash_attention": 3}


def test_capture_runs_no_garbage_collection(monkeypatch):
    """The cyclic collector is off while a graph is captured, where freeing a
    dead engine's CUDA graph invalidates the capture, and is on again after
    (the card's calls stubbed)."""
    import contextlib
    import gc

    during = []

    class FakeGraph:
        def register_generator_state(self, gen):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda graph, stream=None: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda mode: None)
    monkeypatch.setattr(graphs, "capture_stream", lambda device: None)
    g = graphs.StepGraph(lambda: during.append(gc.isenabled()), "cuda")
    was_on = gc.isenabled()
    g._capture()
    assert during == [False] and gc.isenabled() == was_on
    g2 = graphs.StepGraph(lambda: 1 / 0, "cuda")  # a capture that raises turns it on again too
    with pytest.raises(ZeroDivisionError):
        g2._capture()
    assert gc.isenabled() == was_on


@pytest.mark.parametrize("kind", ["dense", "int8", "int4"])
def test_cache_storage_and_head_equal_jax(kind):
    """A prefill-shaped append at the head, then steps of one row each with
    advance, through both packages' caches with the same K/V: storage and
    head bit-equal (the port's head is an int32 0-d tensor, JAX's a traced
    scalar)."""
    rng = np.random.default_rng(3)
    geo = (2, 1, 128, 2, 16)
    if kind == "dense":
        jc, tc = jcache.KVCache.init(*geo, jnp.float32), tcache.KVCache.init(*geo, device=CPU,
                                                                             dtype=torch.float32)
    else:
        jcls = jcache.QuantKVCache if kind == "int8" else jcache.Quant4KVCache
        tcls = tcache.QuantKVCache if kind == "int8" else tcache.Quant4KVCache
        jc, tc = jcls.init(*geo), tcls.init(*geo, device=CPU)
    upd = jax.jit(lambda c, k, v: c.update_layer(0, k, v).update_layer(1, v, k))
    for s in (11, 1, 1, 1):
        k, v = (rng.standard_normal((1, s, 2, 16)).astype(np.float32) for _ in range(2))
        jc = upd(jc, jnp.asarray(k), jnp.asarray(v)).advance(s)
        tc = tc.update_layer(0, torch.from_numpy(k), torch.from_numpy(v))
        tc = tc.update_layer(1, torch.from_numpy(v), torch.from_numpy(k)).advance(s)
        assert tc.pos.dtype == torch.int32 and tc.pos.dim() == 0 and int(tc.pos) == int(jc.pos)
    for t, j in zip(tcache.storage(tc), [jc.k, jc.v] + ([jc.k_scale, jc.v_scale] if kind != "dense" else [])):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("kind", ["dense", "int8", "int4"])
@pytest.mark.parametrize("draft_start,n_accept", [(20, 3), (20, 1), (7, 6)])
def test_rollback_accept_equals_jax(kind, draft_start, n_accept):
    """rollback_accept moves the accepted rows (and their scales) to the head
    and sets it, bit-equal to JAX, with the accepted indices out of order
    and padding entries after n_accept."""
    rng = np.random.default_rng(draft_start + n_accept)
    geo = (2, 1, 128, 2, 16)
    k, v = (rng.standard_normal((2, 1, 40, 2, 16)).astype(np.float32) for _ in range(2))
    if kind == "dense":
        jc, tc = jcache.KVCache.init(*geo, jnp.float32), tcache.KVCache.init(*geo, device=CPU,
                                                                             dtype=torch.float32)
    else:
        jcls = jcache.QuantKVCache if kind == "int8" else jcache.Quant4KVCache
        tcls = tcache.QuantKVCache if kind == "int8" else tcache.Quant4KVCache
        jc, tc = jcls.init(*geo), tcls.init(*geo, device=CPU)
    for layer in range(2):
        jc = jax.jit(lambda c, a, b, layer=layer: c.update_layer(layer, a, b))(
            jc, jnp.asarray(k[layer]), jnp.asarray(v[layer]))
        tc = tc.update_layer(layer, torch.from_numpy(k[layer]), torch.from_numpy(v[layer]))
    accept = np.array([0, 4, 2, 6, 5, 1, 3, 0], np.int32)  # rows after draft_start; padding after n_accept
    jc = jc.rollback_accept(draft_start, jnp.asarray(accept), n_accept)
    tc = tc.rollback_accept(draft_start, accept, n_accept)
    assert int(tc.pos) == int(jc.pos) == draft_start + n_accept
    for t, j in zip(tcache.storage(tc), [jc.k, jc.v] + ([jc.k_scale, jc.v_scale] if kind != "dense" else [])):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


MEGA_KW = dict(vocab_size=512, hidden_size=512, intermediate_size=512, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, head_dim=128, max_position_embeddings=256,
               attention_bias=True, tie_word_embeddings=True, model_type="qwen2", eos_token_id=-2)


@pytest.fixture(scope="module")
def mega():
    model = CausalLM.init(TextConfig(**MEGA_KW), device=CPU, dtype=torch.bfloat16)
    return MegaDecodeLM.from_float(model)


@pytest.mark.parametrize("pos", [0, 9, 200])
def test_megakernel_device_head_equals_host_int(mega, pos):
    """fused_decode_step with pos a device scalar (the cache's head) against
    pos a host int, and MegaDecodeLM's step over a KVCache at that head
    against the same step from the host int: bit for bit."""
    rng = np.random.default_rng(pos)
    k, v = (torch.from_numpy(rng.standard_normal((2, 1, 2, 256, 128)).astype(np.float32)).bfloat16()
            for _ in range(2))
    ops = (mega.qkv_ops.astuple(), mega.o_ops.astuple()[:2], mega.gate_ops.astuple()[:2],
           mega.up_ops.astuple()[:2], mega.down_ops.astuple()[:2], mega.norm1_w, mega.norm2_w)
    kw = dict(n_heads=4, n_kv_heads=2, head_dim=128, block_f=mega.block_f, group_a=mega.group_a)
    x = torch.from_numpy(rng.standard_normal((1, 512)).astype(np.float32))
    rope = mega.base.rope
    rot = tds.rope_rotation_matrix(rope.sin[pos], rope.cos[pos])
    host = tds.fused_decode_step(x, pos, rot, *ops, k, v, **kw)
    dev = tds.fused_decode_step(x, torch.tensor(pos, dtype=torch.int32), rot, *ops, k, v, **kw)
    for a, b in zip(host, dev):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    tok = torch.tensor([[17]])
    lg, c2 = mega(tok, tcache.KVCache(k.clone(), v.clone(), pos))
    emb = mega.base.embed_tokens(tok)[0]
    y, k_new, _ = tds.fused_decode_step(emb, pos, rot, *ops, k, v, **kw)
    torch.testing.assert_close(lg, mega.base.logits(mega.base.norm(y[:, None].to(emb.dtype))), rtol=0, atol=0)
    torch.testing.assert_close(c2.k[:, 0, :, pos], k_new.to(torch.bfloat16), rtol=0, atol=0)
    assert int(c2.pos) == pos + 1


def test_generate_compiled_on_megakernel_equals_eager(mega):
    ids = np.random.default_rng(4).integers(0, 512, (1, 6))
    res, _ = tgen.generate(mega, ids, mega.init_cache(1, 256), SamplingConfig(max_new_tokens=7), bucket=16)
    toks, n = tgen.generate_compiled(mega, tgen.pad_to_bucket(ids, 16), mega.init_cache(1, 256), 6, 7,
                                     SamplingConfig(max_new_tokens=7), window=4)
    assert int(n) == 7 and toks.tolist() == res.tokens


@pytest.mark.parametrize("paged", [0, 16])
def test_engine_window_on_static_buffers_equals_jax(pair, paged):
    """The engine's window over buffers at fixed addresses: the scheduler
    state, the slot heads, the block table and the token buffer keep their
    storage through admissions into other slots, retirements (table edits)
    and windows, as a replayed graph needs; greedy tokens equal the JAX
    engine's."""
    jm, tm = pair
    prompts = [np.arange(5) % 97, (np.arange(9) * 3) % 97, (np.arange(20) + 7) % 97, (np.arange(3) + 40) % 97]
    kw = dict(slots=2, max_len=256 if paged else 64, prompt_bucket=16, start_thread=False, decode_window=4,
              **({"paged": paged} if paged else {}))
    eng = ContinuousEngine(tm, kv_dtype=torch.float32, **kw)
    st, c = eng._state, eng.cache
    fixed = [st.cur, st.active, st.budget, st.temperature, st.top_k, st.top_p, c.pos, eng._out,
             *([c.table] if paged else [])]
    ptrs = [t.data_ptr() for t in fixed]
    qs = [eng.submit(p, 6) for p in prompts]
    for _ in range(30):
        eng.step()
    got = [collect(q, timeout=5) for q in qs]
    assert [t.data_ptr() for t in fixed] == ptrs
    assert eng.cache.pos is c.pos and (not paged or eng.cache.table is c.table)
    jeng_ = jeng.ContinuousEngine(jm, kv_dtype=jnp.float32, **kw)
    jqs = [jeng_.submit(p.astype(np.int32), 6) for p in prompts]
    for _ in range(30):
        jeng_.step()
    assert got == [jeng.collect(q, timeout=5) for q in jqs]


def test_cache_memos_are_not_shared_with_a_capture(monkeypatch):
    """The append rows and attention lengths a cache memoizes per head value
    are made anew inside a CUDA-graph capture: a graph must record their
    computation, not read a tensor made before it (a window whose warm-up
    leaves the head as it was would otherwise replay the warm-up's lengths).
    Outside a capture they are made once per head value."""
    c = tcache.KVCache.init(1, 1, 16, 1, 4, device=CPU, dtype=torch.float32).with_pos(3)
    eager = tcache.valid_len(c, 1)
    assert tcache.valid_len(c, 1) is eager
    monkeypatch.setattr(tcache, "_capturing", lambda: True)
    captured = tcache.valid_len(c, 1)
    assert captured is not eager and int(captured) == int(eager) == 4
    c.pos.fill_(7)  # an in-place edit of the head: made anew
    monkeypatch.setattr(tcache, "_capturing", lambda: False)
    assert int(tcache.valid_len(c, 1)) == 8
