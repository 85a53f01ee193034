"""The port's KV-cache persistence against mllm_tpu's: snapshots written by
either package load in the other with every leaf bit-equal (bf16 through
its f32 widening) for the four cache types, the write head restored on the
cache's device; a resumed decode token-identical to an uninterrupted one
(tests/test_persist.py's tiny model, carried across by the bridge); other
cache types refused on save."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mllm_tpu.core.config import TextConfig as JaxTextConfig
from mllm_tpu.kv import cache as jcache
from mllm_tpu.kv import persist as jpersist
from mllm_tpu.models.transformer import CausalLM as JaxCausalLM
from mllm_tpu_torch.core.config import TextConfig
from mllm_tpu_torch.generation.generate import decode_step, prefill
from mllm_tpu_torch.kv import cache as tcache
from mllm_tpu_torch.kv import persist as tpersist
from mllm_tpu_torch.models.bridge import causal_lm_from_jax_params
from mllm_tpu_torch.nn import attention as port_attention

CPU = torch.device("cpu")
CFG = dict(vocab_size=96, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, max_position_embeddings=128, eos_token_id=-5)


@pytest.fixture(scope="module", autouse=True)
def kernel_route_at_small_head_dim():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_attention, "KERNEL_HEAD_DIMS", (16, 64, 128, 256))
        yield


def _bits(x) -> np.ndarray:
    """The raw bits of a JAX array or tensor (bf16 as uint16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.view(np.uint16).astype(np.int16) if a.dtype.name == "bfloat16" else a


def _filled_jax(kind: str, rng):
    """A JAX cache of `kind` with random contents and a moved head."""
    shape = (2, 3, 2, 128, 16)
    if kind in ("KVCache", "SlotKVCache"):
        k, v = (jnp.asarray(rng.standard_normal(shape), jnp.bfloat16) for _ in range(2))
        if kind == "KVCache":
            return jcache.KVCache(k, v, jnp.asarray(37, jnp.int32))
        return jcache.SlotKVCache(k, v, jnp.asarray([1, 90, 7], jnp.int32))
    packed = kind == "Quant4KVCache"
    kv_shape = shape[:-1] + (shape[-1] // 2,) if packed else shape
    dt = np.uint8 if packed else np.int8
    lo, hi = (0, 256) if packed else (-127, 128)
    k, v = (jnp.asarray(rng.integers(lo, hi, kv_shape).astype(dt)) for _ in range(2))
    ks, vs = (jnp.asarray(rng.uniform(0.01, 0.1, shape[:-1]).astype(np.float32)) for _ in range(2))
    return getattr(jcache, kind)(k, v, ks, vs, jnp.asarray(65, jnp.int32))


@functools.lru_cache(maxsize=None)
def _tiny():
    """tests/test_persist.py's tiny model in JAX and, over the same weights,
    in the port (built once a module)."""
    jm = JaxCausalLM.init(jax.random.PRNGKey(5), JaxTextConfig(**CFG))
    return jm, causal_lm_from_jax_params({k: np.asarray(v) for k, v in jm.parameters().items()},
                                         TextConfig(**CFG), CPU)


KINDS = ("KVCache", "QuantKVCache", "Quant4KVCache", "SlotKVCache")
LEAVES = {"KVCache": ("k", "v", "pos"), "SlotKVCache": ("k", "v", "pos")}


@pytest.mark.parametrize("kind", KINDS)
def test_cross_load_both_ways(kind, tmp_path):
    jc = _filled_jax(kind, np.random.default_rng(0))
    jpersist.save_cache(tmp_path / "j.npz", jc, extra={"tokens": np.arange(5)})
    tc, extras = tpersist.load_cache(tmp_path / "j.npz", extra_keys=("tokens", "absent"), device=CPU)
    assert type(tc).__name__ == kind and list(extras) == ["tokens"]
    np.testing.assert_array_equal(extras["tokens"], np.arange(5))
    names = LEAVES.get(kind, ("k", "v", "k_scale", "v_scale", "pos"))
    for name in names:
        np.testing.assert_array_equal(_bits(getattr(tc, name)), _bits(getattr(jc, name)))
        assert getattr(tc, name).device == CPU
    assert tc.pos.dtype == torch.int32 and tuple(tc.pos.shape) == tuple(jc.pos.shape)
    tpersist.save_cache(tmp_path / "t.npz", tc, extra={"tokens": np.arange(5)})
    jback, jextras = jpersist.load_cache(tmp_path / "t.npz", extra_keys=("tokens",))
    assert type(jback).__name__ == kind
    for name in names:
        np.testing.assert_array_equal(_bits(getattr(jback, name)), _bits(getattr(jc, name)))
        assert getattr(jback, name).dtype == getattr(jc, name).dtype
    a, b = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert sorted(a.files) == sorted(b.files)
    for key in ("__type__", "__names__", "__dtypes__"):
        np.testing.assert_array_equal(a[key], b[key])


def test_refuses_other_caches(tmp_path):
    paged = tcache.PagedKVCache.init(2, 2, 256, 2, 16, device=CPU)
    slot_q = tcache.SlotQuantKVCache.init(2, 2, 128, 2, 16, device=CPU)
    for cache in (paged, slot_q):
        with pytest.raises(TypeError, match="load_cache could not restore"):
            tpersist.save_cache(tmp_path / "x.npz", cache)
    assert not (tmp_path / "x.npz").exists()


def test_load_defaults_to_the_card(tmp_path, monkeypatch):
    """Without `device`, load_cache restores onto the card, and raises where
    there is none rather than quietly restoring onto the CPU."""
    tpersist.save_cache(tmp_path / "c.npz", tcache.KVCache.init(1, 1, 8, 1, 16, dtype=torch.bfloat16, device=CPU))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="found none"):
        tpersist.load_cache(tmp_path / "c.npz")


def test_resume_is_token_identical(tmp_path):
    """Prefill 8 tokens and decode 6 uninterrupted; again with a snapshot
    after 3 tokens (bf16 cache, tokens in `extra`), restored and continued:
    the same tokens. The restored write head is a 0-d int32 tensor on the
    CPU, as the cache keeps it."""
    jm, model = _tiny()
    ids = torch.as_tensor(np.arange(8)[None] % 96)

    def run(n, cache):
        logits, cache = prefill(model, cache, ids, 8)
        toks = [int(logits[0].argmax())]
        for _ in range(n - 1):
            logits, cache = decode_step(model, cache, torch.tensor([toks[-1]]))
            toks.append(int(logits[0].argmax()))
        return toks, cache

    want, _ = run(6, model.init_cache(1, 32, torch.bfloat16))
    first, cache = run(3, model.init_cache(1, 32, torch.bfloat16))
    tpersist.save_cache(tmp_path / "state.npz", cache, extra={"tokens": np.asarray(first)})
    restored, extras = tpersist.load_cache(tmp_path / "state.npz", extra_keys=("tokens",), device=CPU)
    assert isinstance(restored, tcache.KVCache) and restored.k.dtype == torch.bfloat16
    assert restored.pos.dim() == 0 and int(restored.pos) == 10
    toks = [int(t) for t in extras["tokens"]]
    for _ in range(3):
        logits, restored = decode_step(model, restored, torch.tensor([toks[-1]]))
        toks.append(int(logits[0].argmax()))
    assert toks == want


def test_resume_from_a_jax_snapshot(tmp_path):
    """The JAX package prefills and decodes 3 tokens and saves its cache; the
    port loads it and decodes on: the same 6 tokens as the port's
    uninterrupted run and as JAX's."""
    from mllm_tpu.generation.generate import _decode_step, _prefill
    from mllm_tpu.generation.sampling import greedy

    jm, model = _tiny()
    ids = np.arange(8, dtype=np.int32)[None] % 96
    jcache_ = jm.init_cache(1, 32, jnp.bfloat16)
    logits, jcache_ = _prefill(jm, jcache_, jnp.asarray(ids), 8)
    jt = [int(greedy(logits)[0])]
    for _ in range(5):
        logits, jcache_ = _decode_step(jm, jcache_, jnp.asarray([jt[-1]], jnp.int32))
        jt.append(int(greedy(logits)[0]))
        if len(jt) == 3:
            jpersist.save_cache(tmp_path / "j.npz", jcache_, extra={"tokens": np.asarray(jt)})
    restored, extras = tpersist.load_cache(tmp_path / "j.npz", extra_keys=("tokens",), device=CPU)
    toks = [int(t) for t in extras["tokens"]]
    for _ in range(3):
        lg, restored = decode_step(model, restored, torch.tensor([toks[-1]]))
        toks.append(int(lg[0].argmax()))
    assert toks == jt
