"""The port's MBP expert offload against mllm_tpu's: `HostExpertStore` hits
and misses equal to JAX's on the same fetch / prefetch sequence, the LRU
bound, `mbp_moe_forward` on the same weights, and `to_mbp` + `mbp_forward`
of a MoE model (float and int8 experts, a shared expert with its sigmoid
gate) against the JAX MBP model and the port's resident one: 1e-4 (rtol and
atol) in f32. MBP under a CUDA-graph capture raises."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mllm_tpu.core.config import TextConfig as JaxTextConfig
from mllm_tpu.models import moe as jmoe
from mllm_tpu.models.transformer import CausalLM as JaxCausalLM
from mllm_tpu.nn.module import ModuleList
from mllm_tpu.ops.quantize_model import quantize_model as jax_quantize_model
from mllm_tpu.utils import mbp as jmbp
from mllm_tpu_torch.core.config import TextConfig
from mllm_tpu_torch.models import moe as tmoe
from mllm_tpu_torch.models.bridge import causal_lm_from_jax_params
from mllm_tpu_torch.models.transformer import CausalLM as TCausalLM
from mllm_tpu_torch.nn import attention as port_attention
from mllm_tpu_torch.utils import mbp as tmbp

CPU = torch.device("cpu")
CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=64, num_hidden_layers=3, num_attention_heads=4,
           num_key_value_heads=2, max_position_embeddings=256, rope_theta=10000.0, eos_token_id=-2,
           num_experts=8, num_experts_per_tok=2, moe_shared_expert_size=128)
IDS = np.array([[3, 17, 42, 99, 7, 23, 56, 11]])


@pytest.fixture(scope="module", autouse=True)
def kernel_route_at_small_head_dim():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_attention, "KERNEL_HEAD_DIMS", (16, 64, 128, 256))
        yield


def _weights(n_layers=3, n_experts=4, d=8, ff=16, seed=0):
    rng = np.random.default_rng(seed)
    return {(l, e): tuple(rng.standard_normal(s).astype(np.float32) * 0.2 for s in ((ff, d), (ff, d), (d, ff)))
            for l in range(n_layers) for e in range(n_experts)}


def _sequence(store):
    """A fetch / prefetch sequence (tests/test_mbp.py's, then evictions)."""
    out = []
    for op in (("f", 0, 1), ("f", 0, 1), ("p", [(1, 0), (1, 2)]), ("f", 1, 0), ("f", 1, 2), ("f", 0, 3),
               ("f", 2, 0), ("f", 2, 1), ("p", [(2, 2), (2, 3), (0, 1)]), ("f", 2, 2), ("f", 0, 1), ("f", 1, 0)):
        if op[0] == "f":
            store.fetch(op[1], op[2])
        else:
            store.prefetch(op[1])
            store.wait()
        out.append((store.hits, store.misses, sorted(store._cache)))
    return out


@pytest.mark.parametrize("entries", [4, 16])
def test_store_counts_match_jax(entries):
    w = _weights()
    js = jmbp.HostExpertStore(w, device=jax.devices("cpu")[0], max_device_entries=entries)
    ts = tmbp.HostExpertStore(w, device="cpu", max_device_entries=entries)
    assert _sequence(ts) == _sequence(js)
    assert ts.hit_rate == js.hit_rate
    assert ts.fetch(0, 1) is ts.fetch(0, 1)
    assert len(ts._cache) <= entries


def test_mbp_moe_forward_vs_jax():
    w = _weights(n_layers=2)
    rng = np.random.default_rng(1)
    router = rng.standard_normal((4, 8)).astype(np.float32)
    x = rng.standard_normal((5, 8)).astype(np.float32)
    js = jmbp.HostExpertStore(w, device=jax.devices("cpu")[0])
    ts = tmbp.HostExpertStore(w, device="cpu")
    want = jmbp.mbp_moe_forward(jnp.asarray(x), jnp.asarray(router), js, layer=0, n_layers=2, top_k=2,
                                act_fn=jax.nn.silu, norm_topk=True)
    got = tmbp.mbp_moe_forward(torch.from_numpy(x), torch.from_numpy(router), ts, layer=0, n_layers=2, top_k=2,
                               act_fn=torch.nn.functional.silu, norm_topk=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    ts.wait()
    js.wait()
    assert sorted(ts._cache) == sorted(js._cache)  # layer 1's prefetch staged the same experts


@functools.lru_cache(maxsize=None)
def _jax_moe_model(quant=None):
    """The JAX MoE model (built once a module: JAX models are immutable)."""
    if quant:
        return jax_quantize_model(_jax_moe_model(), quant, min_size=0, quant_embed_head=False)
    cfg = JaxTextConfig(**CFG)
    m = JaxCausalLM.init(jax.random.PRNGKey(0), cfg)
    blocks = []
    for i, b in enumerate(m.blocks.mods):
        moe = jmoe.MoEMLP.init(jax.random.fold_in(jax.random.PRNGKey(1), i), cfg, jnp.float32)
        gate = jax.random.normal(jax.random.PRNGKey(9 + i), (1, cfg.hidden_size)) * 0.5
        blocks.append(b.replace(mlp=moe.replace(shared_gate=gate)))
    return m.replace(blocks=ModuleList(blocks))


@pytest.mark.parametrize("quant", [None, "int8"])
def test_to_mbp_vs_jax_and_resident(quant):
    jm = _jax_moe_model(quant)
    tm = causal_lm_from_jax_params({k: np.asarray(v) for k, v in jm.parameters().items()}, TextConfig(**CFG), CPU)
    assert isinstance(tm.blocks[0].mlp, tmoe.QuantMoEMLP if quant else tmoe.MoEMLP)
    ids = torch.as_tensor(IDS)
    with torch.no_grad():
        resident, _ = tm(ids, tm.init_cache(1, 32, torch.float32), last_only=False)
    jmb, jstore = jmoe.to_mbp(jm, max_device_entries=8, device=jax.devices("cpu")[0])
    want, _ = jmoe.mbp_forward(jmb, jnp.asarray(IDS, jnp.int32), jmb.init_cache(1, 32, jnp.float32), last_only=False)
    mb, store = tmoe.to_mbp(tm, max_device_entries=8)
    assert len(store.host) == 3 * 8 and all(isinstance(b.mlp, tmoe.MBPMoEMLP) for b in mb.blocks)
    assert all(t.dtype == torch.float32 for t in store.host[(0, 0)])
    for key in ((0, 0), (2, 7)):
        for a, b in zip(store.host[key], jstore.host[key]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b, np.float32), rtol=1e-6, atol=1e-7)
    with torch.no_grad():
        cache = mb.init_cache(1, 32, torch.float32)
        got, cache = tmoe.mbp_forward(mb, ids, cache, last_only=False)
        store.wait()
        tok = got[:, -1:].argmax(-1)
        step, _ = tmoe.mbp_forward(mb, tok, cache)
        full, _ = tm(torch.cat([ids, tok], 1), tm.init_cache(1, 32, torch.float32), last_only=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), resident.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(step.numpy(), full.numpy(), rtol=1e-4, atol=1e-4)
    assert store.hits > 0  # layer L's routed set prefetched for L + 1
    assert isinstance(tm.blocks[0].mlp, tmoe.MoEMLP)  # the source model keeps its experts


def test_mbp_refuses_capture(monkeypatch):
    jm = _jax_moe_model()
    tm = causal_lm_from_jax_params({k: np.asarray(v) for k, v in jm.parameters().items()}, TextConfig(**CFG), CPU)
    mb, _ = tmoe.to_mbp(tm)
    monkeypatch.setattr(tmoe, "_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="capture"):
        mb(torch.as_tensor(IDS), mb.init_cache(1, 32, torch.float32))
    dense = TCausalLM(TextConfig(**{**CFG, "num_experts": 0}), device=CPU)
    with pytest.raises(ValueError, match="no MoEMLP"):
        tmoe.to_mbp(dense)
