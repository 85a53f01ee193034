"""The port's OpenELM against mllm_tpu's on one `.mllm` file: per-layer head
counts and FFN widths, KV heads zero-padded to the widest layer, the tied
head. Logits at b=1 and b=2 (where the live KV heads of a padded layer are a
strided view, copied contiguous for the kernels) within 1e-4 in f32, greedy
tokens equal to the JAX incremental loop, and the bridge."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mllm_tpu.core.param_loader import MllmWriter
from mllm_tpu.core.param_loader import ParamLoader as JaxParamLoader
from mllm_tpu.models import openelm as joe
from mllm_tpu_torch.core.param_loader import ParamLoader
from mllm_tpu_torch.models import openelm as toe
from mllm_tpu_torch.models.bridge import openelm_from_jax_params
from mllm_tpu_torch.nn import attention as port_attention
from mllm_tpu_torch.ops import decode_attention as dmod
from mllm_tpu_torch.ops import flash_attention as fmod

CPU = torch.device("cpu")
CFG = dict(vocab_size=64, model_dim=32, num_layers=3, head_dim=8, num_query_heads=(2, 4, 4),
           num_kv_heads=(1, 1, 2), ffn_dims=(32, 48, 64), max_context=64)


@pytest.fixture(scope="module", autouse=True)
def kernel_route_at_small_head_dim():
    """head_dim 8 reaches the kernels' plain versions here, as 64 does on the card."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_attention, "KERNEL_HEAD_DIMS", (8, 64, 128, 256))
        yield


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    rng = np.random.default_rng(0)
    path = tmp_path_factory.mktemp("oe") / "oe.mllm"
    w = MllmWriter(path)

    def add(name, *shape):
        w.add(name + ".weight", (rng.standard_normal(shape) * 0.3).astype(np.float32))

    jcfg = joe.OpenELMConfig(**CFG)
    add("transformer.token_embeddings", jcfg.vocab_size, jcfg.model_dim)
    add("transformer.norm", jcfg.model_dim)
    for i in range(jcfg.num_layers):
        p = f"transformer.layers.{i}."
        nq, nkv, ffn = jcfg.num_query_heads[i], jcfg.num_kv_heads[i], jcfg.ffn_dims[i]
        add(p + "attn.qkv_proj", (nq + 2 * nkv) * jcfg.head_dim, jcfg.model_dim)
        add(p + "attn.out_proj", jcfg.model_dim, nq * jcfg.head_dim)
        add(p + "attn.q_norm", jcfg.head_dim)
        add(p + "attn.k_norm", jcfg.head_dim)
        add(p + "attn_norm", jcfg.model_dim)
        add(p + "ffn_norm", jcfg.model_dim)
        add(p + "ffn.proj_1", 2 * ffn, jcfg.model_dim)
        add(p + "ffn.proj_2", jcfg.model_dim, ffn)
    w.write()
    jax_model = joe.load_openelm(JaxParamLoader(path), jcfg)
    port = toe.load_openelm(ParamLoader(path), toe.OpenELMConfig(**CFG), device=CPU)
    return jax_model, port


_jax_call = jax.jit(lambda m, ids, c: m(ids, c, last_only=False))


def _jax_run(model, ids, new: int):
    """Prefill then `new` greedy steps (last_only=False), as the JAX demo
    loop decodes: returns (prefill logits, [step logits], tokens)."""
    cache = model.init_cache(ids.shape[0], 32, jnp.float32)
    lg, cache = _jax_call(model, jnp.asarray(ids, jnp.int32), cache)
    first, steps, toks = np.asarray(lg), [], []
    tok = np.asarray(lg)[:, -1].argmax(-1)
    for _ in range(new):
        toks.append(tok)
        lg, cache = _jax_call(model, jnp.asarray(tok[:, None], jnp.int32), cache)
        steps.append(np.asarray(lg))
        tok = np.asarray(lg)[:, -1].argmax(-1)
    return first, steps, np.stack(toks, 1)


def _port_run(model, ids, new: int):
    with torch.no_grad():
        cache = model.init_cache(ids.shape[0], 32, torch.float32)
        lg, cache = model(torch.as_tensor(ids), cache, last_only=False)
        first, steps, toks = lg.numpy(), [], []
        tok = lg[:, -1].argmax(-1)
        for _ in range(new):
            toks.append(tok.numpy())
            lg, cache = model(tok[:, None], cache, last_only=False)
            steps.append(lg.numpy())
            tok = lg[:, -1].argmax(-1)
    return first, steps, np.stack(toks, 1)


@pytest.mark.parametrize("batch", [1, 2])
def test_openelm_vs_jax(models, batch, monkeypatch):
    """Prefill and 5 greedy steps: logits within 1e-4, tokens equal; the
    port's attention runs the flash / decode plain versions (one a layer a
    call) over contiguous live heads."""
    jax_model, port = models
    calls = {"flash": 0, "decode": 0}
    for mod, name, key in ((fmod, "flash_attention_ref", "flash"), (dmod, "decode_attention_ref", "decode")):
        real = getattr(mod, name)

        def counted(q, k, v, *a, _real=real, _key=key, **kw):
            assert k.is_contiguous() and v.is_contiguous()
            calls[_key] += 1
            return _real(q, k, v, *a, **kw)

        monkeypatch.setattr(mod, name, counted)
    ids = (np.arange(1, 9)[None] + 7 * np.arange(batch)[:, None]) % 64
    jf, js, jt = _jax_run(jax_model, ids, 5)
    tf, ts, tt = _port_run(port, ids, 5)
    np.testing.assert_allclose(tf, jf, rtol=1e-4, atol=1e-4)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tt, jt)
    assert calls == {"flash": 3, "decode": 15}


def test_openelm_incremental_equals_full(models):
    _, port = models
    ids = torch.arange(1, 9)[None]
    with torch.no_grad():
        full, _ = port(ids, port.init_cache(1, 32, torch.float32), last_only=False)
        cache = port.init_cache(1, 32, torch.float32)
        lg, cache = port(ids[:, :5], cache, last_only=False)
        outs = [lg[0]]
        for i in range(5, 8):
            lg, cache = port(ids[:, i : i + 1], cache, last_only=False)
            outs.append(lg[0])
    np.testing.assert_allclose(full[0].numpy(), torch.cat(outs).numpy(), rtol=2e-4, atol=2e-5)


def test_openelm_config_and_bridge(models):
    hf = {"num_transformer_layers": 4, "model_dim": 64, "head_dim": 16,
          "num_query_heads": [2, 2, 4, 4], "num_kv_heads": [1, 1, 2, 2],
          "ffn_multipliers": [0.5, 1.0, 1.5, 2.0], "ffn_dim_divisor": 16, "vocab_size": 100}
    assert toe.OpenELMConfig.from_hf(hf).__dict__ == joe.OpenELMConfig.from_hf(hf).__dict__
    assert toe.OpenELMConfig.from_hf(hf).ffn_dims == (32, 64, 96, 128)
    for v in (3.0, 100.0, 257.5, 1e4):
        assert toe._make_divisible(v, 256) == joe._make_divisible(v, 256)
    jax_model, port = models
    bridged = openelm_from_jax_params({k: np.asarray(v) for k, v in jax_model.parameters().items()},
                                      port.cfg, CPU)
    ids = torch.arange(1, 9)[None]
    with torch.no_grad():
        a, _ = bridged(ids, bridged.init_cache(1, 32, torch.float32), last_only=False)
        b, _ = port(ids, port.init_cache(1, 32, torch.float32), last_only=False)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
