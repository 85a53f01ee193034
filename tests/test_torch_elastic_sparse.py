"""The port's elastic and predictor-sparse models against mllm_tpu's on the
same weights (tests/test_elastic_sparse.py's tiny models, carried across by
the bridge): elastic 0.5 over float and int8 weights and the sparse model
with JAX's own predictors, logits within 1e-4 in f32; ratio 1.0 the same
bytes and bit-equal logits; the slices contiguous (the int8 kernel's
layout), the W8A8 layer's [N, K] copy sliced too; the refusals (fused
projections, int4); and `ElasticLinear` / `PredictorSparseMLP` against the
JAX layers."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mllm_tpu.core.config import TextConfig as JaxTextConfig
from mllm_tpu.models import elastic as jel
from mllm_tpu.models.transformer import CausalLM as JaxCausalLM
from mllm_tpu.nn import layers as jlayers
from mllm_tpu.ops.quantize_model import quantize_model as jax_quantize_model
from mllm_tpu_torch.core.config import TextConfig
from mllm_tpu_torch.models import elastic as tel
from mllm_tpu_torch.models.bridge import causal_lm_from_jax_params, predictors_from_jax
from mllm_tpu_torch.nn import attention as port_attention
from mllm_tpu_torch.nn.layers import ElasticLinear, PredictorSparseMLP, QuantLinear, QuantLinearA8
from mllm_tpu_torch.ops.quantize_model import fuse_projections, quantize_model

CPU = torch.device("cpu")
CFG = dict(vocab_size=96, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, max_position_embeddings=128, eos_token_id=-5)
IDS = np.arange(12)[None] % 96


@pytest.fixture(scope="module", autouse=True)
def kernel_route_at_small_head_dim():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_attention, "KERNEL_HEAD_DIMS", (16, 64, 128, 256))
        yield


@functools.lru_cache(maxsize=None)
def _jax_tiny(quant=None):
    """The JAX model and its parameters as numpy (built once a module)."""
    if quant:
        jm = jax_quantize_model(_jax_tiny()[0], quant, min_size=0, quant_embed_head=False)
    else:
        jm = JaxCausalLM.init(jax.random.PRNGKey(7), JaxTextConfig(**CFG))
    return jm, {k: np.asarray(v) for k, v in jm.parameters().items()}


def _tiny(quant=None):
    """(the JAX model, a new port model over the same weights)."""
    jm, params = _jax_tiny(quant)
    return jm, causal_lm_from_jax_params(params, TextConfig(**CFG), CPU)


_jax_call = jax.jit(lambda m, ids, c: m(ids, c, last_only=False))


def _jl(model, ids=IDS):
    return np.asarray(_jax_call(model, jnp.asarray(ids, jnp.int32), model.init_cache(1, 32, dtype=jnp.float32))[0])


def _tl(model, ids=IDS):
    with torch.no_grad():
        return model(torch.as_tensor(ids), model.init_cache(1, 32, torch.float32), last_only=False)[0].numpy()


@pytest.mark.parametrize("quant", [None, "int8"])
def test_elastic_half_vs_jax(quant):
    jm, tm = _tiny(quant)
    jel_m, tel_m = jel.elastic_model(jm, 0.5, 0.5), tel.elastic_model(tm, 0.5, 0.5)
    assert (tel_m.cfg.num_attention_heads, tel_m.cfg.num_key_value_heads) == (2, 1)
    blk = tel_m.blocks[0]
    ffn = 128 if quant else 64  # the int8 lane quantum rounds 64 up to 128
    if quant:
        assert isinstance(blk.mlp.gate_proj, QuantLinear) and blk.mlp.gate_proj.qweight_t.shape == (64, ffn)
        for lin in (blk.attn.q_proj, blk.attn.k_proj, blk.attn.o_proj, blk.mlp.down_proj):
            assert lin.qweight_t.is_contiguous() and lin.scales.is_contiguous()
    else:
        assert blk.mlp.gate_proj.weight.shape == (ffn, 64) and blk.attn.o_proj.weight.is_contiguous()
    np.testing.assert_allclose(_tl(tel_m), _jl(jel_m), rtol=1e-4, atol=1e-4)
    # the source model is left as it was
    np.testing.assert_allclose(_tl(tm), _jl(jm), rtol=1e-4, atol=1e-4)


def test_elastic_ratio_one_is_exact():
    _, tm = _tiny("int8")
    el = tel.elastic_model(tm, 1.0, 1.0)
    for a, b in zip(el.state_dict().values(), tm.state_dict().values()):
        assert a.data_ptr() == b.data_ptr()
    np.testing.assert_array_equal(_tl(el), _tl(tm))


def test_elastic_per_layer_ratios_and_a8(monkeypatch):
    """Per-layer FFN ratios over a W8A8 model: the sliced layers stay
    QuantLinearA8 with their [N, K] copy the sliced weight's, and a
    prefill-shaped call (the A8 route over that copy) agrees with the JAX
    elastic A8 model within 1e-2 of max |logit|, as tests/test_torch_w8a8.py
    holds the A8 path."""
    import mllm_tpu.utils.native as jnative

    monkeypatch.setattr(jnative, "repack_int8", lambda w: None)
    jm, tm = _tiny()
    jq = jax_quantize_model(jm, "int8-a8", min_size=0, quant_embed_head=False)
    quantize_model(tm, "int8-a8", min_size=0, quant_embed_head=False)
    jel_m, el = jel.elastic_model(jq, 0.5, [1.0, 0.5]), tel.elastic_model(tm, 0.5, [1.0, 0.5])
    for blk in el.blocks:
        for lin in (blk.attn.q_proj, blk.mlp.gate_proj, blk.mlp.down_proj, blk.attn.o_proj):
            assert isinstance(lin, QuantLinearA8)
            assert torch.equal(lin.qweight_nk, lin.qweight_t.t())
        assert blk.mlp.gate_proj.qweight_t.shape[1] == 128
    assert el.blocks[0].attn.q_proj.qweight_nk.shape == (32, 64)
    ids = np.random.default_rng(1).integers(0, 96, (1, 24))
    got, want = _tl(el, ids), _jl(jel_m, ids)
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


def test_elastic_refusals():
    _, tm = _tiny()
    quantize_model(tm, "int4", min_size=0, quant_embed_head=False)
    with pytest.raises(TypeError):
        tel.elastic_model(tm, 0.5, 0.5)
    _, tm = _tiny()
    fuse_projections(tm)
    with pytest.raises(ValueError, match="before fuse_projections"):
        tel.elastic_model(tm, 0.5, 0.5)
    with pytest.raises(ValueError, match="before fuse_projections"):
        tel.sparse_model(tm, tel.make_predictors(tm))


@pytest.mark.parametrize("threshold", [0.0, 0.5])
def test_sparse_vs_jax(threshold):
    jm, tm = _tiny()
    jpreds = jel.make_predictors(jax.random.PRNGKey(3), jm, rank=16)
    preds = predictors_from_jax([tuple(np.asarray(a) for a in p) for p in jpreds], CPU)
    js, ts = jel.sparse_model(jm, jpreds, threshold), tel.sparse_model(tm, preds, threshold)
    assert isinstance(ts.blocks[0].mlp, PredictorSparseMLP)
    got = _tl(ts)
    np.testing.assert_allclose(got, _jl(js), rtol=1e-4, atol=1e-4)
    assert not np.allclose(got, _tl(tm), atol=1e-3)  # neurons were masked
    dense = tel.sparse_model(tm, preds, threshold=-np.inf)
    np.testing.assert_allclose(_tl(dense), _tl(tm), rtol=1e-6, atol=1e-6)
    own = tel.make_predictors(tm, rank=16, generator=torch.Generator().manual_seed(1))
    assert [tuple(p.shape) for p in own[0]] == [(16, 64), (128, 16)]


def test_layers_vs_jax():
    rng = np.random.default_rng(0)
    w, b = rng.standard_normal((48, 32)).astype(np.float32), rng.standard_normal(48).astype(np.float32)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    jl, tl = jlayers.ElasticLinear(jnp.asarray(w), jnp.asarray(b)), ElasticLinear(torch.from_numpy(w), torch.from_numpy(b))
    for ro, ri in ((1.0, 1.0), (0.5, 0.75), (0.3, 0.5)):
        np.testing.assert_allclose(tl(torch.from_numpy(x), ro, ri).numpy(),
                                   np.asarray(jl(jnp.asarray(x), ro, ri)), rtol=1e-5, atol=1e-5)
    g, u, dn = (rng.standard_normal(s).astype(np.float32) for s in ((64, 32), (64, 32), (32, 64)))
    pd, pu = rng.standard_normal((8, 32)).astype(np.float32), rng.standard_normal((64, 8)).astype(np.float32)
    jmlp = jlayers.PredictorSparseMLP(jnp.asarray(pd), jnp.asarray(pu), jlayers.Linear(jnp.asarray(g)),
                                      jlayers.Linear(jnp.asarray(u)), jlayers.Linear(jnp.asarray(dn)), "silu", 0.1)
    from mllm_tpu_torch.nn.layers import Linear

    tmlp = PredictorSparseMLP(torch.from_numpy(pd), torch.from_numpy(pu), Linear.from_tensors(torch.from_numpy(g)),
                              Linear.from_tensors(torch.from_numpy(u)), Linear.from_tensors(torch.from_numpy(dn)),
                              "silu", 0.1)
    np.testing.assert_allclose(tmlp.neuron_scores(torch.from_numpy(x)).numpy(),
                               np.asarray(jmlp.neuron_scores(jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tmlp(torch.from_numpy(x)).numpy(), np.asarray(jmlp(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
