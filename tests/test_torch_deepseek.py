"""The port's DeepSeek-V3 / MiniCPM3 (MLA, the grouped sigmoid router, the
routed and shared experts) against mllm_tpu's on the same checkpoint files,
and against transformers.

Tolerances: logits port vs JAX 1e-4 (rtol and atol) in f32; vs transformers
3e-3, as tests/test_deepseek.py; greedy tokens equal to the JAX `generate`;
the router's indices equal and its weights within 1e-6."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mllm_tpu.core.param_loader import MllmWriter
from mllm_tpu.core.param_loader import ParamLoader as JaxParamLoader
from mllm_tpu.core.param_loader import SafetensorsLoader as JaxSafetensorsLoader
from mllm_tpu.generation.generate import generate as jax_generate
from mllm_tpu.generation.sampling import SamplingConfig as JaxSamplingConfig
from mllm_tpu.models import deepseek as jds
from mllm_tpu_torch.core.param_loader import ParamLoader, SafetensorsLoader
from mllm_tpu_torch.generation.generate import generate, generate_compiled
from mllm_tpu_torch.generation.sampling import SamplingConfig
from mllm_tpu_torch.models import deepseek as tds
from mllm_tpu_torch.models.bridge import deepseek_from_jax_params

CPU = torch.device("cpu")
IDS = np.array([[3, 17, 42, 99, 7, 23, 55, 12]], np.int64)


@pytest.fixture(scope="module")
def tiny_ds(tmp_path_factory):
    """tests/test_deepseek.py's tiny DeepSeek-V3 (q_lora, 8 experts in 2
    groups, a shared expert, layer 0 dense), with a non-zero correction bias
    and weights x3 so that attention and routing are not near-uniform."""
    import transformers

    torch.manual_seed(0)
    cfg = transformers.DeepseekV3Config(
        vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=128,
        rope_theta=10000.0, tie_word_embeddings=False,
        q_lora_rank=16, kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8,
        n_routed_experts=8, num_experts_per_tok=2, n_group=2, topk_group=1,
        norm_topk_prob=True, routed_scaling_factor=1.5, n_shared_experts=1,
        first_k_dense_replace=1, moe_intermediate_size=16, rope_scaling=None, attention_bias=False)
    model = transformers.DeepseekV3ForCausalLM(cfg).eval()
    with torch.no_grad():
        for layer in model.model.layers[cfg.first_k_dense_replace:]:
            layer.mlp.gate.e_score_correction_bias.uniform_(-0.2, 0.2)
    d = tmp_path_factory.mktemp("ds")
    model.save_pretrained(d)
    big = transformers.DeepseekV3ForCausalLM(cfg).eval()
    big.load_state_dict(model.state_dict())
    with torch.no_grad():
        for name, p in big.named_parameters():
            if "norm" not in name and "correction" not in name:
                p.mul_(3.0)
    d3 = tmp_path_factory.mktemp("ds3")
    big.save_pretrained(d3)
    return model, str(d), str(d3)


@functools.lru_cache(maxsize=None)
def _both(d):
    """(JAX model, port model) loaded from the checkpoint at d, once."""
    text, mla, moe = tds.deepseek_config_from_hf(d)
    jt, jm, jmoe = jds.deepseek_config_from_hf(d)
    jax_model = jds.load_deepseek(JaxSafetensorsLoader(d), jt, jm, jmoe, jnp.float32)
    port = tds.load_deepseek(SafetensorsLoader(d), text, mla, moe, device=CPU, dtype=torch.float32)
    return jax_model, port


_jax_call = jax.jit(lambda m, i, c: m(i, c, last_only=False))


def _jax_logits(model, ids):
    lg, _ = _jax_call(model, jnp.asarray(ids, jnp.int32), model.init_cache(ids.shape[0], 32, jnp.float32))
    return np.asarray(lg)


def _port_logits(model, ids):
    with torch.no_grad():
        lg, _ = model(torch.as_tensor(ids), model.init_cache(ids.shape[0], 32, torch.float32), last_only=False)
    return lg.numpy()


@pytest.mark.parametrize("scaled", [False, True])
def test_deepseek_logits_vs_jax_and_transformers(tiny_ds, scaled):
    hf, d, d3 = tiny_ds
    jax_model, port = _both(d3 if scaled else d)
    got = _port_logits(port, IDS)
    np.testing.assert_allclose(got, _jax_logits(jax_model, IDS), rtol=1e-4, atol=1e-4)
    if not scaled:  # the reference's unrotated query departs from transformers at larger weights
        with torch.no_grad():
            ref = hf(torch.from_numpy(IDS)).logits.numpy()
        np.testing.assert_allclose(got, ref, rtol=3e-3, atol=3e-3)


def test_deepseek_cache_and_bridge(tiny_ds):
    _, d, d3 = tiny_ds
    jax_model, port = _both(d3)
    cache = port.init_cache(2, 24, torch.float32)
    assert tuple(cache.k.shape) == (3, 2, 4, 24, 12) and tuple(cache.v.shape) == (3, 2, 4, 24, 8)
    params = {k: np.asarray(v) for k, v in jax_model.parameters().items()}
    text, mla, moe = tds.deepseek_config_from_hf(d3)
    bridged = deepseek_from_jax_params(params, text, mla, moe, CPU)
    assert bridged.blocks[1].mlp.router.weight.dtype == torch.float32
    np.testing.assert_array_equal(_port_logits(bridged, IDS), _port_logits(port, IDS))


def test_deepseek_greedy_vs_jax_generate(tiny_ds):
    _, d, d3 = tiny_ds
    jax_model, port = _both(d3)
    ids = IDS[:, :5]
    res, _ = jax_generate(jax_model, ids.astype(np.int32), jax_model.init_cache(1, 32, jnp.float32),
                          JaxSamplingConfig(max_new_tokens=6), eos_token_id={-1}, bucket=8)
    want = [int(t) for t in res.tokens]
    got, _ = generate(port, ids, port.init_cache(1, 32, torch.float32), SamplingConfig(max_new_tokens=6),
                      eos_token_id={-1}, bucket=8)
    assert got.tokens == want
    toks, n = generate_compiled(port, torch.as_tensor(np.pad(ids, ((0, 0), (0, 3)))), port.init_cache(1, 32, torch.float32),
                                5, 6, window=4)
    assert int(n) == 6 and toks.tolist() == want


def _router_pair(seed, bias_shift):
    rng = np.random.default_rng(seed)
    e, d = 8, 16
    w = rng.standard_normal((e, d)).astype(np.float32)
    b = (rng.uniform(-0.2, 0.2, e) + bias_shift).astype(np.float32)
    args = (2, 4, 2, True, 2.5)  # top_k, n_group, topk_group, norm_topk, routed_scaling
    return (jds.GroupedTopkRouter(jnp.asarray(w), jnp.asarray(b), *args),
            tds.GroupedTopkRouter(torch.from_numpy(w), torch.from_numpy(b), *args),
            rng.standard_normal((64, d)).astype(np.float32))


@pytest.mark.parametrize("bias_shift", [0.0, -2.0], ids=["mixed", "negative_choice"])
def test_grouped_topk_router(bias_shift):
    """Indices equal and weights within 1e-6 of the JAX router; with a bias
    of -2 every choice score is negative, so the masked groups' 0.0 wins the
    top-k (the transformers quirk both keep)."""
    jr, tr, x = _router_pair(3, bias_shift)
    ji, jw = jr(jnp.asarray(x))
    ti, tw = tr(torch.from_numpy(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-6)
    if bias_shift < 0:  # every pick lies in a dropped group (their 0.0 beats the kept negatives)
        choice = 1 / (1 + np.exp(-(x @ tr.weight.numpy().T))) + tr.bias.numpy()
        group = np.sort(choice.reshape(len(x), 4, 2), axis=-1)[..., -2:].sum(-1)
        kept = np.argsort(-group, axis=-1, kind="stable")[:, :2]
        assert not (ti.numpy()[:, :, None] // 2 == kept[:, None, :]).any()


def _write_minicpm3(path, tied: bool):
    rng = np.random.default_rng(0)
    w = MllmWriter(path)

    def add(name, *shape):
        w.add(name, (rng.standard_normal(shape) * 0.2).astype(np.float32))

    d, h = 32, 4
    add("model.embed_tokens.weight", 64, d)
    add("model.norm.weight", d)
    if not tied:
        add("lm_head.weight", 64, d)
    for i in range(2):
        p = f"model.layers.{i}."
        add(p + "self_attn.q_a_proj.weight", 16, d)
        add(p + "self_attn.q_a_layernorm.weight", 16)
        add(p + "self_attn.q_b_proj.weight", h * 12, 16)
        add(p + "self_attn.kv_a_proj_with_mqa.weight", 16 + 4, d)
        add(p + "self_attn.kv_a_layernorm.weight", 16)
        add(p + "self_attn.kv_b_proj.weight", h * 16, 16)
        add(p + "self_attn.o_proj.weight", d, h * 8)
        add(p + "mlp.gate_proj.weight", 64, d)
        add(p + "mlp.up_proj.weight", 64, d)
        add(p + "mlp.down_proj.weight", d, 64)
        add(p + "input_layernorm.weight", d)
        add(p + "post_attention_layernorm.weight", d)
    w.write()


MINICPM3 = dict(model_type="minicpm3", vocab_size=64, hidden_size=32, intermediate_size=64,
                num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
                max_position_embeddings=64, rope_theta=10000.0, tie_word_embeddings=True,
                q_lora_rank=16, kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=4,
                v_head_dim=8, scale_emb=2.0, scale_depth=1.4, dim_model_base=16,
                hidden_act="silu", rms_norm_eps=1e-6)


def test_minicpm3_vs_jax(tmp_path):
    """MiniCPM3 (MLA, a dense MLP, the three scalings) from one `.mllm` file:
    the configs equal, full-sequence logits within 1e-4 of JAX, and the
    incremental decode equal to the full pass."""
    _write_minicpm3(tmp_path / "m3.mllm", tied=True)
    text, mla, moe = tds.minicpm3_config_from_hf(MINICPM3)
    jt, jm, jmoe = jds.minicpm3_config_from_hf(MINICPM3)
    assert (text.residual_multiplier, text.embedding_multiplier, text.logit_divisor) == \
        (jt.residual_multiplier, jt.embedding_multiplier, jt.logit_divisor)
    assert mla == tds.MLAConfig(**jm.__dict__) and moe == jmoe
    jax_model = jds.load_deepseek(JaxParamLoader(tmp_path / "m3.mllm"), jt, jm, jmoe, jnp.float32)
    port = tds.load_deepseek(ParamLoader(tmp_path / "m3.mllm"), text, mla, moe, device=CPU, dtype=torch.float32)
    ids = np.arange(1, 9)[None]
    full = _port_logits(port, ids)
    np.testing.assert_allclose(full, _jax_logits(jax_model, ids), rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        cache = port.init_cache(1, 32, torch.float32)
        lg, cache = port(torch.as_tensor(ids[:, :5]), cache, last_only=False)
        outs = [lg[0]]
        for i in range(5, 8):
            lg, cache = port(torch.as_tensor(ids[:, i : i + 1]), cache, last_only=False)
            outs.append(lg[0])
    np.testing.assert_allclose(full[0], torch.cat(outs).numpy(), rtol=2e-4, atol=2e-5)
