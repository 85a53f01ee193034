"""The text families beyond qwen / llama / mistral: tiny checkpoints written by
transformers on the CPU (gemma, gemma2, stablelm, phi3 with fused qkv /
gate_up and LongRope on both branches), and configs transformers has no class
for (phonelm: relu2 and int8 RoPE tables; minicpm: its multipliers), through
both packages' auto_model or bridged from a JAX CausalLM.

Tolerances: port against JAX 1e-5 of the largest |logit| in f32 (the same
arithmetic, summed in other orders); against transformers 3e-3 absolute (the
JAX package's own bound); greedy tokens equal to JAX's."""

import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mllm_tpu.core.config import TextConfig as JaxTextConfig
from mllm_tpu.generation.generate import generate as jax_generate
from mllm_tpu.generation.sampling import SamplingConfig as JaxSamplingConfig
from mllm_tpu.models.registry import auto_model as jax_auto_model
from mllm_tpu.models.transformer import CausalLM as JaxCausalLM
from mllm_tpu_torch.core.config import TextConfig
from mllm_tpu_torch.generation.generate import generate
from mllm_tpu_torch.generation.sampling import SamplingConfig
from mllm_tpu_torch.models.bridge import causal_lm_from_jax_params
from mllm_tpu_torch.models.families import PRESETS
from mllm_tpu_torch.models.registry import auto_model
from mllm_tpu_torch.nn import attention as port_attention
from mllm_tpu_torch.nn.layers import IRotaryEmbedding, LayerNorm, LongRopeEmbedding, RMSNorm

CPU = torch.device("cpu")
_jax_forward = jax.jit(lambda m, ids, c: m(ids, c, last_only=False))


@pytest.fixture(scope="module", autouse=True)
def kernel_route_at_small_head_dim():
    """The tiny models have head_dim 8 and 16, which the port's route sends to
    `sdpa`: here they reach the kernels' plain versions, as on the card."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_attention, "KERNEL_HEAD_DIMS", (8, 16, 64, 128, 256))
        yield


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _save(tmp_path, kind, monkeypatch, width=32):
    monkeypatch.setenv("USE_TF", "0")
    import transformers

    torch.manual_seed(0)
    common = dict(vocab_size=128, hidden_size=width, intermediate_size=2 * width, num_hidden_layers=2,
                  rope_theta=10000.0)
    if kind == "gemma":
        hf = transformers.GemmaForCausalLM(transformers.GemmaConfig(
            **common, num_attention_heads=4, num_key_value_heads=1, head_dim=width // 4,
            max_position_embeddings=64, hidden_act="gelu_pytorch_tanh"))
    elif kind == "gemma2":
        hf = transformers.Gemma2ForCausalLM(transformers.Gemma2Config(
            **{**common, "num_hidden_layers": 4}, num_attention_heads=4, num_key_value_heads=2,
            head_dim=width // 4, max_position_embeddings=128, sliding_window=16, query_pre_attn_scalar=8,
            final_logit_softcapping=30.0, attn_logit_softcapping=50.0))
    elif kind == "stablelm":
        hf = transformers.StableLmForCausalLM(transformers.StableLmConfig(
            **common, num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=64,
            partial_rotary_factor=0.25, use_qkv_bias=True, layer_norm_eps=1e-5,
            tie_word_embeddings=False))
    elif kind == "phi3":
        hf = transformers.Phi3ForCausalLM(transformers.Phi3Config(
            **common, num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
            tie_word_embeddings=False, pad_token_id=0))
    d = tmp_path / kind
    hf.eval().save_pretrained(d)
    return hf.eval(), d


@pytest.mark.parametrize("kind", ["gemma", "gemma2", "stablelm", "phi3"])
def test_hf_family_matches_jax_and_transformers(tmp_path, kind, monkeypatch):
    hf, d = _save(tmp_path, kind, monkeypatch)
    jm, _, jcfg = jax_auto_model(str(d), dtype=jnp.float32, with_tokenizer=False)
    tm, _, cfg = auto_model(str(d), dtype=torch.float32, with_tokenizer=False, device=CPU)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    if kind == "stablelm":  # LayerNorm with bias, partial rope
        assert isinstance(tm.norm, LayerNorm) and tm.norm.bias is not None
    if kind.startswith("gemma"):
        assert isinstance(tm.norm, RMSNorm) and tm.norm.add_unit_offset
    if kind == "gemma2":
        assert tm.blocks[0].pre_ffn_norm is not None and tm.blocks[0].post_ffn_norm is not None

    ids = np.array([[3, 17, 42, 99, 7, 23, 56, 11, 5, 90, 61, 2, 8, 33, 70, 101, 4, 19, 27]], np.int64)
    jl, _ = _jax_forward(jm, jnp.asarray(ids, jnp.int32), jm.init_cache(1, 32, jnp.float32))
    tl, _ = tm(torch.from_numpy(ids), tm.init_cache(1, 32, torch.float32), last_only=False)
    assert _rel(tl, jl) < 1e-5
    with torch.no_grad():
        hl = hf(torch.from_numpy(ids)).logits.numpy()
    np.testing.assert_allclose(tl.numpy(), hl, rtol=3e-3, atol=3e-3)

    jres, _ = jax_generate(jm, ids, jm.init_cache(1, 48, jnp.float32),
                           JaxSamplingConfig(max_new_tokens=8), eos_token_id={-1}, bucket=8)
    tres, _ = generate(tm, ids, tm.init_cache(1, 48, torch.float32), SamplingConfig(max_new_tokens=8),
                       eos_token_id={-1}, bucket=8)
    assert tres.tokens == jres.tokens


@pytest.mark.parametrize("quant", ["int8", "int8-a8", "int4"])
@pytest.mark.parametrize("kind", ["gemma", "gemma2", "stablelm"])
def test_hf_family_quantized_matches_jax(tmp_path, kind, quant, monkeypatch):
    """auto_model(quant=...) on the families' checkpoints at hidden 64 (int4
    groups), against the JAX package on its canonical int4 layout with the
    numpy packers."""
    import mllm_tpu.ops.quantize_model as jqmod
    import mllm_tpu.utils.native as jnative

    monkeypatch.setenv("MLLM_INT4_IMPL", "pallas")
    monkeypatch.setattr(jqmod, "INT4_MIN_PARAMS", 0)
    monkeypatch.setattr(jnative, "repack_int8", lambda w: None)
    monkeypatch.setattr(jnative, "repack_int4", lambda w, group=32: None)
    _, d = _save(tmp_path, kind, monkeypatch, width=64)
    jm, _, _ = jax_auto_model(str(d), dtype=jnp.float32, quant=quant, with_tokenizer=False)
    tm, _, _ = auto_model(str(d), dtype=torch.float32, quant=quant, with_tokenizer=False, device=CPU)
    assert type(tm.blocks[0].attn.q_proj).__name__ == type(jm.blocks.mods[0].attn.q_proj).__name__
    ids = np.array([[5, 17, 42, 99, 7, 23, 64, 3]], np.int64)
    jl, _ = _jax_forward(jm, jnp.asarray(ids, jnp.int32), jm.init_cache(1, 16, jnp.float32))
    tl, _ = tm(torch.from_numpy(ids), tm.init_cache(1, 16, torch.float32), last_only=False)
    assert _rel(tl, jl) < 1e-4


@pytest.mark.parametrize("quant", ["int8", "int8-a8", "int4"])
def test_phi3_fused_split_quantized_matches_jax(tmp_path, quant, monkeypatch):
    """The fused qkv / gate_up rows split at load and quantized from float,
    as the JAX `_maybe_quant_from_float` does (hidden 64: int4 groups; the
    JAX package on its canonical int4 layout with the numpy packers)."""
    import mllm_tpu.utils.native as jnative
    import mllm_tpu.ops.quantize_model as jqmod

    monkeypatch.setenv("USE_TF", "0")
    monkeypatch.setenv("MLLM_INT4_IMPL", "pallas")
    monkeypatch.setattr(jqmod, "INT4_MIN_PARAMS", 0)
    monkeypatch.setattr(jnative, "repack_int8", lambda w: None)
    monkeypatch.setattr(jnative, "repack_int4", lambda w, group=32: None)
    import transformers

    torch.manual_seed(0)
    hf = transformers.Phi3ForCausalLM(transformers.Phi3Config(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64, rope_theta=10000.0,
        tie_word_embeddings=False, pad_token_id=0))
    d = tmp_path / "phi3q"
    hf.eval().save_pretrained(d)
    jm, _, _ = jax_auto_model(str(d), dtype=jnp.float32, quant=quant, with_tokenizer=False)
    tm, _, _ = auto_model(str(d), dtype=torch.float32, quant=quant, with_tokenizer=False, device=CPU)
    ids = np.array([[5, 17, 42, 99, 7, 23]], np.int64)
    jl, _ = _jax_forward(jm, jnp.asarray(ids, jnp.int32), jm.init_cache(1, 16, jnp.float32))
    tl, _ = tm(torch.from_numpy(ids), tm.init_cache(1, 16, torch.float32), last_only=False)
    assert _rel(tl, jl) < 1e-4


@pytest.mark.parametrize("seq,orig", [(4100, 4096), (40, 4096)], ids=["long_branch", "short_branch"])
def test_phi3_longrope_matches_jax_and_transformers(tmp_path, seq, orig, monkeypatch):
    """LongRope on a 128k-class config: the long factors once the sequence
    passes the original window, the short ones below it."""
    monkeypatch.setenv("USE_TF", "0")
    import transformers

    rot_half = 8
    kw = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=131072,
              original_max_position_embeddings=orig, rope_theta=10000.0,
              rope_scaling={"type": "longrope", "long_factor": [1.0 + 0.35 * i for i in range(rot_half)],
                            "short_factor": [1.0 + 0.05 * i for i in range(rot_half)]},
              tie_word_embeddings=False, pad_token_id=0, bos_token_id=1, eos_token_id=2)
    torch.manual_seed(0)
    hf = transformers.Phi3ForCausalLM(transformers.Phi3Config(**kw)).eval()
    d = tmp_path / "phi3lr"
    hf.save_pretrained(d)
    jm, _, _ = jax_auto_model(str(d), dtype=jnp.float32, with_tokenizer=False)
    tm, _, _ = auto_model(str(d), dtype=torch.float32, with_tokenizer=False, device=CPU)
    assert isinstance(tm.rope, LongRopeEmbedding)
    ids = np.random.default_rng(0).integers(0, 128, (1, seq))
    with torch.no_grad():
        ref = hf(torch.from_numpy(ids)).logits[:, -8:].numpy()
    cache_len = -(-seq // 128) * 128 + 128
    jl, _ = _jax_forward(jm, jnp.asarray(ids, jnp.int32), jm.init_cache(1, cache_len, jnp.float32))
    tl, _ = tm(torch.from_numpy(ids), tm.init_cache(1, cache_len, torch.float32), last_only=False)
    assert _rel(tl[:, -8:], np.asarray(jl)[:, -8:]) < 1e-5
    np.testing.assert_allclose(tl[:, -8:].numpy(), ref, rtol=2e-3, atol=2e-3)


def _bridged(cfg_kw):
    jcfg = JaxTextConfig(**cfg_kw)
    jm = JaxCausalLM.init(jax.random.PRNGKey(3), jcfg)
    params = {k: np.asarray(v) for k, v in jm.parameters().items()}
    return jm, causal_lm_from_jax_params(params, TextConfig(**cfg_kw), CPU, torch.float32)


_SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
              rope_theta=10000.0, eos_token_id=-2)


@pytest.mark.parametrize("cfg_kw", [
    dict(model_type="phonelm", hidden_act="relu2", rope_int8=True, attention_bias=False),
    dict(model_type="minicpm", residual_multiplier=1.4 / 2 ** 0.5, embedding_multiplier=12.0,
         logit_divisor=4.0, attention_bias=False),
    dict(model_type="stablelm", norm_type="layernorm", rope_partial=0.25, hidden_act="quick_gelu"),
], ids=["phonelm_relu2_int8_rope", "minicpm", "layernorm_quick_gelu"])
def test_bridged_family_matches_jax(cfg_kw):
    jm, tm = _bridged({**_SMALL, **cfg_kw})
    if cfg_kw.get("rope_int8"):
        assert isinstance(tm.rope, IRotaryEmbedding) and tm.rope.sin.dtype == torch.int8
        np.testing.assert_array_equal(tm.rope.sin.numpy(), np.asarray(jm.rope.sin_q))
    ids = np.random.default_rng(0).integers(0, 128, (2, 11))
    jl, jc = _jax_forward(jm, jnp.asarray(ids, jnp.int32), jm.init_cache(2, 32, jnp.float32))
    tl, tc = tm(torch.from_numpy(ids), tm.init_cache(2, 32, torch.float32), last_only=False)
    assert _rel(tl, jl) < 1e-5
    tok = np.array([3, 77])
    for _ in range(2):
        jl, jc = _jax_forward(jm, jnp.asarray(tok[:, None], jnp.int32), jc)
        tl, tc = tm(torch.from_numpy(tok[:, None]), tc, last_only=False)
        assert _rel(tl, jl) < 1e-5
        tok = np.asarray(jnp.argmax(jl[:, -1], -1))


def test_non_gated_mlp_and_per_head_layernorm_load(tmp_path):
    """A checkpoint without mlp.up_proj gives a non-gated MLP, and q/k norms
    with biases give per-head LayerNorms (JAX `load_causal_lm`)."""
    from safetensors.numpy import save_file

    rng = np.random.default_rng(0)
    V, D, FF, H, HD = 64, 32, 64, 4, 8
    t = {"model.embed_tokens.weight": (V, D), "model.norm.weight": (D,)}
    for i in range(2):
        p = f"model.layers.{i}."
        t.update({p + "self_attn.q_proj.weight": (D, D), p + "self_attn.k_proj.weight": (D, D),
                  p + "self_attn.v_proj.weight": (D, D), p + "self_attn.o_proj.weight": (D, D),
                  p + "self_attn.q_norm.weight": (HD,), p + "self_attn.q_norm.bias": (HD,),
                  p + "self_attn.k_norm.weight": (HD,), p + "self_attn.k_norm.bias": (HD,),
                  p + "mlp.gate_proj.weight": (FF, D), p + "mlp.down_proj.weight": (D, FF),
                  p + "input_layernorm.weight": (D,), p + "post_attention_layernorm.weight": (D,)})
    tensors = {k: (rng.standard_normal(s) * (0.2 if len(s) > 1 else 0.05) + (1.0 if k.endswith("norm.weight") else 0))
               .astype(np.float32) for k, s in t.items()}
    d = tmp_path / "plain"
    d.mkdir()
    save_file(tensors, str(d / "model.safetensors"))
    (d / "config.json").write_text(json.dumps(dict(
        model_type="qwen3", vocab_size=V, hidden_size=D, intermediate_size=FF, num_hidden_layers=2,
        num_attention_heads=H, num_key_value_heads=H, head_dim=HD, hidden_act="relu2",
        max_position_embeddings=64, rope_theta=10000.0, tie_word_embeddings=True)))
    jm, _, _ = jax_auto_model(str(d), dtype=jnp.float32, with_tokenizer=False)
    tm, _, _ = auto_model(str(d), dtype=torch.float32, with_tokenizer=False, device=CPU)
    assert tm.blocks[0].mlp.up_proj is None and isinstance(tm.blocks[0].attn.q_norm, LayerNorm)
    ids = np.array([[1, 5, 9, 33, 60, 2]], np.int64)
    jl, _ = _jax_forward(jm, jnp.asarray(ids, jnp.int32), jm.init_cache(1, 16, jnp.float32))
    tl, _ = tm(torch.from_numpy(ids), tm.init_cache(1, 16, torch.float32), last_only=False)
    assert _rel(tl, jl) < 1e-5


def test_presets_match_jax():
    from mllm_tpu.models.families import PRESETS as JAX_PRESETS

    assert set(PRESETS) == set(JAX_PRESETS)
    for name, cfg in PRESETS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(JAX_PRESETS[name]), name


def test_irope_tables_and_longrope_scale_match_jax():
    from mllm_tpu.nn import layers as jl
    from mllm_tpu_torch.nn import layers as tl

    jr, tr = jl.IRotaryEmbedding.make(32, 128, 10000.0), IRotaryEmbedding.make(32, 128, 10000.0, device=CPU)
    np.testing.assert_array_equal(tr.sin.numpy(), np.asarray(jr.sin_q))
    np.testing.assert_array_equal(tr.cos.numpy(), np.asarray(jr.cos_q))
    x = np.random.default_rng(0).standard_normal((1, 16, 2, 32)).astype(np.float32)
    pos = np.arange(16)[None]
    np.testing.assert_array_equal(tr(torch.from_numpy(x), torch.from_numpy(pos)).numpy(),
                                  np.asarray(jr(jnp.asarray(x), jnp.asarray(pos))))
    rs = {"original_max_position_embeddings": 4096, "long_factor": [1.5] * 8, "short_factor": [1.1] * 8}
    inv = tl.rope_inv_freq(16)
    for which in ("short", "long", "auto"):
        a, fa = tl.longrope_scale(inv, rs, 131072, 10000.0, which)
        b, fb = jl.longrope_scale(inv, rs, 131072, 10000.0, which)
        np.testing.assert_array_equal(a, b)
        assert fa == fb


def test_tree_speculative_gemma2_flavour_equals_jax_and_greedy():
    """Tree SD over post-FFN norms with Gemma's unit offset, softcaps, a
    residual multiplier and sliding windows on every other layer (the JAX
    package's gemma2-flavoured tree test): tokens and stats equal JAX's and
    the port's greedy decode."""
    from mllm_tpu.generation import speculative as jspec
    from mllm_tpu_torch.generation import speculative as tspec

    kw = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=3,
              num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512, eos_token_id=-3,
              rope_theta=10000.0, model_type="gemma2", post_norm=True, sliding_window=16,
              sliding_window_pattern=2, logit_softcap=30.0, attn_logit_softcap=50.0, residual_multiplier=0.9)
    jm = JaxCausalLM.init(jax.random.PRNGKey(7), JaxTextConfig(**kw))
    tm = causal_lm_from_jax_params({k: np.asarray(v) for k, v in jm.parameters().items()},
                                   TextConfig(**kw), CPU)
    ids = np.array([[5, 9, 2, 7, 5, 9, 2, 7, 5, 9]], np.int32)
    jout, _, jst = jspec.speculative_generate_tree(jm, ids, jm.init_cache(1, 256, jnp.float32), max_new_tokens=24)
    tout, _, tst = tspec.speculative_generate_tree(tm, ids, tm.init_cache(1, 256, torch.float32),
                                                   max_new_tokens=24)
    assert tout == jout
    assert (tst.steps, tst.drafted, tst.accepted, tst.tokens) == (jst.steps, jst.drafted, jst.accepted, jst.tokens)
    res, _ = generate(tm, ids, tm.init_cache(1, 256, torch.float32), SamplingConfig(max_new_tokens=24))
    assert tout == res.tokens


@pytest.mark.parametrize("head_dim", [64, 128, 256])
def test_attention_route_by_head_dim(head_dim):
    """head_dim 256 reaches the kernels of every cache, the quantized ones
    included (as the reference runs its Pallas kernels at 256); a bias or
    softcap is `sdpa` always."""
    from mllm_tpu_torch.ops._common import KERNEL_HEAD_DIMS

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_attention, "KERNEL_HEAD_DIMS", KERNEL_HEAD_DIMS)
        route = port_attention.attention_route
        assert route(1, head_dim=head_dim) == "decode" and route(64, head_dim=head_dim) == "flash"
        assert route(1, cache="paged", head_dim=head_dim) == "decode_paged"
        quant = ("decode_quant", "flash_quant")
        assert (route(1, cache="quant", head_dim=head_dim), route(64, cache="quant", head_dim=head_dim)) == quant
        assert route(1, head_dim=head_dim, logit_softcap=50.0) == "sdpa"
        assert route(64, head_dim=96) == "sdpa"  # Phi-3's head_dim: no kernel, as in the reference


def test_minicpm_checkpoint_matches_jax(tmp_path, monkeypatch):
    """A llama checkpoint relabelled minicpm with scale_depth, scale_emb and
    dim_model_base (the multipliers `from_hf_config` reads) through both
    packages' auto_model, in f32 and bf16."""
    monkeypatch.setenv("USE_TF", "0")
    import transformers

    torch.manual_seed(1)
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, max_position_embeddings=64, rope_theta=10000.0, tie_word_embeddings=False))
    d = tmp_path / "minicpm"
    hf.eval().save_pretrained(d)
    cfg = json.loads((d / "config.json").read_text())
    cfg.update(model_type="minicpm", scale_depth=1.4, scale_emb=12.0, dim_model_base=16)
    (d / "config.json").write_text(json.dumps(cfg))
    ids = np.array([[5, 17, 42, 99, 7, 23, 64, 3]], np.int64)
    for jdt, tdt, tol in ((jnp.float32, torch.float32, 1e-5), (jnp.bfloat16, torch.bfloat16, 2e-2)):
        jm, _, jcfg = jax_auto_model(str(d), dtype=jdt, with_tokenizer=False)
        tm, _, tcfg = auto_model(str(d), dtype=tdt, with_tokenizer=False, device=CPU)
        assert tcfg.residual_multiplier == jcfg.residual_multiplier and tcfg.logit_divisor == 4.0
        jl, _ = _jax_forward(jm, jnp.asarray(ids, jnp.int32), jm.init_cache(1, 16, jdt))
        tl, _ = tm(torch.from_numpy(ids), tm.init_cache(1, 16, tdt), last_only=False)
        assert _rel(tl, np.asarray(jl, np.float32)) < tol
