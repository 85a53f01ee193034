"""`-q int4-mixed` (the attention projections int8, every other Linear int4)
against the JAX package on the CPU:

- `auto_model` / `auto_model_any` / `load_causal_lm` with quant="int4-mixed"
  on tiny transformers checkpoints (qwen2: separate projections; phi3: the
  fused q||k||v and gate||up split at load): each projection's type as the
  JAX load's, f32 logits within 1e-4 x max |logit| (the int4 products in
  another summation order), greedy tokens equal;
- the same on tiny MoE checkpoints: mixtral's experts quantize as "int4"
  does (int8 expert stacks), qwen2_moe's experts and shared expert stay
  float, as the JAX package's builders have it;
- a JAX int4-mixed model (`quantize_model(m, "int4", attn_quant="int8")`)
  through the bridge: the port's own `quantize_model(m, "int4",
  attn_quant="int8")` of the same float model gives its state dict byte for
  byte (int8 attention, FusedInt4MLP, the int4 tied head).

The JAX side runs its canonical int4 layout (MLLM_INT4_IMPL=pallas, the
port's only one) with no INT4_MIN_PARAMS int8 fallback and its numpy
packers.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mllm_tpu.ops.quantize_model as jqmod
import mllm_tpu.utils.native as jnative
from mllm_tpu.core.config import TextConfig as JaxTextConfig
from mllm_tpu.generation import generate as jgen
from mllm_tpu.generation.sampling import SamplingConfig as JaxSamplingConfig
from mllm_tpu.models.registry import auto_model as jax_auto_model
from mllm_tpu.models.transformer import CausalLM as JaxCausalLM
from mllm_tpu_torch.core.config import TextConfig
from mllm_tpu_torch.core.param_loader import SafetensorsLoader
from mllm_tpu_torch.generation import generate as tgen
from mllm_tpu_torch.generation.sampling import SamplingConfig
from mllm_tpu_torch.models.bridge import causal_lm_from_jax_params
from mllm_tpu_torch.models.loading import load_causal_lm
from mllm_tpu_torch.models.registry import auto_config, auto_model, auto_model_any
from mllm_tpu_torch.nn.layers import Int4Linear, QuantLinear
from mllm_tpu_torch.ops import quantize_model as tqmod

CPU = torch.device("cpu")
LOGIT_TOL = 1e-4


@pytest.fixture
def jax_pallas_int4(monkeypatch):
    """The JAX package on its canonical int4 layout, numpy packers."""
    monkeypatch.setenv("MLLM_INT4_IMPL", "pallas")
    monkeypatch.setattr(jqmod, "INT4_MIN_PARAMS", 0)
    monkeypatch.setattr(jnative, "repack_int8", lambda w: None)
    monkeypatch.setattr(jnative, "repack_int4", lambda w, group=32: None)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Tiny qwen2 (untied head), phi3 (fused qkv_proj / gate_up_proj),
    mixtral and qwen2_moe (a shared expert) checkpoints, hidden 64: every
    projection's in-width a multiple of 64."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("USE_TF", "0")
        import transformers

        torch.manual_seed(0)
        common = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
                      rope_theta=10000.0, tie_word_embeddings=False)
        out = {}
        moe = dict(common, num_experts_per_tok=2)
        for kind, cfg, cls in (("qwen2", transformers.Qwen2Config(**common), transformers.Qwen2ForCausalLM),
                               ("phi3", transformers.Phi3Config(**common, pad_token_id=0),
                                transformers.Phi3ForCausalLM),
                               ("mixtral", transformers.MixtralConfig(**moe, num_local_experts=4),
                                transformers.MixtralForCausalLM),
                               ("qwen2_moe", transformers.Qwen2MoeConfig(
                                   **moe, num_experts=4, moe_intermediate_size=96,
                                   shared_expert_intermediate_size=128, norm_topk_prob=False,
                                   decoder_sparse_step=1, mlp_only_layers=[]),
                                transformers.Qwen2MoeForCausalLM)):
            d = tmp_path_factory.mktemp(kind)
            cls(cfg).eval().save_pretrained(d)
            out[kind] = str(d)
        return out


def _types(names) -> dict:
    """Projection path -> its type, read from its parameter names (as the
    bridge reads them): qweight_t an int8 QuantLinear, packed_t an int4
    Int4Linear, the weight of a *_proj / lm_head a float Linear."""
    kinds = {"qweight_t": "QuantLinear", "packed_t": "Int4Linear", "weight": "Linear"}
    out = {}
    for name in names:
        path, _, leaf = name.replace("blocks.mods.", "blocks.").rpartition(".")
        if leaf in kinds and (path.endswith("_proj") or path == "lm_head"):
            out[path] = kinds[leaf]
    return out


@pytest.mark.parametrize("kind", ["qwen2", "phi3"])
def test_int4_mixed_load_matches_jax(ckpts, kind, jax_pallas_int4):
    d = ckpts[kind]
    jm, _, _ = jax_auto_model(d, dtype=jnp.float32, quant="int4-mixed", with_tokenizer=False)
    tm, _, _ = auto_model(d, dtype=torch.float32, quant="int4-mixed", with_tokenizer=False, device=CPU)
    assert _types(tm.state_dict()) == _types(jm.parameters())
    assert isinstance(tm.blocks[0].attn.q_proj, QuantLinear) and isinstance(tm.blocks[0].attn.o_proj, QuantLinear)
    assert isinstance(tm.blocks[0].mlp.down_proj, Int4Linear) and isinstance(tm.lm_head, Int4Linear)

    ids = np.array([[3, 17, 42, 99, 7, 23]], np.int64)
    jl, _ = jax.jit(lambda m, x, c: m(x, c, last_only=False))(jm, jnp.asarray(ids, jnp.int32),
                                                              jm.init_cache(1, 32, jnp.float32))
    with torch.no_grad():
        tl, _ = tm(torch.from_numpy(ids), tm.init_cache(1, 32, torch.float32), last_only=False)
    assert _rel(tl, jl) < LOGIT_TOL
    jres, _ = jgen.generate(jm, ids, jm.init_cache(1, 32, jnp.float32), JaxSamplingConfig(max_new_tokens=8), bucket=8)
    tres, _ = tgen.generate(tm, ids, tm.init_cache(1, 32, torch.float32), SamplingConfig(max_new_tokens=8), bucket=8)
    assert tres.tokens == jres.tokens

    # the other ways in load the same bytes
    for other in (auto_model_any(d, torch.float32, "int4-mixed", device=CPU)[0],
                  load_causal_lm(SafetensorsLoader(d), auto_config(d), device=CPU, dtype=torch.float32,
                                 quant="int4-mixed")):
        a, b = other.state_dict(), tm.state_dict()
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("kind", ["mixtral", "qwen2_moe"])
def test_int4_mixed_moe_load_matches_jax(ckpts, kind, jax_pallas_int4):
    d = ckpts[kind]
    jm, _, _ = jax_auto_model(d, dtype=jnp.float32, quant="int4-mixed", with_tokenizer=False)
    tm, _, _ = auto_model(d, dtype=torch.float32, quant="int4-mixed", with_tokenizer=False, device=CPU)
    jb, tb = jm.blocks.mods[0], tm.blocks[0]
    want = "QuantMoEMLP" if kind == "mixtral" else "MoEMLP"
    assert type(tb.mlp).__name__ == type(jb.mlp).__name__ == want
    assert isinstance(tb.attn.q_proj, QuantLinear) and isinstance(tm.lm_head, Int4Linear)
    assert _types(tm.state_dict()) == _types(jm.parameters())
    if kind == "qwen2_moe":
        assert type(tb.mlp.shared_expert.down_proj).__name__ == type(jb.mlp.shared_expert.down_proj).__name__ \
            == "Linear"

    ids = np.array([[3, 17, 42, 99, 7, 23]], np.int64)
    jl, _ = jax.jit(lambda m, x, c: m(x, c, last_only=False))(jm, jnp.asarray(ids, jnp.int32),
                                                              jm.init_cache(1, 32, jnp.float32))
    with torch.no_grad():
        tl, _ = tm(torch.from_numpy(ids), tm.init_cache(1, 32, torch.float32), last_only=False)
    assert _rel(tl, jl) < LOGIT_TOL
    jres, _ = jgen.generate(jm, ids, jm.init_cache(1, 32, jnp.float32), JaxSamplingConfig(max_new_tokens=8), bucket=8)
    tres, _ = tgen.generate(tm, ids, tm.init_cache(1, 32, torch.float32), SamplingConfig(max_new_tokens=8), bucket=8)
    assert tres.tokens == jres.tokens


CFG_KW = dict(vocab_size=128, hidden_size=64, intermediate_size=256, num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, head_dim=64, max_position_embeddings=256, rope_theta=10000.0,
              eos_token_id=127)


@pytest.mark.parametrize("fuse", [False, True], ids=["split", "fused"])
def test_bridged_jax_int4_mixed_equals_port_quantization(fuse, jax_pallas_int4):
    jm = JaxCausalLM.init(jax.random.PRNGKey(0), JaxTextConfig(**CFG_KW))
    if fuse:
        jm = jqmod.fuse_projections(jm)
    jq = jqmod.quantize_model(jm, "int4", min_size=1, attn_quant="int8")
    params = lambda m: {k: np.asarray(v) for k, v in m.parameters().items()}  # noqa: E731
    want = causal_lm_from_jax_params(params(jq), TextConfig(**CFG_KW), CPU)
    tm = causal_lm_from_jax_params(params(jm), TextConfig(**CFG_KW), CPU)
    got = tqmod.quantize_model(tm, "int4", min_size=1, attn_quant="int8")
    attn = got.blocks[0].attn
    assert all(isinstance(p, QuantLinear) for p in ([attn.qkv_proj] if fuse else [attn.q_proj, attn.k_proj])
               + [attn.o_proj])
    assert isinstance(got.blocks[0].mlp, tqmod.FusedInt4MLP) and isinstance(got.embed_tokens, tqmod.Int4EmbedHead)
    a, b = got.state_dict(), want.state_dict()
    assert a.keys() == b.keys()
    for k in b:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
