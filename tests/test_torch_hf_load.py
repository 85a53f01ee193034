"""HF checkpoint loading: a tiny qwen2 / llama / qwen3 checkpoint written by
transformers on the CPU, loaded by both packages' auto_model, gives the same
logits (f32; 1e-5 relative to the largest |logit|: the same arithmetic in
both packages) and the same greedy tokens."""

import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mllm_tpu.generation.generate import generate as jax_generate
from mllm_tpu.generation.sampling import SamplingConfig as JaxSamplingConfig
from mllm_tpu.models.registry import auto_model as jax_auto_model
from mllm_tpu_torch.generation.generate import generate
from mllm_tpu_torch.generation.sampling import SamplingConfig
from mllm_tpu_torch.models.registry import auto_model

CPU = torch.device("cpu")


def _save_tiny(tmp_path, kind: str, monkeypatch):
    monkeypatch.setenv("USE_TF", "0")  # transformers would otherwise import TensorFlow (~10 s)
    import transformers

    torch.manual_seed(0)
    common = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                  max_position_embeddings=128, rope_theta=10000.0)
    if kind == "qwen2":
        cfg = transformers.Qwen2Config(**common, num_attention_heads=4, num_key_value_heads=2,
                                       tie_word_embeddings=False)
        model = transformers.Qwen2ForCausalLM(cfg)
    elif kind == "llama":
        cfg = transformers.LlamaConfig(**common, num_attention_heads=4, num_key_value_heads=4,
                                       tie_word_embeddings=True, attention_bias=False)
        model = transformers.LlamaForCausalLM(cfg)
    elif kind == "qwen3":
        cfg = transformers.Qwen3Config(**common, num_attention_heads=4, num_key_value_heads=2,
                                       head_dim=16, tie_word_embeddings=False)
        model = transformers.Qwen3ForCausalLM(cfg)
    d = tmp_path / kind
    model.eval().save_pretrained(d)
    return d


@pytest.mark.parametrize("kind", ["qwen2", "llama", "qwen3"])
def test_auto_model_logits_match_jax(tmp_path, kind, monkeypatch):
    d = _save_tiny(tmp_path, kind, monkeypatch)
    jm, _, jcfg = jax_auto_model(str(d), dtype=jnp.float32, with_tokenizer=False)
    tm, tok, cfg = auto_model(str(d), dtype=torch.float32, with_tokenizer=False, device=CPU)
    assert tok is None and dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)

    ids = np.array([[3, 17, 42, 99, 7, 23]], np.int64)
    jl, _ = jax.jit(lambda m, x, c: m(x, c, last_only=False))(
        jm, jnp.asarray(ids, jnp.int32), jm.init_cache(1, 32, jnp.float32))
    tl, _ = tm(torch.from_numpy(ids), tm.init_cache(1, 32, torch.float32), last_only=False)
    jl = np.asarray(jl)
    assert float(np.max(np.abs(tl.numpy() - jl)) / np.max(np.abs(jl))) < 1e-5

    jres, _ = jax_generate(jm, ids, jm.init_cache(1, 32, jnp.float32),
                           JaxSamplingConfig(max_new_tokens=8), bucket=8)
    tres, _ = generate(tm, ids, tm.init_cache(1, 32, torch.float32),
                       SamplingConfig(max_new_tokens=8), bucket=8)
    assert tres.tokens == jres.tokens


def test_unported_parts_raise(tmp_path, monkeypatch):
    d = _save_tiny(tmp_path, "qwen2", monkeypatch)
    (d / "tokenizer.json").write_text("{}")
    with pytest.raises(NotImplementedError, match="tokenizer"):
        auto_model(str(d), dtype=torch.float32, device=CPU)
    with pytest.raises(NotImplementedError, match="item 8"):
        auto_model(str(d), quant="int8-a8", with_tokenizer=False, device=CPU)
    cfg = json.loads((d / "config.json").read_text())
    (d / "config.json").write_text(json.dumps({**cfg, "model_type": "gemma2"}))
    with pytest.raises(NotImplementedError, match="gemma2"):
        auto_model(str(d), with_tokenizer=False, device=CPU)
