"""Model configuration: `TextConfig` and `from_hf_config`.

A copy of `mllm_tpu/core/config.py` (that module has no JAX in it, but
importing anything under `mllm_tpu` imports JAX through the package's
`__init__`). Keep the two in step: the parity tests build both packages from
one config.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass(frozen=True)
class TextConfig:
    """Decoder-only LM hyperparameters (superset across supported families)."""

    vocab_size: int = 151936
    hidden_size: int = 1024
    intermediate_size: int = 2816
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    head_dim: int = 0  # 0 -> hidden_size // num_attention_heads
    hidden_act: str = "silu"
    max_position_embeddings: int = 32768
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    rope_style: str = "hf"  # 'hf' (GPT-NeoX half) | 'llama' (interleaved)
    rope_partial: float = 1.0  # partial-rotary factor (phi/stablelm/openelm)
    rope_scaling: Optional[tuple] = None  # frozen dict items, see rope_scaling_dict
    rope_int8: bool = False  # int8 sin/cos tables (reference IRoPE, PhoneLM NPU path)
    tie_word_embeddings: bool = True
    attention_bias: bool = True  # qwen2 uses qkv bias
    o_proj_bias: bool = False
    mlp_bias: bool = False
    qk_norm: bool = False  # qwen3-style per-head q/k RMSNorm
    norm_type: str = "rmsnorm"  # 'rmsnorm' | 'layernorm'
    post_norm: bool = False  # gemma2-style post-block norms
    sliding_window: Optional[int] = None
    sliding_window_pattern: int = 1  # every Nth layer is full-attn (gemma2: 2)
    logit_softcap: Optional[float] = None  # gemma2
    attn_logit_softcap: Optional[float] = None  # gemma2
    embedding_multiplier: float = 1.0  # gemma sqrt(hidden) input scaling
    query_pre_attn_scalar: float = 0.0  # gemma2: attn scale = this**-0.5 (0 -> head_dim)
    bos_token_id: int = 151643
    eos_token_id: int | tuple = 151645
    model_type: str = "qwen2"
    # MoE fields
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_norm_topk_prob: bool = False
    moe_shared_expert_size: int = 0
    # MiniCPM-style scalings (reference models/minicpm)
    residual_multiplier: float = 1.0  # scale_depth / sqrt(num_layers)
    logit_divisor: float = 1.0  # hidden_size / dim_model_base

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    def rope_scaling_dict(self) -> Optional[dict]:
        return dict(self.rope_scaling) if self.rope_scaling else None

    def replace(self, **kw) -> "TextConfig":
        return dataclasses.replace(self, **kw)


def freeze_dict(d: Optional[dict]) -> Optional[tuple]:
    if d is None:
        return None
    return tuple(sorted((k, v if not isinstance(v, dict) else freeze_dict(v)) for k, v in d.items()))


def from_hf_config(path_or_dict, **overrides) -> TextConfig:
    """Build a TextConfig from a HuggingFace config.json (dict or path)."""
    if isinstance(path_or_dict, (str, os.PathLike)):
        p = os.fspath(path_or_dict)
        if os.path.isdir(p):
            p = os.path.join(p, "config.json")
        with open(p) as f:
            cfg = json.load(f)
    else:
        cfg = dict(path_or_dict)

    mt = cfg.get("model_type", "llama")
    kw: dict[str, Any] = dict(model_type=mt)

    def take(dst, src=None, default=None):
        src = src or dst
        if src in cfg and cfg[src] is not None:
            kw[dst] = cfg[src]
        elif default is not None:
            kw[dst] = default

    take("vocab_size")
    take("hidden_size")
    take("intermediate_size")
    take("num_hidden_layers")
    take("num_attention_heads")
    take("num_key_value_heads", default=cfg.get("num_attention_heads"))
    take("head_dim")
    take("hidden_act")
    take("max_position_embeddings")
    take("rms_norm_eps")
    take("rope_theta")
    take("tie_word_embeddings", default=None)
    kw.setdefault("tie_word_embeddings", False)  # HF default; qwen sets it explicitly
    take("sliding_window")
    take("bos_token_id")
    take("eos_token_id")
    if isinstance(kw.get("eos_token_id"), list):
        kw["eos_token_id"] = tuple(kw["eos_token_id"])
    if cfg.get("rope_scaling"):
        rs = dict(cfg["rope_scaling"])
        # HF stores original_max_position_embeddings top-level (phi3 longrope);
        # RotaryEmbedding.make reads it from the scaling dict — carry it across
        if "original_max_position_embeddings" not in rs and cfg.get(
                "original_max_position_embeddings"):
            rs["original_max_position_embeddings"] = cfg["original_max_position_embeddings"]
        kw["rope_scaling"] = freeze_dict(rs)
    # family-specific conventions
    if mt in ("llama", "mistral", "gemma", "gemma2", "smollm", "stablelm", "phi3"):
        kw.setdefault("attention_bias", cfg.get("attention_bias", False))
    if mt in ("qwen2", "qwen2_vl", "qwen2_5_vl"):
        kw["attention_bias"] = True
    if mt == "qwen3":
        kw["attention_bias"] = False
        kw["qk_norm"] = True
    if mt == "stablelm":
        kw["norm_type"] = "layernorm"
        kw["attention_bias"] = bool(cfg.get("use_qkv_bias", False))
        kw["rope_partial"] = float(cfg.get("partial_rotary_factor", cfg.get("rope_pct", 0.25)))
        if cfg.get("layer_norm_eps") is not None:
            kw["rms_norm_eps"] = float(cfg["layer_norm_eps"])
    if mt == "minicpm":
        import math

        sd = float(cfg.get("scale_depth", 1.0))
        kw["residual_multiplier"] = sd / math.sqrt(cfg.get("num_hidden_layers", 1))
        kw["embedding_multiplier"] = float(cfg.get("scale_emb", 1.0))
        kw["logit_divisor"] = float(cfg.get("hidden_size", 1)) / float(cfg.get("dim_model_base", cfg.get("hidden_size", 1)))
    # MoE families
    if mt == "mixtral":
        kw["num_experts"] = cfg.get("num_local_experts", 8)
        kw["num_experts_per_tok"] = cfg.get("num_experts_per_tok", 2)
        kw["moe_norm_topk_prob"] = True
    if mt == "qwen2_moe":
        kw["num_experts"] = cfg.get("num_experts", 60)
        kw["num_experts_per_tok"] = cfg.get("num_experts_per_tok", 4)
        kw["moe_norm_topk_prob"] = bool(cfg.get("norm_topk_prob", False))
        kw["moe_shared_expert_size"] = cfg.get("shared_expert_intermediate_size", 0)
        kw["intermediate_size"] = cfg.get("moe_intermediate_size", kw.get("intermediate_size"))
        kw["attention_bias"] = True
    if mt in ("bailing_moe", "smallthinker"):
        kw["num_experts"] = cfg.get("num_experts", cfg.get("n_routed_experts", 16))
        kw["num_experts_per_tok"] = cfg.get("num_experts_per_tok", 2)
        kw["moe_norm_topk_prob"] = bool(cfg.get("norm_topk_prob", True))
        kw["moe_shared_expert_size"] = cfg.get("shared_expert_intermediate_size", 0)
        kw["intermediate_size"] = cfg.get("moe_intermediate_size", kw.get("intermediate_size"))
    if mt == "minicpm_moe":
        kw["num_experts"] = cfg.get("num_experts", 8)
        kw["num_experts_per_tok"] = cfg.get("num_experts_per_tok", 2)
        kw["moe_norm_topk_prob"] = True
    if mt in ("gemma", "gemma2"):
        kw["embedding_multiplier"] = float(kw.get("hidden_size", 2048)) ** 0.5
        kw["hidden_act"] = (cfg.get("hidden_activation") or cfg.get("hidden_act")
                            or "gelu_pytorch_tanh")
    if mt == "gemma2":
        kw["post_norm"] = True
        kw["sliding_window_pattern"] = 2
        if cfg.get("query_pre_attn_scalar"):
            kw["query_pre_attn_scalar"] = float(cfg["query_pre_attn_scalar"])
        if cfg.get("final_logit_softcapping"):
            kw["logit_softcap"] = float(cfg["final_logit_softcapping"])
        if cfg.get("attn_logit_softcapping"):
            kw["attn_logit_softcap"] = float(cfg["attn_logit_softcapping"])
    kw.update(overrides)
    return TextConfig(**kw)
