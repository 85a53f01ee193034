"""Fuyu: counterpart of `mllm_tpu/models/fuyu.py`.

The Persimmon LM (the port's `CausalLM` with partial rotary 0.5, per-head
q/k LayerNorms, relu^2, biased LayerNorms and a non-gated MLP) and no vision
tower: raw image patches go through one Linear into the LM's embedding
space and take the `|SPEAKER|` positions (the image placeholder), spliced on
the device by the cumulative count of `llava.splice_rows`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..core.config import TextConfig, from_hf_config
from ..nn.layers import LayerNorm, Linear
from .llava import splice_rows
from .loading import NameMap, load_causal_lm
from .qwen2_vl import load_params, read_config
from .transformer import CausalLM


class PersimmonNameMap(NameMap):
    """Persimmon / Fuyu weight names (`language_model.*`, the interleaved
    fused q/k/v, the dense_h_to_4h MLP)."""

    token_embd = "language_model.model.embed_tokens.weight"
    final_norm = "language_model.model.final_layernorm"
    lm_head = "language_model.lm_head.weight"
    blk = "language_model.model.layers.{i}."
    attn_qkv_interleaved = "self_attn.query_key_value"
    attn_o = "self_attn.dense"
    q_norm = "self_attn.q_layernorm.weight"
    k_norm = "self_attn.k_layernorm.weight"
    gate = "mlp.dense_h_to_4h"
    up = "__none__"
    down = "mlp.dense_4h_to_h"


@dataclass(frozen=True)
class FuyuConfig:
    text: TextConfig = TextConfig()
    patch_size: int = 30
    num_channels: int = 3
    image_token_id: int = 71011  # |SPEAKER|


class FuyuForCausalLM(nn.Module):
    def __init__(self, vision_embed: Linear, lm: CausalLM, cfg: FuyuConfig):
        super().__init__()
        self.vision_embed = vision_embed  # [hidden, C * ps * ps]
        self.lm = lm
        self.cfg = cfg

    @staticmethod
    def init(cfg: FuyuConfig, *, device, dtype=torch.float32, generator=None) -> "FuyuForCausalLM":
        """Random weights from `generator`: the LM as `CausalLM.init` (its
        norms ones / zeros, per-head LayerNorms on q and k, a non-gated MLP),
        the patch Linear U(+-1/sqrt(in))."""
        g = generator or torch.Generator(device=device).manual_seed(0)
        lm = CausalLM.init(cfg.text, device=device, dtype=dtype, generator=g)
        hd = cfg.text.head_dim_
        for blk in lm.blocks:
            blk.mlp.up_proj = None
            blk.attn.q_norm, blk.attn.k_norm = (LayerNorm(hd, cfg.text.rms_norm_eps, device=device, dtype=dtype)
                                                for _ in range(2))
        pin = cfg.num_channels * cfg.patch_size**2
        emb = Linear(pin, cfg.text.hidden_size, True, device=device, dtype=dtype)
        emb.reset_parameters(g)
        return FuyuForCausalLM(emb, lm, cfg)

    def init_cache(self, batch, max_len, dtype=torch.bfloat16, kv_dtype: str = "bf16"):
        return self.lm.init_cache(batch, max_len, dtype, kv_dtype)

    def forward(self, input_ids, cache, image_patches=None, last_only: bool = True):
        """image_patches: [P, C * ps * ps] patch rows (`patchify_image`)."""
        x = self.lm.embed_tokens(input_ids)
        if image_patches is not None:
            emb = self.vision_embed(image_patches.to(self.vision_embed.weight.dtype))
            x = splice_rows(x, input_ids == self.cfg.image_token_id, emb)
        hidden, cache = self.lm.hidden_states(None, cache, inputs_embeds=x)
        if last_only:
            hidden = hidden[:, -1:, :]
        return self.lm.logits(hidden), cache


def fuyu_config_from_hf(path_or_dict) -> FuyuConfig:
    c = read_config(path_or_dict)
    t = dict(c.get("text_config", {}))
    for k in ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
              "num_attention_heads", "num_key_value_heads", "max_position_embeddings",
              "rope_theta", "hidden_act", "partial_rotary_factor", "layer_norm_eps"):
        if k in c and k not in t:
            t[k] = c[k]
    text = from_hf_config(t, model_type=t.get("model_type", "persimmon")).replace(
        norm_type="layernorm",
        rope_partial=float(t.get("partial_rotary_factor", 0.5)),
        attention_bias=True, o_proj_bias=True, mlp_bias=True,
        rms_norm_eps=float(t.get("layer_norm_eps", 1e-5)),
        hidden_act=t.get("hidden_act", "relu2"),
        qk_norm=bool(t.get("qk_layernorm", True)),
    )
    return FuyuConfig(text=text, patch_size=c.get("patch_size", 30), num_channels=c.get("num_channels", 3),
                      image_token_id=c.get("image_token_id", 71011))


def load_fuyu(loader, cfg: FuyuConfig, *, device, dtype=torch.float32, quant=None) -> FuyuForCausalLM:
    """An HF Fuyu checkpoint; `quant` applies to the LM's Linears other than
    the interleaved q/k/v, as in the reference."""
    lm = load_causal_lm(loader, cfg.text, device=device, dtype=dtype, names=PersimmonNameMap(), quant=quant)
    pin = cfg.num_channels * cfg.patch_size**2
    has_bias = "vision_embed_tokens.bias" in loader
    emb = Linear(pin, cfg.text.hidden_size, has_bias, device=device, dtype=dtype)
    load_params(emb, loader, {"weight": "vision_embed_tokens.weight",
                              **({"bias": "vision_embed_tokens.bias"} if has_bias else {})},
                device=device, dtype=dtype)
    return FuyuForCausalLM(emb, lm, cfg)


def patchify_image(img_chw: np.ndarray, patch: int = 30) -> np.ndarray:
    """[C, H, W] -> [nH * nW, C * ps * ps] (the reference's Fuyu patch layout)."""
    c, h, w = img_chw.shape
    nh, nw = h // patch, w // patch
    x = img_chw[:, : nh * patch, : nw * patch].reshape(c, nh, patch, nw, patch)
    return x.transpose(1, 3, 2, 4, 0).reshape(nh * nw, patch * patch * c)
