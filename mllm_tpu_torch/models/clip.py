"""CLIP image-text scoring: counterpart of `mllm_tpu/models/clip.py`.

Text tower: a causal transformer (the vision blocks with a causal bias)
with learned positions and EOT pooling. Vision tower: `ViTEncoder` with CLS
pooling. Loads HF CLIP checkpoints (openai/clip-vit-base-*).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..nn.layers import LayerNorm, Linear, _param, causal_mask_bias
from .qwen2_vl import load_params, read_config
from .vit import VisionConfig, VisionEmbeddings, ViTEncoder, vision_blocks


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 512
    intermediate_size: int = 2048
    num_hidden_layers: int = 12
    num_attention_heads: int = 8
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 49407


@dataclass(frozen=True)
class CLIPConfig:
    text: CLIPTextConfig = CLIPTextConfig()
    vision: VisionConfig = VisionConfig()
    projection_dim: int = 512


class CLIPTextEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.token_embedding = _param(cfg.vocab_size, cfg.hidden_size, **kw)
        self.position_embedding = _param(cfg.max_position_embeddings, cfg.hidden_size, **kw)
        self.blocks = vision_blocks(cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size,
                                    cfg.num_attention_heads, cfg.hidden_act, cfg.layer_norm_eps, **kw)
        self.final_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **kw)
        self.cfg = cfg

    def forward(self, input_ids):
        b, s = input_ids.shape
        x = self.token_embedding[input_ids] + self.position_embedding[None, :s]
        mask = causal_mask_bias(s, s, 0, device=x.device)  # the blocks are bidirectional
        for blk in self.blocks:
            x = blk(x, bias=mask)
        x = self.final_ln(x)
        # EOT pooling: the feature at the first eos (HF: argmax(ids == eos))
        eot = torch.argmax((input_ids == self.cfg.eos_token_id).to(torch.int32), dim=1)
        return x[torch.arange(b, device=x.device), eot]


class CLIPModel(nn.Module):
    """Full CLIP: encode_text / encode_image / similarity logits."""

    def __init__(self, cfg: CLIPConfig, *, device, dtype):
        super().__init__()
        tc, vc = cfg.text, cfg.vision
        kw = dict(device=device, dtype=dtype)
        self.text_model = CLIPTextEncoder(tc, **kw)
        self.vision_model = ViTEncoder(
            VisionEmbeddings(vc, **kw), LayerNorm(vc.hidden_size, vc.layer_norm_eps, **kw),
            vision_blocks(vc.num_hidden_layers, vc.hidden_size, vc.intermediate_size, vc.num_attention_heads,
                          vc.hidden_act, vc.layer_norm_eps, **kw),
            LayerNorm(vc.hidden_size, vc.layer_norm_eps, **kw), vc)
        self.text_projection = Linear(tc.hidden_size, cfg.projection_dim, False, **kw)
        self.visual_projection = Linear(vc.hidden_size, cfg.projection_dim, False, **kw)
        self.logit_scale = nn.Parameter(torch.zeros((), device=device, dtype=torch.float32), requires_grad=False)
        self.cfg = cfg

    @staticmethod
    def init(cfg: CLIPConfig = CLIPConfig(), *, device, dtype=torch.float32,
             generator: Optional[torch.Generator] = None) -> "CLIPModel":
        """Random weights with the JAX `CLIPModel.init` distributions:
        embeddings N(0, 0.02^2), Linears U(-1/sqrt(in), 1/sqrt(in)), a zero
        CLS embedding, norms ones / zeros, logit_scale 2.6592."""
        g = generator or torch.Generator(device=device).manual_seed(0)
        model = CLIPModel(cfg, device=device, dtype=dtype)
        emb = model.vision_model.embeddings
        for t in (model.text_model.token_embedding, model.text_model.position_embedding, emb.patch_weight,
                  emb.position_embedding):
            t.normal_(0.0, 0.02, generator=g)
        emb.class_embedding.zero_()
        for mod in model.modules():
            if isinstance(mod, Linear):
                mod.reset_parameters(g)
        model.logit_scale.fill_(2.6592)
        return model

    def encode_text(self, input_ids):
        return self.text_projection(self.text_model(input_ids))

    def encode_image(self, pixel_values):
        return self.visual_projection(self.vision_model.pooled(pixel_values))

    def forward(self, input_ids, pixel_values):
        """logits_per_image [B_img, B_txt], f32."""
        t = self.encode_text(input_ids).float()
        v = self.encode_image(pixel_values).float()
        t = t / torch.linalg.norm(t, dim=-1, keepdim=True)
        v = v / torch.linalg.norm(v, dim=-1, keepdim=True)
        return torch.exp(self.logit_scale) * v @ t.T


# ---------------------------------------------------------------------------
# HF checkpoint loading
# ---------------------------------------------------------------------------


def tower_block_names(prefix: str, n_layers: int, hf_prefix: Optional[str] = None) -> dict:
    """Port key -> HF name of the blocks of CLIP's tower `prefix`, stored
    under `hf_prefix` (the same name by default)."""
    hf_prefix = hf_prefix or prefix
    sub = {"ln1": "layer_norm1", "ln2": "layer_norm2", "attn.q_proj": "self_attn.q_proj",
           "attn.k_proj": "self_attn.k_proj", "attn.v_proj": "self_attn.v_proj",
           "attn.out_proj": "self_attn.out_proj", "mlp.fc1": "mlp.fc1", "mlp.fc2": "mlp.fc2"}
    return {f"{prefix}.blocks.{i}.{p}.{w}": f"{hf_prefix}.encoder.layers.{i}.{h}.{w}"
            for i in range(n_layers) for p, h in sub.items() for w in ("weight", "bias")}


def load_clip(loader, cfg: CLIPConfig, *, device, dtype=torch.float32) -> CLIPModel:
    model = CLIPModel(cfg, device=device, dtype=dtype)
    names = {
        "text_model.token_embedding": "text_model.embeddings.token_embedding.weight",
        "text_model.position_embedding": "text_model.embeddings.position_embedding.weight",
        "text_model.final_ln.weight": "text_model.final_layer_norm.weight",
        "text_model.final_ln.bias": "text_model.final_layer_norm.bias",
        "vision_model.embeddings.patch_weight": "vision_model.embeddings.patch_embedding.weight",
        "vision_model.embeddings.class_embedding": "vision_model.embeddings.class_embedding",
        "vision_model.embeddings.position_embedding": "vision_model.embeddings.position_embedding.weight",
        "vision_model.pre_ln.weight": "vision_model.pre_layrnorm.weight",
        "vision_model.pre_ln.bias": "vision_model.pre_layrnorm.bias",
        "vision_model.post_ln.weight": "vision_model.post_layernorm.weight",
        "vision_model.post_ln.bias": "vision_model.post_layernorm.bias",
        "text_projection.weight": "text_projection.weight",
        "visual_projection.weight": "visual_projection.weight",
        **tower_block_names("text_model", cfg.text.num_hidden_layers),
        **tower_block_names("vision_model", cfg.vision.num_hidden_layers),
        "logit_scale": "logit_scale",
    }
    load_params(model, loader, names, device=device, dtype=dtype, f32=("logit_scale",))
    return model


def clip_config_from_hf(path_or_dict) -> CLIPConfig:
    c = read_config(path_or_dict)
    t, v = c.get("text_config", {}), c.get("vision_config", {})

    def mk(cls, d, allowed):
        return cls(**{k: d[k] for k in allowed if k in d})

    tc = mk(CLIPTextConfig, t, ["vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
                                "num_attention_heads", "max_position_embeddings", "hidden_act", "layer_norm_eps",
                                "eos_token_id"])
    vcfg = mk(VisionConfig, v, ["hidden_size", "intermediate_size", "num_hidden_layers", "num_attention_heads",
                                "image_size", "patch_size", "num_channels", "hidden_act", "layer_norm_eps"])
    return CLIPConfig(tc, vcfg, c.get("projection_dim", 512))
