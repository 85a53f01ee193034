"""LLaVA: counterpart of `mllm_tpu/models/llava.py`.

A CLIP vision tower run up to its penultimate block (CLS dropped), a 2-layer
projector with exact (erf) gelu, and a LLaMA-class `CausalLM` whose input
embeddings take the projected patches at the image-token positions. Loads HF
llava-1.5 checkpoints (`vision_tower.*`, `multi_modal_projector.*`,
`language_model.*`).

The splice is on the device: image-token position j of a row takes image row
cumsum(is_image)[j] - 1 (clipped to the rows there are), as the reference
indexes it, with no host read. Decoding calls the same `forward` without an
image, one token at a time, as the reference's demos do.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import TextConfig, from_hf_config
from ..nn.layers import LayerNorm, Linear
from .clip import tower_block_names
from .loading import load_causal_lm
from .qwen2_vl import load_params, read_config
from .transformer import CausalLM
from .vit import VisionConfig, VisionEmbeddings, ViTEncoder, vision_blocks


@dataclass(frozen=True)
class LlavaConfig:
    text: TextConfig = TextConfig()
    vision: VisionConfig = VisionConfig()
    image_token_id: int = 32000
    vision_feature_layer: int = -2  # penultimate block


class LlavaProjector(nn.Module):
    """fc2(gelu(fc1(x))), exact gelu."""

    def __init__(self, in_dim: int, out_dim: int, *, device, dtype):
        super().__init__()
        self.fc1 = Linear(in_dim, out_dim, True, device=device, dtype=dtype)
        self.fc2 = Linear(out_dim, out_dim, True, device=device, dtype=dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


def splice_rows(x: torch.Tensor, is_image: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """x [B, S, D] with position j of a row replaced, where is_image [B, S]
    holds, by rows[cumsum(is_image)[j] - 1] (rows [P, D], the index clipped
    to [0, P - 1]): the reference's splice, on the device."""
    idx = (torch.cumsum(is_image.to(torch.int32), dim=-1) - 1).clamp(0, rows.shape[0] - 1)
    return torch.where(is_image[..., None], rows[idx].to(x.dtype), x)


def clip_tower(vc: VisionConfig, *, device, dtype) -> ViTEncoder:
    """A CLIP vision tower (pre-LN, no post-LN: the penultimate features are
    read before it)."""
    kw = dict(device=device, dtype=dtype)
    return ViTEncoder(VisionEmbeddings(vc, **kw), LayerNorm(vc.hidden_size, vc.layer_norm_eps, **kw),
                      vision_blocks(vc.num_hidden_layers, vc.hidden_size, vc.intermediate_size,
                                    vc.num_attention_heads, vc.hidden_act, vc.layer_norm_eps, **kw), None, vc)


def penultimate_patches(tower: ViTEncoder, pixel_values, feature_layer: int = -2):
    """The tower's hidden states after block len + feature_layer + 1 (the
    penultimate for -2), CLS dropped: [B, P, D]."""
    x = tower.embeddings(pixel_values)
    if tower.pre_ln is not None:
        x = tower.pre_ln(x)
    for blk in tower.blocks[: len(tower.blocks) + feature_layer + 1]:
        x = blk(x)
    return x[:, 1:]


class LlavaForConditionalGeneration(nn.Module):
    def __init__(self, vision_tower: ViTEncoder, projector: LlavaProjector, lm: CausalLM, cfg: LlavaConfig):
        super().__init__()
        self.vision_tower = vision_tower
        self.projector = projector
        self.lm = lm
        self.cfg = cfg

    @staticmethod
    def init(cfg: LlavaConfig, *, device, dtype=torch.float32, generator=None) -> "LlavaForConditionalGeneration":
        """Random weights: the LM as `CausalLM.init`, the tower and projector
        as `CLIPModel.init` (N(0, 0.02^2) embeddings, a zero CLS, U(+-1/sqrt(in))
        Linears), all drawn from `generator`."""
        g = generator or torch.Generator(device=device).manual_seed(0)
        tower = clip_tower(cfg.vision, device=device, dtype=dtype)
        init_tower(tower, g)
        proj = LlavaProjector(cfg.vision.hidden_size, cfg.text.hidden_size, device=device, dtype=dtype)
        for lin in (proj.fc1, proj.fc2):
            lin.reset_parameters(g)
        return LlavaForConditionalGeneration(tower, proj, CausalLM.init(cfg.text, device=device, dtype=dtype,
                                                                        generator=g), cfg)

    def init_cache(self, batch, max_len, dtype=torch.bfloat16, kv_dtype: str = "bf16"):
        return self.lm.init_cache(batch, max_len, dtype, kv_dtype)

    def encode_image(self, pixel_values):
        """pixel [B, 3, H, W] -> projected patch embeds [B, P, lm_hidden]."""
        return self.projector(penultimate_patches(self.vision_tower, pixel_values, self.cfg.vision_feature_layer))

    def forward(self, input_ids, cache, pixel_values=None, last_only: bool = True):
        x = self.lm.embed_tokens(input_ids)
        if pixel_values is not None:
            img = self.encode_image(pixel_values)
            x = splice_rows(x, input_ids == self.cfg.image_token_id, img.reshape(-1, img.shape[-1]))
        hidden, cache = self.lm.hidden_states(None, cache, inputs_embeds=x)
        if last_only:
            hidden = hidden[:, -1:, :]
        return self.lm.logits(hidden), cache


def init_tower(tower: ViTEncoder, g: torch.Generator) -> None:
    """`CLIPModel.init`'s draws for a vision tower."""
    emb = tower.embeddings
    for t in (emb.patch_weight, emb.position_embedding):
        t.normal_(0.0, 0.02, generator=g)
    emb.class_embedding.zero_()
    for mod in tower.modules():
        if isinstance(mod, Linear):
            mod.reset_parameters(g)


def llava_config_from_hf(path_or_dict) -> LlavaConfig:
    c = read_config(path_or_dict)
    v = c.get("vision_config", {})
    vis = VisionConfig(
        hidden_size=v.get("hidden_size", 1024),
        intermediate_size=v.get("intermediate_size", 4096),
        num_hidden_layers=v.get("num_hidden_layers", 24),
        num_attention_heads=v.get("num_attention_heads", 16),
        image_size=v.get("image_size", 336),
        patch_size=v.get("patch_size", 14),
        hidden_act=v.get("hidden_act", "quick_gelu"),
    )
    return LlavaConfig(text=from_hf_config(c.get("text_config", {})), vision=vis,
                       image_token_id=c.get("image_token_index", 32000),
                       vision_feature_layer=c.get("vision_feature_layer", -2))


def tower_names(port: str, hf: str, n_layers: int) -> dict:
    """Port key -> HF name of a CLIP vision tower `port` stored under `hf`
    (`...vision_model`), without a post-LN."""
    return {
        f"{port}.embeddings.patch_weight": f"{hf}.embeddings.patch_embedding.weight",
        f"{port}.embeddings.class_embedding": f"{hf}.embeddings.class_embedding",
        f"{port}.embeddings.position_embedding": f"{hf}.embeddings.position_embedding.weight",
        f"{port}.pre_ln.weight": f"{hf}.pre_layrnorm.weight",
        f"{port}.pre_ln.bias": f"{hf}.pre_layrnorm.bias",
        **tower_block_names(port, n_layers, hf),
    }


def load_llava(loader, cfg: LlavaConfig, *, device, dtype=torch.bfloat16, quant=None
               ) -> LlavaForConditionalGeneration:
    """An HF llava-1.5 checkpoint; `quant` applies to the LM's Linears, as in
    the reference."""
    vc = cfg.vision
    tower = clip_tower(vc, device=device, dtype=dtype)
    proj = LlavaProjector(vc.hidden_size, cfg.text.hidden_size, device=device, dtype=dtype)
    holder = nn.Module()
    holder.vision_tower, holder.projector = tower, proj
    names = {**tower_names("vision_tower", "vision_tower.vision_model", vc.num_hidden_layers),
             **{f"projector.fc{j}.{w}": f"multi_modal_projector.linear_{j}.{w}" for j in (1, 2)
                for w in ("weight", "bias")}}
    load_params(holder, loader, names, device=device, dtype=dtype)
    lm_loader = (PrefixedLoader(loader, "language_model.")
                 if "language_model.model.embed_tokens.weight" in loader else loader)
    lm = load_causal_lm(lm_loader, cfg.text, device=device, dtype=dtype, quant=quant)
    return LlavaForConditionalGeneration(tower, proj, lm, cfg)


class PrefixedLoader:
    """A loader's view with a name prefix applied (llava's `language_model.*`)."""

    def __init__(self, base, prefix: str):
        self.base = base
        self.prefix = prefix
        if hasattr(base, "raw"):
            self.raw = lambda name: base.raw(self.prefix + name)
            self.dtype = lambda name: base.dtype(self.prefix + name)

    def __contains__(self, name):
        return (self.prefix + name) in self.base

    def load(self, name, shape, dtype_=np.float32):
        return self.base.load(self.prefix + name, shape, dtype_)
