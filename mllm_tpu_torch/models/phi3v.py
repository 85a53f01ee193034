"""Phi-3-Vision: counterpart of `mllm_tpu/models/phi3v.py`.

The Phi-3 LM (fused qkv / gate_up in the checkpoint, LongRope), the CLIP
ViT-L/14 tower at 336 px read at its penultimate block, and the HD transform
of one global crop: the 24 x 24 patch features are regrouped into 12 x 12
blocks of 2 x 2 concatenated patches (4 x 1024 wide), a `sub_GN` separator
column closes every block row, a `glb_GN` row follows, and a 2-layer gelu
projector maps the 12 x 13 + 1 rows into the LM. Image embeddings take the
positions of negative input ids (Phi-3-V's convention), spliced on the device
by the cumulative count of `llava.splice_rows`; the ids are clamped at 0
before the embedding. Phi-3's head_dim 96 takes `sdpa`, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import TextConfig, from_hf_config
from ..nn.layers import Linear, _param
from .llava import clip_tower, init_tower, penultimate_patches, splice_rows, tower_names
from .loading import load_causal_lm
from .qwen2_vl import load_params, read_config
from .transformer import CausalLM
from .vit import VisionConfig, ViTEncoder


@dataclass(frozen=True)
class Phi3VConfig:
    text: TextConfig = TextConfig()
    vision: VisionConfig = VisionConfig(
        hidden_size=1024, intermediate_size=4096, num_hidden_layers=24,
        num_attention_heads=16, image_size=336, patch_size=14, hidden_act="quick_gelu",
    )
    image_dim_out: int = 1024


class Phi3VImageEmbedding(nn.Module):
    """CLIP tower + HD transform + projector."""

    def __init__(self, vision: ViTEncoder, cfg: Phi3VConfig, *, device, dtype):
        super().__init__()
        d4, hid = 4 * cfg.image_dim_out, cfg.text.hidden_size
        self.vision = vision
        self.glb_gn = _param(1, 1, d4, device=device, dtype=dtype)
        self.sub_gn = _param(1, 1, 1, d4, device=device, dtype=dtype)
        self.proj1 = Linear(d4, hid, True, device=device, dtype=dtype)
        self.proj2 = Linear(hid, hid, True, device=device, dtype=dtype)
        self.cfg = cfg

    def hd_feature(self, pixel_values):
        """[B, 3, 336, 336] -> [B, 12 * 13 + 1, lm_hidden] (one global crop)."""
        feat = penultimate_patches(self.vision, pixel_values)  # [B, 576, 1024]
        b, c = feat.shape[0], self.cfg.image_dim_out
        hw = self.cfg.vision.image_size // self.cfg.vision.patch_size  # 24
        f = feat.reshape(b, hw // 2, 2, hw // 2, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(b, hw // 2, hw // 2, 4 * c)
        sub = self.sub_gn.expand(b, hw // 2, 1, 4 * c).to(f.dtype)
        f = torch.cat([f, sub], dim=2).reshape(b, -1, 4 * c)  # a separator column a block row
        f = torch.cat([f, self.glb_gn.expand(b, 1, 4 * c).to(f.dtype)], dim=1)
        return self.proj2(F.gelu(self.proj1(f)))


class Phi3VForCausalLM(nn.Module):
    def __init__(self, image_embed: Phi3VImageEmbedding, lm: CausalLM, cfg: Phi3VConfig):
        super().__init__()
        self.image_embed = image_embed
        self.lm = lm
        self.cfg = cfg

    @staticmethod
    def init(cfg: Phi3VConfig, *, device, dtype=torch.float32, generator=None) -> "Phi3VForCausalLM":
        """Random weights from `generator`: the LM as `CausalLM.init`, the
        tower as `llava.init_tower`, the projector's Linears U(+-1/sqrt(in)),
        the separators N(0, 0.02^2)."""
        g = generator or torch.Generator(device=device).manual_seed(0)
        tower = clip_tower(cfg.vision, device=device, dtype=dtype)
        init_tower(tower, g)
        emb = Phi3VImageEmbedding(tower, cfg, device=device, dtype=dtype)
        for t in (emb.glb_gn, emb.sub_gn):
            t.normal_(0.0, 0.02, generator=g)
        for lin in (emb.proj1, emb.proj2):
            lin.reset_parameters(g)
        return Phi3VForCausalLM(emb, CausalLM.init(cfg.text, device=device, dtype=dtype, generator=g), cfg)

    def init_cache(self, batch, max_len, dtype=torch.bfloat16, kv_dtype: str = "bf16"):
        return self.lm.init_cache(batch, max_len, dtype, kv_dtype)

    def forward(self, input_ids, cache, pixel_values=None, last_only: bool = True):
        """input_ids: negative ids mark image positions."""
        x = self.lm.embed_tokens(input_ids.clamp_min(0))
        if pixel_values is not None:
            img = self.image_embed.hd_feature(pixel_values)
            x = splice_rows(x, input_ids < 0, img.reshape(-1, img.shape[-1]))
        hidden, cache = self.lm.hidden_states(None, cache, inputs_embeds=x)
        if last_only:
            hidden = hidden[:, -1:, :]
        return self.lm.logits(hidden), cache

    @property
    def num_image_tokens(self) -> int:
        hw = self.cfg.vision.image_size // self.cfg.vision.patch_size
        return (hw // 2) * (hw // 2 + 1) + 1  # 12 * 13 + glb_GN


def phi3v_config_from_hf(path_or_dict) -> Phi3VConfig:
    c = read_config(path_or_dict)
    text = from_hf_config({k: v for k, v in c.items() if k != "embd_layer"}, model_type="phi3")
    img = c.get("img_processor", {})
    vis = VisionConfig(
        hidden_size=img.get("hidden_size", 1024),
        intermediate_size=img.get("intermediate_size", 4096),
        num_hidden_layers=img.get("num_hidden_layers", 24),
        num_attention_heads=img.get("num_attention_heads", 16),
        image_size=img.get("image_size", 336),
        patch_size=img.get("patch_size", 14),
        hidden_act="quick_gelu",
    )
    return Phi3VConfig(text=text, vision=vis, image_dim_out=img.get("hidden_size", 1024))


def load_phi3v(loader, cfg: Phi3VConfig, *, device, dtype=torch.bfloat16, quant=None) -> Phi3VForCausalLM:
    """A Phi-3-V checkpoint (`model.vision_embed_tokens.*` and the Phi-3 LM);
    `quant` applies to the LM's Linears."""
    vc = cfg.vision
    base = "model.vision_embed_tokens."
    emb = Phi3VImageEmbedding(clip_tower(vc, device=device, dtype=dtype), cfg, device=device, dtype=dtype)
    names = {**tower_names("vision", base + "img_processor.vision_model", vc.num_hidden_layers),
             "glb_gn": base + "glb_GN", "sub_gn": base + "sub_GN",
             **{f"proj{j}.{w}": f"{base}img_projection.{k}.{w}" for j, k in ((1, 0), (2, 2))
                for w in ("weight", "bias")}}
    load_params(emb, loader, names, device=device, dtype=dtype)
    lm = load_causal_lm(loader, cfg.text, device=device, dtype=dtype, quant=quant)
    return Phi3VForCausalLM(emb, lm, cfg)
