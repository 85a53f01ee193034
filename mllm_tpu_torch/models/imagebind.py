"""ImageBind, the tri-modal encoder: counterpart of `mllm_tpu/models/imagebind.py`.

Vision (a 3-D patch embedding over 2 frames, CLS, learned positions, ViT
blocks), text (CLIP-style causal blocks pooled at the EOT positions) and audio
(fbank patches of 16 x 16 at stride 10, CLS, positions, blocks; 20 x the unit
embedding, averaged over the clips) towers projected into one space, with
softmax scores vision x text and vision x audio. The default geometry is
ImageBind-huge. The towers' attention is the port's `sdpa`, as the reference
sends these blocks to XLA `sdpa`. The patch embeddings are products with f32
sums (the audio convolution as its patches times the kernel, stride 10).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..nn.layers import LayerNorm, Linear, _param, matmul_f32
from .vit import vision_blocks

EPS = 1e-6  # the towers' LayerNorms


@dataclass(frozen=True)
class ImageBindConfig:
    vision_hidden: int = 1280
    vision_heads: int = 16
    vision_ffn: int = 5120
    patch: int = 14
    patch_time: int = 2
    img_hw: int = 224
    time_frames: int = 2
    vision_blocks: int = 32

    text_hidden: int = 1024
    text_heads: int = 16
    text_ffn: int = 4096
    vocab_size: int = 49408
    max_positions: int = 77
    text_blocks: int = 24

    audio_hidden: int = 768
    audio_heads: int = 12
    audio_ffn: int = 3072
    audio_kernel: int = 16
    audio_stride: int = 10
    audio_h: int = 128
    audio_w: int = 204
    audio_blocks: int = 12
    audio_clips: int = 3
    audio_scale: float = 20.0

    head_dim: int = 1024  # the shared embedding width

    @property
    def vision_seq(self) -> int:
        hw = self.img_hw // self.patch
        return hw * hw * (self.time_frames // self.patch_time) + 1

    @property
    def audio_seq(self) -> int:
        nh = (self.audio_h - self.audio_kernel) // self.audio_stride + 1
        nw = (self.audio_w - self.audio_kernel) // self.audio_stride + 1
        return nh * nw + 1


def _unit(e):
    return e / torch.linalg.norm(e, dim=-1, keepdim=True)


def _with_cls(x, cls_token, pos_embed):
    b = x.shape[0]
    cls = cls_token[None, None].expand(b, 1, x.shape[-1]).to(x.dtype)
    return torch.cat([cls, x], dim=1) + pos_embed[None]


class ImageBindVisionTower(nn.Module):
    """3-D patch embedding + CLS + learned positions + ViT blocks -> head."""

    def __init__(self, cfg: ImageBindConfig, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.vision_hidden
        self.patch_weight = _param(d, 3 * cfg.patch_time * cfg.patch * cfg.patch, **kw)
        self.cls_token = _param(d, **kw)
        self.pos_embed = _param(cfg.vision_seq, d, **kw)
        self.pre_ln = LayerNorm(d, EPS, **kw)
        self.blocks = vision_blocks(cfg.vision_blocks, d, cfg.vision_ffn, cfg.vision_heads, "gelu", EPS, **kw)
        self.norm = LayerNorm(d, EPS, **kw)
        self.head = Linear(d, cfg.head_dim, False, **kw)

    def forward(self, patches):
        """patches: [B, S - 1, C * pt * p * p] (`patchify_video`) -> unit [B, head_dim]."""
        x = matmul_f32(patches.to(self.patch_weight.dtype), self.patch_weight).to(self.patch_weight.dtype)
        x = self.pre_ln(_with_cls(x, self.cls_token, self.pos_embed))
        for blk in self.blocks:
            x = blk(x)
        return _unit(self.head(self.norm(x[:, 0])))


class ImageBindTextTower(nn.Module):
    """CLIP-style causal text encoder pooled at the EOT positions."""

    def __init__(self, cfg: ImageBindConfig, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.text_hidden
        self.token_embedding = _param(cfg.vocab_size, d, **kw)
        self.pos_embed = _param(cfg.max_positions, d, **kw)
        self.blocks = vision_blocks(cfg.text_blocks, d, cfg.text_ffn, cfg.text_heads, "gelu", EPS, **kw)
        self.norm = LayerNorm(d, EPS, **kw)
        self.head = Linear(d, cfg.head_dim, False, **kw)

    def forward(self, input_ids, eot_positions):
        b, s = input_ids.shape
        x = self.token_embedding[input_ids] + self.pos_embed[None, :s]
        j = torch.arange(s, device=x.device)
        mask = torch.where(j[None, :] <= j[:, None], 0.0, -1e30).to(torch.float32)
        for blk in self.blocks:
            x = blk(x, bias=mask)
        x = self.norm(x)
        return _unit(self.head(x[torch.arange(b, device=x.device), eot_positions]))


class ImageBindAudioTower(nn.Module):
    """fbank patch embedding + CLS + positions + blocks; the unit embedding
    times audio_scale, averaged over each input's clips."""

    def __init__(self, cfg: ImageBindConfig, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d, k = cfg.audio_hidden, cfg.audio_kernel
        self.patch_weight = _param(d, 1, k, k, **kw)
        self.embed_norm = LayerNorm(d, EPS, **kw)
        self.cls_token = _param(d, **kw)
        self.pos_embed = _param(cfg.audio_seq, d, **kw)
        self.blocks = vision_blocks(cfg.audio_blocks, d, cfg.audio_ffn, cfg.audio_heads, "gelu", EPS, **kw)
        self.norm = LayerNorm(d, EPS, **kw)
        self.head = Linear(d, cfg.head_dim, False, **kw)
        self.cfg = cfg

    def forward(self, fbanks):
        """fbanks: [B * clips, 1, H, W] -> [B, head_dim]."""
        cfg = self.cfg
        k, st = cfg.audio_kernel, cfg.audio_stride
        n = fbanks.shape[0]
        w = self.patch_weight
        # the stride-10 convolution (VALID) as its patches [N, nh * nw, k * k] times the kernel
        p = fbanks.to(w.dtype).unfold(2, k, st).unfold(3, k, st)  # [N, 1, nh, nw, k, k]
        p = p.permute(0, 2, 3, 1, 4, 5).reshape(n, -1, k * k)
        x = self.embed_norm(matmul_f32(p, w.reshape(w.shape[0], -1)).to(w.dtype))
        x = _with_cls(x, self.cls_token, self.pos_embed)
        for blk in self.blocks:
            x = blk(x)
        e = _unit(self.head(self.norm(x[:, 0]))) * cfg.audio_scale
        return e.reshape(-1, cfg.audio_clips, cfg.head_dim).mean(dim=1)


class ImageBindModel(nn.Module):
    """Cross-modal scoring: softmax(v t^T) and softmax(v a^T)."""

    def __init__(self, cfg: ImageBindConfig = ImageBindConfig(), *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.vision_model = ImageBindVisionTower(cfg, **kw)
        self.text_model = ImageBindTextTower(cfg, **kw)
        self.audio_model = ImageBindAudioTower(cfg, **kw)
        self.cfg = cfg

    @staticmethod
    def init(cfg: ImageBindConfig = ImageBindConfig(), *, device, dtype=torch.float32,
             generator: Optional[torch.Generator] = None) -> "ImageBindModel":
        """Random weights from `generator` with the JAX `init` distributions:
        patch weights, positions N(0, 0.02^2) (text positions N(0, 0.01^2)),
        token embeddings N(0, 0.02^2), zero CLS tokens, Linears U(+-1/sqrt(in)),
        norms ones / zeros."""
        g = generator or torch.Generator(device=device).manual_seed(0)
        m = ImageBindModel(cfg, device=device, dtype=dtype)
        for t, std in ((m.vision_model.patch_weight, 0.02), (m.vision_model.pos_embed, 0.02),
                       (m.text_model.token_embedding, 0.02), (m.text_model.pos_embed, 0.01),
                       (m.audio_model.patch_weight, 0.02), (m.audio_model.pos_embed, 0.02)):
            t.normal_(0.0, std, generator=g)
        m.vision_model.cls_token.zero_()
        m.audio_model.cls_token.zero_()
        for mod in m.modules():
            if isinstance(mod, Linear):
                mod.reset_parameters(g)
        return m

    def forward(self, input_ids, eot_positions, vision_patches, audio_fbanks):
        t = self.text_model(input_ids, eot_positions)
        v = self.vision_model(vision_patches)
        a = self.audio_model(audio_fbanks)
        return torch.softmax(v @ t.T, dim=-1), torch.softmax(v @ a.T, dim=-1)


def patchify_video(frames: np.ndarray, patch: int = 14, patch_time: int = 2) -> np.ndarray:
    """[B, C, T, H, W] -> [B, (T/pt) (H/p) (W/p), C pt p p] (the vision tower's input)."""
    b, c, t, h, w = frames.shape
    x = frames.reshape(b, c, t // patch_time, patch_time, h // patch, patch, w // patch, patch)
    x = x.transpose(0, 2, 4, 6, 1, 3, 5, 7)
    return x.reshape(b, (t // patch_time) * (h // patch) * (w // patch), c * patch_time * patch * patch)
