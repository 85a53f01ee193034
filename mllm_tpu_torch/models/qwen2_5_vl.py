"""Qwen2.5-VL: counterpart of `mllm_tpu/models/qwen2_5_vl.py`.

Differences from Qwen2-VL (`models/qwen2_vl.py`):
  - the vision blocks take RMSNorms and a gated MLP (gate / up / down);
  - windowed vision attention: merged tokens are permuted into windows of
    window_size px, every block but `fullatt_block_indexes` attends within its
    window only (the port's `sdpa` with a same-window bias, as the reference
    sends these blocks to XLA `sdpa`; the full-attention blocks take `sdpa`
    too, as there), and the merger's output is permuted back.

The language model (the M-RoPE decoder) is Qwen2-VL's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..kv.cache import to_device
from ..nn.attention import NEG_INF, sdpa
from ..nn.layers import ACT_FN, Linear, RMSNorm
from .qwen2_vl import (VISION_EPS, PatchEmbed, PatchMerger, Qwen2VLConfig, Qwen2VLForConditionalGeneration,
                       _apply_vision_rotary, _reset, load_params, merged_grid_positions, read_config,
                       rotary_tables, tower_names, vision_inv_freq)
from .transformer import CausalLM


@dataclass(frozen=True)
class Qwen25VLVisionConfig:
    depth: int = 32
    hidden_size: int = 1280  # vision width
    out_hidden_size: int = 2048  # LM hidden
    intermediate_size: int = 3420
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    window_size: int = 112
    fullatt_block_indexes: tuple = (7, 15, 23, 31)
    hidden_act: str = "silu"


def get_window_index(grid_thw: tuple[int, int, int], window_size: int, patch_size: int, merge_size: int):
    """Permutation of MERGED token indices into window order and each
    token's window id (HF Qwen2_5_VisionTransformer.get_window_index; a copy
    of the JAX package's, numpy)."""
    t, h, w = grid_thw
    lh, lw = h // merge_size, w // merge_size  # merged grid
    vit_win = window_size // patch_size // merge_size  # merged tokens per window side
    idx = np.arange(t * lh * lw).reshape(t, lh, lw)
    pad_h = (-lh) % vit_win
    pad_w = (-lw) % vit_win
    padded = np.pad(idx, ((0, 0), (0, pad_h), (0, pad_w)), constant_values=-100)
    nh, nw = padded.shape[1] // vit_win, padded.shape[2] // vit_win
    blocks = padded.reshape(t, nh, vit_win, nw, vit_win).transpose(0, 1, 3, 2, 4)
    flat = blocks.reshape(t * nh * nw, -1)
    window_index = []
    window_ids = []
    for wi, row in enumerate(flat):
        valid = row[row != -100]
        window_index.extend(valid.tolist())
        window_ids.extend([wi] * len(valid))
    return np.asarray(window_index, np.int64), np.asarray(window_ids, np.int32)


class Qwen25VLVisionBlock(nn.Module):
    def __init__(self, dim: int, intermediate: int, n_heads: int, act: str, *, device, dtype,
                 eps: float = VISION_EPS):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = RMSNorm(dim, eps, **kw)
        self.qkv = Linear(dim, 3 * dim, True, **kw)
        self.proj = Linear(dim, dim, True, **kw)
        self.norm2 = RMSNorm(dim, eps, **kw)
        self.gate = Linear(dim, intermediate, True, **kw)
        self.up = Linear(dim, intermediate, True, **kw)
        self.down = Linear(intermediate, dim, True, **kw)
        self.n_heads = n_heads
        self.act = act

    def forward(self, x, cos, sin, bias):
        s, d = x.shape
        hd = d // self.n_heads
        qkv = self.qkv(self.norm1(x)).reshape(s, 3, self.n_heads, hd)
        q = _apply_vision_rotary(qkv[:, 0], cos, sin)
        k = _apply_vision_rotary(qkv[:, 1], cos, sin)
        o = sdpa(q[None], k.transpose(0, 1)[None], qkv[:, 2].transpose(0, 1)[None], causal=False, bias=bias)[0]
        x = x + self.proj(o.reshape(s, d))
        h = self.norm2(x)
        return x + self.down(ACT_FN[self.act](self.gate(h)) * self.up(h))


class Qwen25VLVisionTower(nn.Module):
    def __init__(self, cfg: Qwen25VLVisionConfig, *, device, dtype, eps: float = VISION_EPS):
        super().__init__()
        d = cfg.hidden_size
        kw = dict(device=device, dtype=dtype)
        patch_in = cfg.in_channels * cfg.temporal_patch_size * cfg.patch_size**2
        self.patch_embed = PatchEmbed(d, patch_in, **kw)
        self.blocks = nn.ModuleList([Qwen25VLVisionBlock(d, cfg.intermediate_size, cfg.num_heads, cfg.hidden_act,
                                                         eps=eps, **kw) for _ in range(cfg.depth)])
        merge_dim = d * cfg.spatial_merge_size**2
        self.merger = PatchMerger(RMSNorm(d, eps, **kw), d, merge_dim, cfg.out_hidden_size, **kw)
        self.register_buffer("inv_freq", vision_inv_freq(d // cfg.num_heads, device), persistent=False)
        self.cfg = cfg

    @staticmethod
    def init(cfg: Qwen25VLVisionConfig, *, device, dtype=torch.float32,
             generator: Optional[torch.Generator] = None) -> "Qwen25VLVisionTower":
        tower = Qwen25VLVisionTower(cfg, device=device, dtype=dtype)
        _reset(tower, generator or torch.Generator(device=device).manual_seed(0))
        return tower

    def rot_pos_emb(self, grid_thw, window_index: np.ndarray):
        """cos / sin in WINDOW order for the pre-merge token stream."""
        unit = self.cfg.spatial_merge_size**2
        pos = merged_grid_positions(grid_thw, self.cfg.spatial_merge_size)
        return rotary_tables(pos.reshape(-1, unit, 2)[window_index].reshape(-1, 2), self.inv_freq)

    def forward(self, patches, grid_thw):
        cfg = self.cfg
        ms = cfg.spatial_merge_size
        unit = ms * ms
        grid_thw = tuple(grid_thw)
        window_index, window_ids = get_window_index(grid_thw, cfg.window_size, cfg.patch_size, ms)
        cos, sin = self.rot_pos_emb(grid_thw, window_index)
        dev = self.inv_freq.device

        x = self.patch_embed(patches)  # [S, D] in raster (merge) order
        widx = to_device(window_index, dev, torch.long)
        x = x.reshape(-1, unit, x.shape[-1])[widx].reshape(-1, x.shape[-1])
        tok_win = to_device(np.repeat(window_ids, unit), dev)  # same-window bias, pre-merge tokens
        win_bias = torch.where(tok_win[:, None] == tok_win[None, :], 0.0, NEG_INF).float()
        for i, blk in enumerate(self.blocks):
            x = blk(x, cos, sin, None if i in cfg.fullatt_block_indexes else win_bias)
        x = self.merger(x)  # [S/unit, out_hidden]
        return x[to_device(np.argsort(window_index), dev, torch.long)]  # back to raster order


def qwen2_5_vl_model(cfg: Qwen2VLConfig, vcfg: Qwen25VLVisionConfig, *, device, dtype=torch.float32,
                     generator: Optional[torch.Generator] = None) -> Qwen2VLForConditionalGeneration:
    """A random-weight Qwen2.5-VL (the tower as `Qwen25VLVisionTower.init`,
    the LM as `CausalLM.init`, from `generator`)."""
    generator = generator or torch.Generator(device=device).manual_seed(0)
    visual = Qwen25VLVisionTower.init(vcfg, device=device, dtype=dtype, generator=generator)
    return Qwen2VLForConditionalGeneration(
        visual, CausalLM.init(cfg.text, device=device, dtype=dtype, generator=generator), cfg)


def load_qwen2_5_vl(loader, cfg: Qwen2VLConfig, vcfg: Qwen25VLVisionConfig, *, device, dtype=torch.bfloat16,
                    quant=None):
    """The model from an HF checkpoint: the tower float, the LM through
    `load_causal_lm` (quant as there)."""
    from .loading import load_causal_lm

    visual = Qwen25VLVisionTower(vcfg, device=device, dtype=dtype)
    load_params(visual, loader, tower_names(visual), device=device, dtype=dtype)
    lm = load_causal_lm(loader, cfg.text, device=device, dtype=dtype, quant=quant)
    return Qwen2VLForConditionalGeneration(visual, lm, cfg)


def qwen2_5_vl_configs_from_hf(path_or_dict):
    from .qwen2_vl import qwen2_vl_config_from_hf

    c = read_config(path_or_dict)
    base = qwen2_vl_config_from_hf(c)
    v = c.get("vision_config", {})
    vcfg = Qwen25VLVisionConfig(
        depth=v.get("depth", 32),
        hidden_size=v.get("hidden_size", 1280),
        out_hidden_size=v.get("out_hidden_size", c.get("hidden_size", 2048)),
        intermediate_size=v.get("intermediate_size", 3420),
        num_heads=v.get("num_heads", 16),
        in_channels=v.get("in_channels", 3),
        patch_size=v.get("patch_size", 14),
        temporal_patch_size=v.get("temporal_patch_size", 2),
        spatial_merge_size=v.get("spatial_merge_size", 2),
        window_size=v.get("window_size", 112),
        fullatt_block_indexes=tuple(v.get("fullatt_block_indexes", (7, 15, 23, 31))),
        hidden_act=v.get("hidden_act", "silu"),
    )
    return base, vcfg
