"""Qwen2-VL: counterpart of `mllm_tpu/models/qwen2_vl.py`.

  - the Conv3D patch embed as a matmul over pre-patchified pixels (`PatchEmbed`);
  - vision blocks with the 2-D rotary over the (h, w) grid, whose attention
    (`nn.attention.attend_padded_head`) runs the flash kernel at head_dim 80
    on the card;
  - `PatchMerger`, and the M-RoPE decoder over the port's `CausalLM` blocks:
    each `DecoderBlock` takes the `MultimodalRotaryEmbedding` in place of its
    rope and positions [3, B, S] (the JAX `_mrope_attn` is the block's own
    `Attention` so called), so every cache kind through `attend_from_cache`,
    the fused projections and the quantized layers serve the VL model as
    they serve the text one;
  - `get_rope_index` (images and videos), the image-token splice, VTP
    (prefill-time vision-token pruning) over the dense cache;
  - the on-device preprocess (`device_patchify`, `vl_image_prefill` and its
    I420 and raw-frame forms), `vl_generate` (a host loop) and
    `vl_generate_compiled` (the vision encode and prefill eagerly, then the
    decode loop as a replayed CUDA graph whose M-RoPE offset is a device
    scalar, as `generate_compiled`);
  - `load_qwen2_vl` for HF checkpoints (visual.* / model.* / lm_head).

The towers' blocks stay unrolled (the JAX `stack()` is a scan over leaf-
stacked blocks; `models.bridge` takes both layouts). Unlike the JAX tower,
which runs in the patches' dtype, the port's runs in its weights' dtype:
`PatchEmbed` casts the patches, so a bf16 model's tower is bf16 on the card,
the flash kernel's type.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import TextConfig
from ..kv.cache import KVCache, to_device
from ..nn.attention import attend_padded_head
from ..nn.layers import ACT_FN, LayerNorm, Linear, MultimodalRotaryEmbedding, _param
from .transformer import CausalLM


@dataclass(frozen=True)
class Qwen2VLVisionConfig:
    depth: int = 32
    embed_dim: int = 1280
    hidden_size: int = 1536  # output dim (LM hidden)
    intermediate_size: int = 0  # mlp hidden = embed_dim * mlp_ratio
    mlp_ratio: float = 4.0
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    hidden_act: str = "quick_gelu"

    @property
    def mlp_hidden(self) -> int:
        return self.intermediate_size or int(self.embed_dim * self.mlp_ratio)


@dataclass(frozen=True)
class Qwen2VLConfig:
    text: TextConfig = TextConfig()
    vision: Qwen2VLVisionConfig = Qwen2VLVisionConfig()
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652
    mrope_section: tuple = (16, 24, 24)


VISION_EPS = 1e-6  # the towers' norms (HF checkpoints)


def vision_inv_freq(head_dim: int, device) -> torch.Tensor:
    """The vision rotary's inverse frequencies [head_dim / 4] (theta 10000)."""
    hq = head_dim // 4
    inv = 1.0 / (10000.0 ** (np.arange(0, hq * 2, 2, dtype=np.float64) / (hq * 2)))
    return torch.tensor(inv, dtype=torch.float32, device=device)


def merged_grid_positions(grid_thw, ms: int) -> np.ndarray:
    """(h, w) grid positions [t*h*w, 2] in the merged-patch order of the
    patch matrix (each ms x ms block of patches consecutive)."""
    t, h, w = grid_thw
    hpos = np.arange(h)[:, None].repeat(w, axis=1)
    hpos = hpos.reshape(h // ms, ms, w // ms, ms).transpose(0, 2, 1, 3).reshape(-1)
    wpos = np.arange(w)[None, :].repeat(h, axis=0)
    wpos = wpos.reshape(h // ms, ms, w // ms, ms).transpose(0, 2, 1, 3).reshape(-1)
    return np.tile(np.stack([hpos, wpos], axis=-1), (t, 1))


def rotary_tables(pos: np.ndarray, inv_freq: torch.Tensor):
    """cos / sin [S, head_dim] of grid positions [S, 2] (both halves equal)."""
    p = to_device(pos.astype(np.float32), inv_freq.device)
    freqs = (p[:, :, None] * inv_freq[None, None, :]).reshape(p.shape[0], -1)  # [S, hd/2]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


# ---------------------------------------------------------------------------
# Vision tower
# ---------------------------------------------------------------------------


class PatchEmbed(nn.Module):
    """Conv3D patch embed as a matmul: weight [D, C*tps*ps*ps]; f32
    accumulation, the result in the weight's dtype. Stays float under
    `quantize_model`."""

    def __init__(self, dim: int, patch_in: int, *, device, dtype):
        super().__init__()
        self.weight = _param(dim, patch_in, device=device, dtype=dtype)

    def forward(self, patches):  # [S, C*tps*ps*ps]
        from ..nn.layers import matmul_f32

        return matmul_f32(patches.to(self.weight.dtype), self.weight).to(self.weight.dtype)


def _apply_vision_rotary(x, cos, sin):
    """x: [S, H, D]; cos/sin: [S, D] (already duplicated halves); in f32."""
    xf = x.float()
    half = x.shape[-1] // 2
    rot = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos[:, None, :] + rot * sin[:, None, :]).to(x.dtype)


class VisionSdpaBlock(nn.Module):
    """Qwen2-VL vision block: fused-qkv attention with the 2-D rotary, then
    fc1 / act / fc2; LayerNorms before each."""

    def __init__(self, dim: int, mlp_hidden: int, n_heads: int, act: str, *, device, dtype, eps: float = VISION_EPS):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = LayerNorm(dim, eps, **kw)
        self.qkv = Linear(dim, 3 * dim, True, **kw)
        self.proj = Linear(dim, dim, True, **kw)
        self.norm2 = LayerNorm(dim, eps, **kw)
        self.fc1 = Linear(dim, mlp_hidden, True, **kw)
        self.fc2 = Linear(mlp_hidden, dim, True, **kw)
        self.n_heads = n_heads
        self.act = act

    def _attn(self, x, cos, sin):
        s, d = x.shape
        hd = d // self.n_heads
        qkv = self.qkv(x).reshape(s, 3, self.n_heads, hd)
        q = _apply_vision_rotary(qkv[:, 0], cos, sin)
        k = _apply_vision_rotary(qkv[:, 1], cos, sin)
        v = qkv[:, 2]
        # the flash kernel at head_dim 80 on the card, with no [H, S, S] scores in memory
        out = attend_padded_head(q[None], k.transpose(0, 1)[None].contiguous(),
                                 v.transpose(0, 1)[None].contiguous(), causal=False)[0]
        return self.proj(out.reshape(s, d))

    def forward(self, x, cos, sin):
        x = x + self._attn(self.norm1(x), cos, sin)
        return x + self.fc2(ACT_FN[self.act](self.fc1(self.norm2(x))))


class PatchMerger(nn.Module):
    """ln_q, then a 2-layer MLP (exact gelu) over merge_size^2 concatenated
    patches; `ln_q` is a LayerNorm (Qwen2-VL) or an RMSNorm (Qwen2.5-VL)."""

    def __init__(self, ln_q: nn.Module, dim: int, merge_dim: int, out_dim: int, *, device, dtype):
        super().__init__()
        self.ln_q = ln_q
        self.fc1 = Linear(merge_dim, merge_dim, True, device=device, dtype=dtype)
        self.fc2 = Linear(merge_dim, out_dim, True, device=device, dtype=dtype)
        self.merge_dim = merge_dim

    def forward(self, x):  # [S, D]
        x = self.ln_q(x).reshape(-1, self.merge_dim)
        return self.fc2(F.gelu(self.fc1(x)))


def _reset(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights as the JAX `init`s draw them: Linears U(-1/sqrt(in),
    1/sqrt(in)), the patch embed U(-0.02, 0.02); norms keep ones / zeros."""
    for mod in module.modules():
        if isinstance(mod, Linear):
            mod.reset_parameters(generator)
        elif isinstance(mod, PatchEmbed):
            mod.weight.uniform_(-0.02, 0.02, generator=generator)


class Qwen2VLVisionTower(nn.Module):
    def __init__(self, cfg: Qwen2VLVisionConfig, *, device, dtype, eps: float = VISION_EPS):
        super().__init__()
        d = cfg.embed_dim
        kw = dict(device=device, dtype=dtype)
        patch_in = cfg.in_channels * cfg.temporal_patch_size * cfg.patch_size**2
        self.patch_embed = PatchEmbed(d, patch_in, **kw)
        self.blocks = nn.ModuleList([VisionSdpaBlock(d, cfg.mlp_hidden, cfg.num_heads, cfg.hidden_act, eps=eps, **kw)
                                     for _ in range(cfg.depth)])
        merge_dim = d * cfg.spatial_merge_size**2
        self.merger = PatchMerger(LayerNorm(d, eps, **kw), d, merge_dim, cfg.hidden_size, **kw)
        self.register_buffer("inv_freq", vision_inv_freq(d // cfg.num_heads, device), persistent=False)
        self.cfg = cfg

    @staticmethod
    def init(cfg: Qwen2VLVisionConfig, *, device, dtype=torch.float32,
             generator: Optional[torch.Generator] = None) -> "Qwen2VLVisionTower":
        """Random-weight tower (the smoke's and the tests' builds)."""
        tower = Qwen2VLVisionTower(cfg, device=device, dtype=dtype)
        _reset(tower, generator or torch.Generator(device=device).manual_seed(0))
        return tower

    def rot_pos_emb(self, grid_thw) -> tuple[torch.Tensor, torch.Tensor]:
        """cos / sin [S, head_dim] for the merged-patch ordering."""
        return rotary_tables(merged_grid_positions(grid_thw, self.cfg.spatial_merge_size), self.inv_freq)

    def forward(self, patches, grid_thw):
        """patches: [S, C*tps*ps*ps] -> merged embeds [S/ms^2, hidden_size]."""
        cos, sin = self.rot_pos_emb(tuple(grid_thw))
        x = self.patch_embed(patches)
        for blk in self.blocks:
            x = blk(x, cos, sin)
        return self.merger(x)


# ---------------------------------------------------------------------------
# M-RoPE position computation (a copy of the JAX package's, numpy)
# ---------------------------------------------------------------------------


def get_rope_index(
    input_ids: np.ndarray,  # [S] int
    image_grid_thw: list[tuple[int, int, int]],
    image_token_id: int,
    video_token_id: int,
    spatial_merge_size: int = 2,
) -> tuple[np.ndarray, int]:
    """Returns (position_ids [3, S], mrope_position_delta).

    Text tokens advance all 3 axes together; each vision span uses
    (t, h, w) grid indices offset by the running position.
    """
    s = len(input_ids)
    pos = np.zeros((3, s), dtype=np.int64)
    img_idx = 0
    st = 0  # index into sequence
    current = 0  # running position offset
    ids = np.asarray(input_ids)
    while st < s:
        if ids[st] in (image_token_id, video_token_id):
            t, h, w = image_grid_thw[img_idx]
            img_idx += 1
            lh, lw = h // spatial_merge_size, w // spatial_merge_size
            n = t * lh * lw
            t_idx = np.repeat(np.arange(t), lh * lw)
            h_idx = np.tile(np.repeat(np.arange(lh), lw), t)
            w_idx = np.tile(np.arange(lw), t * lh)
            pos[0, st : st + n] = current + t_idx
            pos[1, st : st + n] = current + h_idx
            pos[2, st : st + n] = current + w_idx
            current = int(pos[:, st : st + n].max()) + 1
            st += n
        else:
            pos[:, st] = current
            current += 1
            st += 1
    delta = current - s
    return pos, delta


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


def text_positions(cache, s: int, device, delta=None) -> torch.Tensor:
    """Positions [3, B or 1, S] of a run with no image in it: the cache's write
    head(s) plus 0..S-1 plus the M-RoPE offset `delta` (a device scalar or
    [B], the request's mrope_delta; None for 0), the same on all three axes,
    read on the device."""
    p = torch.arange(s, device=device)[None, :]
    for base in (cache.pos if cache is not None else None, delta):
        if base is not None:
            p = (base[:, None] if base.dim() == 1 else base) + p
    return p[None].expand(3, *p.shape)


class Qwen2VLForConditionalGeneration(nn.Module):
    def __init__(self, visual: nn.Module, lm: CausalLM, cfg: Qwen2VLConfig):
        super().__init__()
        self.visual = visual
        self.lm = lm
        self.cfg = cfg
        tc = cfg.text  # the LM's rope swapped for M-RoPE
        self.mrope = MultimodalRotaryEmbedding.make(tc.head_dim_, tc.max_position_embeddings, tc.rope_theta,
                                                    cfg.mrope_section, device=lm.device)

    @staticmethod
    def init(cfg: Qwen2VLConfig, *, device, dtype=torch.float32,
             generator: Optional[torch.Generator] = None) -> "Qwen2VLForConditionalGeneration":
        """Random weights: the tower as `Qwen2VLVisionTower.init`, the LM as
        `CausalLM.init`, both from `generator`."""
        generator = generator or torch.Generator(device=device).manual_seed(0)
        visual = Qwen2VLVisionTower.init(cfg.vision, device=device, dtype=dtype, generator=generator)
        return Qwen2VLForConditionalGeneration(
            visual, CausalLM.init(cfg.text, device=device, dtype=dtype, generator=generator), cfg)

    @property
    def device(self) -> torch.device:
        return self.lm.device

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16, kv_dtype: str = "bf16"):
        return self.lm.init_cache(batch, max_len, dtype, kv_dtype=kv_dtype)

    def embed(self, input_ids, image_embeds: Optional[torch.Tensor]):
        """Token embeddings with image embeds spliced at the image / video pad
        positions, in order."""
        x = self.lm.embed_tokens(input_ids)
        if image_embeds is not None:
            is_img = (input_ids == self.cfg.image_token_id) | (input_ids == self.cfg.video_token_id)
            idx = (torch.cumsum(is_img.to(torch.int32), dim=-1) - 1).clamp(0, image_embeds.shape[0] - 1)
            x = torch.where(is_img[..., None], image_embeds[idx].to(x.dtype), x)
        return x

    def trunk(self, x, positions, cache):
        """Decoder trunk with M-RoPE positions [3, B, S] -> (normed hidden
        [B, S, D], cache advanced by S)."""
        for blk in self.lm.blocks:
            x, cache = blk(x, self.mrope, cache, positions)
        x = self.lm.norm(x)
        return x, (cache.advance(x.shape[1]) if cache is not None else None)

    def forward_text(self, x, positions, cache, last_only=True, last_pos: Optional[int] = None):
        """Trunk + LM head; last_pos (the true final token of a padded prompt)
        runs the head on that one position."""
        x, cache = self.trunk(x, positions, cache)
        if last_pos is not None:
            x = x[:, last_pos : last_pos + 1, :]
        elif last_only:
            x = x[:, -1:, :]
        return self.lm.logits(x), cache

    def hidden_states(self, input_ids, cache, inputs_embeds=None, pad_lens=None):
        """Text-only trunk with `CausalLM.hidden_states`' signature (the
        engine's text admissions): positions are the cache heads on all three
        axes."""
        if pad_lens is not None:
            raise ValueError("the VL model has no ragged left-pad path (as in the JAX package)")
        x = inputs_embeds if inputs_embeds is not None else self.embed(input_ids, None)
        return self.trunk(x, text_positions(cache, x.shape[1], x.device), cache)

    def logits(self, hidden):
        return self.lm.logits(hidden)

    def forward(self, input_ids, cache, patches=None, grid_thw=None, positions=None, last_only=True,
                last_pos: Optional[int] = None, pos_delta=None):
        """input_ids [B, S]; patches [Sp, C*tps*ps*ps]; positions [3, B, S]
        (default: the cache heads plus `pos_delta`, a device scalar or [B],
        as `text_positions` gives them: a decode step after an image)."""
        image_embeds = self.visual(patches, grid_thw) if patches is not None else None
        x = self.embed(input_ids, image_embeds)
        if positions is None:
            positions = text_positions(cache, x.shape[1], x.device, pos_delta)
        return self.forward_text(x, positions, cache, last_only, last_pos)


# ---------------------------------------------------------------------------
# VTP: visual token pruning at prefill
# ---------------------------------------------------------------------------


@torch.no_grad()
def vtp_prefill(model: Qwen2VLForConditionalGeneration, input_ids, cache: KVCache, patches, grid_thw, positions,
                keep_ratio: float = 0.5, prune_layer: int = 2):
    """Prefill with prefill-time vision-token pruning (JAX `vtp_prefill`).

    Runs layers [0, prune_layer) at full length, scores vision tokens by the
    last text query's attention over the prune layer's keys, keeps the top
    `keep_ratio` of them, compacts the hidden states, the positions and the
    K/V rows already written (every layer's, along the cache's sequence
    axis), then runs the other layers at the shorter length. The cache (a
    dense KVCache) must start empty. Returns (last-token logits [1, V],
    cache with pos = pruned length)."""
    cfg = model.cfg
    lm = model.lm
    ids = np.asarray(input_ids.cpu() if isinstance(input_ids, torch.Tensor) else input_ids)
    s = ids.shape[1]
    is_img_np = np.isin(ids[0], [cfg.image_token_id, cfg.video_token_id])
    n_img = int(is_img_np.sum())
    n_keep = max(1, int(n_img * keep_ratio))
    s_new = s - (n_img - n_keep)
    dev = model.device

    image_embeds = model.visual(patches, grid_thw) if patches is not None else None
    x = model.embed(to_device(ids, dev, torch.long), image_embeds)
    positions = torch.as_tensor(positions, device=dev)
    cache = cache.with_pos(0)
    for blk in lm.blocks[:prune_layer]:  # phase 1: every block writes rows [0, S)
        x, _ = blk(x, model.mrope, cache, positions)

    kl, _ = cache.layer(prune_layer - 1)  # [1, Hkv, S_max, D]
    q = _last_query(lm, model.mrope, x, positions, prune_layer)
    scores = torch.einsum("d,hsd->hs", q, kl[0, :, :s, :].float()).mean(0)  # [S]
    scores = torch.where(to_device(is_img_np, dev), scores, torch.full_like(scores, float("inf")))
    kept = torch.sort(torch.argsort(-scores, stable=True)[:s_new]).values  # original order

    x = x[:, kept, :]
    positions = positions[:, :, kept]
    for buf in (cache.k, cache.v):  # compact the rows written so far (all layers share them)
        buf[:, :, :, :s_new] = buf.index_select(3, kept)
    for blk in lm.blocks[prune_layer:]:  # phase 2: the other blocks at the pruned length
        x, _ = blk(x, model.mrope, cache, positions)
    x = lm.norm(x)
    return lm.logits(x[:, -1:, :])[:, 0, :], cache.with_pos(s_new)



def _last_query(lm, mrope, x, positions, layer: int):
    """The q vector of the final position at `layer`, mean over heads (the
    VTP importance probe)."""
    attn = lm.blocks[layer].attn
    cfg = attn.cfg
    h = lm.blocks[layer].input_norm(x[:, -1:, :])
    nq = cfg.num_attention_heads * cfg.head_dim_
    q = attn.qkv_proj(h)[..., :nq] if attn.qkv_proj is not None else attn.q_proj(h)
    q = mrope(q.reshape(1, 1, cfg.num_attention_heads, cfg.head_dim_), positions[:, :, -1:])
    return q[0, 0].mean(0).float()  # [D]


# ---------------------------------------------------------------------------
# On-device preprocess (rescale + normalize + 3D patchify)
# ---------------------------------------------------------------------------


def device_patchify(pixel: torch.Tensor, mean, std, patch_size: int = 14, temporal_patch_size: int = 2,
                    merge_size: int = 2) -> torch.Tensor:
    """uint8 [T, H, W, C] -> f32 patch matrix [T/tps*h/ps*w/ps, C*tps*ps*ps]
    on pixel's device: the numpy `Qwen2VLImageProcessor.patchify` layout with
    the rescale (1/255) and the CLIP normalisation in one pass."""
    x = pixel.float() * (1.0 / 255.0)
    x = (x - torch.tensor(mean, dtype=torch.float32, device=x.device)) / torch.tensor(
        std, dtype=torch.float32, device=x.device)
    x = x.permute(0, 3, 1, 2)  # [T, C, H, W]
    t, c, h, w = x.shape
    ps, tps, ms = patch_size, temporal_patch_size, merge_size
    gt, gh, gw = t // tps, h // ps, w // ps
    x = x.reshape(gt, tps, c, gh // ms, ms, ps, gw // ms, ms, ps).permute(0, 3, 6, 4, 7, 2, 1, 5, 8)
    return x.reshape(gt * gh * gw, c * tps * ps * ps)


# ---------------------------------------------------------------------------
# Generation
# ---------------------------------------------------------------------------


@torch.no_grad()
def _vl_prefill(model, cache, input_ids, patches, grid_thw, positions, true_len: int):
    logits, cache = model(input_ids, cache, patches=patches, grid_thw=grid_thw, positions=positions,
                          last_pos=true_len - 1)
    return logits[:, 0, :], cache.with_pos(true_len)


@torch.no_grad()
def vl_image_prefill(model, cache, input_ids, pixel, positions, true_len: int, grid_thw):
    """The image prefill from the resized uint8 frames [T, H, W, 3] on the
    card: normalize + patchify, the vision tower, the image-token splice and
    the LM prefill. Returns (last-token logits [B, V], cache at true_len)."""
    from ..processor.image import CLIP_MEAN, CLIP_STD

    vc = model.visual.cfg
    if pixel.shape[0] % vc.temporal_patch_size:  # a single frame: repeated on the device
        reps = vc.temporal_patch_size - pixel.shape[0] % vc.temporal_patch_size
        pixel = torch.cat([pixel] + [pixel[-1:]] * reps, dim=0)
    patches = device_patchify(pixel, CLIP_MEAN, CLIP_STD, vc.patch_size, vc.temporal_patch_size,
                              vc.spatial_merge_size)
    return _vl_prefill(model, cache, input_ids, patches, grid_thw, positions, true_len)


@torch.no_grad()
def vl_image_prefill_yuv(model, cache, input_ids, y, u, v, positions, true_len: int, grid_thw):
    """`vl_image_prefill` from planar I420 frames (y uint8 [T, H, W], u / v
    [T, H/2, W/2]; `processor.image.rgb_to_yuv420`'s layout): half the RGB
    bytes to the card, the colour conversion there."""
    from ..processor.image import yuv420_to_rgb

    return vl_image_prefill(model, cache, input_ids, yuv420_to_rgb(y, u, v), positions, true_len, grid_thw)


@torch.no_grad()
def vl_image_prefill_raw(model, cache, input_ids, raw_frame, v_coeff, h_coeff, positions, true_len: int,
                         grid_thw):
    """`vl_image_prefill` from the raw frames uint8 [T, H_raw, W_raw, 3]: the
    PIL-semantics bicubic resize runs on the card as two coefficient products
    (`processor.image.device_resize_bicubic`; v_coeff / h_coeff from
    `bicubic_coeff_matrix`)."""
    from ..processor.image import device_resize_bicubic

    resized = device_resize_bicubic(raw_frame, v_coeff, h_coeff)
    return vl_image_prefill(model, cache, input_ids, resized, positions, true_len, grid_thw)


@torch.no_grad()
def _vl_decode_step(model, cache, token, pos):
    """One greedy-loop step at M-RoPE position `pos` on all three axes."""
    p = torch.as_tensor(pos, device=token.device).reshape(1, 1, 1).expand(3, 1, 1)
    logits, cache = model(token[:, None], cache, positions=p, last_only=True)
    return logits[:, 0, :], cache


def vl_generate(model, proc_out, cache, max_new_tokens: int = 128, eos_token_id: Optional[int] = None,
                callback=None):
    """Greedy streaming host loop over a `Qwen2VLProcessorOutput`: the prefill
    with the image, then one eager decode step a token at position head +
    mrope_delta. Returns (tokens, cache)."""
    from ..generation.generate import check_room

    dev = model.device
    ids = np.asarray(proc_out.input_ids)
    true_len = ids.shape[1]
    check_room(cache, true_len + max_new_tokens - 1, "vl_generate")
    eos = eos_token_id if eos_token_id is not None else -1
    patches = proc_out.patches
    if patches is not None:  # host numpy (the processor's) or a tensor already on the card
        patches = patches.to(dev) if isinstance(patches, torch.Tensor) else to_device(np.asarray(patches), dev)
    logits, cache = _vl_prefill(model, cache, to_device(ids, dev, torch.long), patches, proc_out.grid_thw,
                                to_device(np.asarray(proc_out.position_ids), dev, torch.long), true_len)
    tok = torch.argmax(logits, dim=-1)
    out = [int(tok[0])]
    if callback:
        callback(out[-1])
    pos = true_len + proc_out.mrope_delta
    for i in range(max_new_tokens - 1):
        if out[-1] == eos:
            break
        logits, cache = _vl_decode_step(model, cache, tok, pos + i)
        tok = torch.argmax(logits, dim=-1)
        out.append(int(tok[0]))
        if callback:
            callback(out[-1])
    return out, cache


def _vl_loop(model, cache, window: int):
    """A `generate_compiled` decode loop whose model calls take the M-RoPE
    offset `pos_delta`, a device scalar of the loop set per call, so one
    capture serves every image."""
    from ..generation.generate import _DecodeLoop
    from ..generation.sampling import SamplingConfig

    loop = _DecodeLoop(model, cache, SamplingConfig(), window)
    loop.model_kw["pos_delta"] = torch.zeros((), dtype=torch.int32, device=cache.k.device)
    return loop


@torch.no_grad()
def vl_generate_compiled(model, input_ids, patches, grid_thw, positions, cache, true_len: int,
                         max_new_tokens: int, eos_token_id: int = -1, mrope_delta: int = 0, *, window: int = 0):
    """Greedy VL generation with the decode loop on the device (JAX
    `vl_generate_compiled`): the vision encode and the prefill run eagerly,
    then windows of `window` decode steps (COMPILED_WINDOW by default) replay
    as one CUDA graph until eos or the budget; every step's M-RoPE position is
    the loop's head plus its device-scalar `pos_delta`. On the CPU the same steps
    run eagerly. Returns (tokens [max_new_tokens] int32 padded with -1,
    n_generated) as tensors on the cache's device."""
    from ..generation.generate import COMPILED_WINDOW, check_room
    from ..generation.graphs import loop_for

    window = window or COMPILED_WINDOW
    ids = torch.as_tensor(np.asarray(input_ids) if not isinstance(input_ids, torch.Tensor) else input_ids)
    if ids.dim() != 2 or ids.shape[0] != 1:
        raise ValueError(f"vl_generate_compiled: input_ids must be [1, S], got {tuple(ids.shape)}")
    if max_new_tokens < 1:
        raise ValueError("vl_generate_compiled: max_new_tokens must be >= 1")
    check_room(cache, max(ids.shape[1], true_len + max_new_tokens - 1), "vl_generate_compiled")
    ref = weakref.ref(model)
    loop = loop_for(model, cache, ("vl_generate_compiled", window), lambda c: _vl_loop(ref(), c, window))
    dev = loop.tokens.device
    loop.cache.pos.copy_(cache.pos)
    pos = torch.as_tensor(positions, device=dev)
    logits, _ = model(ids.to(dev), loop.cache, patches=patches, grid_thw=grid_thw, positions=pos,
                      last_pos=true_len - 1)
    loop.cache.pos.fill_(true_len)
    tok0 = torch.argmax(logits[:, 0], dim=-1)
    loop.model_kw["pos_delta"].fill_(int(mrope_delta))
    loop.tokens.fill_(-1)
    loop.tokens[:1].copy_(tok0)
    loop.tok.copy_(tok0)
    loop.i.fill_(1)
    loop.limit.fill_(max_new_tokens)
    loop.eos.fill_(eos_token_id)
    loop.done.copy_(tok0[0] == loop.eos)
    while not bool(loop.done | (loop.i >= loop.limit)):  # the one host read a window
        loop.graph()
    return loop.tokens[:max_new_tokens].clone(), loop.i.clone()


# ---------------------------------------------------------------------------
# Loading (HF checkpoint names: visual.* / model.* / lm_head)
# ---------------------------------------------------------------------------


def load_params(module: nn.Module, loader, names: dict, *, device, dtype, f32=()) -> None:
    """Fill `module`'s parameters from checkpoint tensors: names maps each
    state-dict key to its checkpoint name (strict); the keys in `f32` stay
    f32, the others take `dtype`."""
    from .loading import float_tensor

    sd = module.state_dict()
    state = {}
    for key, ck in names.items():
        state[key] = float_tensor(loader.load(ck, tuple(sd[key].shape), np.float32), device,
                                  torch.float32 if key in f32 else dtype)
    module.load_state_dict(state, strict=True)


# a tower block's Linears and their HF names (Qwen2-VL's fc1 / fc2, Qwen2.5-VL's gate / up / down)
_BLOCK_HF = {"qkv": "attn.qkv", "proj": "attn.proj", "fc1": "mlp.fc1", "fc2": "mlp.fc2",
             "gate": "mlp.gate_proj", "up": "mlp.up_proj", "down": "mlp.down_proj"}


def tower_names(tower: nn.Module, prefix: str = "visual.") -> dict:
    """Port state-dict key -> HF name of a Qwen2-VL / Qwen2.5-VL tower: a
    block's Linears sit under `attn.` / `mlp.` there (`_BLOCK_HF`), the
    merger's fc1 / fc2 are `merger.mlp.0` / `mlp.2`, the patch embed's weight
    is `patch_embed.proj.weight`; norms keep their names."""
    out = {}
    for key in tower.state_dict():
        parts = key.split(".")
        if parts[0] == "blocks" and parts[2] in _BLOCK_HF:
            ck = ".".join(parts[:2] + [_BLOCK_HF[parts[2]]] + parts[3:])
        elif parts[0] == "merger" and parts[1] in ("fc1", "fc2"):
            ck = ".".join(["merger", "mlp", "0" if parts[1] == "fc1" else "2"] + parts[2:])
        elif key == "patch_embed.weight":
            ck = "patch_embed.proj.weight"
        else:
            ck = key
        out[key] = prefix + ck
    return out


def load_qwen2_vl(loader, cfg: Qwen2VLConfig, *, device, dtype=torch.bfloat16, quant=None):
    """The model from an HF checkpoint: the tower float, the LM through
    `load_causal_lm` (quant as there)."""
    from .loading import load_causal_lm

    visual = Qwen2VLVisionTower(cfg.vision, device=device, dtype=dtype)
    load_params(visual, loader, tower_names(visual), device=device, dtype=dtype)
    lm = load_causal_lm(loader, cfg.text, device=device, dtype=dtype, quant=quant)
    return Qwen2VLForConditionalGeneration(visual, lm, cfg)


def read_config(path_or_dict) -> dict:
    import json
    import os

    if isinstance(path_or_dict, dict):
        return dict(path_or_dict)
    p = os.fspath(path_or_dict)
    if os.path.isdir(p):
        p = os.path.join(p, "config.json")
    with open(p) as f:
        return json.load(f)


def text_config_from_hf(c: dict) -> TextConfig:
    """The LM's TextConfig of a VL config.json (newer transformers nest the LM
    fields under "text_config"). The M-RoPE trunk uses no sliding window, as
    the JAX `_mrope_attn`."""
    from ..core.config import from_hf_config

    flat = {k: v for k, v in c.items() if k not in ("vision_config", "text_config")}
    flat.update(c.get("text_config", {}))
    return from_hf_config(flat, model_type="qwen2").replace(sliding_window=None)


def qwen2_vl_config_from_hf(path_or_dict) -> Qwen2VLConfig:
    c = read_config(path_or_dict)
    v = c.get("vision_config", {})
    vis = Qwen2VLVisionConfig(
        depth=v.get("depth", 32),
        embed_dim=v.get("embed_dim", 1280),
        hidden_size=v.get("hidden_size", c.get("hidden_size", 1536)),
        mlp_ratio=v.get("mlp_ratio", 4.0),
        num_heads=v.get("num_heads", 16),
        in_channels=v.get("in_channels", 3),
        patch_size=v.get("patch_size", 14),
        temporal_patch_size=v.get("temporal_patch_size", 2),
        spatial_merge_size=v.get("spatial_merge_size", 2),
    )
    rs = c.get("rope_scaling") or {}
    return Qwen2VLConfig(
        text=text_config_from_hf(c), vision=vis,
        image_token_id=c.get("image_token_id", 151655),
        video_token_id=c.get("video_token_id", 151656),
        vision_start_token_id=c.get("vision_start_token_id", 151652),
        mrope_section=tuple(rs.get("mrope_section", (16, 24, 24))),
    )
