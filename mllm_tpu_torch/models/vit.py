"""ViT encoder blocks: counterpart of `mllm_tpu/models/vit.py` (and the
vision blocks that CLIP shares).

Bidirectional attention (the port's `sdpa`, as the reference sends these
blocks to XLA `sdpa`), pre-LN, learned position embeddings, an optional CLS
token; the patch convolution as an unfold and one product. One
(image_size, patch_size) pair per model.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..nn.attention import sdpa
from ..nn.layers import ACT_FN, LayerNorm, Linear, _param, matmul_f32, softmax_f32


@dataclass(frozen=True)
class VisionConfig:
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    image_size: int = 224
    patch_size: int = 32
    num_channels: int = 3
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    use_cls_token: bool = True

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def num_positions(self) -> int:
        return self.num_patches + (1 if self.use_cls_token else 0)


class VisionAttention(nn.Module):
    """Bidirectional MHA over patch (or text) tokens; `bias` an additive
    mask (CLIP's causal text tower)."""

    def __init__(self, dim: int, n_heads: int, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.q_proj = Linear(dim, dim, True, **kw)
        self.k_proj = Linear(dim, dim, True, **kw)
        self.v_proj = Linear(dim, dim, True, **kw)
        self.out_proj = Linear(dim, dim, True, **kw)
        self.n_heads = n_heads

    def forward(self, x, bias=None):
        b, s, d = x.shape
        hd = d // self.n_heads
        q = self.q_proj(x).reshape(b, s, self.n_heads, hd)
        k = self.k_proj(x).reshape(b, s, self.n_heads, hd)
        v = self.v_proj(x).reshape(b, s, self.n_heads, hd)
        out = sdpa(q, k.transpose(1, 2), v.transpose(1, 2), causal=False, bias=bias)
        return self.out_proj(out.reshape(b, s, d))


class VisionMLP(nn.Module):
    def __init__(self, dim: int, inter: int, act: str, *, device, dtype):
        super().__init__()
        self.fc1 = Linear(dim, inter, True, device=device, dtype=dtype)
        self.fc2 = Linear(inter, dim, True, device=device, dtype=dtype)
        self.act = act

    def forward(self, x):
        return self.fc2(ACT_FN[self.act](self.fc1(x)))


class VisionBlock(nn.Module):
    def __init__(self, dim: int, inter: int, n_heads: int, act: str, eps: float, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln1 = LayerNorm(dim, eps, **kw)
        self.attn = VisionAttention(dim, n_heads, **kw)
        self.ln2 = LayerNorm(dim, eps, **kw)
        self.mlp = VisionMLP(dim, inter, act, **kw)

    def forward(self, x, bias=None):
        x = x + self.attn(self.ln1(x), bias=bias)
        return x + self.mlp(self.ln2(x))


def vision_blocks(n: int, dim: int, inter: int, n_heads: int, act: str, eps: float, *, device,
                  dtype) -> nn.ModuleList:
    return nn.ModuleList([VisionBlock(dim, inter, n_heads, act, eps, device=device, dtype=dtype)
                          for _ in range(n)])


class VisionEmbeddings(nn.Module):
    """Conv patch embed (stride == kernel: an unfold and one product), an
    optional CLS token and learned positions. The pixels are cast to the
    weights' dtype."""

    def __init__(self, cfg: VisionConfig, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.patch_weight = _param(cfg.hidden_size, cfg.num_channels, cfg.patch_size, cfg.patch_size, **kw)
        self.class_embedding = _param(cfg.hidden_size, **kw) if cfg.use_cls_token else None
        self.position_embedding = _param(cfg.num_positions, cfg.hidden_size, **kw)
        self.cfg = cfg

    def forward(self, pixel_values):
        """pixel_values: [B, C, H, W] -> [B, S, D]."""
        cfg = self.cfg
        b, ps, n = pixel_values.shape[0], cfg.patch_size, cfg.image_size // cfg.patch_size
        x = pixel_values.to(self.patch_weight.dtype).reshape(b, cfg.num_channels, n, ps, n, ps)
        x = x.permute(0, 2, 4, 1, 3, 5).reshape(b, cfg.num_patches, cfg.num_channels * ps * ps)
        emb = matmul_f32(x, self.patch_weight.reshape(cfg.hidden_size, -1)).to(x.dtype)
        if self.class_embedding is not None:
            cls = self.class_embedding[None, None, :].expand(b, 1, cfg.hidden_size)
            emb = torch.cat([cls.to(emb.dtype), emb], dim=1)
        return emb + self.position_embedding[None]


class ViTEncoder(nn.Module):
    def __init__(self, embeddings: VisionEmbeddings, pre_ln, blocks: nn.ModuleList, post_ln, cfg: VisionConfig):
        super().__init__()
        self.embeddings = embeddings
        self.pre_ln = pre_ln  # CLIP's pre_layrnorm; None for a plain ViT
        self.blocks = blocks
        self.post_ln = post_ln
        self.cfg = cfg

    def forward(self, pixel_values, bias=None):
        x = self.embeddings(pixel_values)
        if self.pre_ln is not None:
            x = self.pre_ln(x)
        for blk in self.blocks:
            x = blk(x, bias=bias)
        return x  # [B, S, D] before post_ln (pooling differs per consumer)

    def pooled(self, pixel_values):
        cls = self(pixel_values)[:, 0]
        return self.post_ln(cls) if self.post_ln is not None else cls


class ViTForImageClassification(nn.Module):
    """CLS-token classifier head on the encoder."""

    def __init__(self, encoder: ViTEncoder, classifier: Linear, id2label=None):
        super().__init__()
        self.encoder = encoder
        self.classifier = classifier
        self.id2label = id2label or {}

    def forward(self, pixel_values):
        """[B, C, H, W] -> logits [B, num_labels]."""
        return self.classifier(self.encoder.pooled(pixel_values))

    @torch.no_grad()
    def classify(self, pixel_values, top_k: int = 1):
        """[(label, prob)] per image (host lists)."""
        probs = softmax_f32(self(pixel_values)).cpu().numpy()
        out = []
        for row in probs:
            idx = np.argsort(row)[::-1][:top_k]
            out.append([(self.id2label.get(int(i), str(int(i))), float(row[i])) for i in idx])
        return out


def vit_classifier(cfg: VisionConfig, num_labels: int, *, device, dtype, id2label=None) -> ViTForImageClassification:
    """An (unfilled) ViT classifier: no pre-LN, a post-LN over the CLS token."""
    kw = dict(device=device, dtype=dtype)
    d = cfg.hidden_size
    blocks = vision_blocks(cfg.num_hidden_layers, d, cfg.intermediate_size, cfg.num_attention_heads,
                           cfg.hidden_act, cfg.layer_norm_eps, **kw)
    enc = ViTEncoder(VisionEmbeddings(cfg, **kw), None, blocks, LayerNorm(d, cfg.layer_norm_eps, **kw), cfg)
    return ViTForImageClassification(enc, Linear(d, num_labels, True, **kw), id2label)


def vit_config_from_hf(path_or_dict) -> "tuple[VisionConfig, int, dict]":
    """HF ViT config.json -> (VisionConfig, num_labels, id2label)."""
    from .qwen2_vl import read_config

    c = read_config(path_or_dict)
    cfg = VisionConfig(
        hidden_size=c.get("hidden_size", 768),
        intermediate_size=c.get("intermediate_size", 3072),
        num_hidden_layers=c.get("num_hidden_layers", 12),
        num_attention_heads=c.get("num_attention_heads", 12),
        image_size=c.get("image_size", 224),
        patch_size=c.get("patch_size", 16),
        num_channels=c.get("num_channels", 3),
        hidden_act=c.get("hidden_act", "gelu"),
        layer_norm_eps=float(c.get("layer_norm_eps", 1e-12)),
    )
    id2label = {int(k): v for k, v in c.get("id2label", {}).items()}
    return cfg, len(id2label) or 1000, id2label


def load_vit_classifier(loader, cfg: VisionConfig, num_labels: int, *, device, dtype=torch.float32,
                        id2label=None) -> ViTForImageClassification:
    """HF `ViTForImageClassification` weights (google/vit-* names). The patch
    convolution's bias is folded into the patch tokens' position embeddings
    (a stride == kernel convolution adds it to every patch), as in the JAX
    package."""
    from .qwen2_vl import load_params

    model = vit_classifier(cfg, num_labels, device=device, dtype=dtype, id2label=id2label)
    emb = model.encoder.embeddings
    d = cfg.hidden_size
    names = {"encoder.embeddings.patch_weight": "vit.embeddings.patch_embeddings.projection.weight",
             "encoder.embeddings.class_embedding": "vit.embeddings.cls_token",
             "encoder.embeddings.position_embedding": "vit.embeddings.position_embeddings",
             "encoder.post_ln.weight": "vit.layernorm.weight", "encoder.post_ln.bias": "vit.layernorm.bias",
             "classifier.weight": "classifier.weight", "classifier.bias": "classifier.bias"}
    sub = {"ln1": "layernorm_before", "ln2": "layernorm_after", "attn.q_proj": "attention.attention.query",
           "attn.k_proj": "attention.attention.key", "attn.v_proj": "attention.attention.value",
           "attn.out_proj": "attention.output.dense", "mlp.fc1": "intermediate.dense", "mlp.fc2": "output.dense"}
    for i in range(cfg.num_hidden_layers):
        for port, hf in sub.items():
            for w in ("weight", "bias"):
                names[f"encoder.blocks.{i}.{port}.{w}"] = f"vit.encoder.layer.{i}.{hf}.{w}"
    load_params(model, loader, names, device=device, dtype=dtype)  # the loaders reshape [1, P, D] to [P, D]
    bias_name = "vit.embeddings.patch_embeddings.projection.bias"
    if bias_name in loader:
        pb = torch.from_numpy(np.array(loader.load(bias_name, (d,), np.float32))).to(device=device, dtype=dtype)
        emb.position_embedding.data[1:] += pb[None, :]
    return model

