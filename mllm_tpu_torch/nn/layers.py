"""Core layers: the main-path subset of `mllm_tpu/nn/layers.py` in PyTorch.

Compute conventions, as in the JAX package:
  - matmuls take the activation dtype (bf16 on the card) with f32
    accumulation; a Linear adds its bias in f32 and rounds once;
  - normalisation and rotary embedding run in f32;
  - every constructor takes an explicit `device` and `dtype`.

Parameters do not require gradients: this slice is inference only.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def silu(x):
    return F.silu(x)


def gelu(x):
    return F.gelu(x)


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def relu(x):
    return F.relu(x)


ACT_FN: dict[str, Callable] = {
    "silu": silu,
    "gelu": gelu,
    "gelu_new": gelu_tanh,
    "gelu_pytorch_tanh": gelu_tanh,
    "relu": relu,
}


def _param(*shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, device=device, dtype=dtype), requires_grad=False)


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w.T accumulated in f32, with an f32 result (the JAX package's
    `dot_general(..., preferred_element_type=f32)`)."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return F.linear(x, w)
    if x.is_cuda:  # bf16 tensor cores, f32 output
        y = torch.mm(x.reshape(-1, x.shape[-1]), w.t(), out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[0])
    return F.linear(x.float(), w.float())


# ---------------------------------------------------------------------------
# Linear / Embedding
# ---------------------------------------------------------------------------


class Linear(nn.Module):
    """y = x @ W^T + b, weight stored [out, in] (HF convention)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, *,
                 device, dtype):
        super().__init__()
        self.weight = _param(out_features, in_features, device=device, dtype=dtype)
        self.bias = _param(out_features, device=device, dtype=dtype) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        """U(-1/sqrt(in), 1/sqrt(in)) for weight and bias (as `mllm_tpu` Linear.init)."""
        s = 1.0 / math.sqrt(self.weight.shape[1])
        self.weight.uniform_(-s, s, generator=generator)
        if self.bias is not None:
            self.bias.uniform_(-s, s, generator=generator)

    def forward(self, x):
        y = matmul_f32(x, self.weight)
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(x.dtype)


class Embedding(nn.Module):
    """Token embedding; `as_lm_head` is the tied lm_head with f32 logits."""

    def __init__(self, vocab_size: int, dim: int, *, device, dtype):
        super().__init__()
        self.weight = _param(vocab_size, dim, device=device, dtype=dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """N(0, 0.02^2) (as `mllm_tpu` Embedding.init)."""
        self.weight.normal_(0.0, 0.02, generator=generator)

    def forward(self, ids):
        return F.embedding(ids, self.weight)

    def as_lm_head(self, x):
        return matmul_f32(x, self.weight)


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------


class RMSNorm(nn.Module):
    """Root-mean-square norm, computed in f32."""

    def __init__(self, dim: int, eps: float = 1e-6, *, device, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype), requires_grad=False)
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        var = xf.pow(2).mean(dim=-1, keepdim=True)
        xf = xf * torch.rsqrt(var + self.eps)
        return (xf * self.weight.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE: numpy frequency helpers copied from mllm_tpu/nn/layers.py
# ---------------------------------------------------------------------------


def rope_inv_freq(head_dim: int, theta: float = 10000.0, partial: float = 1.0) -> np.ndarray:
    rot_dim = int(head_dim * partial)
    return 1.0 / (theta ** (np.arange(0, rot_dim, 2, dtype=np.float64) / rot_dim))


def llama3_scale_inv_freq(
    inv_freq: np.ndarray,
    factor: float = 8.0,
    low_freq_factor: float = 1.0,
    high_freq_factor: float = 4.0,
    original_max_position: int = 8192,
) -> np.ndarray:
    """LLaMA-3.1 frequency-dependent RoPE scaling."""
    low_freq_wavelen = original_max_position / low_freq_factor
    high_freq_wavelen = original_max_position / high_freq_factor
    wavelen = 2 * math.pi / inv_freq
    scaled = np.where(wavelen > low_freq_wavelen, inv_freq / factor, inv_freq)
    smooth = (original_max_position / wavelen - low_freq_factor) / (high_freq_factor - low_freq_factor)
    mid = (1 - smooth) * inv_freq / factor + smooth * inv_freq
    is_mid = (wavelen <= low_freq_wavelen) & (wavelen >= high_freq_wavelen)
    return np.where(is_mid, mid, scaled)


def ntk_scale_theta(theta: float, head_dim: int, factor: float) -> float:
    """Dynamic-NTK base scaling."""
    return theta * factor ** (head_dim / (head_dim - 2))


def yarn_scale(inv_freq: np.ndarray, rope_scaling: dict, max_position: int,
               theta: float, rot_dim: int) -> tuple[np.ndarray, float]:
    """YaRN frequency blending (HF _compute_yarn_parameters): high-frequency
    bands extrapolate (unscaled), low-frequency bands interpolate (/factor),
    with a linear ramp between beta_fast/beta_slow correction dims and
    sqrt-log attention temperature."""
    factor = float(rope_scaling.get("factor", 1.0))
    orig = rope_scaling.get("original_max_position_embeddings", max_position)
    beta_fast = float(rope_scaling.get("beta_fast", 32.0))
    beta_slow = float(rope_scaling.get("beta_slow", 1.0))

    def correction_dim(num_rot: float) -> float:
        return (rot_dim * math.log(orig / (num_rot * 2 * math.pi))) / (2 * math.log(theta))

    low = max(math.floor(correction_dim(beta_fast)), 0)
    high = min(math.ceil(correction_dim(beta_slow)), rot_dim // 2 - 1)
    ramp = np.clip((np.arange(rot_dim // 2, dtype=np.float64) - low) / max(high - low, 1e-3), 0, 1)
    extrap = 1.0 - ramp  # 1 for high-freq dims, 0 for low-freq dims
    out = (inv_freq / factor) * (1 - extrap) + inv_freq * extrap

    attn = rope_scaling.get("attention_factor")
    if attn is None:
        mscale = rope_scaling.get("mscale")
        def get_mscale(s, m=1.0):
            return 0.1 * m * math.log(s) + 1.0 if s > 1.0 else 1.0
        if mscale is not None:  # deepseek-yarn variant
            attn = get_mscale(factor, mscale) / get_mscale(
                factor, rope_scaling.get("mscale_all_dim", 0.0))
        else:
            attn = get_mscale(factor)
    return out, float(attn)


class RotaryEmbedding(nn.Module):
    """Precomputed f32 sin/cos tables [max_pos, rot_dim/2], applied by position.

    style='hf'    : GPT-NeoX half rotation (rotate_half)
    style='llama' : interleaved pairs (x[2i], x[2i+1])
    partial < 1 rotates the first rot_dim features only.
    """

    def __init__(self, sin: torch.Tensor, cos: torch.Tensor, style: str = "hf",
                 rot_dim: Optional[int] = None):
        super().__init__()
        self.register_buffer("sin", sin, persistent=False)
        self.register_buffer("cos", cos, persistent=False)
        self.style = style
        self.rot_dim = rot_dim if rot_dim is not None else 2 * sin.shape[-1]

    @staticmethod
    def make(
        head_dim: int,
        max_position: int = 32768,
        theta: float = 10000.0,
        style: str = "hf",
        partial: float = 1.0,
        rope_scaling: Optional[dict] = None,
        *,
        device,
        dtype=torch.float32,
    ) -> "RotaryEmbedding":
        inv = rope_inv_freq(head_dim, theta, partial)
        rot_dim = int(head_dim * partial) // 2 * 2
        attn_scale = 1.0
        if rope_scaling:
            typ = rope_scaling.get("rope_type", rope_scaling.get("type", ""))
            if typ == "llama3":
                inv = llama3_scale_inv_freq(
                    inv,
                    factor=rope_scaling.get("factor", 8.0),
                    low_freq_factor=rope_scaling.get("low_freq_factor", 1.0),
                    high_freq_factor=rope_scaling.get("high_freq_factor", 4.0),
                    original_max_position=rope_scaling.get("original_max_position_embeddings", 8192),
                )
            elif typ in ("dynamic", "ntk"):
                theta2 = ntk_scale_theta(theta, int(head_dim * partial), rope_scaling.get("factor", 1.0))
                inv = rope_inv_freq(head_dim, theta2, partial)
            elif typ == "linear":
                inv = inv / rope_scaling.get("factor", 1.0)
            elif typ == "yarn":
                inv, attn_scale = yarn_scale(inv, rope_scaling, max_position, theta, rot_dim)
            elif typ == "longrope":
                raise NotImplementedError(
                    "longrope (phi3) RoPE is not ported yet: ROADMAP Queue 1 item 3")
        t = np.arange(max_position, dtype=np.float64)
        freqs = np.outer(t, inv)  # [max_pos, rot/2]
        return RotaryEmbedding(
            torch.tensor(np.sin(freqs) * attn_scale, device=device, dtype=dtype),
            torch.tensor(np.cos(freqs) * attn_scale, device=device, dtype=dtype),
            style,
            rot_dim=rot_dim,
        )

    def forward(self, x, positions):
        """x: [..., S, H, D] (seq axis = -3); positions: int tensor broadcastable to [..., S]."""
        sin = self.sin[positions][..., None, :]  # [..., S, 1, rot/2]
        cos = self.cos[positions][..., None, :]
        return apply_rotary(x, sin, cos, self.style, self.rot_dim)


def apply_rotary(x, sin, cos, style: str = "hf", rot_dim: Optional[int] = None):
    """Apply rotary embedding in f32. sin/cos: [..., S, 1, rot/2] broadcast over heads."""
    d = x.shape[-1]
    rot_dim = rot_dim or d
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    xf = x_rot.float()
    sin = sin.float()
    cos = cos.float()
    if style == "hf":
        half = rot_dim // 2
        x1, x2 = xf[..., :half], xf[..., half:]
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    elif style == "llama":
        x1 = xf[..., 0::2]
        x2 = xf[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).reshape(xf.shape)
    else:
        raise ValueError(f"unknown rope style {style}")
    out = out.to(x.dtype)
    if rot_dim < d:
        out = torch.cat([out, x_pass], dim=-1)
    return out
