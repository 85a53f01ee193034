"""Core layers: the main-path subset of `mllm_tpu/nn/layers.py` in PyTorch.

Compute conventions, as in the JAX package:
  - matmuls take the activation dtype (bf16 on the card) with f32
    accumulation; a Linear adds its bias in f32 and rounds once;
  - normalisation and rotary embedding run in f32;
  - every constructor takes an explicit `device` and `dtype`.

Parameters are built frozen (requires_grad False), for inference;
`training.train.partition` turns gradients on for the ones a training step
updates.
Quantized layers hold their integer weights, scales and bias as buffers.
"""

from __future__ import annotations

import copy
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


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def relu(x):
    return F.relu(x)


def relu2(x):
    r = F.relu(x)
    return r * r


ACT_FN: dict[str, Callable] = {
    "silu": silu,
    "gelu": gelu,
    "gelu_new": gelu_tanh,
    "gelu_pytorch_tanh": gelu_tanh,
    "quick_gelu": quick_gelu,
    "relu": relu,
    "relu2": relu2,
    "relu^2": relu2,
}


def _param(*shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, device=device, dtype=dtype), requires_grad=False)


def shallow_copy(mod: nn.Module) -> nn.Module:
    """A new module object over the same tensors and submodules, whose
    attributes can be replaced without touching `mod`."""
    new = copy.copy(mod)
    new._modules = dict(mod._modules)
    new._parameters = dict(mod._parameters)
    new._buffers = dict(mod._buffers)
    return new


class _MatmulF32(torch.autograd.Function):
    """x2 [M, K] @ w.T on the card's bf16 tensor cores with an f32 result,
    differentiable (`torch.mm(..., out_dtype=)` has no derivative): the
    backward's products take the f32 gradient rounded to the operands'
    dtype, as autocast's do, and accumulate in f32."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.to(w.dtype)
        dx = torch.mm(g, w, out_dtype=torch.float32).to(x2.dtype) if ctx.needs_input_grad[0] else None
        dw = torch.mm(g.t(), x2, out_dtype=torch.float32).to(w.dtype) if ctx.needs_input_grad[1] else None
        return dx, dw


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w.T accumulated in f32, with an f32 result (the JAX package's
    `dot_general(..., preferred_element_type=f32)`)."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return F.linear(x, w)
    if x.is_cuda:  # bf16 tensor cores, f32 output
        x2 = x.reshape(-1, x.shape[-1])
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            y = _MatmulF32.apply(x2, w)
        else:
            y = torch.mm(x2, w.t(), out_dtype=torch.float32)
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

    @staticmethod
    def from_tensors(weight: torch.Tensor, bias: Optional[torch.Tensor] = None) -> "Linear":
        """A Linear holding `weight` [out, in] and `bias` [out] (not copied)."""
        lin = Linear(weight.shape[1], weight.shape[0], bias is not None, device="meta",
                     dtype=weight.dtype)
        lin.weight = nn.Parameter(weight, requires_grad=False)
        if bias is not None:
            lin.bias = nn.Parameter(bias, requires_grad=False)
        return lin

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


class QuantLinear(nn.Module):
    """Linear over int8 weights: values int8 [in, out] (k-major) and f32
    per-out-channel scales [out] (`mllm_tpu` nn/layers.py QuantLinear).
    The product runs `ops.quant_matmul.int8_matmul` (f32 out); the bias is
    added to it in f32 and the sum rounds once to x's dtype."""

    def __init__(self, qweight_t: torch.Tensor, scales: torch.Tensor,
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("qweight_t", qweight_t)
        self.register_buffer("scales", scales)
        self.register_buffer("bias", bias)

    def forward(self, x):
        from ..ops.quant_matmul import int8_matmul

        y = int8_matmul(x, self.qweight_t, self.scales)
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(x.dtype)


class QuantLinearA8(QuantLinear):
    """QuantLinear that quantizes the activations too when a call is
    prefill-shaped (W8A8; `mllm_tpu` nn/layers.py QuantLinearA8): m >= 16
    rows and a sequence longer than one token take `int8_matmul_a8`; every
    other call (decode steps, however many slots) takes the weight-only
    `int8_matmul` kernel. As in the JAX package, the sequence length is
    x.shape[-2] for a 3-D x and m for a 2-D one.

    The A8 product takes the weight's [N, K] copy, `qweight_nk` (a buffer
    outside the state dict, moved with the module), the layout
    `torch._int_mm` takes fastest; the [K, N] one stays for the decode
    kernel."""

    def __init__(self, qweight_t: torch.Tensor, scales: torch.Tensor,
                 bias: Optional[torch.Tensor] = None):
        super().__init__(qweight_t, scales, bias)
        self.register_buffer("qweight_nk", qweight_t.t().contiguous(), persistent=False)

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        self.qweight_nk = self.qweight_t.t().contiguous()

    @staticmethod
    def takes_a8(x) -> bool:
        """Whether a call on x is prefill-shaped (the W8A8 product)."""
        m = x.numel() // x.shape[-1]
        return m >= 16 and (x.shape[-2] if x.dim() >= 3 else m) > 1

    def forward(self, x):
        from ..ops.quant_matmul import int8_matmul, int8_matmul_a8

        if self.takes_a8(x):
            y = int8_matmul_a8(x, self.qweight_nk, self.scales)
        else:
            y = int8_matmul(x, self.qweight_t, self.scales)
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(x.dtype)


class Int4Linear(nn.Module):
    """Linear over int4 group-quantized weights in the canonical planar layout
    of `ops.quant_matmul.prepare_int4` (`mllm_tpu` nn/layers.py Int4Linear):
    packed_t uint8 [khp, out], scales_t (and zeros_t, None when symmetric)
    f32 [2*khp/G, out]. Decode shapes run the int4 kernel, prefill dequantizes
    and runs one matmul (`int4_matmul`); the bias is added in f32 and the sum
    rounds once to x's dtype."""

    def __init__(self, packed_t: torch.Tensor, scales_t: torch.Tensor, group: int = 32,
                 zeros_t: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("packed_t", packed_t)
        self.register_buffer("scales_t", scales_t)
        self.register_buffer("zeros_t", zeros_t)
        self.register_buffer("bias", bias)
        self.group = group

    def forward(self, x):
        from ..ops.quant_matmul import int4_matmul

        y = int4_matmul(x, self.packed_t, self.scales_t, self.group, self.zeros_t)
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


class ElasticLinear(nn.Module):
    """Width-elastic linear (`mllm_tpu` ElasticLinear, the reference's
    ElasticLinear): a call uses only the first int(out * out_ratio) output and
    int(in * in_ratio) input features of weight [out, in]; f32 accumulation,
    the bias added in f32, one rounding to x's dtype."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.weight = nn.Parameter(weight, requires_grad=False)
        self.bias = None if bias is None else nn.Parameter(bias, requires_grad=False)

    def forward(self, x, out_ratio: float = 1.0, in_ratio: float = 1.0):
        o, i = self.weight.shape
        oa, ia = max(1, int(o * out_ratio)), max(1, int(i * in_ratio))
        y = matmul_f32(x[..., :ia], self.weight[:oa, :ia])
        if self.bias is not None:
            y = y + self.bias[:oa].float()
        return y.to(x.dtype)


class PredictorSparseMLP(nn.Module):
    """PowerInfer-style predictor-gated FFN (`mllm_tpu` PredictorSparseMLP):
    a low-rank predictor (pred_down [r, in], pred_up [ff, r], f32 products)
    scores the FFN neurons of each token, and the neurons scoring at most
    `threshold` are masked to exactly zero. Dense compute, then the mask on
    act(gate) * up before down, as the JAX package computes it."""

    def __init__(self, pred_down: torch.Tensor, pred_up: torch.Tensor, gate_proj, up_proj, down_proj,
                 act: str = "relu", threshold: float = 0.0):
        super().__init__()
        self.pred_down = nn.Parameter(pred_down, requires_grad=False)
        self.pred_up = nn.Parameter(pred_up, requires_grad=False)
        self.gate_proj, self.up_proj, self.down_proj = gate_proj, up_proj, down_proj
        self.act = act
        self.threshold = threshold

    def neuron_scores(self, x):
        """f32 [..., ff]: (x @ pred_down^T) @ pred_up^T in f32."""
        return F.linear(F.linear(x.float(), self.pred_down.float()), self.pred_up.float())

    def forward(self, x):
        mask = (self.neuron_scores(x) > self.threshold).to(x.dtype)
        h = ACT_FN[self.act](self.gate_proj(x))
        if self.up_proj is not None:
            h = h * self.up_proj(x)
        return self.down_proj(h * mask)


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------


class RMSNorm(nn.Module):
    """Root-mean-square norm, computed in f32. `add_unit_offset` scales by
    (1 + w), Gemma's convention."""

    def __init__(self, dim: int, eps: float = 1e-6, add_unit_offset: bool = False, *, device, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype), requires_grad=False)
        self.eps = eps
        self.add_unit_offset = add_unit_offset

    def forward(self, x):
        xf = x.float()
        var = xf.pow(2).mean(dim=-1, keepdim=True)
        xf = xf * torch.rsqrt(var + self.eps)
        w = self.weight.float()
        if self.add_unit_offset:
            w = 1.0 + w
        return (xf * w).to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm in f32 (biased variance), optional bias (`mllm_tpu` LayerNorm)."""

    def __init__(self, dim: int, eps: float = 1e-5, bias: bool = True, *, device, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype), requires_grad=False)
        self.bias = (nn.Parameter(torch.zeros(dim, device=device, dtype=dtype), requires_grad=False)
                     if bias else None)
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).pow(2).mean(dim=-1, keepdim=True)
        xf = (xf - mean) * torch.rsqrt(var + self.eps)
        xf = xf * self.weight.float()
        if self.bias is not None:
            xf = xf + self.bias.float()
        return xf.to(x.dtype)


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


def longrope_scale(inv_freq: np.ndarray, rope_scaling: dict, max_position: int,
                   theta: float, which: str = "auto") -> tuple[np.ndarray, float]:
    """Phi-3 LongRope: per-frequency long or short rescale factors and the
    attention factor (HF _compute_longrope_parameters). Returns (inv_freq,
    attention_factor). which: "short" | "long" | "auto" (long when
    max_position exceeds the original window); the attention factor is the
    same for both branches."""
    orig = rope_scaling.get("original_max_position_embeddings", max_position)
    if which == "auto":
        which = "long" if max_position > orig else "short"
    ext = rope_scaling.get(f"{which}_factor")
    if ext is not None:
        ext = np.asarray(ext, np.float64)
        inv_freq = inv_freq / ext
    scale = max_position / orig
    attn = rope_scaling.get("attention_factor")
    if attn is None:
        attn = math.sqrt(1 + math.log(scale) / math.log(orig)) if scale > 1.0 else 1.0
    return inv_freq, float(attn)


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
                orig = rope_scaling.get("original_max_position_embeddings", max_position)
                if rope_scaling.get("short_factor") is not None and max_position > orig:
                    # both branches reachable: both tables, chosen per call
                    inv_s, attn_scale = longrope_scale(inv, rope_scaling, max_position, theta, "short")
                    inv_l, _ = longrope_scale(inv, rope_scaling, max_position, theta, "long")
                    t = np.arange(max_position, dtype=np.float64)
                    fs, fl = np.outer(t, inv_s), np.outer(t, inv_l)

                    def tab(a):
                        return torch.tensor(a * attn_scale, device=device, dtype=dtype)

                    return LongRopeEmbedding(tab(np.sin(fs)), tab(np.cos(fs)), tab(np.sin(fl)),
                                             tab(np.cos(fl)), int(orig), style, rot_dim=rot_dim)
                inv, attn_scale = longrope_scale(inv, rope_scaling, max_position, theta)
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


class LongRopeEmbedding(nn.Module):
    """Phi-3 LongRope with the long / short choice made per call, as HF and
    the reference make it: LONG factors when the largest position + 1 exceeds
    the original window, else SHORT (`mllm_tpu` LongRopeEmbedding). Both
    tables are kept; the choice is a `torch.where` on the device, so no host
    read and a captured step stays valid at every position."""

    def __init__(self, sin_short, cos_short, sin_long, cos_long, original_max_position: int,
                 style: str = "hf", rot_dim: Optional[int] = None):
        super().__init__()
        for name, t in (("sin", sin_short), ("cos", cos_short), ("sin_long", sin_long),
                        ("cos_long", cos_long)):
            self.register_buffer(name, t, persistent=False)
        self.original_max_position = original_max_position
        self.style = style
        self.rot_dim = rot_dim if rot_dim is not None else 2 * sin_short.shape[-1]

    def forward(self, x, positions):
        use_long = (positions.max() + 1) > self.original_max_position  # a device bool
        sin = torch.where(use_long, self.sin_long[positions], self.sin[positions])[..., None, :]
        cos = torch.where(use_long, self.cos_long[positions], self.cos[positions])[..., None, :]
        return apply_rotary(x, sin, cos, self.style, self.rot_dim)


class IRotaryEmbedding(nn.Module):
    """int8 sin/cos tables, round(v * 127), dequantized by 1/127 at apply time
    (the reference's IRoPE, PhoneLM; `mllm_tpu` IRotaryEmbedding). `sin` and
    `cos` are the int8 tables."""

    def __init__(self, sin_q: torch.Tensor, cos_q: torch.Tensor, style: str = "hf",
                 rot_dim: Optional[int] = None):
        super().__init__()
        self.register_buffer("sin", sin_q, persistent=False)
        self.register_buffer("cos", cos_q, persistent=False)
        self.style = style
        self.rot_dim = rot_dim if rot_dim is not None else 2 * sin_q.shape[-1]

    @staticmethod
    def make(head_dim: int, max_position: int = 32768, theta: float = 10000.0, style: str = "hf",
             partial: float = 1.0, *, device) -> "IRotaryEmbedding":
        freqs = np.outer(np.arange(max_position, dtype=np.float64), rope_inv_freq(head_dim, theta, partial))
        sq = np.clip(np.round(np.sin(freqs) * 127.0), -127, 127).astype(np.int8)
        cq = np.clip(np.round(np.cos(freqs) * 127.0), -127, 127).astype(np.int8)
        return IRotaryEmbedding(torch.from_numpy(sq).to(device), torch.from_numpy(cq).to(device), style,
                                rot_dim=int(head_dim * partial) // 2 * 2)

    def forward(self, x, positions):
        inv127 = np.float32(1.0 / 127.0).item()  # the f32 constant JAX multiplies by
        sin = self.sin[positions][..., None, :].float() * inv127
        cos = self.cos[positions][..., None, :].float() * inv127
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


# ---------------------------------------------------------------------------
# Vision-language: M-RoPE, the vision rotary, masks, convolutions
# ---------------------------------------------------------------------------


class MultimodalRotaryEmbedding(nn.Module):
    """Qwen2-VL M-RoPE (`mllm_tpu` MultimodalRotaryEmbedding): positions
    [3, B, S] on three axes (temporal, height, width); the first
    mrope_section[0] frequencies of the half rotation take axis 0's position,
    the next mrope_section[1] axis 1's, the rest axis 2's. f32 sin/cos tables
    [max_pos, head_dim/2]; positions outside the table clamp to its ends (only
    idle slots of a serving window reach them)."""

    def __init__(self, sin: torch.Tensor, cos: torch.Tensor, mrope_section):
        super().__init__()
        self.register_buffer("sin", sin, persistent=False)
        self.register_buffer("cos", cos, persistent=False)
        self.mrope_section = tuple(int(s) for s in mrope_section)

    @staticmethod
    def make(head_dim: int, max_position: int, theta: float, mrope_section, *, device,
             dtype=torch.float32) -> "MultimodalRotaryEmbedding":
        freqs = np.outer(np.arange(max_position, dtype=np.float64), rope_inv_freq(head_dim, theta))
        return MultimodalRotaryEmbedding(torch.tensor(np.sin(freqs), device=device, dtype=dtype),
                                         torch.tensor(np.cos(freqs), device=device, dtype=dtype), mrope_section)

    def _gather(self, table: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """[3, B, S] positions -> [B, S, rot/2]: each section from its axis."""
        positions = positions.clamp(0, table.shape[0] - 1)
        chunks, start = [], 0
        for ax, sec in enumerate(self.mrope_section):
            chunks.append(table[:, start : start + sec][positions[ax]])
            start += sec
        return torch.cat(chunks, dim=-1)

    def forward(self, x, positions):
        """x: [B, S, H, D]; positions: int [3, B, S] (or [3, 1, S])."""
        sin = self._gather(self.sin, positions)[..., None, :]
        cos = self._gather(self.cos, positions)[..., None, :]
        return apply_rotary(x, sin, cos, "hf")


class VisionRotaryEmbedding(nn.Module):
    """Qwen2-VL's vision rotary over the (h, w) patch grid (`mllm_tpu`
    VisionRotaryEmbedding): inv_freq [head_dim/4] for each spatial axis."""

    def __init__(self, inv_freq: torch.Tensor):
        super().__init__()
        self.register_buffer("inv_freq", inv_freq, persistent=False)

    @staticmethod
    def make(head_dim: int, theta: float = 10000.0, *, device, dtype=torch.float32) -> "VisionRotaryEmbedding":
        dim = head_dim // 2
        inv = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
        return VisionRotaryEmbedding(torch.tensor(inv, device=device, dtype=dtype))

    def freqs(self, grid_hw) -> torch.Tensor:
        """grid positions [S, 2] (h_idx, w_idx) -> rotary freqs [S, head_dim/2]."""
        hw = torch.as_tensor(np.asarray(grid_hw), device=self.inv_freq.device).float()
        return torch.cat([hw[:, :1] * self.inv_freq[None, :], hw[:, 1:2] * self.inv_freq[None, :]], dim=-1)


NEG_INF = -1e30  # large-but-finite: a fully masked row stays finite


def causal_mask_bias(q_len: int, kv_len: int, q_offset, dtype=torch.float32, window: Optional[int] = None,
                     device=None) -> torch.Tensor:
    """Additive attention bias [q_len, kv_len] (`mllm_tpu` causal_mask_bias):
    0 where key j <= q_offset + i (and j > q_offset + i - window), else NEG_INF."""
    q_pos = q_offset + torch.arange(q_len, device=device)[:, None]
    k_pos = torch.arange(kv_len, device=device)[None, :]
    ok = k_pos <= q_pos
    if window is not None:
        ok = ok & (k_pos > q_pos - window)
    return torch.where(ok, 0.0, NEG_INF).to(dtype)


def softmax_f32(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.softmax(x.float(), dim=dim)


class Conv2d(nn.Module):
    """NHWC convolution, VALID padding, weight [out, in, kh, kw] (torch
    layout), computed in f32 and rounded once to x's dtype (`mllm_tpu` Conv2d)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: tuple, stride: tuple, bias: bool = True, *,
                 device, dtype):
        super().__init__()
        self.weight = _param(out_channels, in_channels, *kernel, device=device, dtype=dtype)
        self.bias = _param(out_channels, device=device, dtype=dtype) if bias else None
        self.stride = tuple(stride)

    def forward(self, x):  # [B, H, W, C]
        y = F.conv2d(x.permute(0, 3, 1, 2).float(), self.weight.float(),
                     None if self.bias is None else self.bias.float(), stride=self.stride)
        return y.permute(0, 2, 3, 1).to(x.dtype)


class Conv3d(nn.Module):
    """The 3-D patch-embed convolution (stride == kernel) as one product over
    the pre-unfolded patch matrix [N, in*kt*kh*kw] (`mllm_tpu` Conv3d); weight
    [out, in, kt, kh, kw]."""

    def __init__(self, in_channels: int, out_channels: int, kernel: tuple, bias: bool = True, *, device, dtype):
        super().__init__()
        self.weight = _param(out_channels, in_channels, *kernel, device=device, dtype=dtype)
        self.bias = _param(out_channels, device=device, dtype=dtype) if bias else None
        self.kernel = tuple(kernel)

    def forward(self, patches):
        y = matmul_f32(patches, self.weight.reshape(self.weight.shape[0], -1))
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(patches.dtype)
