"""Whole-model post-training quantization: counterpart of
`mllm_tpu/ops/quantize_model.py` for the modes "int8" and "int4".

  - `fuse_projections`: q/k/v -> one `qkv_proj`, gate/up -> one `gateup_proj`.
  - `quantize_model`: every eligible `Linear` becomes a `QuantLinear` (int8,
    per out-channel) or an `Int4Linear` (int4, group 32, symmetric, canonical
    planar layout); in int4 mode a gated MLP becomes one `FusedInt4MLP`, and
    the tied-embedding head is quantized (`QuantEmbedHead`, `Int4EmbedHead`).

Unlike the JAX package, both work IN PLACE on the torch model (the float
weights are released as each layer is replaced) and return it. There is one
int4 layout (the canonical planar one of `prepare_int4`): no `MLLM_INT4_IMPL`
n-axis twin, no `INT4_MIN_PARAMS` int8 fallback for small projections, no
int4-mixed heuristic. `on_device=True` quantizes with torch ops where the
weights are (`_q8_device`, `_q4_device`); otherwise the numpy packers run on
the host. Both give the same bytes as the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import Embedding, Int4Linear, Linear, QuantLinear
from . import quant_matmul as qm
from .fused_mlp import _ACT, fused_int4_mlp, pick_block_f, prepare_int4_ff

MODES = ("int8", "int4")


def _not_ported(mode) -> NotImplementedError:
    return NotImplementedError(
        f"mllm_tpu_torch does not port quantization mode {mode!r} yet (it ports "
        f"{', '.join(MODES)}): ROADMAP Queue 1 item 8")


def check_mode(mode) -> None:
    if mode not in MODES:
        raise _not_ported(mode)


class QuantEmbedHead(nn.Module):
    """Tied-embedding lm_head with int8 weights for the projection (the
    lookup stays on the float table). `mllm_tpu` QuantEmbedHead."""

    def __init__(self, embedding: Embedding, qweight_t: torch.Tensor, scales: torch.Tensor):
        super().__init__()
        self.embedding = embedding
        self.register_buffer("qweight_t", qweight_t)  # int8 [D, V]
        self.register_buffer("scales", scales)  # f32 [V]

    def forward(self, ids):
        return self.embedding(ids)

    @property
    def weight(self):
        return self.embedding.weight

    def as_lm_head(self, x):
        return qm.int8_matmul(x, self.qweight_t, self.scales)


class Int4EmbedHead(nn.Module):
    """Tied-embedding lm_head on the int4 kernel: `mllm_tpu`
    Int4EmbedHeadPallas. The vocab axis is zero-padded to a multiple of 512
    (zero weights dequantize to exactly 0 in the excess-8 layout) and the
    padded logits are sliced off. As there, `proj` rounds the logits to the
    model's dtype. The lookup stays on the float table."""

    def __init__(self, embedding: Embedding, proj: Int4Linear, vocab: int):
        super().__init__()
        self.embedding = embedding
        self.proj = proj
        self.vocab = vocab

    def forward(self, ids):
        return self.embedding(ids)

    @property
    def weight(self):
        return self.embedding.weight

    def as_lm_head(self, x):
        return self.proj(x)[..., : self.vocab]


class Int4Operands(nn.Module):
    """The (packed, scales, zeros) operands of one int4 weight, as buffers
    named "0", "1", "2" like the JAX tuple's parameters; "2" (zeros) is None
    for symmetric weights."""

    def __init__(self, packed: torch.Tensor, scales: torch.Tensor, zeros=None):
        super().__init__()
        for i, t in enumerate((packed, scales, zeros)):
            self.register_buffer(str(i), t)

    def astuple(self) -> tuple:
        return tuple(self._buffers[str(i)] for i in range(3))


class FusedInt4MLP(nn.Module):
    """Gated MLP run by the fused int4 kernel (`ops/fused_mlp.py`); made by
    quantize_model(mode="int4") for a gated MLP with a supported activation.
    `mllm_tpu` FusedInt4MLP."""

    def __init__(self, gate_ops: Int4Operands, up_ops: Int4Operands, down_ops: Int4Operands,
                 act: str, block_f: int, bias=None):
        super().__init__()
        self.gate_ops = gate_ops
        self.up_ops = up_ops
        self.down_ops = down_ops
        self.register_buffer("bias", bias)  # down_proj bias (rare)
        self.act = act
        self.block_f = block_f

    def forward(self, x):
        y = fused_int4_mlp(x, self.gate_ops.astuple(), self.up_ops.astuple(),
                           self.down_ops.astuple(), act=self.act, block_f=self.block_f)
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(x.dtype)


# XLA compiles the JAX quantizers' `amax / 127.0` and `amax / 7.0` (division by
# a constant) to a multiplication by the f32 reciprocal; the on-device
# quantizers below do the same, so their scales have the JAX package's bits.
# (The numpy packers divide, as numpy does there.)
_RECIP_127 = 1.0 / 127.0
_RECIP_7 = 1.0 / 7.0


@torch.no_grad()
def _q8_device(w: torch.Tensor):
    """Per-out-channel symmetric int8 where w lies: float [..., N, K] ->
    (int8 [..., K, N], scales f32 [..., N])."""
    wf = w.float()
    amax = wf.abs().amax(dim=-1)
    sc = torch.where(amax > 0, amax * _RECIP_127, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / sc[..., None]), -127, 127).to(torch.int8)
    return q.transpose(-1, -2).contiguous(), sc


@torch.no_grad()
def _q4_device(w: torch.Tensor, group: int = qm.GROUP):
    """Symmetric group int4 planar pack where w lies: float [..., N, K] ->
    (packed uint8 [..., K/2, N] signed nibbles, scales f32 [..., K/G, N])."""
    n, k = w.shape[-2], w.shape[-1]
    lead = w.shape[:-2]
    wg = w.float().reshape(*lead, n, k // group, group)
    amax = wg.abs().amax(dim=-1)
    sc = torch.where(amax > 0, amax * _RECIP_7, torch.ones_like(amax))
    v = torch.clamp(torch.round(wg / sc[..., None]), -8, 7).to(torch.int8).reshape(*lead, n, k)
    vt = v.transpose(-1, -2)  # [..., K, N]
    lo = (vt[..., : k // 2, :] & 0x0F).to(torch.uint8)
    hi = (vt[..., k // 2 :, :] & 0x0F).to(torch.uint8)
    return (lo | (hi << 4)).contiguous(), sc.transpose(-1, -2).contiguous()


def _host_f32(w: torch.Tensor) -> np.ndarray:
    return w.detach().float().cpu().numpy()


def _planar_int4(w: torch.Tensor, on_device: bool):
    """float [N, K] -> symmetric planar (packed [K/2, N], scales [K/G, N])
    on w's device, by `_q4_device` or by the numpy packer."""
    if on_device:
        return _q4_device(w)
    p, s = qm.repack_float_to_int4(_host_f32(w), qm.GROUP)
    return torch.from_numpy(p).to(w.device), torch.from_numpy(s).to(w.device)


def _bias(lin: Linear):
    return None if lin.bias is None else lin.bias.detach()


def int8_linear(w: torch.Tensor, bias, on_device: bool) -> QuantLinear:
    if on_device:
        qv, sc = _q8_device(w)
    else:
        q_np, s_np = qm.repack_float_to_int8(_host_f32(w))
        qv, sc = torch.from_numpy(q_np).to(w.device), torch.from_numpy(s_np).to(w.device)
    return QuantLinear(qv, sc, bias)


def int4_linear(w: torch.Tensor, bias, on_device: bool) -> Int4Linear:
    packed, scales, _ = qm.prepare_int4(*_planar_int4(w, on_device), qm.GROUP)
    return Int4Linear(packed.contiguous(), scales.contiguous(), qm.GROUP, None, bias)  # symmetric


def _eligible(w: torch.Tensor, min_size: int) -> bool:
    return w.numel() >= min_size and w.shape[-1] % 64 == 0


def _quant_linear(lin: Linear, mode: str, min_size: int, on_device: bool):
    if not _eligible(lin.weight, min_size):
        return lin
    make = int8_linear if mode == "int8" else int4_linear
    return make(lin.weight, _bias(lin), on_device)


def _fuse_int4_mlp(mlp, min_size: int, on_device: bool):
    """MLP -> FusedInt4MLP when eligible, else None."""
    if mlp.act not in _ACT:
        return None
    if mlp.gateup_proj is not None:
        # fuse_projections merged gate||up into one Linear; split it back:
        # per-out-channel group quantization commutes with output-channel
        # concatenation, so quantizing the halves is exact vs the fused form
        gu = mlp.gateup_proj
        if type(gu) is not Linear or gu.bias is not None:
            return None
        ff_half = gu.weight.shape[-2] // 2
        gate_w, up_w = gu.weight[:ff_half], gu.weight[ff_half:]
    else:
        if any(type(l) is not Linear or l.bias is not None for l in (mlp.gate_proj, mlp.up_proj)):
            return None
        gate_w, up_w = mlp.gate_proj.weight, mlp.up_proj.weight
    down = mlp.down_proj
    if type(down) is not Linear:
        return None
    if not all(_eligible(w, min_size) for w in (gate_w, up_w, down.weight)):
        return None
    ff, d = gate_w.shape
    block_f = pick_block_f(ff)
    if block_f is None or d % 64 or ff % 64:
        return None

    # quantized from float: symmetric, so zeros == -8 * scales identically and
    # are not stored (the kernel's zeros-elided variant)
    def ops_over_d(w):
        p, s, _ = qm.prepare_int4(*_planar_int4(w, on_device), qm.GROUP)
        return Int4Operands(p.contiguous(), s.contiguous())

    dp, dsc, _ = prepare_int4_ff(*_planar_int4(down.weight, on_device), None, block_f)
    return FusedInt4MLP(ops_over_d(gate_w), ops_over_d(up_w),
                        Int4Operands(dp.contiguous(), dsc.contiguous()), mlp.act, block_f,
                        bias=_bias(down))


@torch.no_grad()
def fuse_projections(model):
    """Fuse q/k/v -> one `qkv_proj` and gate/up -> one `gateup_proj`, in
    place; returns the model.

    Exactness-preserving: per-output-channel quantization commutes with
    output-channel concatenation, so fuse-then-quantize == quantize on the
    split projections. It cuts launches per decoder layer from 7 to 4. Call
    BEFORE quantize_model."""
    from ..models.transformer import MLP, Attention

    def fuse(lins):
        w = torch.cat([l.weight for l in lins], dim=0)
        if all(l.bias is None for l in lins):
            b = None
        else:
            b = torch.cat([l.bias if l.bias is not None
                           else torch.zeros(l.weight.shape[0], dtype=l.weight.dtype,
                                            device=l.weight.device) for l in lins])
        return Linear.from_tensors(w, b)

    for mod in model.modules():
        if isinstance(mod, Attention) and mod.qkv_proj is None and all(
                type(p) is Linear for p in (mod.q_proj, mod.k_proj, mod.v_proj)):
            mod.qkv_proj = fuse([mod.q_proj, mod.k_proj, mod.v_proj])
            mod.q_proj = mod.k_proj = mod.v_proj = None
        elif isinstance(mod, MLP) and mod.gateup_proj is None and all(
                type(p) is Linear for p in (mod.gate_proj, mod.up_proj)):
            mod.gateup_proj = fuse([mod.gate_proj, mod.up_proj])
            mod.gate_proj = mod.up_proj = None
    return model


@torch.no_grad()
def quantize_model(model, mode: str = "int8", min_size: int = 1 << 16,
                   quant_embed_head: bool = True, on_device: bool = False,
                   attn_quant: str | None = None):
    """Quantize the big Linears of `model` in place; returns the model.

    min_size: Linears with fewer weights (or an in-width not a multiple of
    64) stay float. attn_quant overrides `mode` for the Linears inside
    Attention modules. quant_embed_head quantizes the projection of a tied
    embedding. on_device=True quantizes with torch ops where the weights lie
    (the fast path for a model already on the card)."""
    from ..models.transformer import MLP, Attention

    check_mode(mode)
    if attn_quant is not None:
        check_mode(attn_quant)

    def walk(mod, lin_mode):
        for name, child in list(mod.named_children()):
            if isinstance(child, Linear):
                setattr(mod, name, _quant_linear(child, lin_mode, min_size, on_device))
                continue
            if mode == "int4" and type(child) is MLP:
                fused = _fuse_int4_mlp(child, min_size, on_device)
                if fused is not None:
                    setattr(mod, name, fused)
                    continue
            walk(child, attn_quant if attn_quant is not None and isinstance(child, Attention)
                 else lin_mode)

    walk(model, mode)
    emb = getattr(model, "embed_tokens", None)
    if quant_embed_head and getattr(model, "lm_head", 1) is None and isinstance(emb, Embedding):
        if mode == "int4":
            v = emb.weight.shape[0]
            vp = -(-v // 512) * 512
            wp = F.pad(emb.weight, (0, 0, 0, vp - v))
            proj = int4_linear(wp, None, on_device)
            model.embed_tokens = Int4EmbedHead(emb, proj, v)
        else:
            head = int8_linear(emb.weight, None, on_device)
            model.embed_tokens = QuantEmbedHead(emb, head.qweight_t, head.scales)
    return model
