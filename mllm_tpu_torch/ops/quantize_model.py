"""Whole-model post-training quantization: counterpart of
`mllm_tpu/ops/quantize_model.py` for the modes "int8", "int8-a8", "int4" and
"int4-mixed".

  - `fuse_projections`: q/k/v -> one `qkv_proj`, gate/up -> one `gateup_proj`.
  - `quantize_model`: every eligible `Linear` becomes a `QuantLinear` (int8,
    per out-channel), a `QuantLinearA8` (int8-a8: the same weights, int8
    activations on prefill-shaped calls) or an `Int4Linear` (int4, group 32,
    symmetric, canonical planar layout); in int4 mode a gated MLP becomes one
    `FusedInt4MLP`, and the tied-embedding head is quantized
    (`QuantEmbedHead` for int8 and int8-a8, `Int4EmbedHead`). A `MoEMLP`
    becomes a `QuantMoEMLP` (int8 expert stacks in every mode, "int4"
    included, as in the JAX package) and its shared expert is walked like
    any MLP. `attn_quant` overrides the mode inside attention blocks: mode
    "int4" with attn_quant "int8" is `-q int4-mixed` (attention projections
    int8, the rest int4), as in the JAX package; the loaders take
    "int4-mixed" by name (`MODES`), `quantize_model` only a Linear's mode.
  - `fused_mlp_shard`: rank r of tp's part of a `FusedInt4MLP` (tensor
    parallelism, `parallel/sharding.py`).

Unlike the JAX package, both work IN PLACE on the torch model (the float
weights are released as each layer is replaced) and return it. There is one
int4 layout (the canonical planar one of `prepare_int4`): no `MLLM_INT4_IMPL`
n-axis twin, no `INT4_MIN_PARAMS` int8 fallback for small projections (a
TPU launch-cost heuristic). `on_device=True` quantizes where the
weights are, with XLA's reciprocal scale rule (`_q8_device`, `_q4_device`);
otherwise the same quantizers run on the host with numpy's dividing rule.
Both give the same bytes as the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import Embedding, Int4Linear, Linear, QuantLinear, QuantLinearA8
from . import quant_matmul as qm
from .fused_mlp import _ACT, down_take_f, fit_block_f, fused_int4_mlp, pick_block_f, prepare_int4_ff

LINEAR_MODES = ("int8", "int8-a8", "int4")  # the modes of one Linear (`quantize_model`)
MODES = LINEAR_MODES + ("int4-mixed",)  # every mode of the JAX package's -q (the loaders)
MIXED = ("int4", "int8")  # -q int4-mixed: (mode, attn_quant)


def _not_ported(mode) -> NotImplementedError:
    return NotImplementedError(
        f"mllm_tpu_torch has no quantization mode {mode!r} (it ports every mode of the JAX "
        f"package: {', '.join(MODES)}): ROADMAP Queue 1 item 8")


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


def fused_mlp_shard(mlp: FusedInt4MLP, r: int, tp: int) -> FusedInt4MLP:
    """Rank r of tp's part of `mlp`: the hidden units [r F/tp, (r+1) F/tp),
    i.e. those columns of the gate and up operands and those rows of the
    block-planar down operands, re-laid in blocks of `fit_block_f(F / tp)`
    (the same nibbles, scales and zeros). Its output is the rank's f32 partial
    sum over its hidden units; it has no bias (the caller adds the whole
    MLP's after the sum over the ranks). Raises a ValueError where tp does
    not divide F or no block the CUDA kernel takes divides F / tp: the rank's
    MLP stays fused or is not built."""
    gate, up = mlp.gate_ops.astuple(), mlp.up_ops.astuple()
    ff = gate[0].shape[1]
    fr = ff // tp
    block_f = fit_block_f(fr) if ff % tp == 0 else None
    if block_f is None:
        raise ValueError(f"fused_mlp_shard: F = {ff} at tp {tp} leaves {ff / tp:g} hidden units a rank, which no "
                         "block of the fused int4 kernel (a multiple of 64) divides")
    cols = np.arange(r * fr, (r + 1) * fr)
    return FusedInt4MLP(Int4Operands(*qm.int4_take_n(*gate, cols)), Int4Operands(*qm.int4_take_n(*up, cols)),
                        Int4Operands(*down_take_f(mlp.down_ops.astuple(), mlp.block_f, r * fr, (r + 1) * fr,
                                                  block_f)), mlp.act, block_f)


def _q8_device(w: torch.Tensor):
    """`quantize_int8` where w lies, with the scales of XLA's reciprocal rule."""
    return qm.quantize_int8(w, recip=True)


def _q4_device(w: torch.Tensor, group: int = qm.GROUP):
    """`quantize_int4` where w lies, with the scales of XLA's reciprocal rule."""
    return qm.quantize_int4(w, group, recip=True)


def _on_host(quantize, w: torch.Tensor):
    """quantize(w) on an f32 CPU copy of w (numpy's dividing rule), the
    results moved back to w's device."""
    return tuple(t.to(w.device) for t in quantize(w.detach().float().cpu()))


def _planar_int4(w: torch.Tensor, on_device: bool):
    """float [N, K] -> symmetric planar (packed [K/2, N], scales [K/G, N])
    on w's device, quantized there or on the host."""
    return _q4_device(w) if on_device else _on_host(qm.quantize_int4, w)


def _bias(lin: Linear):
    return None if lin.bias is None else lin.bias.detach()


def int8_linear(w: torch.Tensor, bias, on_device: bool, a8: bool = False) -> QuantLinear:
    """QuantLinear (QuantLinearA8 with a8=True) of the float weight w [N, K]."""
    qv, sc = _q8_device(w) if on_device else _on_host(qm.quantize_int8, w)
    return (QuantLinearA8 if a8 else QuantLinear)(qv, sc, bias)


def int4_linear(w: torch.Tensor, bias, on_device: bool) -> Int4Linear:
    packed, scales, _ = qm.prepare_int4(*_planar_int4(w, on_device), qm.GROUP)
    return Int4Linear(packed.contiguous(), scales.contiguous(), qm.GROUP, None, bias)  # symmetric


def _eligible(w: torch.Tensor, min_size: int) -> bool:
    return w.numel() >= min_size and w.shape[-1] % 64 == 0


def _quant_linear(lin: Linear, mode: str, min_size: int, on_device: bool):
    if not _eligible(lin.weight, min_size):
        return lin
    if mode == "int4":
        return int4_linear(lin.weight, _bias(lin), on_device)
    return int8_linear(lin.weight, _bias(lin), on_device, a8=mode == "int8-a8")


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
    Attention modules: mode="int4", attn_quant="int8" is `-q int4-mixed`.
    Both take one Linear's mode (`LINEAR_MODES`). quant_embed_head quantizes the
    projection of a tied embedding. on_device=True quantizes with torch ops
    where the weights lie (the fast path for a model already on the card)."""
    from ..models.moe import MoEMLP, QuantMoEMLP
    from ..models.transformer import MLP, Attention

    for m in (mode, attn_quant):
        if m is not None and m not in LINEAR_MODES:
            check_mode(m)
            raise ValueError(f"quantize_model takes one Linear's mode {LINEAR_MODES}, not {m!r}: "
                             f"-q int4-mixed is mode={MIXED[0]!r}, attn_quant={MIXED[1]!r}")

    def moe(m):  # int8 per-(expert, out-channel) expert stacks
        return QuantMoEMLP.from_moe(m) if type(m) is MoEMLP and m.w_gate.numel() >= min_size else m

    def walk(mod, lin_mode):
        for name, child in list(mod.named_children()):
            if isinstance(child, Linear):
                setattr(mod, name, _quant_linear(child, lin_mode, min_size, on_device))
                continue
            if type(child) is MoEMLP:
                child = moe(child)
                setattr(mod, name, child)
            if mode == "int4" and type(child) is MLP:
                fused = _fuse_int4_mlp(child, min_size, on_device)
                if fused is not None:
                    setattr(mod, name, fused)
                    continue
            walk(child, attn_quant if attn_quant is not None and isinstance(child, Attention)
                 else lin_mode)

    model = moe(model)
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
