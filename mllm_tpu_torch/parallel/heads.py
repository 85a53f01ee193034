"""Head padding / GQA expansion for tensor parallelism: counterpart of
`mllm_tpu/parallel/heads.py`.

A GQA geometry whose head counts do not divide tp (Qwen2-VL-2B's 12 q / 2 kv
heads on tp=8) is rewritten exactly:
  - kv heads expand to tp by repeating each head r = tp / hkv times (GQA is
    invariant under kv-head repetition);
  - q heads are regrouped so each expanded kv head owns a contiguous block of
    qpg = ceil(h / hkv / r) q heads, padded with zero q rows where groups are
    ragged; a zero q row attends uniformly, but its o_proj columns are zero,
    so the output is unchanged;
  - o_proj's input columns are permuted and padded to match.
The projections may be float, int8 or int4 (the canonical planar layout: an
output-channel gather, or for o_proj's inputs a gather in natural k order
laid out anew, `ops.quant_matmul.int4_take_n` / `int4_take_k`; a pad head's
channels get zero nibbles, scales and zeros, which dequantize to exactly 0).
After it every head axis divides tp, so `sharding.shard_model` cuts the KV
cache and the four projections with nothing replicated. No collective.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from ..nn.layers import Int4Linear, Linear, QuantLinear, shallow_copy
from ..ops.quant_matmul import int4_take_k, int4_take_n


def tp_head_plan(h: int, hkv: int, tp: int):
    """(q_index [h'], kv_index [hkv'], h', hkv'), or None when no transform
    is needed or none applies (the caller then replicates the axes that do
    not divide). q_index[i] is the original q head of new head i, or -1 for a
    zero pad; kv_index[j] the original kv head of new kv head j, or -1 for a
    zero kv head."""
    if (h % tp == 0 and hkv % tp == 0) or h % hkv != 0:
        return None
    gq = h // hkv  # q heads per original kv head
    if hkv < tp and tp % hkv == 0:
        # GQA expansion: repeat each kv head r times, regroup and zero-pad q
        r = tp // hkv
        qpg = math.ceil(gq / r)
        q_index = []
        for g in range(hkv):
            for j in range(r):
                for t in range(qpg):
                    k = j * qpg + t
                    q_index.append(g * gq + k if k < gq else -1)
        kv_index = [g for g in range(hkv) for _ in range(r)]
        return np.asarray(q_index), np.asarray(kv_index), hkv * r * qpg, tp
    if hkv >= tp:
        # MHA / wide GQA: zero-pad kv heads to the next multiple of tp, keeping
        # the q-per-kv group size; pad groups are all -1
        hkv2 = math.ceil(hkv / tp) * tp
        kv_index = list(range(hkv)) + [-1] * (hkv2 - hkv)
        q_index = [g * gq + t if g < hkv else -1 for g in range(hkv2) for t in range(gq)]
        return np.asarray(q_index), np.asarray(kv_index), hkv2 * gq, hkv2
    # e.g. hkv=3, tp=8: no exact uniform expansion, replicate instead
    warnings.warn(f"tp_head_plan: no exact head expansion for h={h} hkv={hkv} tp={tp}; "
                  "falling back to replicated KV")
    return None


def _take_heads(x, index, hd: int, axis: int):
    """Gather head blocks (size hd) along `axis`; index -1 gives zeros."""
    if x is None:
        return None
    axis = axis % x.dim()
    xm = x.movedim(axis, 0)
    rest = xm.shape[1:]
    blocks = xm.reshape(x.shape[axis] // hd, hd, *rest)
    idx = torch.as_tensor(np.maximum(index, 0), device=x.device)
    g = blocks[idx]  # [n_new, hd, ...]
    keep = torch.as_tensor(np.asarray(index) >= 0, device=x.device).reshape(-1, *([1] * (g.dim() - 1)))
    g = torch.where(keep, g, torch.zeros((), dtype=g.dtype, device=g.device))
    return g.reshape(len(index) * hd, *rest).movedim(0, axis).contiguous()


def _channels(index, hd: int) -> np.ndarray:
    """Head index (-1: a zero head) -> channel index (-1: a zero channel)."""
    index = np.asarray(index)
    ch = index[:, None] * hd + np.arange(hd)
    return np.where(index[:, None] < 0, -1, ch).reshape(-1)


def _map_linear(lin, index, hd: int, *, rows: bool, k: int = 0):
    """The head gather on a Linear, QuantLinear or Int4Linear. rows=True:
    output channels (q/k/v: Linear.weight axis 0, QuantLinear.qweight_t axis
    1, Int4Linear's n axis; scales and bias per row); rows=False: input
    channels (o_proj over k inputs: weight axis 1, qweight_t axis 0, the int4
    operands re-laid over the new K, their group scales gathered with their
    channels, which must move in whole groups; scales and bias untouched
    otherwise)."""
    if type(lin) is Linear:
        w = _take_heads(lin.weight, index, hd, 0 if rows else 1)
        b = _take_heads(lin.bias, index, hd, 0) if (rows and lin.bias is not None) else lin.bias
        return Linear.from_tensors(w, b)
    if isinstance(lin, QuantLinear):  # QuantLinearA8 keeps its type (same fields)
        qw = _take_heads(lin.qweight_t, index, hd, 1 if rows else 0)
        sc = _take_heads(lin.scales, index, hd, 0) if rows else lin.scales
        b = _take_heads(lin.bias, index, hd, 0) if (rows and lin.bias is not None) else lin.bias
        return type(lin)(qw, sc, b)
    if isinstance(lin, Int4Linear):
        ch = _channels(index, hd)
        if rows:
            ops = int4_take_n(lin.packed_t, lin.scales_t, lin.zeros_t, ch)
            b = _take_heads(lin.bias, index, hd, 0) if lin.bias is not None else None
        else:
            ops = int4_take_k(lin.packed_t, lin.scales_t, lin.zeros_t, lin.group, k, ch)
            b = lin.bias
        packed, scales, zeros = ops
        return Int4Linear(packed, scales, lin.group, zeros, b)
    raise NotImplementedError(f"pad_heads_for_tp: unsupported projection type {type(lin).__name__} (Linear, "
                              "int8 QuantLinear and int4 Int4Linear projections are head-sliced)")


def pad_heads_for_tp(model, tp: int):
    """An exactly equivalent model whose q and kv head counts divide `tp`;
    the model itself when its geometry divides already. The new model shares
    every tensor the transform does not touch."""
    cfg = model.cfg
    h, hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    plan = tp_head_plan(h, hkv, tp)
    if plan is None:
        return model
    q_index, kv_index, h2, hkv2 = plan
    cfg2 = cfg.replace(num_attention_heads=h2, num_key_value_heads=hkv2, head_dim=hd)
    out = shallow_copy(model)
    blocks = []
    for blk in model.blocks:
        attn = blk.attn
        if attn.qkv_proj is not None:
            raise NotImplementedError("pad_heads_for_tp: run before fuse_projections")
        a2 = shallow_copy(attn)
        a2.q_proj = _map_linear(attn.q_proj, q_index, hd, rows=True)
        a2.k_proj = _map_linear(attn.k_proj, kv_index, hd, rows=True)
        a2.v_proj = _map_linear(attn.v_proj, kv_index, hd, rows=True)
        a2.o_proj = _map_linear(attn.o_proj, q_index, hd, rows=False, k=h * hd)
        a2.cfg = cfg2
        b2 = shallow_copy(blk)
        b2.attn = a2
        blocks.append(b2)
    out.blocks = torch.nn.ModuleList(blocks)
    out.cfg = cfg2
    return out
