"""Elastic and predictor-sparse inference: counterpart of
`mllm_tpu/models/elastic.py` (the reference's width-elastic and
PowerInfer-style sparse LLaMA variants).

`elastic_model` slices the weights once into a smaller `CausalLM`: the first
`attn_ratio` of the KV heads (the GQA group size kept) and the first
`mlp_ratio` of the FFN neurons, the reference's "first activate_dim columns".
Every entry point then runs at the reduced shapes. A sliced weight is copied
once into a contiguous tensor: a column slice of the int8 [K, N] weight is a
strided view, and `int8_matmul` takes contiguous weights with N % 16 == 0 (a
quantized FFN width rounds down to a multiple of 128, as in the JAX package).
A weight that keeps its full width is shared with the source model, so ratio
1.0 gives the same bytes.

`sparse_model` swaps each block's MLP for a `PredictorSparseMLP`: a low-rank
predictor scores the FFN neurons and the inactive ones are masked (dense
compute, then mask).

Both return a new model and leave the source as it was; the tensors they do
not slice are shared. Both refuse a model whose projections
`ops.quantize_model.fuse_projections` has fused (q||k||v, gate||up): slicing
the split Linears would leave the fused ones at full width. Call them before
`fuse_projections`, as the JAX package asks for them before `.stack()`.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
from torch import nn

from ..nn.layers import Linear, PredictorSparseMLP, QuantLinear, shallow_copy
from .transformer import MLP, CausalLM


def _rows(t: Optional[torch.Tensor], n: int) -> Optional[torch.Tensor]:
    return None if t is None else t[:n].contiguous()


def _slice_out(lin, n_out: int):
    """The first n_out output features of a Linear or int8 QuantLinear (the
    same layer when n_out is its width)."""
    if isinstance(lin, QuantLinear):
        if n_out == lin.qweight_t.shape[1]:
            return lin
        return type(lin)(lin.qweight_t[:, :n_out].contiguous(), _rows(lin.scales, n_out), _rows(lin.bias, n_out))
    if isinstance(lin, Linear):
        if n_out == lin.weight.shape[0]:
            return lin
        return Linear.from_tensors(_rows(lin.weight, n_out), _rows(lin.bias, n_out))
    raise TypeError(f"elastic slicing supports Linear/QuantLinear(int8), got {type(lin).__name__}; "
                    "load with quant=None or quant='int8'")


def _slice_in(lin, n_in: int):
    """The first n_in input features of a Linear or int8 QuantLinear."""
    if isinstance(lin, QuantLinear):
        if n_in == lin.qweight_t.shape[0]:
            return lin
        return type(lin)(lin.qweight_t[:n_in].contiguous(), lin.scales, lin.bias)
    if isinstance(lin, Linear):
        if n_in == lin.weight.shape[1]:
            return lin
        return Linear.from_tensors(lin.weight[:, :n_in].contiguous(), lin.bias)
    raise TypeError(f"elastic slicing supports Linear/QuantLinear(int8), got {type(lin).__name__}")


def _check_unfused(model: CausalLM, what: str) -> None:
    for blk in model.blocks:
        if getattr(blk.attn, "qkv_proj", None) is not None or getattr(blk.mlp, "gateup_proj", None) is not None:
            raise ValueError(f"call {what} before fuse_projections")


def _with_blocks(model: CausalLM, blocks: list, cfg) -> CausalLM:
    new = shallow_copy(model)
    new.blocks = nn.ModuleList(blocks)
    new.cfg = cfg
    return new


def elastic_model(model: CausalLM, attn_ratio: float = 1.0,
                  mlp_ratio: Union[float, Sequence[float]] = 1.0) -> CausalLM:
    """The model cut to the first attn_ratio of its KV heads (query heads
    follow, the group size kept) and the first mlp_ratio of each layer's FFN
    neurons (one ratio, or one a layer). Ratio 1.0 keeps the same tensors."""
    _check_unfused(model, "elastic_model")
    cfg = model.cfg
    h, hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    ahkv = max(1, round(hkv * attn_ratio))
    ah = ahkv * (h // hkv)
    n_layers = cfg.num_hidden_layers
    if isinstance(mlp_ratio, (int, float)):
        mlp_ratio = [float(mlp_ratio)] * n_layers
    if len(mlp_ratio) != n_layers:
        raise ValueError(f"need {n_layers} mlp ratios, got {len(mlp_ratio)}")
    new_cfg = cfg.replace(num_attention_heads=ah, num_key_value_heads=ahkv, head_dim=hd)
    blocks = []
    for li, blk in enumerate(model.blocks):
        if not isinstance(blk.mlp, MLP):
            raise TypeError(f"elastic_model slices a dense MLP, got {type(blk.mlp).__name__}")
        attn = shallow_copy(blk.attn)
        attn.q_proj = _slice_out(blk.attn.q_proj, ah * hd)
        attn.k_proj = _slice_out(blk.attn.k_proj, ahkv * hd)
        attn.v_proj = _slice_out(blk.attn.v_proj, ahkv * hd)
        attn.o_proj = _slice_in(blk.attn.o_proj, ah * hd)
        attn.cfg = new_cfg
        mlp = shallow_copy(blk.mlp)
        ai = max(1, round(cfg.intermediate_size * mlp_ratio[li]))
        if isinstance(blk.mlp.gate_proj, QuantLinear):  # the int8 lane quantum
            ai = max(128, (ai // 128) * 128)
        mlp.gate_proj = _slice_out(blk.mlp.gate_proj, ai)
        mlp.up_proj = None if blk.mlp.up_proj is None else _slice_out(blk.mlp.up_proj, ai)
        mlp.down_proj = _slice_in(blk.mlp.down_proj, ai)
        new = shallow_copy(blk)
        new.attn, new.mlp = attn, mlp
        blocks.append(new)
    return _with_blocks(model, blocks, new_cfg)


def make_predictors(model: CausalLM, rank: int = 128, generator: Optional[torch.Generator] = None):
    """Random low-rank FFN-activation predictors, one a layer: (pred_down
    [r, d] ~ N(0, 1/d), pred_up [ff, r] ~ N(0, 1/r)) in f32 on the model's
    device, drawn from `generator` (the JAX package draws from a PRNG key, so
    the values differ). Real deployments train them offline."""
    cfg = model.cfg
    d, ff = cfg.hidden_size, cfg.intermediate_size
    dev = model.device
    g = generator or torch.Generator(device=dev).manual_seed(0)
    preds = []
    for _ in range(cfg.num_hidden_layers):
        pd = torch.randn(rank, d, generator=g, device=dev) / math.sqrt(d)
        pu = torch.randn(ff, rank, generator=g, device=dev) / math.sqrt(rank)
        preds.append((pd, pu))
    return preds


def sparse_model(model: CausalLM, predictors, threshold: float = 0.0) -> CausalLM:
    """The model with each block's MLP behind a predictor-gated
    `PredictorSparseMLP`; predictors: one (pred_down [r, d], pred_up [ff, r])
    a layer, tensors on the model's device."""
    _check_unfused(model, "sparse_model")
    cfg = model.cfg
    if len(predictors) != cfg.num_hidden_layers:
        raise ValueError(f"need {cfg.num_hidden_layers} predictors, got {len(predictors)}")
    blocks = []
    for blk, (pd, pu) in zip(model.blocks, predictors):
        mlp = blk.mlp
        if not isinstance(mlp, MLP):
            raise TypeError(f"sparse_model gates a dense MLP, got {type(mlp).__name__}")
        new = shallow_copy(blk)
        new.mlp = PredictorSparseMLP(pd, pu, mlp.gate_proj, mlp.up_proj, mlp.down_proj, act=mlp.act,
                                     threshold=threshold)
        blocks.append(new)
    return _with_blocks(model, blocks, cfg)
