"""JAX parameters -> the port's CausalLM, float or quantized.

`causal_lm_from_jax_params` takes the flat `{name: array}` dict that
`mllm_tpu`'s `Module.parameters()` gives, as numpy arrays, and loads it into
`mllm_tpu_torch.models.transformer.CausalLM`. It takes both layouts of the
decoder blocks:
  - unrolled: `blocks.mods.{i}.attn.q_proj.weight`, ...
  - stacked:  `stacked_blocks.attn.q_proj.weight` with a leading [L] axis.
The model may have gone through `fuse_projections` and/or `quantize_model`
(int8 or int4, any flags): the port's structure is read from the names
(`qkv_proj`, `gateup_proj`, `qweight_t`/`scales`, `packed_t`/`scales_t`
[/`zeros_t`], `mlp.gate_ops.0/1[/2]`, `embed_tokens.qweight_t`,
`embed_tokens.proj.packed_t`). Integer arrays keep their dtype and scales and
zeros stay f32; the other float arrays take `dtype`.
RoPE tables (`rope.sin`, `rope.cos`) are rebuilt from the config, not copied.
Loading is strict: a missing or unexpected name raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.config import TextConfig
from ..nn.layers import Int4Linear, Linear, QuantLinear
from ..ops.fused_mlp import pick_block_f
from ..ops.quantize_model import FusedInt4MLP, Int4EmbedHead, Int4Operands, QuantEmbedHead
from .transformer import CausalLM

_F32_NAMES = ("scales", "scales_t", "zeros_t", "1", "2")  # last name parts kept in f32


def port_state_dict(params: dict[str, np.ndarray], n_layers: int) -> dict[str, np.ndarray]:
    """Rename JAX parameter names to the port's state-dict keys."""
    out: dict[str, np.ndarray] = {}
    for name, arr in params.items():
        if name.startswith("rope."):
            continue
        if name.startswith("blocks.mods."):
            out["blocks." + name[len("blocks.mods."):]] = arr
        elif name.startswith("stacked_blocks."):
            rest = name[len("stacked_blocks."):]
            if arr.shape[0] != n_layers:
                raise ValueError(f"{name}: leading axis {arr.shape[0]} != {n_layers} layers")
            for i in range(n_layers):
                out[f"blocks.{i}.{rest}"] = arr[i]
        else:
            out[name] = arr
    return out


def _to_torch(name: str, arr: np.ndarray, device, dtype) -> torch.Tensor:
    arr = np.asarray(arr)
    if np.issubdtype(arr.dtype, np.integer):
        return torch.from_numpy(np.array(arr)).to(device)
    want = torch.float32 if name.rsplit(".", 1)[-1] in _F32_NAMES else dtype
    return torch.from_numpy(np.array(arr, dtype=np.float32)).to(device=device, dtype=want)


def _linear(state: dict, prefix: str, required: bool = True):
    """The layer that the names under `prefix` describe (None when there is
    none and it is not required)."""
    get = lambda k: state.get(f"{prefix}.{k}")  # noqa: E731
    if get("qweight_t") is not None:
        return QuantLinear(get("qweight_t"), get("scales"), get("bias"))
    if get("packed_t") is not None:
        return Int4Linear(get("packed_t"), get("scales_t"), 32, get("zeros_t"), get("bias"))
    if get("weight") is not None:
        return Linear.from_tensors(get("weight"), get("bias"))
    if required:
        raise KeyError(f"no parameters for the projection {prefix}")
    return None


def _operands(state: dict, prefix: str) -> Int4Operands:
    return Int4Operands(*(state.get(f"{prefix}.{i}") for i in range(3)))


def causal_lm_from_jax_params(params: dict[str, np.ndarray], cfg: TextConfig, device,
                              dtype=torch.float32) -> CausalLM:
    model = CausalLM(cfg, device=device, dtype=dtype)
    state = {k: _to_torch(k, v, device, dtype)
             for k, v in port_state_dict(params, cfg.num_hidden_layers).items()}
    for i, blk in enumerate(model.blocks):
        p = f"blocks.{i}."
        attn, mlp = blk.attn, blk.mlp
        qkv = _linear(state, p + "attn.qkv_proj", required=False)
        if qkv is not None:
            attn.qkv_proj = qkv
            attn.q_proj = attn.k_proj = attn.v_proj = None
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            if getattr(attn, name) is not None:
                setattr(attn, name, _linear(state, p + "attn." + name))
        if p + "mlp.gate_ops.0" in state:
            blk.mlp = FusedInt4MLP(
                _operands(state, p + "mlp.gate_ops"), _operands(state, p + "mlp.up_ops"),
                _operands(state, p + "mlp.down_ops"), cfg.hidden_act,
                pick_block_f(cfg.intermediate_size), bias=state.get(p + "mlp.bias"))
            continue
        gateup = _linear(state, p + "mlp.gateup_proj", required=False)
        if gateup is not None:
            mlp.gateup_proj = gateup
            mlp.gate_proj = mlp.up_proj = None
        for name in ("gate_proj", "up_proj", "down_proj"):
            if getattr(mlp, name) is not None:
                setattr(mlp, name, _linear(state, p + "mlp." + name))
    if model.lm_head is not None:
        model.lm_head = _linear(state, "lm_head")
    if "embed_tokens.qweight_t" in state:
        model.embed_tokens = QuantEmbedHead(model.embed_tokens, state["embed_tokens.qweight_t"],
                                            state["embed_tokens.scales"])
    elif "embed_tokens.proj.packed_t" in state:
        model.embed_tokens = Int4EmbedHead(model.embed_tokens, _linear(state, "embed_tokens.proj"),
                                           cfg.vocab_size)
    model.load_state_dict(state, strict=True)
    return model
