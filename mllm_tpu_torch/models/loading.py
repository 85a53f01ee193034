"""Checkpoint -> CausalLM: counterpart of `mllm_tpu/models/loading.py` for
float weights (f32 / f16 / bf16 safetensors), kept float or quantized at load
(`quant="int8" | "int4"`, as `make_linear` does it). Quantized checkpoints
(.mllm / GGUF) and the fused-projection checkpoints (phi3, persimmon) come in
later slices.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.config import TextConfig
from ..nn.layers import Int4Linear, Linear, QuantLinear
from ..ops import quant_matmul as qm
from ..ops.quantize_model import check_mode
from .transformer import CausalLM


class NameMap:
    """HF-convention weight names. Override fields for families that differ."""

    token_embd = "model.embed_tokens.weight"
    final_norm = "model.norm.weight"
    lm_head = "lm_head.weight"
    blk = "model.layers.{i}."
    attn_q = "self_attn.q_proj"
    attn_k = "self_attn.k_proj"
    attn_v = "self_attn.v_proj"
    attn_o = "self_attn.o_proj"
    q_norm = "self_attn.q_norm.weight"
    k_norm = "self_attn.k_norm.weight"
    gate = "mlp.gate_proj"
    up = "mlp.up_proj"
    down = "mlp.down_proj"
    attn_norm = "input_layernorm"
    ffn_norm = "post_attention_layernorm"


def checkpoint_names(model: CausalLM, nm: NameMap) -> dict[str, str]:
    """Port state-dict key -> checkpoint tensor name, for every parameter."""
    names = {"embed_tokens.weight": nm.token_embd, "norm.weight": nm.final_norm}
    if model.lm_head is not None:
        names["lm_head.weight"] = nm.lm_head
    for i, blk in enumerate(model.blocks):
        p, b = nm.blk.format(i=i), f"blocks.{i}."
        names[b + "input_norm.weight"] = p + nm.attn_norm + ".weight"
        names[b + "post_attn_norm.weight"] = p + nm.ffn_norm + ".weight"
        if blk.attn.q_norm is not None:
            names[b + "attn.q_norm.weight"] = p + nm.q_norm
            names[b + "attn.k_norm.weight"] = p + nm.k_norm
        for port, ck, lin in (("attn.q_proj", nm.attn_q, blk.attn.q_proj),
                              ("attn.k_proj", nm.attn_k, blk.attn.k_proj),
                              ("attn.v_proj", nm.attn_v, blk.attn.v_proj),
                              ("attn.o_proj", nm.attn_o, blk.attn.o_proj),
                              ("mlp.gate_proj", nm.gate, blk.mlp.gate_proj),
                              ("mlp.up_proj", nm.up, blk.mlp.up_proj),
                              ("mlp.down_proj", nm.down, blk.mlp.down_proj)):
            names[b + port + ".weight"] = p + ck + ".weight"
            if lin.bias is not None:
                names[b + port + ".bias"] = p + ck + ".bias"
    return names


def quant_linear_from_float(w: np.ndarray, bias, quant: str, device):
    """A float [out, in] checkpoint weight -> QuantLinear (int8) or symmetric
    Int4Linear (int4) by the numpy packers (`make_linear`,
    `_maybe_quant_from_float` of the JAX package)."""
    if quant == "int8":
        qv, sc = qm.repack_float_to_int8(w)
        return QuantLinear(torch.from_numpy(qv).to(device), torch.from_numpy(sc).to(device), bias)
    packed, scales, _ = qm.prepare_int4(*qm.repack_float_to_int4(w, qm.GROUP), qm.GROUP)
    return Int4Linear(torch.from_numpy(packed).to(device), torch.from_numpy(scales).to(device),
                      qm.GROUP, None, bias)


def load_causal_lm(loader, cfg: TextConfig, *, device, dtype=torch.bfloat16,
                   names: NameMap = None, quant: str | None = None) -> CausalLM:
    """Build the model for `cfg` and fill it from `loader` (strict: every
    parameter must be in the checkpoint). As in the JAX package, an untied
    config whose checkpoint has no lm_head falls back to the tied head, and
    a qk_norm config whose checkpoint has no q_norm runs without it.

    quant="int8" | "int4" quantizes every Linear (the untied lm_head too)
    from the checkpoint's f32 values on the host; the tied embedding and the
    MLPs stay as they are (no head quantization, no FusedInt4MLP), as in JAX."""
    if quant is not None:
        check_mode(quant)
    nm = names or NameMap()
    model = CausalLM(cfg, device=device, dtype=dtype)
    if model.lm_head is not None and nm.lm_head not in loader:
        model.lm_head = None
    for blk in model.blocks:
        if blk.attn.q_norm is not None and nm.blk.format(i=blk.attn.layer_idx) + nm.q_norm not in loader:
            blk.attn.q_norm = blk.attn.k_norm = None
    sd = model.state_dict()
    arrays = {key: np.array(loader.load(ck, tuple(sd[key].shape), np.float32))
              for key, ck in checkpoint_names(model, nm).items()}

    def tensor(a):
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    state = {}
    if quant is not None:
        for path, lin in list(model.named_modules()):
            if not isinstance(lin, Linear):
                continue
            bias = arrays.pop(path + ".bias", None)
            ql = quant_linear_from_float(arrays.pop(path + ".weight"), None if bias is None
                                         else tensor(bias), quant, device)
            parent, _, name = path.rpartition(".")
            setattr(model.get_submodule(parent), name, ql)
            state.update({f"{path}.{k}": v for k, v in ql.state_dict().items()})
    state.update({k: tensor(a) for k, a in arrays.items()})
    model.load_state_dict(state, strict=True)
    return model
