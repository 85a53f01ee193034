"""Checkpoint -> CausalLM: counterpart of `mllm_tpu/models/loading.py`.

Float weights (f32 / f16 / bf16 safetensors, or float tensors of a `.mllm`
or GGUF container) are kept float or quantized at load (`quant="int8" |
"int8-a8" | "int4" | "int4-mixed"`; int4-mixed: the attention projections
int8, every other Linear int4, as the JAX loader). A container that exposes raw ggml blocks (`.mllm`,
GGUF) gives its quantized Linear weights to `make_linear`, which repacks
them losslessly into the kernels' layouts: Q4_0 -> symmetric `Int4Linear`,
Q4_K -> affine `Int4Linear` (with zeros), Q8_0 / Q8_0F -> `QuantLinear`
(requantized to one scale a row); other block types decode to float and
follow `quant`. Fused q||k||v and gate||up checkpoints (phi3) are split by
rows at load and each part kept float or quantized from float, as there; an
interleaved q/k/v (Persimmon / Fuyu: rows [H, (q, k, v), hd], with a bias)
is split per head into float Linears, whatever `quant` says, as there.
`mlp_builder` builds a block's MLP itself (the MoE families).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import dtypes as dt
from ..core.config import TextConfig
from ..nn.layers import Int4Linear, LayerNorm, Linear, QuantLinear, QuantLinearA8, RotaryEmbedding
from ..ops import quant_matmul as qm
from ..ops.quantize_model import MIXED, check_mode
from .transformer import CausalLM


def layer_quant(quant: str | None, attention: bool) -> str | None:
    """The mode of one Linear under `quant`: under "int4-mixed" the attention
    projections are int8 and every other Linear int4 (JAX `load_causal_lm`'s
    `aq`, `make_linear`); other modes apply to every Linear."""
    if quant == "int4-mixed":
        return MIXED[1] if attention else MIXED[0]
    return quant


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
    attn_qkv = "self_attn.qkv_proj"  # fused variant (phi3)
    attn_qkv_interleaved = None  # persimmon / fuyu: rows packed [H, (q, k, v), hd]
    q_norm = "self_attn.q_norm.weight"
    k_norm = "self_attn.k_norm.weight"
    gate = "mlp.gate_proj"
    up = "mlp.up_proj"
    down = "mlp.down_proj"
    gate_up = "mlp.gate_up_proj"  # fused variant (phi3)
    attn_norm = "input_layernorm"
    ffn_norm = "post_attention_layernorm"
    pre_ffn_norm = "pre_feedforward_layernorm"  # gemma2
    post_ffn_norm = "post_feedforward_layernorm"


def _norm_names(names: dict, port: str, ck: str, norm) -> None:
    """A norm's weight (and LayerNorm bias) names; ck is the checkpoint name
    with or without its ".weight"."""
    base = ck[: -len(".weight")] if ck.endswith(".weight") else ck
    names[port + ".weight"] = base + ".weight"
    if getattr(norm, "bias", None) is not None:
        names[port + ".bias"] = base + ".bias"


def checkpoint_names(model: CausalLM, nm: NameMap) -> dict[str, str]:
    """Port state-dict key -> checkpoint tensor name, for every parameter
    (a block's MLP left out when mlp_builder built it: it holds no Linear of
    this map)."""
    from .transformer import MLP

    names = {"embed_tokens.weight": nm.token_embd}
    _norm_names(names, "norm", nm.final_norm, model.norm)
    if model.lm_head is not None:
        names["lm_head.weight"] = nm.lm_head
    for i, blk in enumerate(model.blocks):
        p, b = nm.blk.format(i=i), f"blocks.{i}."
        _norm_names(names, b + "input_norm", p + nm.attn_norm, blk.input_norm)
        _norm_names(names, b + "post_attn_norm", p + nm.ffn_norm, blk.post_attn_norm)
        if blk.pre_ffn_norm is not None:
            _norm_names(names, b + "pre_ffn_norm", p + nm.pre_ffn_norm, blk.pre_ffn_norm)
            _norm_names(names, b + "post_ffn_norm", p + nm.post_ffn_norm, blk.post_ffn_norm)
        if blk.attn.q_norm is not None:
            _norm_names(names, b + "attn.q_norm", p + nm.q_norm, blk.attn.q_norm)
            _norm_names(names, b + "attn.k_norm", p + nm.k_norm, blk.attn.k_norm)
        projs = [("attn.q_proj", nm.attn_q, blk.attn.q_proj), ("attn.k_proj", nm.attn_k, blk.attn.k_proj),
                 ("attn.v_proj", nm.attn_v, blk.attn.v_proj), ("attn.o_proj", nm.attn_o, blk.attn.o_proj)]
        if type(blk.mlp) is MLP:
            projs += [("mlp.gate_proj", nm.gate, blk.mlp.gate_proj), ("mlp.up_proj", nm.up, blk.mlp.up_proj),
                      ("mlp.down_proj", nm.down, blk.mlp.down_proj)]
        for port, ck, lin in projs:
            if lin is None:
                continue
            names[b + port + ".weight"] = p + ck + ".weight"
            if lin.bias is not None:
                names[b + port + ".bias"] = p + ck + ".bias"
    return names


def quant_linear_from_float(w: np.ndarray, bias, quant: str, device):
    """A float [out, in] checkpoint weight -> QuantLinear (int8),
    QuantLinearA8 (int8-a8) or symmetric Int4Linear (int4) by the numpy
    packers (`make_linear`, `_maybe_quant_from_float` of the JAX package)."""
    if quant in ("int8", "int8-a8"):
        qv, sc = qm.repack_float_to_int8(w)
        cls = QuantLinearA8 if quant == "int8-a8" else QuantLinear
        return cls(torch.from_numpy(qv).to(device), torch.from_numpy(sc).to(device), bias)
    packed, scales, _ = qm.prepare_int4(*qm.repack_float_to_int4(w, qm.GROUP), qm.GROUP)
    return Int4Linear(torch.from_numpy(packed).to(device), torch.from_numpy(scales).to(device),
                      qm.GROUP, None, bias)


def float_tensor(a, device, dtype) -> torch.Tensor:
    """A loader's float array as a tensor on `device` in `dtype`. The array
    may be a view of the file's mapping: `torch.tensor` copies it, so the
    tensor owns its memory, and a card's copy is read straight from the view
    (no second host copy of the f32 array)."""
    return torch.tensor(np.asarray(a, np.float32), dtype=dtype, device=device)


def make_linear(loader, name: str, n: int, k: int, bias, quant: str | None, *, device, dtype):
    """The checkpoint weight `name` [n, k] -> the port's Linear module (JAX
    `make_linear`). Raw ggml blocks repack into the kernels' layouts whatever
    `quant` says, as there: Q4_0 -> symmetric Int4Linear (value = (q - 8) * d),
    Q4_K -> affine Int4Linear (q * scale + zero), Q8_0 / Q8_0F -> QuantLinear.
    Any other weight is read as float and kept (quant None) or quantized."""
    ldt = loader.dtype(name) if hasattr(loader, "raw") else None

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    if ldt is not None and dt.is_quantized(ldt):
        raw = np.asarray(loader.raw(name))
        if ldt == dt.DataType.Q4_0:
            packed, scales, _ = qm.prepare_int4(*qm.repack_q4_0(raw, n, k), qm.GROUP)
            return Int4Linear(dev(packed), dev(scales), qm.GROUP, None, bias)
        if ldt == dt.DataType.Q4_K:
            packed, scales, zeros = qm.repack_q4_k(raw, n, k)
            packed, scales, zeros = qm.prepare_int4(packed, scales, qm.GROUP, zeros)
            return Int4Linear(dev(packed), dev(scales), qm.GROUP, dev(zeros), bias)
        if ldt == dt.DataType.Q8_0:
            return QuantLinear(*map(dev, qm.repack_q8_0(raw, n, k)), bias)
        w = dt.decode(raw, ldt, n * k).reshape(n, k)
        if ldt == dt.DataType.Q8_0F:  # f32 block scales: the same per-row requantization
            qv, sc = dt.quant_q8_per_row_int8(w)
            return QuantLinear(dev(qv.T), dev(sc), bias)
    else:
        w = loader.load(name, (n, k), np.float32)
    if quant is not None:
        return quant_linear_from_float(np.array(w, np.float32), bias, quant, device)  # a private copy
    return Linear.from_tensors(float_tensor(w, device, dtype), bias)


def _split_rows(loader, name: str, splits: list[int], in_f: int) -> list[np.ndarray]:
    """A fused [sum(splits), in_f] weight split by rows (JAX `_split_rows`)."""
    w = np.array(loader.load(name, (sum(splits), in_f), np.float32), np.float32)
    return np.split(w, np.cumsum(splits)[:-1], axis=0)


def _split_interleaved(loader, base: str, cfg: TextConfig, device, dtype) -> list:
    """An interleaved fused q/k/v `base` (weight [H * 3 * hd, D], rows packed
    [H, (q, k, v), hd]; bias [H * 3 * hd] when present) -> float Linears for
    q, k and v (JAX `load_causal_lm`'s `attn_qkv_interleaved` branch)."""
    h, hd, d = cfg.num_attention_heads, cfg.head_dim_, cfg.hidden_size
    w = np.array(loader.load(base + ".weight", (h, 3, hd, d), np.float32), np.float32)
    b = (np.array(loader.load(base + ".bias", (h, 3, hd), np.float32), np.float32)
         if base + ".bias" in loader else None)

    def part(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    return [Linear.from_tensors(part(w[:, j].reshape(h * hd, d)),
                                None if b is None else part(b[:, j].reshape(h * hd))) for j in range(3)]


def _from_float(w: np.ndarray, quant: str | None, *, device, dtype):
    """A float [out, in] part of a fused weight -> Linear, or quantized from
    float (JAX `_maybe_quant_from_float`; no bias)."""
    if quant is not None:
        return quant_linear_from_float(np.ascontiguousarray(w), None, quant, device)
    return Linear.from_tensors(torch.from_numpy(np.ascontiguousarray(w)).to(device=device, dtype=dtype))


def load_causal_lm(loader, cfg: TextConfig, *, device, dtype=torch.bfloat16,
                   names: NameMap = None, quant: str | None = None, mlp_builder=None) -> CausalLM:
    """Build the model for `cfg` and fill it from `loader` (strict: every
    parameter must be in the checkpoint). As in the JAX package, an untied
    config whose checkpoint has no lm_head falls back to the tied head, a
    qk_norm config whose checkpoint has no q_norm runs without it (and one
    whose q_norm has a bias gets per-head LayerNorms), a LayerNorm without a
    bias in the checkpoint has none, and an MLP without up_proj is non-gated.

    Every Linear (the untied lm_head too) goes through `make_linear`: raw
    ggml blocks are repacked, float weights quantized on the host when
    quant="int8" | "int8-a8" | "int4" | "int4-mixed" (`layer_quant`: the
    attention projections int8, the rest int4); the tied embedding and the
    MLPs stay as they are (no head quantization, no FusedInt4MLP), as in JAX.
    mlp_builder(loader, layer_prefix, layer_idx) -> module replaces a
    block's MLP (the MoE families)."""
    if quant is not None:
        check_mode(quant)
    nm = names or NameMap()
    # a built MLP replaces the block's: the blocks are made with small dense
    # MLPs in its place, so no expert stack is allocated twice
    model = CausalLM(cfg.replace(num_experts=0) if mlp_builder else cfg, device=device, dtype=dtype)
    model.cfg = cfg
    if cfg.rope_int8:  # as in the JAX package, a loaded model takes the float tables
        model.rope = RotaryEmbedding.make(cfg.head_dim_, cfg.max_position_embeddings, cfg.rope_theta,
                                          cfg.rope_style, cfg.rope_partial, cfg.rope_scaling_dict(),
                                          device=device)
    if model.lm_head is not None and nm.lm_head not in loader:
        model.lm_head = None
    hd = cfg.head_dim_
    built, fused = {}, {}
    for i, blk in enumerate(model.blocks):
        p = nm.blk.format(i=i)
        attn = blk.attn
        if attn.q_norm is not None:
            if p + nm.q_norm not in loader:
                attn.q_norm = attn.k_norm = None
            elif p + nm.q_norm.replace(".weight", ".bias") in loader:  # per-head LayerNorm
                attn.q_norm, attn.k_norm = (LayerNorm(hd, cfg.rms_norm_eps, device=device, dtype=dtype)
                                            for _ in range(2))
        if nm.attn_qkv_interleaved and p + nm.attn_qkv_interleaved + ".weight" in loader:
            for name, lin in zip(("q_proj", "k_proj", "v_proj"),
                                 _split_interleaved(loader, p + nm.attn_qkv_interleaved, cfg, device, dtype)):
                fused[f"blocks.{i}.attn.{name}"] = lin
        elif p + nm.attn_qkv + ".weight" in loader:
            h, hkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.hidden_size
            parts = _split_rows(loader, p + nm.attn_qkv + ".weight", [h * hd, hkv * hd, hkv * hd], d)
            for name, w in zip(("q_proj", "k_proj", "v_proj"), parts):
                fused[f"blocks.{i}.attn.{name}"] = _from_float(w, layer_quant(quant, True), device=device,
                                                               dtype=dtype)
        if mlp_builder is not None:
            built[i] = mlp_builder(loader, p, i)
            continue
        if p + nm.gate_up + ".weight" in loader:
            ff = cfg.intermediate_size
            parts = _split_rows(loader, p + nm.gate_up + ".weight", [ff, ff], cfg.hidden_size)
            for name, w in zip(("gate_proj", "up_proj"), parts):
                fused[f"blocks.{i}.mlp.{name}"] = _from_float(w, layer_quant(quant, False), device=device,
                                                              dtype=dtype)
        elif p + nm.up + ".weight" not in loader:
            blk.mlp.up_proj = None
    for i, mlp in built.items():
        model.blocks[i].mlp = mlp
    names = checkpoint_names(model, nm)
    for key in [k for k in names if k.endswith(".bias") and names[k] not in loader]:
        # a bias the checkpoint does not hold is none (JAX `make_linear`, `norm_from`)
        del names[key]
        mod = model.get_submodule(key[: -len(".bias")])
        if isinstance(mod, LayerNorm):
            mod.bias = None
    sd = model.state_dict()

    def tensor(key):
        return float_tensor(loader.load(names.pop(key), tuple(sd[key].shape), np.float32), device, dtype)

    state = {}
    for i, mlp in built.items():
        state.update({f"blocks.{i}.mlp.{k}": v for k, v in mlp.state_dict().items()})
    for path, new in fused.items():
        names.pop(path + ".weight", None)
        parent, _, name = path.rpartition(".")
        setattr(model.get_submodule(parent), name, new)
        state.update({f"{path}.{key}": v for key, v in new.state_dict().items()})
    for path, lin in list(model.named_modules()):
        if not isinstance(lin, Linear) or path in fused or path + ".weight" not in names:
            continue
        bias = tensor(path + ".bias") if path + ".bias" in names else None
        n, k = lin.weight.shape
        new = make_linear(loader, names.pop(path + ".weight"), n, k, bias,
                          layer_quant(quant, ".attn." in f".{path}."), device=device, dtype=dtype)
        parent, _, name = path.rpartition(".")
        setattr(model.get_submodule(parent), name, new)
        state.update({f"{path}.{key}": v for key, v in new.state_dict().items()})
    state.update({key: tensor(key) for key in list(names)})
    model.load_state_dict(state, strict=True)
    return model
