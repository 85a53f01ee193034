"""JAX parameters -> the port's CausalLM, float or quantized.

`causal_lm_from_jax_params` takes the flat `{name: array}` dict that
`mllm_tpu`'s `Module.parameters()` gives, as numpy arrays, and loads it into
`mllm_tpu_torch.models.transformer.CausalLM`. It takes both layouts of the
decoder blocks:
  - unrolled: `blocks.mods.{i}.attn.q_proj.weight`, ...
  - stacked:  `stacked_blocks.attn.q_proj.weight` with a leading [L] axis.
The model may have gone through `fuse_projections` and/or `quantize_model`
(int8 or int4, any flags; int4 with attn_quant="int8" is `-q int4-mixed`:
int8 attention beside the int4 MLP and head): the port's structure is read
from the names
(`qkv_proj`, `gateup_proj`, `qweight_t`/`scales`, `packed_t`/`scales_t`
[/`zeros_t`], `mlp.gate_ops.0/1[/2]`, `embed_tokens.qweight_t`,
`embed_tokens.proj.packed_t`); a projection with `lora_a` / `lora_b` (the
JAX `add_lora`) becomes a `training.lora.LoRALinear`. MoE blocks take `mlp.router_weight`,
`mlp.w_gate` / `w_up` / `w_down` (float: `MoEMLP`; with `mlp.s_gate` /
`s_up` / `s_down`: `QuantMoEMLP`), `mlp.shared_expert.*` (float, int8 or
fused int4) and `mlp.shared_gate`. LayerNorm biases, per-head q/k
LayerNorms and a non-gated MLP (no `mlp.up_proj`) follow the names too.
Integer arrays keep their dtype and scales and zeros stay f32; the other
float arrays take `dtype`.
RoPE tables (`rope.sin`, `rope.cos`) are rebuilt from the config, not copied.
Loading is strict: a missing or unexpected name raises.

`mega_decode_from_jax` takes the parameters of a JAX `MegaDecodeLM` (its
operand stacks, norms and qkv bias, and its int4 `base` under `base.`) and
gives the port's `MegaDecodeLM` with the same bytes: the kernel's bf16 scales
stay bf16, the base's become f32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.config import TextConfig
from ..nn.layers import Int4Linear, LayerNorm, Linear, QuantLinear, RMSNorm
from ..ops.fused_mlp import pick_block_f
from ..ops.quantize_model import FusedInt4MLP, Int4EmbedHead, Int4Operands, QuantEmbedHead
from .megadecode import BLOCK_F_CAP, MegaDecodeLM
from .moe import MoEMLP, QuantMoEMLP
from .transformer import MLP, CausalLM

_F32_NAMES = ("scales", "scales_t", "zeros_t", "1", "2", "s_gate", "s_up", "s_down", "lora_a", "lora_b")  # kept in f32


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


def _linear(state: dict, prefix: str, required: bool = True, lora_scale=None):
    """The layer that the names under `prefix` describe (None when there is
    none and it is not required). `lora_a` / `lora_b` beside the weight make
    a LoRALinear (the JAX LoRALinear's leaves) with scale `lora_scale`
    (alpha / rank: a static field there, not a parameter)."""
    get = lambda k: state.get(f"{prefix}.{k}")  # noqa: E731
    if get("lora_a") is not None:
        from ..training.lora import LoRALinear

        if lora_scale is None:
            raise ValueError(f"{prefix} holds LoRA adapters: pass lora_scale (alpha / rank)")
        return LoRALinear(get("weight"), get("bias"), get("lora_a"), get("lora_b"), lora_scale)
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


def _mlp(state: dict, prefix: str, mlp: MLP, cfg: TextConfig, lora_scale=None):
    """The MLP (or FusedInt4MLP) that the names under `prefix` describe,
    filling `mlp`'s projections."""
    if prefix + "gate_ops.0" in state:
        return FusedInt4MLP(
            _operands(state, prefix + "gate_ops"), _operands(state, prefix + "up_ops"),
            _operands(state, prefix + "down_ops"), cfg.hidden_act,
            pick_block_f(state[prefix + "gate_ops.0"].shape[1]), bias=state.get(prefix + "bias"))
    gateup = _linear(state, prefix + "gateup_proj", required=False)
    if gateup is not None:
        mlp.gateup_proj = gateup
        mlp.gate_proj = mlp.up_proj = None
    for name in ("gate_proj", "up_proj", "down_proj"):
        if getattr(mlp, name) is not None:
            setattr(mlp, name, _linear(state, prefix + name, required=name != "up_proj", lora_scale=lora_scale))
    return mlp


def _moe(state: dict, prefix: str, moe: MoEMLP, cfg: TextConfig):
    """MoEMLP (float stacks) or QuantMoEMLP (with s_*) from the names under
    `prefix`; the shared expert as `_mlp`, or None when there is none."""
    shared = None
    if any(k.startswith(prefix + "shared_expert.") for k in state):
        shared = _mlp(state, prefix + "shared_expert.", moe.shared_expert, cfg)
    gate = state.get(prefix + "shared_gate")
    if prefix + "s_gate" in state:
        get = lambda k: state[prefix + k]  # noqa: E731
        return QuantMoEMLP(get("router_weight"), get("w_gate"), get("s_gate"), get("w_up"), get("s_up"),
                           get("w_down"), get("s_down"), moe.top_k, moe.norm_topk_prob, moe.act, shared, gate)
    moe.shared_expert = shared
    if gate is not None:
        moe.shared_gate = torch.nn.Parameter(gate, requires_grad=False)
    return moe


def causal_lm_from_jax_params(params: dict[str, np.ndarray], cfg: TextConfig, device,
                              dtype=torch.float32, lora_scale=None) -> CausalLM:
    """lora_scale: the adapters' alpha / rank, for a model that went through
    the JAX `add_lora` (its LoRALinear leaves become the port's LoRALinear)."""
    model = CausalLM(cfg, device=device, dtype=dtype)
    state = {k: _to_torch(k, v, device, dtype)
             for k, v in port_state_dict(params, cfg.num_hidden_layers).items()}
    for key in [k for k in state if k.endswith("norm.bias")]:  # LayerNorm biases
        norm = model.get_submodule(key[: -len(".bias")])
        if isinstance(norm, RMSNorm) or norm.bias is None:
            parent, _, name = key[: -len(".bias")].rpartition(".")
            setattr(model.get_submodule(parent), name,
                    LayerNorm(norm.weight.shape[0], norm.eps, device=device, dtype=dtype))
    for name, norm in list(model.named_modules()):
        if isinstance(norm, LayerNorm) and norm.bias is not None and name + ".bias" not in state:
            norm.bias = None
    for i, blk in enumerate(model.blocks):
        p = f"blocks.{i}."
        attn, mlp = blk.attn, blk.mlp
        qkv = _linear(state, p + "attn.qkv_proj", required=False)
        if qkv is not None:
            attn.qkv_proj = qkv
            attn.q_proj = attn.k_proj = attn.v_proj = None
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            if getattr(attn, name) is not None:
                setattr(attn, name, _linear(state, p + "attn." + name, lora_scale=lora_scale))
        blk.mlp = (_moe(state, p + "mlp.", mlp, cfg) if isinstance(mlp, MoEMLP)
                   else _mlp(state, p + "mlp.", mlp, cfg, lora_scale=lora_scale))
    if model.lm_head is not None:
        model.lm_head = _linear(state, "lm_head", lora_scale=lora_scale)
    if "embed_tokens.qweight_t" in state:
        model.embed_tokens = QuantEmbedHead(model.embed_tokens, state["embed_tokens.qweight_t"],
                                            state["embed_tokens.scales"])
    elif "embed_tokens.proj.packed_t" in state:
        model.embed_tokens = Int4EmbedHead(model.embed_tokens, _linear(state, "embed_tokens.proj"),
                                           cfg.vocab_size)
    model.load_state_dict(state, strict=True)
    return model


def _same_bits(arr: np.ndarray, device) -> torch.Tensor:
    """numpy -> torch with the dtype and bits kept (bfloat16 included)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr.copy()).to(device)


def mega_decode_from_jax(params: dict[str, np.ndarray], cfg: TextConfig, device,
                         dtype=torch.float32) -> MegaDecodeLM:
    """The port's MegaDecodeLM from a JAX MegaDecodeLM's `parameters()` as
    numpy (built by the JAX `from_float` with its default block_f, which is
    not a parameter there: `pick_block_f(ff, cap=1280)`)."""
    base = causal_lm_from_jax_params(
        {k[len("base."):]: v for k, v in params.items() if k.startswith("base.")}, cfg, device, dtype)
    t = {k: _same_bits(v, device) for k, v in params.items() if not k.startswith("base.")}
    ops = {name: tuple(t.get(f"{name}.{i}") for i in range(3))
           for name in ("qkv_ops", "o_ops", "gate_ops", "up_ops", "down_ops")}
    return MegaDecodeLM(base, ops["qkv_ops"], ops["o_ops"][:2], ops["gate_ops"][:2], ops["up_ops"][:2],
                        ops["down_ops"][:2], t["norm1_w"], t["norm2_w"],
                        pick_block_f(cfg.intermediate_size, cap=BLOCK_F_CAP),
                        cfg.hidden_size // ops["qkv_ops"][1].shape[1])


# ---------------------------------------------------------------------------
# Vision-language and encoder models
# ---------------------------------------------------------------------------


def unstacked(params: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """JAX names -> the port's: `blocks.mods.{i}.` -> `blocks.{i}.` anywhere
    in a name, and a `stacked_blocks.` leaf with a leading [L] axis -> one
    `blocks.{i}.` leaf a layer."""
    out: dict[str, np.ndarray] = {}
    for name, arr in params.items():
        name = name.replace("blocks.mods.", "blocks.")
        if "stacked_blocks." in name:
            head, rest = name.split("stacked_blocks.", 1)
            for i in range(arr.shape[0]):
                out[f"{head}blocks.{i}.{rest}"] = arr[i]
        else:
            out[name] = arr
    return out


def module_from_jax(module: torch.nn.Module, params: dict[str, np.ndarray], device, dtype=torch.float32,
                    f32=()) -> torch.nn.Module:
    """Load JAX parameters (numpy, names as `Module.parameters()` gives them,
    unrolled or stacked) into a port module built with the same structure: a
    Linear whose names say int8 or int4 becomes that layer (`_linear`); the
    names in `f32` stay f32. Strict; returns the module."""
    state = {k: (torch.from_numpy(np.array(v, np.float32)).to(device) if k in f32 else _to_torch(k, v, device, dtype))
             for k, v in unstacked(params).items()}
    for path, lin in list(module.named_modules()):
        if isinstance(lin, Linear) and f"{path}.weight" not in state:
            parent, _, name = path.rpartition(".")
            setattr(module.get_submodule(parent) if parent else module, name, _linear(state, path))
    module.load_state_dict(state, strict=True)
    return module


def qwen2_vl_from_jax_params(params: dict[str, np.ndarray], cfg, device, dtype=torch.float32,
                             vision_cfg=None, vision_eps: float = 1e-6):
    """The port's Qwen2VLForConditionalGeneration from a JAX one's parameters:
    the LM (`lm.*`) through `causal_lm_from_jax_params`, the tower
    (`visual.*`) into `Qwen2VLVisionTower(cfg.vision)`, or with `vision_cfg`
    (a Qwen25VLVisionConfig) into `Qwen25VLVisionTower`; the rotary tables
    (`mrope.*`, `visual.inv_freq`) are rebuilt. vision_eps: the towers'
    norms' eps (1e-6 for a loaded checkpoint, 1e-5 for the JAX `init`'s
    LayerNorms)."""
    from .qwen2_5_vl import Qwen25VLVisionTower
    from .qwen2_vl import Qwen2VLForConditionalGeneration, Qwen2VLVisionTower

    lm = causal_lm_from_jax_params({k[3:]: v for k, v in params.items() if k.startswith("lm.")}, cfg.text,
                                   device, dtype)
    if vision_cfg is None:
        tower = Qwen2VLVisionTower(cfg.vision, device=device, dtype=dtype, eps=vision_eps)
    else:
        tower = Qwen25VLVisionTower(vision_cfg, device=device, dtype=dtype, eps=vision_eps)
    module_from_jax(tower, {k[7:]: v for k, v in params.items()
                            if k.startswith("visual.") and k != "visual.inv_freq"}, device, dtype)
    return Qwen2VLForConditionalGeneration(tower, lm, cfg)


def clip_from_jax_params(params: dict[str, np.ndarray], cfg, device, dtype=torch.float32):
    """The port's CLIPModel from a JAX CLIPModel's parameters (logit_scale f32)."""
    from .clip import CLIPModel

    return module_from_jax(CLIPModel(cfg, device=device, dtype=dtype), params, device, dtype, f32=("logit_scale",))


def vit_from_jax_params(params: dict[str, np.ndarray], cfg, num_labels: int, device, dtype=torch.float32,
                        id2label=None):
    """The port's ViTForImageClassification from a JAX one's parameters."""
    from .vit import vit_classifier

    return module_from_jax(vit_classifier(cfg, num_labels, device=device, dtype=dtype, id2label=id2label), params,
                           device, dtype)


def _under(params: dict[str, np.ndarray], prefix: str) -> dict[str, np.ndarray]:
    """The parameters under `prefix`, with the prefix taken off."""
    return {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}


def llava_from_jax_params(params: dict[str, np.ndarray], cfg, device, dtype=torch.float32):
    """The port's LlavaForConditionalGeneration from a JAX one's parameters
    (`vision_tower.*`, `projector.*`, `lm.*`)."""
    from .llava import LlavaForConditionalGeneration, LlavaProjector, clip_tower

    tower = module_from_jax(clip_tower(cfg.vision, device=device, dtype=dtype), _under(params, "vision_tower."),
                            device, dtype)
    proj = module_from_jax(LlavaProjector(cfg.vision.hidden_size, cfg.text.hidden_size, device=device, dtype=dtype),
                           _under(params, "projector."), device, dtype)
    lm = causal_lm_from_jax_params(_under(params, "lm."), cfg.text, device, dtype)
    return LlavaForConditionalGeneration(tower, proj, lm, cfg)


def phi3v_from_jax_params(params: dict[str, np.ndarray], cfg, device, dtype=torch.float32):
    """The port's Phi3VForCausalLM from a JAX one's parameters
    (`image_embed.*`: the tower, separators and projector; `lm.*`)."""
    from .llava import clip_tower
    from .phi3v import Phi3VForCausalLM, Phi3VImageEmbedding

    emb = Phi3VImageEmbedding(clip_tower(cfg.vision, device=device, dtype=dtype), cfg, device=device, dtype=dtype)
    module_from_jax(emb, _under(params, "image_embed."), device, dtype)
    return Phi3VForCausalLM(emb, causal_lm_from_jax_params(_under(params, "lm."), cfg.text, device, dtype), cfg)


def fuyu_from_jax_params(params: dict[str, np.ndarray], cfg, device, dtype=torch.float32):
    """The port's FuyuForCausalLM from a JAX one's parameters (`vision_embed.*`
    and the Persimmon LM under `lm.*`: per-head LayerNorms, biased q/k/v, a
    non-gated MLP, as the names say)."""
    from .fuyu import FuyuForCausalLM

    state = _under(params, "vision_embed.")
    emb = Linear.from_tensors(_to_torch("weight", state["weight"], device, dtype),
                              _to_torch("bias", state["bias"], device, dtype) if "bias" in state else None)
    return FuyuForCausalLM(emb, causal_lm_from_jax_params(_under(params, "lm."), cfg.text, device, dtype), cfg)


def opt_from_jax_params(params: dict[str, np.ndarray], cfg, device, dtype=torch.float32):
    """The port's OPTForCausalLM from a JAX one's parameters."""
    from .opt import OPTForCausalLM

    model = OPTForCausalLM(cfg, final_ln="final_ln.weight" in params,
                           bias="blocks.mods.0.attn.q_proj.bias" in params, device=device, dtype=dtype)
    return module_from_jax(model, params, device, dtype)


def bert_from_jax_params(params: dict[str, np.ndarray], cfg, device, dtype=torch.float32):
    """The port's BertModel from a JAX one's parameters."""
    from .bert import BertModel

    return module_from_jax(BertModel(cfg, device=device, dtype=dtype), params, device, dtype)


def imagebind_from_jax_params(params: dict[str, np.ndarray], cfg, device, dtype=torch.float32):
    """The port's ImageBindModel from a JAX one's parameters."""
    from .imagebind import ImageBindModel

    return module_from_jax(ImageBindModel(cfg, device=device, dtype=dtype), params, device, dtype)


# ---------------------------------------------------------------------------
# MLA, OpenELM, predictor-sparse models
# ---------------------------------------------------------------------------


def _without_rope(params: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    return {k: v for k, v in params.items() if not k.startswith("rope.")}


def deepseek_from_jax_params(params: dict[str, np.ndarray], text, mla, moe_cfg: dict, device,
                             dtype=torch.float32):
    """The port's DeepseekForCausalLM (DeepSeek-V3 or MiniCPM3) from a JAX
    one's parameters; the routers' weights and correction biases stay f32."""
    from .deepseek import DeepseekForCausalLM

    params = _without_rope(params)
    model = DeepseekForCausalLM(text, mla, moe_cfg, device=device, dtype=dtype, lm_head="lm_head.weight" in params,
                                attention_bias=any(k.endswith("attn.kv_a.bias") for k in params))
    f32 = tuple(k.replace("blocks.mods.", "blocks.") for k in params if ".mlp.router." in k)
    return module_from_jax(model, params, device, dtype, f32=f32)


def openelm_from_jax_params(params: dict[str, np.ndarray], cfg, device, dtype=torch.float32):
    """The port's OpenELMForCausalLM from a JAX one's parameters."""
    from .openelm import OpenELMForCausalLM

    return module_from_jax(OpenELMForCausalLM(cfg, device=device, dtype=dtype), _without_rope(params), device, dtype)


def predictors_from_jax(predictors, device) -> list:
    """`sparse_model`'s predictors from the JAX `make_predictors` output (one
    (pred_down [r, d], pred_up [ff, r]) a layer, as numpy): f32 tensors."""
    return [tuple(torch.from_numpy(np.array(a, np.float32)).to(device) for a in pair) for pair in predictors]
