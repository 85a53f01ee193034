"""Model registry and auto loading from a checkpoint directory: counterpart
of `mllm_tpu/models/registry.py` for the text families (dense and MoE),
Qwen2-VL, Qwen2.5-VL, LLaVA, Phi-3-V, Fuyu, CLIP, ViT, OPT and BERT.

`auto_model(path)` reads an HF `config.json` (or takes a named preset),
builds the CausalLM, loads its weights from safetensors or `.mllm`
container(s) and returns (model, tokenizer, config), the tokenizer read
from the directory's `tokenizer.json`; a vision-language or encoder
checkpoint goes to `auto_model_any`, which returns (model, kind).
Options the port does not have yet raise NotImplementedError naming the
ROADMAP item that brings them; so does a model_type the port does not build.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from ..core.config import TextConfig, from_hf_config
from ..core.param_loader import MultiFileParamLoader, ParamLoader, SafetensorsLoader
from ..ops.quantize_model import check_mode
from ..utils.runtime import default_device
from .families import PRESETS
from .loading import load_causal_lm

# model_types whose checkpoints are a dense CausalLM with HF names (minicpm:
# the llama topology with its multipliers in TextConfig)
DENSE_TYPES = ("qwen2", "qwen3", "llama", "mistral", "gemma", "gemma2", "stablelm", "phi3",
               "phonelm", "smollm", "dclm", "tinyllama", "minicpm")
MOE_TYPES = ("mixtral", "qwen2_moe", "minicpm_moe", "bailing_moe", "smallthinker")

# model_types that are not bare CausalLMs: `auto_model` hands them to
# `auto_model_any` (JAX `_ANY_TYPES`)
ANY_TYPES = ("opt", "bert", "clip", "llava", "vit", "fuyu", "phi3_v", "phi3v", "qwen2_vl", "qwen2_5_vl")


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"mllm_tpu_torch does not port {what} yet: {item}")


def build_model(cfg: TextConfig, loader, *, device, dtype=torch.bfloat16, quant=None):
    """Dispatch on model_type to the function that builds the architecture."""
    mt = cfg.model_type
    if mt in DENSE_TYPES:
        return load_causal_lm(loader, cfg, device=device, dtype=dtype, quant=quant)
    if mt in MOE_TYPES:
        from .moe import load_moe_mlp

        kw = dict(device=device, dtype=dtype, quant=quant)
        if mt == "mixtral":  # block_sparse_moe with experts w1 (gate) / w3 (up) / w2 (down)
            names = tuple(f"experts.{{e}}.{w}.weight" for w in ("w1", "w3", "w2"))
            # int4-mixed quantizes mixtral's experts as "int4"; the other
            # families' experts stay float under it (JAX registry.py:140-143)
            mkw = {**kw, "quant": "int4" if quant == "int4-mixed" else quant}

            def mlp_builder(ld, prefix, i):
                return load_moe_mlp(ld, prefix + "block_sparse_moe.", cfg, expert_names=names, **mkw)
        elif mt == "minicpm_moe":
            def mlp_builder(ld, prefix, i):
                return load_moe_mlp(ld, prefix + "mlp.", cfg, **kw)
        else:  # qwen2_moe; bailing (Ling) and smallthinker follow its names
            def mlp_builder(ld, prefix, i):
                return load_moe_mlp(ld, prefix + "mlp.", cfg, shared_prefix="shared_expert.",
                                    shared_gate_name="shared_expert_gate", **kw)
        return load_causal_lm(loader, cfg, device=device, dtype=dtype, quant=quant,
                              mlp_builder=mlp_builder)
    raise _not_ported(f"model_type {cfg.model_type!r}", "no ROADMAP item names it")


def open_loader(path: str):
    """Open a checkpoint: `.mllm` file(s) (a directory holding `.mllm` files
    and no safetensors reads them all) or a safetensors file or directory
    (JAX `open_loader`)."""
    if os.path.isdir(path):
        mllms = [f for f in sorted(os.listdir(path)) if f.endswith(".mllm")]
        if mllms and not any(f.endswith(".safetensors") for f in os.listdir(path)):
            return MultiFileParamLoader([os.path.join(path, f) for f in mllms])
        return SafetensorsLoader(path)
    if path.endswith(".mllm"):
        return ParamLoader(path)
    return SafetensorsLoader(path)


def auto_config(path_or_preset: str, **overrides) -> TextConfig:
    if path_or_preset in PRESETS:
        cfg = PRESETS[path_or_preset]
        return cfg.replace(**overrides) if overrides else cfg
    cfg_json = path_or_preset
    if os.path.isdir(path_or_preset):
        cfg_json = os.path.join(path_or_preset, "config.json")
    return from_hf_config(cfg_json, **overrides)


def auto_model_any(path: str, dtype=torch.bfloat16, quant=None, *, device=None):
    """(model, kind) for any checkpoint directory (JAX `auto_model_any`):
    opt, bert, clip, llava, vit, fuyu, phi3_v / phi3v (kind "phi3v"),
    qwen2_vl and qwen2_5_vl (quant applies to the LM's Linears of the
    vision-language ones, as there), or a CausalLM ("causal_lm"). The model
    goes to the card unless `device` says otherwise."""
    with open(os.path.join(path, "config.json")) as f:
        mt = json.load(f).get("model_type", "")
    if quant is not None:
        check_mode(quant)
    dev = device or default_device()
    if mt == "opt":
        from .opt import load_opt, opt_config_from_hf

        return load_opt(open_loader(path), opt_config_from_hf(path), device=dev, dtype=dtype), "opt"
    if mt == "bert":
        from .bert import bert_config_from_hf, load_bert

        return load_bert(open_loader(path), bert_config_from_hf(path), device=dev, dtype=dtype), "bert"
    if mt == "llava":
        from .llava import llava_config_from_hf, load_llava

        return load_llava(open_loader(path), llava_config_from_hf(path), device=dev, dtype=dtype,
                          quant=quant), "llava"
    if mt == "fuyu":
        from .fuyu import fuyu_config_from_hf, load_fuyu

        return load_fuyu(open_loader(path), fuyu_config_from_hf(path), device=dev, dtype=dtype,
                         quant=quant), "fuyu"
    if mt in ("phi3_v", "phi3v"):
        from .phi3v import load_phi3v, phi3v_config_from_hf

        return load_phi3v(open_loader(path), phi3v_config_from_hf(path), device=dev, dtype=dtype,
                          quant=quant), "phi3v"
    if mt == "clip":
        from .clip import clip_config_from_hf, load_clip

        return load_clip(open_loader(path), clip_config_from_hf(path), device=dev, dtype=dtype), "clip"
    if mt == "vit":
        from .vit import load_vit_classifier, vit_config_from_hf

        vcfg, n_labels, id2label = vit_config_from_hf(path)
        return load_vit_classifier(open_loader(path), vcfg, n_labels, device=dev, dtype=dtype,
                                   id2label=id2label), "vit"
    if mt == "qwen2_5_vl":
        from .qwen2_5_vl import load_qwen2_5_vl, qwen2_5_vl_configs_from_hf

        base, vcfg = qwen2_5_vl_configs_from_hf(path)
        return load_qwen2_5_vl(open_loader(path), base, vcfg, device=dev, dtype=dtype, quant=quant), "qwen2_5_vl"
    if mt == "qwen2_vl":
        from .qwen2_vl import load_qwen2_vl, qwen2_vl_config_from_hf

        return load_qwen2_vl(open_loader(path), qwen2_vl_config_from_hf(path), device=dev, dtype=dtype,
                             quant=quant), "qwen2_vl"
    model, _, _ = auto_model(path, dtype, quant, with_tokenizer=False, device=dev)
    return model, "causal_lm"


def auto_model(path: str, dtype=torch.bfloat16, quant=None, config: Optional[TextConfig] = None,
               with_tokenizer: bool = True, *, device=None, **overrides):
    """Load (model, tokenizer, cfg) from an HF-style model directory (JAX
    `auto_model`). The tokenizer is `auto_tokenizer(path)` when the directory
    holds a tokenizer.json and with_tokenizer is set, else None.

    quant="int8" | "int8-a8" | "int4" | "int4-mixed" quantizes the
    checkpoint's float Linears at load (int4-mixed: attention int8, the rest
    int4; ggml blocks repack whatever quant says); other modes raise
    NotImplementedError. The model goes to the card unless `device` says
    otherwise. A vision-language or encoder checkpoint (ANY_TYPES) is loaded
    by `auto_model_any`; its config is then the model's `cfg` (None for a ViT
    classifier), as in the JAX package."""
    if quant is not None:
        check_mode(quant)
    model = None
    if config is None and os.path.isdir(path):
        cfg_json = os.path.join(path, "config.json")
        if os.path.exists(cfg_json):
            with open(cfg_json) as f:
                mt = json.load(f).get("model_type", "")
            if mt in ANY_TYPES:
                model, _ = auto_model_any(path, dtype, quant, device=device)
                cfg = getattr(model, "cfg", None)
    if model is None:
        cfg = config or auto_config(path, **overrides)
        model = build_model(cfg, open_loader(path), device=device or default_device(), dtype=dtype,
                            quant=quant)
    tok = None
    if with_tokenizer and os.path.isdir(path) and os.path.exists(os.path.join(path, "tokenizer.json")):
        from ..tokenizers.hf_json import auto_tokenizer

        tok = auto_tokenizer(path)
    return model, tok, cfg
