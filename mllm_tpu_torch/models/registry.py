"""Model registry and auto loading from a checkpoint directory: counterpart
of `mllm_tpu/models/registry.py` for the dense text families.

`auto_model(path)` reads an HF `config.json` (or takes a named preset),
builds the CausalLM and loads its safetensors weights. Architectures,
containers and options this slice does not port raise NotImplementedError
naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from ..core.config import TextConfig, from_hf_config
from ..core.param_loader import SafetensorsLoader
from ..ops.quantize_model import check_mode
from ..utils.runtime import default_device
from .families import PRESETS
from .loading import load_causal_lm

# model_types whose checkpoints are a plain dense CausalLM with HF names
DENSE_TYPES = ("qwen2", "qwen3", "llama", "mistral", "tinyllama", "smollm")

_LATER = {
    **dict.fromkeys(("gemma", "gemma2", "stablelm", "phi3", "phonelm", "dclm", "minicpm",
                     "opt", "bert", "clip", "vit", "mixtral", "qwen2_moe", "minicpm_moe",
                     "bailing_moe", "smallthinker"), "ROADMAP Queue 1 item 14"),
    **dict.fromkeys(("qwen2_vl", "qwen2_5_vl", "llava", "fuyu", "phi3_v", "phi3v"),
                    "ROADMAP Queue 1 item 13"),
}


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"mllm_tpu_torch does not port {what} yet: {item}")


def build_model(cfg: TextConfig, loader, *, device, dtype=torch.bfloat16, quant=None):
    """Dispatch on model_type to the function that builds the architecture."""
    if cfg.model_type in DENSE_TYPES:
        return load_causal_lm(loader, cfg, device=device, dtype=dtype, quant=quant)
    raise _not_ported(f"model_type {cfg.model_type!r}",
                      _LATER.get(cfg.model_type, "no ROADMAP item names it"))


def open_loader(path: str):
    """Safetensors file or directory."""
    if path.endswith(".mllm") or (os.path.isdir(path) and not any(
            f.endswith(".safetensors") for f in os.listdir(path))):
        raise _not_ported("the .mllm container reader", "ROADMAP Queue 1 item 6")
    return SafetensorsLoader(path)


def auto_config(path_or_preset: str, **overrides) -> TextConfig:
    if path_or_preset in PRESETS:
        cfg = PRESETS[path_or_preset]
        return cfg.replace(**overrides) if overrides else cfg
    cfg_json = path_or_preset
    if os.path.isdir(path_or_preset):
        cfg_json = os.path.join(path_or_preset, "config.json")
    return from_hf_config(cfg_json, **overrides)


def auto_model(path: str, dtype=torch.bfloat16, quant=None, config: Optional[TextConfig] = None,
               with_tokenizer: bool = True, *, device=None, **overrides):
    """Load (model, tokenizer, cfg) from an HF-style model directory.

    quant="int8" | "int4" quantizes the float checkpoint's Linears at load;
    other modes raise NotImplementedError. The tokenizer is not ported yet:
    with_tokenizer=True on a directory that holds a tokenizer.json raises
    rather than returning None."""
    if quant is not None:
        check_mode(quant)
    if config is None and os.path.isdir(path):
        cfg_json = os.path.join(path, "config.json")
        if os.path.exists(cfg_json):
            with open(cfg_json) as f:
                mt = json.load(f).get("model_type", "")
            if mt in _LATER:
                raise _not_ported(f"model_type {mt!r}", _LATER[mt])
    cfg = config or auto_config(path, **overrides)
    if with_tokenizer and os.path.isdir(path) and os.path.exists(os.path.join(path, "tokenizer.json")):
        raise _not_ported("tokenizers", "ROADMAP Queue 1 item 6")
    model = build_model(cfg, open_loader(path), device=device or default_device(), dtype=dtype,
                        quant=quant)
    return model, None, cfg
