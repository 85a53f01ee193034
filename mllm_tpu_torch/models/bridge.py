"""JAX parameters -> the port's CausalLM.

`causal_lm_from_jax_params` takes the flat `{name: array}` dict that
`mllm_tpu`'s `Module.parameters()` gives, as numpy arrays, and loads it into
`mllm_tpu_torch.models.transformer.CausalLM`. It takes both layouts of the
decoder blocks:
  - unrolled: `blocks.mods.{i}.attn.q_proj.weight`, ...
  - stacked:  `stacked_blocks.attn.q_proj.weight` with a leading [L] axis.
RoPE tables (`rope.sin`, `rope.cos`) are rebuilt from the config, not copied.
Loading is strict: a missing or unexpected name raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.config import TextConfig
from .transformer import CausalLM


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


def causal_lm_from_jax_params(params: dict[str, np.ndarray], cfg: TextConfig, device,
                              dtype=torch.float32) -> CausalLM:
    model = CausalLM(cfg, device=device, dtype=dtype)
    state = {
        k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device=device, dtype=dtype)
        for k, v in port_state_dict(params, cfg.num_hidden_layers).items()
    }
    model.load_state_dict(state, strict=True)
    return model
