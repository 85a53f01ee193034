"""LoRA (low-rank adaptation) fine-tuning: counterpart of
`mllm_tpu/training/lora.py`.

`add_lora` swaps target `Linear` layers for `LoRALinear` (the frozen base
weight and a rank-r delta), `lora_params_filter` restricts training to the
adapters, and `merge_lora` folds the delta back into plain `Linear`s so
inference (quantization and tp sharding included) sees an ordinary model.
The adapters' random draws come from an explicit `torch.Generator`, so they
differ from the JAX `fold_in` keys; `models.bridge` carries JAX adapters
across for parity.
"""

from __future__ import annotations

import re

import torch
from torch import nn

from ..nn.layers import Linear, matmul_f32

DEFAULT_TARGETS = r"(q_proj|k_proj|v_proj|o_proj)"


class LoRALinear(nn.Module):
    """y = x W^T + scale * (x A^T) B^T + bias.

    weight / bias are the frozen base; lora_a [r, in] and lora_b [out, r] are
    the f32 adapters (B zero at the start, so the wrapped layer starts equal
    to the base). The rounding points of the JAX layer: the base product
    accumulated in f32, the adapter path in f32, one cast to x's dtype, then
    the bias added in that dtype."""

    def __init__(self, weight: torch.Tensor, bias, lora_a: torch.Tensor, lora_b: torch.Tensor, scale: float):
        super().__init__()
        self.weight = weight if isinstance(weight, nn.Parameter) else nn.Parameter(weight, requires_grad=False)
        self.bias = None if bias is None else (bias if isinstance(bias, nn.Parameter)
                                               else nn.Parameter(bias, requires_grad=False))
        self.lora_a = nn.Parameter(lora_a, requires_grad=False)
        self.lora_b = nn.Parameter(lora_b, requires_grad=False)
        self.scale = scale

    @staticmethod
    def wrap(lin: Linear, generator: torch.Generator, rank: int, alpha: float) -> "LoRALinear":
        """A ~ N(0, 1) / rank from `generator`, B = 0, scale = alpha / rank."""
        out_f, in_f = lin.weight.shape
        dev = lin.weight.device
        a = torch.randn(rank, in_f, generator=generator, device=generator.device,
                        dtype=torch.float32).to(dev) * (1.0 / rank)
        b = torch.zeros(out_f, rank, dtype=torch.float32, device=dev)
        return LoRALinear(lin.weight, lin.bias, a, b, alpha / rank)

    def forward(self, x):
        y = matmul_f32(x, self.weight)
        xa = torch.nn.functional.linear(x.float(), self.lora_a)
        y = (y + self.scale * torch.nn.functional.linear(xa, self.lora_b)).to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y

    def merged(self) -> Linear:
        """The plain Linear with the delta folded in: (W in f32 + scale * B A)
        rounded to W's dtype; the bias kept."""
        with torch.no_grad():
            delta = self.scale * (self.lora_b @ self.lora_a)  # [out, in]
            w = (self.weight.float() + delta).to(self.weight.dtype)
        return Linear.from_tensors(w, None if self.bias is None else self.bias.detach())


def _map_linears(module: nn.Module, fn, path: str = "") -> nn.Module:
    """Apply fn(path, layer) to every plain Linear and LoRALinear under
    `module` (paths as `named_modules` gives them), replacing the layer with
    what fn returns. In place; returns `module` (or fn's result when
    `module` is itself such a layer)."""
    if type(module) is Linear or isinstance(module, LoRALinear):
        return fn(path, module)
    for name, child in list(module.named_children()):
        if child is None:
            continue
        new = _map_linears(child, fn, f"{path}.{name}" if path else name)
        if new is not child:
            setattr(module, name, new)
    return module


def add_lora(model: nn.Module, generator: torch.Generator, rank: int = 8, alpha: float = 16.0,
             targets: str = DEFAULT_TARGETS) -> nn.Module:
    """Swap every plain Linear whose path matches `targets` (a regex, searched
    in the `named_modules` path) for a LoRALinear over the same base tensors.
    In place; returns the model. Raises if nothing matched, and on a model
    from `parallel.sharding.shard_model` (add the adapters first: a
    LoRALinear stays whole on every rank)."""
    from ..parallel.sharding import ColumnParallelLinear, RowParallelLinear

    pat = re.compile(targets)
    for path, mod in model.named_modules():
        if isinstance(mod, (ColumnParallelLinear, RowParallelLinear)) and pat.search(path):
            raise ValueError(f"add_lora: {path} is a tensor-parallel shard; add the adapters before shard_model")
    count = [0]

    def fn(path, lin):
        if isinstance(lin, LoRALinear) or not pat.search(path):
            return lin
        count[0] += 1
        return LoRALinear.wrap(lin, generator, rank, alpha)

    model = _map_linears(model, fn)
    if count[0] == 0:
        raise ValueError(f"no Linear matched targets {targets!r}")
    return model


def merge_lora(model: nn.Module) -> nn.Module:
    """Fold every LoRALinear back into a plain Linear. In place; returns the model."""
    return _map_linears(model, lambda path, lin: lin.merged() if isinstance(lin, LoRALinear) else lin)


def lora_params_filter(path: str) -> bool:
    """The `trainable` predicate of `make_train_step`: the adapters only."""
    return "lora_a" in path or "lora_b" in path
