"""Training loop primitives: optimizer state and checkpoint / resume;
counterpart of `mllm_tpu/training/train.py`.

`CausalLM.loss` is differentiable; this module adds a `torch.optim`
optimizer over a chosen parameter subset (`partition`), the train step, and
checkpoints of the model, the optimizer state and the step. The JAX package
checkpoints with orbax; here a checkpoint is one torch file, which does not
load into the JAX package (nor an orbax checkpoint here).
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import torch

CHECKPOINT_FORMAT = "mllm_tpu_torch.training.checkpoint/1"


def partition(model: torch.nn.Module, trainable: Optional[Callable[[str], bool]] = None) -> list:
    """Set requires_grad on the float parameters `trainable(name)` accepts
    (every float parameter when it is None) and clear it on every other
    parameter; returns the trainable ones in `named_parameters` order."""
    out = []
    for name, p in model.named_parameters():
        on = p.is_floating_point() and (trainable is None or trainable(name))
        p.requires_grad_(on)
        if on:
            out.append(p)
    return out


class TrainState:
    """The model, a `torch.optim` optimizer over its trainable parameters, and
    the step count."""

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer, step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.step = step

    @staticmethod
    def create(model, optimizer_factory: Callable, trainable: Optional[Callable[[str], bool]] = None
               ) -> "TrainState":
        """optimizer_factory(params) -> a torch.optim optimizer, e.g.
        `lambda ps: torch.optim.AdamW(ps, lr=1e-4)`; params are the ones
        `partition(model, trainable)` names."""
        return TrainState(model, optimizer_factory(partition(model, trainable)), 0)


def make_train_step(loss_fn: Optional[Callable] = None, trainable: Optional[Callable[[str], bool]] = None):
    """Returns `step(state, batch_ids, batch_targets) -> (state, loss)`: the
    loss (loss_fn(model, ids, targets), default model.loss), its gradients
    with respect to the parameters `partition(model, trainable)` names (every
    float parameter when trainable is None, as in the JAX step), each cast to
    its parameter's dtype (as the JAX step casts), one step of the state's
    optimizer. The JAX step takes the optimizer here; this one's is the
    state's (`TrainState.create`), and a step raises when that optimizer
    does not hold exactly the parameters `trainable` names. The state is
    updated in place and returned; the loss is detached. On a model sharded
    over a mesh with dp > 1 (`parallel.sharding.shard_model`) the gradients
    and the loss are averaged over dp first, as GSPMD's psum does in the JAX
    package."""
    from ..parallel.comm import dp_mean

    def step(state: TrainState, batch_ids, batch_targets):
        params = partition(state.model, trainable)
        held = [p for g in state.optimizer.param_groups for p in g["params"]]
        if {id(p) for p in params} != {id(p) for p in held}:
            raise ValueError(f"make_train_step: `trainable` names {len(params)} parameters, the state's optimizer "
                             f"holds {len(held)} (or other ones); create the state with the same `trainable`")
        if loss_fn is not None:
            loss = loss_fn(state.model, batch_ids, batch_targets)
        else:
            loss = state.model.loss(batch_ids, batch_targets)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads, loss = dp_mean(state.model, params, grads, loss.detach())
        for p, g in zip(params, grads):
            p.grad = None if g is None else g.to(p.dtype)
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        return state, loss.detach()

    return step


def _is_checkpoint(path: str) -> bool:
    try:
        obj = torch.load(path, map_location="cpu", mmap=True, weights_only=True)
    except Exception:
        return False
    return isinstance(obj, dict) and obj.get("format") == CHECKPOINT_FORMAT


def save_checkpoint(path: str, state: TrainState) -> None:
    """Write the model's state dict, the optimizer's state and the step to
    one torch file: first to `path + ".saving"`, then renamed into place.
    An existing `path` is replaced only if it is such a checkpoint."""
    path = os.path.abspath(path)
    tmp = path + ".saving"
    torch.save({"format": CHECKPOINT_FORMAT, "model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(), "step": int(state.step)}, tmp)
    if os.path.exists(path) and not (os.path.isfile(path) and _is_checkpoint(path)):
        os.remove(tmp)
        raise ValueError(f"{path} exists and is not a checkpoint")
    os.replace(tmp, path)


def restore_checkpoint(path: str, template: TrainState) -> TrainState:
    """Load a checkpoint into `template` (a state of the same model and
    optimizer, e.g. freshly `TrainState.create`d): tensors go to the devices
    of the template's. Returns the template."""
    dev = next(template.model.parameters()).device
    obj = torch.load(os.path.abspath(path), map_location=dev, weights_only=True)
    if obj.get("format") != CHECKPOINT_FORMAT:
        raise ValueError(f"{path} is not a checkpoint")
    template.model.load_state_dict(obj["model"])
    template.optimizer.load_state_dict(obj["optimizer"])
    template.step = int(obj["step"])
    return template
