"""Pipeline parallelism (GPipe microbatching) over a mesh axis: counterpart
of `mllm_tpu/parallel/pipeline.py`.

Layers are split into S stages, one per rank along the "pp" axis; M
microbatches flow stage to stage. Each rank runs its stage on microbatch
0..M-1 in order, receiving from the previous stage and sending to the next
with hand-written point-to-point ops whose backwards send the gradient the
other way (`_Recv`, `_Send`); the sends do not wait for the next stage, so
the stages overlap as in the GPipe schedule, finishing after S + M - 1
stage steps. The last stage maps each finished microbatch through `last_fn`
(norm, lm_head and the loss live there) and the stacked results are
broadcast to every rank.

Gradients: each rank's backward reaches only its own stage's parameters (and
the embedding on stage 0, the head on the last stage), so the gradient of a
parameter held by every rank is the sum over the axis, as in data
parallelism (the tests all-reduce them).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .comm import axis_group, axis_rank, axis_size


def _peer(group, offset: int) -> int:
    return dist.get_global_rank(group, dist.get_rank(group) + offset)


class _Recv(torch.autograd.Function):
    """Forward: receive a tensor like `like` from the previous stage.
    Backward: send its gradient back. `anchor` (a leaf that requires grad)
    puts the node into the graph."""

    @staticmethod
    def forward(ctx, anchor, like, group):
        ctx.group = group
        out = torch.empty_like(like)
        dist.recv(out, _peer(group, -1), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        dist.send(g.contiguous(), _peer(ctx.group, -1), group=ctx.group)
        return None, None, None


class _Send(torch.autograd.Function):
    """Forward: send x to the next stage; returns an empty tensor to be added
    into the stage's result, so the backward runs. Backward: receive x's
    gradient from the next stage."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.like = group, torch.empty_like(x)
        dist.send(x.contiguous(), _peer(group, 1), group=group)
        return x.new_zeros(0)

    @staticmethod
    def backward(ctx, _):
        g = torch.empty_like(ctx.like)
        dist.recv(g, _peer(ctx.group, 1), group=ctx.group)
        return g, None


class _FromLast(torch.autograd.Function):
    """Broadcast the last stage's result to every stage. Backward: the last
    stage keeps its gradient, the others' copies pass none on (the result is
    replicated: one copy's gradient is the whole one)."""

    @staticmethod
    def forward(ctx, x, group, src):
        ctx.keep = dist.get_rank(group) == src
        x = x.contiguous().clone()
        dist.broadcast(x, dist.get_global_rank(group, src), group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.keep else torch.zeros_like(g)), None, None


def pipeline_forward(stage_params, x, stage_fn: Callable, mesh, axis: str = "pp",
                     last_fn: Callable = None, aux=None):
    """Run x [M, mb, ...] through S stages, stage s on the rank with index s
    along `axis`. stage_params[s] is stage s's parameters (a stacked tensor
    or a list; this rank reads its own entry). With `last_fn(h, aux[m])`
    the last stage maps each finished microbatch through it and the result
    is the stacked last_fn outputs [M, ...]; otherwise the last hidden
    states [M, mb, ...]. Returned on every rank; differentiable."""
    s_count, idx = axis_size(mesh, axis), axis_rank(mesh, axis)
    group = axis_group(mesh, axis)
    params = stage_params[idx]
    m = x.shape[0]
    # in grad mode every send and receive joins the graph on every rank, so
    # the backward's point-to-point ops pair up whatever requires grad
    anchor = torch.zeros((), device=x.device, requires_grad=torch.is_grad_enabled())
    outputs, sent = [], []
    for i in range(m):
        h = (x[i] + anchor if anchor.requires_grad else x[i]) if idx == 0 else _Recv.apply(anchor, x[i], group)
        h = stage_fn(params, h)
        if idx < s_count - 1:
            sent.append(_Send.apply(h, group))
        elif last_fn is None:
            outputs.append(h)
        else:
            outputs.append(last_fn(h, aux[i]))
    if idx == s_count - 1:
        out = torch.stack(outputs)
        meta = [tuple(out.shape), out.dtype]
    else:
        meta = [None, None]
    dist.broadcast_object_list(meta, dist.get_global_rank(group, s_count - 1), group=group)
    if idx != s_count - 1:
        out = torch.zeros(meta[0], dtype=meta[1], device=x.device)
    out = _FromLast.apply(out, group, s_count - 1)
    for t in sent:  # ties every send into the graph (adds zeros)
        out = out + t.sum()
    return out


def stack_stages(block_list, n_stages: int) -> list:
    """Group per-layer blocks into `n_stages` lists of consecutive layers."""
    n = len(block_list)
    per = n // n_stages
    if per * n_stages != n:
        raise ValueError(f"{n} layers not divisible into {n_stages} stages")
    return [list(block_list[s * per:(s + 1) * per]) for s in range(n_stages)]


def _trunk_inputs(model, input_ids, n_microbatches: int):
    b, s = input_ids.shape
    if b % n_microbatches:
        raise ValueError(f"batch {b} % microbatches {n_microbatches}")
    from ..models.transformer import in_dtype

    x = model.embed_tokens(input_ids)
    if model.cfg.embedding_multiplier != 1.0:
        x = x * in_dtype(model.cfg.embedding_multiplier, x.dtype)
    positions = torch.arange(s, device=x.device)[None, :]

    def stage_fn(blocks, h):
        for blk in blocks:
            h, _ = blk(h, model.rope, None, positions)
        return h

    return x.reshape(n_microbatches, b // n_microbatches, s, x.shape[-1]), stage_fn


def pipeline_lm_hidden(model, input_ids, mesh, axis: str = "pp", n_microbatches: int = 4):
    """The cacheless CausalLM trunk as a GPipe pipeline of its own
    DecoderBlocks (mesh.size(axis) stages; embedding, final norm and lm_head
    on every rank). Returns hidden states [B, S, D], those of
    `model.hidden_states`."""
    b, s = input_ids.shape
    xmb, stage_fn = _trunk_inputs(model, input_ids, n_microbatches)
    out = pipeline_forward(stack_stages(model.blocks, axis_size(mesh, axis)), xmb, stage_fn, mesh, axis=axis)
    return model.norm(out.reshape(b, s, -1))


def pipeline_lm_loss(model, input_ids, targets, mesh, axis: str = "pp", n_microbatches: int = 4):
    """GPipe training loss: the trunk's stages on the "pp" axis; norm,
    lm_head and cross-entropy on the last stage per microbatch (the
    [mb, S, V] logits never leave it); the mean over microbatches. Equal to
    `model.loss`, and differentiable (gradients as the module docstring
    says)."""
    b, s = input_ids.shape
    xmb, stage_fn = _trunk_inputs(model, input_ids, n_microbatches)

    def last_fn(h, tgt):
        logp = torch.log_softmax(model.logits(model.norm(h)), dim=-1)
        return -logp.gather(-1, tgt[..., None].long())[..., 0].mean()

    tmb = targets.reshape(n_microbatches, b // n_microbatches, s)
    losses = pipeline_forward(stack_stages(model.blocks, axis_size(mesh, axis)), xmb, stage_fn, mesh,
                              axis=axis, last_fn=last_fn, aux=tmb)
    return losses.mean()
