"""Expert parallelism: MoE expert weights split over a mesh axis;
counterpart of `mllm_tpu/parallel/expert.py`.

Each rank owns E/ep experts, computes its experts' contributions for every
token (the router runs replicated) and the contributions are summed over the
axis (`reduce_from_axis`): the all-to-all-free dense-dispatch formulation,
right for the small expert counts of the MiniCPM-MoE / Qwen2-MoE class.
"""

from __future__ import annotations

import torch

from ..models.moe import route
from ..nn.layers import ACT_FN, matmul_f32
from .comm import axis_rank, axis_size, copy_to_axis, reduce_from_axis


def moe_forward_ep(moe, x: torch.Tensor, mesh, axis: str = "ep") -> torch.Tensor:
    """Expert-parallel forward of a `MoEMLP`: x [B, S, d] -> [B, S, d].

    The rank reads its experts' slices of w_gate / w_up / w_down (views of
    the module's stacks, experts r*E/ep .. (r+1)*E/ep - 1). As the JAX
    function: per local expert, the tokens' products in x's dtype, the
    output in f32 times the token's routing weight (0 when not routed), the
    f32 sum over the axis, one rounding to x's dtype; then the shared expert
    (with its sigmoid gate, where the module has one) is added.
    Gradients: x's is whole on every rank; each rank's expert stacks get
    their own experts' gradients, and the replicated router weight each
    rank's share (sum it over the axis, as data parallelism sums)."""
    e = moe.w_gate.shape[0]
    ep = axis_size(mesh, axis)
    if e % ep:
        raise ValueError(f"{e} experts not divisible by ep={ep}")
    e_local = e // ep
    base = axis_rank(mesh, axis) * e_local
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    # the router's and the local experts' input: each rank's gradient of it
    # is its experts' share, all-reduced in the backward (`copy_to_axis`)
    xe = copy_to_axis(xf, mesh, axis)
    top_p, top_i = route(xe, moe.router_weight, moe.top_k, moe.norm_topk_prob)
    act = ACT_FN[moe.act]
    y = torch.zeros(b * s, d, dtype=torch.float32, device=x.device)
    for le in range(e_local):
        ge = base + le
        w_tok = torch.where(top_i == ge, top_p, torch.zeros((), device=x.device)).sum(-1)  # [t]
        h = xe @ moe.w_gate[ge].to(xe.dtype)
        u = xe @ moe.w_up[ge].to(xe.dtype)
        o = (act(h) * u) @ moe.w_down[ge].to(xe.dtype)
        y = y + o.float() * w_tok[:, None]
    out = reduce_from_axis(y, mesh, axis).reshape(b, s, d).to(x.dtype)
    if moe.shared_expert is not None:
        sh = moe.shared_expert(xf)
        if moe.shared_gate is not None:
            sh = sh * torch.sigmoid(matmul_f32(xf, moe.shared_gate)).to(sh.dtype)
        out = out + sh.reshape(b, s, d).to(out.dtype)
    return out
