"""Ring attention: sequence parallelism over a mesh axis; counterpart of
`mllm_tpu/parallel/ring_attention.py`.

Each rank holds one block of the sequence. K/V blocks rotate around the
ring (`comm.ring_shift`, point-to-point over `batch_isend_irecv`, with a
backward that rotates the gradients back) while each rank accumulates its
queries' online-softmax state: attention over N*S tokens with the memory of
S. Causal masking is by absolute position, so the rotation order does not
matter; blocks entirely above the diagonal are still computed (masked), the
simple ring schedule of the JAX function. Plain torch in f32: the flash
kernel gives no log-sum-exp to merge (and has no backward).
"""

from __future__ import annotations

from typing import Optional

import torch

from .comm import axis_rank, axis_size, ring_shift

NEG_INF = -1e30


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, axis: str = "sp",
                   causal: bool = True, scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention over the whole sequence, this rank's block:
    q [B, S/n, H, D], k/v [B, S/n, H_kv, D] (the rank's rows) ->
    [B, S/n, H, D] in q's dtype."""
    b, sl, h, d = q.shape
    hkv = k.shape[2]
    n_rep = h // hkv
    if scale is None:
        scale = d**-0.5
    n, idx = axis_size(mesh, axis), axis_rank(mesh, axis)
    qf = q.float() * scale
    m = torch.full((b, sl, h, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, sl, h, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sl, h, d), dtype=torch.float32, device=q.device)
    kv = torch.cat([k, v], dim=-1)  # one rotation carries both
    pos = torch.arange(sl, device=q.device)
    for r in range(n):
        src = (idx - r) % n  # the rank whose block kv holds now
        kr, vr = kv[..., :d], kv[..., d:]
        if n_rep > 1:
            kr = kr.repeat_interleave(n_rep, dim=2)
            vr = vr.repeat_interleave(n_rep, dim=2)
        sij = torch.einsum("bqhd,bkhd->bqhk", qf, kr.float())
        if causal:
            ok = (src * sl + pos)[None, :] <= (idx * sl + pos)[:, None]  # [Sq, Sk]
            sij = torch.where(ok[None, :, None, :], sij, torch.full_like(sij, NEG_INF))
        m_new = torch.maximum(m, sij.amax(-1, keepdim=True))
        p = torch.exp(sij - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bqhk,bkhd->bqhd", p, vr.float())
        m = m_new
        if r < n - 1:
            kv = ring_shift(kv, mesh, axis)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l).to(q.dtype)
