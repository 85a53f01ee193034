"""Ulysses (DeepSpeed-style) sequence parallelism: all-to-all head/sequence
resharding around attention; counterpart of `mllm_tpu/parallel/ulysses.py`.

Per rank (p = the axis size):
    [B, S/p, H, D]  --all_to_all-->  [B, S, H/p, D]
    full-sequence causal attention over the local head group (`nn.attention.sdpa`)
    [B, S, H/p, D]  --all_to_all-->  [B, S/p, H, D]
Two exchanges of the activations (`comm.all_to_all_axis`, over
`all_to_all_single`, its backward the inverse exchange) in place of ring
attention's p rotations of K/V.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..nn.attention import sdpa
from .comm import all_to_all_axis, axis_size


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, axis: str = "sp",
                      causal: bool = True, scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention over the whole sequence with this rank's block:
    q [B, S/p, H, D], k/v [B, S/p, H_kv, D] -> [B, S/p, H, D]. Needs
    H % p == 0; kv heads that p does not divide are repeated to H first."""
    h, hkv, d = q.shape[2], k.shape[2], q.shape[3]
    if scale is None:
        scale = d**-0.5
    p = axis_size(mesh, axis)
    if h % p:
        raise ValueError(f"Ulysses needs q heads {h} % mesh axis {p} == 0")
    if hkv % p:  # expand GQA kv heads so the head split divides
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    qg = all_to_all_axis(q, mesh, axis, split=2, concat=1)
    kg = all_to_all_axis(k, mesh, axis, split=2, concat=1)
    vg = all_to_all_axis(v, mesh, axis, split=2, concat=1)
    out = sdpa(qg, kg.transpose(1, 2), vg.transpose(1, 2), causal=causal, scale=scale)  # GQA inside the group
    return all_to_all_axis(out, mesh, axis, split=1, concat=2)
