"""Argument handling shared by the attention wrappers and their plain versions."""

from __future__ import annotations

import math
from typing import Optional

import torch

KERNEL_HEAD_DIMS = (64, 128)


def visible_keys(b: int, skv: int, kv_valid_len, kv_start: Optional[torch.Tensor],
                 device) -> torch.Tensor:
    """[B, Skv] bool: kv_start[b] <= j < kv_valid_len[b] (the masks that do not
    depend on the query position)."""
    k_pos = torch.arange(skv, device=device)
    if kv_valid_len is None:
        kvl = torch.full((b,), skv, device=device)
    elif isinstance(kv_valid_len, torch.Tensor):
        kvl = kv_valid_len.to(device).reshape(-1).expand(b)
    else:
        kvl = torch.full((b,), int(kv_valid_len), device=device)
    ok = k_pos[None, :] < kvl[:, None]
    if kv_start is not None:
        ok = ok & (k_pos[None, :] >= torch.as_tensor(kv_start, device=device).reshape(b, 1))
    return ok


def masked_softmax(s: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis of f32 scores `s`, restricted to `ok`:
    masked entries are exactly 0 and a row with no visible key is all 0."""
    s = s.masked_fill(~ok, -math.inf)
    m = s.amax(dim=-1, keepdim=True).clamp_min(-1e30)  # finite for fully masked rows
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    return p / torch.where(l > 0, l, torch.ones_like(l))


def check_kernel_args(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on anything the CUDA attention kernels do not take."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: tensors must lie on the CPU or on a CUDA card, got {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{name}: q, k, v on different devices ({q.device}, {k.device}, {v.device})")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"{name}: the CUDA kernel takes bf16 q/k/v, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: q must be [B,Sq,H,D] and k/v [B,Hkv,S,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[1] != 0:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit k/v {tuple(k.shape)}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: the CUDA kernel takes head_dim in {KERNEL_HEAD_DIMS}, got {d}")
    for t, n in ((q, "q"), (k, "k"), (v, "v")):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {n} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {n} must be 16-byte aligned")


def kv_len_arg(name: str, kv_valid_len, b: int, skv: int, device) -> tuple[int, Optional[torch.Tensor]]:
    """(scalar length, per-sequence int32 [B] on device or None)."""
    if kv_valid_len is None:
        return skv, None
    if isinstance(kv_valid_len, torch.Tensor):
        vec = kv_valid_len.reshape(-1).to(device=device, dtype=torch.int32)
        if vec.numel() == 1:
            vec = vec.expand(b)
        if vec.numel() != b:
            raise ValueError(f"{name}: kv_valid_len has {vec.numel()} entries for batch {b}")
        return 0, vec.contiguous()
    n = int(kv_valid_len)
    if not 0 <= n <= skv:
        raise ValueError(f"{name}: kv_valid_len {n} outside [0, {skv}]")
    return n, None


def kv_start_arg(name: str, kv_start, b: int, device) -> Optional[torch.Tensor]:
    """int32 [B] on device, or None."""
    if kv_start is None:
        return None
    vec = torch.as_tensor(kv_start).reshape(-1).to(device=device, dtype=torch.int32).contiguous()
    if vec.numel() != b:
        raise ValueError(f"{name}: kv_start has {vec.numel()} entries for batch {b}")
    return vec
