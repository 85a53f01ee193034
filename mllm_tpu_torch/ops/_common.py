"""Argument handling shared by the attention wrappers and their plain versions."""

from __future__ import annotations

import math
from typing import Optional

import torch

KERNEL_HEAD_DIMS = (64, 128, 256)  # the bf16 flash, decode and paged decode kernels
# the bf16 flash kernel also takes 80 (the vision towers' heads, reached through
# `nn.attention.attend_padded_head` only: `attention_route` keeps 80 on `sdpa`)
FLASH_HEAD_DIMS = (64, 80, 128, 256)
QUANT_KERNEL_HEAD_DIMS = (64, 128, 256)  # the kernels over int8 / int4 K/V


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


def decode_visible_keys(b: int, s_max: int, kv_valid_len, kv_start: Optional[torch.Tensor],
                        window: Optional[int], device) -> torch.Tensor:
    """[B, S] bool for a one-token query at the last valid key: the keys of
    `visible_keys`, and with a window only j > kv_valid_len - 1 - window."""
    ok = visible_keys(b, s_max, kv_valid_len, kv_start, device)
    if window is not None:
        if kv_valid_len is None:
            last = torch.full((b,), s_max, device=device)
        else:
            last = torch.as_tensor(kv_valid_len, device=device).reshape(-1).expand(b)
        k_pos = torch.arange(s_max, device=device)
        ok = ok & (k_pos[None, :] > last[:, None] - 1 - window)
    return ok


def flash_visible_keys(b: int, sq: int, skv: int, q_offset, kv_valid_len,
                       kv_start: Optional[torch.Tensor], causal: bool, window: Optional[int],
                       device) -> torch.Tensor:
    """[B, Sq or 1, Skv] bool: key j is visible from query row s when
    kv_start[b] <= j < kv_valid_len[b] and, if causal, j <= q_pos and
    j > q_pos - window (q_pos = q_offset + s; q_offset an int or [B])."""
    ok = visible_keys(b, skv, kv_valid_len, kv_start, device)[:, None, :]  # [B, 1, Skv]
    if causal:
        q_pos = torch.as_tensor(q_offset, device=device).reshape(-1, 1) + torch.arange(sq, device=device)
        k_pos = torch.arange(skv, device=device)
        c = k_pos[None, None, :] <= q_pos[:, :, None]  # [1 or B, Sq, Skv]
        if window is not None:
            c = c & (k_pos[None, None, :] > q_pos[:, :, None] - window)
        ok = ok & c
    return ok


def masked_exp(s: torch.Tensor, ok: torch.Tensor, exp=torch.exp):
    """The unnormalised softmax over the last axis of f32 scores `s`,
    restricted to `ok`: (p, l) with p = exp(s - max) (exactly 0 where masked)
    and l = sum p, or 1 for a row with no visible key (so p / l is 0 there)."""
    s = s.masked_fill(~ok, -math.inf)
    m = s.amax(dim=-1, keepdim=True).clamp_min(-1e30)  # finite for fully masked rows
    p = exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    return p, torch.where(l > 0, l, torch.ones_like(l))


def masked_softmax(s: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis of f32 scores `s`, restricted to `ok`:
    masked entries are exactly 0 and a row with no visible key is all 0."""
    p, l = masked_exp(s, ok)
    return p / l


def on_cpu(t: torch.Tensor) -> bool:
    """The wrappers' device test: a CPU tensor takes the plain version, any
    other launches the kernel or raises."""
    return t.device.type == "cpu"


def refuse_grad(name: str, *inputs) -> None:
    """Raise when grad mode is on and an input (a tensor, or a tuple of them)
    requires grad. A CUDA kernel is a launch outside autograd: its output
    would carry no gradient and nothing would say so. Each wrapper calls this
    first on its device branch; a loss that needs gradients through attention
    takes `sdpa` (`nn.attention.attention_route`), as the reference sends
    every call off the TPU to XLA."""
    if not torch.is_grad_enabled():
        return
    stack = list(inputs)
    while stack:
        t = stack.pop()
        if isinstance(t, (tuple, list)):
            stack.extend(t)
        elif isinstance(t, torch.Tensor) and t.requires_grad:
            raise RuntimeError(f"{name}: an input requires grad, and the CUDA kernel has no backward; "
                               "run it under torch.no_grad() or take the plain PyTorch route")


def check_kernel_args(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      head_dims: tuple = KERNEL_HEAD_DIMS) -> None:
    """Raise on anything the CUDA attention kernels do not take (a head_dim
    outside `head_dims` among it)."""
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
    if d not in head_dims:
        raise ValueError(f"{name}: the CUDA kernel takes head_dim in {head_dims}, got {d}")
    for t, n in ((q, "q"), (k, "k"), (v, "v")):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {n} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {n} must be 16-byte aligned")


def check_quant_kv_args(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        k_scale: torch.Tensor, v_scale: torch.Tensor) -> int:
    """Raise on anything the quantized-cache kernels do not take; returns the
    bits of the stored K/V: 8 (int8 [B, Hkv, S, D]) or 4 (uint8 [B, Hkv, S, D/2])."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: tensors must lie on the CPU or on a CUDA card, got {q.device}")
    if any(t.device != q.device for t in (k, v, k_scale, v_scale)):
        raise ValueError(f"{name}: q, K/V and scales on different devices")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the CUDA kernel takes a bf16 query, got {q.dtype}")
    if k.dtype not in (torch.int8, torch.uint8) or v.dtype != k.dtype:
        raise TypeError(f"{name}: K/V must both be int8 or packed uint8, got {k.dtype}, {v.dtype}")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError(f"{name}: the scales must be f32")
    bits = 4 if k.dtype == torch.uint8 else 8
    b, _, h, d = q.shape
    if (q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or k.shape[0] != b
            or h % k.shape[1] or k.shape[3] != (d // 2 if bits == 4 else d)
            or k_scale.shape != k.shape[:3] or v_scale.shape != k.shape[:3]):
        raise ValueError(f"{name}: q {tuple(q.shape)}, K/V {tuple(k.shape)} and scales "
                         f"{tuple(k_scale.shape)} do not fit ({bits}-bit K/V)")
    if d not in QUANT_KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: the CUDA kernel takes head_dim in {QUANT_KERNEL_HEAD_DIMS}, got {d}")
    for t, n in ((q, "q"), (k, "k"), (v, "v"), (k_scale, "k_scale"), (v_scale, "v_scale")):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {n} must be contiguous and 16-byte aligned")
    return bits


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


def offset_arg(name: str, q_offset, device) -> tuple[int, Optional[torch.Tensor]]:
    """(host q_offset, device int32 scalar or None): a tensor q_offset (a write
    head on the device) is passed by address and read by the kernel, so a
    captured loop replays the same launch at every position."""
    if not isinstance(q_offset, torch.Tensor):
        return int(q_offset), None
    if q_offset.numel() != 1:
        raise ValueError(f"{name}: one q_offset for the batch, got {q_offset.numel()} "
                         "(per-sequence offsets have no kernel, as in the JAX wrapper)")
    return 0, q_offset.reshape(()).to(device=device, dtype=torch.int32)


def kv_start_arg(name: str, kv_start, b: int, device) -> Optional[torch.Tensor]:
    """int32 [B] on device, or None."""
    if kv_start is None:
        return None
    vec = torch.as_tensor(kv_start).reshape(-1).to(device=device, dtype=torch.int32).contiguous()
    if vec.numel() != b:
        raise ValueError(f"{name}: kv_start has {vec.numel()} entries for batch {b}")
    return vec
