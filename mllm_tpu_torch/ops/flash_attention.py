"""Prefill attention: the `flash_attention` wrapper around the hand-written
Hopper kernel in `csrc/flash_attention.cu`, and its plain PyTorch version.

Counterpart of `mllm_tpu/ops/flash_attention.py:flash_attention`.

Layouts: q is [B, Sq, H, D] (model layout); k/v are [B, H_kv, Skv, D] (cache
layout). GQA groups are contiguous: query head h reads KV head h // n_rep.

Masking (both versions): key j is visible from query row s of sequence b when
    kv_start[b] <= j < kv_valid_len[b]
and, if causal, j <= q_offset + s and j > q_offset + s - window.
A row with no visible key is zeros.

A CPU tensor takes `flash_attention_ref`; a CUDA tensor launches the kernel or
raises. `flash_attention.launches` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from ._common import check_kernel_args, kv_len_arg, kv_start_arg, masked_softmax, visible_keys

LOG2E = 1.4426950408889634


def flash_attention_ref(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, H_kv, Skv, D]
    v: torch.Tensor,
    *,
    q_offset: int = 0,
    kv_valid_len=None,  # int or [B]; None = Skv
    kv_start: Optional[torch.Tensor] = None,  # [B] first valid key (left pad)
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch prefill attention: f32 scores and softmax, bf16-or-f32
    probabilities times V with f32 accumulation (as `mllm_tpu.nn.attention.sdpa`)."""
    b, sq, h, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = h // hkv
    if scale is None:
        scale = d**-0.5
    q_pos = q_offset + torch.arange(sq, device=q.device)
    ok = visible_keys(b, skv, kv_valid_len, kv_start, q.device)[:, None, :]  # [B, 1, Skv]
    if causal:
        k_pos = torch.arange(skv, device=q.device)
        c = k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            c = c & (k_pos[None, :] > q_pos[:, None] - window)
        ok = ok & c[None]  # [B, Sq, Skv]
    qg = q.reshape(b, sq, hkv, g, d).float()
    s = torch.einsum("bqkgd,bksd->bkgqs", qg, k.float()) * scale
    p = masked_softmax(s, ok[:, None, None])  # ok: [B, 1, 1, Sq, Skv]
    out = torch.einsum("bkgqs,bksd->bqkgd", p.to(v.dtype).float(), v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_offset: int = 0,
    kv_valid_len=None,
    kv_start: Optional[torch.Tensor] = None,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Prefill attention; same signature and masking as `flash_attention_ref`."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, q_offset=q_offset, kv_valid_len=kv_valid_len,
                                   kv_start=kv_start, causal=causal, window=window, scale=scale)
    b, sq, h, d = q.shape
    check_kernel_args("flash_attention", q, k, v)
    hkv, skv = k.shape[1], k.shape[2]
    if not isinstance(q_offset, int):
        raise TypeError(f"flash_attention: q_offset must be a host int, got {type(q_offset)}")
    valid_int, valid_vec = kv_len_arg("flash_attention", kv_valid_len, b, skv, q.device)
    start_vec = kv_start_arg("flash_attention", kv_start, b, q.device)
    if scale is None:
        scale = d**-0.5
    out = torch.empty_like(q)
    err = _build.library().mllm_flash_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        valid_vec.data_ptr() if valid_vec is not None else None,
        start_vec.data_ptr() if start_vec is not None else None,
        b, sq, h, hkv, skv, d, q_offset, valid_int, int(causal), int(window or 0),
        scale * LOG2E, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
