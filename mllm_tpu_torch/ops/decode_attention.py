"""Decode attention: the `decode_attention` wrapper around the hand-written
Hopper kernel in `csrc/decode_attention.cu`, and its plain PyTorch version.

Counterpart of `mllm_tpu/ops/decode_attention.py:decode_attention`.

q is [B, 1, H, D]; k/v are the dense cache of one layer, [B, H_kv, S, D].
GQA groups are contiguous (`q.reshape(B, H_kv, n_rep, D)`).

Masking (both versions): key j is visible to sequence b when
    kv_start[b] <= j < kv_valid_len[b]   and   j > kv_valid_len[b] - 1 - window,
i.e. the window is measured from the last valid key, where the query sits.
A sequence with no visible key gets zeros.

A CPU tensor takes `decode_attention_ref`; a CUDA tensor launches the kernel or
raises. `decode_attention.launches` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from ._common import check_kernel_args, kv_len_arg, kv_start_arg, masked_softmax, visible_keys
from .flash_attention import LOG2E


def decode_attention_ref(
    q: torch.Tensor,  # [B, 1, H, D]
    k: torch.Tensor,  # [B, H_kv, S, D]
    v: torch.Tensor,
    *,
    kv_valid_len=None,  # int or [B]; None = S
    kv_start: Optional[torch.Tensor] = None,  # [B]
    scale: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch decode attention: f32 scores and softmax, probabilities in
    V's dtype times V with f32 accumulation."""
    b, sq, h, d = q.shape
    if sq != 1:
        raise ValueError("decode_attention is single-token; use flash_attention for prefill")
    hkv, s_max = k.shape[1], k.shape[2]
    g = h // hkv
    if scale is None:
        scale = d**-0.5
    ok = visible_keys(b, s_max, kv_valid_len, kv_start, q.device)  # [B, S]
    if window is not None:
        if kv_valid_len is None:
            last = torch.full((b,), s_max, device=q.device)
        else:
            last = torch.as_tensor(kv_valid_len, device=q.device).reshape(-1).expand(b)
        k_pos = torch.arange(s_max, device=q.device)
        ok = ok & (k_pos[None, :] > last[:, None] - 1 - window)
    qg = q.reshape(b, hkv, g, d).float()
    s = torch.einsum("bkgd,bksd->bkgs", qg, k.float()) * scale
    p = masked_softmax(s, ok[:, None, None, :])
    out = torch.einsum("bkgs,bksd->bkgd", p.to(v.dtype).float(), v.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


def decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    kv_valid_len=None,
    kv_start: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Decode attention; same signature and masking as `decode_attention_ref`."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, kv_valid_len=kv_valid_len, kv_start=kv_start,
                                    scale=scale, window=window)
    b, sq, h, d = q.shape
    if sq != 1:
        raise ValueError("decode_attention is single-token; use flash_attention for prefill")
    check_kernel_args("decode_attention", q, k, v)
    hkv, s_max = k.shape[1], k.shape[2]
    valid_int, valid_vec = kv_len_arg("decode_attention", kv_valid_len, b, s_max, q.device)
    start_vec = kv_start_arg("decode_attention", kv_start, b, q.device)
    if scale is None:
        scale = d**-0.5
    out = torch.empty_like(q)
    err = _build.library().mllm_decode_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        valid_vec.data_ptr() if valid_vec is not None else None,
        start_vec.data_ptr() if start_vec is not None else None,
        b, h, hkv, s_max, d, valid_int, int(window or 0), scale * LOG2E,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention: kernel launch failed with CUDA error {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
