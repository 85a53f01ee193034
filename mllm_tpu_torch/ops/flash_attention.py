"""Prefill attention: the wrappers around the hand-written Hopper kernels,
and their plain PyTorch versions.

  - `flash_attention`        over bf16 K/V          (`csrc/flash_attention.cu`)
  - `flash_attention_quant`  over int8 / int4 K/V   (`csrc/flash_attention_quant.cu`)

Counterparts of `mllm_tpu/ops/flash_attention.py` (`flash_attention`,
`flash_attention_quant`).

Layouts: q is [B, Sq, H, D] (model layout); k/v are [B, H_kv, Skv, D] (cache
layout; int8, or packed uint8 [B, H_kv, Skv, D/2] for int4, with f32 per-key
scales [B, H_kv, Skv]). GQA groups are contiguous: query head h reads KV head
h // n_rep.

Masking (both versions): key j is visible from query row s of sequence b when
    kv_start[b] <= j < kv_valid_len[b]
and, if causal, j <= q_offset + s and j > q_offset + s - window.
A row with no visible key is zeros.

A CPU tensor takes `flash_attention_ref`; a CUDA tensor launches the kernel or
raises. Each wrapper counts its kernel launches in `.launches`.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from . import _build
from ._common import (check_kernel_args, check_quant_kv_args, flash_visible_keys, kv_len_arg,
                      kv_start_arg, masked_exp, masked_softmax, offset_arg)

LOG2E = 1.4426950408889634


def flash_attention_ref(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, H_kv, Skv, D]
    v: torch.Tensor,
    *,
    q_offset=0,  # int or [B]
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
    ok = flash_visible_keys(b, sq, skv, q_offset, kv_valid_len, kv_start, causal, window,
                            q.device)  # [B, Sq or 1, Skv]
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
    q_offset=0,
    kv_valid_len=None,
    kv_start: Optional[torch.Tensor] = None,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Prefill attention; same signature and masking as `flash_attention_ref`.

    q_offset is a host int or a one-element tensor on the card (a write head,
    as the JAX kernel's scalar prefetch); kv_valid_len an int or a tensor of
    one or B entries. Device values are read by the kernel, never by the host,
    so the launch is the same at every position and replays in a CUDA graph."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, q_offset=q_offset, kv_valid_len=kv_valid_len,
                                   kv_start=kv_start, causal=causal, window=window, scale=scale)
    b, sq, h, d = q.shape
    check_kernel_args("flash_attention", q, k, v)
    hkv, skv = k.shape[1], k.shape[2]
    offset_int, offset_dev = offset_arg("flash_attention", q_offset, q.device)
    valid_int, valid_vec = kv_len_arg("flash_attention", kv_valid_len, b, skv, q.device)
    start_vec = kv_start_arg("flash_attention", kv_start, b, q.device)
    if scale is None:
        scale = d**-0.5
    out = torch.empty_like(q)
    err = _build.library().mllm_flash_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        valid_vec.data_ptr() if valid_vec is not None else None,
        start_vec.data_ptr() if start_vec is not None else None,
        offset_dev.data_ptr() if offset_dev is not None else None,
        b, sq, h, hkv, skv, d, offset_int, valid_int, int(causal), int(window or 0),
        scale * LOG2E, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


@functools.cache
def quant_q_scale(scale: float) -> float:
    """The factor by which `flash_attention_quant` pre-scales q, as the f32
    that the kernel multiplies by: scale * log2(e) rounded to bf16 (q's dtype,
    as the JAX wrapper's `jnp.asarray(scale * log2 e, q.dtype)`)."""
    return float(torch.tensor(scale * LOG2E, dtype=torch.bfloat16))


def flash_attention_quant_ref(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # int8 [B, H_kv, Skv, D] or packed uint8 [B, H_kv, Skv, D/2]
    v: torch.Tensor,
    k_scale: torch.Tensor,  # f32 [B, H_kv, Skv]
    v_scale: torch.Tensor,
    *,
    q_offset=0,
    kv_valid_len=None,
    kv_start: Optional[torch.Tensor] = None,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain version of `flash_attention_quant`, at the Pallas kernel's
    rounding points: q * (scale * log2 e) in q's dtype, each key row
    dequantized as bf16(f32(stored) * scale), a base-2 softmax in f32,
    probabilities rounded to bf16 before P V, f32 sums."""
    from .decode_attention import stored_values

    b, sq, h, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = h // hkv
    if scale is None:
        scale = d**-0.5
    qt = q * torch.tensor(scale * LOG2E, dtype=q.dtype)
    kd = (stored_values(k) * k_scale.float()[..., None]).to(torch.bfloat16)
    vd = (stored_values(v) * v_scale.float()[..., None]).to(torch.bfloat16)
    ok = flash_visible_keys(b, sq, skv, q_offset, kv_valid_len, kv_start, causal, window, q.device)
    s = torch.einsum("bqkgd,bksd->bkgqs", qt.reshape(b, sq, hkv, g, d).float(), kd.float())
    p, l = masked_exp(s, ok[:, None, None], exp=torch.exp2)
    out = torch.einsum("bkgqs,bksd->bqkgd", p.to(torch.bfloat16).float(), vd.float())
    return (out / l.permute(0, 3, 1, 2, 4)).reshape(b, sq, h, d).to(q.dtype)


def flash_attention_quant(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    k_scale: torch.Tensor,
    v_scale: torch.Tensor,
    *,
    q_offset=0,
    kv_valid_len=None,
    kv_start: Optional[torch.Tensor] = None,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Prefill attention over int8 or packed-int4 K/V; same signature and
    arithmetic as `flash_attention_quant_ref`. On the card q_offset and
    kv_valid_len are one value for the batch, as the JAX wrapper's scalars:
    host ints, or one-element tensors on the card that the kernel reads (a
    write head; the launch is then the same at every position).

    The kernel (`csrc/flash_attention_quant.cu`, one launch) is bound by
    matrix math past a few hundred tokens, as the bf16 one, and its integers
    must become bf16 in shared memory before wgmma reads them: its producer
    warpgroup loads the stored rows and their scales by TMA and converts each
    tile's K and V into the bf16 kernel's swizzled ring a tile or more ahead
    of the consumers, which run the bf16 kernel's products and softmax
    (`csrc/flash_attention.cuh`). What still bounds it is the conversion's
    issue beside the consumers' softmax on the same schedulers (PERF.md). q
    goes in raw: the kernel rounds bf16(f32(q) * q_scale) in shared memory,
    q_scale = f32(bf16(scale * log2 e)) (`quant_q_scale`), the product the
    plain version takes in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_quant_ref(q, k, v, k_scale, v_scale, q_offset=q_offset,
                                         kv_valid_len=kv_valid_len, kv_start=kv_start,
                                         causal=causal, window=window, scale=scale)
    name = "flash_attention_quant"
    b, sq, h, d = q.shape
    bits = check_quant_kv_args(name, q, k, v, k_scale, v_scale)
    hkv, skv = k.shape[1], k.shape[2]
    if isinstance(kv_valid_len, torch.Tensor) and kv_valid_len.numel() != 1:
        raise ValueError(f"{name}: one kv_valid_len for the batch, got {kv_valid_len.numel()} "
                         "(per-sequence lengths have no kernel here, as in the JAX wrapper)")
    offset_int, offset_dev = offset_arg(name, q_offset, q.device)
    valid_int, valid_vec = kv_len_arg(name, kv_valid_len, b, skv, q.device)
    start_vec = kv_start_arg(name, kv_start, b, q.device)
    if scale is None:
        scale = d**-0.5
    out = torch.empty_like(q)
    err = _build.library().mllm_flash_attention_quant(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
        out.data_ptr(), start_vec.data_ptr() if start_vec is not None else None,
        valid_vec.data_ptr() if valid_vec is not None else None,
        offset_dev.data_ptr() if offset_dev is not None else None,
        b, sq, h, hkv, skv, d, bits, offset_int, valid_int, int(causal), int(window or 0),
        quant_q_scale(scale), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    flash_attention_quant.launches += 1
    return out


flash_attention_quant.launches = 0
