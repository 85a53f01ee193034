"""Decode attention: the wrappers around the hand-written Hopper kernels for a
one-token query, and their plain PyTorch versions.

  - `decode_attention`        over the dense cache      (`csrc/decode_attention.cu`)
  - `decode_attention_quant`  over int8 / int4 K/V       (`csrc/decode_attention_quant.cu`)
  - `decode_attention_paged`  over the paged block pool  (`csrc/decode_attention_paged.cu`)

Counterparts of `mllm_tpu/ops/decode_attention.py` (`decode_attention`,
`decode_attention_quant`, `decode_attention_paged`, `unpack4_planar`).

q is [B, 1, H, D]; k/v are one layer of the cache, [B, H_kv, S, D] (int8, or
packed uint8 [B, H_kv, S, D/2] for int4, with f32 per-key scales [B, H_kv, S]),
or the paged pool [NB, H_kv, 128, D] with a block table [B, MAXB].
GQA groups are contiguous (`q.reshape(B, H_kv, n_rep, D)`).

Masking (every version): key j is visible to sequence b when
    kv_start[b] <= j < kv_valid_len[b]   and   j > kv_valid_len[b] - 1 - window,
i.e. the window is measured from the last valid key, where the query sits.
A kv_valid_len past the cache clamps to it. A sequence with no visible key
gets zeros.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. Each wrapper counts its kernel launches in `.launches`.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from . import _build
from ._common import (KERNEL_HEAD_DIMS, check_kernel_args, check_quant_kv_args,
                      decode_visible_keys, kv_len_arg, kv_start_arg, masked_exp, masked_softmax, on_cpu,
                      refuse_grad)
from .flash_attention import LOG2E
from .quant_matmul import sm_count

PAGE = 128  # rows of a pool block (PagedKVCache.BS)
DECODE_TILE = 64  # keys a tile of `csrc/decode_attention.cuh`
DECODE_MAX_SPLITS = 8  # its largest cluster: the portable limit
DECODE_HEADS = 16  # query heads one of its CTAs takes (the m16 of mma.sync)


def decode_split_ranges(lo: int, hi: int, splits: int, tile: int = DECODE_TILE) -> list[tuple[int, int]]:
    """The decode kernels' division of the keys [lo, hi) among the `splits`
    CTAs of a cluster (`csrc/decode_attention.cuh`, `decode_attention_quant.cu`):
    the tiles [t0, hi) with t0 = lo rounded down to `tile`, cut into runs of
    ceil(ntiles / splits) whole tiles, run r to rank r. Rank r sees the keys
    [start, stop) of its run within [lo, hi); a rank with no tile gets start
    == stop (its partial is empty: m = -inf, l = 0, acc = 0). The ranks'
    partials are merged in rank order."""
    t0 = (lo // tile) * tile
    ntiles = -(-(hi - t0) // tile) if hi > lo else 0
    per = -(-ntiles // splits)
    out = []
    for r in range(splits):
        a = min(r * per, ntiles)
        e = min(a + per, ntiles)
        start, stop = max(lo, t0 + a * tile), min(hi, t0 + e * tile)
        out.append((start, max(start, stop)))
    return out


# CTAs an SM the bf16 dense kernel's grid aims at, by head_dim: at 64 its
# tiles are TMA boxes, a CTA's ring 64 KB, and a CTA streams its tiles at a
# pace of its own, so two CTAs an SM stream twice the bytes (PERF.md)
DECODE_CTAS_PER_SM = {64: 2}


def decode_splits(b: int, hkv: int, n_rep: int, s_max: int, sms: int, head_dim: Optional[int] = None) -> int:
    """The decode kernels' cluster size: enough CTAs per (b, KV head) that the
    grid fills the card's `sms` SMs (DECODE_CTAS_PER_SM[head_dim] CTAs an SM
    for the bf16 dense kernel at that head_dim, else one), at most
    DECODE_MAX_SPLITS and at most the cache's tiles (`s_max` keys a sequence:
    the dense cache's S, or MAXB * 128 for the paged pool). Depends on the
    shapes only, never on a device length."""
    groups = b * hkv * -(-n_rep // DECODE_HEADS)
    want = sms * DECODE_CTAS_PER_SM.get(head_dim, 1)
    return max(1, min(DECODE_MAX_SPLITS, -(-want // groups), -(-s_max // DECODE_TILE)))


def unpack4_planar(p: torch.Tensor) -> torch.Tensor:
    """uint8 [..., D/2] excess-8 nibble pairs -> bf16 [..., D].

    The int4-KV packing contract (`Quant4KVCache` packs with the inverse):
    planar along head_dim, byte j holds d = j in the low nibble and d = j + D/2
    in the high one, each stored as v + 8 for v in [-8, 7]."""
    p32 = p.to(torch.int32)
    lo = ((p32 & 0x0F) - 8).to(torch.bfloat16)
    hi = ((p32 >> 4) - 8).to(torch.bfloat16)
    return torch.cat([lo, hi], dim=-1)


def stored_values(x: torch.Tensor) -> torch.Tensor:
    """f32 values of a quantized cache row before its scale: the int8 value,
    or the unpacked nibble for packed uint8."""
    return unpack4_planar(x).float() if x.dtype == torch.uint8 else x.float()


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
    ok = decode_visible_keys(b, s_max, kv_valid_len, kv_start, window, q.device)  # [B, S]
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
    if on_cpu(q):
        return decode_attention_ref(q, k, v, kv_valid_len=kv_valid_len, kv_start=kv_start,
                                    scale=scale, window=window)
    refuse_grad("decode_attention", q, k, v)
    b, sq, h, d = q.shape
    if sq != 1:
        raise ValueError("decode_attention is single-token; use flash_attention for prefill")
    check_kernel_args("decode_attention", q, k, v)
    hkv, s_max = k.shape[1], k.shape[2]
    valid_int, valid_vec = kv_len_arg("decode_attention", kv_valid_len, b, s_max, q.device)
    start_vec = kv_start_arg("decode_attention", kv_start, b, q.device)
    if scale is None:
        scale = d**-0.5
    splits = decode_splits(b, hkv, h // hkv, s_max, sm_count(q.device.index or 0), d)
    out = torch.empty_like(q)
    err = _build.library().mllm_decode_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        valid_vec.data_ptr() if valid_vec is not None else None,
        start_vec.data_ptr() if start_vec is not None else None,
        b, h, hkv, s_max, d, valid_int, int(window or 0), scale * LOG2E, splits,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention: kernel launch failed with CUDA error {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


@functools.cache
def quant_decode_scale(scale: float, dtype: torch.dtype) -> float:
    """The softmax scale `decode_attention_quant`'s kernel multiplies q by:
    rounded to q's dtype, as JAX multiplies a weakly typed scalar."""
    return float(torch.tensor(scale, dtype=dtype))


def decode_attention_quant_ref(
    q: torch.Tensor,  # [B, 1, H, D]
    k: torch.Tensor,  # int8 [B, H_kv, S, D] or packed uint8 [B, H_kv, S, D/2]
    v: torch.Tensor,
    k_scale: torch.Tensor,  # f32 [B, H_kv, S]
    v_scale: torch.Tensor,
    *,
    kv_valid_len=None,
    kv_start: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Plain version of `decode_attention_quant`, at the Pallas kernel's
    rounding points: qs = bf16(q * scale) against the stored integers, the K
    scale multiplied into the f32 score, bf16(p * v_scale) against the stored
    V integers with f32 sums, divided by sum p. One softmax over all keys,
    where the kernels run an online one over tiles."""
    b, sq, h, d = q.shape
    if sq != 1:
        raise ValueError("decode_attention_quant is single-token; use flash_attention_quant")
    hkv, s_max = k.shape[1], k.shape[2]
    g = h // hkv
    if scale is None:
        scale = d**-0.5
    ok = decode_visible_keys(b, s_max, kv_valid_len, kv_start, window, q.device)
    qs = (q * torch.tensor(scale, dtype=q.dtype)).to(torch.bfloat16).float().reshape(b, hkv, g, d)
    s = torch.einsum("bkgd,bksd->bkgs", qs, stored_values(k)) * k_scale.float()[:, :, None, :]
    p, l = masked_exp(s, ok[:, None, None, :])
    pv = (p * v_scale.float()[:, :, None, :]).to(torch.bfloat16).float()
    out = torch.einsum("bkgs,bksd->bkgd", pv, stored_values(v)) / l
    return out.reshape(b, 1, h, d).to(q.dtype)


def decode_attention_quant(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    k_scale: torch.Tensor,
    v_scale: torch.Tensor,
    *,
    kv_valid_len=None,
    kv_start: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Decode attention over int8 or packed-int4 K/V; same signature and
    arithmetic as `decode_attention_quant_ref`."""
    if on_cpu(q):
        return decode_attention_quant_ref(q, k, v, k_scale, v_scale, kv_valid_len=kv_valid_len,
                                          kv_start=kv_start, scale=scale, window=window)
    refuse_grad("decode_attention_quant", q, k, v, k_scale, v_scale)
    name = "decode_attention_quant"
    b, sq, h, d = q.shape
    if sq != 1:
        raise ValueError(f"{name} is single-token; use flash_attention_quant")
    bits = check_quant_kv_args(name, q, k, v, k_scale, v_scale)
    hkv, s_max = k.shape[1], k.shape[2]
    valid_int, valid_vec = kv_len_arg(name, kv_valid_len, b, s_max, q.device)
    start_vec = kv_start_arg(name, kv_start, b, q.device)
    if scale is None:
        scale = d**-0.5
    splits = decode_splits(b, hkv, h // hkv, s_max, sm_count(q.device.index or 0))
    out = torch.empty_like(q)
    err = _build.library().mllm_decode_attention_quant(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
        out.data_ptr(), valid_vec.data_ptr() if valid_vec is not None else None,
        start_vec.data_ptr() if start_vec is not None else None,
        b, h, hkv, s_max, d, bits, valid_int, int(window or 0), quant_decode_scale(scale, q.dtype),
        splits, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    decode_attention_quant.launches += 1
    return out


decode_attention_quant.launches = 0


def gather_pages(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The dense view [B, H_kv, MAXB * 128, D] of a pool [NB, H_kv, 128, D]
    through a block table [B, MAXB], each entry clipped to [0, NB - 1]."""
    nb, hkv, bs, d = pool.shape
    b, maxb = table.shape
    g = pool[table.long().clamp(0, nb - 1)]  # [B, MAXB, H_kv, BS, D]
    return g.permute(0, 2, 1, 3, 4).reshape(b, hkv, maxb * bs, d)


def decode_attention_paged_ref(
    q: torch.Tensor,  # [B, 1, H, D]
    k_pool: torch.Tensor,  # [NB, H_kv, 128, D]
    v_pool: torch.Tensor,
    table: torch.Tensor,  # int32 [B, MAXB], -1 = unallocated
    *,
    kv_valid_len=None,  # [B]; None = MAXB * 128
    scale: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Plain version of `decode_attention_paged`: the dense view of each slot's
    blocks, then `decode_attention_ref`."""
    return decode_attention_ref(q, gather_pages(k_pool, table), gather_pages(v_pool, table),
                                kv_valid_len=kv_valid_len, scale=scale, window=window)


def decode_attention_paged(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    table: torch.Tensor,
    *,
    kv_valid_len=None,
    scale: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Paged decode attention; same signature and masking as
    `decode_attention_paged_ref`."""
    if on_cpu(q):
        return decode_attention_paged_ref(q, k_pool, v_pool, table, kv_valid_len=kv_valid_len,
                                          scale=scale, window=window)
    refuse_grad("decode_attention_paged", q, k_pool, v_pool)
    name = "decode_attention_paged"
    b, sq, h, d = q.shape
    if sq != 1:
        raise ValueError(f"{name} is single-token")
    nb, hkv, bs, _ = k_pool.shape
    if bs != PAGE:
        raise ValueError(f"{name}: the CUDA kernel takes pool blocks of {PAGE} rows, got {bs}")
    if table.dim() != 2 or table.shape[0] != b:
        raise ValueError(f"{name}: table must be [B, MAXB] for batch {b}, got {tuple(table.shape)}")
    if k_pool.shape != v_pool.shape or k_pool.shape[3] != d or h % hkv:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit the pool {tuple(k_pool.shape)}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: the CUDA kernel takes head_dim in {KERNEL_HEAD_DIMS}, got {d}")
    for t, n in ((q, "q"), (k_pool, "k_pool"), (v_pool, "v_pool")):
        if t.device != q.device or t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: {n} must be bf16 on {q.device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {n} must be contiguous and 16-byte aligned")
    maxb = table.shape[1]
    tbl = table.to(device=q.device, dtype=torch.int32).contiguous()
    valid_int, valid_vec = kv_len_arg(name, kv_valid_len, b, maxb * PAGE, q.device)
    if scale is None:
        scale = d**-0.5
    splits = decode_splits(b, hkv, h // hkv, maxb * PAGE, sm_count(q.device.index or 0))
    out = torch.empty_like(q)
    err = _build.library().mllm_decode_attention_paged_bf16(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tbl.data_ptr(), out.data_ptr(),
        valid_vec.data_ptr() if valid_vec is not None else None,
        b, h, hkv, nb, maxb, d, valid_int, int(window or 0), scale * LOG2E, splits,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    decode_attention_paged.launches += 1
    return out


decode_attention_paged.launches = 0
