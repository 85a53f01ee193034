"""Attention: plain `sdpa`, the `attend` dispatch to the CUDA kernels, and
`attend_from_cache` for every cache type. Counterpart of
`mllm_tpu/nn/attention.py`.

Layouts: q is [B, Sq, H, D]; k/v are in cache layout [B, H_kv, Skv, D].

`attend` sends a single-token query (Sq == 1) to `ops.decode_attention` and
every other query length to `ops.flash_attention`. Each wrapper runs its
plain version on CPU tensors and its kernel on CUDA tensors; the TPU
package's shape thresholds (D % 128, Sq % 128, batch/length switches) do not
apply. `attention_route` decides, the same on every device: an additive
`bias` (tree speculation), an attention `logit_softcap` (gemma2) and a prefill
over a quantized cache with per-slot lengths go through the port's own `sdpa`
(on the card too), as the reference sends them to XLA `sdpa`: no Pallas
kernel takes them there, so no Hopper kernel is owed.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.decode_attention import decode_attention, decode_attention_paged, decode_attention_quant
from ..ops.flash_attention import flash_attention, flash_attention_quant

NEG_INF = -1e30  # large-but-finite, as in mllm_tpu.nn.layers


def repeat_kv_cache_layout(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, H_kv, S, D] -> [B, H_kv*n_rep, S, D] (GQA broadcast, contiguous groups)."""
    if n_rep == 1:
        return x
    b, h, s, d = x.shape
    return x[:, :, None].expand(b, h, n_rep, s, d).reshape(b, h * n_rep, s, d)


def sdpa(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, H_kv, Skv, D]
    v: torch.Tensor,  # [B, H_kv, Skv, D]
    *,
    q_offset=0,  # absolute position of q[0]: int or [B]
    kv_valid_len=None,  # number of valid kv entries: int or [B]; None = all
    kv_start: Optional[torch.Tensor] = None,  # [B] first valid kv index (left pad)
    causal: bool = True,
    window: Optional[int] = None,
    bias: Optional[torch.Tensor] = None,  # additive bias [..., Sq, Skv]
    scale: Optional[float] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Masked scaled-dot-product attention with f32 softmax statistics; the
    same arithmetic and masking as `mllm_tpu.nn.attention.sdpa` (masked
    logits are NEG_INF, so a fully masked row averages V)."""
    b, sq, h, d = q.shape
    hkv = k.shape[1]
    n_rep = h // hkv
    k = repeat_kv_cache_layout(k, n_rep)
    v = repeat_kv_cache_layout(v, n_rep)
    if scale is None:
        scale = d**-0.5
    dev = q.device

    logits = torch.einsum("bqhd,bhkd->bhqk", q.float(), k.float()) * scale
    if logit_softcap is not None:
        logits = torch.tanh(logits / logit_softcap) * logit_softcap

    skv = k.shape[2]
    qo = torch.as_tensor(q_offset, device=dev).reshape(-1, 1)  # [1 or B, 1]
    k_pos = torch.arange(skv, device=dev)
    ok = torch.ones((1, sq, skv), dtype=torch.bool, device=dev)
    if causal:
        q_pos = qo + torch.arange(sq, device=dev)[None, :]  # [1 or B, sq]
        ok = k_pos[None, None, :] <= q_pos[:, :, None]
        if window is not None:
            ok = ok & (k_pos[None, None, :] > q_pos[:, :, None] - window)
    if kv_valid_len is not None:
        kvl = torch.as_tensor(kv_valid_len, device=dev).reshape(-1, 1, 1)
        ok = ok & (k_pos[None, None, :] < kvl)
    ok = ok[:, None].expand(logits.shape)
    if kv_start is not None:  # left-padded batches: mask the pad prefix
        ok = ok & (k_pos[None, None, None, :] >= kv_start.to(dev)[:, None, None, None])
    logits = torch.where(ok, logits, torch.full_like(logits, NEG_INF))
    if bias is not None:
        logits = logits + bias.float()

    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bhkd->bqhd", probs.float(), v.float())
    return out.to(q.dtype)


def attention_route(sq: int, *, cache: str = "dense", bias=None, logit_softcap=None,
                    kv_valid_len=None, kv_start=None) -> str:
    """Which function serves an attention call: "sdpa", "decode", "flash",
    "decode_paged", "decode_quant" or "flash_quant". `cache` is "dense",
    "paged" or "quant". The route does not depend on the device: the kernels'
    wrappers take their plain versions on CPU tensors and launch on CUDA ones,
    and `sdpa` is plain PyTorch on both. Counterpart of the choice between XLA
    `sdpa` and the Pallas kernels in `mllm_tpu/nn/attention.py:145-175,192-196`."""
    if bias is not None or logit_softcap is not None:
        return "sdpa"
    if cache == "paged":
        return "decode_paged" if sq == 1 and kv_start is None else _dense_route(sq)
    if cache == "quant":
        if sq == 1:
            return "decode_quant"
        per_slot = isinstance(kv_valid_len, torch.Tensor) and kv_valid_len.dim() > 0
        return "sdpa" if per_slot else "flash_quant"
    return _dense_route(sq)


def _dense_route(sq: int) -> str:
    return "decode" if sq == 1 else "flash"


def attend(
    q, k, v, *, q_offset=0, kv_valid_len=None, kv_start=None, causal=True, window=None,
    bias=None, scale=None, logit_softcap=None,
):
    """Dispatch (`attention_route`): Sq == 1 -> decode kernel, otherwise the
    flash kernel; a bias or softcap -> `sdpa`.

    The decode kernel measures a window from the last valid key, so it
    assumes the query sits at position kv_valid_len - 1 (as every decode
    step does)."""
    route = attention_route(q.shape[1], bias=bias, logit_softcap=logit_softcap)
    if route == "sdpa":
        return sdpa(q, k, v, q_offset=q_offset, kv_valid_len=kv_valid_len, kv_start=kv_start,
                    causal=causal, window=window, bias=bias, scale=scale,
                    logit_softcap=logit_softcap)
    if route == "decode":
        return decode_attention(q, k, v, kv_valid_len=kv_valid_len, kv_start=kv_start,
                                scale=scale, window=window)
    return flash_attention(q, k, v, q_offset=q_offset, kv_valid_len=kv_valid_len,
                           kv_start=kv_start, causal=causal, window=window, scale=scale)


def attend_from_cache(q, cache, layer_idx: int, *, q_offset=0, kv_valid_len=None, kv_start=None,
                      causal=True, window=None, bias=None, scale=None, logit_softcap=None):
    """Attention reading K/V straight from the cache object (JAX
    `attend_from_cache`, without the TPU shape thresholds):

      PagedKVCache, Sq == 1          -> decode_attention_paged over the pool
      PagedKVCache, otherwise        -> the gathered dense view through `attend`
      quantized cache, Sq == 1       -> decode_attention_quant on the stored K/V
      quantized cache, Sq > 1        -> flash_attention_quant (a scalar kv_valid_len;
                                        per-slot lengths: `sdpa` over the dequantized
                                        layer, as the reference's XLA route)
      dense caches                   -> `attend`

    A bias or a softcap takes `sdpa` over the layer (dequantized or gathered).

    A quantized cache is never dequantized to memory on the kernel routes."""
    from ..kv.cache import PagedKVCache, QuantKVCache, SlotQuantKVCache

    kw = dict(q_offset=q_offset, kv_valid_len=kv_valid_len, kv_start=kv_start, causal=causal,
              window=window, bias=bias, scale=scale, logit_softcap=logit_softcap)
    kind = ("paged" if isinstance(cache, PagedKVCache)
            else "quant" if isinstance(cache, (QuantKVCache, SlotQuantKVCache)) else "dense")
    route = attention_route(q.shape[1], cache=kind, bias=bias, logit_softcap=logit_softcap,
                            kv_valid_len=kv_valid_len, kv_start=kv_start)
    if route == "decode_paged":
        return decode_attention_paged(q, cache.k[layer_idx], cache.v[layer_idx], cache.table,
                                      kv_valid_len=kv_valid_len, scale=scale, window=window)
    if route in ("decode_quant", "flash_quant"):
        kq, vq, ks, vs = cache.layer_quant(layer_idx)
        if route == "decode_quant":
            return decode_attention_quant(q, kq, vq, ks, vs, kv_valid_len=kv_valid_len,
                                          kv_start=kv_start, scale=scale, window=window)
        return flash_attention_quant(q, kq, vq, ks, vs, q_offset=q_offset,
                                     kv_valid_len=kv_valid_len, kv_start=kv_start,
                                     causal=causal, window=window, scale=scale)
    k, v = cache.layer(layer_idx)
    if route == "sdpa":
        return sdpa(q, k, v, **kw)
    return attend(q, k, v, **kw)
