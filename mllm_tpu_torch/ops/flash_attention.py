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

import ctypes
import functools
import heapq
from typing import Optional

import torch

from . import _build
from ._common import (FLASH_HEAD_DIMS, check_kernel_args, check_quant_kv_args, flash_visible_keys,
                      kv_len_arg, kv_start_arg, masked_exp, masked_softmax, offset_arg, on_cpu,
                      refuse_grad)

LOG2E = 1.4426950408889634
FLASH_BQ = 128  # query rows a CTA of `csrc/flash_attention.cuh` (kBQ)
FLASH_TILE = 128  # keys a tile at head_dim 64, 80 and 128 (kBK)
FLASH_TILE_WIDE = 64  # keys a tile at head_dim 256 (kBKWide)
FLASH_MIN_RUN = 2  # tiles a rank takes at least before a q-tile is split (kMinRun)
FLASH_MAX_SPLITS = 8  # the largest cluster: the portable limit (kMaxSplits)
FLASH_SPLIT_HEAD_DIMS = (256,)  # the bodies that split a q-tile's keys
# flash_splits' cost model, in key tiles of one CTA (a tile's products took
# ~2.07 us a CTA at head_dim 256): the fixed cost of a CTA (launch, Q's
# load, the ring's first fill, the store; ~7.0 us) and that of a merge (the
# partials through shared memory, two cluster barriers, the remote reads;
# ~1.5-2.7 us), fitted to the chunk row at 1-8 CTAs a cluster (PERF.md)
FLASH_CTA_COST = 3.4
FLASH_MERGE_COST = 1.1


def flash_tile_keys(head_dim: int) -> int:
    """Keys a tile of the body that runs `head_dim` (`block_k` of
    `csrc/flash_attention.cuh`): 64 at 256, else 128."""
    return FLASH_TILE_WIDE if head_dim > 128 else FLASH_TILE


def flash_qtile_tiles(q0: int, sq: int, q_offset: int, kv_valid: int, kv_start: int, causal: bool,
                      window: Optional[int], skv: int, tile: int = FLASH_TILE_WIDE) -> tuple[int, int]:
    """(kb0, ntiles): the key tiles that q-tile rows [q0, q0 + 128) of one
    sequence load, as `cta_tiles` (`csrc/flash_attention.cuh`) computes them
    on the card from the device values: the keys [lo, hi) some row sees,
    kv_start <= j < kv_valid and, when causal, j <= q_offset + s and
    j > q_offset + s - window; tiles of `tile` keys (the body's,
    `flash_tile_keys`) from kb0 = lo rounded down."""
    lo, hi = max(kv_start, 0), min(kv_valid, skv)
    if causal:
        hi = min(hi, q_offset + min(q0 + FLASH_BQ, sq))
        if window:
            lo = max(lo, q_offset + q0 - window + 1)
    kb0 = lo // tile * tile
    return kb0, (-(-(hi - kb0) // tile) if hi > lo else 0)


def flash_split_runs(ntiles: int, splits: int) -> list[tuple[int, int]]:
    """The head_dim 256 kernel's division of a q-tile's `ntiles` key tiles
    among the `splits` CTAs of its cluster: (first, count) of each rank.
    `used` = min(splits, max(1, ntiles // FLASH_MIN_RUN)) ranks take runs of whole
    tiles, rank r the tiles [r ntiles // used, (r + 1) ntiles // used); the
    other ranks leave at once (count 0). A q-tile with used = 1 is written by
    rank 0 as without a split; else the ranks' partials (m, l, O) are merged
    in rank order. Each CTA computes its run on the card from the device
    values, so this depends on ntiles, never on the host."""
    if splits <= 1:
        return [(0, ntiles)]
    used = min(splits, max(1, ntiles // FLASH_MIN_RUN))
    return [(r * ntiles // used, (r + 1) * ntiles // used - r * ntiles // used) if r < used else (ntiles, 0)
            for r in range(splits)]


def flash_unit(u: int, b: int, h: int, nq: int) -> tuple[int, int, int]:
    """(sequence, head, q-tile) of unit u of the heaviest-first list that
    every flash grid walks (`unit_tiles` in `csrc/flash_attention.cuh`):
    every head's and sequence's last q-tile, then the one before."""
    return (u // h) % b, u % h, nq - 1 - u // (h * b)


def flash_persistent_units(n_units: int, ctas: int) -> list[list[int]]:
    """The persistent grid's division at head_dim 64 and 80: `ctas` CTAs
    (min(n_units, the card's SMs)); CTA i's k-th unit is k ctas + i in even
    rounds k and k ctas + ctas - 1 - i in odd ones (`narrow_unit` in
    `csrc/flash_attention.cu`), while below n_units, so a CTA's heavy units
    pair with light ones. Each CTA reads the device q_offset, kv_valid and
    kv_start for every unit."""
    out = []
    for i in range(ctas):
        units, k = [], 0
        while (u := k * ctas + (ctas - 1 - i if k & 1 else i)) < n_units:
            units.append(u)
            k += 1
        out.append(units)
    return out


@functools.lru_cache(maxsize=4096)
def flash_splits(b: int, sq: int, skv: int, h: int, causal: bool, window: Optional[int],
                 slots: tuple[int, ...], q_offset: Optional[int] = None, kv_valid: Optional[int] = None) -> int:
    """The head_dim 256 kernel's cluster size: the CTAs that share one
    q-tile's key tiles (`flash_split_runs`). slots[c - 1] is how many
    clusters of c CTAs the card keeps resident at once
    (`flash_cluster_slots`); 1 where the grid already runs four waves.

    Else the size, of 1..len(slots), whose grid a greedy schedule finishes
    first: the clusters in the grid's order (heaviest q-tiles first), each
    onto the cluster slot that frees first, each costing its longest run plus
    FLASH_CTA_COST (and FLASH_MERGE_COST when its q-tile is split); ties go
    to the smaller cluster. A q-tile's tiles are estimated from q_offset and
    kv_valid where the caller has them as host ints; a device value (None
    here) is estimated from the shapes alone, as if the rows ended at the
    cache's end (q_offset = skv - sq when causal, kv_valid = skv), the most a
    causal chunk can see, so that a captured launch fits every position. The
    kernel's ranks still compute their runs from the values on the card."""
    nq = -(-sq // FLASH_BQ)
    if b * h * nq >= 4 * slots[0]:
        return 1
    if q_offset is None:
        q_offset = max(0, skv - sq) if causal else 0
    kv_valid = skv if kv_valid is None else kv_valid
    est = [flash_qtile_tiles(qt * FLASH_BQ, sq, q_offset, kv_valid, 0, causal, window, skv)[1] for qt in range(nq)]
    best, best_span = 1, float("inf")
    for c in range(1, len(slots) + 1):
        if slots[c - 1] < 1:
            continue
        free = [0.0] * slots[c - 1]
        for qt in reversed(range(nq)):
            runs = [n for _, n in flash_split_runs(est[qt], c) if n > 0] or [0]
            cost = max(runs) + FLASH_CTA_COST + (FLASH_MERGE_COST if len(runs) > 1 else 0.0)
            for _ in range(b * h):
                heapq.heappush(free, heapq.heappop(free) + cost)
        span = max(free)
        if span < best_span - 1e-9:
            best, best_span = c, span
    return best


@functools.cache
def flash_cluster_slots(device_index: int) -> tuple[int, ...]:
    """How many clusters of 1..FLASH_MAX_SPLITS CTAs of the head_dim 256
    kernel the card keeps resident at once (cudaOccupancyMaxActiveClusters:
    clusters pack into GPCs, so 2-CTA clusters of a one-CTA-an-SM kernel may
    fit fewer than sms / 2)."""
    out = []
    for c in range(1, FLASH_MAX_SPLITS + 1):
        n = ctypes.c_int(0)
        with torch.cuda.device(device_index):
            err = _build.library().mllm_flash_max_clusters(c, ctypes.addressof(n))
        if err != 0:
            raise RuntimeError(f"flash_attention: cluster occupancy query failed with CUDA error {err}")
        out.append(n.value)
    return tuple(out)


@functools.cache
def flash_quant_cluster_slots(device_index: int, bits: int) -> tuple[int, ...]:
    """`flash_cluster_slots` of the head_dim 256 kernel over `bits`-bit K/V
    (`flash_quant_wide_kernel`: its own shared-memory plan, Q, one bf16
    stage of K and V and the raw stages, differs from the bf16 kernel's)."""
    out = []
    for c in range(1, FLASH_MAX_SPLITS + 1):
        n = ctypes.c_int(0)
        with torch.cuda.device(device_index):
            err = _build.library().mllm_flash_quant_max_clusters(bits, c, ctypes.addressof(n))
        if err != 0:
            raise RuntimeError(f"flash_attention_quant: cluster occupancy query failed with CUDA error {err}")
        out.append(n.value)
    return tuple(out)


def flash_quant_launch_splits(b: int, sq: int, skv: int, h: int, d: int, bits: int, causal: bool,
                              window: Optional[int], device_index: int, q_offset: Optional[int],
                              kv_valid: Optional[int]) -> int:
    """The cluster size `flash_attention_quant` launches with: `flash_splits`
    over the quantized kernel's own resident clusters at head_dim 256, else
    1 (the 64 / 128 kernel has no split)."""
    if d not in FLASH_SPLIT_HEAD_DIMS:
        return 1
    return flash_splits(b, sq, skv, h, causal, window or None, flash_quant_cluster_slots(device_index, bits),
                        q_offset, kv_valid)


def flash_launch_splits(b: int, sq: int, skv: int, h: int, d: int, causal: bool, window: Optional[int],
                        device_index: int, q_offset: Optional[int], kv_valid: Optional[int]) -> int:
    """The cluster size `flash_attention` launches with: `flash_splits` over
    the card's slots at head_dim 256, else 1 (no split there; at 64 and 80 a
    persistent grid); q_offset / kv_valid are the host ints, or None for
    device values."""
    if d not in FLASH_SPLIT_HEAD_DIMS:
        return 1
    return flash_splits(b, sq, skv, h, causal, window or None, flash_cluster_slots(device_index), q_offset, kv_valid)


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
    so the launch is the same at every position and replays in a CUDA graph.

    head_dim is 64, 128, 256 or 80 (`FLASH_HEAD_DIMS`); 80 runs a body of its
    own over rows of 80 columns (a 64-column box and a 16-column rest box,
    `csrc/flash_attention.cu`). At 256 a cluster of `flash_splits` CTAs
    shares each q-tile's keys (`flash_split_runs`) and merges its partials in
    distributed shared memory; at 64 and 80 the grid is persistent
    (`flash_persistent_units`). One launch."""
    if on_cpu(q):
        return flash_attention_ref(q, k, v, q_offset=q_offset, kv_valid_len=kv_valid_len,
                                   kv_start=kv_start, causal=causal, window=window, scale=scale)
    refuse_grad("flash_attention", q, k, v)
    b, sq, h, d = q.shape
    check_kernel_args("flash_attention", q, k, v, FLASH_HEAD_DIMS)
    hkv, skv = k.shape[1], k.shape[2]
    offset_int, offset_dev = offset_arg("flash_attention", q_offset, q.device)
    valid_int, valid_vec = kv_len_arg("flash_attention", kv_valid_len, b, skv, q.device)
    start_vec = kv_start_arg("flash_attention", kv_start, b, q.device)
    if scale is None:
        scale = d**-0.5
    splits = flash_launch_splits(b, sq, skv, h, d, bool(causal), window, q.device.index or 0,
                                 None if offset_dev is not None else offset_int,
                                 None if valid_vec is not None else valid_int)
    out = torch.empty_like(q)
    err = _build.library().mllm_flash_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        valid_vec.data_ptr() if valid_vec is not None else None,
        start_vec.data_ptr() if start_vec is not None else None,
        offset_dev.data_ptr() if offset_dev is not None else None,
        b, sq, h, hkv, skv, d, offset_int, valid_int, int(causal), int(window or 0),
        scale * LOG2E, splits, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA error {err}")
    flash_attention.launches += 1
    flash_attention.launches_at[d] = flash_attention.launches_at.get(d, 0) + 1
    return out


flash_attention.launches = 0
flash_attention.launches_at = {}  # head_dim -> launches (counted with `launches`)


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
    issue beside the consumers' softmax on the same schedulers (PERF.md). At
    head_dim 256 the consumers convert each tile themselves, and a cluster of
    `flash_quant_launch_splits` CTAs shares each q-tile's keys
    (`flash_split_runs`), merging its partials in distributed shared memory.
    q goes in raw: the kernel rounds bf16(f32(q) * q_scale) in shared memory,
    q_scale = f32(bf16(scale * log2 e)) (`quant_q_scale`), the product the
    plain version takes in q's dtype."""
    if on_cpu(q):
        return flash_attention_quant_ref(q, k, v, k_scale, v_scale, q_offset=q_offset,
                                         kv_valid_len=kv_valid_len, kv_start=kv_start,
                                         causal=causal, window=window, scale=scale)
    refuse_grad("flash_attention_quant", q, k, v, k_scale, v_scale)
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
    splits = flash_quant_launch_splits(b, sq, skv, h, d, bits, bool(causal), window, q.device.index or 0,
                                       None if offset_dev is not None else offset_int,
                                       None if valid_vec is not None else valid_int)
    out = torch.empty_like(q)
    err = _build.library().mllm_flash_attention_quant(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
        out.data_ptr(), start_vec.data_ptr() if start_vec is not None else None,
        valid_vec.data_ptr() if valid_vec is not None else None,
        offset_dev.data_ptr() if offset_dev is not None else None,
        b, sq, h, hkv, skv, d, bits, offset_int, valid_int, int(causal), int(window or 0),
        quant_q_scale(scale), splits, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    flash_attention_quant.launches += 1
    return out


flash_attention_quant.launches = 0
