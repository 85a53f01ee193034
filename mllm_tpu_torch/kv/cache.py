"""KV caches: counterparts of `mllm_tpu/kv/cache.py`.

  - `KVCache`          dense `[L, B, H_kv, max_len, D]`, one host-int write head
  - `QuantKVCache`     int8 K/V with f32 per-(token, head) scales
  - `Quant4KVCache`    packed int4 K/V (planar nibbles, excess-8) with f32 scales
  - `SlotKVCache`      dense, a write head per slot (continuous batching)
  - `SlotQuantKVCache` int8 or int4, a write head per slot
  - `PagedKVCache`     a shared pool of 128-row blocks behind a block table

The sequence axis is inner per head, so the attention kernels stream one
head's keys contiguously. `update_layer`, `rollback_accept` and the
admissions write IN PLACE into the storage; `advance`, `with_pos` and `reset`
return a new cache over the same storage, so callers keep the JAX package's
style (`cache = cache.advance(n)`).

Write heads live on the cache's device, as in the JAX package: `KVCache` and
the two quantized caches keep an int32 0-d tensor, the slot and paged caches
an int32 `[B]` tensor. Nothing here reads a head back to the host, so a
decode step is the same launches at every position and a captured loop
(`generation/graphs.py`) replays it. Out-of-range writes follow the JAX
package: a dense append whose rows would run past max_len is shifted back to
end at max_len when the head is on the card (`lax.dynamic_update_slice`
clamps its start; the loops check their lengths up front, so none of them
reaches it) and raises when it is on the CPU, where reading it is free; a
slot's append at pos >= max_len lands on row max_len - 1 (idle and retired
slots keep advancing), and a paged append past the table or through a -1
entry is dropped (it lands in a sink block behind the pool that nothing
reads). The slot heads and the paged table are edited in place (admission,
`with_tables`), so a captured decode window reads them at the addresses it
was captured with.

Host-side indices (admission slots, the block table the allocator edits) are
numpy; they reach the card with non-blocking copies, which do not wait for
work already queued on the stream.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK = 128  # the quantized caches round max_len up to it; PagedKVCache's block rows


def to_device(x, device, dtype=None) -> torch.Tensor:
    """A host value as a tensor on `device`, copied without synchronising."""
    return torch.as_tensor(x, dtype=dtype).to(device, non_blocking=True)


def _round_up(n: int, m: int = BLOCK) -> int:
    return -(-n // m) * m


def _set_rows(pos: torch.Tensor, slots, values) -> torch.Tensor:
    """pos[slots] = values (host or device values), in place; returns pos."""
    pos[to_device(slots, pos.device, torch.long)] = to_device(values, pos.device, pos.dtype)
    return pos


def head(pos, device) -> torch.Tensor:
    """A write head as an int32 0-d tensor on `device` (a host int is filled
    in by a kernel, not copied, so making one never waits on the card)."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int32).reshape(())
    return torch.full((), int(pos), dtype=torch.int32, device=device)


def _memo(cache, name: str, s: int):
    """A per-cache memo and its key: the length, the head's version counter,
    which every in-place edit of the head (an admission, a captured loop's
    write-back) moves on, and whether a CUDA graph is being captured: a
    capture must record the computation, not read a tensor made before it
    (its replays would see that tensor's old value)."""
    return cache.__dict__.setdefault(name, {}), (s, cache.pos._version, _capturing())


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def _write_rows(cache, s: int) -> torch.Tensor:
    """The rows [start, start + s) that an s-token append writes, start =
    the head clamped to [0, max_len - s] as `lax.dynamic_update_slice` clamps
    it; made once per head value and length (every layer appends there).

    A head on the CPU is checked, as reading it costs nothing: an append that
    does not fit raises. A head on the card is not read back (that would
    wait for the card, and a captured loop cannot): the loops check their
    lengths up front."""
    memo, key = _memo(cache, "_rows", s)
    if key not in memo:
        if cache.pos.device.type == "cpu" and int(cache.pos) + s > cache.max_len:
            raise ValueError(f"KV cache overflow: pos {int(cache.pos)} + {s} tokens > max_len "
                             f"{cache.max_len}")
        start = cache.pos.clamp(0, max(cache.max_len - s, 0))
        memo[key] = (start + torch.arange(s, device=start.device)).long()
    return memo[key]


def storage(cache) -> list:
    """The storage tensors of a cache (K, V and, quantized, their scales)."""
    return [getattr(cache, n) for n in ("k", "v", "k_scale", "v_scale") if hasattr(cache, n)]


def valid_len(cache, s: int) -> torch.Tensor:
    """The attention length after an s-token append, pos + s (0-d, or [B]
    per slot), made once per head value and length."""
    memo, key = _memo(cache, "_valid", s)
    if key not in memo:
        memo[key] = cache.pos + s
    return memo[key]


def _rollback(bufs, max_len: int, draft_start, accept_idx, n_accept) -> torch.Tensor:
    """JAX `rollback_accept` on storage whose sequence axis is 3: gather the
    accepted rows draft_start + accept_idx[i] (i < n_accept; row draft_start
    otherwise) and write them at draft_start + i, in place. Returns the new
    head draft_start + n_accept."""
    dev = bufs[0].device
    idx = to_device(accept_idx, dev, torch.long).reshape(-1)
    start, n = head(draft_start, dev), head(n_accept, dev)
    i = torch.arange(idx.shape[0], device=dev)
    src = (start + torch.where(i < n, idx, 0)).clamp(0, max_len - 1)
    dst = start.clamp(0, max_len - idx.shape[0]) + i
    for buf in bufs:
        buf.index_copy_(3, dst, buf.index_select(3, src))
    return start + n


class KVCache:
    """k, v: [L, B, H_kv, max_len, D]; pos: int32 0-d tensor on the storage's
    device, the number of valid cached tokens (a host int is accepted)."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor, pos=0):
        self.k = k
        self.v = v
        self.pos = head(pos, k.device)

    @staticmethod
    def init(n_layers: int, batch: int, max_len: int, n_kv_heads: int, head_dim: int, *,
             device, dtype=torch.bfloat16) -> "KVCache":
        shape = (n_layers, batch, n_kv_heads, max_len, head_dim)
        return KVCache(torch.zeros(shape, device=device, dtype=dtype),
                       torch.zeros(shape, device=device, dtype=dtype), 0)

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    @property
    def n_layers(self) -> int:
        return self.k.shape[0]

    def update_layer(self, layer: int, k_new: torch.Tensor, v_new: torch.Tensor) -> "KVCache":
        """Write k_new/v_new [B, S, H_kv, D] at self.pos of `layer`, in place
        (the start clamped so the S rows fit, as JAX's dynamic_update_slice).

        Does NOT advance pos (all layers append at the same offset; call
        `advance` once per step)."""
        rows = _write_rows(self, k_new.shape[1])
        self.k[layer].index_copy_(2, rows, k_new.transpose(1, 2).to(self.k.dtype))
        self.v[layer].index_copy_(2, rows, v_new.transpose(1, 2).to(self.v.dtype))
        return self

    def layer(self, layer: int):
        """Full-length K/V for one layer: ([B, H_kv, max_len, D], same)."""
        return self.k[layer], self.v[layer]

    def dtype_bytes(self) -> int:
        """Bytes of one stored K or V element."""
        return self.k.element_size()

    def advance(self, n) -> "KVCache":
        return KVCache(self.k, self.v, self.pos + n)

    def with_pos(self, pos) -> "KVCache":
        """Same storage, write head at `pos` (an int or a device scalar)."""
        return KVCache(self.k, self.v, pos)

    def reset(self) -> "KVCache":
        """Rewind the write head; the storage is left as it is."""
        return KVCache(self.k, self.v, 0)

    def rollback_accept(self, draft_start, accept_idx, n_accept) -> "KVCache":
        """Speculative-decoding verification (JAX `KVCache.rollback_accept`):
        for i < n_accept, the entry at draft_start + accept_idx[i] moves to
        draft_start + i, in place, and the head becomes draft_start +
        n_accept. draft_start and n_accept are ints or device scalars,
        accept_idx [n_draft] host or device ints."""
        pos = _rollback((self.k, self.v), self.max_len, draft_start, accept_idx, n_accept)
        return KVCache(self.k, self.v, pos)


# -- quantized storage --------------------------------------------------------

# XLA turns `amax / 127.0` (`/ 7.0`) under jit, where the JAX caches quantize,
# into a multiplication by the f32 reciprocal; the port multiplies too, so its
# scales have the jitted JAX bits (tests/test_torch_kvcache.py).
_RECIP = {8: 1.0 / 127.0, 4: 1.0 / 7.0}


def quantize_kv(x: torch.Tensor, bits: int):
    """[..., D] float -> (stored [..., D] int8 or [..., D/2] packed uint8,
    f32 scale [...]): symmetric per vector, scale = amax / 127 (int8) or
    amax / 7 (int4), 1 for an all-zero vector. int4 is stored excess-8, planar:
    byte j holds d = j (low nibble) and d = j + D/2 (high)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax * _RECIP[bits], torch.ones_like(amax))
    r = torch.round(xf / scale[..., None])
    if bits == 8:
        return torch.clamp(r, -127, 127).to(torch.int8), scale
    q = (torch.clamp(r, -8, 7) + 8).to(torch.uint8)
    d = x.shape[-1]
    return q[..., : d // 2] | (q[..., d // 2 :] << 4), scale


def dequantize_kv(stored: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The JAX caches' `layer()` dequant: bf16(stored) * bf16(scale), a bf16
    product (the Pallas kernels instead round f32(stored) * scale once)."""
    from ..ops.decode_attention import unpack4_planar

    vals = unpack4_planar(stored) if stored.dtype == torch.uint8 else stored.to(torch.bfloat16)
    return vals * scale[..., None].to(torch.bfloat16)


def _quant_storage(shape, bits: int, device):
    """Empty quantized storage: int8 zeros, or 0x88 (two excess-8 zeros) so an
    untouched int4 row dequantizes to 0; scales 1."""
    d_store = shape[-1] // 2 if bits == 4 else shape[-1]
    kv_shape = (*shape[:-1], d_store)

    def fill():
        return (torch.full(kv_shape, 0x88, dtype=torch.uint8, device=device) if bits == 4
                else torch.zeros(kv_shape, dtype=torch.int8, device=device))

    return (fill(), fill(), torch.ones(shape[:-1], dtype=torch.float32, device=device),
            torch.ones(shape[:-1], dtype=torch.float32, device=device))


class QuantKVCache:
    """int8 KV cache with per-(token, head) scales (JAX `QuantKVCache`).

    k, v: int8 [L, B, H_kv, max_len, D]; k_scale, v_scale: f32 [L, B, H_kv,
    max_len]; pos: int32 0-d tensor on the device. max_len rounds up to a
    multiple of 128."""

    BITS = 8

    def __init__(self, k, v, k_scale, v_scale, pos=0):
        self.k = k
        self.v = v
        self.k_scale = k_scale
        self.v_scale = v_scale
        self.pos = head(pos, k.device)

    @classmethod
    def init(cls, n_layers: int, batch: int, max_len: int, n_kv_heads: int, head_dim: int, *,
             device, dtype=None):
        shape = (n_layers, batch, n_kv_heads, _round_up(max_len), head_dim)
        return cls(*_quant_storage(shape, cls.BITS, device), 0)

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    @property
    def n_layers(self) -> int:
        return self.k.shape[0]

    @classmethod
    def _quantize(cls, x: torch.Tensor):
        """[B, H, S, D] float -> (stored, scale [B, H, S])."""
        return quantize_kv(x, cls.BITS)

    def update_layer(self, layer: int, k_new: torch.Tensor, v_new: torch.Tensor):
        """Quantize k_new/v_new [B, S, H_kv, D] and write them at self.pos of
        `layer`, in place (the start clamped as `KVCache.update_layer`); pos
        does not advance."""
        rows = _write_rows(self, k_new.shape[1])
        for buf, sbuf, new in ((self.k, self.k_scale, k_new), (self.v, self.v_scale, v_new)):
            q, sc = self._quantize(new.transpose(1, 2))
            buf[layer].index_copy_(2, rows, q)
            sbuf[layer].index_copy_(2, rows, sc)
        return self

    def layer(self, layer: int):
        """Dequantized K/V for one layer: ([B, H_kv, max_len, D] bf16, same)."""
        return (dequantize_kv(self.k[layer], self.k_scale[layer]),
                dequantize_kv(self.v[layer], self.v_scale[layer]))

    def layer_quant(self, layer: int):
        """(k, v, k_scale, v_scale) of one layer as stored, for the kernels."""
        return self.k[layer], self.v[layer], self.k_scale[layer], self.v_scale[layer]

    def with_pos(self, pos):
        return type(self)(self.k, self.v, self.k_scale, self.v_scale, pos)

    def advance(self, n):
        return self.with_pos(self.pos + n)

    def reset(self):
        return self.with_pos(0)

    def rollback_accept(self, draft_start, accept_idx, n_accept):
        """`KVCache.rollback_accept` on the stored rows and their scales
        (packed int4 bytes move as they are)."""
        return self.with_pos(_rollback((self.k, self.v, self.k_scale[..., None], self.v_scale[..., None]),
                                       self.max_len, draft_start, accept_idx, n_accept))


class Quant4KVCache(QuantKVCache):
    """int4 KV cache (JAX `Quant4KVCache`): k, v packed uint8 [L, B, H_kv,
    max_len, D/2] (planar nibbles, excess-8), f32 scales as `QuantKVCache`."""

    BITS = 4


# -- per-slot caches (continuous batching) -------------------------------------


def _slot_append(buf: torch.Tensor, layer: int, upd: torch.Tensor, pos: torch.Tensor) -> None:
    """Write upd[b] at buf[layer, b, :, min(pos[b], S - 1), ...] in place, for
    every slot at once (JAX `_slot_append`: its dynamic_update_slice clamps a
    start past the cache to the last row)."""
    b = upd.shape[0]
    row = pos.clamp(0, buf.shape[3] - 1).long()
    buf[layer, torch.arange(b, device=buf.device), :, row] = upd.to(buf.dtype)


class SlotKVCache:
    """Continuous-batching cache (JAX `SlotKVCache`): dense storage
    [L, B, H_kv, max_len, D] and a write head per slot, pos int32 [B] on the
    cache's device. Decode appends one token per slot at its own head;
    admission copies a freshly prefilled small cache into a slot."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor):
        self.k = k
        self.v = v
        self.pos = pos

    @staticmethod
    def init(n_layers: int, batch: int, max_len: int, n_kv_heads: int, head_dim: int, *,
             device, dtype=torch.bfloat16) -> "SlotKVCache":
        shape = (n_layers, batch, n_kv_heads, max_len, head_dim)
        return SlotKVCache(torch.zeros(shape, device=device, dtype=dtype),
                           torch.zeros(shape, device=device, dtype=dtype),
                           torch.zeros(batch, device=device, dtype=torch.int32))

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    @property
    def n_layers(self) -> int:
        return self.k.shape[0]

    def update_layer(self, layer: int, k_new: torch.Tensor, v_new: torch.Tensor) -> "SlotKVCache":
        """Decode append: k_new/v_new [B, 1, H_kv, D] at pos[b] per slot."""
        _slot_append(self.k, layer, k_new[:, 0], self.pos)
        _slot_append(self.v, layer, v_new[:, 0], self.pos)
        return self

    def layer(self, layer: int):
        return self.k[layer], self.v[layer]

    def advance(self, n) -> "SlotKVCache":
        return SlotKVCache(self.k, self.v, self.pos + n)

    def make_prefill_cache(self, batch: int, bucket: int, n_layers: int, n_kv_heads: int,
                           head_dim: int) -> KVCache:
        """Small admission-prefill cache of the matching storage type."""
        return KVCache.init(n_layers, batch, bucket, n_kv_heads, head_dim, device=self.k.device,
                            dtype=self.k.dtype)

    def admit(self, slot: int, small: KVCache, true_len) -> "SlotKVCache":
        """Copy a freshly prefilled 1-sequence cache into `slot`."""
        rows = small.k.shape[3]
        self.k[:, slot, :, :rows] = small.k[:, 0]
        self.v[:, slot, :, :rows] = small.v[:, 0]
        return SlotKVCache(self.k, self.v, _set_rows(self.pos, [slot], [true_len]))

    def admit_batch(self, slot_ids, small: KVCache, true_lens, bucket: int) -> "SlotKVCache":
        """Install A prefilled sequences: row a of `small` into slot
        slot_ids[a] (host ints); rows with slot_ids >= B are dropped."""
        rows, slots = _kept_rows(slot_ids, self.k.shape[1])
        if rows.size:
            src, dst = to_device(rows, self.k.device, torch.long), to_device(slots, self.k.device, torch.long)
            self.k[:, dst, :, :bucket] = small.k[:, src, :, :bucket]
            self.v[:, dst, :, :bucket] = small.v[:, src, :, :bucket]
        return SlotKVCache(self.k, self.v, _set_rows(self.pos, slots, np.asarray(true_lens)[rows]))


def _kept_rows(slot_ids, n_slots: int):
    """(rows, slots) of the admission rows whose slot id is a real slot."""
    ids = np.asarray(slot_ids, np.int64).reshape(-1)
    rows = np.nonzero(ids < n_slots)[0]
    return rows, ids[rows]


class SlotQuantKVCache:
    """Continuous-batching cache over quantized storage (JAX
    `SlotQuantKVCache`): `SlotKVCache`'s per-slot heads with the storage of
    `QuantKVCache` (bits 8) or `Quant4KVCache` (bits 4)."""

    def __init__(self, k, v, k_scale, v_scale, pos: torch.Tensor, bits: int = 8):
        self.k = k
        self.v = v
        self.k_scale = k_scale
        self.v_scale = v_scale
        self.pos = pos
        self.bits = bits

    @staticmethod
    def init(n_layers: int, batch: int, max_len: int, n_kv_heads: int, head_dim: int, *,
             device, bits: int = 8) -> "SlotQuantKVCache":
        shape = (n_layers, batch, n_kv_heads, _round_up(max_len), head_dim)
        return SlotQuantKVCache(*_quant_storage(shape, bits, device),
                                torch.zeros(batch, device=device, dtype=torch.int32), bits)

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    @property
    def n_layers(self) -> int:
        return self.k.shape[0]

    def _replace(self, pos: torch.Tensor) -> "SlotQuantKVCache":
        return SlotQuantKVCache(self.k, self.v, self.k_scale, self.v_scale, pos, self.bits)

    def update_layer(self, layer: int, k_new: torch.Tensor, v_new: torch.Tensor):
        """Decode append: quantize k_new/v_new [B, 1, H_kv, D] over D and write
        them at pos[b] per slot."""
        for buf, sbuf, new in ((self.k, self.k_scale, k_new), (self.v, self.v_scale, v_new)):
            q, sc = quantize_kv(new[:, 0], self.bits)  # [B, H, D'], [B, H]
            _slot_append(buf, layer, q, self.pos)
            _slot_append(sbuf, layer, sc, self.pos)
        return self

    def layer(self, layer: int):
        return (dequantize_kv(self.k[layer], self.k_scale[layer]),
                dequantize_kv(self.v[layer], self.v_scale[layer]))

    def layer_quant(self, layer: int):
        return self.k[layer], self.v[layer], self.k_scale[layer], self.v_scale[layer]

    def advance(self, n) -> "SlotQuantKVCache":
        return self._replace(self.pos + n)

    def make_prefill_cache(self, batch: int, bucket: int, n_layers: int, n_kv_heads: int,
                           head_dim: int) -> QuantKVCache:
        """Small admission-prefill cache of the matching quantized type."""
        cls = Quant4KVCache if self.bits == 4 else QuantKVCache
        return cls.init(n_layers, batch, bucket, n_kv_heads, head_dim, device=self.k.device)

    def admit(self, slot: int, small: QuantKVCache, true_len) -> "SlotQuantKVCache":
        """Copy a freshly prefilled quantized 1-sequence cache into `slot`."""
        rows = small.k.shape[3]
        for dst, src in ((self.k, small.k), (self.v, small.v), (self.k_scale, small.k_scale),
                         (self.v_scale, small.v_scale)):
            dst[:, slot, :, :rows] = src[:, 0]
        return self._replace(_set_rows(self.pos, [slot], [true_len]))

    def admit_batch(self, slot_ids, small: QuantKVCache, true_lens, bucket: int):
        """Install A prefilled sequences (rows with slot_ids >= B are dropped)."""
        rows, slots = _kept_rows(slot_ids, self.k.shape[1])
        if rows.size:
            src, dst = to_device(rows, self.k.device, torch.long), to_device(slots, self.k.device, torch.long)
            for d, s in ((self.k, small.k), (self.v, small.v), (self.k_scale, small.k_scale),
                         (self.v_scale, small.v_scale)):
                d[:, dst, :, :bucket] = s[:, src, :, :bucket]
        return self._replace(_set_rows(self.pos, slots, np.asarray(true_lens)[rows]))


# -- paged ---------------------------------------------------------------------


class PagedKVCache:
    """Paged (block-table) continuous-batching cache (JAX `PagedKVCache`).

    K/V live in a pool of BS = 128-row blocks shared by the slots; slot b's
    logical block i is pool block table[b, i] (-1: none). Blocks are reserved
    per request by the engine's allocator (`ContinuousEngine`), so short
    requests do not pay for max_len.

    k, v:   [L, NB, H_kv, BS, D]   the pool (views of the storage below)
    table:  int32 [B, MAXB]        on the device; `table_host` is its numpy copy
    pos:    int32 [B]              per-slot write heads (token positions)

    The storage holds one block more than the pool, a sink: an append that
    JAX drops (past the table, or through a -1 entry) is written there
    instead, and nothing reads it.
    """

    BS = BLOCK

    def __init__(self, k_store: torch.Tensor, v_store: torch.Tensor, table: torch.Tensor,
                 pos: torch.Tensor, table_host: np.ndarray):
        self.k_store = k_store
        self.v_store = v_store
        self.table = table
        self.pos = pos
        self.table_host = table_host

    @staticmethod
    def init(n_layers: int, batch: int, max_len: int, n_kv_heads: int, head_dim: int, *,
             device, dtype=torch.bfloat16, n_blocks: int = 0) -> "PagedKVCache":
        """max_len: per-slot logical capacity (table width max_len / BS, rounded
        up); n_blocks: pool size, default half of batch * max_len / BS."""
        maxb = _round_up(max_len, PagedKVCache.BS) // PagedKVCache.BS
        if n_blocks <= 0:
            n_blocks = max(batch * maxb // 2, maxb)
        shape = (n_layers, n_blocks + 1, n_kv_heads, PagedKVCache.BS, head_dim)
        table = np.full((batch, maxb), -1, np.int32)
        return PagedKVCache(torch.zeros(shape, device=device, dtype=dtype),
                            torch.zeros(shape, device=device, dtype=dtype),
                            to_device(table, device), torch.zeros(batch, device=device, dtype=torch.int32),
                            table)

    @property
    def k(self) -> torch.Tensor:
        return self.k_store[:, :-1]

    @property
    def v(self) -> torch.Tensor:
        return self.v_store[:, :-1]

    @property
    def max_len(self) -> int:
        return self.table.shape[1] * self.BS

    @property
    def n_layers(self) -> int:
        return self.k_store.shape[0]

    @property
    def n_blocks(self) -> int:
        return self.k_store.shape[1] - 1

    def _replace(self, pos=None, table_host=None) -> "PagedKVCache":
        if table_host is None:
            table_host = self.table_host
        else:  # in place: a captured window reads the table where it was captured
            self.table.copy_(torch.from_numpy(table_host), non_blocking=True)
        return PagedKVCache(self.k_store, self.v_store, self.table, self.pos if pos is None else pos,
                            table_host)

    def update_layer(self, layer: int, k_new: torch.Tensor, v_new: torch.Tensor) -> "PagedKVCache":
        """Decode append: k_new/v_new [B, 1, H_kv, D] at each slot's head."""
        maxb = self.table.shape[1]
        logical = (self.pos // self.BS).long()
        phys = self.table.gather(1, logical.clamp(max=maxb - 1)[:, None])[:, 0].long()
        phys = torch.where((logical < maxb) & (phys >= 0), phys, self.n_blocks)  # else: the sink
        row = (self.pos % self.BS).long()
        self.k_store[layer, phys, :, row] = k_new[:, 0].to(self.k_store.dtype)
        self.v_store[layer, phys, :, row] = v_new[:, 0].to(self.v_store.dtype)
        return self

    def layer(self, layer: int):
        """The gathered dense view [B, H_kv, MAXB * BS, D] of each slot's blocks."""
        from ..ops.decode_attention import gather_pages

        return gather_pages(self.k[layer], self.table), gather_pages(self.v[layer], self.table)

    def advance(self, n) -> "PagedKVCache":
        return self._replace(pos=self.pos + n)

    def make_prefill_cache(self, batch: int, bucket: int, n_layers: int, n_kv_heads: int,
                           head_dim: int) -> KVCache:
        return KVCache.init(n_layers, batch, bucket, n_kv_heads, head_dim, device=self.k_store.device,
                            dtype=self.k_store.dtype)

    def _install(self, small: KVCache, rows, slots) -> None:
        """Copy small-cache row rows[i] into the blocks of slot slots[i]: its
        logical block j to pool block table[slot, j]; -1 entries are skipped."""
        l, _, h, bucket, d = small.k.shape
        nbk = -(-bucket // self.BS)
        src_row, src_blk, dst = [], [], []
        for r, s in zip(rows, slots):
            for j, p in enumerate(self.table_host[s, :nbk]):
                if p >= 0:
                    src_row.append(r)
                    src_blk.append(j)
                    dst.append(p)
        if not dst:
            return
        dev = self.k_store.device
        src_row, src_blk, dst = (to_device(np.asarray(x, np.int64), dev) for x in (src_row, src_blk, dst))
        for store, kv in ((self.k_store, small.k), (self.v_store, small.v)):
            if bucket % self.BS:  # admission buckets smaller than a block: pad up
                kv = torch.nn.functional.pad(kv, (0, 0, 0, nbk * self.BS - bucket))
            blocks = kv.reshape(l, kv.shape[1], h, nbk, self.BS, d).permute(0, 1, 3, 2, 4, 5)
            store[:, dst] = blocks[:, src_row, src_blk].to(store.dtype)

    def admit(self, slot: int, small: KVCache, true_len) -> "PagedKVCache":
        """Scatter a prefilled 1-sequence cache into this slot's reserved blocks."""
        self._install(small, [0], [slot])
        return self._replace(pos=_set_rows(self.pos, [slot], [true_len]))

    def admit_batch(self, slot_ids, small: KVCache, true_lens, bucket: int) -> "PagedKVCache":
        """Scatter A prefilled sequences into their slots' blocks (rows with
        slot_ids >= B are dropped)."""
        rows, slots = _kept_rows(slot_ids, self.table.shape[0])
        sub = KVCache(small.k[:, :, :, :bucket], small.v[:, :, :, :bucket])
        self._install(sub, rows, slots)
        return self._replace(pos=_set_rows(self.pos, slots, np.asarray(true_lens)[rows]))

    def with_tables(self, table: np.ndarray) -> "PagedKVCache":
        """The allocator's table update (host numpy, copied to the device)."""
        return self._replace(table_host=np.array(table, np.int32))
