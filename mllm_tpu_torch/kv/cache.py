"""Dense KV cache: counterpart of `mllm_tpu/kv/cache.py:KVCache`.

Storage is `[L, B, H_kv, max_len, D]` per K and V: the sequence axis is
inner per head, so the attention kernels stream one head's keys
contiguously. The write head `pos` is a host int, so eager decode never
reads a device scalar back per layer.

`update_layer` writes IN PLACE into the storage. `advance`, `with_pos` and
`reset` return a new KVCache over the same storage with another write head,
so callers keep the JAX package's style (`cache = cache.advance(n)`).
"""

from __future__ import annotations

import torch


class KVCache:
    """k, v: [L, B, H_kv, max_len, D]; pos: number of valid cached tokens."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor, pos: int = 0):
        self.k = k
        self.v = v
        self.pos = int(pos)

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
        """Write k_new/v_new [B, S, H_kv, D] at self.pos of `layer`, in place.

        Does NOT advance pos (all layers append at the same offset; call
        `advance` once per step)."""
        s = k_new.shape[1]
        if self.pos + s > self.max_len:
            raise ValueError(f"KV cache overflow: pos {self.pos} + {s} tokens > max_len {self.max_len}")
        self.k[layer, :, :, self.pos : self.pos + s].copy_(k_new.transpose(1, 2))
        self.v[layer, :, :, self.pos : self.pos + s].copy_(v_new.transpose(1, 2))
        return self

    def layer(self, layer: int):
        """Full-length K/V for one layer: ([B, H_kv, max_len, D], same)."""
        return self.k[layer], self.v[layer]

    def advance(self, n: int) -> "KVCache":
        return KVCache(self.k, self.v, self.pos + int(n))

    def with_pos(self, pos: int) -> "KVCache":
        """Same storage, write head at `pos`."""
        return KVCache(self.k, self.v, pos)

    def reset(self) -> "KVCache":
        """Rewind the write head; the storage is left as it is."""
        return KVCache(self.k, self.v, 0)
