"""KV-cache persistence: counterpart of `mllm_tpu/kv/persist.py`.

A snapshot of a cache (plus optional metadata arrays) goes into one `.npz`
file, so a restarted server resumes decoding where it stopped without
prefilling again; the resumed decode is token-identical to an uninterrupted
run (tested).

The file format is the JAX package's, so a snapshot written by either
package loads in the other:
  - `__type__`  the cache class name;
  - `__names__` the leaf names, in the JAX pytree order (attribute names
    sorted: `k, pos, v` or `k, k_scale, pos, v, v_scale`);
  - `__dtypes__` the leaves' dtype names; bfloat16 leaves are stored widened
    to float32 (numpy has no bfloat16) and narrowed again on load;
  - `leaf_{i}`  the arrays, `extra_{key}` the caller's metadata.

The port's caches carry the JAX attribute names, so no renaming is needed.
Four types load (the JAX `_TYPES`): `KVCache`, `QuantKVCache`,
`Quant4KVCache`, `SlotKVCache`. The JAX `save_cache` writes any pytree and
fails only on load; here `save_cache` raises TypeError for any other cache
(paged, slot-quantized), rather than write a file that cannot be read back.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.runtime import default_device
from .cache import KVCache, Quant4KVCache, QuantKVCache, SlotKVCache

_TYPES = {c.__name__: c for c in (KVCache, Quant4KVCache, QuantKVCache, SlotKVCache)}
_LEAVES = {KVCache: ("k", "pos", "v"), SlotKVCache: ("k", "pos", "v"),
           QuantKVCache: ("k", "k_scale", "pos", "v", "v_scale"),
           Quant4KVCache: ("k", "k_scale", "pos", "v", "v_scale")}
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16,
           "int8": torch.int8, "uint8": torch.uint8, "int32": torch.int32, "int64": torch.int64}


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def save_cache(path, cache, extra: dict | None = None) -> None:
    """Snapshot `cache` (and `extra`: name -> array-like) to `path`."""
    names = _LEAVES.get(type(cache))
    if names is None:
        raise TypeError(f"save_cache takes {', '.join(_TYPES)}; got {type(cache).__name__}, "
                        "which load_cache could not restore")
    arrs, dtypes = {}, []
    for i, name in enumerate(names):
        t = getattr(cache, name).detach()
        dtypes.append(_dtype_name(t))
        if t.dtype == torch.bfloat16:
            t = t.float()  # bf16 has no numpy dtype: widen, restore on load
        arrs[f"leaf_{i}"] = t.cpu().numpy()
    arrs["__type__"] = np.asarray(type(cache).__name__)
    arrs["__names__"] = np.asarray(names)
    arrs["__dtypes__"] = np.asarray(dtypes)
    for k, v in (extra or {}).items():
        arrs[f"extra_{k}"] = np.asarray(v)
    np.savez(path, **arrs)


def load_cache(path, extra_keys: tuple = (), *, device=None):
    """Restore a cache saved by either package's `save_cache` onto `device`
    (its storage and its write head; the card unless `device="cpu"`);
    returns (cache, extras dict)."""
    device = default_device() if device is None else torch.device(device)
    z = np.load(path, allow_pickle=False)
    cls = _TYPES[str(z["__type__"])]
    leaves = {}
    for i, (name, dt) in enumerate(zip((str(n) for n in z["__names__"]), (str(d) for d in z["__dtypes__"]))):
        leaves[name] = torch.from_numpy(np.array(z[f"leaf_{i}"])).to(device=device, dtype=_DTYPES[dt])
    if cls in (QuantKVCache, Quant4KVCache):
        cache = cls(leaves["k"], leaves["v"], leaves["k_scale"], leaves["v_scale"], leaves["pos"])
    else:
        cache = cls(leaves["k"], leaves["v"], leaves["pos"])
    extras = {k: z[f"extra_{k}"] for k in extra_keys if f"extra_{k}" in z}
    return cache, extras
