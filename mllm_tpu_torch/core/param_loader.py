"""Safetensors reader (single file, or an HF directory with or without an
index), copied from `mllm_tpu/core/param_loader.py:SafetensorsLoader`.

The file is memory-mapped and tensors come out as numpy views of its bytes;
bf16 is widened to f32 by bit shifts (numpy has no bfloat16). The `.mllm`
container readers of the JAX package are not ported yet.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from collections.abc import Mapping

import numpy as np

_ST_DTYPES = {
    "F32": np.float32,
    "F16": np.float16,
    "BF16": None,  # handled specially below
    "I64": np.int64,
    "I32": np.int32,
    "I16": np.int16,
    "I8": np.int8,
    "U8": np.uint8,
    "BOOL": np.bool_,
    "F64": np.float64,
}


class SafetensorsLoader(Mapping):
    """Minimal zero-copy safetensors reader (single file or HF index dir)."""

    def __init__(self, path: str | os.PathLike):
        path = os.fspath(path)
        if os.path.isdir(path):
            idx = os.path.join(path, "model.safetensors.index.json")
            if os.path.exists(idx):
                with open(idx) as f:
                    weight_map = json.load(f)["weight_map"]
                files = sorted(set(weight_map.values()))
                self._files = [_SafetensorsFile(os.path.join(path, fn)) for fn in files]
            else:
                self._files = [
                    _SafetensorsFile(os.path.join(path, fn))
                    for fn in sorted(os.listdir(path))
                    if fn.endswith(".safetensors")
                ]
        else:
            self._files = [_SafetensorsFile(path)]
        self._index = {}
        for fobj in self._files:
            for name in fobj.header:
                self._index[name] = fobj

    def __getitem__(self, name):
        return self._index[name].get(name)

    def __iter__(self):
        return iter(self._index)

    def __len__(self):
        return len(self._index)

    def load(self, name: str, shape=None, dtype=np.float32) -> np.ndarray:
        arr = self._index[name].get(name)
        if dtype is not None and arr.dtype != dtype:
            arr = arr.astype(dtype)
        if shape is not None:
            arr = arr.reshape(shape)
        return arr


class _SafetensorsFile:
    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        (hlen,) = struct.unpack_from("<Q", self._mm, 0)
        self.header = json.loads(self._mm[8 : 8 + hlen].decode("utf-8"))
        self.header.pop("__metadata__", None)
        self._data_start = 8 + hlen
        self._buf = np.frombuffer(self._mm, dtype=np.uint8)

    def get(self, name: str) -> np.ndarray:
        meta = self.header[name]
        b0, b1 = meta["data_offsets"]
        raw = self._buf[self._data_start + b0 : self._data_start + b1]
        st_dt = meta["dtype"]
        shape = tuple(meta["shape"])
        if st_dt == "BF16":
            # widen bf16 -> f32 via bit tricks (numpy has no bfloat16)
            u16 = raw.view(np.uint16)
            u32 = u16.astype(np.uint32) << 16
            return u32.view(np.float32).reshape(shape)
        np_dt = _ST_DTYPES[st_dt]
        return raw.view(np_dt).reshape(shape)
