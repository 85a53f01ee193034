"""Weight-container readers, copied from `mllm_tpu/core/param_loader.py`.

Reads the reference `.mllm` format bit-compatibly (magic 20012; header layout
documented at mllm/ParamLoader.cpp:14-31 of the reference C++ engine) and the
`.mllm` vocab format (magic 23333), writes both (`MllmWriter`,
`write_vocab`), and reads HuggingFace safetensors (single file, or an HF
directory with or without an index).

The loaders memory-map the file and hand out zero-copy numpy views of its
bytes; tensors are materialized (and dequantized by `core/dtypes.py`) lazily,
shaped by the model definition (the `.mllm` container stores no shapes). A
`.mllm` loader also exposes a tensor's raw bytes and ggml type (`raw`,
`dtype`), which `models/loading.py` repacks into the int4 / int8 kernels'
layouts. bf16 is widened to f32 by bit shifts (numpy has no bfloat16).
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from collections.abc import Mapping
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from . import dtypes
from .dtypes import DataType

MLLM_MAGIC = 20012
VOCAB_MAGIC = 23333


@dataclass(frozen=True)
class ParamEntry:
    name: str
    offset: int  # absolute byte offset in file
    size: int  # byte length
    dtype: DataType


class ParamLoader(Mapping):
    """Reader for a single `.mllm` weight container.

    Layout: [int32 magic][u64 index_len][index entries...][tensor bytes...]
    index entry: [int32 name_len][name][u64 size][u64 offset][int32 dtype]
    """

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        with open(self.path, "rb") as f:
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        self._buf = np.frombuffer(self._mm, dtype=np.uint8)
        (magic,) = struct.unpack_from("<i", self._mm, 0)
        if magic != MLLM_MAGIC:
            raise ValueError(f"{self.path}: bad magic {magic}, want {MLLM_MAGIC}")
        (index_len,) = struct.unpack_from("<Q", self._mm, 4)
        self.entries: dict[str, ParamEntry] = {}
        pos, end = 12, 12 + index_len
        while pos < end:
            (name_len,) = struct.unpack_from("<i", self._mm, pos)
            pos += 4
            if name_len == 0:  # zero padding after last entry
                break
            name = self._mm[pos : pos + name_len].decode("utf-8")
            pos += name_len
            size, offset = struct.unpack_from("<QQ", self._mm, pos)
            pos += 16
            (dt,) = struct.unpack_from("<i", self._mm, pos)
            pos += 4
            self.entries[name] = ParamEntry(name, offset, size, DataType(dt))

    # Mapping interface over entry names
    def __getitem__(self, name: str) -> ParamEntry:
        return self.entries[name]

    def __iter__(self) -> Iterator[str]:
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def raw(self, name: str) -> np.ndarray:
        """Zero-copy uint8 view of the tensor's bytes."""
        e = self.entries[name]
        return self._buf[e.offset : e.offset + e.size]

    def dtype(self, name: str) -> DataType:
        return self.entries[name].dtype

    def load(self, name: str, shape: tuple[int, ...], dtype=np.float32) -> np.ndarray:
        """Materialize a tensor: dequantize if needed, reshape to `shape`."""
        e = self.entries[name]
        n = int(np.prod(shape))
        # GemmPack row-interleaved formats need the row width to un-interleave
        npr = int(shape[-1]) if len(shape) >= 2 else None
        arr = dtypes.decode(self.raw(name), e.dtype, n, n_per_row=npr)
        if arr.dtype != dtype and dtype is not None:
            arr = arr.astype(dtype)
        return arr.reshape(shape)

    def close(self):
        self._mm.close()


class MultiFileParamLoader(Mapping):
    """Parity with reference MultiFileParamLoader (ParamLoader.hpp:120-141)."""

    def __init__(self, paths):
        self.loaders = [ParamLoader(p) for p in paths]
        self._index: dict[str, ParamLoader] = {}
        for ld in self.loaders:
            for name in ld:
                self._index[name] = ld

    def __getitem__(self, name: str) -> ParamEntry:
        return self._index[name][name]

    def __iter__(self):
        return iter(self._index)

    def __len__(self):
        return len(self._index)

    def raw(self, name: str) -> np.ndarray:
        return self._index[name].raw(name)

    def dtype(self, name: str) -> DataType:
        return self._index[name].dtype(name)

    def load(self, name: str, shape, dtype=np.float32) -> np.ndarray:
        return self._index[name].load(name, shape, dtype)


def load_vocab(path: str | os.PathLike):
    """Read a `.mllm` vocab file (magic 23333).

    Returns (token_to_id: dict[str,int], id_to_token: list[str], scores: list[float]).
    Format: [int32 magic][int32 count] then count x ([int32 id][int32 len][bytes][f32 score]).
    """
    with open(path, "rb") as f:
        data = f.read()
    (magic, count) = struct.unpack_from("<ii", data, 0)
    if magic != VOCAB_MAGIC:
        raise ValueError(f"{path}: bad vocab magic {magic}")
    pos = 8
    token_to_id: dict[str, int] = {}
    max_id = -1
    items = []
    for _ in range(count):
        (tid, tlen) = struct.unpack_from("<ii", data, pos)
        pos += 8
        raw = data[pos : pos + tlen]
        try:
            tok = raw.decode("utf-8")
        except UnicodeDecodeError:
            # sentencepiece byte-fallback tokens are stored as raw bytes
            # 0x00..0xFF in reference .mllm vocabs (llama2_vocab.mllm
            # ids 3..258) — keep them as latin-1 chars, not U+FFFD.
            tok = raw.decode("latin-1")
        pos += tlen
        (score,) = struct.unpack_from("<f", data, pos)
        pos += 4
        items.append((tid, tok, score))
        max_id = max(max_id, tid)
        token_to_id[tok] = tid
    id_to_token = [""] * (max_id + 1)
    scores = [0.0] * (max_id + 1)
    for tid, tok, score in items:
        id_to_token[tid] = tok
        scores[tid] = score
    return token_to_id, id_to_token, scores


def load_merges(path: str | os.PathLike) -> dict[tuple[str, str], int]:
    """Read a merges.txt (BPE merge ranks) file."""
    merges: dict[tuple[str, str], int] = {}
    with open(path, encoding="utf-8") as f:
        rank = 0
        for line in f:
            line = line.rstrip("\n")
            if not line or line.startswith("#version"):
                continue
            parts = line.split(" ")
            if len(parts) != 2:
                continue
            merges[(parts[0], parts[1])] = rank
            rank += 1
    return merges


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

    def __contains__(self, name):  # without decoding the tensor, as Mapping's would
        return name in self._index

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
            # widen bf16 -> f32 (exact; numpy has no bfloat16) with torch's
            # conversion, ~3x faster than numpy's shift on the host
            import warnings

            import torch

            with warnings.catch_warnings():  # the mapping is read-only; the conversion copies
                warnings.simplefilter("ignore", UserWarning)
                bf16 = torch.frombuffer(raw, dtype=torch.bfloat16) if raw.size else torch.empty(0, dtype=torch.bfloat16)
            return bf16.float().numpy().reshape(shape)
        np_dt = _ST_DTYPES[st_dt]
        return raw.view(np_dt).reshape(shape)


# ---------------------------------------------------------------------------
# Writer: produces `.mllm` files that the reference C++ engine can also read
# (used by tests and by chip_smoke.py's container phase).
# ---------------------------------------------------------------------------


class MllmWriter:
    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        self._tensors: list[tuple[str, bytes, DataType]] = []

    def add(self, name: str, data: np.ndarray | bytes, dtype: DataType | None = None):
        if isinstance(data, np.ndarray):
            if dtype is None:
                dtype = {
                    np.dtype(np.float32): DataType.F32,
                    np.dtype(np.float16): DataType.F16,
                    np.dtype(np.int8): DataType.I8,
                    np.dtype(np.int32): DataType.I32,
                    np.dtype(np.uint8): DataType.KLEIDIAI_Q4_0,
                }[data.dtype]
            data = np.ascontiguousarray(data).tobytes()
        assert dtype is not None
        self._tensors.append((name, data, dtype))

    def write(self):
        index_len = sum(4 + len(n.encode()) + 8 + 8 + 4 for n, _, _ in self._tensors)
        with open(self.path, "wb") as f:
            f.write(struct.pack("<i", MLLM_MAGIC))
            f.write(struct.pack("<Q", index_len))
            offset = 12 + index_len
            index = b""
            for name, data, dt in self._tensors:
                nb = name.encode("utf-8")
                index += struct.pack("<i", len(nb)) + nb
                index += struct.pack("<QQi", len(data), offset, int(dt))
                offset += len(data)
            f.write(index)
            for _, data, _ in self._tensors:
                f.write(data)


def write_vocab(path: str | os.PathLike, tokens: list[str], scores=None):
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", VOCAB_MAGIC, len(tokens)))
        for i, tok in enumerate(tokens):
            tb = tok.encode("utf-8")
            f.write(struct.pack("<ii", i, len(tb)))
            f.write(tb)
            f.write(struct.pack("<f", scores[i] if scores else 0.0))


# ---------------------------------------------------------------------------
# Safetensors writer (the format written by hand: the card has no
# `safetensors` package)
# ---------------------------------------------------------------------------

_NP_TO_ST = {np.dtype(np.float32): "F32", np.dtype(np.float16): "F16", np.dtype(np.int8): "I8",
             np.dtype(np.uint8): "U8", np.dtype(np.int32): "I32", np.dtype(np.int64): "I64"}


def write_safetensors(path: str | os.PathLike, tensors: dict, metadata: dict | None = None) -> None:
    """Write numpy arrays (or bf16 torch tensors: numpy has no bfloat16) as
    one safetensors file: an 8-byte little-endian header length, the JSON
    header (name -> dtype, shape, data_offsets, and `__metadata__`), padded
    with spaces to a multiple of 8 bytes, then each tensor's raw little-endian
    bytes in name order."""
    import torch

    names = sorted(tensors)
    header: dict = {"__metadata__": dict(metadata)} if metadata else {}
    offset = 0
    blobs = []
    for name in names:
        arr = tensors[name]
        if isinstance(arr, torch.Tensor) and arr.dtype == torch.bfloat16:  # its bits as int16, little-endian
            st, data = "BF16", arr.detach().contiguous().view(torch.int16).cpu().numpy().tobytes()
        else:
            arr = np.ascontiguousarray(arr)
            if arr.dtype not in _NP_TO_ST:
                raise ValueError(f"write_safetensors: {name} has dtype {arr.dtype}")
            st, data = _NP_TO_ST[arr.dtype], arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes()
        header[name] = {"dtype": st, "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(data)]}
        offset += len(data)
        blobs.append(data)
    head = json.dumps(header, separators=(",", ":")).encode("utf-8")
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for data in blobs:
            f.write(data)


def save_safetensors_model(out_dir: str, model, src_dir: str | None = None, names=None) -> str:
    """Write a CausalLM back to an HF-style checkpoint directory (the inverse
    of `load_causal_lm` for the dense layout: q/k/v/o, gate/up/down, norms),
    every tensor f32 under its HF name, as the JAX package writes it; the
    directory loads with `auto_model` and with transformers. Copies
    config.json and the tokenizer files from `src_dir` when given. Fused,
    quantized, adapter-wrapped or non-dense MLP layers raise: merge, unfuse
    or dequantize first."""
    import shutil

    from ..models.loading import NameMap

    nm = names or NameMap()
    t: dict = {}

    def put(name, tensor):
        if tensor is not None:
            t[name] = tensor.detach().float().cpu().numpy()

    def put_linear(prefix, lin):
        if lin is None:
            return
        if type(lin).__name__ != "Linear":
            raise ValueError(f"save_safetensors_model: {prefix} is {type(lin).__name__}; "
                             "merge/unfuse/dequantize before saving")
        put(prefix + ".weight", lin.weight)
        put(prefix + ".bias", lin.bias)

    def put_norm(name, norm):
        if norm is None:
            return
        base = name[: -len(".weight")] if name.endswith(".weight") else name
        put(base + ".weight", norm.weight)
        if getattr(norm, "bias", None) is not None:
            put(base + ".bias", norm.bias)

    if type(model.embed_tokens).__name__ != "Embedding":
        raise ValueError(f"save_safetensors_model: embed_tokens is {type(model.embed_tokens).__name__}")
    put(nm.token_embd, model.embed_tokens.weight)
    put_norm(nm.final_norm, model.norm)
    if model.lm_head is not None:
        put_linear(nm.lm_head[: -len(".weight")], model.lm_head)
    for i, blk in enumerate(model.blocks):
        p = nm.blk.format(i=i)
        a = blk.attn
        if a.qkv_proj is not None:
            raise ValueError("save_safetensors_model: unfuse qkv_proj first")
        put_linear(p + nm.attn_q, a.q_proj)
        put_linear(p + nm.attn_k, a.k_proj)
        put_linear(p + nm.attn_v, a.v_proj)
        put_linear(p + nm.attn_o, a.o_proj)
        if a.q_norm is not None:
            put_norm(p + nm.q_norm, a.q_norm)
            put_norm(p + nm.k_norm, a.k_norm)
        m = blk.mlp
        if type(m).__name__ != "MLP":
            raise ValueError(f"save_safetensors_model: layer {i} mlp is {type(m).__name__} (dense MLP only)")
        if m.gateup_proj is not None:
            raise ValueError("save_safetensors_model: unfuse gateup_proj first")
        put_linear(p + nm.gate, m.gate_proj)
        put_linear(p + nm.up, m.up_proj)
        put_linear(p + nm.down, m.down_proj)
        put_norm(p + nm.attn_norm, blk.input_norm)
        put_norm(p + nm.ffn_norm, blk.post_attn_norm)
        put_norm(p + nm.pre_ffn_norm, blk.pre_ffn_norm)
        put_norm(p + nm.post_ffn_norm, blk.post_ffn_norm)

    os.makedirs(out_dir, exist_ok=True)
    write_safetensors(os.path.join(out_dir, "model.safetensors"), t, metadata={"format": "pt"})
    if src_dir:
        for f in ("config.json", "generation_config.json", "tokenizer.json", "tokenizer_config.json",
                  "vocab.json", "merges.txt"):
            s = os.path.join(src_dir, f)
            if os.path.exists(s):
                shutil.copy(s, os.path.join(out_dir, f))
    return out_dir
