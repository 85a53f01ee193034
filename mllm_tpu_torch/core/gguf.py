"""GGUF reader and writer, ported from `mllm_tpu/core/gguf.py`: a `.gguf`
file acts as a weight source (the loader protocol: load / raw / dtype /
__contains__), with llama.cpp tensor names mapped to the HF convention, the
config read from the metadata and the embedded tokenizer exposed.

GGUF v2/v3, little-endian. Quantized tensors (Q4_0 / Q8_0 / Q4_K / Q6_K; the
ggml type ids match core/dtypes.DataType numerically) flow straight into the
lossless repack path of `models/loading.py:make_linear`.
"""

from __future__ import annotations

import mmap
import os
import struct
from dataclasses import dataclass
from typing import Any

import numpy as np

from . import dtypes as dt
from .dtypes import DataType

GGUF_MAGIC = 0x46554747  # "GGUF"

# metadata value types
_T_U8, _T_I8, _T_U16, _T_I16, _T_U32, _T_I32, _T_F32, _T_BOOL, _T_STR, _T_ARR = range(10)
_T_U64, _T_I64, _T_F64 = 10, 11, 12

_SCALAR_FMT = {
    _T_U8: "<B", _T_I8: "<b", _T_U16: "<H", _T_I16: "<h",
    _T_U32: "<I", _T_I32: "<i", _T_F32: "<f", _T_BOOL: "<?",
    _T_U64: "<Q", _T_I64: "<q", _T_F64: "<d",
}

# ggml type id -> (DataType, elems/block, bytes/block)
_GGML_TYPES = {
    0: (DataType.F32, 1, 4),
    1: (DataType.F16, 1, 2),
    2: (DataType.Q4_0, 32, 18),
    3: (DataType.Q4_1, 32, 20),
    8: (DataType.Q8_0, 32, 34),
    12: (DataType.Q4_K, 256, 144),
    14: (DataType.Q6_K, 256, 210),
    15: (DataType.Q8_K, 256, 4 + 256 + 32),
    24: (DataType.I8, 1, 1),
    25: (DataType.I16, 1, 2),
    26: (DataType.I32, 1, 4),
}


@dataclass
class GGUFTensor:
    name: str
    shape: tuple[int, ...]  # torch-order (dims reversed from gguf ne)
    ggml_type: int
    offset: int  # relative to data section
    nbytes: int


class GGUFFile:
    """Low-level GGUF parser: metadata dict + tensor directory + mmap data."""

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        with open(self.path, "rb") as f:
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        self._buf = np.frombuffer(self._mm, np.uint8)
        pos = 0
        magic, version = struct.unpack_from("<II", self._mm, pos)
        pos += 8
        if magic != GGUF_MAGIC:
            raise ValueError(f"{self.path}: not a GGUF file")
        if version < 2:
            raise NotImplementedError("GGUF v1 not supported")
        n_tensors, n_kv = struct.unpack_from("<QQ", self._mm, pos)
        pos += 16

        self.metadata: dict[str, Any] = {}
        for _ in range(n_kv):
            key, pos = self._read_str(pos)
            (vt,) = struct.unpack_from("<I", self._mm, pos)
            pos += 4
            val, pos = self._read_value(vt, pos)
            self.metadata[key] = val

        self.tensors: dict[str, GGUFTensor] = {}
        infos = []
        for _ in range(n_tensors):
            name, pos = self._read_str(pos)
            (nd,) = struct.unpack_from("<I", self._mm, pos)
            pos += 4
            ne = struct.unpack_from(f"<{nd}Q", self._mm, pos)
            pos += 8 * nd
            (ggml_type,) = struct.unpack_from("<I", self._mm, pos)
            pos += 4
            (offset,) = struct.unpack_from("<Q", self._mm, pos)
            pos += 8
            infos.append((name, tuple(reversed(ne)), ggml_type, offset))

        align = int(self.metadata.get("general.alignment", 32))
        self.data_start = (pos + align - 1) // align * align
        for name, shape, ggml_type, offset in infos:
            n_elems = int(np.prod(shape)) if shape else 1
            dtinfo = _GGML_TYPES.get(ggml_type)
            nbytes = (n_elems // dtinfo[1] * dtinfo[2]) if dtinfo else 0
            self.tensors[name] = GGUFTensor(name, shape, ggml_type, offset, nbytes)

    def _read_str(self, pos):
        (n,) = struct.unpack_from("<Q", self._mm, pos)
        pos += 8
        s = self._mm[pos : pos + n].decode("utf-8", errors="replace")
        return s, pos + n

    def _read_value(self, vt, pos):
        if vt == _T_STR:
            return self._read_str(pos)
        if vt == _T_ARR:
            (et,) = struct.unpack_from("<I", self._mm, pos)
            pos += 4
            (cnt,) = struct.unpack_from("<Q", self._mm, pos)
            pos += 8
            out = []
            if et in _SCALAR_FMT:
                fmt = _SCALAR_FMT[et]
                size = struct.calcsize(fmt)
                for _ in range(cnt):
                    out.append(struct.unpack_from(fmt, self._mm, pos)[0])
                    pos += size
            else:
                for _ in range(cnt):
                    v, pos = self._read_value(et, pos)
                    out.append(v)
            return out, pos
        fmt = _SCALAR_FMT[vt]
        (v,) = struct.unpack_from(fmt, self._mm, pos)
        return v, pos + struct.calcsize(fmt)

    def raw_tensor(self, name: str) -> np.ndarray:
        t = self.tensors[name]
        start = self.data_start + t.offset
        return self._buf[start : start + t.nbytes]

    def tensor(self, name: str) -> np.ndarray:
        t = self.tensors[name]
        dtinfo = _GGML_TYPES[t.ggml_type]
        n = int(np.prod(t.shape))
        arr = dt.decode(self.raw_tensor(name), dtinfo[0], n)
        return arr.reshape(t.shape)


# ---------------------------------------------------------------------------
# llama.cpp tensor-name mapping -> HF convention
# ---------------------------------------------------------------------------


def _map_name(hf: str) -> str | None:
    """HF name -> gguf name (we look up by the HF name models ask for)."""
    if hf == "model.embed_tokens.weight":
        return "token_embd.weight"
    if hf == "model.norm.weight":
        return "output_norm.weight"
    if hf == "lm_head.weight":
        return "output.weight"
    if hf.startswith("model.layers."):
        rest = hf[len("model.layers."):]
        i, sub = rest.split(".", 1)
        m = {
            "self_attn.q_proj.weight": "attn_q.weight",
            "self_attn.k_proj.weight": "attn_k.weight",
            "self_attn.v_proj.weight": "attn_v.weight",
            "self_attn.o_proj.weight": "attn_output.weight",
            "self_attn.q_proj.bias": "attn_q.bias",
            "self_attn.k_proj.bias": "attn_k.bias",
            "self_attn.v_proj.bias": "attn_v.bias",
            "mlp.gate_proj.weight": "ffn_gate.weight",
            "mlp.up_proj.weight": "ffn_up.weight",
            "mlp.down_proj.weight": "ffn_down.weight",
            "input_layernorm.weight": "attn_norm.weight",
            "post_attention_layernorm.weight": "ffn_norm.weight",
            "self_attn.q_norm.weight": "attn_q_norm.weight",
            "self_attn.k_norm.weight": "attn_k_norm.weight",
        }.get(sub)
        if m:
            return f"blk.{i}.{m}"
    return None


class GGUFLoader:
    """Standard loader protocol over a GGUF file (HF names)."""

    def __init__(self, path):
        self.f = GGUFFile(path)

    def _resolve(self, name: str) -> str | None:
        g = _map_name(name)
        if g and g in self.f.tensors:
            return g
        return name if name in self.f.tensors else None

    def __contains__(self, name: str) -> bool:
        return self._resolve(name) is not None

    def load(self, name, shape, dtype=np.float32):
        g = self._resolve(name)
        arr = self.f.tensor(g)
        if dtype is not None and arr.dtype != dtype:
            arr = arr.astype(dtype)
        return arr.reshape(shape) if shape is not None else arr

    def raw(self, name):
        return self.f.raw_tensor(self._resolve(name))

    def dtype(self, name) -> DataType:
        return _GGML_TYPES[self.f.tensors[self._resolve(name)].ggml_type][0]


def config_from_gguf(path_or_file) -> "TextConfig":
    """Build a TextConfig from GGUF metadata (llama.cpp key conventions)."""
    from .config import TextConfig

    f = path_or_file if isinstance(path_or_file, GGUFFile) else GGUFFile(path_or_file)
    md = f.metadata
    arch = md.get("general.architecture", "llama")

    def g(key, default=None):
        return md.get(f"{arch}.{key}", default)

    heads = int(g("attention.head_count", 32))
    kv_heads = int(g("attention.head_count_kv", heads))
    emb = int(g("embedding_length", 4096))
    vocab = len(md.get("tokenizer.ggml.tokens", [])) or int(g("vocab_size", 32000))
    mt = {"llama": "llama", "qwen2": "qwen2", "gemma": "gemma", "phi3": "phi3",
          "stablelm": "stablelm"}.get(arch, "llama")
    return TextConfig(
        model_type=mt,
        vocab_size=vocab,
        hidden_size=emb,
        intermediate_size=int(g("feed_forward_length", 11008)),
        num_hidden_layers=int(g("block_count", 32)),
        num_attention_heads=heads,
        num_key_value_heads=kv_heads,
        max_position_embeddings=int(g("context_length", 4096)),
        rms_norm_eps=float(g("attention.layer_norm_rms_epsilon", 1e-5)),
        rope_theta=float(g("rope.freq_base", 10000.0)),
        attention_bias="qwen" in arch,
        tie_word_embeddings="output.weight" not in f.tensors,
        bos_token_id=int(md.get("tokenizer.ggml.bos_token_id", 1)),
        eos_token_id=int(md.get("tokenizer.ggml.eos_token_id", 2)),
    )


def tokenizer_from_gguf(path_or_file):
    """Build a tokenizer from GGUF-embedded vocab (llama/gpt2 models)."""
    f = path_or_file if isinstance(path_or_file, GGUFFile) else GGUFFile(path_or_file)
    md = f.metadata
    tokens = md.get("tokenizer.ggml.tokens", [])
    model = md.get("tokenizer.ggml.model", "llama")
    token_to_id = {t: i for i, t in enumerate(tokens)}
    if model == "gpt2":  # byte-level BPE with merges
        from ..tokenizers.bpe import ByteLevelBPE, QWEN2_PATTERN

        merges = md.get("tokenizer.ggml.merges", [])
        merge_rank = {}
        for r, m in enumerate(merges):
            a, b = m.split(" ", 1)
            merge_rank[(a, b)] = r
        tk = ByteLevelBPE(token_to_id, list(tokens), merge_rank, QWEN2_PATTERN)
    else:  # sentencepiece-style
        from ..tokenizers.bpe import SentencePieceBPE

        scores = md.get("tokenizer.ggml.scores", [0.0] * len(tokens))
        tk = SentencePieceBPE(token_to_id, list(tokens), list(scores))
    tk.bos_token_id = md.get("tokenizer.ggml.bos_token_id")
    tk.eos_token_id = md.get("tokenizer.ggml.eos_token_id")
    return tk


class GGUFWriter:
    """Minimal GGUF v3 writer (tensor names in llama.cpp convention), used by
    tests and by chip_smoke.py's container phase. An ndarray is written as
    f32; bytes are written as they are, with the shape and ggml type given."""

    def __init__(self, path, architecture: str = "llama"):
        self.path = os.fspath(path)
        self.arch = architecture
        self.kv: list[tuple[str, int, Any]] = [("general.architecture", _T_STR, architecture)]
        self.tensors: list[tuple[str, tuple[int, ...], int, bytes]] = []

    def add_kv(self, key: str, vt: int, value):
        self.kv.append((key, vt, value))

    def add_tensor(self, name: str, data: np.ndarray | bytes, shape=None, ggml_type=0):
        if isinstance(data, np.ndarray):
            shape = shape or data.shape
            data = np.ascontiguousarray(data, np.float32).tobytes()
            ggml_type = 0
        self.tensors.append((name, tuple(shape), ggml_type, data))

    def _w_str(self, f, s: str):
        b = s.encode("utf-8")
        f.write(struct.pack("<Q", len(b)))
        f.write(b)

    def _w_val(self, f, vt, v):
        if vt == _T_STR:
            self._w_str(f, v)
        elif vt == _T_ARR:
            et, items = v
            f.write(struct.pack("<IQ", et, len(items)))
            for it in items:
                self._w_val(f, et, it)
        else:
            f.write(struct.pack(_SCALAR_FMT[vt], v))

    def write(self):
        align = 32
        with open(self.path, "wb") as f:
            f.write(struct.pack("<IIQQ", GGUF_MAGIC, 3, len(self.tensors), len(self.kv)))
            for k, vt, v in self.kv:
                self._w_str(f, k)
                f.write(struct.pack("<I", vt))
                self._w_val(f, vt, v)
            offset = 0
            for name, shape, gt, data in self.tensors:
                self._w_str(f, name)
                ne = tuple(reversed(shape))
                f.write(struct.pack("<I", len(ne)))
                f.write(struct.pack(f"<{len(ne)}Q", *ne))
                f.write(struct.pack("<IQ", gt, offset))
                offset += (len(data) + align - 1) // align * align
            pos = f.tell()
            f.write(b"\x00" * ((-pos) % align))
            for _, _, _, data in self.tensors:
                f.write(data)
                f.write(b"\x00" * ((-len(data)) % align))


def load_gguf_model(path, dtype=None, quant=None, *, device=None):
    """One call: .gguf -> (model, tokenizer, cfg). The model goes to the card
    unless `device` says otherwise."""
    import torch

    from ..models.loading import load_causal_lm
    from ..utils.runtime import default_device

    f = GGUFFile(path)
    cfg = config_from_gguf(f)
    loader = GGUFLoader.__new__(GGUFLoader)
    loader.f = f
    model = load_causal_lm(loader, cfg, device=device or default_device(),
                           dtype=dtype or torch.bfloat16, quant=quant)
    return model, tokenizer_from_gguf(f), cfg
