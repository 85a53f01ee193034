"""Tokenizer base: vocab handling, special tokens, chat templates.

Copied from `mllm_tpu/tokenizers/base.py` (pure Python and numpy).
Counterpart of mllm/tokenizers/Tokenizer.hpp
(:34-190): loads the same `.mllm` vocab container (magic 23333) and exposes
the same surface (tokenize -> ids, detokenize, apply_chat_template), plus
direct HF `tokenizer.json` loading the reference needs an offline converter
for (tools/convertor/vocab.py).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Iterable, Optional

import numpy as np


@dataclass
class SpecialToken:
    content: str
    id: int


class Tokenizer:
    """Base class: vocab maps + special-token splitting + chat template."""

    def __init__(self, token_to_id: dict[str, int], id_to_token: list[str],
                 special_tokens: Optional[dict[str, int]] = None):
        self.token_to_id = token_to_id
        self.id_to_token = id_to_token
        self.special_tokens: dict[str, int] = dict(special_tokens or {})
        self._special_re = None
        self.bos_token_id: Optional[int] = None
        self.eos_token_id: Optional[int] = None
        self.chat_template: Optional[str] = None

    # -- abstract core ------------------------------------------------------
    def encode_ordinary(self, text: str) -> list[int]:
        """Encode text that contains no special tokens."""
        raise NotImplementedError

    def decode_ordinary(self, ids: Iterable[int]) -> str:
        return "".join(self.id_to_token[i] for i in ids if 0 <= i < len(self.id_to_token))

    # -- public surface -----------------------------------------------------
    def add_special_tokens(self, tokens):
        """Register special tokens for split-out-and-emit handling.

        `tokens` is an iterable of strings already present in the vocab, or a
        {token: id} mapping to register NEW ids beyond the vocab file — the
        reference hardcodes extended specials the same way (e.g. Qwen2-VL's
        <|image_pad|> = 151655, models/qwen2_vl/tokenization_qwen2_vl.hpp)."""
        items = tokens.items() if isinstance(tokens, dict) else ((t, None) for t in tokens)
        for t, tid in items:
            if tid is None:
                tid = self.token_to_id.get(t)
                if tid is None:
                    continue
            self.token_to_id[t] = tid
            if tid >= len(self.id_to_token):
                self.id_to_token.extend([""] * (tid + 1 - len(self.id_to_token)))
            self.id_to_token[tid] = t
            self.special_tokens[t] = tid
        self._special_re = None

    def _split_specials(self, text: str):
        if not self.special_tokens:
            yield (text, None)
            return
        if self._special_re is None:
            pat = "|".join(re.escape(t) for t in sorted(self.special_tokens, key=len, reverse=True))
            self._special_re = re.compile(f"({pat})")
        for part in self._special_re.split(text):
            if not part:
                continue
            if part in self.special_tokens:
                yield (part, self.special_tokens[part])
            else:
                yield (part, None)

    def encode(self, text: str, bos: bool = False) -> list[int]:
        ids: list[int] = []
        if bos and self.bos_token_id is not None:
            ids.append(self.bos_token_id)
        for part, sid in self._split_specials(text):
            if sid is not None:
                ids.append(sid)
            else:
                ids.extend(self.encode_ordinary(part))
        return ids

    # reference naming parity
    def tokenize(self, text: str, bos: bool = False) -> list[int]:
        return self.encode(text, bos=bos)

    def decode(self, ids: Iterable[int]) -> str:
        return self.decode_ordinary(ids)

    def detokenize(self, token_id: int) -> str:
        """Single-token streaming decode (reference detokenize)."""
        return self.decode([token_id])

    def tokens2input(self, ids: list[int]) -> np.ndarray:
        """Reference tokens2Input: ids -> [1, S] int32 model input."""
        return np.asarray(ids, np.int32)[None, :]

    def apply_chat_template(self, text_or_messages, add_generation_prompt: bool = True) -> str:
        """Minimal chat templating.  Subclasses set `chat_template` as a
        format string with {content} (single-turn, the reference's pattern,
        Tokenizer.hpp:182-190) or override for multi-turn."""
        if isinstance(text_or_messages, str):
            if self.chat_template:
                return self.chat_template.format(content=text_or_messages)
            return text_or_messages
        out = []
        for m in text_or_messages:
            out.append(self.format_message(m["role"], m["content"]))
        if add_generation_prompt:
            out.append(self.generation_prompt())
        return "".join(out)

    def format_message(self, role: str, content: str) -> str:
        return f"<|im_start|>{role}\n{content}<|im_end|>\n"

    def generation_prompt(self) -> str:
        return "<|im_start|>assistant\n"

    @property
    def vocab_size(self) -> int:
        return len(self.id_to_token)


# ---------------------------------------------------------------------------
# GPT-2 byte<->unicode table (shared by BPE and HF-json loaders)
# ---------------------------------------------------------------------------


def bytes_to_unicode() -> dict[int, str]:
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


BYTE_TO_UNICODE = bytes_to_unicode()
UNICODE_TO_BYTE = {v: k for k, v in BYTE_TO_UNICODE.items()}


def text_to_byte_units(text: str) -> str:
    """utf-8 bytes of `text` mapped through the GPT-2 byte->unicode table."""
    return "".join(BYTE_TO_UNICODE[b] for b in text.encode("utf-8"))


def byte_units_to_text(units: str) -> str:
    """Inverse mapping; invalid partial utf-8 is replaced."""
    data = bytes(UNICODE_TO_BYTE[c] for c in units if c in UNICODE_TO_BYTE)
    return data.decode("utf-8", errors="replace")
