"""Byte-level and sentencepiece-style BPE.

Counterpart of mllm/tokenizers/BPE/ (Bpe.cpp): merge-rank BPE
with GPT-2 bytes-to-unicode and byte-fallback, plus regex pre-tokenization
(the reference's Tiktoken pattern path).  Pure Python: a copy of
`mllm_tpu/tokenizers/bpe.py` without its optional native merge core, which
buys nothing for served prompts: on the host of an H100 machine the Python
merges encode the 17-300-token prompts of the smoke's server phase in 0.72
ms together (word cache empty), the native core in 2.78 ms after a one-off
278 ms table build (tools/tokenize_time.py; PERF.md, PR 11). The
`regex` module (for \\p unicode classes) is imported by the classes whose
patterns need it, so `SentencePieceBPE` works where `regex` is absent.
"""

from __future__ import annotations

import functools
from typing import Iterable, Optional

from .base import (
    BYTE_TO_UNICODE,
    Tokenizer,
    byte_units_to_text,
    text_to_byte_units,
)

# Common pre-tokenization patterns (model cards / HF tokenizer.json)
GPT2_PATTERN = r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
QWEN2_PATTERN = r"""(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"""
LLAMA3_PATTERN = r"""(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"""

PATTERNS = {
    "gpt2": GPT2_PATTERN,
    "qwen2": QWEN2_PATTERN,
    "llama3": LLAMA3_PATTERN,
}


def bpe_merge(word: tuple[str, ...], merge_rank: dict[tuple[str, str], int]) -> tuple[str, ...]:
    """Standard rank-based BPE merge loop over a symbol tuple."""
    if len(word) < 2:
        return word
    word = list(word)
    while True:
        best_pair = None
        best_rank = None
        for i in range(len(word) - 1):
            r = merge_rank.get((word[i], word[i + 1]))
            if r is not None and (best_rank is None or r < best_rank):
                best_rank = r
                best_pair = (word[i], word[i + 1])
        if best_pair is None:
            return tuple(word)
        a, b = best_pair
        # merge ALL occurrences of this pair (classic GPT-2 bpe())
        out = []
        i = 0
        while i < len(word):
            if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                out.append(a + b)
                i += 2
            else:
                out.append(word[i])
                i += 1
        word = out
        if len(word) == 1:
            return tuple(word)


class ByteLevelBPE(Tokenizer):
    """GPT-2-family byte-level BPE (qwen/gpt2/llama3 and most modern LLMs)."""

    def __init__(self, token_to_id, id_to_token, merge_rank: dict[tuple[str, str], int],
                 pattern: str = QWEN2_PATTERN, special_tokens=None,
                 add_prefix_space: bool = False):
        super().__init__(token_to_id, id_to_token, special_tokens)
        self.merge_rank = merge_rank
        import regex

        self.pattern = regex.compile(pattern)
        self.add_prefix_space = add_prefix_space
        self._cache: dict[str, tuple[str, ...]] = {}

    def _bpe(self, unit_word: str) -> tuple[str, ...]:
        hit = self._cache.get(unit_word)
        if hit is not None:
            return hit
        toks = bpe_merge(tuple(unit_word), self.merge_rank)
        if len(self._cache) < 65536:
            self._cache[unit_word] = toks
        return toks

    def encode_ordinary(self, text: str) -> list[int]:
        if self.add_prefix_space and text and not text[0].isspace():
            text = " " + text
        ids: list[int] = []
        for m in self.pattern.finditer(text):
            units = text_to_byte_units(m.group())
            for tok in self._bpe(units):
                tid = self.token_to_id.get(tok)
                if tid is None:  # split to single byte-units as fallback
                    for ch in tok:
                        tid2 = self.token_to_id.get(ch)
                        if tid2 is not None:
                            ids.append(tid2)
                else:
                    ids.append(tid)
        return ids

    def decode_ordinary(self, ids: Iterable[int]) -> str:
        units = []
        for i in ids:
            if 0 <= i < len(self.id_to_token):
                tok = self.id_to_token[i]
                if tok in self.special_tokens_set:
                    units.append(("special", tok))
                else:
                    units.append(("units", tok))
        out = []
        buf = ""
        for kind, tok in units:
            if kind == "special":
                if buf:
                    out.append(byte_units_to_text(buf))
                    buf = ""
                out.append(tok)
            else:
                buf += tok
        if buf:
            out.append(byte_units_to_text(buf))
        return "".join(out)

    @property
    def special_tokens_set(self):
        return self.special_tokens


class SentencePieceBPE(Tokenizer):
    """SentencePiece-style BPE (llama1/2, mistral): '▁' word marker,
    byte-fallback <0xXX> tokens, merges implied by vocab scores.

    Counterpart of the reference BPE byte_fallback path (Bpe.cpp).
    """

    SPACE = "▁"

    def __init__(self, token_to_id, id_to_token, scores: list[float],
                 special_tokens=None, add_bos: bool = True, add_prefix_space: bool = True,
                 space_marker: str | None = None):
        super().__init__(token_to_id, id_to_token, special_tokens)
        self.scores = scores
        self.add_prefix_space = add_prefix_space
        # The reference's vocab writer (tools/convertor/vocab.py) stores the
        # sentencepiece "▁" marker as a literal space in .mllm vocab files
        # (the C++ BPE works on raw spaces) — auto-detect which convention
        # this vocab uses unless told explicitly.
        if space_marker is None:
            space_marker = "▁" if ("▁" in token_to_id or "▁the" in token_to_id) else " "
        self.SPACE = space_marker
        # byte-fallback block: either <0xXX> tokens or a contiguous raw-byte
        # block (reference .mllm convention: ids base..base+255 hold bytes)
        self._byte_id0 = None
        nul = token_to_id.get("\x00")
        if nul is not None and nul + 255 < len(id_to_token) and id_to_token[nul + 255] == "\xff":
            self._byte_id0 = nul
        # build merge ranks from vocab: pair (a,b) mergeable if a+b in vocab;
        # rank by score of merged token (higher score = earlier merge)
        self._merge_score = {}
        for tok, tid in token_to_id.items():
            if len(tok) > 1:
                self._merge_score[tok] = scores[tid] if tid < len(scores) else 0.0

    def encode_ordinary(self, text: str) -> list[int]:
        if not text:
            return []
        if self.add_prefix_space and not text.startswith(" "):
            text = " " + text
        text = text.replace(" ", self.SPACE)
        # greedy best-pair merge by score (sentencepiece BPE semantics)
        symbols = list(text)
        while True:
            best_i, best_s = None, None
            for i in range(len(symbols) - 1):
                merged = symbols[i] + symbols[i + 1]
                s = self._merge_score.get(merged)
                if s is not None and (best_s is None or s > best_s):
                    best_s, best_i = s, i
            if best_i is None:
                break
            symbols[best_i : best_i + 2] = [symbols[best_i] + symbols[best_i + 1]]
        ids = []
        for sym in symbols:
            tid = self.token_to_id.get(sym)
            if tid is not None:
                ids.append(tid)
            else:  # byte fallback
                for b in sym.encode("utf-8"):
                    bt = self.token_to_id.get(f"<0x{b:02X}>")
                    if bt is None and self._byte_id0 is not None:
                        bt = self._byte_id0 + b
                    if bt is not None:
                        ids.append(bt)
        return ids

    def decode_ordinary(self, ids: Iterable[int]) -> str:
        out = []
        byte_buf = []

        def flush_bytes():
            if byte_buf:
                out.append(bytes(byte_buf).decode("utf-8", errors="replace"))
                byte_buf.clear()

        for i in ids:
            if self._byte_id0 is not None and self._byte_id0 <= i < self._byte_id0 + 256:
                byte_buf.append(i - self._byte_id0)
                continue
            tok = self.id_to_token[i] if 0 <= i < len(self.id_to_token) else ""
            if len(tok) == 6 and tok.startswith("<0x") and tok.endswith(">"):
                byte_buf.append(int(tok[3:5], 16))
                continue
            flush_bytes()
            out.append(tok.replace(self.SPACE, " "))
        flush_bytes()
        return "".join(out)


CLIP_PATTERN = (
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"
)


class ClipBPE(Tokenizer):
    """CLIP word-suffix BPE: lowercasing, whitespace cleanup, and a `</w>`
    end-of-word marker on the final symbol of every word.

    Counterpart of the reference CLIP tokenizer
    (mllm/models/clip/tokenization_clip.hpp) reading the same
    clip_vocab.mllm (magic 23333) + clip_merges.txt assets; byte-level
    alphabet via the GPT-2 bytes-to-unicode map.
    """

    END = "</w>"

    def __init__(self, token_to_id, id_to_token, merge_rank: dict[tuple[str, str], int],
                 special_tokens=None):
        super().__init__(token_to_id, id_to_token, special_tokens)
        self.merge_rank = merge_rank
        import regex

        self.pattern = regex.compile(CLIP_PATTERN, regex.IGNORECASE)
        self._cache: dict[str, tuple[str, ...]] = {}

    def _bpe(self, units: str) -> tuple[str, ...]:
        hit = self._cache.get(units)
        if hit is None:
            word = tuple(units[:-1]) + (units[-1] + self.END,)
            hit = bpe_merge(word, self.merge_rank)
            if len(self._cache) < 65536:
                self._cache[units] = hit
        return hit

    def encode_ordinary(self, text: str) -> list[int]:
        # HF CLIPTokenizer's non-ftfy path: BasicTokenizer cleanup (lowercase,
        # CJK char isolation, NO accent strip, NO punct split), then the CLIP
        # regex over the space-joined words.
        from .wordpiece import basic_tokenize

        text = " ".join(basic_tokenize(text, lowercase=True, strip_accents=False,
                                       split_on_punc=False))
        ids: list[int] = []
        for m in self.pattern.finditer(text):
            units = text_to_byte_units(m.group())
            if not units:
                continue
            for tok in self._bpe(units):
                tid = self.token_to_id.get(tok)
                if tid is not None:
                    ids.append(tid)
        return ids

    def decode_ordinary(self, ids: Iterable[int]) -> str:
        toks = [self.id_to_token[i] for i in ids if 0 <= i < len(self.id_to_token)]
        return byte_units_to_text("".join(toks)).replace(self.END, " ").strip()
