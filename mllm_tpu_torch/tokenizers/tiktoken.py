"""Tiktoken-style rank BPE operating directly on bytes.

Counterpart of mllm/tokenizers/Tiktoken/ (tiktoken.cpp
byte_pair_encode): mergeable ranks over raw byte strings + regex split +
base64 `.tiktoken` rank files. Copied from `mllm_tpu/tokenizers/tiktoken.py`;
`regex` is imported when a tokenizer is built.
"""

from __future__ import annotations

import base64
from typing import Iterable, Optional

from .base import Tokenizer
from .bpe import QWEN2_PATTERN


def byte_pair_encode(piece: bytes, ranks: dict[bytes, int]) -> list[int]:
    """tiktoken's merge: repeatedly merge the lowest-rank adjacent pair."""
    if len(piece) == 1:
        return [ranks[piece]]
    parts = [piece[i : i + 1] for i in range(len(piece))]
    while True:
        best_rank = None
        best_i = None
        for i in range(len(parts) - 1):
            r = ranks.get(parts[i] + parts[i + 1])
            if r is not None and (best_rank is None or r < best_rank):
                best_rank = r
                best_i = i
        if best_i is None:
            break
        parts[best_i : best_i + 2] = [parts[best_i] + parts[best_i + 1]]
    return [ranks[p] for p in parts if p in ranks]


def load_tiktoken_ranks(path: str) -> dict[bytes, int]:
    """`.tiktoken` file: lines of `base64(token) rank`."""
    ranks: dict[bytes, int] = {}
    with open(path, "rb") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            tok_b64, rank = line.split()
            ranks[base64.b64decode(tok_b64)] = int(rank)
    return ranks


class TiktokenTokenizer(Tokenizer):
    def __init__(self, ranks: dict[bytes, int], special_tokens: dict[str, int],
                 pattern: str = QWEN2_PATTERN):
        max_id = max(list(ranks.values()) + list(special_tokens.values()), default=-1)
        id_to_token = [""] * (max_id + 1)
        token_to_id = {}
        for tok, tid in ranks.items():
            s = tok.decode("utf-8", errors="replace")
            id_to_token[tid] = s
            token_to_id[s] = tid
        for tok, tid in special_tokens.items():
            id_to_token[tid] = tok
            token_to_id[tok] = tid
        super().__init__(token_to_id, id_to_token, special_tokens)
        self.ranks = ranks
        self.id_to_bytes: dict[int, bytes] = {tid: tok for tok, tid in ranks.items()}
        for tok, tid in special_tokens.items():
            self.id_to_bytes[tid] = tok.encode("utf-8")
        import regex

        self.pattern = regex.compile(pattern)

    def encode_ordinary(self, text: str) -> list[int]:
        ids: list[int] = []
        for m in self.pattern.finditer(text):
            piece = m.group().encode("utf-8")
            if piece in self.ranks:
                ids.append(self.ranks[piece])
            else:
                ids.extend(byte_pair_encode(piece, self.ranks))
        return ids

    def decode_ordinary(self, ids: Iterable[int]) -> str:
        data = b"".join(self.id_to_bytes.get(i, b"") for i in ids)
        return data.decode("utf-8", errors="replace")
