"""Unigram LM tokenizer (Viterbi) — counterpart of
mllm/tokenizers/Unigram/ (trie + Viterbi path). Copied from
`mllm_tpu/tokenizers/unigram.py`."""

from __future__ import annotations

import math
from typing import Iterable

from .base import Tokenizer


class UnigramTokenizer(Tokenizer):
    SPACE = "▁"

    def __init__(self, token_to_id, id_to_token, scores: list[float],
                 special_tokens=None, unk_id: int = 0, byte_fallback: bool = False,
                 add_prefix_space: bool = True):
        super().__init__(token_to_id, id_to_token, special_tokens)
        self.scores = scores
        self.unk_id = unk_id
        self.byte_fallback = byte_fallback
        self.add_prefix_space = add_prefix_space
        self.max_len = max((len(t) for t in token_to_id), default=1)
        self.unk_penalty = min((s for s in scores if s != 0.0), default=-10.0) - 10.0

    def encode_ordinary(self, text: str) -> list[int]:
        if not text:
            return []
        if self.add_prefix_space and not text.startswith(" "):
            text = " " + text
        text = text.replace(" ", self.SPACE)
        n = len(text)
        # Viterbi over character positions
        best = [float("-inf")] * (n + 1)
        back: list[tuple[int, int] | None] = [None] * (n + 1)  # (prev_pos, token_id)
        best[0] = 0.0
        for i in range(n):
            if best[i] == float("-inf"):
                continue
            for j in range(i + 1, min(n, i + self.max_len) + 1):
                piece = text[i:j]
                tid = self.token_to_id.get(piece)
                if tid is not None:
                    score = best[i] + self.scores[tid]
                    if score > best[j]:
                        best[j] = score
                        back[j] = (i, tid)
            # unk transition: single char
            if back[i + 1] is None or best[i] + self.unk_penalty > best[i + 1]:
                score = best[i] + self.unk_penalty
                if score > best[i + 1]:
                    best[i + 1] = score
                    back[i + 1] = (i, -1)
        # backtrack
        out: list[int] = []
        pos = n
        while pos > 0:
            prev, tid = back[pos]
            if tid == -1:  # unk
                piece = text[prev:pos]
                if self.byte_fallback:
                    fb = []
                    for b in piece.encode("utf-8"):
                        bt = self.token_to_id.get(f"<0x{b:02X}>")
                        fb.append(bt if bt is not None else self.unk_id)
                    out.extend(reversed(fb))
                else:
                    out.append(self.unk_id)
            else:
                out.append(tid)
            pos = prev
        out.reverse()
        return out

    def decode_ordinary(self, ids: Iterable[int]) -> str:
        out = []
        byte_buf = []

        def flush():
            if byte_buf:
                out.append(bytes(byte_buf).decode("utf-8", errors="replace"))
                byte_buf.clear()

        for i in ids:
            tok = self.id_to_token[i] if 0 <= i < len(self.id_to_token) else ""
            if len(tok) == 6 and tok.startswith("<0x") and tok.endswith(">"):
                byte_buf.append(int(tok[3:5], 16))
                continue
            flush()
            out.append(tok.replace(self.SPACE, " "))
        flush()
        return "".join(out)
