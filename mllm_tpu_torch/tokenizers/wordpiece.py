"""WordPiece tokenizer (BERT family) — counterpart of
mllm/tokenizers/WordPiece/. Copied from
`mllm_tpu/tokenizers/wordpiece.py`."""

from __future__ import annotations

import unicodedata
from typing import Iterable

from .base import Tokenizer


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


def basic_tokenize(text: str, lowercase: bool = True, strip_accents=None,
                   split_on_punc: bool = True) -> list[str]:
    """BERT BasicTokenizer: clean, CJK-split, lowercase (+accent strip unless
    strip_accents=False), optional punct-split.  CLIP's text cleanup is this
    with strip_accents=False, split_on_punc=False."""
    out = []
    text = "".join(
        " " if ch in ("\t", "\n", "\r") or unicodedata.category(ch) == "Zs" else ch
        for ch in text
        if ord(ch) != 0 and ord(ch) != 0xFFFD
        and not (unicodedata.category(ch) in ("Cc", "Cf") and ch not in ("\t", "\n", "\r"))
    )
    # CJK chars get surrounding spaces
    spaced = []
    for ch in text:
        if _is_cjk(ord(ch)):
            spaced.extend([" ", ch, " "])
        else:
            spaced.append(ch)
    for word in "".join(spaced).split():
        if lowercase:
            word = word.lower()
        if strip_accents is True or (strip_accents is None and lowercase):
            word = "".join(c for c in unicodedata.normalize("NFD", word)
                           if unicodedata.category(c) != "Mn")
        if not split_on_punc:
            out.append(word)
            continue
        # split punctuation
        cur = ""
        for ch in word:
            if _is_punct(ch):
                if cur:
                    out.append(cur)
                    cur = ""
                out.append(ch)
            else:
                cur += ch
        if cur:
            out.append(cur)
    return out


class WordPieceTokenizer(Tokenizer):
    def __init__(self, token_to_id, id_to_token, special_tokens=None,
                 unk_token: str = "[UNK]", lowercase: bool = True,
                 max_chars_per_word: int = 100):
        super().__init__(token_to_id, id_to_token, special_tokens)
        self.unk_token = unk_token
        self.lowercase = lowercase
        self.max_chars = max_chars_per_word

    def encode_ordinary(self, text: str) -> list[int]:
        ids = []
        unk = self.token_to_id.get(self.unk_token, 0)
        for word in basic_tokenize(text, self.lowercase):
            if len(word) > self.max_chars:
                ids.append(unk)
                continue
            start = 0
            word_ids = []
            bad = False
            while start < len(word):
                end = len(word)
                cur = None
                while start < end:
                    sub = word[start:end]
                    if start > 0:
                        sub = "##" + sub
                    if sub in self.token_to_id:
                        cur = self.token_to_id[sub]
                        break
                    end -= 1
                if cur is None:
                    bad = True
                    break
                word_ids.append(cur)
                start = end
            ids.extend([unk] if bad else word_ids)
        return ids

    def decode_ordinary(self, ids: Iterable[int]) -> str:
        toks = [self.id_to_token[i] for i in ids if 0 <= i < len(self.id_to_token)]
        out = []
        for t in toks:
            if t.startswith("##"):
                out.append(t[2:])
            else:
                if out:
                    out.append(" ")
                out.append(t)
        return "".join(out)
