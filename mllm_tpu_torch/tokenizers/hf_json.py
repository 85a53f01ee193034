"""Load HuggingFace `tokenizer.json` into our pure-Python tokenizers.

The reference needs an offline converter (tools/convertor/vocab.py) to turn HF
vocabs into `.mllm` files; here we read the HF format natively and build the
matching algorithm (byte-level BPE / sentencepiece BPE / Unigram / WordPiece).
Copied from `mllm_tpu/tokenizers/hf_json.py`.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from .base import Tokenizer
from .bpe import ByteLevelBPE, SentencePieceBPE, PATTERNS, QWEN2_PATTERN
from .unigram import UnigramTokenizer
from .wordpiece import WordPieceTokenizer


def _collect_split_patterns(pre_tok: dict | None) -> Optional[str]:
    """Extract a usable split regex from the pre_tokenizer config."""
    if not pre_tok:
        return None
    t = pre_tok.get("type")
    if t == "Sequence":
        for p in pre_tok.get("pretokenizers", []):
            r = _collect_split_patterns(p)
            if r:
                return r
    if t == "Split":
        pat = pre_tok.get("pattern", {})
        if "Regex" in pat:
            return pat["Regex"]
    return None


def from_tokenizer_json(path: str | os.PathLike) -> Tokenizer:
    path = os.fspath(path)
    if os.path.isdir(path):
        path = os.path.join(path, "tokenizer.json")
    with open(path, encoding="utf-8") as f:
        spec = json.load(f)

    model = spec.get("model", {})
    mtype = model.get("type", "BPE")
    added = spec.get("added_tokens", [])
    specials = {t["content"]: t["id"] for t in added if t.get("special", False)}

    if mtype == "BPE":
        vocab: dict[str, int] = model["vocab"]
        merges_raw = model.get("merges", [])
        merge_rank = {}
        for i, m in enumerate(merges_raw):
            if isinstance(m, str):
                a, b = m.split(" ", 1)
            else:
                a, b = m
            merge_rank[(a, b)] = i
        max_id = max(list(vocab.values()) + list(specials.values()), default=-1)
        id_to_token = [""] * (max_id + 1)
        for tok, tid in vocab.items():
            id_to_token[tid] = tok
        for tok, tid in specials.items():
            id_to_token[tid] = tok
            vocab.setdefault(tok, tid)

        if model.get("byte_fallback", False):  # sentencepiece-style (llama2)
            scores = [0.0] * (max_id + 1)
            tk = SentencePieceBPE(vocab, id_to_token, scores, specials)
            # rebuild merge scores from merge ranks (earlier merge = higher score)
            tk._merge_score = {a + b: -(r) for (a, b), r in merge_rank.items()}
            return tk

        pattern = _collect_split_patterns(spec.get("pre_tokenizer"))
        add_prefix = False
        pt = spec.get("pre_tokenizer") or {}
        for p in [pt] + (pt.get("pretokenizers", []) if pt.get("type") == "Sequence" else []):
            if p.get("type") == "ByteLevel":
                add_prefix = p.get("add_prefix_space", False)
                if pattern is None and p.get("use_regex", True):
                    pattern = PATTERNS["gpt2"]  # ByteLevel's built-in split
        if pattern is None:
            pattern = QWEN2_PATTERN
        tok = ByteLevelBPE(vocab, id_to_token, merge_rank, pattern, specials,
                           add_prefix_space=add_prefix)
        return tok

    if mtype == "Unigram":
        entries = model["vocab"]  # list of [token, score]
        token_to_id = {}
        id_to_token = []
        scores = []
        for i, (tok, score) in enumerate(entries):
            token_to_id[tok] = i
            id_to_token.append(tok)
            scores.append(float(score))
        for tok, tid in specials.items():
            if tid >= len(id_to_token):
                id_to_token.extend([""] * (tid + 1 - len(id_to_token)))
                scores.extend([0.0] * (tid + 1 - len(scores)))
            id_to_token[tid] = tok
            token_to_id.setdefault(tok, tid)
        return UnigramTokenizer(
            token_to_id, id_to_token, scores, specials,
            unk_id=model.get("unk_id", 0) or 0,
            byte_fallback=model.get("byte_fallback", False),
        )

    if mtype == "WordPiece":
        vocab = model["vocab"]
        max_id = max(vocab.values())
        id_to_token = [""] * (max_id + 1)
        for tok, tid in vocab.items():
            id_to_token[tid] = tok
        norm = spec.get("normalizer") or {}
        lowercase = bool(norm.get("lowercase", True))
        return WordPieceTokenizer(vocab, id_to_token, specials,
                                  unk_token=model.get("unk_token", "[UNK]"),
                                  lowercase=lowercase)

    raise NotImplementedError(f"tokenizer.json model type {mtype}")


def auto_tokenizer(model_dir: str | os.PathLike) -> Tokenizer:
    """Build a tokenizer from a HF model directory; wires bos/eos and the
    chat template from tokenizer_config.json / config.json when present."""
    model_dir = os.fspath(model_dir)
    tok = from_tokenizer_json(model_dir)
    cfg_path = os.path.join(model_dir, "tokenizer_config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path, encoding="utf-8") as f:
            tc = json.load(f)
        for name, attr in (("bos_token", "bos_token_id"), ("eos_token", "eos_token_id")):
            t = tc.get(name)
            if isinstance(t, dict):
                t = t.get("content")
            if t and t in tok.token_to_id:
                setattr(tok, attr, tok.token_to_id[t])
        if tc.get("chat_template"):
            tok.chat_template_jinja = tc["chat_template"]
    mcfg = os.path.join(model_dir, "config.json")
    if os.path.exists(mcfg) and tok.eos_token_id is None:
        with open(mcfg) as f:
            c = json.load(f)
        e = c.get("eos_token_id")
        tok.eos_token_id = e[0] if isinstance(e, list) else e
        tok.bos_token_id = tok.bos_token_id or c.get("bos_token_id")
    return tok
