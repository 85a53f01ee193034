"""The port's tokenizers and chat templates (`mllm_tpu_torch/tokenizers/`,
copies of `mllm_tpu.tokenizers`) against the JAX package's on the same
tokenizer.json kinds as tests/test_tokenizers.py: HF-trained byte-level BPE,
WordPiece and Unigram, SentencePiece BPE with byte fallback, and the
synthetic 2048-entry byte-level and SentencePiece tokenizers that
chip_smoke.py writes. Tolerance: none, ids and text are equal (hypothesis
strings included), and every family's chat template renders the same text.
SentencePieceBPE builds and encodes where `regex` cannot be imported."""

import json
import os
import subprocess
import sys

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from tokenizers import Tokenizer as HFTokenizer
from tokenizers import decoders, models, pre_tokenizers, trainers

import chip_smoke
from mllm_tpu.tokenizers import chat_templates as jax_chat
from mllm_tpu.tokenizers.hf_json import auto_tokenizer as jax_auto_tokenizer
from mllm_tpu.tokenizers.hf_json import from_tokenizer_json as jax_from_json
from mllm_tpu_torch.tokenizers import chat_templates
from mllm_tpu_torch.tokenizers.hf_json import auto_tokenizer, from_tokenizer_json

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = [
    "Hello world! This is a test of the tokenizer.",
    "The quick brown fox jumps over the lazy dog. 1234 42",
    "def main():\n    print('hi')\n",
    "多语言 support with 中文 and emoji 🙂 too",
    "Curiosity killed the cat, but satisfaction brought it back.",
]
SAMPLES = [
    "Hello world!",
    "  leading spaces and\ttabs\nnewlines",
    "numbers 123456789 and punct!!! ...",
    "unicode: 你好世界 🙂 café naïve",
    "code: x = f(y) * 2 ** 8  # comment",
    "<|endoftext|>between<|endoftext|>",
    "",
]
TEXT = st.text(st.characters(blacklist_categories=("Cs",)), max_size=40)


def _trained(kind: str, path: str) -> str:
    """An HF-trained tokenizer.json of `kind` at `path`."""
    if kind == "bytelevel":
        tok = HFTokenizer(models.BPE())
        tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
        tok.decoder = decoders.ByteLevel()
        trainer = trainers.BpeTrainer(vocab_size=400, special_tokens=["<|endoftext|>"], show_progress=False,
                                      initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    elif kind == "unigram":
        tok = HFTokenizer(models.Unigram())
        tok.pre_tokenizer = pre_tokenizers.Metaspace()
        tok.decoder = decoders.Metaspace()
        trainer = trainers.UnigramTrainer(vocab_size=200, special_tokens=["<unk>"], unk_token="<unk>",
                                          show_progress=False)
    elif kind == "wordpiece":
        tok = HFTokenizer(models.WordPiece(unk_token="[UNK]"))
        tok.pre_tokenizer = pre_tokenizers.Whitespace()
        trainer = trainers.WordPieceTrainer(vocab_size=300, special_tokens=["[UNK]", "[CLS]", "[SEP]"],
                                            show_progress=False)
    else:  # SentencePiece BPE with byte fallback (the llama kind)
        tok = HFTokenizer(models.BPE(byte_fallback=True, unk_token="<unk>"))
        tok.pre_tokenizer = pre_tokenizers.Metaspace()
        tok.decoder = decoders.Metaspace()
        trainer = trainers.BpeTrainer(vocab_size=400, show_progress=False,
                                      special_tokens=["<unk>", "<s>", "</s>"]
                                      + [f"<0x{b:02X}>" for b in range(256)])
    tok.train_from_iterator(CORPUS * 10, trainer)
    tok.save(path)
    return path


KINDS = ["bytelevel", "unigram", "wordpiece", "spm", "synthetic_bytelevel", "synthetic_spm"]


@pytest.fixture(scope="module")
def tokenizer_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tok")
    files = {k: _trained(k, str(d / f"{k}.json")) for k in KINDS[:4]}
    for kind, byte_level in (("synthetic_bytelevel", True), ("synthetic_spm", False)):
        files[kind] = str(d / f"{kind}.json")
        with open(files[kind], "w", encoding="utf-8") as f:
            json.dump(chip_smoke.synthetic_tokenizer(2048, seed=3, byte_level=byte_level), f, ensure_ascii=False)
    return files


@pytest.fixture(scope="module")
def pairs(tokenizer_files):
    return {k: (from_tokenizer_json(p), jax_from_json(p)) for k, p in tokenizer_files.items()}


@pytest.mark.parametrize("kind", KINDS)
def test_same_class_and_vocab(pairs, kind):
    port, ref = pairs[kind]
    assert type(port).__name__ == type(ref).__name__
    assert port.token_to_id == ref.token_to_id and port.id_to_token == ref.id_to_token


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("text", SAMPLES, ids=range(len(SAMPLES)))
def test_ids_and_text_equal(pairs, kind, text):
    port, ref = pairs[kind]
    ids = port.encode(text, bos=True)
    assert ids == ref.encode(text, bos=True)
    assert port.decode(ids) == ref.decode(ids)


@pytest.mark.parametrize("kind", KINDS)
def test_hypothesis_strings_equal(pairs, kind):
    port, ref = pairs[kind]

    @settings(max_examples=40, deadline=None, database=None)
    @given(TEXT)
    def check(text):
        ids = port.encode(text)
        assert ids == ref.encode(text)
        assert port.decode(ids) == ref.decode(ids)

    check()


@pytest.mark.parametrize("kind", ["bytelevel", "synthetic_bytelevel"])
def test_byte_level_round_trip(pairs, kind):
    port, _ = pairs[kind]
    for text in SAMPLES + list(chip_smoke.CONTAINER_PROMPTS):
        assert port.decode(port.encode(text)) == text


def test_auto_tokenizer_wires_bos_eos_and_template(tmp_path, tokenizer_files):
    d = tmp_path / "model"
    d.mkdir()
    (d / "tokenizer.json").write_text(open(tokenizer_files["bytelevel"], encoding="utf-8").read(),
                                      encoding="utf-8")
    (d / "tokenizer_config.json").write_text(json.dumps(
        {"eos_token": {"content": "<|endoftext|>"}, "chat_template": "{{ messages }}"}))
    (d / "config.json").write_text(json.dumps({"bos_token_id": 5, "eos_token_id": [7, 8]}))
    port, ref = auto_tokenizer(d), jax_auto_tokenizer(d)
    assert (port.bos_token_id, port.eos_token_id) == (ref.bos_token_id, ref.eos_token_id)
    assert port.eos_token_id == port.token_to_id["<|endoftext|>"]
    assert port.chat_template_jinja == ref.chat_template_jinja


MESSAGES = [{"role": "system", "content": "Be brief."}, {"role": "user", "content": "Hi"},
            {"role": "assistant", "content": "Hello"}, {"role": "user", "content": "Bye"}]


@pytest.mark.parametrize("family", sorted(set(jax_chat.TEMPLATES) | {"somethingelse"}))
@pytest.mark.parametrize("gen", [True, False])
def test_chat_templates_render_equal(family, gen):
    for msgs in (MESSAGES, MESSAGES[1:2], "Hi"):
        assert chat_templates.render(family, msgs, gen) == jax_chat.render(family, msgs, gen)


_NO_REGEX = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name == "regex" or name.startswith("regex."):
            raise ModuleNotFoundError("No module named 'regex'")
sys.meta_path.insert(0, Block())
from mllm_tpu_torch.tokenizers.bpe import ByteLevelBPE, SentencePieceBPE
from mllm_tpu_torch.tokenizers.hf_json import from_tokenizer_json
toks = ["<unk>", "<s>", "</s>", "▁", "▁the", "▁cat", "c", "a", "t", "h", "e"]
toks += [f"<0x{i:02X}>" for i in range(256)]
tk = SentencePieceBPE({t: i for i, t in enumerate(toks)}, toks, [0.0] * len(toks))
assert tk.decode(tk.encode("the cat")) == " the cat"
assert from_tokenizer_json(sys.argv[1]).encode("hello") == [int(x) for x in sys.argv[2].split(",")]
try:
    ByteLevelBPE({"a": 0}, ["a"], {})
except ModuleNotFoundError:
    print("ok")
"""


def test_sentencepiece_works_without_regex(tokenizer_files, pairs):
    """With `regex` hidden, SentencePieceBPE (and a byte-fallback
    tokenizer.json) builds and encodes as with it; only the byte-level BPE
    needs `regex`, when it is built."""
    want = ",".join(map(str, pairs["spm"][0].encode("hello")))
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", _NO_REGEX, tokenizer_files["spm"], want], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "ok"
