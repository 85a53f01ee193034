"""Tiny HF checkpoints for quick runs of the demos and the server:
counterpart of `tools/make_tiny_fixtures.py` of the JAX repo.

  python -m mllm_tpu_torch.tools.make_tiny_fixtures [both|text|vl] [--out DIR]

writes `DIR/tiny_qwen2` (a 2-layer Qwen2, hidden 32, 128-entry vocabulary)
and / or `DIR/tiny_qwen2vl` (a 2-layer Qwen2-VL with a 2-block tower, 160
entries, the vision tokens at 149-152); DIR defaults to the system's
temporary directory, the JAX tool's place. Each holds `save_pretrained`
safetensors (seed 0: the same tensors every run) and a byte-level BPE
tokenizer.json trained on a few sentences (its tokens vary from run to run:
the trainer starts from 64 characters of an unordered list).

A CPU tool: it builds the models with `transformers` and trains the
tokenizer with `tokenizers`, neither of which the port needs otherwise (the
card's machine has neither). It imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import tempfile

CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "a b c a b c a b c d e f g h i j k l m n o p",
    "hello world this is a tiny fixture for serving tests",
    "0 1 2 3 4 5 6 7 8 9 numbers and words mix here",
]
VL_SPECIALS = ["<|vision_start|>", "<|vision_end|>", "<|image_pad|>", "<|video_pad|>"]


def make_tokenizer(path: str, extra_special: list[str]) -> None:
    """Train a tiny byte-level BPE and write HF tokenizer.json."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=128 - len(extra_special) - 1,
        special_tokens=["<|endoftext|>"] + extra_special,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()[:64],
    )
    tok.train_from_iterator(CORPUS * 8, trainer)
    tok.save(os.path.join(path, "tokenizer.json"))


def make_text(path: str) -> str:
    """A tiny Qwen2 checkpoint directory at `path`."""
    import torch
    import transformers

    os.makedirs(path, exist_ok=True)
    torch.manual_seed(0)
    cfg = transformers.Qwen2Config(
        vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512,
        rope_theta=10000.0, tie_word_embeddings=False,
        bos_token_id=0, eos_token_id=0,
    )
    transformers.Qwen2ForCausalLM(cfg).eval().save_pretrained(path, safe_serialization=True)
    make_tokenizer(path, [])
    print(f"wrote {path}")
    return path


def make_vl(path: str) -> str:
    """A tiny Qwen2-VL checkpoint directory at `path`."""
    import torch
    import transformers

    os.makedirs(path, exist_ok=True)
    torch.manual_seed(0)
    vis = dict(
        depth=2, embed_dim=32, hidden_size=32, num_heads=4, in_chans=3,
        patch_size=14, spatial_merge_size=2, temporal_patch_size=2, mlp_ratio=2,
    )
    cfg = transformers.Qwen2VLConfig(
        vocab_size=160, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512,
        rope_theta=10000.0, tie_word_embeddings=False, vision_config=vis,
        rope_scaling={"type": "mrope", "mrope_section": [2, 1, 1]},
        image_token_id=151, vision_start_token_id=149, vision_end_token_id=150,
        bos_token_id=0, eos_token_id=0,
    )
    transformers.Qwen2VLForConditionalGeneration(cfg).eval().save_pretrained(path, safe_serialization=True)
    make_tokenizer(path, VL_SPECIALS)
    print(f"wrote {path}")
    return path


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", nargs="?", default="both", choices=["both", "text", "vl"])
    ap.add_argument("--out", default=tempfile.gettempdir(), help="parent directory of the fixtures")
    args = ap.parse_args(argv)
    out = []
    if args.what in ("both", "text"):
        out.append(make_text(os.path.join(args.out, "tiny_qwen2")))
    if args.what in ("both", "vl"):
        out.append(make_vl(os.path.join(args.out, "tiny_qwen2vl")))
    return out


if __name__ == "__main__":
    main()
