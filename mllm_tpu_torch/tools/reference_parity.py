"""Token-for-token parity against the reference C++ engine: counterpart of
`tools/reference_parity.py` of the JAX repo.

The goldens `tests/goldens/reference_qwen05b.json` and
`reference_tinyllama.json` hold the unmodified C++ engine's greedy ids (CPU,
f32) on deterministic random-weight checkpoints at the reference's QWen
"0.5B" preset (hidden 1024, ffn 2816, 24 layers, 16 / 16 heads, vocab
151936, tied embeddings, qkv biases) and TinyLlama-1.1B preset (hidden 2048,
ffn 5632, 22 layers, 32 / 4 heads, vocab 32000, untied head) geometries:

  python -m mllm_tpu_torch.tools.reference_parity --gen DIR [--family qwen05b|tinyllama]
  python -m mllm_tpu_torch.tools.reference_parity --run DIR [--family ...] \\
      [--vocab V.mllm] [--merges M.txt] [--new-tokens 32] [--device cuda|cpu]

`--gen` writes the checkpoint (f32 safetensors with HF names, written by
`core.param_loader.write_safetensors`: no `safetensors` package needed)
from `numpy.random.default_rng(SEED)` (SEED + 1 for TinyLlama), the same
draws in the same order as the JAX tool, so the tensors are bit-identical.
`--run` tokenizes the prompt through the port's BPE over the reference's
vocab files (`chat_ids` / `tinyllama_chat_ids`) and decodes greedily in
f32 (`greedy_ids`), printing the ids as JSON. `greedy_ids` also takes a
golden's recorded `input_ids` directly, so the model half needs no vocab
file. The vocab files default to $MLLM_REF_VOCAB / $MLLM_REF_MERGES, else to
`reference/vocab/` under the working directory (the JAX tool's default is
the reference checkout's `vocab/` directory).

f32 on the card runs attention on the plain `sdpa` (the CUDA kernels are
bf16-only) and cuBLAS without TF32: `greedy_ids` asserts that TF32 is off.
Runs on the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

# reference QWenConfig "0.5B" (configuration_qwen.hpp:86-104)
GEOM = dict(vocab_size=151936, hidden_size=1024, intermediate_size=2816,
            num_hidden_layers=24, num_attention_heads=16,
            num_key_value_heads=16, rope_theta=1000000.0,
            max_position_embeddings=32768, rms_norm_eps=1e-6,
            tie_word_embeddings=True)
SEED = 20012  # the .mllm magic number
PROMPT = "Give me a short introduction to large language model."
NEW_TOKENS = 32

# reference TinyLLaMAConfig "1.1B" (configuration_tinyllama.hpp)
TINYLLAMA_GEOM = dict(vocab_size=32000, hidden_size=2048,
                      intermediate_size=5632, num_hidden_layers=22,
                      num_attention_heads=32, num_key_value_heads=4,
                      rope_theta=10000.0, max_position_embeddings=16384,
                      rms_norm_eps=1e-6, tie_word_embeddings=False)
# demo_tinyllama.cpp's chat template (set_chat_template args)
TINYLLAMA_SYS_START = (" You are a Q&A assistant. Your goal is to answer "
                       "questions as accurately as possible based on the "
                       "instructions and context provided.<|USER|>")
TINYLLAMA_SYS_END = "<|ASSISTANT|>"

VOCAB_DIR = os.path.join("reference", "vocab")


def _writer(path: str, tensors: dict, cfg: dict) -> None:
    from ..core.param_loader import write_safetensors

    os.makedirs(path, exist_ok=True)
    write_safetensors(os.path.join(path, "model.safetensors"), tensors)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f, indent=1)
    print(f"wrote {path}: {len(tensors)} tensors")


def qwen_tensors() -> dict:
    """HF name -> f32 array of the Qwen "0.5B"-geometry checkpoint (GEOM),
    drawn as the JAX tool draws them."""
    g = GEOM
    d, ff, L = g["hidden_size"], g["intermediate_size"], g["num_hidden_layers"]
    rng = np.random.default_rng(SEED)

    def w(*shape, std=0.02):  # float32 * std, in place: the JAX tool's bits without a second array
        a = rng.standard_normal(shape, dtype=np.float32)
        a *= np.float32(std)
        return a

    t = {"model.embed_tokens.weight": w(g["vocab_size"], d),
         "model.norm.weight": np.ones(d, np.float32)}
    for i in range(L):
        p = f"model.layers.{i}."
        t[p + "input_layernorm.weight"] = np.ones(d, np.float32)
        t[p + "post_attention_layernorm.weight"] = np.ones(d, np.float32)
        for nm in ("q_proj", "k_proj", "v_proj"):
            t[p + f"self_attn.{nm}.weight"] = w(d, d)
            t[p + f"self_attn.{nm}.bias"] = w(d, std=0.01)
        t[p + "self_attn.o_proj.weight"] = w(d, d)
        t[p + "mlp.gate_proj.weight"] = w(ff, d)
        t[p + "mlp.up_proj.weight"] = w(ff, d)
        t[p + "mlp.down_proj.weight"] = w(d, ff)
    return t


def gen_checkpoint(path: str) -> None:
    """The deterministic random-weight Qwen2-0.5B-geometry checkpoint (f32
    safetensors, HF names, ~1.9 GB) and its config.json."""
    cfg = dict(GEOM, model_type="qwen2", hidden_act="silu",
               bos_token_id=151643, eos_token_id=151645,
               attention_dropout=0.0, initializer_range=0.02,
               architectures=["Qwen2ForCausalLM"], torch_dtype="float32")
    _writer(path, qwen_tensors(), cfg)


def tinyllama_tensors() -> dict:
    """HF name -> f32 array of the TinyLlama-1.1B-geometry checkpoint
    (TINYLLAMA_GEOM), drawn as the JAX tool draws them."""
    g = TINYLLAMA_GEOM
    d, ff, L, v = g["hidden_size"], g["intermediate_size"], g["num_hidden_layers"], g["vocab_size"]
    kvd = g["num_key_value_heads"] * (d // g["num_attention_heads"])
    rng = np.random.default_rng(SEED + 1)

    def w(*shape, std=0.02):  # float32 * std, in place: the JAX tool's bits without a second array
        a = rng.standard_normal(shape, dtype=np.float32)
        a *= np.float32(std)
        return a

    t = {"model.embed_tokens.weight": w(v, d),
         "model.norm.weight": np.ones(d, np.float32),
         "lm_head.weight": w(v, d)}
    for i in range(L):
        p = f"model.layers.{i}."
        t[p + "input_layernorm.weight"] = np.ones(d, np.float32)
        t[p + "post_attention_layernorm.weight"] = np.ones(d, np.float32)
        t[p + "self_attn.q_proj.weight"] = w(d, d)
        t[p + "self_attn.k_proj.weight"] = w(kvd, d)
        t[p + "self_attn.v_proj.weight"] = w(kvd, d)
        t[p + "self_attn.o_proj.weight"] = w(d, d)
        t[p + "mlp.gate_proj.weight"] = w(ff, d)
        t[p + "mlp.up_proj.weight"] = w(ff, d)
        t[p + "mlp.down_proj.weight"] = w(d, ff)
    return t


def gen_checkpoint_tinyllama(path: str) -> None:
    """The deterministic random-weight TinyLlama-1.1B-geometry checkpoint
    (~4.4 GB) and its config.json."""
    cfg = dict(TINYLLAMA_GEOM, model_type="llama", hidden_act="silu",
               bos_token_id=1, eos_token_id=2, attention_bias=False,
               architectures=["LlamaForCausalLM"], torch_dtype="float32")
    _writer(path, tinyllama_tensors(), cfg)


def chat_ids(vocab_mllm: str, merges_txt: str) -> list[int]:
    """The prompt in the reference's own chat template
    (tokenization_qwen.hpp:71-72) through the port's byte-level BPE."""
    from ..core.param_loader import load_merges, load_vocab
    from ..tokenizers.bpe import QWEN2_PATTERN, ByteLevelBPE

    t2i, i2t, _scores = load_vocab(vocab_mllm)
    tok = ByteLevelBPE(t2i, i2t, load_merges(merges_txt), pattern=QWEN2_PATTERN)
    # QWenTokenizer's specials (tokenization_qwen.hpp:365-369)
    tok.add_special_tokens(["<|endoftext|>", "<|im_start|>", "<|im_end|>"])
    text = ("<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
            "<|im_start|>user\n" + PROMPT + "<|im_end|>\n<|im_start|>assistant\n")
    return tok.encode(text)


def tinyllama_chat_ids(vocab_mllm: str) -> list[int]:
    """The prompt as the reference's TinyLlama parity program tokenizes it: bos + the
    SentencePiece-score BPE with byte fallback over the chat-templated text."""
    from ..core.param_loader import load_vocab
    from ..tokenizers.bpe import SentencePieceBPE

    t2i, i2t, scores = load_vocab(vocab_mllm)
    tok = SentencePieceBPE(t2i, i2t, scores, add_bos=True, add_prefix_space=False)
    tok.bos_token_id = 1  # BPETokenizer::TokenBos
    return tok.encode(TINYLLAMA_SYS_START + PROMPT + TINYLLAMA_SYS_END, bos=True)


def check_tf32_off() -> None:
    """The goldens are f32 arithmetic: raise if cuBLAS may use TF32."""
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("reference parity needs f32 matmuls: TF32 is on "
                             f"(allow_tf32 {torch.backends.cuda.matmul.allow_tf32}, "
                             f"precision {torch.get_float32_matmul_precision()!r})")


@torch.no_grad()
def greedy_ids(path: str, input_ids: list[int], new_tokens: int = NEW_TOKENS, device=None,
               stats: dict | None = None) -> list[int]:
    """Greedy decode of the checkpoint at `path` in f32 from `input_ids`:
    `auto_model(..., with_tokenizer=False)`, a cache of len(ids) + new + 8,
    the prefill and each step with `last_only=True`, argmax. On the card
    unless `device` is the CPU. `stats`, when given, receives load_s,
    decode_s and each step's gap between its two largest logits."""
    from ..models.registry import auto_model

    check_tf32_off()
    t0 = time.perf_counter()
    model, _, _ = auto_model(path, dtype=torch.float32, with_tokenizer=False, device=device)
    dev = model.embed_tokens.weight.device
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cache = model.init_cache(1, len(input_ids) + new_tokens + 8, torch.float32)
    logits, cache = model(torch.tensor([input_ids], dtype=torch.long, device=dev), cache, last_only=True)
    out, gaps = [], []
    for _ in range(new_tokens):
        top = torch.topk(logits[0, -1].float(), 2).values
        gaps.append(top[0] - top[1])
        tok = torch.argmax(logits[:, -1], dim=-1)
        out.append(tok)
        logits, cache = model(tok[:, None], cache, last_only=True)
    out = [int(t[0]) for t in out]
    if stats is not None:
        stats.update(load_s=load_s, decode_s=time.perf_counter() - t0, top2_gaps=[float(g) for g in gaps])
    return out


def run_local(path: str, vocab_mllm: str, merges_txt: str, new_tokens: int = NEW_TOKENS, device=None) -> dict:
    ids = chat_ids(vocab_mllm, merges_txt)
    return {"input_ids": ids, "output_ids": greedy_ids(path, ids, new_tokens, device)}


def run_local_tinyllama(path: str, vocab_mllm: str, new_tokens: int = NEW_TOKENS, device=None) -> dict:
    ids = tinyllama_chat_ids(vocab_mllm)
    return {"input_ids": ids, "output_ids": greedy_ids(path, ids, new_tokens, device)}


def parser() -> argparse.ArgumentParser:
    from ..examples._demo_common import add_device_arg

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gen", metavar="DIR", help="write the fixture checkpoint")
    ap.add_argument("--run", metavar="DIR", help="greedy-decode locally, print ids")
    ap.add_argument("--family", default="qwen05b", choices=["qwen05b", "tinyllama"])
    ap.add_argument("--vocab", default=None)
    ap.add_argument("--merges", default=os.environ.get("MLLM_REF_MERGES",
                                                       os.path.join(VOCAB_DIR, "qwen2.5_merges.txt")))
    ap.add_argument("--new-tokens", type=int, default=NEW_TOKENS)
    add_device_arg(ap)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    if args.vocab is None:
        args.vocab = os.environ.get("MLLM_REF_VOCAB", os.path.join(
            VOCAB_DIR, "tinyllama_vocab.mllm" if args.family == "tinyllama" else "qwen2.5_vocab.mllm"))
    res = None
    if args.family == "tinyllama":
        if args.gen:
            gen_checkpoint_tinyllama(args.gen)
        if args.run:
            from ..examples._demo_common import device

            res = run_local_tinyllama(args.run, args.vocab, args.new_tokens, device(args.device))
    else:
        if args.gen:
            gen_checkpoint(args.gen)
        if args.run:
            from ..examples._demo_common import device

            res = run_local(args.run, args.vocab, args.merges, args.new_tokens, device(args.device))
    if res is not None:
        print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
