"""Per-family chat templates.

Counterpart of the reference's per-model `apply_chat_template` overrides
(e.g. models/qwen/tokenization_qwen.hpp, models/llama3/tokenization_llama3.hpp):
each family formats [{role, content}] messages its own way.  A lightweight
registry keyed by model_type/family; `render` also accepts a raw string as a
single user turn (the reference's single-turn pattern, Tokenizer.hpp:182-190).
Copied from `mllm_tpu/tokenizers/chat_templates.py`.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

Message = dict  # {"role": str, "content": str}


def _chatml(messages, add_gen=True, system_default=None):
    out = []
    roles = [m["role"] for m in messages]
    if system_default and "system" not in roles:
        out.append(f"<|im_start|>system\n{system_default}<|im_end|>\n")
    for m in messages:
        out.append(f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n")
    if add_gen:
        out.append("<|im_start|>assistant\n")
    return "".join(out)


def qwen_template(messages, add_gen=True):
    return _chatml(messages, add_gen, system_default="You are a helpful assistant.")


def chatml_template(messages, add_gen=True):
    return _chatml(messages, add_gen)


def llama2_template(messages, add_gen=True):
    """[INST] ... [/INST] with optional <<SYS>> block."""
    sys_msg = next((m["content"] for m in messages if m["role"] == "system"), None)
    turns = [m for m in messages if m["role"] != "system"]
    out = []
    first = True
    for m in turns:
        if m["role"] == "user":
            content = m["content"]
            if first and sys_msg:
                content = f"<<SYS>>\n{sys_msg}\n<</SYS>>\n\n{content}"
            out.append(f"<s>[INST] {content} [/INST]")
            first = False
        else:
            out.append(f" {m['content']} </s>")
    return "".join(out)


def llama3_template(messages, add_gen=True):
    out = ["<|begin_of_text|>"]
    for m in messages:
        out.append(f"<|start_header_id|>{m['role']}<|end_header_id|>\n\n{m['content']}<|eot_id|>")
    if add_gen:
        out.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
    return "".join(out)


def gemma_template(messages, add_gen=True):
    out = ["<bos>"]
    for m in messages:
        role = "model" if m["role"] == "assistant" else m["role"]
        if role == "system":  # gemma folds system into the first user turn
            continue
        out.append(f"<start_of_turn>{role}\n{m['content']}<end_of_turn>\n")
    if add_gen:
        out.append("<start_of_turn>model\n")
    return "".join(out)


def mistral_template(messages, add_gen=True):
    out = ["<s>"]
    for m in messages:
        if m["role"] == "user":
            out.append(f"[INST] {m['content']} [/INST]")
        elif m["role"] == "assistant":
            out.append(f"{m['content']}</s>")
    return "".join(out)


def phi3_template(messages, add_gen=True):
    out = []
    for m in messages:
        out.append(f"<|{m['role']}|>\n{m['content']}<|end|>\n")
    if add_gen:
        out.append("<|assistant|>\n")
    return "".join(out)


def tinyllama_zephyr_template(messages, add_gen=True):
    out = []
    for m in messages:
        out.append(f"<|{m['role']}|>\n{m['content']}</s>\n")
    if add_gen:
        out.append("<|assistant|>\n")
    return "".join(out)


def fuyu_template(messages, add_gen=True):
    # fuyu is instruction-plain (reference tokenization_fuyu.hpp)
    text = "\n".join(m["content"] for m in messages if m["role"] == "user")
    return text + ("\x04" if add_gen else "")


TEMPLATES: dict[str, Callable] = {
    "qwen": qwen_template,
    "qwen2": qwen_template,
    "qwen2_moe": qwen_template,
    "qwen3": qwen_template,
    "qwen2_vl": qwen_template,
    "qwen2_5_vl": qwen_template,
    "chatml": chatml_template,
    "llama": llama2_template,
    "llama2": llama2_template,
    "llama3": llama3_template,
    "gemma": gemma_template,
    "gemma2": gemma_template,
    "mistral": mistral_template,
    "mixtral": mistral_template,
    "phi3": phi3_template,
    "tinyllama": tinyllama_zephyr_template,
    "stablelm": chatml_template,
    "smollm": chatml_template,
    "minicpm": chatml_template,
    "fuyu": fuyu_template,
}


def render(family: str, messages_or_text, add_generation_prompt: bool = True) -> str:
    """Render chat messages (or a plain user string) for `family`."""
    fn = TEMPLATES.get(family, chatml_template)
    if isinstance(messages_or_text, str):
        messages_or_text = [{"role": "user", "content": messages_or_text}]
    return fn(list(messages_or_text), add_generation_prompt)
