"""The port's vision-language demos (`mllm_tpu_torch.examples.demo_qwen2_vl`,
`demo_showui`, `demo_qwen2_5_vl`, `demo_phi3v`, `demo_fuyu`, `demo_opt`)
against the JAX package, run in process with `--device cpu` on tiny
checkpoint directories: transformers `save_pretrained` checkpoints (Phi-3-V:
`tests/test_phi3v.py`'s `.mllm` writer) of the geometries the model tests
use (hidden 32, 2 layers), a 300-entry synthetic byte-level tokenizer
(`chip_smoke.synthetic_tokenizer`, the chat and vision specials last) and a
PNG from a numpy seed.

The JAX side is its own functions called as each JAX demo calls them, in
bf16 (the demos' dtype): `load_*`, its tokenizer and processors,
`vl_generate` or one image forward and the greedy loop of
`examples/_demo_common.py:vl_decode_loop`. The greedy ids are equal. The
checkpoints' token embeddings are redrawn N(0, 1) and their untied heads
N(0, 0.5^2) (`_condition`): at transformers' default init the top two
logits often lie within the two packages' bf16 rounding of the hidden
state (0.005 apart against a 0.027 gap between the packages on OPT),
where either argmax is a coin toss. `demo_showui` puts the JAX
wrapper's grounding prompt (read from `examples/demo_showui.py`) in front
unless `--prompt` is given.
"""

import functools
import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mllm_tpu.core.param_loader import SafetensorsLoader as JaxLoader
from mllm_tpu.models import fuyu as jfuyu
from mllm_tpu.models import opt as jopt
from mllm_tpu.models import phi3v as jphi3v
from mllm_tpu.models import qwen2_5_vl as jvl25
from mllm_tpu.models import qwen2_vl as jvl
from mllm_tpu.models.registry import open_loader as jax_open_loader
from mllm_tpu.processor.image import ClipImageProcessor as JaxClipProcessor
from mllm_tpu.processor.image import load_image as jax_load_image
from mllm_tpu.processor.qwen2_vl import Qwen2VLProcessor as JaxQwen2VLProcessor
from mllm_tpu.tokenizers.hf_json import auto_tokenizer as jax_auto_tokenizer
from mllm_tpu_torch.examples import (demo_fuyu, demo_opt, demo_phi3v, demo_qwen2_5_vl, demo_qwen2_vl,
                                     demo_showui)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V = 300
SPECIALS = chip_smoke.TOKENIZER_SPECIALS + chip_smoke.VL_SPECIALS  # ids 293-299
END, IM_START, IM_END, VSTART, VEND, IMG, VID = range(V - len(SPECIALS), V)
PHI3_SPECIALS = ("<|endoftext|>", "<|user|>", "<|end|>", "<|assistant|>")
STD = 0.2  # the checkpoints' initializer_range
PROMPT = "Describe this image."
NEW, LIMIT = 8, 512
RUN = ["--prompt", PROMPT, "--max-new", str(NEW), "-l", str(LIMIT), "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tokenizer(path, specials=SPECIALS, seed=0):
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(chip_smoke.synthetic_tokenizer(V, seed, specials=specials), f, ensure_ascii=False)


def _png(path, h: int, w: int, seed: int) -> str:
    from PIL import Image

    img = np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)
    Image.fromarray(img).save(path)
    return str(path)


def _condition(path, seed: int = 0) -> None:
    """Redraw the checkpoint's token embedding N(0, 1) and its untied output
    head N(0, 0.5^2), in place (`chip_smoke.cli_tensors`' recipe): logits
    whose top two lie well apart against the bf16 rounding of the hidden
    state."""
    from safetensors.numpy import load_file, save_file

    f = os.path.join(path, "model.safetensors")
    t = load_file(f)
    rng = np.random.default_rng(seed)
    for k in sorted(t):
        if k.endswith("embed_tokens.weight"):
            t[k] = rng.standard_normal(t[k].shape).astype(t[k].dtype)
        elif k.endswith("lm_head.weight"):
            t[k] = (rng.standard_normal(t[k].shape) * 0.5).astype(t[k].dtype)
    save_file(t, f, metadata={"format": "pt"})


def _save(model_cls, cfg, path) -> str:
    torch.manual_seed(0)
    model_cls(cfg).eval().save_pretrained(path)
    _condition(str(path))
    return str(path)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("demos_vl")


@pytest.fixture(scope="module")
def qwen2_vl_dir(root):
    import transformers

    cfg = transformers.Qwen2VLConfig(
        vocab_size=V, hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, max_position_embeddings=512, rope_theta=10000.0, tie_word_embeddings=False,
        rope_scaling={"type": "mrope", "mrope_section": [1, 1, 2]}, initializer_range=STD,
        image_token_id=IMG, video_token_id=VID, vision_start_token_id=VSTART, vision_end_token_id=VEND,
        bos_token_id=END, eos_token_id=IM_END,
        vision_config=dict(depth=2, embed_dim=32, hidden_size=32, mlp_ratio=2.0, num_heads=4, in_channels=3,
                           patch_size=14, temporal_patch_size=2, spatial_merge_size=2, initializer_range=STD))
    d = _save(transformers.Qwen2VLForConditionalGeneration, cfg, root / "qwen2_vl")
    _tokenizer(d)
    return d


@pytest.fixture(scope="module")
def qwen2_5_vl_dir(root):
    import transformers

    cfg = transformers.Qwen2_5_VLConfig(
        vocab_size=V, hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, max_position_embeddings=512, rope_theta=10000.0, tie_word_embeddings=False,
        rope_scaling={"type": "mrope", "mrope_section": [1, 1, 2]}, initializer_range=STD,
        image_token_id=IMG, video_token_id=VID, vision_start_token_id=VSTART, vision_end_token_id=VEND,
        bos_token_id=END, eos_token_id=IM_END,
        vision_config=dict(depth=3, hidden_size=32, out_hidden_size=32, intermediate_size=48, num_heads=4,
                           in_channels=3, patch_size=14, temporal_patch_size=2, spatial_merge_size=2,
                           window_size=56, fullatt_block_indexes=[1], initializer_range=STD))
    d = _save(transformers.Qwen2_5_VLForConditionalGeneration, cfg, root / "qwen2_5_vl")
    _tokenizer(d, seed=1)
    return d


@pytest.fixture(scope="module")
def image(root):
    return _png(root / "image.png", 56, 84, 0)  # Qwen2-VL grid (1, 4, 6): 6 image tokens


def _jax_qwen_vl(path: str, image: str, prompt: str, load) -> list:
    """The JAX demo_qwen2_vl / demo_qwen2_5_vl: load in bf16, the processor,
    `vl_generate`."""
    model, cfg = load(path)
    tok = jax_auto_tokenizer(path)
    proc = JaxQwen2VLProcessor(tok, image_token_id=cfg.image_token_id, video_token_id=cfg.video_token_id)
    out = proc(proc.chat_text(prompt), images=image)
    toks, _ = jvl.vl_generate(model, out, model.init_cache(1, LIMIT, jnp.bfloat16), NEW,
                              eos_token_id=tok.eos_token_id)
    return toks


@functools.lru_cache(maxsize=None)
def _jax_qwen2_vl(path: str, image: str, prompt: str = PROMPT) -> list:
    def load(p):
        cfg = jvl.qwen2_vl_config_from_hf(p)
        return jvl.load_qwen2_vl(JaxLoader(p), cfg, jnp.bfloat16, None), cfg
    return _jax_qwen_vl(path, image, prompt, load)


def test_demo_qwen2_vl_greedy_equals_jax(qwen2_vl_dir, image):
    got = demo_qwen2_vl.main(["-m", qwen2_vl_dir, "-i", image, *RUN])
    assert got["grid_thw"] == (1, 4, 6)
    assert got["ids"] == _jax_qwen2_vl(qwen2_vl_dir, image)
    assert len(set(got["ids"])) > 1 and 0 <= got["ttft_s"] <= got["seconds"]


def _jax_script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_demo_showui_inserts_the_jax_grounding_prompt(qwen2_vl_dir, image):
    assert demo_showui.GROUNDING == _jax_script("demo_showui")._GROUNDING
    run = [a for a in RUN if a not in ("--prompt", PROMPT)]
    got = demo_showui.main(["-m", qwen2_vl_dir, "-i", image, *run])
    assert got["ids"] == _jax_qwen2_vl(qwen2_vl_dir, image, demo_showui.GROUNDING)
    given = demo_showui.main(["-m", qwen2_vl_dir, "-i", image, *RUN])  # --prompt given: not inserted
    assert given["ids"] == _jax_qwen2_vl(qwen2_vl_dir, image)


def test_demo_qwen2_5_vl_greedy_equals_jax(qwen2_5_vl_dir, image, capsys):
    def load(p):
        base, vcfg = jvl25.qwen2_5_vl_configs_from_hf(p)
        return jvl25.load_qwen2_5_vl(jax_open_loader(p), base, vcfg, jnp.bfloat16, None), base
    got = demo_qwen2_5_vl.main(["-m", qwen2_5_vl_dir, "-i", image, *RUN])
    assert got["ids"] == _jax_qwen_vl(qwen2_5_vl_dir, image, PROMPT, load)
    assert len(set(got["ids"])) > 1
    out = capsys.readouterr().out
    assert "load: " in out and "image grid: (1, 4, 6)" in out and "tok/s" in out


def _jax_greedy(model, tok, logits, cache, max_new: int) -> list:
    """The tokens JAX `examples/_demo_common.py:vl_decode_loop` streams."""
    tokv = int(np.argmax(np.asarray(logits[0, -1])))
    out = [tokv]
    for _ in range(max_new - 1):
        logits, cache = model(jnp.asarray([[tokv]], jnp.int32), cache)
        tokv = int(np.argmax(np.asarray(logits[0, -1])))
        if tokv == tok.eos_token_id:
            break
        out.append(tokv)
    return out


@pytest.fixture(scope="module")
def phi3v_dir(root):
    import dataclasses

    from test_phi3v import _tiny_cfg, _write_random

    jcfg = _tiny_cfg()
    jcfg = dataclasses.replace(jcfg, text=jcfg.text.replace(vocab_size=V))
    d = root / "phi3v"
    d.mkdir()
    _write_random(d / "model.mllm", jcfg)
    t = jcfg.text
    hf = dict(model_type="phi3_v", vocab_size=V, hidden_size=t.hidden_size, intermediate_size=t.intermediate_size,
              num_hidden_layers=t.num_hidden_layers, num_attention_heads=t.num_attention_heads,
              num_key_value_heads=t.num_key_value_heads, max_position_embeddings=t.max_position_embeddings,
              rope_theta=t.rope_theta, tie_word_embeddings=True, bos_token_id=1, eos_token_id=V - 2,
              embd_layer={"embedding_cls": "image"},
              img_processor=dict(hidden_size=16, intermediate_size=32, num_hidden_layers=2, num_attention_heads=4,
                                 image_size=56, patch_size=14))
    with open(d / "config.json", "w") as f:
        json.dump(hf, f)
    _tokenizer(d, PHI3_SPECIALS, seed=2)
    return str(d)


def test_demo_phi3v_greedy_equals_jax(phi3v_dir, image, capsys):
    got = demo_phi3v.main(["-m", phi3v_dir, "-i", image, *RUN])
    cfg = jphi3v.phi3v_config_from_hf(phi3v_dir)
    jm = jphi3v.load_phi3v(jax_open_loader(phi3v_dir), cfg, jnp.bfloat16, None)
    tok = jax_auto_tokenizer(phi3v_dir)
    pixel = JaxClipProcessor(size=cfg.vision.image_size, crop=cfg.vision.image_size)(image)
    ids = [-1] * jm.num_image_tokens + tok.encode(f"<|user|>\n{PROMPT}<|end|>\n<|assistant|>\n")
    assert got["prompt_len"] == len(ids)
    logits, cache = jm(jnp.asarray(np.asarray(ids, np.int32)[None]), jm.init_cache(1, LIMIT, jnp.bfloat16),
                       pixel_values=jnp.asarray(pixel))
    assert got["ids"] == _jax_greedy(jm, tok, logits, cache, NEW)
    assert f"({jm.num_image_tokens} image tokens)" in capsys.readouterr().out


@pytest.fixture(scope="module")
def fuyu_dir(root):
    import transformers

    cfg = transformers.FuyuConfig(
        text_config=dict(model_type="persimmon", vocab_size=V, hidden_size=32, intermediate_size=64,
                         num_hidden_layers=2, num_attention_heads=4, max_position_embeddings=512,
                         partial_rotary_factor=0.5, qk_layernorm=True, hidden_act="relu2", rope_theta=10000.0,
                         tie_word_embeddings=False, initializer_range=STD),
        hidden_size=32, patch_size=4, num_channels=3, image_token_id=200, initializer_range=STD,
        eos_token_id=END)
    d = _save(transformers.FuyuForCausalLM, cfg, root / "fuyu")
    _tokenizer(d, seed=3)
    return d


def test_demo_fuyu_greedy_equals_jax(fuyu_dir, root):
    png = _png(root / "fuyu.png", 8, 12, 1)  # 2 x 3 patches of 4 px
    got = demo_fuyu.main(["-m", fuyu_dir, "-i", png, *RUN])
    cfg = jfuyu.fuyu_config_from_hf(fuyu_dir)
    jm = jfuyu.load_fuyu(jax_open_loader(fuyu_dir), cfg, jnp.bfloat16, None)
    tok = jax_auto_tokenizer(fuyu_dir)
    chw = jax_load_image(png).transpose(2, 0, 1).astype(np.float32) / 255.0 * 2 - 1
    patches = jfuyu.patchify_image(chw, cfg.patch_size)
    ids = [cfg.image_token_id] * patches.shape[0] + tok.encode(PROMPT)
    assert patches.shape[0] == 6 and got["prompt_len"] == len(ids)
    logits, cache = jm(jnp.asarray(np.asarray(ids, np.int32)[None]), jm.init_cache(1, LIMIT, jnp.bfloat16),
                       image_patches=jnp.asarray(patches))
    assert got["ids"] == _jax_greedy(jm, tok, logits, cache, NEW)
    assert len(set(got["ids"])) > 1


@pytest.fixture(scope="module")
def opt_dir(root):
    import transformers

    cfg = transformers.OPTConfig(vocab_size=V, hidden_size=32, ffn_dim=64, num_hidden_layers=2,
                                 num_attention_heads=4, max_position_embeddings=512, word_embed_proj_dim=32,
                                 init_std=STD, eos_token_id=END)
    d = _save(transformers.OPTForCausalLM, cfg, root / "opt")
    _tokenizer(d, seed=4)
    return d


def test_demo_opt_greedy_equals_jax(opt_dir):
    got = demo_opt.main(["-m", opt_dir, *RUN])
    cfg = jopt.opt_config_from_hf(opt_dir)
    jm = jopt.load_opt(jax_open_loader(opt_dir), cfg, jnp.bfloat16)
    tok = jax_auto_tokenizer(opt_dir)
    ids = [cfg.bos_token_id] + tok.encode(PROMPT)
    assert got["prompt_len"] == len(ids)
    logits, cache = jm(jnp.asarray(np.asarray(ids, np.int32)[None]), jm.init_cache(1, LIMIT, jnp.bfloat16))
    assert got["ids"] == _jax_greedy(jm, tok, logits, cache, NEW)
    assert len(set(got["ids"])) > 1


@pytest.mark.parametrize("demo", [demo_qwen2_vl, demo_showui, demo_qwen2_5_vl, demo_phi3v, demo_fuyu, demo_opt])
def test_demos_need_a_card_unless_cpu_is_asked(demo, monkeypatch, image):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="found none"):
        demo.main(["-m", "unused"] + ([] if demo is demo_opt else ["-i", image]))
