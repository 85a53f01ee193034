"""The port's LLaVA and Phi-3-V (`mllm_tpu_torch.models.llava` / `phi3v`) on
the CPU against the JAX package on the same checkpoints, and LLaVA against
transformers (tests/test_llava.py's tiny checkpoint; Phi-3-V has no
transformers oracle, as in tests/test_phi3v.py).

Tiny geometries: LLaVA's LM 32 wide, 2 layers, 4/2 heads, its CLIP tower 24
wide, 3 blocks, 28 px images of 14 px patches (4 image tokens); Phi-3-V's LM
32 wide, 2 layers, its tower 16 wide, 2 blocks, 56 px images (7 image tokens
after the HD transform). Inputs from numpy seeds; everything in f32.

Tolerances: the image prefill's logits within 1e-4 x max |logit| of JAX, 8
greedy tokens (each step through `forward` without the image, as the
reference decodes) equal; transformers within the JAX tests' 2e-3.
"""

import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mllm_tpu.core.param_loader import ParamLoader as JaxParamLoader
from mllm_tpu.core.param_loader import SafetensorsLoader as JaxLoader
from mllm_tpu.models import llava as jllava
from mllm_tpu.models import phi3v as jphi3v
from mllm_tpu_torch.core.config import TextConfig
from mllm_tpu_torch.core.param_loader import ParamLoader
from mllm_tpu_torch.models import llava as tllava
from mllm_tpu_torch.models import phi3v as tphi3v
from mllm_tpu_torch.models.bridge import llava_from_jax_params, phi3v_from_jax_params
from mllm_tpu_torch.models.registry import auto_model, auto_model_any
from mllm_tpu_torch.models.vit import VisionConfig

from test_phi3v import _tiny_cfg, _write_random

CPU = torch.device("cpu")
REL_TOL = 1e-4
HF_TOL = dict(rtol=2e-3, atol=2e-3)
IMG_TOK = 63
N_NEW = 8


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def jax_greedy(model, logits, cache, n):
    toks = []
    for _ in range(n):
        t = int(np.argmax(np.asarray(logits)[0, -1]))
        toks.append(t)
        logits, cache = model(jnp.asarray([[t]], jnp.int32), cache, last_only=True)
    return toks


def port_greedy(model, logits, cache, n):
    toks = []
    for _ in range(n):
        t = int(torch.argmax(logits[0, -1]))
        toks.append(t)
        logits, cache = model(torch.tensor([[t]]), cache, last_only=True)
    return toks


@pytest.fixture(scope="module")
def tiny_llava(tmp_path_factory):
    import transformers

    torch.manual_seed(0)
    cfg = transformers.LlavaConfig(
        text_config=dict(model_type="llama", vocab_size=128, hidden_size=32, intermediate_size=64,
                         num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                         max_position_embeddings=128, rope_theta=10000.0),
        vision_config=dict(model_type="clip_vision_model", hidden_size=24, intermediate_size=48,
                           num_hidden_layers=3, num_attention_heads=4, image_size=28, patch_size=14,
                           hidden_act="quick_gelu"),
        image_token_index=IMG_TOK, vision_feature_layer=-2, vision_feature_select_strategy="default")
    model = transformers.LlavaForConditionalGeneration(cfg).eval()
    d = tmp_path_factory.mktemp("llava")
    model.save_pretrained(d)
    return model, str(d)


LLAVA_IDS = np.array([[1, 5, IMG_TOK, IMG_TOK, IMG_TOK, IMG_TOK, 9, 11]], np.int64)


def _llava_pair(d):
    jm = jllava.load_llava(JaxLoader(d), jllava.llava_config_from_hf(d), jnp.float32)
    tm, kind = auto_model_any(d, torch.float32, device=CPU)
    assert kind == "llava" and isinstance(tm, tllava.LlavaForConditionalGeneration)
    return jm, tm


def test_llava_prefill_and_greedy_match_jax(tiny_llava):
    jm, tm = _llava_pair(tiny_llava[1])
    pixel = np.random.default_rng(0).standard_normal((1, 3, 28, 28)).astype(np.float32)
    jl, jc = jm(jnp.asarray(LLAVA_IDS, jnp.int32), jm.init_cache(1, 32, jnp.float32),
                pixel_values=jnp.asarray(pixel), last_only=False)
    with torch.no_grad():
        tl, tc = tm(torch.from_numpy(LLAVA_IDS), tm.init_cache(1, 32, torch.float32),
                    pixel_values=torch.from_numpy(pixel), last_only=False)
        assert rel(tl, jl) < REL_TOL
        assert port_greedy(tm, tl, tc, N_NEW) == jax_greedy(jm, jl, jc, N_NEW)


def test_llava_matches_transformers(tiny_llava):
    hf, d = tiny_llava
    _, tm = _llava_pair(d)
    pixel = np.random.default_rng(1).standard_normal((1, 3, 28, 28)).astype(np.float32)
    with torch.no_grad():
        ref = hf(input_ids=torch.from_numpy(LLAVA_IDS), pixel_values=torch.from_numpy(pixel)).logits
        out, cache = tm(torch.from_numpy(LLAVA_IDS), tm.init_cache(1, 32, torch.float32),
                        pixel_values=torch.from_numpy(pixel), last_only=False)
        torch.testing.assert_close(out, ref, **HF_TOL)
        hf_toks = hf.generate(inputs=torch.from_numpy(LLAVA_IDS), pixel_values=torch.from_numpy(pixel),
                              max_new_tokens=6, do_sample=False, eos_token_id=None,
                              pad_token_id=0)[0, LLAVA_IDS.shape[1]:].tolist()
        assert port_greedy(tm, out, cache, 6) == hf_toks


def test_llava_bridge_and_splice(tiny_llava):
    """The bridge gives the same model as the checkpoint; the splice is the
    reference's cumulative count, clipped (a fifth image token repeats the
    last patch), with no host read."""
    jm, tm = _llava_pair(tiny_llava[1])
    bridged = llava_from_jax_params({k: np.asarray(v) for k, v in jm.parameters().items()}, tm.cfg, CPU)
    pixel = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 3, 28, 28)).astype(np.float32))
    ids = torch.tensor([[IMG_TOK, 3, IMG_TOK, IMG_TOK, IMG_TOK, IMG_TOK, 7]])
    with torch.no_grad():
        a, _ = tm(ids, tm.init_cache(1, 16, torch.float32), pixel_values=pixel, last_only=False)
        b, _ = bridged(ids, bridged.init_cache(1, 16, torch.float32), pixel_values=pixel, last_only=False)
        assert torch.equal(a, b)
        img = tm.encode_image(pixel)[0]
        x = tllava.splice_rows(tm.lm.embed_tokens(ids), ids == IMG_TOK, img)
    assert torch.equal(x[0, [0, 2, 3, 4, 5]], img[[0, 1, 2, 3, 3]])
    assert torch.equal(x[0, 1], tm.lm.embed_tokens.weight[3])


# ---------------------------------------------------------------------------
# Phi-3-V
# ---------------------------------------------------------------------------


def _port_phi3v_cfg(jcfg) -> tphi3v.Phi3VConfig:
    import dataclasses

    return tphi3v.Phi3VConfig(text=TextConfig(**dataclasses.asdict(jcfg.text)),
                              vision=VisionConfig(**dataclasses.asdict(jcfg.vision)), image_dim_out=jcfg.image_dim_out)


@pytest.fixture(scope="module")
def tiny_phi3v(tmp_path_factory):
    jcfg = _tiny_cfg()
    p = tmp_path_factory.mktemp("phi3v") / "p3v.mllm"
    _write_random(p, jcfg)
    return jcfg, p


def test_phi3v_prefill_and_greedy_match_jax(tiny_phi3v):
    jcfg, p = tiny_phi3v
    jm = jphi3v.load_phi3v(JaxParamLoader(p), jcfg, jnp.float32)
    tm = tphi3v.load_phi3v(ParamLoader(p), _port_phi3v_cfg(jcfg), device=CPU, dtype=torch.float32)
    assert tm.num_image_tokens == jm.num_image_tokens == 7
    pixel = np.random.default_rng(1).standard_normal((1, 3, 56, 56)).astype(np.float32)
    ids = np.array([[1, 5] + [-1] * 7 + [9]], np.int32)
    jl, jc = jm(jnp.asarray(ids), jm.init_cache(1, 32, jnp.float32), pixel_values=jnp.asarray(pixel),
                last_only=False)
    with torch.no_grad():
        feats = tm.image_embed.hd_feature(torch.from_numpy(pixel))
        assert feats.shape == (1, 7, jcfg.text.hidden_size)
        assert rel(feats, jm.image_embed.hd_feature(jnp.asarray(pixel))) < REL_TOL
        tl, tc = tm(torch.from_numpy(ids.astype(np.int64)), tm.init_cache(1, 32, torch.float32),
                    pixel_values=torch.from_numpy(pixel), last_only=False)
        assert rel(tl, jl) < REL_TOL
        assert port_greedy(tm, tl, tc, N_NEW) == jax_greedy(jm, jl, jc, N_NEW)
        bridged = phi3v_from_jax_params({k: np.asarray(v) for k, v in jm.parameters().items()}, tm.cfg, CPU)
        bl, _ = bridged(torch.from_numpy(ids.astype(np.int64)), bridged.init_cache(1, 32, torch.float32),
                        pixel_values=torch.from_numpy(pixel), last_only=False)
        assert torch.equal(bl, tl)


def test_phi3v_incremental_equals_full(tiny_phi3v):
    """The image in a first chunk and the text after it in a second give the
    logits of one prefill (tests/test_phi3v.py's check, on the port)."""
    jcfg, p = tiny_phi3v
    tm = tphi3v.load_phi3v(ParamLoader(p), _port_phi3v_cfg(jcfg), device=CPU, dtype=torch.float32)
    pixel = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 3, 56, 56)).astype(np.float32))
    ids = torch.tensor([[1, 5] + [-1] * 7 + [9]])
    with torch.no_grad():
        full, _ = tm(ids, tm.init_cache(1, 32, torch.float32), pixel_values=pixel, last_only=False)
        a, c = tm(ids[:, :9], tm.init_cache(1, 32, torch.float32), pixel_values=pixel, last_only=False)
        b, _ = tm(ids[:, 9:], c, last_only=False)
    torch.testing.assert_close(full[0], torch.cat([a[0], b[0]]), rtol=2e-4, atol=2e-5)


def test_phi3v_config_and_registry(tmp_path, tiny_phi3v):
    """phi3v_config_from_hf reads the Phi-3 LM and the img_processor fields;
    a `phi3_v` / `phi3v` checkpoint directory loads through auto_model_any
    (kind "phi3v") and auto_model (cfg the model's)."""
    import shutil

    jcfg, p = tiny_phi3v
    t = jcfg.text
    hf = dict(model_type="phi3_v", vocab_size=t.vocab_size, hidden_size=t.hidden_size,
              intermediate_size=t.intermediate_size, num_hidden_layers=t.num_hidden_layers,
              num_attention_heads=t.num_attention_heads, num_key_value_heads=t.num_key_value_heads,
              max_position_embeddings=t.max_position_embeddings, rope_theta=t.rope_theta,
              tie_word_embeddings=True, eos_token_id=-3, embd_layer={"embedding_cls": "image"},
              img_processor=dict(hidden_size=16, intermediate_size=32, num_hidden_layers=2, num_attention_heads=4,
                                 image_size=56, patch_size=14))
    for mt in ("phi3_v", "phi3v"):
        d = tmp_path / mt
        d.mkdir()
        shutil.copy(p, d / "model.mllm")
        (d / "config.json").write_text(json.dumps({**hf, "model_type": mt}))
        cfg = tphi3v.phi3v_config_from_hf(str(d))
        assert cfg.text.model_type == "phi3" and cfg.vision.image_size == 56 and cfg.image_dim_out == 16
        model, kind = auto_model_any(str(d), torch.float32, device=CPU)
        assert kind == "phi3v" and isinstance(model, tphi3v.Phi3VForCausalLM)
        model2, tok, mcfg = auto_model(str(d), torch.float32, device=CPU)
        assert mcfg is model2.cfg and tok is None
