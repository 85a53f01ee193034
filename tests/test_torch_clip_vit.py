"""The port's CLIP and ViT models, and the vision-language layers of
`nn/layers.py` (M-RoPE, the vision rotary, Conv2d / Conv3d, the causal bias,
softmax_f32), on the CPU against the JAX package on the same weights, and
against transformers where the JAX tests use it (tests/test_vision.py,
tests/test_vit_classifier.py).

Tiny checkpoints (CLIP: towers of width 32, 2 layers, 28 px images of 14 px
patches, a 99-entry vocabulary; ViT: width 32, 2 layers, 32 px images of 16 px
patches, 5 labels), one per module, loaded by both packages in f32; inputs
from numpy seeds.

Tolerances: f32 logits within 1e-4 abs + 1e-4 rel of JAX, the JAX tests'
2e-3 of transformers; the layers within 1e-5 (f32, one rounding of the same
products); the registry's refusals by message.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mllm_tpu.core.param_loader import SafetensorsLoader as JaxLoader
from mllm_tpu.models import clip as jclip
from mllm_tpu.models import vit as jvit
from mllm_tpu.nn import layers as jl
from mllm_tpu_torch.core.param_loader import SafetensorsLoader
from mllm_tpu_torch.models import clip as tclip
from mllm_tpu_torch.models import vit as tvit
from mllm_tpu_torch.nn import layers as tl

CPU = torch.device("cpu")
F32_TOL = dict(rtol=1e-4, atol=1e-4)
HF_TOL = dict(rtol=2e-3, atol=2e-3)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def clip_ckpt(tmp_path_factory):
    import transformers

    torch.manual_seed(0)
    cfg = transformers.CLIPConfig(
        text_config_dict=dict(vocab_size=99, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                              num_attention_heads=4, max_position_embeddings=16, eos_token_id=98),
        vision_config_dict=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
                                image_size=28, patch_size=14),
        projection_dim=24)
    model = transformers.CLIPModel(cfg).eval()
    d = tmp_path_factory.mktemp("clip")
    model.save_pretrained(d)
    return model, str(d)


@pytest.fixture(scope="module")
def vit_ckpt(tmp_path_factory):
    import transformers

    torch.manual_seed(0)
    cfg = transformers.ViTConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
                                 image_size=32, patch_size=16, num_labels=5,
                                 id2label={i: f"class_{i}" for i in range(5)},
                                 label2id={f"class_{i}": i for i in range(5)})
    model = transformers.ViTForImageClassification(cfg).eval()
    d = tmp_path_factory.mktemp("vit")
    model.save_pretrained(d)
    return model, str(d)


CLIP_IDS = np.array([[5, 9, 2, 98, 0, 0], [7, 7, 7, 7, 7, 98], [3, 98, 1, 1, 1, 1]], np.int64)


# ---------------------------------------------------------------------------
# CLIP
# ---------------------------------------------------------------------------


def test_clip_logits_per_image(clip_ckpt):
    hf, d = clip_ckpt
    jm = jclip.load_clip(JaxLoader(d), jclip.clip_config_from_hf(d), jnp.float32)
    tm = tclip.load_clip(SafetensorsLoader(d), tclip.clip_config_from_hf(d), device=CPU)
    pixel = np.random.default_rng(2).standard_normal((2, 3, 28, 28)).astype(np.float32)
    want = np.asarray(jm(jnp.asarray(CLIP_IDS, jnp.int32), jnp.asarray(pixel)))
    with torch.no_grad():
        got = tm(_t(CLIP_IDS), _t(pixel)).numpy()
        ref = hf(input_ids=torch.from_numpy(CLIP_IDS), pixel_values=torch.from_numpy(pixel),
                 attention_mask=torch.ones_like(torch.from_numpy(CLIP_IDS))).logits_per_image.numpy()
    assert got.shape == (2, 3)
    np.testing.assert_allclose(got, want, **F32_TOL)
    np.testing.assert_allclose(got, ref, **HF_TOL)


def test_clip_encoders_equal_to_jax(clip_ckpt):
    _, d = clip_ckpt
    jm = jclip.load_clip(JaxLoader(d), jclip.clip_config_from_hf(d), jnp.float32)
    tm = tclip.load_clip(SafetensorsLoader(d), tclip.clip_config_from_hf(d), device=CPU)
    pixel = np.random.default_rng(3).standard_normal((1, 3, 28, 28)).astype(np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(tm.encode_text(_t(CLIP_IDS)).numpy(),
                                   np.asarray(jm.encode_text(jnp.asarray(CLIP_IDS, jnp.int32))), **F32_TOL)
        np.testing.assert_allclose(tm.encode_image(_t(pixel)).numpy(), np.asarray(jm.encode_image(jnp.asarray(pixel))),
                                   **F32_TOL)
    assert tm.logit_scale.dtype == torch.float32


def test_clip_random_init_through_the_bridge():
    """The JAX `CLIPModel.init` at small widths, bridged: the same scores;
    the port's own init has the JAX init's distributions' shapes and scale."""
    from mllm_tpu_torch.models.bridge import clip_from_jax_params

    kw = dict(text=dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                        num_attention_heads=4, max_position_embeddings=8, eos_token_id=63),
              vision=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
                          image_size=28, patch_size=14))
    jcfg = jclip.CLIPConfig(jclip.CLIPTextConfig(**kw["text"]), jvit.VisionConfig(**kw["vision"]), 16)
    tcfg = tclip.CLIPConfig(tclip.CLIPTextConfig(**kw["text"]), tvit.VisionConfig(**kw["vision"]), 16)
    jm = jclip.CLIPModel.init(jax.random.PRNGKey(0), jcfg)
    tm = clip_from_jax_params({k: np.asarray(v) for k, v in jm.parameters().items()}, tcfg, CPU)
    ids = np.array([[1, 2, 63, 0, 0, 0, 0, 0], [4, 4, 4, 4, 4, 4, 4, 63]], np.int64)
    pixel = np.random.default_rng(0).standard_normal((3, 3, 28, 28)).astype(np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(tm(_t(ids), _t(pixel)).numpy(),
                                   np.asarray(jm(jnp.asarray(ids, jnp.int32), jnp.asarray(pixel))), **F32_TOL)
    fresh = tclip.CLIPModel.init(tcfg, device=CPU)
    assert float(fresh.logit_scale) == pytest.approx(2.6592)
    assert fresh.state_dict().keys() == tm.state_dict().keys()
    assert 0.015 < float(fresh.text_model.token_embedding.std()) < 0.025


# ---------------------------------------------------------------------------
# ViT
# ---------------------------------------------------------------------------


def test_vit_class_logits_and_classify(vit_ckpt):
    hf, d = vit_ckpt
    jcfg, n, id2label = jvit.vit_config_from_hf(d)
    tcfg, tn, tid2label = tvit.vit_config_from_hf(d)
    assert (tn, tid2label) == (n, id2label) and tcfg.__dict__ == jcfg.__dict__
    jm = jvit.load_vit_classifier(JaxLoader(d), jcfg, n, jnp.float32, id2label)
    tm = tvit.load_vit_classifier(SafetensorsLoader(d), tcfg, tn, device=CPU, id2label=tid2label)
    pixel = np.random.default_rng(0).standard_normal((2, 3, 32, 32)).astype(np.float32)
    want = np.asarray(jm(jnp.asarray(pixel)))
    with torch.no_grad():
        got = tm(_t(pixel)).numpy()
        ref = hf(torch.from_numpy(pixel)).logits.numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)
    np.testing.assert_allclose(got, ref, **HF_TOL)
    got_top = tm.classify(_t(pixel), top_k=2)
    want_top = jm.classify(jnp.asarray(pixel), top_k=2)
    assert [[lab for lab, _ in row] for row in got_top] == [[lab for lab, _ in row] for row in want_top]
    for gr, wr in zip(got_top, want_top):
        np.testing.assert_allclose([p for _, p in gr], [p for _, p in wr], rtol=1e-5)


def test_vit_bridge(vit_ckpt):
    from mllm_tpu_torch.models.bridge import vit_from_jax_params

    _, d = vit_ckpt
    jcfg, n, id2label = jvit.vit_config_from_hf(d)
    jm = jvit.load_vit_classifier(JaxLoader(d), jcfg, n, jnp.float32, id2label)
    tcfg, _, _ = tvit.vit_config_from_hf(d)
    tm = tvit.load_vit_classifier(SafetensorsLoader(d), tcfg, n, device=CPU)
    bridged = vit_from_jax_params({k: np.asarray(v) for k, v in jm.parameters().items()}, tcfg, n, CPU)
    assert bridged.state_dict().keys() == tm.state_dict().keys()
    for k, v in tm.state_dict().items():
        assert torch.equal(bridged.state_dict()[k], v), k


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def test_auto_model_any_loads_clip_and_vit(clip_ckpt, vit_ckpt):
    from mllm_tpu_torch.models.registry import auto_model, auto_model_any

    model, kind = auto_model_any(clip_ckpt[1], torch.float32, device=CPU)
    assert kind == "clip" and isinstance(model, tclip.CLIPModel)
    model, tok, cfg = auto_model(clip_ckpt[1], torch.float32, device=CPU)
    assert isinstance(model, tclip.CLIPModel) and cfg == model.cfg and tok is None
    model, kind = auto_model_any(vit_ckpt[1], torch.float32, device=CPU)
    assert kind == "vit"
    assert model(torch.zeros(1, 3, 32, 32)).shape == (1, 5)


@pytest.mark.parametrize("mt,item", [("llava", "item 13"), ("fuyu", "item 13"), ("phi3_v", "item 13"),
                                     ("phi3v", "item 13"), ("opt", "item 14"), ("bert", "item 14")])
def test_later_types_still_raise(tmp_path, monkeypatch, mt, item):
    """The types of ROADMAP items 13 and 14 (`item`), which raised until the
    port had them, now reach their family's loader through auto_model_any
    and auto_model, with the JAX package's kind and the config's defaults."""
    import importlib

    from mllm_tpu_torch.models import registry

    module, loader, kind = {"llava": ("llava", "load_llava", "llava"), "fuyu": ("fuyu", "load_fuyu", "fuyu"),
                            "phi3_v": ("phi3v", "load_phi3v", "phi3v"), "phi3v": ("phi3v", "load_phi3v", "phi3v"),
                            "opt": ("opt", "load_opt", "opt"), "bert": ("bert", "load_bert", "bert")}[mt]
    seen = []

    class Loaded:
        cfg = "cfg"

    monkeypatch.setattr(registry, "open_loader", lambda path: "loader")
    monkeypatch.setattr(importlib.import_module(f"mllm_tpu_torch.models.{module}"), loader,
                        lambda ld, cfg, **kw: seen.append((ld, type(cfg).__name__, kw["device"])) or Loaded())
    (tmp_path / "config.json").write_text(json.dumps({"model_type": mt}))
    model, got = registry.auto_model_any(str(tmp_path), device=CPU)
    assert isinstance(model, Loaded) and got == kind
    _, tok, cfg = registry.auto_model(str(tmp_path), device=CPU)
    assert tok is None and cfg == "cfg" and seen[0] == seen[1] and seen[0][0] == "loader"


# ---------------------------------------------------------------------------
# the vision-language layers
# ---------------------------------------------------------------------------


def test_multimodal_rotary_equal():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 64, (3, 2, 5))
    want = jl.MultimodalRotaryEmbedding.make(16, 64, 10000.0, (2, 3, 3))(jnp.asarray(x), jnp.asarray(pos))
    rope = tl.MultimodalRotaryEmbedding.make(16, 64, 10000.0, (2, 3, 3), device=CPU)
    np.testing.assert_allclose(rope(_t(x), _t(pos)).numpy(), np.asarray(want), **LAYER_TOL)
    # one position on all three axes is the plain rotary
    same = np.broadcast_to(pos[:1], pos.shape)
    plain = tl.RotaryEmbedding.make(16, 64, 10000.0, device=CPU)(_t(x), _t(same[0]))
    np.testing.assert_allclose(rope(_t(x), _t(same)).numpy(), plain.numpy(), **LAYER_TOL)


def test_vision_rotary_freqs_equal():
    hw = np.random.default_rng(1).integers(0, 40, (7, 2))
    want = jl.VisionRotaryEmbedding.make(80).freqs(hw)
    got = tl.VisionRotaryEmbedding.make(80, device=CPU).freqs(hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


def test_convolutions_equal():
    rng = np.random.default_rng(2)
    w2, b2 = rng.standard_normal((6, 3, 4, 4)).astype(np.float32), rng.standard_normal(6).astype(np.float32)
    x2 = rng.standard_normal((2, 12, 8, 3)).astype(np.float32)
    conv2 = tl.Conv2d(3, 6, (4, 4), (4, 2), device=CPU, dtype=torch.float32)
    conv2.load_state_dict({"weight": _t(w2), "bias": _t(b2)})
    want2 = jl.Conv2d(jnp.asarray(w2), jnp.asarray(b2), (4, 2))(jnp.asarray(x2))
    np.testing.assert_allclose(conv2(_t(x2)).detach().numpy(), np.asarray(want2), **LAYER_TOL)
    w3, b3 = rng.standard_normal((5, 3, 2, 2, 2)).astype(np.float32), rng.standard_normal(5).astype(np.float32)
    p3 = rng.standard_normal((7, 24)).astype(np.float32)
    conv3 = tl.Conv3d(3, 5, (2, 2, 2), device=CPU, dtype=torch.float32)
    conv3.load_state_dict({"weight": _t(w3), "bias": _t(b3)})
    want3 = jl.Conv3d(jnp.asarray(w3), jnp.asarray(b3), (2, 2, 2))(jnp.asarray(p3))
    np.testing.assert_allclose(conv3(_t(p3)).detach().numpy(), np.asarray(want3), **LAYER_TOL)


def test_causal_bias_and_softmax_equal():
    for window in (None, 3):
        want = jl.causal_mask_bias(5, 9, 4, window=window)
        np.testing.assert_array_equal(tl.causal_mask_bias(5, 9, 4, window=window).numpy(), np.asarray(want))
    x = np.random.default_rng(3).standard_normal((4, 7)).astype(np.float32)
    np.testing.assert_allclose(tl.softmax_f32(_t(x).to(torch.bfloat16)).numpy(),
                               np.asarray(jl.softmax_f32(jnp.asarray(x, jnp.bfloat16))), **LAYER_TOL)
