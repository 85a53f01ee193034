"""The port's Qwen2-VL stack (processors, vision tower, M-RoPE, VTP, the fused
image prefill, VL generation, engine admission) on the CPU against the JAX
package on the same weights, and against transformers where the JAX tests
use it (tests/test_qwen2_vl.py).

One tiny checkpoint per module (transformers' Qwen2VLForConditionalGeneration
at the JAX tests' geometry: hidden 32, 2 layers, 4 / 2 heads, a 2-block
tower of width 32, a 128-entry vocabulary with the vision tokens at 120-123)
is loaded by both packages' `load_qwen2_vl` in f32; inputs come from numpy
seeds.

Tolerances: the processors, get_rope_index, device_patchify, yuv420_to_rgb,
VTP's kept indices and greedy tokens exactly; device_resize_bicubic within
1 u8 LSB of PIL (the JAX function's bound); f32 embeds and logits within
1e-4 abs + 1e-4 rel of JAX, and the JAX tests' 2e-3 of transformers; the
int8 / int4 models and KV caches: greedy tokens equal to JAX's and logits
within 2e-3 x max |logit| (int4 KV: the first two greedy steps, as the JAX
test asserts).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mllm_tpu.core.param_loader import SafetensorsLoader as JaxLoader
from mllm_tpu.models import qwen2_vl as jvl
from mllm_tpu.processor import image as jimage
from mllm_tpu.processor import qwen2_vl as jproc
from mllm_tpu_torch.core.param_loader import SafetensorsLoader
from mllm_tpu_torch.models import qwen2_vl as tvl
from mllm_tpu_torch.nn import attention as port_attention
from mllm_tpu_torch.processor import image as timage
from mllm_tpu_torch.processor import qwen2_vl as tproc

CPU = torch.device("cpu")
IMG, VID, VSTART, VEND = 120, 121, 122, 123
F32_TOL = dict(rtol=1e-4, atol=1e-4)  # the port against JAX, f32
HF_TOL = dict(rtol=2e-3, atol=2e-3)  # against transformers (the JAX tests' tolerance)
QUANT_TOL = 2e-3  # x max |logit|, quantized paths


@pytest.fixture(scope="module", autouse=True)
def kernel_route_at_small_head_dim():
    """The LM's head_dim is 8, which the port's route sends to `sdpa`: here
    it reaches the kernels' plain versions, as the loops do on the card."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_attention, "KERNEL_HEAD_DIMS", (8, 64, 128))
        yield


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """(transformers model, checkpoint directory)."""
    import transformers

    torch.manual_seed(0)
    cfg = transformers.Qwen2VLConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
        rope_theta=10000.0, tie_word_embeddings=False,
        rope_scaling={"type": "mrope", "mrope_section": [1, 1, 2]},
        image_token_id=IMG, video_token_id=VID, vision_start_token_id=VSTART, vision_end_token_id=VEND,
        vision_config=dict(depth=2, embed_dim=32, hidden_size=32, mlp_ratio=2.0, num_heads=4, in_channels=3,
                           patch_size=14, temporal_patch_size=2, spatial_merge_size=2))
    model = transformers.Qwen2VLForConditionalGeneration(cfg).eval()
    d = tmp_path_factory.mktemp("qwen2vl")
    model.save_pretrained(d)
    return model, str(d)


@pytest.fixture(scope="module")
def jm(ckpt):
    _, d = ckpt
    return jvl.load_qwen2_vl(JaxLoader(d), jvl.qwen2_vl_config_from_hf(d), jnp.float32)


@pytest.fixture(scope="module")
def tm(ckpt):
    _, d = ckpt
    return tvl.load_qwen2_vl(SafetensorsLoader(d), tvl.qwen2_vl_config_from_hf(d), device=CPU,
                             dtype=torch.float32)


def _inputs(video=False):
    """(ids [1, S], patches, grid): an image (grid (1, 4, 4), 4 tokens) or a
    video (grid (2, 4, 4), 8 tokens) between text."""
    rng = np.random.default_rng(5 if video else 0)
    grid = (2, 4, 4) if video else (1, 4, 4)
    n = grid[0] * grid[1] * grid[2]
    patches = rng.standard_normal((n, 3 * 2 * 14 * 14)).astype(np.float32)
    pad = VID if video else IMG
    ids = np.array([[10, 20, VSTART] + [pad] * (n // 4) + [VEND, 30, 40, 50]], np.int64)
    return ids, patches, grid


def _pos(ids, grid):
    pos, delta = jvl.get_rope_index(ids[0], [grid], IMG, VID, 2)
    return pos[:, None, :], delta


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


class StubTok:
    """Words and vision specials to ids (both processors see the same ids)."""

    def encode(self, text, bos=False):
        out = []
        for part in text.replace("<|image_pad|>", " <|image_pad|> ").replace("<|video_pad|>",
                                                                            " <|video_pad|> ").split():
            out.append({"<|image_pad|>": IMG, "<|video_pad|>": VID}.get(part, sum(map(ord, part)) % 100))
        return out


# ---------------------------------------------------------------------------
# processors and the on-device preprocess
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hw", [(56, 84), (100, 61), (28, 28)])
def test_image_processor_bit_equal(hw):
    img = np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3), np.uint8)
    want_p, want_g = jimage.Qwen2VLImageProcessor()(img)
    got_p, got_g = timage.Qwen2VLImageProcessor()(img)
    assert got_g == want_g
    np.testing.assert_array_equal(got_p, want_p)


def test_clip_processor_and_helpers_bit_equal():
    img = np.random.default_rng(3).integers(0, 256, (240, 300, 3), np.uint8)
    np.testing.assert_array_equal(timage.ClipImageProcessor()(img), jimage.ClipImageProcessor()(img))
    for h, w in ((1000, 200), (50, 50), (3000, 3000)):
        assert timage.smart_resize(h, w) == jimage.smart_resize(h, w)
    np.testing.assert_array_equal(timage.bicubic_coeff_matrix(97, 56), jimage.bicubic_coeff_matrix(97, 56))
    for a, b in zip(timage.rgb_to_yuv420(img), jimage.rgb_to_yuv420(img)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("video", [False, True])
def test_processor_expansion_equal(video):
    rng = np.random.default_rng(2)
    frames = [rng.integers(0, 255, (56, 56, 3)).astype(np.uint8) for _ in range(4 if video else 1)]
    kw = dict(image_token_id=IMG, video_token_id=VID)
    outs = []
    for mod in (jproc, tproc):
        proc = mod.Qwen2VLProcessor(StubTok(), **kw)
        text = proc.chat_text("what is this?", video=video)
        outs.append(proc(text, videos=frames) if video else proc(text, images=frames[0]))
    want, got = outs
    assert got.grid_thw == want.grid_thw == ((2, 4, 4) if video else (1, 4, 4))
    for f in ("input_ids", "patches", "position_ids"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.mrope_delta == want.mrope_delta


@pytest.mark.parametrize("video", [False, True])
def test_get_rope_index_equal_to_jax_and_hf(ckpt, video):
    hf, _ = ckpt
    ids, _, grid = _inputs(video)
    pos, delta = tvl.get_rope_index(ids[0], [grid], IMG, VID, 2)
    jpos, jdelta = jvl.get_rope_index(ids[0], [grid], IMG, VID, 2)
    np.testing.assert_array_equal(pos, jpos)
    assert delta == jdelta
    kw = {"video_grid_thw" if video else "image_grid_thw": torch.tensor([list(grid)])}
    hf_pos, hf_delta = hf.model.get_rope_index(torch.from_numpy(ids), **kw)
    np.testing.assert_array_equal(pos, hf_pos[:, 0].numpy())
    assert delta == int(hf_delta[0])


def test_device_patchify_equal():
    img = np.random.default_rng(0).integers(0, 256, (2, 56, 84, 3), np.uint8)
    want = jvl.device_patchify(jnp.asarray(img), jimage.CLIP_MEAN, jimage.CLIP_STD)
    got = tvl.device_patchify(_t(img), timage.CLIP_MEAN, timage.CLIP_STD)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_yuv420_to_rgb_equal():
    img = np.random.default_rng(4).integers(0, 256, (2, 28, 42, 3), np.uint8)
    planes = [np.stack(p) for p in zip(*(jimage.rgb_to_yuv420(f) for f in img))]
    want = jax.vmap(jimage.yuv420_to_rgb)(*map(jnp.asarray, planes))
    got = timage.yuv420_to_rgb(*map(_t, planes))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_device_resize_bicubic_within_one_lsb():
    from PIL import Image

    img = np.random.default_rng(6).integers(0, 256, (97, 131, 3), np.uint8)
    vc, hc = timage.bicubic_coeff_matrix(97, 56), timage.bicubic_coeff_matrix(131, 84)
    got = timage.device_resize_bicubic(_t(img), _t(vc), _t(hc)).numpy().astype(int)
    pil = np.asarray(Image.fromarray(img).resize((84, 56), Image.BICUBIC)).astype(int)
    jax_out = np.asarray(jimage.device_resize_bicubic(jnp.asarray(img), jnp.asarray(vc), jnp.asarray(hc)))
    assert np.abs(got - pil).max() <= 1
    assert np.abs(got - jax_out.astype(int)).max() <= 1
    batched = timage.device_resize_bicubic(_t(np.stack([img, img])), _t(vc), _t(hc)).numpy()
    np.testing.assert_array_equal(batched[1], got)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_vision_tower_embeds(ckpt, jm, tm):
    hf, _ = ckpt
    for video in (False, True):
        _, patches, grid = _inputs(video)
        want = np.asarray(jm.visual(jnp.asarray(patches), grid))
        with torch.no_grad():
            got = tm.visual(_t(patches), grid).numpy()
            hf_out = hf.model.visual(torch.from_numpy(patches), grid_thw=torch.tensor([list(grid)])).numpy()
        np.testing.assert_allclose(got, want, **F32_TOL)
        np.testing.assert_allclose(got, hf_out, **HF_TOL)


@pytest.mark.parametrize("video", [False, True])
def test_e2e_logits(ckpt, jm, tm, video):
    hf, _ = ckpt
    ids, patches, grid = _inputs(video)
    pos, _ = _pos(ids, grid)
    want, _ = jm(jnp.asarray(ids, jnp.int32), jm.init_cache(1, 32, jnp.float32), patches=jnp.asarray(patches),
                 grid_thw=grid, positions=jnp.asarray(pos), last_only=False)
    with torch.no_grad():
        got, cache = tm(_t(ids), tm.init_cache(1, 32, torch.float32), patches=_t(patches), grid_thw=grid,
                        positions=_t(pos), last_only=False)
        key = "pixel_values_videos" if video else "pixel_values"
        hf_logits = hf(input_ids=torch.from_numpy(ids), **{key: torch.from_numpy(patches)},
                       **{("video_grid_thw" if video else "image_grid_thw"): torch.tensor([list(grid)])}).logits
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(got.numpy(), hf_logits.numpy(), rtol=2e-3, atol=5e-3)
    assert int(cache.pos) == ids.shape[1]


def _jax_greedy(jm, ids, patches, grid, n, kv_dtype="bf16"):
    pos, delta = _pos(ids, grid)
    cache = jm.init_cache(1, 64, jnp.float32, kv_dtype=kv_dtype)
    logits, cache = jm(jnp.asarray(ids, jnp.int32), cache, patches=jnp.asarray(patches), grid_thw=grid,
                       positions=jnp.asarray(pos), last_only=True)
    toks, rows = [], []
    for i in range(n):
        rows.append(np.asarray(logits)[0, 0])
        toks.append(int(np.argmax(rows[-1])))
        p = np.full((3, 1, 1), ids.shape[1] + delta + i, np.int32)
        logits, cache = jm(jnp.asarray([[toks[-1]]], jnp.int32), cache, positions=jnp.asarray(p), last_only=True)
    return toks, np.stack(rows)


@torch.no_grad()
def _port_greedy(tm, ids, patches, grid, n, kv_dtype="bf16"):
    pos, delta = _pos(ids, grid)
    cache = tm.init_cache(1, 64, torch.float32, kv_dtype=kv_dtype)
    logits, cache = tm(_t(ids), cache, patches=_t(patches), grid_thw=grid, positions=_t(pos), last_only=True)
    toks, rows = [], []
    for i in range(n):
        rows.append(logits[0, 0].numpy())
        toks.append(int(np.argmax(rows[-1])))
        logits, cache = tvl._vl_decode_step(tm, cache, torch.tensor([toks[-1]]), ids.shape[1] + delta + i)
        logits = logits[:, None]
    return toks, np.stack(rows)


def test_greedy_decode_equal_to_jax_and_hf(ckpt, jm, tm):
    hf, _ = ckpt
    ids, patches, grid = _inputs()
    want, want_rows = _jax_greedy(jm, ids, patches, grid, 6)
    got, rows = _port_greedy(tm, ids, patches, grid, 6)
    assert got == want
    np.testing.assert_allclose(rows, want_rows, **F32_TOL)
    with torch.no_grad():
        hf_out = hf.generate(inputs=torch.from_numpy(ids), pixel_values=torch.from_numpy(patches),
                             image_grid_thw=torch.tensor([list(grid)]), max_new_tokens=6, do_sample=False,
                             eos_token_id=None, pad_token_id=0)[0, ids.shape[1]:].numpy()
    assert got == hf_out.tolist()


def _proc_out(mod, video=False):
    ids, patches, grid = _inputs(video)
    pos, delta = _pos(ids, grid)
    return mod.Qwen2VLProcessorOutput(ids.astype(np.int32), patches, grid, pos.astype(np.int32), delta)


@pytest.mark.parametrize("video", [False, True])
def test_vl_generate_eager_and_compiled(jm, tm, video):
    want, _ = jvl.vl_generate(jm, _proc_out(jproc, video), jm.init_cache(1, 64, jnp.float32), max_new_tokens=8)
    got, cache = tvl.vl_generate(tm, _proc_out(tproc, video), tm.init_cache(1, 64, torch.float32),
                                 max_new_tokens=8)
    assert got == want
    ids, patches, grid = _inputs(video)
    pos, delta = _pos(ids, grid)
    jtoks, jn = jvl.vl_generate_compiled(jm, jnp.asarray(ids, jnp.int32), jnp.asarray(patches), grid,
                                         jnp.asarray(pos), jm.init_cache(1, 64, jnp.float32), true_len=ids.shape[1],
                                         max_new_tokens=8, mrope_delta=delta)
    toks, n = tvl.vl_generate_compiled(tm, ids, _t(patches), grid, _t(pos), tm.init_cache(1, 64, torch.float32),
                                       ids.shape[1], 8, mrope_delta=delta, window=3)
    assert int(n) == int(jn) == 8
    assert toks.tolist() == np.asarray(jtoks).tolist() == want


def test_vl_generate_compiled_stops_at_eos(tm):
    ids, patches, grid = _inputs()
    pos, delta = _pos(ids, grid)
    full, _ = tvl.vl_generate(tm, _proc_out(tproc), tm.init_cache(1, 64, torch.float32), 8)
    eos = full[3]
    toks, n = tvl.vl_generate_compiled(tm, ids, _t(patches), grid, _t(pos), tm.init_cache(1, 64, torch.float32),
                                       ids.shape[1], 8, eos_token_id=eos, mrope_delta=delta, window=3)
    stop = full.index(eos) + 1
    assert int(n) == stop and toks[:stop].tolist() == full[:stop] and (toks[stop:] == -1).all()


def test_vtp_prefill_keeps_the_same_tokens(jm, tm):
    ids, patches, grid = _inputs()
    pos, _ = _pos(ids, grid)
    ref, _ = tm(_t(ids), tm.init_cache(1, 32, torch.float32), patches=_t(patches), grid_thw=grid,
                positions=_t(pos), last_only=True)
    full, full_cache = tvl.vtp_prefill(tm, ids, tm.init_cache(1, 32, torch.float32), _t(patches), grid, _t(pos),
                                       keep_ratio=1.0, prune_layer=1)
    np.testing.assert_allclose(full.numpy(), ref[:, 0].detach().numpy(), rtol=2e-4, atol=2e-5)
    assert int(full_cache.pos) == ids.shape[1]
    for keep, n_img in ((0.5, 2), (0.75, 3)):
        want, jcache = jvl.vtp_prefill(jm, ids, jm.init_cache(1, 32, jnp.float32), jnp.asarray(patches), grid,
                                       jnp.asarray(pos), keep_ratio=keep, prune_layer=1)
        got, cache = tvl.vtp_prefill(tm, ids, tm.init_cache(1, 32, torch.float32), _t(patches), grid, _t(pos),
                                     keep_ratio=keep, prune_layer=1)
        assert int(cache.pos) == int(jcache.pos) == ids.shape[1] - (4 - n_img)
        # the kept indices: layer 0's compacted K rows are rows of the unpruned prefill's
        full_k = full_cache.k[0, 0, :, : ids.shape[1]]  # [Hkv, S, D]
        kept = [int(torch.argmin((full_k - row[:, None]).abs().amax(dim=(0, 2))))
                for row in cache.k[0, 0, :, : int(cache.pos)].transpose(0, 1)]
        jk = np.asarray(jcache.k)[0, 0, :, : int(jcache.pos)]
        jkept = [int(np.argmin(np.abs(full_k.numpy() - row[:, None]).max(axis=(0, 2))))
                 for row in jk.transpose(1, 0, 2)]
        is_img = ids[0] == IMG
        assert kept == jkept and kept == sorted(kept)
        assert is_img[kept].sum() == n_img and (~is_img[kept]).sum() == (~is_img).sum()
        np.testing.assert_allclose(cache.k[:, 0, :, : int(cache.pos)].numpy(),
                                   np.asarray(jcache.k)[:, 0, :, : int(jcache.pos)], **F32_TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("wire", ["rgb", "yuv", "raw"])
def test_vl_image_prefill_equal_to_jax(jm, tm, wire):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (1, 56, 56, 3), np.uint8)
    ids, _, grid = _inputs()
    pos, _ = _pos(ids, grid)
    tl = ids.shape[1]
    jargs = (jm, jm.init_cache(1, 32, jnp.float32), jnp.asarray(ids, jnp.int32))
    targs = (tm, tm.init_cache(1, 32, torch.float32), _t(ids))
    if wire == "rgb":
        want, _ = jvl.vl_image_prefill(*jargs, jnp.asarray(img), jnp.asarray(pos), tl, grid)
        got, cache = tvl.vl_image_prefill(*targs, _t(img), _t(pos), tl, grid)
    elif wire == "yuv":
        y, u, v = (p[None] for p in jimage.rgb_to_yuv420(img[0]))
        want, _ = jvl.vl_image_prefill_yuv(*jargs, *map(jnp.asarray, (y, u, v)), jnp.asarray(pos), tl, grid)
        got, cache = tvl.vl_image_prefill_yuv(*targs, *map(_t, (y, u, v)), _t(pos), tl, grid)
    else:
        raw = rng.integers(0, 256, (1, 97, 83, 3), np.uint8)
        vc, hc = jimage.bicubic_coeff_matrix(97, 56), jimage.bicubic_coeff_matrix(83, 56)
        want, _ = jvl.vl_image_prefill_raw(*jargs, jnp.asarray(raw), jnp.asarray(vc), jnp.asarray(hc),
                                           jnp.asarray(pos), tl, grid)
        got, cache = tvl.vl_image_prefill_raw(*targs, _t(raw), _t(vc), _t(hc), _t(pos), tl, grid)
    # raw: the two resizes may differ by 1 LSB on a few pixels (f32 sums in another order)
    tol = dict(rtol=2e-2, atol=2e-2) if wire == "raw" else F32_TOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    assert int(cache.pos) == tl


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_quantized_kv_cache_decode(jm, tm, kv, jax_kernel_arithmetic):
    ids, patches, grid = _inputs()
    n = 6 if kv == "int8" else 4
    want, want_rows = _jax_greedy(jm, ids, patches, grid, n, kv)
    got, rows = _port_greedy(tm, ids, patches, grid, n, kv)
    ref, _ = _port_greedy(tm, ids, patches, grid, n)
    if kv == "int8":
        assert got == want == ref
    else:
        assert got[:2] == want[:2] == ref[:2]
    err = np.abs(rows[:2] - want_rows[:2]).max() / np.abs(want_rows[:2]).max()
    assert err <= QUANT_TOL


@pytest.fixture
def jax_kernel_arithmetic(monkeypatch):
    """The JAX model's quantized-cache attention through the Pallas kernels in
    interpret mode, whose rounding the port's plain versions follow
    (tests/test_torch_kvcache.py)."""
    import mllm_tpu.nn.attention as jattn
    from test_torch_kvcache import _kernel_arithmetic_attend

    orig = jattn.attend_from_cache

    def attend(q, cache, layer_idx, **kw):
        return _kernel_arithmetic_attend(orig, q, cache, layer_idx,
                                         **{"kv_start": None, "window": None, "scale": None, **kw})

    jax.clear_caches()
    monkeypatch.setattr(jattn, "attend_from_cache", attend)
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def wide():
    """(JAX model, the port's on the same f32 weights) at widths the
    quantizers take (in-widths multiples of 64): a JAX `init` tower of width
    64 and a 64-wide LM, bridged (the init's LayerNorm eps 1e-5)."""
    from mllm_tpu.core.config import TextConfig as JaxTextConfig
    from mllm_tpu.models.transformer import CausalLM as JaxCausalLM
    from mllm_tpu_torch.core.config import TextConfig
    from mllm_tpu_torch.models.bridge import qwen2_vl_from_jax_params

    tkw = dict(model_type="qwen2", vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, attention_bias=True, max_position_embeddings=128)
    vkw = dict(depth=2, embed_dim=64, hidden_size=64, mlp_ratio=2.0, num_heads=4)
    ckw = dict(image_token_id=IMG, video_token_id=VID, vision_start_token_id=VSTART, mrope_section=(2, 3, 3))
    jvc = jvl.Qwen2VLVisionConfig(**vkw)
    jmodel = jvl.Qwen2VLForConditionalGeneration(
        jvl.Qwen2VLVisionTower.init(jax.random.PRNGKey(0), jvc),
        JaxCausalLM.init(jax.random.PRNGKey(1), JaxTextConfig(**tkw)),
        jvl.Qwen2VLConfig(text=JaxTextConfig(**tkw), vision=jvc, **ckw))
    tcfg = tvl.Qwen2VLConfig(text=TextConfig(**tkw), vision=tvl.Qwen2VLVisionConfig(**vkw), **ckw)
    return jmodel, qwen2_vl_from_jax_params({k: np.asarray(v) for k, v in jmodel.parameters().items()}, tcfg, CPU,
                                            vision_eps=1e-5)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_model_equal_to_jax(wide, mode, jax_pallas_int4):
    import copy

    from mllm_tpu.ops import quantize_model as jq
    from mllm_tpu_torch.models.bridge import qwen2_vl_from_jax_params
    from mllm_tpu_torch.nn.layers import Int4Linear, QuantLinear
    from mllm_tpu_torch.ops import quantize_model as tq

    jm, tm = wide
    jqm = jq.quantize_model(jm, mode, min_size=1)
    tqm = tq.quantize_model(copy.deepcopy(tm), mode, min_size=1)
    # the JAX walk's structure: every tower and merger Linear quantized, the patch embed float
    want_cls = QuantLinear if mode == "int8" else Int4Linear
    blk = tqm.visual.blocks[0]
    for lin in (blk.qkv, blk.proj, blk.fc1, blk.fc2, tqm.visual.merger.fc1, tqm.visual.merger.fc2):
        assert type(lin) is want_cls
    assert type(tqm.visual.patch_embed) is tvl.PatchEmbed
    bridged = qwen2_vl_from_jax_params({k: np.asarray(v) for k, v in jqm.parameters().items()}, tm.cfg, CPU,
                                       vision_eps=1e-5)
    assert bridged.state_dict().keys() == tqm.state_dict().keys()
    for k, v in bridged.state_dict().items():
        np.testing.assert_array_equal(tqm.state_dict()[k].numpy(), v.numpy())
    ids, patches, grid = _inputs()
    want, want_rows = _jax_greedy(jqm, ids, patches, grid, 5)
    got, rows = _port_greedy(tqm, ids, patches, grid, 5)
    assert got == want
    assert np.abs(rows - want_rows).max() / np.abs(want_rows).max() <= QUANT_TOL


def test_quantize_model_keeps_small_and_odd_width_linears_float(wide):
    import copy

    from mllm_tpu_torch.nn.layers import Linear, QuantLinear
    from mllm_tpu_torch.ops import quantize_model as tq

    q = tq.quantize_model(copy.deepcopy(wide[1]), "int8")  # the default min_size: 65536 weights
    assert all(type(m) is Linear for m in q.visual.blocks.modules() if isinstance(m, (Linear, QuantLinear)))
    assert type(q.visual.merger.fc1) is QuantLinear  # 256 x 256
    q = tq.quantize_model(copy.deepcopy(wide[1]), "int8", min_size=8192)
    blk = q.visual.blocks[0]
    assert type(blk.qkv) is QuantLinear and type(blk.proj) is Linear  # 64 x 64 = 4096 < 8192


@pytest.fixture
def jax_pallas_int4(monkeypatch):
    """The JAX package on its canonical int4 layout, numpy packers
    (tests/test_torch_quant.py)."""
    from mllm_tpu.ops import quantize_model as jqmod
    from mllm_tpu.utils import native as jnative

    monkeypatch.setenv("MLLM_INT4_IMPL", "pallas")
    monkeypatch.setattr(jqmod, "INT4_MIN_PARAMS", 0)
    monkeypatch.setattr(jnative, "repack_int8", lambda w: None)
    monkeypatch.setattr(jnative, "repack_int4", lambda w, group=32: None)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _offline_text(tm, text, n):
    cache = tm.init_cache(1, 64, torch.float32)
    with torch.no_grad():
        logits, cache = tm(_t(text[None]), cache, last_only=True)
        out = []
        for _ in range(n):
            out.append(int(torch.argmax(logits[0, 0])))
            logits, cache = tm(torch.tensor([[out[-1]]]), cache, last_only=True)
    return out


@pytest.mark.parametrize("kv", ["bf16", "int8", "paged"])
def test_engine_serves_image_and_text_requests(jm, tm, kv, request):
    """An image request, a text request and a video request share the two
    slots of the port's engine and of the JAX engine built alike (f32 dense;
    an int8 KV cache, JAX's quantized attention through the interpret
    kernels; f32 paged over a 4-block pool), two decode steps a window: every
    stream equal token for token, and equal to the offline greedy streams where the cache is f32.
    While a request is live its slot's pos_delta is its mrope_delta (0 for
    text)."""
    from mllm_tpu.generation import engine as jeng
    from mllm_tpu_torch.generation.engine import ContinuousEngine, collect

    if kv == "int8":
        request.getfixturevalue("jax_kernel_arithmetic")
    ids, patches, grid = _inputs()
    text = np.array([7, 100, 30, 42, 9], np.int64)
    kw = dict(slots=2, max_len=64, prompt_bucket=16, start_thread=False, eos_token_id=-7, decode_window=2,
              **{"bf16": {}, "int8": {"kv_dtype": "int8"}, "paged": {"paged": 4}}[kv])
    eng = ContinuousEngine(tm, **{"kv_dtype": torch.float32, **kw})
    reqs = [(tproc, False), None, (tproc, True)]
    qs = [eng.submit_vl(_proc_out(*r), 5) if r else eng.submit(text, 5) for r in reqs]
    live_deltas = set()
    for _ in range(12):
        eng.step()
        for slot, r in enumerate(eng.req):
            if r is not None:
                want = r.vl[3] if r.vl is not None else 0
                assert int(eng._state.pos_delta[slot]) == want
                live_deltas.add(want)
    assert len(live_deltas) == 3  # the image's, the text's 0 and the video's were each checked live
    got = [collect(q, timeout=5) for q in qs]
    jeng_ = jeng.ContinuousEngine(jm, **{"kv_dtype": jnp.float32, **kw})
    jq = [jeng_.submit_vl(_proc_out(jproc, r[1]), 5) if r else jeng_.submit(text.astype(np.int32), 5)
          for r in reqs]
    for _ in range(12):
        jeng_.step()
    assert got == [jeng.collect(q, timeout=5) for q in jq]
    if kv != "int8":
        assert got[0] == _jax_greedy(jm, ids, patches, grid, 5)[0]
        assert got[1] == _offline_text(tm, text, 5)
        assert got[2] == _jax_greedy(jm, *_inputs(video=True), 5)[0]


# ---------------------------------------------------------------------------
# loading, the bridge, the route of the tower's attention
# ---------------------------------------------------------------------------


def test_auto_model_any_and_auto_model(ckpt, tm):
    from mllm_tpu_torch.models.registry import auto_model, auto_model_any

    _, d = ckpt
    model, kind = auto_model_any(d, torch.float32, device=CPU)
    assert kind == "qwen2_vl"
    for k, v in tm.state_dict().items():
        assert torch.equal(model.state_dict()[k], v)
    model2, tok, cfg = auto_model(d, torch.float32, device=CPU)
    assert cfg == tm.cfg and tok is None and isinstance(model2, tvl.Qwen2VLForConditionalGeneration)
    q8, _ = auto_model_any(d, torch.float32, quant="int8", device=CPU)
    assert type(q8.visual.blocks[0].qkv).__name__ == "Linear"  # the tower stays float at load, as in JAX
    assert type(q8.lm.blocks[0].attn.q_proj).__name__ == "QuantLinear"


@pytest.mark.parametrize("stacked", [False, True])
def test_bridge_from_jax_params(jm, tm, stacked):
    from mllm_tpu_torch.models.bridge import qwen2_vl_from_jax_params

    src = jm.stack() if stacked else jm
    got = qwen2_vl_from_jax_params({k: np.asarray(v) for k, v in src.parameters().items()}, tm.cfg, CPU)
    assert got.state_dict().keys() == tm.state_dict().keys()
    for k, v in tm.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k


def test_random_init_tower_matches_jax_init_through_the_bridge():
    from mllm_tpu.core.config import TextConfig as JaxTextConfig
    from mllm_tpu.models.transformer import CausalLM as JaxCausalLM
    from mllm_tpu_torch.core.config import TextConfig
    from mllm_tpu_torch.models.bridge import qwen2_vl_from_jax_params

    tkw = dict(model_type="qwen2", vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, attention_bias=True, max_position_embeddings=64)
    vc_kw = dict(depth=2, embed_dim=32, hidden_size=48, num_heads=4)
    jvc = jvl.Qwen2VLVisionConfig(**vc_kw)
    tower = jvl.Qwen2VLVisionTower.init(jax.random.PRNGKey(0), jvc)
    jmodel = jvl.Qwen2VLForConditionalGeneration(
        tower, JaxCausalLM.init(jax.random.PRNGKey(1), JaxTextConfig(**dict(tkw, hidden_size=48))),
        jvl.Qwen2VLConfig(text=JaxTextConfig(**dict(tkw, hidden_size=48)), vision=jvc, mrope_section=(1, 1, 4)))
    tcfg = tvl.Qwen2VLConfig(text=TextConfig(**dict(tkw, hidden_size=48)), vision=tvl.Qwen2VLVisionConfig(**vc_kw),
                             mrope_section=(1, 1, 4))
    port = qwen2_vl_from_jax_params({k: np.asarray(v) for k, v in jmodel.parameters().items()}, tcfg, CPU,
                                    vision_eps=1e-5)
    patches = np.random.default_rng(0).standard_normal((16, 3 * 2 * 14 * 14)).astype(np.float32)
    want = np.asarray(tower(jnp.asarray(patches), (1, 4, 4)))
    got = port.visual(_t(patches), (1, 4, 4)).detach().numpy()
    assert got.shape == (4, 48)
    np.testing.assert_allclose(got, want, **F32_TOL)
    fresh = tvl.Qwen2VLVisionTower.init(tcfg.vision, device=CPU)
    assert np.isfinite(fresh(_t(patches), (1, 4, 4)).detach().numpy()).all()


def test_tower_attention_reaches_the_flash_kernel_on_a_card(monkeypatch):
    """attend_padded_head on a (pretend) card sends head_dim 80, non-causal,
    to the flash wrapper, with no quiet detour to sdpa: a failing wrapper
    raises through it."""
    class Reached(Exception):
        pass

    def failing(*a, **kw):
        raise Reached(kw)

    monkeypatch.setattr(port_attention, "flash_attention", failing)
    monkeypatch.setattr(port_attention, "sdpa", lambda *a, **kw: pytest.fail("took sdpa"))
    q = torch.empty(1, 1444, 16, 80, device="meta", dtype=torch.bfloat16)
    k = torch.empty(1, 16, 1444, 80, device="meta", dtype=torch.bfloat16)
    with pytest.raises(Reached) as e:
        port_attention.attend_padded_head(q, k, k, causal=False)
    assert e.value.args[0]["causal"] is False
    assert port_attention.attention_route(1444, head_dim=80) == "sdpa"  # the LM's route keeps 80 on sdpa
    # a head_dim the kernel does not take, or a causal call, is sdpa's
    monkeypatch.setattr(port_attention, "sdpa", lambda *a, **kw: "sdpa")
    q96 = torch.empty(1, 1444, 16, 96, device="meta", dtype=torch.bfloat16)
    k96 = torch.empty(1, 16, 1444, 96, device="meta", dtype=torch.bfloat16)
    assert port_attention.attend_padded_head(q96, k96, k96, causal=False) == "sdpa"
    assert port_attention.attend_padded_head(q, k, k, causal=True) == "sdpa"


def test_flash_kernel_takes_head_dim_80_and_the_others_do_not():
    from mllm_tpu_torch.ops._common import FLASH_HEAD_DIMS, KERNEL_HEAD_DIMS, check_kernel_args

    q = torch.empty(1, 8, 16, 80, device="meta", dtype=torch.bfloat16)
    k = torch.empty(1, 16, 8, 80, device="meta", dtype=torch.bfloat16)
    for dims in (FLASH_HEAD_DIMS, KERNEL_HEAD_DIMS):  # meta is no card: the device check comes first
        with pytest.raises(ValueError, match="CUDA card"):
            check_kernel_args("x", q, k, k, dims)
    assert 80 in FLASH_HEAD_DIMS and 80 not in KERNEL_HEAD_DIMS
    from mllm_tpu_torch.ops.flash_attention import flash_attention

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(*s, generator=g) for s in ((1, 40, 4, 80), (1, 4, 40, 80), (1, 4, 40, 80)))
    np.testing.assert_allclose(flash_attention(q, k, v, causal=False, kv_valid_len=33).numpy(),
                               port_attention.sdpa(q, k, v, causal=False, kv_valid_len=33).numpy(),
                               rtol=1e-5, atol=1e-5)
