"""The port's Qwen2.5-VL (the windowed vision tower, its gated blocks, the
window permutation and its reverse) on the CPU against the JAX package on
the same weights, and against transformers where the JAX tests use it
(tests/test_qwen2_5_vl.py).

One tiny checkpoint per module (transformers' Qwen2_5_VLForConditionalGeneration
at the JAX tests' geometry: hidden 32, 2 layers, a 3-block tower of width 32
with 56 px windows and block 1 full-attention; a 128-entry vocabulary), loaded
by both packages in f32; inputs from numpy seeds.

Tolerances: window indices exactly; f32 tower embeds and logits within 1e-4
abs + 1e-4 rel of JAX and the JAX tests' 3e-3 of transformers; greedy tokens
exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mllm_tpu.core.param_loader import SafetensorsLoader as JaxLoader
from mllm_tpu.models import qwen2_5_vl as jvl25
from mllm_tpu.models import qwen2_vl as jvl
from mllm_tpu_torch.core.param_loader import SafetensorsLoader
from mllm_tpu_torch.models import qwen2_5_vl as tvl25
from mllm_tpu_torch.models import qwen2_vl as tvl
from mllm_tpu_torch.nn import attention as port_attention

CPU = torch.device("cpu")
IMG, VID, VSTART = 120, 121, 122
F32_TOL = dict(rtol=1e-4, atol=1e-4)
HF_TOL = dict(rtol=3e-3, atol=3e-3)


@pytest.fixture(scope="module", autouse=True)
def kernel_route_at_small_head_dim():
    """head_dim 8 reaches the kernels' plain versions (as the other files)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_attention, "KERNEL_HEAD_DIMS", (8, 64, 128))
        yield


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    import transformers

    torch.manual_seed(0)
    cfg = transformers.Qwen2_5_VLConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
        rope_theta=10000.0, tie_word_embeddings=False,
        rope_scaling={"type": "mrope", "mrope_section": [1, 1, 2]},
        image_token_id=IMG, video_token_id=VID, vision_start_token_id=VSTART, vision_end_token_id=123,
        vision_config=dict(depth=3, hidden_size=32, out_hidden_size=32, intermediate_size=48, num_heads=4,
                           in_channels=3, patch_size=14, temporal_patch_size=2, spatial_merge_size=2,
                           window_size=56, fullatt_block_indexes=[1]))
    model = transformers.Qwen2_5_VLForConditionalGeneration(cfg).eval()
    d = tmp_path_factory.mktemp("q25vl")
    model.save_pretrained(d)
    return model, str(d)


@pytest.fixture(scope="module")
def jm(ckpt):
    _, d = ckpt
    base, vcfg = jvl25.qwen2_5_vl_configs_from_hf(d)
    return jvl25.load_qwen2_5_vl(JaxLoader(d), base, vcfg, jnp.float32)


@pytest.fixture(scope="module")
def tm(ckpt):
    _, d = ckpt
    base, vcfg = tvl25.qwen2_5_vl_configs_from_hf(d)
    return tvl25.load_qwen2_5_vl(SafetensorsLoader(d), base, vcfg, device=CPU, dtype=torch.float32)


def _t(a):
    return torch.as_tensor(np.array(a))


def _image(grid, seed):
    rng = np.random.default_rng(seed)
    n = grid[0] * grid[1] * grid[2]
    patches = rng.standard_normal((n, 3 * 2 * 14 * 14)).astype(np.float32)
    ids = np.array([[10, 20, VSTART] + [IMG] * (n // 4) + [30, 40, 50]], np.int64)
    pos, delta = jvl.get_rope_index(ids[0], [grid], IMG, VID, 2)
    return ids, patches, pos[:, None, :], delta


@pytest.mark.parametrize("grid", [(1, 6, 8), (1, 4, 4), (2, 8, 6)])
def test_window_index_equal(grid):
    for window in (56, 112):
        got, got_ids = tvl25.get_window_index(grid, window, 14, 2)
        want, want_ids = jvl25.get_window_index(grid, window, 14, 2)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_ids, want_ids)
        assert sorted(got.tolist()) == list(range(grid[0] * grid[1] * grid[2] // 4))


@pytest.mark.parametrize("grid", [(1, 6, 8), (2, 4, 4)])
def test_windowed_tower_embeds(ckpt, jm, tm, grid):
    hf, _ = ckpt
    _, patches, _, _ = _image(grid, 0)
    want = np.asarray(jm.visual(jnp.asarray(patches), grid))
    with torch.no_grad():
        got = tm.visual(_t(patches), grid).numpy()
        ref = hf.model.visual(torch.from_numpy(patches), grid_thw=torch.tensor([list(grid)])).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)
    np.testing.assert_allclose(got, ref, **HF_TOL)


def test_e2e_logits(ckpt, jm, tm):
    hf, _ = ckpt
    grid = (1, 4, 4)
    ids, patches, pos, _ = _image(grid, 1)
    want, _ = jm(jnp.asarray(ids, jnp.int32), jm.init_cache(1, 32, jnp.float32), patches=jnp.asarray(patches),
                 grid_thw=grid, positions=jnp.asarray(pos), last_only=False)
    with torch.no_grad():
        got, _ = tm(_t(ids), tm.init_cache(1, 32, torch.float32), patches=_t(patches), grid_thw=grid,
                    positions=_t(pos), last_only=False)
        ref = hf(input_ids=torch.from_numpy(ids), pixel_values=torch.from_numpy(patches),
                 image_grid_thw=torch.tensor([list(grid)])).logits.numpy()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(got.numpy(), ref, **HF_TOL)


def test_greedy_generation_and_engine(jm, tm):
    from mllm_tpu.processor.qwen2_vl import Qwen2VLProcessorOutput as JaxOut
    from mllm_tpu_torch.generation.engine import ContinuousEngine, collect
    from mllm_tpu_torch.processor.qwen2_vl import Qwen2VLProcessorOutput

    grid = (1, 4, 4)
    ids, patches, pos, delta = _image(grid, 4)
    want, _ = jvl.vl_generate(jm, JaxOut(ids.astype(np.int32), patches, grid, pos.astype(np.int32), delta),
                              jm.init_cache(1, 64, jnp.float32), max_new_tokens=6)
    out = Qwen2VLProcessorOutput(ids.astype(np.int32), patches, grid, pos.astype(np.int32), delta)
    got, _ = tvl.vl_generate(tm, out, tm.init_cache(1, 64, torch.float32), max_new_tokens=6)
    assert got == want
    toks, n = tvl.vl_generate_compiled(tm, ids, _t(patches), grid, _t(pos), tm.init_cache(1, 64, torch.float32),
                                       ids.shape[1], 6, mrope_delta=delta, window=4)
    assert toks.tolist() == want and int(n) == 6
    eng = ContinuousEngine(tm, slots=2, max_len=64, prompt_bucket=16, kv_dtype=torch.float32, start_thread=False,
                           eos_token_id=-7)
    q = eng.submit_vl(out, 6)
    for _ in range(8):
        eng.step()
    assert collect(q, timeout=5) == want


def test_auto_model_any_and_bridge(ckpt, jm, tm):
    from mllm_tpu_torch.models.bridge import qwen2_vl_from_jax_params
    from mllm_tpu_torch.models.registry import auto_model_any

    _, d = ckpt
    model, kind = auto_model_any(d, torch.float32, device=CPU)
    assert kind == "qwen2_5_vl" and isinstance(model.visual, tvl25.Qwen25VLVisionTower)
    _, vcfg = tvl25.qwen2_5_vl_configs_from_hf(d)
    bridged = qwen2_vl_from_jax_params({k: np.asarray(v) for k, v in jm.parameters().items()}, tm.cfg, CPU,
                                       vision_cfg=vcfg)
    for m in (model, bridged):
        assert m.state_dict().keys() == tm.state_dict().keys()
        for k, v in tm.state_dict().items():
            assert torch.equal(m.state_dict()[k], v), k


def test_published_3b_config_and_odd_width_down_stays_float(tmp_path):
    """Qwen2.5-VL-3B's published config.json (Qwen/Qwen2.5-VL-3B-Instruct) is
    read as the JAX package reads it; quantize_model leaves the tower's
    3420-wide `down` float (in-width not a multiple of 64) and quantizes the
    rest, at full vision width with the depth cut to 1."""
    import copy
    import dataclasses
    import json

    from mllm_tpu_torch.nn.layers import Linear, QuantLinear
    from mllm_tpu_torch.ops.quantize_model import quantize_model

    cfg = {"model_type": "qwen2_5_vl", "vocab_size": 151936, "hidden_size": 2048, "intermediate_size": 11008,
           "num_hidden_layers": 36, "num_attention_heads": 16, "num_key_value_heads": 2,
           "max_position_embeddings": 128000, "rope_theta": 1000000.0, "tie_word_embeddings": True,
           "rms_norm_eps": 1e-6, "rope_scaling": {"type": "mrope", "mrope_section": [16, 24, 24]},
           "vision_config": {"depth": 32, "hidden_act": "silu", "hidden_size": 1280, "intermediate_size": 3420,
                             "num_heads": 16, "in_chans": 3, "out_hidden_size": 2048, "patch_size": 14,
                             "spatial_merge_size": 2, "spatial_patch_size": 14, "window_size": 112,
                             "fullatt_block_indexes": [7, 15, 23, 31], "tokens_per_second": 2,
                             "temporal_patch_size": 2}}
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    base, vcfg = tvl25.qwen2_5_vl_configs_from_hf(str(tmp_path))
    jbase, jvcfg = jvl25.qwen2_5_vl_configs_from_hf(str(tmp_path))
    assert dataclasses.asdict(vcfg) == dataclasses.asdict(jvcfg)
    assert base.mrope_section == jbase.mrope_section == (16, 24, 24)
    assert base.text.hidden_size == 2048 and base.text.tie_word_embeddings and base.text.num_key_value_heads == 2
    tower = tvl25.Qwen25VLVisionTower(dataclasses.replace(vcfg, depth=1), device="meta", dtype=torch.bfloat16)
    q = quantize_model(copy.deepcopy(tower), "int8", on_device=True)
    blk = q.blocks[0]
    assert type(blk.down) is Linear and all(type(x) is QuantLinear for x in (blk.qkv, blk.proj, blk.gate, blk.up))
