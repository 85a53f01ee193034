"""Tensor and data parallelism of the port (`mllm_tpu_torch/parallel/heads.py`,
`sharding.py`, `multihost.py`, the engine's `mesh=` over slot caches, a paged
pool and image requests, int4 weights cut on the canonical layout and the
int4-mixed model) in one gloo world of 4 CPU ranks
(tests/torch_dist_cases.py:tp_cases), against the port's single-process
results and the JAX functions of `tests/test_parallel.py` (each called once,
on 2 or 4 of the 8 forced CPU devices, or on one: the single-chip paged and
VL engines).

Tolerances (f32): losses 1e-5 relative; logits, updated parameters 1e-5 x
max|.|; greedy tokens equal.
"""

import logging

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_dist_cases as cases
from mllm_tpu.core.config import TextConfig as JaxTextConfig
from mllm_tpu.models.transformer import CausalLM as JaxCausalLM
from mllm_tpu_torch.parallel import heads as port_heads
from mllm_tpu_torch.parallel.sharding import param_spec

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128, eos_token_id=-3)
FLAGSHIP = dict(vocab_size=128, hidden_size=192, intermediate_size=256, num_hidden_layers=2,
                num_attention_heads=12, num_key_value_heads=2, head_dim=16, max_position_embeddings=128,
                eos_token_id=-3)
ENGINE = dict(vocab_size=97, hidden_size=96, intermediate_size=128, num_hidden_layers=2, num_attention_heads=6,
              num_key_value_heads=2, head_dim=16, max_position_embeddings=256, eos_token_id=-9)
HYBRID = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=4, head_dim=16, max_position_embeddings=64, eos_token_id=-3)
INT4 = dict(vocab_size=128, hidden_size=128, intermediate_size=512, num_hidden_layers=2, num_attention_heads=12,
            num_key_value_heads=2, head_dim=64, max_position_embeddings=128, eos_token_id=-3)
TOL = 1e-5
VL_IMG = 120  # the tiny Qwen2-VL's image pad id; video, vision start and end follow it


def _jax(cfg_kw, seed):
    return JaxCausalLM.init(jax.random.PRNGKey(seed), JaxTextConfig(**cfg_kw))


def _params(jm):
    return {k: np.asarray(v) for k, v in jm.parameters().items()}


@pytest.fixture(scope="module")
def jax_models():
    return {"tiny": _jax(TINY, 0), "flagship": _jax(FLAGSHIP, 1), "engine": _jax(ENGINE, 5),
            "hybrid": _jax(HYBRID, 2), "int4": _jax(INT4, 7)}


@pytest.fixture(scope="module")
def vl_ckpt(tmp_path_factory):
    """(transformers model, checkpoint directory): the tiny Qwen2-VL of
    tests/test_torch_qwen2_vl.py (4 / 2 heads of 8, a 2-block tower)."""
    import transformers

    torch.manual_seed(0)
    cfg = transformers.Qwen2VLConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
        rope_theta=10000.0, tie_word_embeddings=False,
        rope_scaling={"type": "mrope", "mrope_section": [1, 1, 2]},
        image_token_id=VL_IMG, video_token_id=VL_IMG + 1, vision_start_token_id=VL_IMG + 2,
        vision_end_token_id=VL_IMG + 3,
        vision_config=dict(depth=2, embed_dim=32, hidden_size=32, mlp_ratio=2.0, num_heads=4, in_channels=3,
                           patch_size=14, temporal_patch_size=2, spatial_merge_size=2))
    model = transformers.Qwen2VLForConditionalGeneration(cfg).eval()
    d = tmp_path_factory.mktemp("qwen2vl_tp")
    model.save_pretrained(d)
    return model, str(d)


def _vl_request():
    """(ids [1, S], patches, grid, M-RoPE positions [3, 1, S], delta): an
    image of grid (1, 4, 4), 4 tokens, between text."""
    from mllm_tpu.models.qwen2_vl import get_rope_index

    rng = np.random.default_rng(0)
    grid = (1, 4, 4)
    patches = rng.standard_normal((16, 3 * 2 * 14 * 14)).astype(np.float32)
    ids = np.array([[10, 20, VL_IMG + 2] + [VL_IMG] * 4 + [VL_IMG + 3, 30, 40, 50]], np.int64)
    pos, delta = get_rope_index(ids[0], [grid], VL_IMG, VL_IMG + 1, 2)
    return ids, patches, grid, np.asarray(pos, np.int64)[:, None, :], int(delta)


@pytest.fixture(scope="module")
def inputs(vl_ckpt):
    rng = np.random.default_rng(0)
    return {"fwd_ids": rng.integers(0, 128, (2, 8)), "train_ids": rng.integers(0, 128, (4, 16)),
            "train_tgt": rng.integers(0, 128, (4, 16)), "gen_ids": rng.integers(0, 128, (2, 12)),
            "quant_ids": rng.integers(0, 128, (2, 10)), "hybrid_ids": rng.integers(0, 128, (4, 8)),
            "engine_prompts": [np.arange(5) % 97, (np.arange(9) * 3) % 97],
            "paged_prompts": [np.arange(5) % 97, (np.arange(9) * 3) % 97, (np.arange(12) * 7 + 1) % 97],
            "vl_dir": vl_ckpt[1], "vl_request": _vl_request(), "vl_text": np.array([7, 100, 30, 42, 9], np.int64),
            "int4_ids": rng.integers(0, 128, (2, 10)),
            "int4_prompts": [np.arange(5) * 11 % 128, (np.arange(9) * 5 + 3) % 128, (np.arange(12) * 7 + 1) % 128]}


@pytest.fixture(scope="module")
def world(jax_models, inputs):
    models = {"tiny": (_params(jax_models["tiny"]), TINY), "flagship": (_params(jax_models["flagship"]), FLAGSHIP),
              "engine": (_params(jax_models["engine"]), ENGINE), "hybrid": (_params(jax_models["hybrid"]), HYBRID),
              "int4": (_params(jax_models["int4"]), INT4)}
    return cases.run_world(cases.tp_cases, 4, models, inputs)


def test_tp_forward_matches_single_process(world):
    assert world["tp4_forward_err"] < TOL
    assert world["tp4_local_kv_heads"] == 1  # 2 kv heads expanded to 4, one a rank


def test_dp_tp_sgd_step_matches_single_process(world):
    loss, plain = world["sgd_loss"]
    assert abs(loss - plain) <= TOL * abs(plain)
    assert world["sgd_state_err"] < TOL
    assert world["sgd_losses"][-1] < world["sgd_losses"][0]


def test_sharded_lora_finetune_matches_single_process(world):
    loss, plain = world["lora_loss"]
    assert abs(loss - plain) <= TOL * abs(plain)
    assert world["lora_state_err"] < TOL
    assert world["add_lora_on_shard_raises"]


def test_sharded_generate_matches_jax(world, jax_models, inputs, caplog):
    """Flagship head ratio: the port at tp 2 and 4 (heads padded, one kv head
    a rank at tp 4, no dropped sharding) against JAX `sharded_generate` at
    tp 2 and the single-device greedy loop."""
    from mllm_tpu.parallel.sharding import make_mesh, sharded_generate

    mesh = make_mesh(dp=1, tp=2, devices=jax.devices("cpu")[:2])
    with caplog.at_level(logging.WARNING, logger="mllm_tpu"):
        want = np.asarray(sharded_generate(jax_models["flagship"], inputs["gen_ids"].astype(np.int32), mesh, 8, 64))
    assert "sharding dropped" not in caplog.text
    np.testing.assert_array_equal(world["gen_tp2"], want)
    np.testing.assert_array_equal(world["gen_tp4"], want)
    np.testing.assert_array_equal(world["gen_single"], want)
    assert world["gen_dropped_warnings"] == 0
    assert world["gen_tp4_cache_heads"] == 1


def test_tp_sharded_int8_generate_matches_jax(world, jax_models, inputs):
    from mllm_tpu.ops.quantize_model import quantize_model
    from mllm_tpu.parallel.sharding import make_mesh, sharded_generate

    qmodel = quantize_model(jax_models["tiny"], "int8", min_size=1, quant_embed_head=False)
    mesh = make_mesh(dp=1, tp=2, devices=jax.devices("cpu")[:2])
    want = np.asarray(sharded_generate(qmodel, inputs["quant_ids"].astype(np.int32), mesh, 6, 64))
    local, full = world["quant_leaf_cols"]
    assert local == full // 2
    np.testing.assert_array_equal(world["quant_tp2"], want)
    np.testing.assert_array_equal(world["quant_single"], want)


def test_tp_sharded_int8_a8_generate_matches_jax(world, jax_models, inputs):
    """W8A8 (`int8-a8`) at tp=2: the o / down products of every prefill go
    through the row-parallel A8 path (the whole row's amax, int32 partial
    sums), whose logits equal the unsharded model's, and the tokens equal
    JAX's GSPMD `sharded_generate`."""
    from mllm_tpu.ops.quantize_model import quantize_model
    from mllm_tpu.parallel.sharding import make_mesh, sharded_generate

    qmodel = quantize_model(jax_models["tiny"], "int8-a8", min_size=1, quant_embed_head=False)
    mesh = make_mesh(dp=1, tp=2, devices=jax.devices("cpu")[:2])
    want = np.asarray(sharded_generate(qmodel, inputs["quant_ids"].astype(np.int32), mesh, 6, 64))
    assert world["a8_row_calls"] == 2 * TINY["num_hidden_layers"]  # o_proj and down_proj of each block
    assert world["a8_prefill_err"] < TOL
    np.testing.assert_array_equal(world["a8_tp2"], want)
    np.testing.assert_array_equal(world["a8_single"], want)


@pytest.fixture
def jax_xla_int4(monkeypatch):
    """The JAX package's default int4 impl (the n-axis layout, which its
    GSPMD cuts over tp) with its numpy packers."""
    import mllm_tpu.utils.native as jnative

    monkeypatch.setenv("MLLM_INT4_IMPL", "xla")
    monkeypatch.setattr(jnative, "repack_int8", lambda w: None)
    monkeypatch.setattr(jnative, "repack_int4", lambda w, group=32: None)


_jax_step = jax.jit(lambda m, ids, c: m(ids, c, last_only=True))


def _jax_greedy(model, ids, steps: int, max_len: int) -> np.ndarray:
    """The single-device greedy loop of tests/test_parallel.py (jitted)."""
    cache = model.init_cache(ids.shape[0], max_len, jnp.float32)
    logits, cache = _jax_step(model, jnp.asarray(ids, jnp.int32), cache)
    out = [np.argmax(np.asarray(logits)[:, -1], -1)]
    for _ in range(steps - 1):
        logits, cache = _jax_step(model, jnp.asarray(out[-1], jnp.int32)[:, None], cache)
        out.append(np.argmax(np.asarray(logits)[:, -1], -1))
    return np.stack(out, 1)


@pytest.mark.parametrize("mode", ["int4", "int4-mixed"])
def test_tp_sharded_int4_generate_matches_jax(world, jax_models, inputs, mode, jax_xla_int4):
    """The int4 model (every projection int4 on the canonical layout, one
    FusedInt4MLP a block, the tied int4 head) and the int4-mixed one
    (attention int8) at tp 2 and at tp 4 (12 / 2 heads padded to 12 / 4):
    greedy tokens equal the port's single process and the JAX package's
    single-device int4 model (`test_tp_sharded_quantized_generate[int4]`'s
    reference, on its default n-axis layout: the same quantized values)."""
    from mllm_tpu.ops.quantize_model import quantize_model

    kw = dict(attn_quant="int8") if mode == "int4-mixed" else {}
    want = _jax_greedy(quantize_model(jax_models["int4"], "int4", min_size=1, **kw), inputs["int4_ids"], 6, 64)
    assert len(set(want.ravel().tolist())) > 2  # not an echo
    for key in ("single", "tp2", "tp4"):
        np.testing.assert_array_equal(world[f"{mode}_{key}"], want, err_msg=key)


@pytest.mark.parametrize("mode,kind,tp", [("int4", "slot", 2), ("int4", "paged", 4), ("int4-mixed", "slot", 2)])
def test_engine_tp_int4_matches_single(world, mode, kind, tp):
    """The engine over the int4 (and int4-mixed) model cut over tp: slot
    caches at tp 2, a one-block paged pool (a request requeued) at tp 4 with
    the heads padded; tokens equal the single-process engine's and every
    rank's agree."""
    want, requeued = world[f"{mode}_engine_{kind}_single"]
    assert all(len(w) == 5 for w in want)
    assert world[f"{mode}_engine_{kind}_tp{tp}"] == (want, requeued)
    assert world[f"{mode}_engine_{kind}_tp{tp}_ranks_agree"]
    assert (requeued > 0) == (kind == "paged")


@pytest.mark.parametrize("tp", [2, 4])
def test_int4_leaves_are_cut_over_tp(world, tp):
    """Each rank holds 1/tp of every cut int4 leaf: the columns of q/k/v, the
    fused MLP's gate/up and the head's proj (the 512-padded vocab), the live
    input channels of o_proj, the fused MLP's down rows and the table's rows."""
    cuts = world[f"int4_cuts_tp{tp}"]
    assert len(cuts) == 2 * 6 + 2
    for name, (local, whole) in cuts.items():
        assert local * tp == whole, (name, local, whole)


def test_int4_cut_dropped_where_k_does_not_divide(world):
    """The tiny model in int4 at tp 2: o_proj's K / tp = 32 is no multiple
    of 64 (whole groups in each nibble half), so each block's attention stays
    whole with the "sharding dropped" warning while its MLP (unfused int4, K
    / tp = 64) is cut; greedy tokens equal the single process's."""
    assert world["tiny_int4_kept"] == (True, "RowParallelLinear")
    assert world["tiny_int4_dropped"] >= TINY["num_hidden_layers"]
    np.testing.assert_array_equal(world["tiny_int4_tp2"], world["tiny_int4_single"])


def test_engine_tp_matches_jax(world, jax_models, inputs):
    from mllm_tpu.generation.engine import ContinuousEngine, collect
    from mllm_tpu.parallel.heads import pad_heads_for_tp
    from mllm_tpu.parallel.sharding import make_mesh, shard_model

    mesh = make_mesh(dp=1, tp=2, devices=jax.devices("cpu")[:2])
    eng = ContinuousEngine(shard_model(pad_heads_for_tp(jax_models["engine"], 2), mesh), slots=2, max_len=64,
                           prompt_bucket=16, kv_dtype=jnp.float32, start_thread=False, decode_window=4, mesh=mesh)
    qs = [eng.submit(np.asarray(p, np.int32), 5) for p in inputs["engine_prompts"]]
    for _ in range(20):
        eng.step()
    want = [collect(q, timeout=5) for q in qs]
    assert all(len(w) == 5 for w in want)
    for key in ("engine_single", "engine_tp2", "engine_tp4"):
        assert world[key] == want, key
    assert world["engine_tp2_ranks_agree"] and world["engine_tp4_ranks_agree"]


def test_engine_tp_paged_matches_jax(world, jax_models, inputs):
    """The engine over a paged pool at tp 2 (pools of 4 and 1 blocks) and tp
    4 (heads padded, a 1-block pool): each rank's pool holds its kv heads of
    every block; with one block for two slots a request is requeued; tokens
    equal the single-process paged engines' and the JAX single-chip paged
    engine's, and every rank's tokens, requeues and block table at every
    step agree."""
    from mllm_tpu.generation.engine import ContinuousEngine, collect

    eng = ContinuousEngine(jax_models["engine"], slots=2, max_len=64, prompt_bucket=16, kv_dtype=jnp.float32,
                           start_thread=False, decode_window=4, paged=1)
    qs = [eng.submit(np.asarray(p, np.int32), 5) for p in inputs["paged_prompts"]]
    for _ in range(24):
        eng.step()
    want = [collect(q, timeout=5) for q in qs]
    assert all(len(w) == 5 for w in want)
    for key in ("paged_single_1", "paged_single_4", "paged_tp2_4", "paged_tp2_1", "paged_tp4_1"):
        assert world[key] == want, key
    for key in ("paged_tp2_4", "paged_tp2_1", "paged_tp4_1"):
        assert world[key + "_ranks_agree"], key
    assert world["paged_tp2_1_requeued"] > 0 and world["paged_tp4_1_requeued"] > 0
    assert world["paged_tp2_1_requeued"] == world["paged_single_1_requeued"]
    assert world["paged_tp2_4_requeued"] == 0
    assert (world["paged_tp2_4_pool_heads"], world["paged_tp4_1_pool_heads"]) == (1, 1)  # 2 kv heads; 4 padded


def test_shard_slot_cache_cuts_the_paged_pool(world):
    """shard_slot_cache on a PagedKVCache (tp 2, 4 kv heads, 3 blocks and
    the sink): each rank's k_store is its two kv heads of every block; the
    block table (device and host) and the write heads are the same objects,
    as the JAX `shard_slot_cache` splits the pool's kv-head axis and keeps
    the table and heads replicated."""
    from mllm_tpu.kv.cache import PagedKVCache
    from mllm_tpu.parallel.sharding import make_mesh, shard_slot_cache

    mesh = make_mesh(dp=1, tp=2, devices=jax.devices("cpu")[:2])
    jc = shard_slot_cache(PagedKVCache.init(2, 2, 256, 4, 16, jnp.float32, n_blocks=3), mesh)
    assert jc.k.sharding.spec == P(None, None, "tp", None, None) and jc.table.sharding.spec == P()
    cut = world["paged_cut"]
    assert cut["shape"] == (2, 4, 2, 128, 16)  # layers, 3 blocks + the sink, 2 of 4 kv heads, rows, head_dim
    assert cut["equal"] and cut["shared"] == (True, True, True)


def test_shard_model_raises_where_tp_does_not_divide_the_heads(world):
    """12 q / 2 kv heads at tp 4 without pad_heads_for_tp, and the tiny
    Qwen2-VL (4 / 2) at tp 4: ValueError naming pad_heads_for_tp, raised
    before any shard is built (no rank holds 0 kv heads)."""
    assert world["shard_12_2_tp4"] is not None and "pad_heads_for_tp" in world["shard_12_2_tp4"]
    assert world["vl_tp4_raises"] is not None and "2 kv heads" in world["vl_tp4_raises"]


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_engine_tp_vl_matches_jax(world, vl_ckpt, inputs, kv, request):
    """A tiny Qwen2-VL at tp 2 (its LM cut, its tower whole on each rank):
    an image request and text requests through the engine over f32 and int8
    slot caches give the single-process engine's tokens and the JAX
    single-chip engine's (int8: JAX's quantized attention through the
    interpret kernels, as tests/test_torch_qwen2_vl.py runs it); each
    rank's cache holds 1 of the 2 kv heads."""
    from mllm_tpu.core.param_loader import SafetensorsLoader
    from mllm_tpu.generation.engine import ContinuousEngine, collect
    from mllm_tpu.models import qwen2_vl as jvl
    from mllm_tpu.processor.qwen2_vl import Qwen2VLProcessorOutput

    if kv == "int8":
        request.getfixturevalue("jax_kernel_arithmetic")
    d = vl_ckpt[1]
    jm = jvl.load_qwen2_vl(SafetensorsLoader(d), jvl.qwen2_vl_config_from_hf(d), jnp.float32)
    ids, patches, grid, pos, delta = inputs["vl_request"]
    order = {"f32": ("text", "image", "text"), "int8": ("image", "text")}[kv]
    eng = ContinuousEngine(jm, slots=2, max_len=64, prompt_bucket=16, start_thread=False, eos_token_id=-7,
                           decode_window=2, kv_dtype=jnp.float32 if kv == "f32" else kv)
    proc = Qwen2VLProcessorOutput(ids.astype(np.int32), patches, grid, pos.astype(np.int32), delta)
    qs = [eng.submit_vl(proc, 5) if k == "image" else eng.submit(inputs["vl_text"].astype(np.int32), 5)
          for k in order]
    for _ in range(12):
        eng.step()
    want = [collect(q, timeout=5) for q in qs]
    assert all(len(w) == 5 for w in want)
    assert world[f"vl_single_{kv}"] == want
    assert world[f"vl_tp2_{kv}"] == want
    assert world[f"vl_tp2_{kv}_ranks_agree"]
    assert world[f"vl_tp2_{kv}_cache_heads"] == 1
    assert world["vl_shard"] == dict(local_heads=(2, 1), tower_shared=True, full_heads=(4, 2))


def test_engine_tp_numbers_mixed_text_and_image_requests(world):
    """Under a mesh, text, image, text submitted on every rank are numbered
    0, 1, 2 on every rank (submit_vl numbers its request and, off rank 0,
    registers its queue by that number), so each rank's queues receive the
    tokens of rank 0's request of the same number."""
    assert sorted(world["vl_tp2_f32_admitted"]) == [(0, False), (1, True), (2, False)]
    assert sorted(world["vl_tp2_int8_admitted"]) == [(0, True), (1, False)]
    assert world["vl_tp2_f32_ranks_agree"] and world["vl_tp2_int8_ranks_agree"]


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


def test_hybrid_mesh_and_host_batch_match_jax(world, jax_models, inputs):
    from mllm_tpu.parallel.multihost import host_local_batch, hybrid_mesh
    from mllm_tpu.parallel.sharding import sgd_train_step, shard_model

    mesh = hybrid_mesh(ici={"tp": 2}, dcn={"dp": 2}, devices=jax.devices("cpu")[:4])
    ids = inputs["hybrid_ids"].astype(np.int32)
    with jax.set_mesh(mesh):
        _, loss = sgd_train_step(shard_model(jax_models["hybrid"], mesh), host_local_batch(ids, mesh, "dp"),
                                 host_local_batch(np.roll(ids, -1, axis=1), mesh, "dp"))
    assert world["hybrid_dims"] == (("dp", "tp"), (2, 2))
    assert world["hybrid_rows"] == (0, 2)  # rank 0's rows of the global batch
    assert abs(world["hybrid_loss"] - float(loss)) <= TOL * abs(float(loss))
    assert world["hybrid_too_big_raises"]


@pytest.mark.parametrize("h,hkv,tp", [(12, 2, 8), (12, 12, 8), (6, 2, 8), (4, 2, 4), (8, 8, 4), (9, 3, 8)])
def test_tp_head_plan_matches_jax(h, hkv, tp):
    from mllm_tpu.parallel.heads import tp_head_plan

    with pytest.warns(UserWarning, match="replicated KV") if (h, hkv) == (9, 3) else _no_warning():
        got = port_heads.tp_head_plan(h, hkv, tp)
    want = tp_head_plan(h, hkv, tp)
    if want is None:
        assert got is None
        return
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2:] == want[2:]


class _no_warning:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("case", ["bias_12_2", "int8_12_2", "mha_12_12"])
def test_pad_heads_for_tp_matches_jax(case):
    """The cases of tests/test_parallel.py (12 q / 2 kv with biases, its
    int8 model, MHA 12 / 12 at tp=8): the port's padded model against the
    JAX padded model (through the bridge) and against the unpadded one."""
    from mllm_tpu.ops.quantize_model import quantize_model as jax_quantize
    from mllm_tpu.parallel.heads import pad_heads_for_tp

    kw = dict(FLAGSHIP, attention_bias=case == "bias_12_2")
    if case == "mha_12_12":
        kw.update(num_key_value_heads=12)
    jm = _jax(kw, 1 if case != "mha_12_12" else 5)
    if case == "int8_12_2":
        jm = jax_quantize(jm, "int8")
    jp = pad_heads_for_tp(jm, 8)
    port = cases.port_model(_params(jm), kw)
    padded = port_heads.pad_heads_for_tp(port, 8)
    want_kw = dict(kw, num_attention_heads=jp.cfg.num_attention_heads, num_key_value_heads=jp.cfg.num_key_value_heads)
    jax_padded = cases.port_model(_params(jp), want_kw)
    assert (padded.cfg.num_attention_heads, padded.cfg.num_key_value_heads) == (
        jp.cfg.num_attention_heads, jp.cfg.num_key_value_heads)
    ids = np.random.default_rng(3).integers(0, 128, (2, 12))
    with torch.no_grad():
        out = {name: m(torch.as_tensor(ids), m.init_cache(2, 32, torch.float32), last_only=False)[0]
               for name, m in (("port", padded), ("jax", jax_padded), ("unpadded", port))}
    for name in ("jax", "unpadded"):
        assert cases.rel(out["port"], out[name]) < TOL, name
    for a, b in zip(padded.state_dict().values(), jax_padded.state_dict().values()):
        assert torch.equal(a, b)  # the same gather, bit for bit


def test_param_spec_matches_jax():
    from mllm_tpu.parallel.sharding import param_spec as jax_spec

    for path, ndim in [("blocks.0.attn.q_proj.weight", 2), ("blocks.0.attn.o_proj.weight", 2),
                       ("blocks.0.mlp.down_proj.weight", 2), ("embed_tokens.weight", 2),
                       ("blocks.0.input_norm.weight", 1), ("blocks.0.attn.q_proj.bias", 1),
                       ("blocks.0.mlp.gate_proj.qweight_t", 2), ("blocks.0.attn.o_proj.qweight_t", 2),
                       ("blocks.0.mlp.up_proj.scales", 1), ("stacked_blocks.attn.k_proj.weight", 3),
                       ("lm_head.weight", 2)]:
        assert param_spec(path, ndim) == tuple(jax_spec(path, ndim)), path
    assert tuple(P("tp", None)) == param_spec("blocks.0.attn.q_proj.weight", 2)


def test_make_mesh_raises_without_a_world_or_a_card(monkeypatch):
    """No silent device fallback: no card and no device asked for raises,
    as does a mesh before the process group is up."""
    from mllm_tpu_torch.parallel.sharding import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        make_mesh(1, 2)
    with pytest.raises(RuntimeError, match="not initialised"):
        make_mesh(1, 2, device="cpu")


def test_dryrun_runs_on_the_device_named():
    """The dry run names its device: without `--device` it is a usage error;
    `2 --device cpu` runs every section in a world of 2 gloo ranks."""
    import pathlib
    import subprocess
    import sys

    cmd = [sys.executable, "-m", "mllm_tpu_torch.parallel.dryrun", "2"]
    root = pathlib.Path(__file__).resolve().parents[1]
    bare = subprocess.run(cmd, capture_output=True, text=True, timeout=120, cwd=root)
    assert bare.returncode == 2 and "--device" in bare.stderr
    proc = subprocess.run(cmd + ["--device", "cpu"], capture_output=True, text=True, timeout=300, cwd=root)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "dryrun OK: mesh dp=1 tp=2" in proc.stdout
