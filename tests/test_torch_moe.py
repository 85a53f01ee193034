"""The port's MoE layers against mllm_tpu's on the same numpy weights: each
branch (ragged, dense) against the same JAX branch, the two port branches
against each other, routing ties, the int8 expert stacks, quantize_model,
the stacked-layer bridge, and tiny HF checkpoints of every MoE model_type.

Tolerances: a branch against the JAX branch 1e-5 of max |y| in f32 and 1e-2
in bf16 (one bf16 rounding an op, in other places); the port's two branches
against each other 1e-5 in f32, and in bf16 3e-2 (the ragged branch rounds
its products and combine to bf16, the dense one keeps them in f32);
QuantMoEMLP against JAX 1e-5 (both branches compute f32 products of bf16
values); model logits 1e-5 of max |logit| against JAX and 3e-3 absolute
against transformers; greedy tokens equal."""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mllm_tpu.ops.quantize_model as jqmod
import mllm_tpu.utils.native as jnative
from mllm_tpu.core.config import TextConfig as JaxTextConfig
from mllm_tpu.generation.generate import generate as jax_generate
from mllm_tpu.generation.sampling import SamplingConfig as JaxSamplingConfig
from mllm_tpu.models import moe as jmoe
from mllm_tpu.models.registry import auto_model as jax_auto_model
from mllm_tpu.models.transformer import CausalLM as JaxCausalLM
from mllm_tpu.nn.module import ModuleList
from mllm_tpu_torch.core.config import TextConfig
from mllm_tpu_torch.generation.generate import generate
from mllm_tpu_torch.generation.sampling import SamplingConfig
from mllm_tpu_torch.models import moe as tmoe
from mllm_tpu_torch.models.bridge import causal_lm_from_jax_params
from mllm_tpu_torch.models.megadecode import _supported
from mllm_tpu_torch.models.registry import auto_model
from mllm_tpu_torch.nn import attention as port_attention
from mllm_tpu_torch.ops.quantize_model import FusedInt4MLP, quantize_model

CPU = torch.device("cpu")
_jax_forward = jax.jit(lambda m, ids, c: m(ids, c, last_only=False))
CFG_KW = dict(vocab_size=128, hidden_size=64, intermediate_size=64, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
              rope_theta=10000.0, eos_token_id=-2, num_experts=8, num_experts_per_tok=2,
              moe_shared_expert_size=256)


@pytest.fixture(scope="module", autouse=True)
def kernel_route_at_small_head_dim():
    """The tiny models have head_dim 8 and 16, which the port's route sends to
    `sdpa`: here they reach the kernels' plain versions, as on the card."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_attention, "KERNEL_HEAD_DIMS", (8, 16, 64, 128, 256))
        yield


@pytest.fixture
def jax_pallas_int4(monkeypatch):
    """The JAX package on its canonical int4 layout, numpy packers."""
    monkeypatch.setenv("MLLM_INT4_IMPL", "pallas")
    monkeypatch.setattr(jqmod, "INT4_MIN_PARAMS", 0)
    monkeypatch.setattr(jnative, "repack_int8", lambda w: None)
    monkeypatch.setattr(jnative, "repack_int4", lambda w, group=32: None)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _jax_moe_model(jdtype=jnp.float32, stacked=False, shared_gate=False, **kw):
    """A JAX CausalLM whose blocks hold MoEMLP.init experts (bench.py's
    build), unrolled or stacked."""
    cfg = JaxTextConfig(**{**CFG_KW, **kw})
    m = JaxCausalLM.init(jax.random.PRNGKey(0), cfg, dtype=jdtype)
    blocks = []
    for i, b in enumerate(m.blocks.mods):
        moe = jmoe.MoEMLP.init(jax.random.fold_in(jax.random.PRNGKey(1), i), cfg, jdtype)
        if shared_gate:
            g = jax.random.normal(jax.random.PRNGKey(10 + i), (1, cfg.hidden_size), jdtype) * 0.3
            moe = moe.replace(shared_gate=g)
        blocks.append(b.replace(mlp=moe))
    m = m.replace(blocks=ModuleList(blocks))
    return m.stack() if stacked else m


def _bridge(jm, tdtype=torch.float32, **kw):
    params = {k: np.asarray(v) for k, v in jm.parameters().items()}
    return causal_lm_from_jax_params(params, TextConfig(**{**CFG_KW, **kw}), CPU, tdtype)


def _jax_branch(moe, x, ragged: bool):
    """The JAX MoEMLP's ragged (dense decode off) or dense branch on x."""
    cls = type(moe)
    orig = cls._dense_decode_ok
    cls._dense_decode_ok = (lambda self: False) if ragged else orig
    try:
        return np.asarray(moe(jnp.asarray(x)).astype(jnp.float32))
    finally:
        cls._dense_decode_ok = orig


def _port_branch(moe, x, ragged: bool):
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(moe.router_weight.dtype)
    xf = xt.reshape(-1, xt.shape[-1])
    top_p, top_i = tmoe.route(xf, moe.router_weight, moe.top_k, moe.norm_topk_prob)
    y = moe._ragged(xf, top_p, top_i) if ragged else moe._dense_all_experts(xf, top_p, top_i)
    if moe.shared_expert is not None:
        sh = moe.shared_expert(xf)
        if moe.shared_gate is not None:
            sh = sh * torch.sigmoid(tmoe.matmul_f32(xf, moe.shared_gate)).to(sh.dtype)
        y = y + sh
    return y.reshape(xt.shape).float().numpy()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("norm_topk", [False, True])
def test_branches_match_jax_and_each_other(dtype, norm_topk):
    jdt, tdt, tol, cross = ((jnp.float32, torch.float32, 1e-5, 1e-5) if dtype == "f32"
                            else (jnp.bfloat16, torch.bfloat16, 1e-2, 3e-2))
    jm = _jax_moe_model(jdt, moe_norm_topk_prob=norm_topk, shared_gate=True)
    tm = _bridge(jm, tdt, moe_norm_topk_prob=norm_topk)
    jmoe_, tmoe_ = jm.blocks.mods[0].mlp, tm.blocks[0].mlp
    assert type(tmoe_) is tmoe.MoEMLP and tmoe_.shared_gate is not None
    x = (np.random.default_rng(0).standard_normal((2, 5, 64)) * 2).astype(np.float32)
    xj = jnp.asarray(x, jdt)
    jr, jd = _jax_branch(jmoe_, xj, True), _jax_branch(jmoe_, xj, False)
    pr, pd = _port_branch(tmoe_, x, True), _port_branch(tmoe_, x, False)
    assert _rel(pr, jr) < tol and _rel(pd, jd) < tol
    assert _rel(pr, pd) < cross


def test_router_ties_go_to_the_lower_expert():
    """Exactly tied router rows: the port picks the experts jax.lax.top_k picks."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((8, 64)).astype(np.float32)
    w[5], w[6], w[1] = w[2], w[2], w[7]  # experts 2, 5, 6 tie; 1 and 7 tie
    x = rng.standard_normal((33, 64)).astype(np.float32)
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(w).T, axis=-1)
    for k in (1, 2, 3, 4):
        _, ji = jax.lax.top_k(probs, k)
        _, ti = tmoe.route(torch.from_numpy(x), torch.from_numpy(w), k, False)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_quant_expert_stack_bit_equal_to_eager_jax():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((2, 4, 64, 48)) * rng.uniform(0.01, 3, (2, 4, 1, 48))).astype(np.float32)
    w[0, 1, :, 7] = 0.0  # the amax == 0 guard
    jq, js = jmoe._quant_expert_stack(jnp.asarray(w))
    tq, ts = tmoe._quant_expert_stack(torch.from_numpy(w))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(js).view(np.uint32))


@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "dense"])
def test_quant_moe_branches_match_jax(ragged):
    jm = _jax_moe_model(shared_gate=True)
    jq = jmoe.QuantMoEMLP.from_moe(jm.blocks.mods[0].mlp)
    tq = tmoe.QuantMoEMLP.from_moe(_bridge(jm).blocks[0].mlp)
    for name in ("w_gate", "s_gate", "w_up", "s_up", "w_down", "s_down"):
        np.testing.assert_array_equal(getattr(tq, name).numpy(), np.asarray(getattr(jq, name)))
    x = np.random.default_rng(1).standard_normal((1, 7, 64)).astype(np.float32)
    assert _rel(_port_branch(tq, x, ragged), _jax_branch(jq, jnp.asarray(x), ragged)) < 1e-5


@pytest.mark.parametrize("mode", ["int8", "int8-a8", "int4"])
def test_quantize_model_gives_the_jax_structure(mode, jax_pallas_int4):
    """int8 expert stacks in every mode; the shared expert like any MLP:
    int8 Linears, or one FusedInt4MLP in "int4"; logits close to JAX's."""
    jm = _jax_moe_model()
    tm = _bridge(jm)
    jq = jqmod.quantize_model(jm, mode, min_size=1, quant_embed_head=False)
    quantize_model(tm, mode, min_size=1, quant_embed_head=False)
    for jb, tb in zip(jq.blocks.mods, tm.blocks):
        assert type(jb.mlp).__name__ == type(tb.mlp).__name__ == "QuantMoEMLP"
        assert type(jb.mlp.shared_expert).__name__ == type(tb.mlp.shared_expert).__name__
        if mode == "int4":
            assert isinstance(tb.mlp.shared_expert, FusedInt4MLP)
    ids = np.random.default_rng(0).integers(0, 128, (1, 20))
    jl, _ = _jax_forward(jq, jnp.asarray(ids, jnp.int32), jq.init_cache(1, 32, jnp.float32))
    tl, _ = tm(torch.from_numpy(ids), tm.init_cache(1, 32, torch.float32), last_only=False)
    assert _rel(tl, jl) < 2e-3  # the int4 shared expert: the JAX kernel's bf16 group sums


@pytest.mark.parametrize("stacked", [False, True], ids=["unrolled", "stacked"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_bridged_model_matches_jax(stacked, quant):
    """The bridge on unrolled and stacked ([L]-leading, bench.py's build)
    MoE blocks; prefill (ragged: 40 tokens) and decode steps (dense)."""
    jm = _jax_moe_model()
    if quant:
        jm = jqmod.quantize_model(jm, "int8", min_size=1, quant_embed_head=False)
    tm = _bridge(jm.stack() if stacked else jm)
    assert type(tm.blocks[1].mlp).__name__ == ("QuantMoEMLP" if quant else "MoEMLP")
    ids = np.random.default_rng(0).integers(0, 128, (1, 40))
    jl, jc = _jax_forward(jm, jnp.asarray(ids, jnp.int32), jm.init_cache(1, 64, jnp.float32))
    tl, tc = tm(torch.from_numpy(ids), tm.init_cache(1, 64, torch.float32), last_only=False)
    assert _rel(tl, jl) < 1e-5
    tok = np.array([int(np.argmax(np.asarray(jl)[0, -1]))])
    for _ in range(3):
        jl, jc = _jax_forward(jm, jnp.asarray(tok[:, None], jnp.int32), jc)
        tl, tc = tm(torch.from_numpy(tok[:, None]), tc, last_only=False)
        assert _rel(tl, jl) < 1e-5
        tok = np.asarray(jnp.argmax(jl[:, -1], -1))
    assert _supported(tm.cfg, tm.blocks[0]) is not None  # the megakernel refuses MoE blocks


def _save_tiny_moe(tmp_path, kind, monkeypatch, width=32):
    monkeypatch.setenv("USE_TF", "0")
    import transformers

    torch.manual_seed(0)
    common = dict(vocab_size=128, hidden_size=width, intermediate_size=2 * width, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
                  num_experts_per_tok=2, rope_theta=10000.0)
    if kind == "mixtral":
        hf = transformers.MixtralForCausalLM(transformers.MixtralConfig(**common, num_local_experts=4))
    else:
        hf = transformers.Qwen2MoeForCausalLM(transformers.Qwen2MoeConfig(
            **common, num_experts=4, moe_intermediate_size=width + width // 2,
            shared_expert_intermediate_size=2 * width, norm_topk_prob=False, decoder_sparse_step=1,
            mlp_only_layers=[]))
    d = tmp_path / kind
    hf.eval().save_pretrained(d)
    return hf.eval(), d


IDS = np.array([[3, 17, 42, 99, 7, 23, 56, 11, 5, 90, 61, 2, 8, 33, 70, 101, 4, 19, 27, 64]], np.int64)


@pytest.mark.parametrize("kind", ["mixtral", "qwen2_moe"])
def test_hf_checkpoint_matches_transformers_and_jax(tmp_path, kind, monkeypatch):
    hf, d = _save_tiny_moe(tmp_path, kind, monkeypatch)
    jm, _, jcfg = jax_auto_model(str(d), dtype=jnp.float32, with_tokenizer=False)
    tm, _, cfg = auto_model(str(d), dtype=torch.float32, with_tokenizer=False, device=CPU)
    assert cfg.num_experts == 4 and type(tm.blocks[0].mlp) is tmoe.MoEMLP
    with torch.no_grad():
        hl = hf(torch.from_numpy(IDS)).logits.numpy()
    tl, _ = tm(torch.from_numpy(IDS), tm.init_cache(1, 32, torch.float32), last_only=False)
    jl, _ = _jax_forward(jm, jnp.asarray(IDS, jnp.int32), jm.init_cache(1, 32, jnp.float32))
    np.testing.assert_allclose(tl.numpy(), hl, rtol=3e-3, atol=3e-3)
    assert _rel(tl, jl) < 1e-5
    jres, _ = jax_generate(jm, IDS, jm.init_cache(1, 48, jnp.float32), JaxSamplingConfig(max_new_tokens=8),
                           eos_token_id={-1}, bucket=8)
    tres, _ = generate(tm, IDS, tm.init_cache(1, 48, torch.float32), SamplingConfig(max_new_tokens=8),
                       eos_token_id={-1}, bucket=8)
    assert tres.tokens == jres.tokens


@pytest.mark.parametrize("quant", ["int8", "int8-a8", "int4"])
@pytest.mark.parametrize("kind", ["mixtral", "qwen2_moe"])
def test_quantized_load_matches_jax(tmp_path, kind, quant, monkeypatch, jax_pallas_int4):
    """auto_model(quant=...) on MoE checkpoints (hidden 64: int4 groups): the
    experts int8 on the host, the rest as make_linear quantizes it."""
    _, d = _save_tiny_moe(tmp_path, kind, monkeypatch, width=64)
    jm, _, _ = jax_auto_model(str(d), dtype=jnp.float32, quant=quant, with_tokenizer=False)
    tm, _, _ = auto_model(str(d), dtype=torch.float32, quant=quant, with_tokenizer=False, device=CPU)
    jb, tb = jm.blocks.mods[0], tm.blocks[0]
    assert type(tb.mlp).__name__ == type(jb.mlp).__name__ == "QuantMoEMLP"
    if kind == "qwen2_moe":
        assert type(tb.mlp.shared_expert).__name__ == type(jb.mlp.shared_expert).__name__
    assert type(tb.attn.q_proj).__name__ == type(jb.attn.q_proj).__name__
    tl, _ = tm(torch.from_numpy(IDS), tm.init_cache(1, 32, torch.float32), last_only=False)
    jl, _ = _jax_forward(jm, jnp.asarray(IDS, jnp.int32), jm.init_cache(1, 32, jnp.float32))
    assert _rel(tl, jl) < 2e-3  # int4: the JAX kernels' bf16 group sums


def _retype(src, dst, model_type: str, rename=None, **cfg_kw):
    """A copy of the checkpoint at src as `model_type`, tensors renamed."""
    from safetensors.numpy import load_file, save_file

    dst.mkdir()
    t = load_file(str(src / "model.safetensors"))
    if rename:
        t = {rename(k): v for k, v in t.items()}
    save_file(t, str(dst / "model.safetensors"))
    cfg = json.loads((src / "config.json").read_text())
    cfg.update(model_type=model_type, **cfg_kw)
    (dst / "config.json").write_text(json.dumps(cfg))
    return dst


def _minicpm_moe_name(k: str) -> str:
    for a, b in ((".block_sparse_moe.gate.", ".mlp.gate."), (".block_sparse_moe.experts.", ".mlp.experts."),
                 (".w1.", ".gate_proj."), (".w3.", ".up_proj."), (".w2.", ".down_proj.")):
        k = k.replace(a, b)
    return k


@pytest.mark.parametrize("quant", [None, "int8", "int8-a8", "int4"])
@pytest.mark.parametrize("model_type", ["minicpm_moe", "bailing_moe", "smallthinker"])
def test_other_moe_types_build_and_match_jax(tmp_path, model_type, quant, monkeypatch, jax_pallas_int4):
    """minicpm_moe (mlp.experts.{e}.gate_proj names, no shared expert, from
    the mixtral checkpoint) and bailing_moe / smallthinker (qwen2_moe's
    names), float and quantized at load (hidden 64: int4 groups)."""
    if model_type == "minicpm_moe":
        _, src = _save_tiny_moe(tmp_path, "mixtral", monkeypatch, width=64)
        d = _retype(src, tmp_path / model_type, model_type, _minicpm_moe_name, num_experts=4)
    else:
        _, src = _save_tiny_moe(tmp_path, "qwen2_moe", monkeypatch, width=64)
        d = _retype(src, tmp_path / model_type, model_type)
    jm, _, _ = jax_auto_model(str(d), dtype=jnp.float32, quant=quant, with_tokenizer=False)
    tm, _, cfg = auto_model(str(d), dtype=torch.float32, quant=quant, with_tokenizer=False, device=CPU)
    want = tmoe.MoEMLP if quant is None else tmoe.QuantMoEMLP
    assert cfg.model_type == model_type and type(tm.blocks[0].mlp) is want
    tl, _ = tm(torch.from_numpy(IDS), tm.init_cache(1, 32, torch.float32), last_only=False)
    jl, _ = _jax_forward(jm, jnp.asarray(IDS, jnp.int32), jm.init_cache(1, 32, jnp.float32))
    assert _rel(tl, jl) < (1e-5 if quant is None else 2e-3)  # int4: the JAX kernels' bf16 group sums


@pytest.mark.parametrize("model_type,item", [("opt", "item 14"), ("bert", "item 14"), ("fuyu", "item 13"),
                                             ("phi3_v", "item 13"), ("phi3v", "item 13"), ("llava", "item 13")])
def test_unported_types_name_their_item(tmp_path, monkeypatch, model_type, item):
    """The types the port took in ROADMAP items 13 and 14 (`item`) no longer
    raise: auto_model hands them to auto_model_any, as the JAX package does,
    and returns the model's config."""
    from mllm_tpu_torch.models import registry

    seen = []

    class Loaded:
        cfg = "cfg"

    monkeypatch.setattr(registry, "auto_model_any",
                        lambda path, dtype, quant, device: seen.append((path, quant, device)) or (Loaded(), "kind"))
    (tmp_path / "config.json").write_text(json.dumps({"model_type": model_type}))
    model, tok, cfg = auto_model(str(tmp_path), device=CPU)
    assert isinstance(model, Loaded) and cfg == "cfg" and tok is None
    assert seen == [(str(tmp_path), None, CPU)]


def test_init_draws_moe_scale_and_runs():
    """CausalLM.init of an MoE config: N(0, 0.02^2) experts and router (JAX
    MoEMLP.init's scale); both branches run through generate."""
    from mllm_tpu_torch.models.transformer import CausalLM

    cfg = TextConfig(**CFG_KW)
    tm = CausalLM.init(cfg, device=CPU, generator=torch.Generator().manual_seed(0))
    moe = tm.blocks[0].mlp
    assert type(moe) is tmoe.MoEMLP and abs(float(moe.w_gate.std()) - 0.02) < 2e-3
    res, _ = generate(tm, IDS, tm.init_cache(1, 160, torch.float32), SamplingConfig(max_new_tokens=4))
    assert len(res.tokens) == 4


@pytest.mark.parametrize("e,d,ff,dense_at,ragged_at", [
    (16, 1024, 512, (1, 2, 4, 8, 16, 32, 128), (1024,)),     # the JAX bench's geometry
    (60, 2048, 1408, (32,), (1, 2, 4, 8, 16, 128, 1024)),     # Qwen1.5-MoE-A2.7B
])
def test_dense_branch_rule_picks_the_measured_winner(e, d, ff, dense_at, ragged_at):
    """The rule's choice at every point of its docstring's table (top-4, bf16);
    int8 experts stay dense up to QUANT_DENSE_MAX_T."""
    from mllm_tpu_torch.models.moe import QUANT_DENSE_MAX_T, dense_branch

    assert all(dense_branch(t, e, 4, d, ff, False) for t in dense_at)
    assert not any(dense_branch(t, e, 4, d, ff, False) for t in ragged_at)
    assert dense_branch(QUANT_DENSE_MAX_T, e, 4, d, ff, True)
    assert not dense_branch(QUANT_DENSE_MAX_T + 1, e, 4, d, ff, True)
