"""The port's int8 / int4 weight paths against mllm_tpu on the same numpy
inputs (CPU): packers and quantizers byte for byte, the plain products
against the Pallas kernels in interpret mode, quantized models through the
bridge, the port's own quantize_model, and auto_model(quant=...).

The JAX side runs its canonical int4 layout (MLLM_INT4_IMPL=pallas) with no
INT4_MIN_PARAMS int8 fallback, and its numpy packers without the native
library (which multiplies by a reciprocal where numpy divides).

Tolerances: products 1e-5 relative to the largest |y| (f32 on both sides,
other summation orders); f32 model logits 1e-4 relative; packed bytes,
scales and greedy tokens exactly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mllm_tpu.ops.quantize_model as jqmod
import mllm_tpu.utils.native as jnative
from mllm_tpu.core.config import TextConfig as JaxTextConfig
from mllm_tpu.generation import generate as jgen
from mllm_tpu.generation.sampling import SamplingConfig as JaxSamplingConfig
from mllm_tpu.models.transformer import CausalLM as JaxCausalLM
from mllm_tpu.ops import quant_matmul as jqm
from mllm_tpu_torch.core.config import TextConfig
from mllm_tpu_torch.generation import generate as tgen
from mllm_tpu_torch.generation.sampling import SamplingConfig
from mllm_tpu_torch.models.bridge import causal_lm_from_jax_params
from mllm_tpu_torch.nn.layers import Int4Linear, QuantLinear
from mllm_tpu_torch.ops import quant_matmul as tqm
from mllm_tpu_torch.ops import quantize_model as tqmod

CPU = torch.device("cpu")
CFG_KW = dict(vocab_size=128, hidden_size=64, intermediate_size=256, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, head_dim=64,
              max_position_embeddings=256, rope_theta=10000.0, eos_token_id=127)


@pytest.fixture
def jax_pallas_int4(monkeypatch):
    """The JAX package on its canonical int4 layout, numpy packers."""
    monkeypatch.setenv("MLLM_INT4_IMPL", "pallas")
    monkeypatch.setattr(jqmod, "INT4_MIN_PARAMS", 0)
    monkeypatch.setattr(jnative, "repack_int8", lambda w: None)
    monkeypatch.setattr(jnative, "repack_int4", lambda w, group=32: None)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def _equal(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8))  # bit for bit


def _weights(rng, *shape):
    """Normal weights with a spread of row magnitudes, and one all-zero row
    (the amax == 0 guard)."""
    w = rng.standard_normal(shape).astype(np.float32) * rng.uniform(0.01, 1.0, shape[:-1])[..., None]
    w[..., 0, :] = 0.0
    return w


# ---------------------------------------------------------------------------
# (a) packers and quantizers: the same bytes and scale bits as JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,k", [(48, 64), (256, 960)])
def test_numpy_packers_match(jax_pallas_int4, n, k):
    w = _weights(np.random.default_rng(0), n, k)
    for got, want in zip(tqm.repack_float_to_int8(w), jqm.repack_float_to_int8(w)):
        _equal(got, want)
    p, s = tqm.repack_float_to_int4(w, 32)
    jp, js = jqm.repack_float_to_int4(w, 32)
    _equal(p, jp)
    _equal(s, js)
    v = np.random.default_rng(1).integers(-8, 8, (n, k))
    _equal(tqm.pack_int4_planar_signed(v), jqm.pack_int4_planar_signed(v))
    for got, want in zip(tqm.prepare_int4(p, s, 32), jqm.prepare_int4(jp, js, 32)):
        _equal(got, want)
    z = np.random.default_rng(2).standard_normal(s.shape).astype(np.float32)
    for got, want in zip(tqm.prepare_int4(p, s, 32, z), jqm.prepare_int4(jp, js, 32, z)):
        _equal(got, want)


@pytest.mark.parametrize("shape", [(48, 64), (256, 960), (2, 96, 128)], ids=["small", "padded", "stacked"])
def test_device_quantizers_match(shape):
    w = _weights(np.random.default_rng(3), *shape)
    for got, want in zip(tqmod._q8_device(torch.from_numpy(w)), jqmod._q8_device(jnp.asarray(w))):
        _equal(got, want)
    tp, ts = tqmod._q4_device(torch.from_numpy(w))
    jp, js = jqmod._q4_device(jnp.asarray(w))
    _equal(tp, jp)
    _equal(ts, js)
    for got, want in zip(tqm.prepare_int4(tp, ts, 32), jqm.prepare_int4(jp, js, 32)):
        _equal(got, want)
    # the device quantizers take the model's bf16 weights as they are
    wb = torch.from_numpy(w).to(torch.bfloat16)
    for got, want in zip(tqmod._q4_device(wb), jqmod._q4_device(jnp.asarray(w).astype(jnp.bfloat16))):
        _equal(got, want)


def test_dequant_canonical_matches():
    rng = np.random.default_rng(4)
    p, s, z = jqm.prepare_int4(*jqm.repack_float_to_int4(_weights(rng, 32, 960), 32), 32)
    z = z + rng.standard_normal(z.shape).astype(np.float32) * (s != 0)
    for zeros in (None, z):
        got = tqm.dequant_int4_canonical(torch.from_numpy(p), torch.from_numpy(s),
                                         None if zeros is None else torch.from_numpy(zeros), 32, 960)
        want = jqm.dequant_int4_canonical(jnp.asarray(p), jnp.asarray(s),
                                          None if zeros is None else jnp.asarray(zeros), 32, 960)
        _equal(got, want)


# ---------------------------------------------------------------------------
# (b) plain products against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------


def _x_exact_group_sums(rng, m, k):
    """x in {-1, -0.5, 0, 0.5, 1}: bf16 holds it, and every 32-group sum of
    it, exactly. The Pallas int4 kernel rounds its group sums of x to bf16
    (ROADMAP Queue 3); with these inputs both sides see the same sums."""
    return (rng.integers(-2, 3, (m, k)) * 0.5).astype(np.float32)


@pytest.mark.parametrize("m", [1, 8, 32])
def test_int8_ref_matches_interpret_kernel(m):
    rng = np.random.default_rng(5)
    k, n = 192, 256
    qv, sc = jqm.repack_float_to_int8(_weights(rng, n, k))
    x = np.array(jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16).astype(jnp.float32))
    want = jqm.int8_matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(qv), jnp.asarray(sc),
                           block_m=8, block_n=128, block_k=64, interpret=True)
    got = tqm.int8_matmul(torch.from_numpy(x), torch.from_numpy(qv), torch.from_numpy(sc))
    assert got.dtype == torch.float32
    assert _rel(got, want) < 1e-5


def _int4_operands(rng, n, k, affine):
    p, s, z = jqm.prepare_int4(*jqm.repack_float_to_int4(_weights(rng, n, k), 32), 32)
    if affine:  # raw nibbles, scales and zeros; the padded rows stay zero
        live = s != 0
        rows = np.arange(p.shape[0])[:, None] < k // 2
        p = (rng.integers(0, 256, p.shape) * rows).astype(np.uint8)
        s = (rng.uniform(0.001, 0.02, s.shape) * live).astype(np.float32)
        z = (rng.standard_normal(s.shape) * 0.05 * live).astype(np.float32)
    return p, s, (z if affine else None)


@pytest.mark.parametrize("affine", [False, True], ids=["symmetric", "affine"])
@pytest.mark.parametrize("m,k", [(1, 64), (8, 64), (32, 64), (8, 960)],
                         ids=["m1", "m8", "m32", "padded_k"])
def test_int4_ref_matches_interpret_kernel(m, k, affine):
    rng = np.random.default_rng(6)
    n = 256
    p, s, z = _int4_operands(rng, n, k, affine)
    x = _x_exact_group_sums(rng, m, k)
    want = jqm.int4_matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(p), jnp.asarray(s), 32,
                           None if z is None else jnp.asarray(z), interpret=True)
    got = tqm.int4_matmul(torch.from_numpy(x), torch.from_numpy(p), torch.from_numpy(s), 32,
                          None if z is None else torch.from_numpy(z))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert _rel(got, want) < 1e-5


def test_int4_ref_bf16_group_sum_divergence():
    """General bf16 x: the Pallas kernel's group sums of x are rounded to
    bf16 (jnp.sum over a bf16 slab), the port's are f32. The two agree to
    ~2^-9 of the zero-point term: 2e-2 relative bounds it here."""
    rng = np.random.default_rng(7)
    p, s, _ = _int4_operands(rng, 256, 960, False)
    x = np.array(jnp.asarray(rng.standard_normal((8, 960)), jnp.bfloat16).astype(jnp.float32))
    want = jqm.int4_matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(p), jnp.asarray(s), 32,
                           interpret=True)
    got = tqm.int4_matmul(torch.from_numpy(x), torch.from_numpy(p), torch.from_numpy(s), 32)
    assert _rel(got, want) < 2e-2


@pytest.mark.parametrize("affine", [False, True], ids=["symmetric", "affine"])
def test_int4_large_m_matches_jax_fallback(affine):
    """m = 40 > 32: the JAX package dequantizes and runs one f32 matmul."""
    rng = np.random.default_rng(8)
    p, s, z = _int4_operands(rng, 128, 960, affine)
    x = rng.standard_normal((40, 960)).astype(np.float32)
    want = jqm.int4_matmul(jnp.asarray(x), jnp.asarray(p), jnp.asarray(s), 32,
                           None if z is None else jnp.asarray(z))
    got = tqm.int4_matmul(torch.from_numpy(x), torch.from_numpy(p), torch.from_numpy(s), 32,
                          None if z is None else torch.from_numpy(z))
    assert _rel(got, want) < 1e-5


def test_quant_layers_add_bias_in_f32_and_round_once(jax_pallas_int4):
    from mllm_tpu.nn import layers as jl

    rng = np.random.default_rng(9)
    w = _weights(rng, 64, 128)
    b = rng.standard_normal(64).astype(np.float32)
    x = rng.standard_normal((2, 3, 128)).astype(np.float32)
    qv, sc = jqm.repack_float_to_int8(w)
    p, s, _ = jqm.prepare_int4(*jqm.repack_float_to_int4(w, 32), 32)
    for dtype, jdtype, tol in ((torch.float32, jnp.float32, 1e-5), (torch.bfloat16, jnp.bfloat16, 1e-2)):
        tb = torch.from_numpy(b).to(dtype)
        tx = torch.from_numpy(x).to(dtype)
        jb, jx = jnp.asarray(b, jdtype), jnp.asarray(x, jdtype)
        got = QuantLinear(torch.from_numpy(qv), torch.from_numpy(sc), tb)(tx)
        want = jl.QuantLinear(jnp.asarray(qv), jnp.asarray(sc), jb)(jx)
        assert got.dtype == dtype and _rel(got.float(), want.astype(jnp.float32)) < tol
        got = Int4Linear(torch.from_numpy(p), torch.from_numpy(s), 32, None, tb)(tx)
        want = jl.Int4Linear(jnp.asarray(p), jnp.asarray(s), 32, None, jb)(jx)
        assert got.dtype == dtype and _rel(got.float(), want.astype(jnp.float32)) < tol


# ---------------------------------------------------------------------------
# (d) quantized JAX models through the bridge; the port's quantize_model
# ---------------------------------------------------------------------------

_jax_forward = jax.jit(lambda m, ids, c: m(ids, c, last_only=False))
_jax_step = jax.jit(lambda m, ids, c: m(ids, c, last_only=True))


def _jax_float_model(layout):
    jm = JaxCausalLM.init(jax.random.PRNGKey(0), JaxTextConfig(**CFG_KW))
    return jm.stack() if layout == "stacked" else jm


def _params(jm):
    return {k: np.asarray(v) for k, v in jm.parameters().items()}


@pytest.mark.parametrize("layout,mode,fuse", [
    ("unrolled", "int8", True), ("stacked", "int8", True),
    ("unrolled", "int4", True), ("stacked", "int4", True),
    ("unrolled", "int4", False),
])
def test_bridged_quantized_model_matches_jax(jax_pallas_int4, layout, mode, fuse):
    jm = _jax_float_model(layout)
    if fuse:
        jm = jqmod.fuse_projections(jm)
    jq = jqmod.quantize_model(jm, mode, min_size=1)
    tm = causal_lm_from_jax_params(_params(jq), TextConfig(**CFG_KW), CPU)
    blk = tm.blocks[1]
    if mode == "int4":
        assert isinstance(blk.mlp, tqmod.FusedInt4MLP)
        assert isinstance(tm.embed_tokens, tqmod.Int4EmbedHead)
    else:
        assert isinstance(blk.mlp.down_proj, QuantLinear)
        assert isinstance(tm.embed_tokens, tqmod.QuantEmbedHead)
    assert (blk.attn.qkv_proj is not None) == fuse

    ids = np.random.default_rng(10).integers(0, 128, (2, 11))
    jl, jc = _jax_forward(jq, jnp.asarray(ids, jnp.int32), jq.init_cache(2, 32, jnp.float32))
    tl, tc = tm(torch.from_numpy(ids), tm.init_cache(2, 32, torch.float32), last_only=False)
    assert _rel(tl, jl) < 1e-4
    tok = np.array([3, 77])
    for _ in range(3):
        jl, jc = _jax_step(jq, jnp.asarray(tok[:, None], jnp.int32), jc)
        tl, tc = tm(torch.from_numpy(tok[:, None]), tc)
        assert _rel(tl, jl) < 1e-4
        tok = np.array(jnp.argmax(jl[:, 0], -1))

    prompt = np.random.default_rng(11).integers(0, 127, (1, 13)).astype(np.int32)
    jres, _ = jgen.generate(jq, prompt, jq.init_cache(1, 64, jnp.float32),
                            JaxSamplingConfig(max_new_tokens=12), bucket=16)
    tres, _ = tgen.generate(tm, prompt, tm.init_cache(1, 64, torch.float32),
                            SamplingConfig(max_new_tokens=12), bucket=16)
    assert tres.tokens == jres.tokens


@pytest.mark.parametrize("on_device", [True, False], ids=["on_device", "numpy"])
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_port_quantize_model_state_matches_bridged_jax(jax_pallas_int4, mode, on_device):
    """fuse_projections + quantize_model in the port, on the bridged float
    model, gives the state dict of the bridged JAX-quantized model."""
    jm = _jax_float_model("unrolled")
    jq = jqmod.quantize_model(jqmod.fuse_projections(jm), mode, min_size=1, on_device=on_device)
    want = causal_lm_from_jax_params(_params(jq), TextConfig(**CFG_KW), CPU).state_dict()
    tm = causal_lm_from_jax_params(_params(jm), TextConfig(**CFG_KW), CPU)
    got = tqmod.quantize_model(tqmod.fuse_projections(tm), mode, min_size=1,
                               on_device=on_device).state_dict()
    assert got.keys() == want.keys()
    for k in want:
        _equal(got[k], want[k].numpy())


def test_quantize_model_flags(jax_pallas_int4):
    """min_size keeps small Linears float, attn_quant overrides the mode
    inside attention, quant_embed_head=False keeps the float head."""
    jm = _jax_float_model("unrolled")
    kw = dict(min_size=10000, attn_quant="int8", quant_embed_head=False)
    jq = jqmod.quantize_model(jm, "int4", **kw)
    want = causal_lm_from_jax_params(_params(jq), TextConfig(**CFG_KW), CPU)
    tm = tqmod.quantize_model(causal_lm_from_jax_params(_params(jm), TextConfig(**CFG_KW), CPU),
                              "int4", **kw)
    assert type(tm.blocks[0].attn.q_proj) is QuantLinear  # 256 x 64: int8 by attn_quant
    assert type(tm.blocks[0].attn.k_proj).__name__ == "Linear"  # 128 x 64 < min_size
    assert isinstance(tm.blocks[0].mlp, tqmod.FusedInt4MLP)
    assert type(tm.embed_tokens).__name__ == "Embedding"
    got, ref = tm.state_dict(), want.state_dict()
    assert got.keys() == ref.keys()
    for k in ref:
        _equal(got[k], ref[k].numpy())


@pytest.mark.parametrize("mode", ["nf4", "int4-mixed", "fp8"])
def test_unported_modes_raise(mode):
    """Modes the JAX package lacks raise; "int4-mixed", ported since, is a
    mode of the loaders: `quantize_model` takes one Linear's mode, as the
    JAX one does, and names the pair that spells it (mode "int4",
    attn_quant "int8")."""
    tm = causal_lm_from_jax_params(_params(_jax_float_model("unrolled")), TextConfig(**CFG_KW), CPU)
    if mode == "int4-mixed":
        for kw in (dict(mode=mode), dict(mode="int4", attn_quant=mode)):
            with pytest.raises(ValueError, match="mode='int4', attn_quant='int8'"):
                tqmod.quantize_model(tm, **kw)
        return
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        tqmod.quantize_model(tm, mode)


# ---------------------------------------------------------------------------
# (e) auto_model(quant=...) on a float checkpoint
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_auto_model_quant_matches_jax(jax_pallas_int4, tmp_path, monkeypatch, quant):
    from mllm_tpu.models.registry import auto_model as jax_auto_model
    from mllm_tpu_torch.models.registry import auto_model

    monkeypatch.setenv("USE_TF", "0")
    import transformers

    torch.manual_seed(0)
    cfg = transformers.Qwen2Config(vocab_size=128, hidden_size=64, intermediate_size=128,
                                   num_hidden_layers=2, num_attention_heads=4,
                                   num_key_value_heads=2, max_position_embeddings=128,
                                   tie_word_embeddings=False)
    d = tmp_path / "qwen2"
    transformers.Qwen2ForCausalLM(cfg).eval().save_pretrained(d)
    jm, _, _ = jax_auto_model(str(d), dtype=jnp.float32, quant=quant, with_tokenizer=False)
    tm, _, _ = auto_model(str(d), dtype=torch.float32, quant=quant, with_tokenizer=False,
                          device=CPU)
    cls = QuantLinear if quant == "int8" else Int4Linear
    assert isinstance(tm.blocks[0].mlp.down_proj, cls) and isinstance(tm.lm_head, cls)

    ids = np.array([[3, 17, 42, 99, 7, 23]], np.int64)
    jl, _ = _jax_forward(jm, jnp.asarray(ids, jnp.int32), jm.init_cache(1, 32, jnp.float32))
    tl, _ = tm(torch.from_numpy(ids), tm.init_cache(1, 32, torch.float32), last_only=False)
    assert _rel(tl, jl) < 1e-5
    jres, _ = jgen.generate(jm, ids, jm.init_cache(1, 32, jnp.float32),
                            JaxSamplingConfig(max_new_tokens=8), bucket=8)
    tres, _ = tgen.generate(tm, ids, tm.init_cache(1, 32, torch.float32),
                            SamplingConfig(max_new_tokens=8), bucket=8)
    assert tres.tokens == jres.tokens
