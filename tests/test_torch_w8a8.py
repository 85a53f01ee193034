"""W8A8 in the port (`int8_matmul_a8`, `QuantLinearA8`, mode "int8-a8")
against mllm_tpu on the same numpy inputs (CPU).

Tolerances: `int8_matmul_a8` bit-equal to the jitted JAX function (XLA
multiplies by f32(1/127) where eager JAX divides; against eager JAX the
difference is f32 rounding of the scale, <= 1e-6 of the largest |y|); its
integer product exact; zero rows give exact zeros. The dispatch is exact
(which of the two products each call takes), a layer's output within 1e-6
of JAX's (f32 rounding: the weight-only product sums in another order).
Quantized state bit-equal; greedy tokens equal; f32 model logits within
1e-2 of the largest |logit| where the A8 product runs: rounding x to int8
turns a last-bit difference upstream (f32 sums in another order) into a
step of 1/127 of its row's amax now and then (the int8 model, weight-only,
agrees to 1e-5: test_torch_quant.py), and within 1e-5 where it does not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mllm_tpu.ops.quantize_model as jqmod
import mllm_tpu.utils.native as jnative
from mllm_tpu.core.config import TextConfig as JaxTextConfig
from mllm_tpu.generation import generate as jgen
from mllm_tpu.generation.sampling import SamplingConfig as JaxSamplingConfig
from mllm_tpu.models.registry import auto_model as jax_auto_model
from mllm_tpu.models.transformer import CausalLM as JaxCausalLM
from mllm_tpu.nn.layers import QuantLinearA8 as JaxQuantLinearA8
from mllm_tpu.ops import quant_matmul as jqm
from mllm_tpu_torch.core.config import TextConfig
from mllm_tpu_torch.generation import generate as tgen
from mllm_tpu_torch.generation.sampling import SamplingConfig
from mllm_tpu_torch.models.bridge import causal_lm_from_jax_params
from mllm_tpu_torch.models.registry import auto_model
from mllm_tpu_torch.nn.layers import QuantLinear, QuantLinearA8
from mllm_tpu_torch.ops import quant_matmul as qm
from mllm_tpu_torch.ops import quantize_model as tqmod
from test_torch_hf_load import _save_tiny

CPU = torch.device("cpu")
CFG_KW = dict(vocab_size=128, hidden_size=64, intermediate_size=256, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, head_dim=64,
              max_position_embeddings=256, rope_theta=10000.0, eos_token_id=127)
_jax_a8 = jax.jit(jqm.int8_matmul_a8)


@pytest.fixture
def jax_numpy_packers(monkeypatch):
    monkeypatch.setattr(jnative, "repack_int8", lambda w: None)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def _operands(rng, m, k, n):
    x = rng.standard_normal((m, k)).astype(np.float32)
    qv, sc = qm.repack_float_to_int8(rng.standard_normal((n, k)).astype(np.float32))
    return x, qv, sc


def _nk(qv):
    """The port's A8 operand: JAX's [K, N] int8 weight as its [N, K] copy."""
    return torch.from_numpy(np.ascontiguousarray(qv.T))


@pytest.mark.parametrize("m,k,n", [(1, 64, 32), (5, 64, 32), (16, 128, 64), (17, 256, 128), (40, 512, 96)])
def test_int8_matmul_a8_matches_jax(m, k, n):
    x, qv, sc = _operands(np.random.default_rng(m), m, k, n)
    got = qm.int8_matmul_a8(torch.from_numpy(x), _nk(qv), torch.from_numpy(sc)).numpy()
    jitted = np.asarray(_jax_a8(jnp.asarray(x), jnp.asarray(qv), jnp.asarray(sc)))
    assert np.array_equal(got, jitted)
    eager = np.asarray(jqm.int8_matmul_a8(jnp.asarray(x), jnp.asarray(qv), jnp.asarray(sc)))
    assert _rel(got, eager) <= 1e-6
    # the integer product is exact: the same int8 rows and scales through f64
    xq, xs = qm.a8_quantize(torch.from_numpy(x), k)
    exact = (xq.double() @ torch.from_numpy(qv).double()).float() * xs * torch.from_numpy(sc)[None, :]
    assert np.array_equal(got, exact.numpy())


def test_int8_matmul_a8_leading_axes_and_zero_rows():
    rng = np.random.default_rng(3)
    x, qv, sc = _operands(rng, 24, 64, 32)
    x[[0, 5, 23]] = 0.0
    x3 = x.reshape(2, 12, 64)
    got = qm.int8_matmul_a8(torch.from_numpy(x3), _nk(qv), torch.from_numpy(sc)).numpy()
    assert got.shape == (2, 12, 32)
    assert np.all(got.reshape(24, 32)[[0, 5, 23]] == 0)
    assert np.array_equal(got, np.asarray(_jax_a8(jnp.asarray(x3), jnp.asarray(qv), jnp.asarray(sc))))


@pytest.mark.parametrize("shape,route", [
    ((2, 1, 64), "w8"),     # a decode step, b = 2
    ((32, 1, 64), "w8"),    # a decode step, b = 32 >= 16: stays weight-only
    ((1, 15, 64), "w8"),    # 15 rows
    ((1, 16, 64), "a8"),    # 16 rows of one sequence
    ((1, 128, 64), "a8"),   # a prefill
    ((4, 20, 64), "a8"),    # a batched prefill
    ((64, 64), "a8"),       # a 2-D stack of tokens (T >= 16)
    ((8, 64), "w8"),        # a 2-D stack of 8
], ids=["decode_b2", "decode_b32", "rows15", "rows16", "prefill", "batched_prefill", "2d_64", "2d_8"])
def test_quant_linear_a8_dispatch(monkeypatch, shape, route):
    """The port's QuantLinearA8 takes the same product as the JAX one at each
    shape (`tests/test_quant_matmul.py::test_quant_linear_a8_dispatch`), and
    gives its values."""
    calls = []
    real_a8, real_w8 = qm.int8_matmul_a8, qm.int8_matmul
    monkeypatch.setattr(qm, "int8_matmul_a8", lambda *a, **k: calls.append("a8") or real_a8(*a, **k))
    monkeypatch.setattr(qm, "int8_matmul", lambda *a, **k: calls.append("w8") or real_w8(*a, **k))
    rng = np.random.default_rng(len(shape) * 100 + shape[0])
    _, qv, sc = _operands(rng, 1, 64, 32)
    bias = rng.standard_normal(32).astype(np.float32)
    x = rng.standard_normal(shape).astype(np.float32)
    lin = QuantLinearA8(torch.from_numpy(qv), torch.from_numpy(sc), torch.from_numpy(bias))
    got = lin(torch.from_numpy(x)).numpy()
    assert calls == [route]
    jlin = JaxQuantLinearA8(jnp.asarray(qv), jnp.asarray(sc), jnp.asarray(bias))
    want = np.asarray(jax.jit(lambda v: jlin(v))(jnp.asarray(x)))
    assert _rel(got, want) <= 1e-6


def test_quant_linear_a8_keeps_its_nk_copy():
    """The A8 operand is the [N, K] copy of the weight whatever device the
    layer is built on: a buffer outside the state dict that moves with the
    module and follows a loaded state."""
    rng = np.random.default_rng(9)
    _, qv, sc = _operands(rng, 1, 64, 32)
    lin = QuantLinearA8(torch.from_numpy(qv), torch.from_numpy(sc))
    assert torch.equal(lin.qweight_nk, lin.qweight_t.t()) and lin.qweight_nk.is_contiguous()
    assert set(lin.state_dict()) == {"qweight_t", "scales"}
    _, qv2, sc2 = _operands(rng, 1, 64, 32)
    lin.load_state_dict({"qweight_t": torch.from_numpy(qv2), "scales": torch.from_numpy(sc2)})
    assert torch.equal(lin.qweight_nk, torch.from_numpy(qv2).t())
    assert lin.to("meta").qweight_nk.device.type == "meta"


def _jax_float_model():
    return JaxCausalLM.init(jax.random.PRNGKey(0), JaxTextConfig(**CFG_KW))


def _params(jm):
    return {k: np.asarray(v) for k, v in jm.parameters().items()}


@pytest.mark.parametrize("on_device", [True, False], ids=["on_device", "numpy"])
def test_quantize_model_int8_a8_matches_jax(jax_numpy_packers, on_device):
    """fuse_projections + quantize_model("int8-a8") in the port on the bridged
    float model: QuantLinearA8 layers with the JAX quantized state, bit for
    bit; prefill logits (the A8 product) and greedy tokens as JAX's."""
    jm = _jax_float_model()
    jq = jqmod.quantize_model(jqmod.fuse_projections(jm), "int8-a8", min_size=1, on_device=on_device)
    tm = causal_lm_from_jax_params(_params(jm), TextConfig(**CFG_KW), CPU)
    tqmod.quantize_model(tqmod.fuse_projections(tm), "int8-a8", min_size=1, on_device=on_device)
    assert isinstance(tm.blocks[0].attn.qkv_proj, QuantLinearA8)
    assert isinstance(tm.blocks[1].mlp.down_proj, QuantLinearA8)
    assert type(tm.embed_tokens).__name__ == "QuantEmbedHead"  # the head stays weight-only, as in JAX
    want = causal_lm_from_jax_params(_params(jq), TextConfig(**CFG_KW), CPU).state_dict()
    got = tm.state_dict()
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)

    ids = np.random.default_rng(1).integers(0, 128, (1, 24))
    jl, _ = jax.jit(lambda m, x, c: m(x, c, last_only=False))(jq, jnp.asarray(ids, jnp.int32),
                                                               jq.init_cache(1, 64, jnp.float32))
    tl, _ = tm(torch.from_numpy(ids), tm.init_cache(1, 64, torch.float32), last_only=False)
    assert _rel(tl, jl) < 1e-2
    jres, _ = jgen.generate(jq, ids, jq.init_cache(1, 64, jnp.float32), JaxSamplingConfig(max_new_tokens=8),
                            bucket=32)
    tres, _ = tgen.generate(tm, ids, tm.init_cache(1, 64, torch.float32), SamplingConfig(max_new_tokens=8),
                            bucket=32)
    assert tres.tokens == jres.tokens


def test_auto_model_int8_a8_matches_jax(jax_numpy_packers, tmp_path, monkeypatch):
    d = _save_tiny(tmp_path, "qwen2", monkeypatch)
    jm, _, _ = jax_auto_model(str(d), dtype=jnp.float32, quant="int8-a8", with_tokenizer=False)
    tm, _, _ = auto_model(str(d), dtype=torch.float32, quant="int8-a8", with_tokenizer=False, device=CPU)
    assert type(tm.blocks[0].mlp.down_proj) is QuantLinearA8 and type(tm.lm_head) is QuantLinearA8
    ids = np.random.default_rng(2).integers(0, 128, (1, 20))
    jl, _ = jax.jit(lambda m, x, c: m(x, c, last_only=False))(jm, jnp.asarray(ids, jnp.int32),
                                                               jm.init_cache(1, 32, jnp.float32))
    tl, _ = tm(torch.from_numpy(ids), tm.init_cache(1, 32, torch.float32), last_only=False)
    assert _rel(tl, jl) < 1e-2
    jl1, _ = jax.jit(lambda m, x, c: m(x, c, last_only=False))(jm, jnp.asarray(ids[:, :8], jnp.int32),
                                                                jm.init_cache(1, 32, jnp.float32))
    tl1, _ = tm(torch.from_numpy(ids[:, :8]), tm.init_cache(1, 32, torch.float32), last_only=False)
    assert _rel(tl1, jl1) < 1e-5  # 8 rows: weight-only


def test_int8_a8_twin_is_the_int8_model():
    """The same int8 weights as QuantLinear give the int8 model: the A8 mode
    changes the prefill product only (decode steps are weight-only)."""
    tm = causal_lm_from_jax_params(_params(_jax_float_model()), TextConfig(**CFG_KW), CPU)
    tqmod.quantize_model(tm, "int8-a8", min_size=1)
    ids = torch.from_numpy(np.random.default_rng(4).integers(0, 128, (3, 1)))
    cache = tm.init_cache(3, 16, torch.float32)
    a8, _ = tm(ids, cache, last_only=True)
    for mod in list(tm.modules()):
        for name, child in list(mod.named_children()):
            if isinstance(child, QuantLinearA8):
                setattr(mod, name, QuantLinear(child.qweight_t, child.scales, child.bias))
    w8, _ = tm(ids, tm.init_cache(3, 16, torch.float32), last_only=True)
    assert torch.equal(a8, w8)


@pytest.mark.parametrize("mode", ["int4-mixed", "fp8"])
def test_other_modes_still_raise(mode):
    """fp8 (no mode of the JAX package) raises; int4-mixed, ported since,
    quantizes as mode "int4" with attn_quant "int8": attention int8, the MLP
    fused int4."""
    tm = causal_lm_from_jax_params(_params(_jax_float_model()), TextConfig(**CFG_KW), CPU)
    if mode == "int4-mixed":
        tqmod.quantize_model(tm, "int4", min_size=1, attn_quant="int8")
        assert type(tm.blocks[0].attn.q_proj) is QuantLinear and isinstance(tm.blocks[0].mlp, tqmod.FusedInt4MLP)
        return
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        tqmod.quantize_model(tm, mode)
