"""The port's fused int4 MLP against mllm_tpu/ops/fused_mlp.py on the same
numpy inputs (CPU, d 64, ff 256, so pick_block_f gives 256): the
block-planar packer byte for byte, the plain version against the JAX
fallback (1e-4 relative: f32 on both sides) and against the Pallas kernel in
interpret mode (2e-2 relative: the kernel rounds x and the hidden activation
to bf16, the plain version keeps f32), and the FusedInt4MLP module."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mllm_tpu.ops import fused_mlp as jfm
from mllm_tpu.ops import quant_matmul as jqm
from mllm_tpu.ops import quantize_model as jqmod
from mllm_tpu_torch.ops import fused_mlp as tfm
from mllm_tpu_torch.ops import quant_matmul as tqm
from mllm_tpu_torch.ops.quantize_model import FusedInt4MLP, Int4Operands

D, FF = 64, 256


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def _equal(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


def _ops(seed: int, affine: bool, d: int = D, ff: int = FF):
    """(gate, up, down) operand triples as numpy arrays: symmetric ones from
    float weights, or affine ones (raw nibbles, scales, zeros; the padded
    rows of gate/up stay zero)."""
    rng = np.random.default_rng(seed)
    bf = tfm.pick_block_f(ff)
    w = [rng.standard_normal(s).astype(np.float32) * 0.05 for s in ((ff, d), (ff, d), (d, ff))]
    gate, up = (jqm.prepare_int4(*jqm.repack_float_to_int4(x, 32), 32) for x in w[:2])
    down = jfm.prepare_int4_ff(*jqm.repack_float_to_int4(w[2], 32), None, bf)
    if not affine:
        return tuple((p, s, None) for p, s, _ in (gate, up, down)), bf

    def randomize(p, s, rows):
        live = s != 0
        p = (rng.integers(0, 256, p.shape) * (np.arange(p.shape[0])[:, None] < rows)).astype(np.uint8)
        s = (rng.uniform(0.002, 0.01, s.shape) * live).astype(np.float32)
        z = (rng.standard_normal(s.shape) * 0.02 * live).astype(np.float32)
        return p, s, z

    return (randomize(*gate[:2], d // 2), randomize(*up[:2], d // 2),
            randomize(*down[:2], ff // 2)), bf


def _as(ops, conv):
    return tuple(tuple(None if a is None else conv(a) for a in op) for op in ops)


@pytest.mark.parametrize("ff", [256, 512, 8960, 4864, 100])
def test_pick_block_f(ff):
    assert tfm.pick_block_f(ff) == jfm.pick_block_f(ff)


@pytest.mark.parametrize("lead", [(), (2,)], ids=["unrolled", "stacked"])
@pytest.mark.parametrize("affine", [False, True], ids=["symmetric", "affine"])
def test_prepare_int4_ff_matches(lead, affine):
    rng = np.random.default_rng(1)
    ff, n, bf = 1024, 32, 512  # two blocks
    p = rng.integers(0, 256, lead + (ff // 2, n)).astype(np.uint8)
    s = rng.uniform(0.001, 0.1, lead + (ff // 32, n)).astype(np.float32)
    z = rng.standard_normal(s.shape).astype(np.float32) if affine else None
    want = jfm.prepare_int4_ff(p, s, z, bf)
    got = tfm.prepare_int4_ff(torch.from_numpy(p), torch.from_numpy(s),
                              None if z is None else torch.from_numpy(z), bf)
    for g, w in zip(got, want):
        _equal(g, w)


@pytest.mark.parametrize("affine", [False, True], ids=["symmetric", "affine"])
def test_dequant_down_blockplanar_matches(affine):
    (_, _, down), bf = _ops(2, affine, ff=512)
    got = tfm.dequant_down_blockplanar(*_as([down], lambda a: torch.from_numpy(a))[0], 32, bf)
    want = jfm._dequant_down_blockplanar(*_as([down], jnp.asarray)[0], 32, bf)
    _equal(got, want)


CASES = [("silu", False), ("silu", True), ("gelu_new", False), ("gelu_new", True)]


@pytest.mark.parametrize("act,affine", CASES, ids=[f"{a}-{'affine' if f else 'symmetric'}"
                                                   for a, f in CASES])
def test_fused_ref_matches_jax(act, affine):
    ops, bf = _ops(3, affine)
    x = np.random.default_rng(4).standard_normal((8, D)).astype(np.float32)
    tops = _as(ops, lambda a: torch.from_numpy(a))
    got = tfm.fused_int4_mlp(torch.from_numpy(x), *tops, act=act, block_f=bf)
    assert got.dtype == torch.float32 and got.shape == (8, D)
    want = jfm.fused_int4_mlp(jnp.asarray(x), *_as(ops, jnp.asarray), act=act, block_f=bf)
    assert _rel(got, want) < 1e-4
    # the Pallas kernel (interpret mode), on the same bf16 x
    xb = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    kern = jfm.fused_int4_mlp(jnp.asarray(xb, jnp.bfloat16), *_as(ops, jnp.asarray), act=act,
                              block_f=bf, interpret=True)
    assert _rel(tfm.fused_int4_mlp_ref(torch.from_numpy(xb), *tops, act=act, block_f=bf),
                kern) < 2e-2


@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_fused_ref_other_activations(act):
    ops, bf = _ops(5, False)
    x = np.random.default_rng(6).standard_normal((3, D)).astype(np.float32)
    got = tfm.fused_int4_mlp(torch.from_numpy(x), *_as(ops, torch.from_numpy), act=act, block_f=bf)
    want = jfm.fused_int4_mlp(jnp.asarray(x), *_as(ops, jnp.asarray), act=act, block_f=bf)
    assert _rel(got, want) < 1e-4


def test_fused_module_with_bias_matches_jax():
    ops, bf = _ops(7, False)
    bias = np.random.default_rng(8).standard_normal(D).astype(np.float32)
    x = np.random.default_rng(9).standard_normal((2, 5, D)).astype(np.float32)
    jmod = jqmod.FusedInt4MLP(*_as(ops, jnp.asarray), "silu", bf, bias=jnp.asarray(bias))
    tops = [Int4Operands(*op) for op in _as(ops, torch.from_numpy)]
    tmod = FusedInt4MLP(*tops, "silu", bf, bias=torch.from_numpy(bias))
    assert set(tmod.state_dict()) == {"gate_ops.0", "gate_ops.1", "up_ops.0", "up_ops.1",
                                      "down_ops.0", "down_ops.1", "bias"}
    got = tmod(torch.from_numpy(x))
    assert got.shape == (2, 5, D)
    assert _rel(got, jmod(jnp.asarray(x))) < 1e-4


def test_fused_matches_unfused_int4_products():
    """The fused op equals the three int4 products it replaces."""
    ops, bf = _ops(10, False)
    x = torch.from_numpy(np.random.default_rng(11).standard_normal((4, D)).astype(np.float32))
    (gp, gs, _), (up, us, _), (dp, ds, _) = _as(ops, torch.from_numpy)
    h = torch.nn.functional.silu(tqm.int4_matmul(x, gp, gs)) * tqm.int4_matmul(x, up, us)
    want = h @ tfm.dequant_down_blockplanar(dp, ds, None, 32, bf)
    got = tfm.fused_int4_mlp(x, *_as(ops, torch.from_numpy), act="silu", block_f=bf)
    assert _rel(got, want) < 1e-5
