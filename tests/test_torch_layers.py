"""mllm_tpu_torch.nn.layers against mllm_tpu.nn.layers on the same numpy
inputs (f32, CPU). Tolerance 1e-5: both sides compute in f32 and differ
only in summation order."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mllm_tpu.nn import layers as jl
from mllm_tpu_torch.nn import layers as tl

CPU = torch.device("cpu")
TOL = 1e-5


def _close(a, b, tol=TOL):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


@pytest.mark.parametrize("bias", [True, False])
def test_linear(bias):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((24, 16), dtype=np.float32) * 0.2
    b = rng.standard_normal(24).astype(np.float32) if bias else None
    x = rng.standard_normal((2, 5, 16), dtype=np.float32)
    ref = jl.Linear(jnp.asarray(w), None if b is None else jnp.asarray(b))(jnp.asarray(x))
    lin = tl.Linear(16, 24, bias, device=CPU, dtype=torch.float32)
    lin.weight.copy_(torch.from_numpy(w))
    if bias:
        lin.bias.copy_(torch.from_numpy(b))
    _close(lin(torch.from_numpy(x)), ref)


def test_embedding_and_lm_head():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((50, 16), dtype=np.float32)
    ids = rng.integers(0, 50, (2, 7))
    h = rng.standard_normal((2, 3, 16), dtype=np.float32)
    je = jl.Embedding(jnp.asarray(w))
    te = tl.Embedding(50, 16, device=CPU, dtype=torch.float32)
    te.weight.copy_(torch.from_numpy(w))
    _close(te(torch.from_numpy(ids)), je(jnp.asarray(ids)))
    out = te.as_lm_head(torch.from_numpy(h))
    assert out.dtype == torch.float32
    _close(out, je.as_lm_head(jnp.asarray(h)))


def test_rmsnorm():
    rng = np.random.default_rng(2)
    w = rng.standard_normal(16).astype(np.float32)
    x = rng.standard_normal((3, 4, 16), dtype=np.float32) * 3
    tn = tl.RMSNorm(16, 1e-6, device=CPU, dtype=torch.float32)
    tn.weight.copy_(torch.from_numpy(w))
    _close(tn(torch.from_numpy(x)), jl.RMSNorm(jnp.asarray(w), 1e-6)(jnp.asarray(x)))


@pytest.mark.parametrize("act", ["silu", "gelu", "gelu_pytorch_tanh", "relu"])
def test_activations(act):
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    _close(tl.ACT_FN[act](torch.from_numpy(x)), jl.ACT_FN[act](jnp.asarray(x)))


ROPE_CASES = {
    "hf": dict(style="hf"),
    "llama": dict(style="llama"),
    "partial": dict(style="hf", partial=0.5),
    "llama3": dict(style="hf", rope_scaling=dict(
        rope_type="llama3", factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0,
        original_max_position_embeddings=64)),
    "yarn": dict(style="hf", rope_scaling=dict(
        rope_type="yarn", factor=4.0, original_max_position_embeddings=64)),
    "ntk": dict(style="hf", rope_scaling=dict(rope_type="dynamic", factor=2.0)),
    "linear": dict(style="hf", rope_scaling=dict(rope_type="linear", factor=2.0)),
}


@pytest.mark.parametrize("case", list(ROPE_CASES))
def test_rope(case):
    kw = ROPE_CASES[case]
    head_dim, max_pos = 32, 256
    jr = jl.RotaryEmbedding.make(head_dim, max_pos, 10000.0, **kw)
    tr = tl.RotaryEmbedding.make(head_dim, max_pos, 10000.0, **kw, device=CPU)
    _close(tr.sin, jr.sin)
    _close(tr.cos, jr.cos)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 3, head_dim), dtype=np.float32)
    pos = rng.integers(0, max_pos, (2, 6))
    _close(tr(torch.from_numpy(x), torch.from_numpy(pos)), jr(jnp.asarray(x), jnp.asarray(pos)))
