"""Sequence parallelism of the port (`mllm_tpu_torch/parallel/ring_attention.py`,
`ulysses.py`, the `ring=` of `CausalLM.hidden_states` / `loss`) in one gloo
world of 4 CPU ranks (tests/torch_dist_cases.py:sequence_cases), against
the port's single-process attention and trunk and the JAX functions of
`tests/test_parallel.py` (each called once, on 2 of the 8 forced CPU
devices).

Tolerances (f32): losses 1e-5 relative; attention outputs, hidden states
and gradients 1e-5 x max|.|.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

import torch_dist_cases as cases
from mllm_tpu.core.config import TextConfig as JaxTextConfig
from mllm_tpu.models.transformer import CausalLM as JaxCausalLM

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128, eos_token_id=-3)
TOL = 1e-5
ULYSSES = ((4, 8, 4), (4, 8, 2))  # (ranks, q heads, kv heads)


@pytest.fixture(scope="module")
def jax_model():
    return JaxCausalLM.init(jax.random.PRNGKey(0), JaxTextConfig(**TINY))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(3)
    out = {"ring_q": rng.standard_normal((1, 32, 4, 16)).astype(np.float32),
           "ring_k": rng.standard_normal((1, 32, 2, 16)).astype(np.float32),
           "ring_v": rng.standard_normal((1, 32, 2, 16)).astype(np.float32),
           "trunk_ids": rng.integers(0, 128, (2, 32)), "ulysses_cases": ULYSSES}
    for _, h, hkv in ULYSSES:
        for c, heads in (("q", h), ("k", hkv), ("v", hkv)):
            out[f"ul_{c}_{h}_{hkv}"] = rng.standard_normal((2, 32, heads, 16)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def world(jax_model, inputs):
    params = {k: np.asarray(v) for k, v in jax_model.parameters().items()}
    return cases.run_world(cases.sequence_cases, 4, {"tiny": (params, TINY)}, inputs)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_full(world, causal):
    assert world[f"ring_err_{causal}"] < TOL


def test_ring_attention_gradients(world):
    """q, k and v gradients through the ring (the rotations' backward sends
    them back around it) equal sdpa's."""
    assert world["ring_grad_err"] < TOL


@pytest.mark.parametrize("p,h,hkv", ULYSSES)
def test_ulysses_attention_exact(world, p, h, hkv):
    assert world[f"ulysses_err_{h}_{hkv}"] < TOL


@pytest.mark.parametrize("mode", [(), ("ulysses",)])
def test_sequence_parallel_trunk_matches_jax(world, jax_model, inputs, mode):
    """The trunk and the loss with ring / Ulysses attention: 4 and 2 ranks
    against one process, 2 ranks against the JAX trunk and loss over a
    2-device "sp" mesh."""
    mesh = Mesh(np.array(jax.devices("cpu")[:2]), ("sp",))
    ids = jnp.asarray(inputs["trunk_ids"], jnp.int32)
    tgt = jnp.roll(ids, -1, axis=1)
    with jax.set_mesh(mesh):
        hid, _ = jax_model.hidden_states(ids, None, ring=(mesh, "sp", *mode))
        loss = float(jax_model.loss(ids, tgt, ring=(mesh, "sp", *mode)))
    assert cases.rel(world[f"trunk_{mode}_2"], np.asarray(hid)) < TOL
    for p in (4, 2):
        assert world[f"trunk_err_{mode}_{p}"] < TOL
        got, single = world[f"loss_{mode}_{p}"]
        assert abs(got - single) <= TOL * abs(single)
        assert abs(got - loss) <= TOL * abs(loss)


@pytest.mark.parametrize("mode", [(), ("ulysses",)])
def test_sequence_parallel_loss_gradients(world, mode):
    """The parameters' gradients of the ring / Ulysses loss (Ulysses with
    remat), summed over the ranks, equal one process's."""
    assert world[f"loss_grad_err_{mode}"] < TOL
