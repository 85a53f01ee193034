"""Pipeline and expert parallelism of the port (`mllm_tpu_torch/parallel/
pipeline.py`, `expert.py`) in one gloo world of 4 CPU ranks
(tests/torch_dist_cases.py:pipeline_ep_cases), against the port's
single-process results and the JAX functions of `tests/test_parallel.py`
(each called once, on 2 of the 8 forced CPU devices).

Tolerances (f32): losses 1e-5 relative; hidden states, MoE outputs and
gradients 1e-5 x max|.| (the stage-tanh chain 1e-5 against numpy f64).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

import torch_dist_cases as cases
from mllm_tpu.core.config import TextConfig as JaxTextConfig
from mllm_tpu.models.transformer import CausalLM as JaxCausalLM
from mllm_tpu_torch.models.bridge import port_state_dict

L4 = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=4, num_attention_heads=4,
          num_key_value_heads=2, max_position_embeddings=128, eos_token_id=-3)
TOL = 1e-5


@pytest.fixture(scope="module")
def jax_model():
    return JaxCausalLM.init(jax.random.PRNGKey(0), JaxTextConfig(**L4))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    s, m, mb, d = 4, 6, 2, 16
    e, dm, ff = 4, 16, 32
    ids = rng.integers(0, 128, (8, 16))
    return {"stage_w": (rng.standard_normal((s, d, d)) * 0.3).astype(np.float32),
            "stage_x": rng.standard_normal((m, mb, d)).astype(np.float32),
            "pp_ids": ids, "pp_tgt": np.roll(ids, -1, axis=1),
            "moe": {"router_weight": rng.standard_normal((e, dm)).astype(np.float32),
                    "w_gate": (rng.standard_normal((e, dm, ff)) * 0.1).astype(np.float32),
                    "w_up": (rng.standard_normal((e, dm, ff)) * 0.1).astype(np.float32),
                    "w_down": (rng.standard_normal((e, ff, dm)) * 0.1).astype(np.float32)},
            "moe_x": rng.standard_normal((2, 3, dm)).astype(np.float32)}


@pytest.fixture(scope="module")
def world(jax_model, inputs):
    params = {k: np.asarray(v) for k, v in jax_model.parameters().items()}
    return cases.run_world(cases.pipeline_ep_cases, 4, {"l4": (params, L4)}, inputs)


def test_pipeline_forward_matches_sequential_stages(world, inputs):
    ref = inputs["stage_x"].astype(np.float64)
    for w in inputs["stage_w"]:
        ref = np.tanh(ref @ w)
    assert cases.rel(world["pipeline_forward"], ref) < TOL


def test_pipeline_real_decoder_blocks(world):
    assert world["hidden_err"] < TOL


def test_pipeline_lm_loss_and_grads_match_jax(world, jax_model, inputs):
    """The port's 4-stage GPipe loss and its gradients (summed over the
    stages) against the JAX 2-stage `pipeline_lm_loss` and `jax.grad` of it;
    the port's 2-stage loss too."""
    from mllm_tpu.parallel.pipeline import pipeline_lm_loss

    mesh = Mesh(np.array(jax.devices("cpu")[:2]), ("pp",))
    ids, tgt = jnp.asarray(inputs["pp_ids"], jnp.int32), jnp.asarray(inputs["pp_tgt"], jnp.int32)
    loss, grads = jax.value_and_grad(lambda m: pipeline_lm_loss(m, ids, tgt, mesh, n_microbatches=2))(jax_model)
    loss = float(loss)
    got, single = world["pp_loss"]
    for value in (got, single, world["pp2_loss"]):
        assert abs(value - loss) <= TOL * abs(loss)
    assert world["pp_grad_err"] < TOL
    want = port_state_dict({k: np.asarray(v) for k, v in grads.parameters().items()}, 4)
    for name, g in world["pp_grads"].items():
        assert cases.rel(g, want[name]) < TOL, name


def test_expert_parallel_moe_matches_jax(world, inputs):
    from mllm_tpu.models.moe import MoEMLP
    from mllm_tpu.parallel.expert import moe_forward_ep

    w = {k: jnp.asarray(v) for k, v in inputs["moe"].items()}
    moe = MoEMLP(w["router_weight"], w["w_gate"], w["w_up"], w["w_down"], top_k=2, norm_topk_prob=True, act="silu")
    mesh = Mesh(np.array(jax.devices("cpu")[:2]), ("ep",))
    want = np.asarray(moe_forward_ep(moe, jnp.asarray(inputs["moe_x"]), mesh, axis="ep"))
    for key in ("ep2", "ep4", "ep_module"):
        assert cases.rel(world[key], want) < TOL, key


def test_expert_parallel_gradients(world):
    """Gradients through the expert shards: x's (whole on every rank) and
    the expert stacks' and the router's (each rank's share, summed over the
    ranks) equal the module's."""
    assert world["ep_grad_err"] < TOL
