"""Two port faults against the reference, repaired (ROADMAP Queue 3):

- attention calls that the reference serves through XLA `sdpa` (an additive
  bias, a logit softcap, a prefill over a quantized cache with per-slot
  lengths) take the port's `sdpa` on every device; they raised on a card;
- the scalar multipliers (residual, embedding, logit divisor) are rounded to
  the activation dtype before use, as `jnp.asarray(rm, h.dtype)` rounds them.

Tolerances: the route is exact; `sdpa` against itself exact; the bf16 model
against the JAX CausalLM at minicpm-like multipliers within 2e-2 of max
|logit| (one bf16 rounding per op in different places), and the least-squares
scale of the port's logits on JAX's within 1e-3 of 1: a multiplier kept in f32
shifts it by ~4e-3 here (the divisor 4.0155 is 4.0 in bf16), while the
rounding differences of the two frameworks average out to ~2e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_tpu_torch.kv.cache import KVCache, QuantKVCache
from mllm_tpu_torch.models.transformer import in_dtype
from mllm_tpu_torch.nn.attention import attend, attend_from_cache, attention_route, sdpa

from test_torch_model import _jax_forward, _pair, _rel


@pytest.mark.parametrize("case,want", [
    (dict(sq=1, bias=0.0), "sdpa"),
    (dict(sq=7, logit_softcap=30.0), "sdpa"),
    (dict(sq=1, cache="quant", bias=0.0), "sdpa"),
    (dict(sq=1, cache="paged", logit_softcap=5.0), "sdpa"),
    (dict(sq=16, cache="quant", kv_valid_len=torch.tensor([16, 9])), "sdpa"),
    (dict(sq=16, cache="quant", kv_valid_len=16), "flash_quant"),
    (dict(sq=16, cache="quant", kv_valid_len=torch.tensor(16)), "flash_quant"),
    (dict(sq=1, cache="quant", kv_valid_len=torch.tensor([16, 9])), "decode_quant"),
    (dict(sq=1, cache="paged"), "decode_paged"),
    (dict(sq=1, cache="paged", kv_start=torch.tensor([0, 2])), "decode"),
    (dict(sq=8, cache="paged"), "flash"),
    (dict(sq=1), "decode"),
    (dict(sq=5, kv_valid_len=torch.tensor([5, 3])), "flash"),
], ids=["bias", "softcap", "quant_bias", "paged_softcap", "quant_per_slot_prefill",
        "quant_scalar_prefill", "quant_0d_prefill", "quant_decode", "paged_decode",
        "paged_left_pad", "paged_prefill", "dense_decode", "dense_prefill"])
def test_attention_route(case, want):
    """The route of a call, the same on a card as here: the three calls the
    reference sends to XLA sdpa go to the port's sdpa, no other call moves."""
    case = dict(case)
    sq = case.pop("sq")
    assert attention_route(sq, **case) == want


def test_bias_and_softcap_take_sdpa():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, 3, 4, 16), dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 2, 9, 16), dtype=np.float32)) for _ in range(2))
    bias = torch.from_numpy(rng.standard_normal((2, 4, 3, 9), dtype=np.float32))
    for kw in (dict(bias=bias), dict(logit_softcap=2.0), dict(bias=bias, logit_softcap=2.0)):
        out = attend(q, k, v, q_offset=6, kv_valid_len=9, **kw)
        assert torch.equal(out, sdpa(q, k, v, q_offset=6, kv_valid_len=9, **kw))


def test_quant_cache_prefill_with_per_slot_lengths_takes_sdpa():
    rng = np.random.default_rng(1)
    cache = QuantKVCache.init(1, 2, 128, 2, 16, device="cpu")
    new = [torch.from_numpy(rng.standard_normal((2, 12, 2, 16), dtype=np.float32)) for _ in range(2)]
    cache.update_layer(0, *new)
    q = torch.from_numpy(rng.standard_normal((2, 12, 4, 16), dtype=np.float32)).to(torch.bfloat16)
    kvl = torch.tensor([12, 7], dtype=torch.int32)
    out = attend_from_cache(q, cache, 0, kv_valid_len=kvl)
    assert torch.equal(out, sdpa(q, *cache.layer(0), kv_valid_len=kvl))
    dense = KVCache.init(1, 2, 128, 2, 16, device="cpu", dtype=torch.bfloat16)
    assert attend_from_cache(q, dense, 0, kv_valid_len=kvl).shape == q.shape


@pytest.mark.parametrize("value", [1.4 / 40**0.5, 1.4 / 2**0.5, 2048**0.5, 12.1, 4.0155, 1.0])
def test_in_dtype_rounds_as_jax(value):
    want = float(jnp.asarray(value, jnp.bfloat16).astype(jnp.float32))
    assert in_dtype(value, torch.bfloat16) == want
    assert in_dtype(value, torch.float32) == float(np.float32(value))


def test_bf16_minicpm_multipliers_match_jax():
    """bf16 CausalLM with residual 1.4/sqrt(2), embedding x12.1 and logits
    / 4.0155 against the JAX CausalLM on the same weights."""
    jm, tm = _pair(jdtype=jnp.bfloat16, tdtype=torch.bfloat16, residual_multiplier=1.4 / 2**0.5,
                   embedding_multiplier=12.1, logit_divisor=4.0155)
    ids = np.random.default_rng(0).integers(0, 128, (2, 11))
    jl, _ = _jax_forward(jm, jnp.asarray(ids, jnp.int32), jm.init_cache(2, 32, jnp.bfloat16))
    tl, _ = tm(torch.from_numpy(ids), tm.init_cache(2, 32, torch.bfloat16), last_only=False)
    assert _rel(tl, jl) < 2e-2
    a = tl.double().numpy().ravel()
    b = np.asarray(jl, np.float64).ravel()
    assert abs(a @ b / (b @ b) - 1) < 1e-3
