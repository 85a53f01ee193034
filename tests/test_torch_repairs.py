"""Port faults against the reference, repaired (ROADMAP Queue 3):

- attention calls that the reference serves through XLA `sdpa` (an additive
  bias, a logit softcap, a prefill over a quantized cache with per-slot
  lengths, a head_dim other than the kernels' 64 and 128) take the port's
  `sdpa` on every device; they raised on a card;
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
    *[(dict(sq=sq, cache=cache, head_dim=d),
       "sdpa" if d != 256 else {"dense": {1: "decode", 16: "flash"}, "paged": {1: "decode_paged", 16: "flash"},
                                "quant": {1: "decode_quant", 16: "flash_quant"}}[cache][sq])
      for d in (80, 96, 256) for cache in ("dense", "paged", "quant") for sq in (1, 16)],
    *[(dict(sq=sq, cache=cache, head_dim=d), want) for d in (64, 128)
      for cache, sq, want in (("dense", 1, "decode"), ("dense", 16, "flash"), ("paged", 1, "decode_paged"),
                              ("paged", 16, "flash"), ("quant", 1, "decode_quant"),
                              ("quant", 16, "flash_quant"))],
], ids=["bias", "softcap", "quant_bias", "paged_softcap", "quant_per_slot_prefill",
        "quant_scalar_prefill", "quant_0d_prefill", "quant_decode", "paged_decode",
        "paged_left_pad", "paged_prefill", "dense_decode", "dense_prefill",
        *[f"head_dim{d}_{cache}_sq{sq}" for d in (80, 96, 256) for cache in ("dense", "paged", "quant")
          for sq in (1, 16)],
        *[f"head_dim{d}_{cache}_sq{sq}_kernel" for d in (64, 128)
          for cache, sq in (("dense", 1), ("dense", 16), ("paged", 1), ("paged", 16), ("quant", 1),
                            ("quant", 16))]])
def test_attention_route(case, want):
    """The route of a call, the same on a card as here: the calls the
    reference sends to XLA sdpa (a bias, a softcap, a per-slot quantized
    prefill, a head_dim the kernels do not take: 80 and 96 on every cache)
    go to the port's sdpa; 256 reaches the kernels of every cache, the
    quantized ones included, as the reference runs its Pallas kernels there.
    No other call moves."""
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


@pytest.mark.parametrize("head_dim", [80, 96, 256])
def test_head_dim_outside_the_kernels_takes_sdpa(monkeypatch, head_dim):
    """attend and attend_from_cache (dense, paged, int8 and int4 caches) at a
    head_dim no kernel takes call none of the kernels' wrappers, whose CUDA
    entries would raise on it, and give `sdpa` over the (dequantized or
    gathered) layer; a 2-layer model at that head_dim generates. 256 is
    inside the kernels of every cache: the dense and paged calls reach the
    bf16 kernels' plain versions, within 1e-5 of `sdpa`, and the quantized
    caches' calls the quantized kernels' plain version on the stored K/V."""
    import mllm_tpu_torch.nn.attention as att
    from mllm_tpu_torch.core.config import TextConfig
    from mllm_tpu_torch.generation.generate import generate
    from mllm_tpu_torch.generation.sampling import SamplingConfig
    from mllm_tpu_torch.kv.cache import PagedKVCache, Quant4KVCache
    from mllm_tpu_torch.models.transformer import CausalLM
    from mllm_tpu_torch.ops.flash_attention import flash_attention_quant_ref

    bf16_kernels = head_dim == 256
    if bf16_kernels:  # the kernel routes in this test's f32 (the kernels themselves take bf16 only)
        monkeypatch.setattr(att, "KERNEL_DTYPES", (torch.bfloat16, torch.float32))
    else:
        for name in ("flash_attention", "decode_attention", "flash_attention_quant", "decode_attention_quant",
                     "decode_attention_paged"):
            monkeypatch.setattr(att, name, lambda *a, _n=name, **k: pytest.fail(f"{_n} at head_dim {head_dim}"))

    def same(a, b, kernel_route):
        return torch.allclose(a, b, rtol=1e-5, atol=1e-5) if kernel_route else torch.equal(a, b)

    rng = np.random.default_rng(head_dim)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))

    q1, q8 = t(2, 1, 4, head_dim), t(2, 8, 4, head_dim)
    k, v = t(2, 2, 16, head_dim), t(2, 2, 16, head_dim)
    for q in (q1, q8):
        assert same(attend(q, k, v, q_offset=16 - q.shape[1], kv_valid_len=16),
                    sdpa(q, k, v, q_offset=16 - q.shape[1], kv_valid_len=16), bf16_kernels)
    caches = [KVCache.init(1, 2, 128, 2, head_dim, device="cpu", dtype=torch.float32),
              QuantKVCache.init(1, 2, 128, 2, head_dim, device="cpu"),
              Quant4KVCache.init(1, 2, 128, 2, head_dim, device="cpu"),
              PagedKVCache.init(1, 2, 256, 2, head_dim, device="cpu", dtype=torch.float32, n_blocks=4)]
    for cache in caches:
        if isinstance(cache, PagedKVCache):
            cache = cache.with_tables(np.array([[0, 1], [2, 3]], np.int32))
        cache = cache.update_layer(0, t(2, 8, 2, head_dim), t(2, 8, 2, head_dim))
        out = attend_from_cache(q8, cache, 0, kv_valid_len=8)
        if bf16_kernels and isinstance(cache, (QuantKVCache, Quant4KVCache)):
            assert torch.equal(out, flash_attention_quant_ref(q8, *cache.layer_quant(0), kv_valid_len=8))
        else:
            assert same(out, sdpa(q8, *cache.layer(0), kv_valid_len=8), bf16_kernels)
    cfg = TextConfig(vocab_size=64, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                     num_attention_heads=4, num_key_value_heads=2, head_dim=head_dim, eos_token_id=-1)
    model = CausalLM.init(cfg, device="cpu")
    res, _ = generate(model, np.arange(5), model.init_cache(1, 64, torch.float32), SamplingConfig(max_new_tokens=4),
                      bucket=8)
    assert len(res.tokens) == 4


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_float32_attention_takes_sdpa(monkeypatch, dtype):
    """A query that is not bf16 takes `sdpa` on every cache kind and query
    length, and in `attend_padded_head` on a (pretend) card: the CUDA
    kernels are bf16-only (the Pallas kernels run in the input's dtype). The
    same calls in bf16 keep their kernel routes. An f32 model's `generate`
    over a dense and an int8 cache calls none of the five attention
    wrappers (whose CUDA entries raise on f32); a bf16 one calls them."""
    import mllm_tpu_torch.nn.attention as att
    from mllm_tpu_torch.core.config import TextConfig
    from mllm_tpu_torch.generation.generate import generate
    from mllm_tpu_torch.generation.sampling import SamplingConfig
    from mllm_tpu_torch.models.transformer import CausalLM

    kernel = {"dense": {1: "decode", 16: "flash"}, "paged": {1: "decode_paged", 16: "flash"},
              "quant": {1: "decode_quant", 16: "flash_quant"}}
    for cache, by_sq in kernel.items():
        for sq, want in by_sq.items():
            assert attention_route(sq, cache=cache, head_dim=128, dtype=dtype) == "sdpa"
            assert attention_route(sq, cache=cache, head_dim=128, dtype=torch.bfloat16) == want

    calls = []
    for name in ("flash_attention", "decode_attention", "flash_attention_quant", "decode_attention_quant",
                 "decode_attention_paged"):
        real = getattr(att, name)
        monkeypatch.setattr(att, name, lambda *a, _n=name, _f=real, **k: calls.append(_n) or _f(*a, **k))
    q = torch.empty(1, 64, 4, 80, device="meta", dtype=dtype)
    k = torch.empty(1, 4, 64, 80, device="meta", dtype=dtype)
    monkeypatch.setattr(att, "sdpa", lambda *a, **kw: "sdpa")
    assert att.attend_padded_head(q, k, k, causal=False) == "sdpa" and calls == []
    monkeypatch.undo()

    for name in ("flash_attention", "decode_attention", "flash_attention_quant", "decode_attention_quant",
                 "decode_attention_paged"):
        real = getattr(att, name)
        monkeypatch.setattr(att, name, lambda *a, _n=name, _f=real, **k: calls.append(_n) or _f(*a, **k))
    cfg = TextConfig(vocab_size=64, hidden_size=128, intermediate_size=128, num_hidden_layers=2,
                     num_attention_heads=2, num_key_value_heads=1, head_dim=64, eos_token_id=-1)
    for model_dtype in (dtype, torch.bfloat16):
        model = CausalLM.init(cfg, device="cpu", dtype=model_dtype)
        for kv in ("bf16", "int8"):
            calls.clear()
            res, _ = generate(model, np.arange(5), model.init_cache(1, 64, model_dtype, kv_dtype=kv),
                              SamplingConfig(max_new_tokens=3), bucket=8)
            assert len(res.tokens) == 3
            if model_dtype == torch.bfloat16:
                assert calls, f"bf16 over {kv} reached no kernel wrapper"
            else:
                assert calls == [], f"{model_dtype} over {kv} reached {sorted(set(calls))}"


def test_megakernel_refuses_an_f32_cache_before_launching(monkeypatch):
    """The whole-trunk kernel reads a bf16 cache (the Pallas one reads the
    cache's dtype): an f32 cache raises TypeError in the operand check, before
    any launch (meta tensors stand in for the card's, and a library whose
    entries fail the test stands in for the built kernels)."""
    from types import SimpleNamespace

    from mllm_tpu_torch.ops import decode_step as ds
    from mllm_tpu_torch.ops.decode_step import fused_decode_step

    entry = lambda *a: pytest.fail("launched")  # noqa: E731
    monkeypatch.setattr(ds._build, "library", lambda: SimpleNamespace(mllm_fused_decode_step_bf16=entry))

    meta, u8, bf, f32 = "meta", torch.uint8, torch.bfloat16, torch.float32
    L, d, h, hkv, hd, ff, s = 1, 256, 2, 1, 128, 640, 64
    nqkv = (h + 2 * hkv) * hd

    def e(*shape, dtype=u8):
        return torch.empty(shape, device=meta, dtype=dtype)

    ops = dict(qkv_ops=(e(L, d // 2, nqkv), e(L, d // 64, nqkv, dtype=bf), e(L, nqkv, dtype=f32)),
               o_ops=(e(L, h * hd // 2, d), e(L, h * hd // 64, d, dtype=bf)),
               gate_ops=(e(L, d // 2, ff), e(L, d // 64, ff, dtype=bf)),
               up_ops=(e(L, d // 2, ff), e(L, d // 64, ff, dtype=bf)),
               down_ops=(e(L, ff // 2, d), e(L, ff // 32, d, dtype=bf)),
               norm1_w=e(L, 1, d, dtype=f32), norm2_w=e(L, 1, d, dtype=f32))
    before = fused_decode_step.launches
    for cache_dtype in (f32, torch.float16):
        kv = e(L, 1, hkv, s, hd, dtype=cache_dtype)
        with pytest.raises(TypeError, match="bfloat16"):
            fused_decode_step(e(1, d, dtype=bf), 5, e(hd, hd, dtype=f32), **ops, k_cache=kv, v_cache=kv,
                              n_heads=h, n_kv_heads=hkv, head_dim=hd)
    assert fused_decode_step.launches == before
