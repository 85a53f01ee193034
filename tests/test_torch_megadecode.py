"""The port's whole-trunk int4 decode step (ops/decode_step.py,
models/megadecode.py) against mllm_tpu on the same weights (CPU), on the
CFG of tests/test_decode_step.py (2 layers, hidden 512, head_dim 128, qkv
bias, tied embeddings). The JAX side is `MegaDecodeLM.from_float(model.stack(),
interpret=True)`, its Pallas megakernels run in interpret mode; the port's
MegaDecodeLM is `from_float` of the bridged float model, and its decode step
runs the plain version on CPU tensors.

Tolerances:
  - operand stacks, norms, bias and the rotation matrix: bit for bit;
  - op level, max |port - JAX| / max |JAX| <= 3e-2 on y and the new K/V. The
    whole gap is the Pallas kernel's bf16 group sum of x (ROADMAP Queue 3):
    observed 0.4-1.3 %, and emulating that sum brings layer 0's K/V to 1e-5
    (`test_gap_is_the_bf16_group_sum`);
  - model level, logits and the new K/V within the JAX test file's own
    rtol = atol = 0.05, and greedy tokens equal.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mllm_tpu.core.config import TextConfig as JaxTextConfig
from mllm_tpu.models.megadecode import MegaDecodeLM as JaxMegaDecodeLM
from mllm_tpu.models.transformer import CausalLM as JaxCausalLM
from mllm_tpu.ops import decode_step as jds
from mllm_tpu_torch.core.config import TextConfig
from mllm_tpu_torch.generation import generate as tgen
from mllm_tpu_torch.generation.sampling import SamplingConfig
from mllm_tpu_torch.kv.cache import KVCache
from mllm_tpu_torch.models.bridge import _same_bits, causal_lm_from_jax_params, mega_decode_from_jax
from mllm_tpu_torch.models.megadecode import MegaDecodeLM
from mllm_tpu_torch.ops import decode_step as tds

CPU = torch.device("cpu")
CFG_KW = dict(vocab_size=512, hidden_size=512, intermediate_size=512, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, head_dim=128,
              max_position_embeddings=256, attention_bias=True, tie_word_embeddings=True,
              model_type="qwen2")  # the CFG of tests/test_decode_step.py
CFG = JaxTextConfig(**CFG_KW)
OP_TOL = 3e-2
L, HKV, S = CFG.num_hidden_layers, CFG.num_key_value_heads, 256
TCFG = TextConfig(**CFG_KW)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _bits(t):
    a = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
    return np.ascontiguousarray(a).view(np.uint8)


def _jbits(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def _float_params():
    jm = JaxCausalLM.init(jax.random.PRNGKey(0), CFG)
    return jm, {k: np.asarray(v) for k, v in jm.parameters().items()}


@pytest.fixture(scope="module")
def megas():
    """(JAX MegaDecodeLM, the port's from_float of the same float weights)."""
    jm, params = _float_params()
    jmega = JaxMegaDecodeLM.from_float(jm.stack(), interpret=True)
    tmega = MegaDecodeLM.from_float(causal_lm_from_jax_params(params, TCFG, CPU))
    return jmega, tmega


def _kw(jmega):
    return dict(n_heads=CFG.num_attention_heads, n_kv_heads=HKV, head_dim=128, act=CFG.hidden_act,
                eps=CFG.rms_norm_eps, block_f=jmega.block_f, group_a=jmega.group_a)


def _tops(m):
    return (m.qkv_ops.astuple(), m.o_ops.astuple()[:2], m.gate_ops.astuple()[:2],
            m.up_ops.astuple()[:2], m.down_ops.astuple()[:2], m.norm1_w, m.norm2_w)


def _jops(m):
    return (m.qkv_ops, m.o_ops, m.gate_ops, m.up_ops, m.down_ops, m.norm1_w, m.norm2_w)


def _cache(rng, b):
    """A random bf16 cache pair, as (jax arrays, torch tensors) of the same values."""
    kc, vc = (rng.standard_normal((L, b, HKV, S, 128)).astype(np.float32) for _ in range(2))
    return ((jnp.asarray(kc, jnp.bfloat16), jnp.asarray(vc, jnp.bfloat16)),
            (torch.from_numpy(kc).bfloat16(), torch.from_numpy(vc).bfloat16()))


# ---------------------------------------------------------------------------
# (a), (b): the same bytes as JAX
# ---------------------------------------------------------------------------


def test_operands_byte_equal(megas):
    jmega, tmega = megas
    jp = jmega.parameters()
    ours = {k: v for k, v in tmega.state_dict().items() if not k.startswith("base.")}
    assert set(ours) == {k for k in jp if not k.startswith("base.")}
    for k, v in ours.items():
        assert v.dtype == {"uint8": torch.uint8, "bfloat16": torch.bfloat16,
                           "float32": torch.float32}[str(jp[k].dtype)], k
        assert tuple(v.shape) == jp[k].shape and np.array_equal(_bits(v), _jbits(jp[k])), k
    assert (tmega.block_f, tmega.group_a) == (jmega.block_f, jmega.group_a) == (512, 128)
    # the int4 head: the same packed bytes, and the bf16 scales' values in f32
    head = tmega.base.embed_tokens.proj
    assert np.array_equal(head.packed_t.numpy(), np.asarray(jp["base.embed_tokens.proj.packed_t"]))
    assert np.array_equal(head.scales_t.numpy(),
                          np.asarray(jp["base.embed_tokens.proj.scales_t"], np.float32))
    # base's blocks hold views of the stacked packed bytes
    p0 = tmega.qkv_ops.astuple()[0]
    assert tmega.base.blocks[1].attn.qkv_proj.packed_t.data_ptr() == p0[1].data_ptr()


def test_rope_rotation_matrix_equal():
    rng = np.random.default_rng(0)
    sin, cos = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    got = tds.rope_rotation_matrix(torch.from_numpy(sin), torch.from_numpy(cos))
    want = jds.rope_rotation_matrix(jnp.asarray(sin), jnp.asarray(cos))
    assert np.array_equal(got.numpy(), np.asarray(want))
    x = rng.standard_normal((3, 128)).astype(np.float32)
    x1, x2 = x[:, :64], x[:, 64:]  # rotate_half
    rotated = np.concatenate([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    np.testing.assert_allclose((torch.from_numpy(x) @ got).numpy(), rotated, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# (c), (d): the plain versions against the JAX kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pos", [0, 9, 200])
def test_fused_decode_step_matches_jax(megas, pos):
    jmega, tmega = megas
    rng = np.random.default_rng(pos)
    (jk, jv), (tk, tv) = _cache(rng, 1)
    x = rng.standard_normal((1, CFG.hidden_size)).astype(np.float32) * 0.05
    sin, cos = jmega.base.rope.sin[pos], jmega.base.rope.cos[pos]
    want = jds.fused_decode_step(jnp.asarray(x), pos, jds.rope_rotation_matrix(sin, cos),
                                 *_jops(jmega), jk, jv, interpret=True, **_kw(jmega))
    rot = tds.rope_rotation_matrix(tmega.base.rope.sin[pos], tmega.base.rope.cos[pos])
    got = tds.fused_decode_step(torch.from_numpy(x), pos, rot, *_tops(tmega), tk, tv, **_kw(jmega))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert _rel(g, w) < OP_TOL


@pytest.mark.parametrize("kv_start", [None, [0, 17, 3, 60]], ids=["no_kv_start", "kv_start"])
def test_fused_decode_step_batched_matches_jax(megas, kv_start):
    """b = 4 at unequal positions (one slot past a 128-row KV block of the
    JAX kernel, one inside the first), with and without per-slot kv_start."""
    jmega, tmega = megas
    rng = np.random.default_rng(5)
    (jk, jv), (tk, tv) = _cache(rng, 4)
    x = rng.standard_normal((4, CFG.hidden_size)).astype(np.float32) * 0.05
    pos = np.array([5, 200, 130, 70], np.int32)
    sin = jnp.take(jmega.base.rope.sin, pos, axis=0)
    cos = jnp.take(jmega.base.rope.cos, pos, axis=0)
    kvs = None if kv_start is None else np.array(kv_start, np.int32)
    want = jds.fused_decode_step_batched(
        jnp.asarray(x), jnp.asarray(pos), sin, cos, *_jops(jmega), jk, jv, block_k=128, slot_group=4,
        kv_start=None if kvs is None else jnp.asarray(kvs), interpret=True, **_kw(jmega))
    got = tds.fused_decode_step_batched(
        torch.from_numpy(x), torch.from_numpy(pos), torch.from_numpy(np.array(sin)),
        torch.from_numpy(np.array(cos)), *_tops(tmega), tk, tv, block_k=128, slot_group=4,
        kv_start=None if kvs is None else torch.from_numpy(kvs), **_kw(jmega))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g, w) < OP_TOL


@pytest.mark.parametrize("batched", [False, True], ids=["b1", "batched"])
@pytest.mark.parametrize("pos,kv_start,match", [
    (9, -1, "negative"), (9, 10, "past pos"), (S, 0, "outside the cache"), (-1, None, "outside the cache"),
])
def test_bad_window_raises(megas, batched, pos, kv_start, match):
    """A host window outside 0 <= kv_start <= pos < S raises before either
    the kernel or the plain version reads the cache."""
    jmega, tmega = megas
    rng = np.random.default_rng(2)
    _, (tk, tv) = _cache(rng, 2 if batched else 1)
    rope = tmega.base.rope
    with pytest.raises(ValueError, match=match):
        if batched:  # the bad window in slot 0, a good one in slot 1
            p = torch.tensor([pos, 5])
            kvs = None if kv_start is None else torch.tensor([kv_start, 0])
            tds.fused_decode_step_batched(torch.zeros(2, CFG.hidden_size), p, rope.sin[:2], rope.cos[:2],
                                          *_tops(tmega), tk, tv, kv_start=kvs, **_kw(jmega))
        else:
            tds.fused_decode_step(torch.zeros(1, CFG.hidden_size), pos,
                                  tds.rope_rotation_matrix(rope.sin[0], rope.cos[0]), *_tops(tmega), tk, tv,
                                  kv_start=kv_start, **_kw(jmega))


def test_gap_is_the_bf16_group_sum(megas):
    """Layer 0's new K/V: the port's per-weight f32 dequant differs from the
    Pallas `_gdot_sym` only by its bf16 group sum of x; summing x in bf16 per
    group as it does gives the JAX K/V to 1e-5."""
    jmega, tmega = megas
    rng = np.random.default_rng(9)
    (jk, jv), _ = _cache(rng, 1)
    x = rng.standard_normal((1, CFG.hidden_size)).astype(np.float32) * 0.05
    pos = 9
    rot = jds.rope_rotation_matrix(jmega.base.rope.sin[pos], jmega.base.rope.cos[pos])
    _, jkn, jvn = jds.fused_decode_step(jnp.asarray(x), pos, rot, *_jops(jmega), jk, jv,
                                        interpret=True, **_kw(jmega))
    xn = tds._rms_bf16(torch.from_numpy(x), tmega.norm1_w[0, 0], CFG.rms_norm_eps)
    packed, scales, bias = tmega.qkv_ops.astuple()
    g, kh = tmega.group_a, CFG.hidden_size // 2
    lo, hi = (packed[0] & 15).float(), (packed[0] >> 4).float()
    qkv = bias[0].clone()
    for i in range(kh // g):
        for half, nib in ((0, lo), (1, hi)):
            xs = xn[:, half * kh + i * g : half * kh + (i + 1) * g]
            xsum = xs.sum(1, keepdim=True).bfloat16().float()
            qkv = qkv + (xs @ nib[i * g : (i + 1) * g] - 8 * xsum) * scales[0, half * (kh // g) + i].float()
    n_q = CFG.num_attention_heads * 128
    k = qkv[:, n_q : n_q + HKV * 128].reshape(HKV, 128) @ torch.from_numpy(np.asarray(rot))
    v = qkv[:, n_q + HKV * 128 :].reshape(HKV, 128)
    assert _rel(k, np.asarray(jkn)[0]) < 1e-5 and _rel(v, np.asarray(jvn)[0]) < 1e-5
    _, tkn, _ = tds.fused_decode_step(torch.from_numpy(x), pos, torch.from_numpy(np.asarray(rot)),
                                      *_tops(tmega), *_cache(rng, 1)[1], **_kw(jmega))
    assert 1e-5 < _rel(tkn[0], np.asarray(jkn)[0]) < OP_TOL  # the port does not round the sum


# ---------------------------------------------------------------------------
# (e): MegaDecodeLM against the JAX MegaDecodeLM
# ---------------------------------------------------------------------------


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32), rtol=0.05, atol=0.05)


def test_single_step_matches_jax(megas):
    jmega, tmega = megas
    ids = np.random.RandomState(0).randint(0, 512, (1, 9))
    _, jc = jmega.base(jnp.asarray(ids), jmega.init_cache(1, S), last_only=True)
    jl, jc = jmega(jnp.asarray([[7]]), jc, last_only=True)
    _, tc = tmega(torch.from_numpy(ids), tmega.init_cache(1, S))  # prefill goes to base
    tl, tc = tmega(torch.tensor([[7]]), tc)
    assert tl.shape == (1, 1, CFG.vocab_size) and tc.pos == int(jc.pos) == 10
    _close(tl[0, 0], jl[0, 0])
    assert int(tl[0, 0].argmax()) == int(np.argmax(np.asarray(jl[0, 0])))
    _close(tc.k[:, 0, :, 9].float(), np.asarray(jc.k[:, 0, :, 9], np.float32))
    _close(tc.v[:, 0, :, 9].float(), np.asarray(jc.v[:, 0, :, 9], np.float32))


def test_generate_greedy_tokens_match_jax(megas):
    """`generate` on the port's MegaDecodeLM gives the JAX MegaDecodeLM's
    greedy tokens (prefill by base, then 4 megakernel steps)."""
    jmega, tmega = megas
    ids = np.random.RandomState(1).randint(0, 512, (1, 5))
    logits, jc = jmega.base(jnp.asarray(ids), jmega.init_cache(1, S), last_only=True)
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None]
    want = [int(tok[0, 0])]
    for _ in range(4):
        logits, jc = jmega(tok, jc, last_only=True)
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None]
        want.append(int(tok[0, 0]))
    res, cache = tgen.generate(tmega, ids, tmega.init_cache(1, S),
                               SamplingConfig(max_new_tokens=5), bucket=16)
    assert res.tokens == want and cache.pos == 9


def test_empty_cache_first_token_matches_jax(megas):
    """pos = 0: the softmax sees only the current token."""
    jmega, tmega = megas
    jl, _ = jmega(jnp.asarray([[3]]), jmega.init_cache(1, S), last_only=True)
    tl, tc = tmega(torch.tensor([[3]]), tmega.init_cache(1, S))
    _close(tl[0, 0], jl[0, 0])
    assert tc.pos == 1


def test_batched_lockstep_matches_jax(megas):
    """b = 3 lockstep: one batched megakernel step after a base prefill, and
    `batched_generate` through it."""
    jmega, tmega = megas
    rs = np.random.RandomState(2)
    ids = rs.randint(0, 512, (3, 7))
    tok = rs.randint(0, 512, (3, 1))
    jl0, jc = jmega.base(jnp.asarray(ids), jmega.init_cache(3, S), last_only=True)
    jl, jc = jmega(jnp.asarray(tok), jc, last_only=True)
    _, tc = tmega(torch.from_numpy(ids), tmega.init_cache(3, S))
    tl, tc = tmega(torch.from_numpy(tok), tc)
    _close(tl[:, 0], jl[:, 0])
    assert tl[:, 0].argmax(-1).tolist() == np.argmax(np.asarray(jl[:, 0]), -1).tolist()
    for new, jnew in ((tc.k, jc.k), (tc.v, jc.v)):
        _close(new[:, :, :, 7].float(), np.asarray(jnew[:, :, :, 7], np.float32))

    first = jnp.argmax(jl0[:, -1], axis=-1)[:, None]
    jl1, _ = jmega(first, jmega.base(jnp.asarray(ids), jmega.init_cache(3, S), last_only=True)[1],
                   last_only=True)
    toks, _ = tgen.batched_generate(tmega, ids, np.full(3, 7), tmega.init_cache(3, S),
                                    SamplingConfig(max_new_tokens=2))
    assert toks[:, 0].tolist() == np.asarray(first[:, 0]).tolist()
    assert toks[:, 1].tolist() == np.argmax(np.asarray(jl1[:, 0]), -1).tolist()


# ---------------------------------------------------------------------------
# (f), (g): the bridge, the gates, and the calls that go to base
# ---------------------------------------------------------------------------


def test_mega_decode_from_jax_equals_from_float(megas):
    jmega, tmega = megas
    params = {k: np.asarray(v) for k, v in jmega.parameters().items()}
    bridged = mega_decode_from_jax(params, TCFG, CPU)
    got, want = bridged.state_dict(), tmega.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    ids = torch.from_numpy(np.random.RandomState(3).randint(0, 512, (2, 6)))
    outs = []
    for m in (bridged, tmega):
        _, c = m(ids, m.init_cache(2, S))
        logits, c = m(torch.tensor([[4], [5]]), c)
        outs.append((logits, c.k))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


def test_untied_head_matches_jax():
    """An untied lm_head becomes the padded int4 head (`_PaddedHead`) with the
    JAX head's bytes and bf16 scale values; prefill logits equal JAX's."""
    kw = {**CFG_KW, "tie_word_embeddings": False, "vocab_size": 300, "num_hidden_layers": 1}
    jm = JaxCausalLM.init(jax.random.PRNGKey(1), JaxTextConfig(**kw))
    params = {k: np.asarray(v) for k, v in jm.parameters().items()}
    jmega = JaxMegaDecodeLM.from_float(jm.stack(), interpret=True)
    tmega = MegaDecodeLM.from_float(causal_lm_from_jax_params(params, TextConfig(**kw), CPU))
    jp = jmega.parameters()
    head = tmega.lm_head.proj
    assert tmega.lm_head.vocab == 300 and head.packed_t.shape == (256, 512)
    assert np.array_equal(head.packed_t.numpy(), np.asarray(jp["base.lm_head.proj.packed_t"]))
    assert np.array_equal(head.scales_t.numpy(), np.asarray(jp["base.lm_head.proj.scales_t"], np.float32))
    ids = np.random.RandomState(7).randint(0, 300, (1, 6))
    jl, _ = jmega(jnp.asarray(ids), jmega.init_cache(1, S), last_only=False)
    tl, _ = tmega(torch.from_numpy(ids), tmega.init_cache(1, S), last_only=False)
    assert tl.shape == (1, 6, 300) and _rel(tl, jl) < 1e-4


def test_same_bits_keeps_bf16():
    a = np.asarray(jnp.asarray([1.5, -2.25, 3e-3], jnp.bfloat16))
    t = _same_bits(a, CPU)
    assert t.dtype == torch.bfloat16 and np.array_equal(_bits(t), _jbits(a))


@pytest.mark.parametrize("change,match", [
    (dict(head_dim=64, num_attention_heads=4, hidden_size=256, intermediate_size=256), "head_dim"),
    (dict(o_proj_bias=True), "bias"),
    (dict(sliding_window=16), "sliding window"),
    (dict(intermediate_size=576), "128 multiple"),  # group-aligned, but not the CUDA kernel's chunks
    (dict(intermediate_size=384), "no ff block size"),
])
def test_unsupported_configs_raise(change, match):
    from mllm_tpu_torch.models.transformer import CausalLM

    cfg = dataclasses.replace(TCFG, num_hidden_layers=1, **change)
    with pytest.raises(ValueError, match=match):
        MegaDecodeLM.from_float(CausalLM.init(cfg, device=CPU))


def test_quantized_model_raises():
    from mllm_tpu_torch.models.transformer import CausalLM
    from mllm_tpu_torch.ops.quantize_model import quantize_model

    model = quantize_model(CausalLM.init(dataclasses.replace(TCFG, num_hidden_layers=1), device=CPU),
                           "int8", min_size=1)
    with pytest.raises(ValueError, match="float model"):
        MegaDecodeLM.from_float(model)


def test_prefill_and_pad_lens_go_to_base(megas):
    _, tmega = megas
    ids = torch.from_numpy(np.random.RandomState(4).randint(0, 512, (2, 6)))
    pad = torch.tensor([0, 2])
    out = []
    for m in (tmega, tmega.base):
        lg, c = m(ids, m.init_cache(2, S), last_only=False, pad_lens=pad)
        lg2, c = m(torch.tensor([[1], [2]]), c, pad_lens=pad)
        lg3, _ = m(ids[:1], m.init_cache(1, S), last_only=False)
        out.append((lg, lg2, lg3, c.k))
    for a, b in zip(*out):
        assert torch.equal(a, b)
    # b > 32 goes to base too
    big = KVCache(torch.zeros(1, 33, 1, 4, 1), None)
    assert not tmega._mega_eligible(None, big, torch.zeros(33, 1, 8), None)


def test_ragged_batched_generate_goes_to_base(megas):
    _, tmega = megas
    rs = np.random.RandomState(6)
    prompts = [rs.randint(0, 512, n) for n in (3, 8)]
    got = tgen.ragged_batched_generate(tmega, prompts, tmega.init_cache(2, S),
                                       SamplingConfig(max_new_tokens=4))
    want = tgen.ragged_batched_generate(tmega.base, prompts, tmega.base.init_cache(2, S),
                                        SamplingConfig(max_new_tokens=4))
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


@pytest.mark.parametrize("b", [1, 8, 32])
def test_kernel_plan_at_full_width(b):
    """The kernel's work split at the Qwen2-VL-2B geometry on 132 SMs: chunks
    of packed rows that are multiples of the kernel's 32-row ring stage,
    divide each product's K/2 and fit the staged-x buffer; the workspace holds
    every piece."""
    d, ff, h, hkv = 1536, 8960, 12, 2
    n_q, n_qkv = h * 128, (h + 2 * hkv) * 128
    plan = tds.decode_step_plan(b, d, n_q, n_qkv, ff, h, 132)
    for rows, khalf in zip(plan[:4], (d // 2, n_q // 2, d // 2, ff // 2)):
        assert 32 <= rows <= 512 and rows % 32 == 0 and khalf % rows == 0
        assert (rows // 16) * 128 * tds.mega_rows_of_x(b) <= tds.X_STAGE_FLOATS
    assert 1 <= plan[4] <= 32 and (b * h * plan[4] >= 264 or plan[4] == 32)
    ws = tds.decode_step_workspace(b, d, n_q, n_qkv, ff, h, plan)
    assert ws % 4 == 0 and ws * 4 < 64 << 20
