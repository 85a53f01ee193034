"""The port's quantized and paged KV caches and their attention kernels'
plain versions against mllm_tpu (CPU).

  - packing and quantizers: `unpack4_planar` bit for bit over all 256 bytes;
    the port's quantizer bit for bit with the JAX `_quantize` under
    `jax.jit` (where the JAX caches quantize: XLA multiplies `amax` by the f32
    reciprocal of 127 or 7), and equal integers but other scale bits eagerly;
  - plain versions vs the Pallas kernels in interpret mode: 1e-4 when the
    Pallas kernel takes all keys in one block (the same arithmetic, summed in
    another order, exp vs exp2 for the decode kernel: a score that differs in
    its last bit can flip the bf16 rounding of one probability, observed
    5e-5), 2e-3 with several blocks (the Pallas online softmax rounds
    p * v_scale, or p, to bf16 against a running max that the one-softmax
    plain versions never see);
    the paged one 1e-4 (f32, as tests/test_torch_attention.py);
  - storage after update_layer / admit / admit_batch: bit for bit, with the
    slot caches' clamp and the paged cache's drop at and past capacity;
  - the model over int8 / int4 caches through `models/bridge.py`: with the
    JAX attention routed through its Pallas kernels in interpret mode (the
    kernels' arithmetic, which the port's plain versions follow) logits within
    1e-4 of max |logit| and greedy tokens equal; with the JAX CPU path (which
    dequantizes as bf16(q) * bf16(scale) and runs sdpa) logits within 3e-2,
    the gap being that dequant rounding (ROADMAP Queue 3).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mllm_tpu.models.transformer as jax_transformer
from mllm_tpu.core.config import TextConfig as JaxTextConfig
from mllm_tpu.generation import generate as jgen
from mllm_tpu.generation.sampling import SamplingConfig as JaxSamplingConfig
from mllm_tpu.kv import cache as jcache
from mllm_tpu.models.transformer import CausalLM as JaxCausalLM
from mllm_tpu.ops import decode_attention as jda
from mllm_tpu.ops import flash_attention as jfa
from mllm_tpu_torch.core.config import TextConfig
from mllm_tpu_torch.generation import generate as tgen
from mllm_tpu_torch.generation.sampling import SamplingConfig
from mllm_tpu_torch.kv import cache as tcache
from mllm_tpu_torch.models.bridge import causal_lm_from_jax_params
from mllm_tpu_torch.nn import attention as tattn
from mllm_tpu_torch.ops.decode_attention import (decode_attention_paged_ref, decode_attention_quant_ref,
                                                 unpack4_planar)
from mllm_tpu_torch.ops.flash_attention import flash_attention_quant_ref

CPU = torch.device("cpu")
ONE_BLOCK_TOL = 1e-4
# head_dim 256, one block: the f32 scores sum 256 products in another order,
# which flips the bf16 rounding of a probability more often (3.5e-4 seen)
ONE_BLOCK_TOL_256 = 4e-4
BLOCKS_TOL = 2e-3


@pytest.fixture(scope="module", autouse=True)
def kernel_route_at_small_head_dim():
    """This file's models have head_dim 16, which the port's route sends
    to `sdpa` (the kernels take 64 and 128): here it reaches the kernels'
    plain versions, so the loops drive the wrappers as they do on the card."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tattn, "KERNEL_HEAD_DIMS", (16, 64, 128))
        yield


def _t(x):
    return torch.from_numpy(np.array(x))


def _bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a).view(np.uint8)


def _same(port, jax_arr):
    assert port.shape == tuple(jax_arr.shape)
    np.testing.assert_array_equal(_bits(port), _bits(jax_arr))


# ---------------------------------------------------------------------------
# packing and quantizers
# ---------------------------------------------------------------------------


def test_unpack4_planar_matches_jax():
    p = np.arange(256, dtype=np.uint8).reshape(4, 64)
    want = np.asarray(jda.unpack4_planar(jnp.asarray(p)))
    got = unpack4_planar(torch.from_numpy(p))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))


def _kv_input(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 2, 40, 64)).astype(np.float32)
    x *= rng.uniform(0.01, 10, (2, 2, 40, 1)).astype(np.float32)
    x[0, 0, 0] = 0  # an all-zero vector: scale 1
    return x


@pytest.mark.parametrize("bits", [8, 4])
def test_quantizer_matches_jitted_jax(bits):
    cls = jcache.QuantKVCache if bits == 8 else jcache.Quant4KVCache
    x = _kv_input()
    jq, js = jax.jit(cls._quantize)(jnp.asarray(x))
    tq, ts = (tcache.QuantKVCache if bits == 8 else tcache.Quant4KVCache)._quantize(torch.from_numpy(x))
    _same(tq, jq)
    _same(ts, js)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantizer_vs_eager_jax_differs_in_scale_bits_only(bits):
    """Eagerly the JAX quantizer divides by 127 (7); the scales then differ in
    the last bit from the jitted ones the port copies, the integers do not."""
    cls = jcache.QuantKVCache if bits == 8 else jcache.Quant4KVCache
    x = _kv_input(1)
    jq, js = cls._quantize(jnp.asarray(x))
    tq, ts = tcache.quantize_kv(torch.from_numpy(x), bits)
    _same(tq, jq)
    rel = np.abs(ts.numpy() - np.asarray(js)) / np.asarray(js)
    assert 0 < rel.max() <= 2 ** -23  # one ulp of f32 at most


# ---------------------------------------------------------------------------
# plain versions vs the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------


def _quant_kv(seed, b, hkv, s, d, bits):
    rng = np.random.default_rng(seed)
    cls = jcache.QuantKVCache if bits == 8 else jcache.Quant4KVCache
    out = []
    for _ in range(2):
        q, sc = jax.jit(cls._quantize)(jnp.asarray(rng.standard_normal((b, hkv, s, d)), jnp.float32))
        out += [q, sc]
    return out  # k, ks, v, vs


# name: (b, s, kv_valid, kv_start, window, block_k, head_dim); head_dim 256
# is Gemma-2B's (8 / 1 heads there)
DECODE_QUANT_CASES = {
    "per_slot_one_block": (3, 384, [17, 300, 384], None, None, 384, 128),
    "kv_start_window_one_block": (3, 384, [100, 300, 384], [0, 40, 7], 128, 384, 128),
    "per_slot_blocks": (3, 384, [17, 300, 384], [0, 5, 100], None, 128, 128),
    "d256_kv_start_window_one_block": (2, 256, [100, 256], [0, 40], 128, 256, 256),
    "d256_per_slot_blocks": (2, 256, [17, 256], [0, 100], None, 128, 256),
}


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("case", list(DECODE_QUANT_CASES))
def test_decode_quant_ref_vs_pallas_interpret(case, bits):
    b, s, kvl, start, window, bk, d = DECODE_QUANT_CASES[case]
    h, hkv = 4, 2
    k, ks, v, vs = _quant_kv(2, b, hkv, s, d, bits)
    q = np.random.default_rng(3).standard_normal((b, 1, h, d)).astype(np.float32)
    kvl = np.asarray(kvl, np.int32)
    st = None if start is None else np.asarray(start, np.int32)
    ref = jda.decode_attention_quant(jnp.asarray(q), k, v, ks, vs, kv_valid_len=jnp.asarray(kvl),
                                     kv_start=None if st is None else jnp.asarray(st), window=window,
                                     block_k=bk, interpret=True)
    out = decode_attention_quant_ref(_t(q), _t(k), _t(v), _t(ks), _t(vs), kv_valid_len=_t(kvl),
                                     kv_start=None if st is None else _t(st), window=window)
    tol = ONE_BLOCK_TOL if bk >= s else BLOCKS_TOL
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=tol, atol=tol)


# name: (b, sq, skv, q_offset, kv_valid, kv_start, window, block_k, head_dim)
FLASH_QUANT_CASES = {
    "prefill_one_block": (1, 128, 256, 0, 128, None, None, 256, 128),
    "chunk_offset_one_block": (1, 128, 256, 128, 256, None, None, 256, 128),
    "ragged_valid_kv_start": (2, 64, 256, 64, 192, [0, 30], None, 256, 128),
    "window_blocks": (1, 128, 256, 128, 256, None, 64, 128, 128),
    "d256_ragged_valid_kv_start": (2, 64, 256, 64, 192, [0, 30], None, 256, 256),
    "d256_window_blocks": (1, 128, 256, 128, 256, None, 64, 128, 256),
}


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("case", list(FLASH_QUANT_CASES))
def test_flash_quant_ref_vs_pallas_interpret(case, bits):
    b, sq, skv, qoff, kvl, start, window, bk, d = FLASH_QUANT_CASES[case]
    h, hkv = 4, 2
    k, ks, v, vs = _quant_kv(4, b, hkv, skv, d, bits)
    q = np.random.default_rng(5).standard_normal((b, sq, h, d)).astype(np.float32)
    st = None if start is None else np.asarray(start, np.int32)
    ref = jfa.flash_attention_quant(jnp.asarray(q), k, v, ks, vs, q_offset=qoff, kv_valid_len=kvl,
                                    kv_start=None if st is None else jnp.asarray(st), window=window,
                                    block_k=bk, interpret=True)
    out = flash_attention_quant_ref(_t(q), _t(k), _t(v), _t(ks), _t(vs), q_offset=qoff,
                                    kv_valid_len=kvl, kv_start=None if st is None else _t(st),
                                    window=window)
    # rows that see a key (a row with none is zeros in the port, an average of V in Pallas)
    lo = np.zeros(b, np.int64) if st is None else st
    valid = (qoff + np.arange(sq))[None, :] >= lo[:, None]
    tol = (ONE_BLOCK_TOL if d < 256 else ONE_BLOCK_TOL_256) if bk >= skv else BLOCKS_TOL
    np.testing.assert_allclose(out.numpy()[valid], np.asarray(ref)[valid], rtol=tol, atol=tol)


def _paged_inputs(seed, valid, maxb=4, nb=16, retired=None):
    """A shuffled pool holding each slot's blocks, its table, and q."""
    rng = np.random.default_rng(seed)
    b, hkv, h, d, bs = len(valid), 2, 4, 128, 128
    perm = rng.permutation(nb)
    table = np.full((b, maxb), -1, np.int32)
    pool_k, pool_v = (rng.standard_normal((nb, hkv, bs, d)).astype(np.float32) for _ in range(2))
    pi = 0
    for i, n in enumerate(valid):
        for lb in range(-(-n // bs)):
            table[i, lb] = perm[pi]
            pi += 1
    if retired is not None:
        table[retired] = -1
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    return q, pool_k, pool_v, table


@pytest.mark.parametrize("window,retired", [(None, None), (100, None), (None, 1)],
                         ids=["shuffled", "window", "retired_row"])
def test_paged_ref_vs_pallas_interpret(window, retired):
    valid = np.asarray([300, 130, 512], np.int32)
    q, pk, pv, table = _paged_inputs(6, valid, retired=retired)
    ref = jda.decode_attention_paged(jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
                                     jnp.asarray(table), kv_valid_len=jnp.asarray(valid),
                                     window=window, interpret=True)
    out = decode_attention_paged_ref(_t(q), _t(pk), _t(pv), _t(table), kv_valid_len=_t(valid),
                                     window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_paged_ref_clamps_past_the_table():
    """An idle slot whose kv_valid runs past MAXB * 128 reads the whole table
    and no further, as a dense cache of that many rows would."""
    q, pk, pv, table = _paged_inputs(7, [512, 200])
    far = decode_attention_paged_ref(_t(q), _t(pk), _t(pv), _t(table), kv_valid_len=torch.tensor([700, 200]))
    full = decode_attention_paged_ref(_t(q), _t(pk), _t(pv), _t(table), kv_valid_len=torch.tensor([512, 200]))
    torch.testing.assert_close(far, full, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# storage after update_layer / admit / admit_batch
# ---------------------------------------------------------------------------

L, B, HKV, D = 2, 3, 2, 64


def _new_kv(seed, b, s):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, HKV, D)).astype(np.float32) for _ in range(2)]


def _quant_leaves(c):
    return [c.k, c.v, c.k_scale, c.v_scale]


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quant_cache_update_layer_matches_jax(kind):
    jcls = jcache.QuantKVCache if kind == "int8" else jcache.Quant4KVCache
    tcls = tcache.QuantKVCache if kind == "int8" else tcache.Quant4KVCache
    jc = jcls.init(L, B, 100, HKV, D)  # max_len rounds up to 128
    tc = tcls.init(L, B, 100, HKV, D, device=CPU)
    assert tc.max_len == jc.max_len == 128
    upd = jax.jit(lambda c, k, v, layer: c.update_layer(layer, k, v), static_argnums=3)
    for layer, (pos, s) in enumerate([(0, 5), (5, 3)]):
        k, v = _new_kv(layer, B, s)
        jc = upd(jc.with_pos(pos), jnp.asarray(k), jnp.asarray(v), layer)
        tc = tc.with_pos(pos).update_layer(layer, _t(k), _t(v))
    for t, j in zip(_quant_leaves(tc), _quant_leaves(jc)):
        _same(t, j)
    for a, b_ in zip(tc.layer(1), jc.layer(1)):  # the JAX bf16-product dequant
        np.testing.assert_array_equal(a.view(torch.int16).numpy(), np.asarray(b_).view(np.int16))
    assert tc.advance(4).pos == 9 and tc.reset().pos == 0


def _slot_pair(kind, max_len=64):
    geo = (L, B, max_len, HKV, D)
    if kind == "dense":
        return jcache.SlotKVCache.init(*geo, jnp.float32), tcache.SlotKVCache.init(*geo, device=CPU, dtype=torch.float32)
    bits = 8 if kind == "int8" else 4
    return (jcache.SlotQuantKVCache.init(*geo, bits=bits),
            tcache.SlotQuantKVCache.init(*geo, device=CPU, bits=bits))


def _leaves(c):
    return _quant_leaves(c) if hasattr(c, "k_scale") else [c.k, c.v]


@pytest.mark.parametrize("kind", ["dense", "int8", "int4"])
def test_slot_cache_storage_matches_jax(kind):
    """admit (a 1-sequence small cache into slot 1), admit_batch (two rows
    and a padding row past the slots), then decode appends with per-slot
    heads, one at the last row and one past it: JAX's dynamic_update_slice
    clamps that write onto the last row, and so does the port."""
    jc, tc = _slot_pair(kind)
    s_max = tc.max_len
    assert jc.max_len == s_max
    bucket = 16
    jsmall = jc.make_prefill_cache(1, bucket, L, HKV, D)
    tsmall = tc.make_prefill_cache(1, bucket, L, HKV, D)
    k, v = _new_kv(1, 1, 11)
    prefill = jax.jit(lambda c, k, v: c.update_layer(0, k, v).update_layer(1, v, k))
    jsmall = prefill(jsmall, jnp.asarray(k), jnp.asarray(v))
    tsmall = tsmall.update_layer(0, _t(k), _t(v)).update_layer(1, _t(v), _t(k))
    jc = jc.admit(1, jsmall, 11)
    tc = tc.admit(1, tsmall, 11)

    jsmall = jc.make_prefill_cache(3, bucket, L, HKV, D)
    tsmall = tc.make_prefill_cache(3, bucket, L, HKV, D)
    k, v = _new_kv(2, 3, bucket)
    jsmall = prefill(jsmall, jnp.asarray(k), jnp.asarray(v))
    tsmall = tsmall.update_layer(0, _t(k), _t(v)).update_layer(1, _t(v), _t(k))
    slot_ids, lens = np.array([2, 0, B], np.int32), np.array([7, 16, 5], np.int32)
    jc = jc.admit_batch(jnp.asarray(slot_ids), jsmall, jnp.asarray(lens), bucket)
    tc = tc.admit_batch(slot_ids, tsmall, lens, bucket)
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))

    step = jax.jit(lambda c, k, v: c.update_layer(0, k, v).update_layer(1, v, k))
    heads = np.array([s_max - 1, 11, s_max + 9], np.int32)  # the last row, a live slot, past the cache
    for i in range(2):
        k, v = _new_kv(3 + i, B, 1)
        jc = step(type(jc)(*_leaves(jc), jnp.asarray(heads + i), *([jc.bits] if kind != "dense" else [])),
                  jnp.asarray(k), jnp.asarray(v))
        tc = type(tc)(*_leaves(tc), torch.from_numpy(heads + i), *([tc.bits] if kind != "dense" else []))
        tc = tc.update_layer(0, _t(k), _t(v)).update_layer(1, _t(v), _t(k))
    for t, j in zip(_leaves(tc), _leaves(jc)):
        _same(t, j)
    np.testing.assert_array_equal(tc.advance(2).pos.numpy(), np.asarray(jc.advance(2).pos))


def _paged_pair(n_blocks=6, maxb=3):
    geo = (L, B, maxb * 128, HKV, D)
    jc = jcache.PagedKVCache.init(*geo, jnp.float32, n_blocks=n_blocks)
    tc = tcache.PagedKVCache.init(*geo, device=CPU, dtype=torch.float32, n_blocks=n_blocks)
    table = np.full((B, maxb), -1, np.int32)
    table[0, :2] = [4, 1]
    table[1, :1] = [0]
    table[2, :3] = [5, 2, 3]
    return jc.with_tables(table), tc.with_tables(table)


def test_paged_cache_storage_matches_jax():
    """admit (a bucket smaller than a block: padded), admit_batch with a
    padding row, then decode appends: a live slot, a slot whose head passed
    its table (logical block >= MAXB), and a retired slot (a -1 row): JAX
    drops the last two writes, and the port writes them to its sink block."""
    jc, tc = _paged_pair()
    assert (tc.n_blocks, tc.max_len) == (jc.n_blocks, jc.max_len) == (6, 384)
    prefill = jax.jit(lambda c, k, v: c.update_layer(0, k, v).update_layer(1, v, k))
    jsmall = jc.make_prefill_cache(1, 16, L, HKV, D)
    tsmall = tc.make_prefill_cache(1, 16, L, HKV, D)
    k, v = _new_kv(5, 1, 16)
    jsmall = prefill(jsmall, jnp.asarray(k), jnp.asarray(v))
    tsmall = tsmall.update_layer(0, _t(k), _t(v)).update_layer(1, _t(v), _t(k))
    jc, tc = jc.admit(2, jsmall, 9), tc.admit(2, tsmall, 9)

    jsmall = jc.make_prefill_cache(3, 256, L, HKV, D)
    tsmall = tc.make_prefill_cache(3, 256, L, HKV, D)
    k, v = _new_kv(6, 3, 256)
    jsmall = prefill(jsmall, jnp.asarray(k), jnp.asarray(v))
    tsmall = tsmall.update_layer(0, _t(k), _t(v)).update_layer(1, _t(v), _t(k))
    slot_ids, lens = np.array([0, B, 1], np.int32), np.array([200, 3, 100], np.int32)
    jc = jc.admit_batch(jnp.asarray(slot_ids), jsmall, jnp.asarray(lens), 256)
    tc = tc.admit_batch(slot_ids, tsmall, lens, 256)
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))

    table = tc.table_host.copy()
    table[1] = -1  # slot 1 retired
    jc, tc = jc.with_tables(table), tc.with_tables(table)
    heads = np.array([200, 57, 3 * 128 + 5], np.int32)  # live, retired, past the table
    step = jax.jit(lambda c, k, v: c.update_layer(0, k, v).update_layer(1, v, k))
    for i in range(2):
        k, v = _new_kv(7 + i, B, 1)
        jc = step(jcache.PagedKVCache(jc.k, jc.v, jc.table, jnp.asarray(heads + i)),
                  jnp.asarray(k), jnp.asarray(v))
        tc = tcache.PagedKVCache(tc.k_store, tc.v_store, tc.table, torch.from_numpy(heads + i),
                                 tc.table_host)
        tc = tc.update_layer(0, _t(k), _t(v)).update_layer(1, _t(v), _t(k))
    _same(tc.k.contiguous(), jc.k)
    _same(tc.v.contiguous(), jc.v)
    for a, b_ in zip(tc.layer(0), jc.layer(0)):  # the gathered dense view
        _same(a.contiguous(), b_)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,sq,vector,route", [
    ("paged", 1, True, "decode_attention_paged"),
    ("paged", 4, False, "attend"),
    ("int8", 1, True, "decode_attention_quant"),
    ("int4", 4, False, "flash_attention_quant"),
    ("int8", 4, True, "sdpa"),
    ("dense", 1, True, "attend"),
], ids=["paged_decode", "paged_prefill", "quant_decode", "quant_prefill", "quant_prefill_per_slot",
        "slot_dense"])
def test_attend_from_cache_routes(monkeypatch, kind, sq, vector, route):
    """The JAX `attend_from_cache` table without its TPU thresholds."""
    calls = []
    for name in ("decode_attention_paged", "decode_attention_quant", "flash_attention_quant",
                 "attend", "sdpa"):
        monkeypatch.setattr(tattn, name, functools.partial(lambda n, *a, **k: calls.append(n), name))
    geo = (L, B, 256, HKV, D)
    cache = {"paged": lambda: tcache.PagedKVCache.init(*geo, device=CPU),
             "int8": lambda: tcache.SlotQuantKVCache.init(*geo, device=CPU, bits=8),
             "int4": lambda: tcache.Quant4KVCache.init(*geo, device=CPU),
             "dense": lambda: tcache.SlotKVCache.init(*geo, device=CPU)}[kind]()
    q = torch.zeros(B, sq, 4, D)
    pos = torch.tensor([3, 9, 0], dtype=torch.int32) if vector else 3
    tattn.attend_from_cache(q, cache, 1, q_offset=pos, kv_valid_len=pos + sq)
    assert calls == [route]


def test_init_cache_kv_dtype():
    tm = causal_lm_from_jax_params(*_bridge_args(), CPU)
    assert type(tm.init_cache(1, 100, kv_dtype="int8")) is tcache.QuantKVCache
    c4 = tm.init_cache(2, 100, kv_dtype="int4")
    assert type(c4) is tcache.Quant4KVCache and c4.k.shape == (2, 2, 2, 128, 8) and c4.k.dtype == torch.uint8
    assert int(c4.k[0, 0, 0, 0, 0]) == 0x88
    assert type(tm.init_cache(1, 100, torch.float32)) is tcache.KVCache


# ---------------------------------------------------------------------------
# the model over quantized caches
# ---------------------------------------------------------------------------

CFG_KW = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512,
              eos_token_id=127)


def _bridge_args():
    jm = JaxCausalLM.init(jax.random.PRNGKey(0), JaxTextConfig(**CFG_KW))
    return {k: np.asarray(v) for k, v in jm.parameters().items()}, TextConfig(**CFG_KW)


@pytest.fixture(scope="module")
def pair():
    jm = JaxCausalLM.init(jax.random.PRNGKey(0), JaxTextConfig(**CFG_KW))
    params = {k: np.asarray(v) for k, v in jm.parameters().items()}
    return jm, causal_lm_from_jax_params(params, TextConfig(**CFG_KW), CPU)


def _kernel_arithmetic_attend(orig, q, cache, layer_idx, **kw):
    """JAX `attend_from_cache` with quantized caches routed through the
    Pallas kernels in interpret mode (the TPU path, without its shape gates)."""
    if isinstance(cache, (jcache.QuantKVCache, jcache.Quant4KVCache, jcache.SlotQuantKVCache)):
        kq, vq, ks, vs = cache.layer_quant(layer_idx)
        common = dict(kv_valid_len=kw["kv_valid_len"], kv_start=kw["kv_start"], window=kw["window"],
                      scale=kw["scale"])
        if q.shape[1] == 1:
            return jda.decode_attention_quant(q, kq, vq, ks, vs, block_k=cache.max_len, interpret=True,
                                              **common)
        return jfa.flash_attention_quant(q, kq, vq, ks, vs, q_offset=kw["q_offset"], causal=kw["causal"],
                                         block_k=cache.max_len, interpret=True, **common)
    return orig(q, cache, layer_idx, **kw)


@pytest.fixture
def jax_kernel_arithmetic(monkeypatch):
    jax.clear_caches()  # programs traced before the patch would keep the CPU path
    monkeypatch.setattr(jax_transformer, "attend_from_cache",
                        functools.partial(_kernel_arithmetic_attend, jax_transformer.attend_from_cache))
    yield
    jax.clear_caches()


def _first_logits_and_tokens(jm, tm, kv, ids, n):
    jres, _ = jgen.generate(jm, ids, jm.init_cache(1, 192, kv_dtype=kv),
                            JaxSamplingConfig(max_new_tokens=n), bucket=16)
    jl, _ = jgen._prefill(jm, jm.init_cache(1, 192, kv_dtype=kv), jnp.asarray(ids[None]), ids.size)
    tres, tc = tgen.generate(tm, ids, tm.init_cache(1, 192, kv_dtype=kv), SamplingConfig(max_new_tokens=n),
                             bucket=16)
    tl, _ = tgen.prefill(tm, tm.init_cache(1, 192, kv_dtype=kv), torch.from_numpy(ids[None]), ids.size)
    rel = float(np.max(np.abs(tl.numpy() - np.asarray(jl))) / np.max(np.abs(np.asarray(jl))))
    return rel, jres.tokens, tres.tokens, tc


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_generate_quant_cache_matches_jax_kernel_arithmetic(pair, jax_kernel_arithmetic, kv):
    jm, tm = pair
    ids = np.random.default_rng(8).integers(0, 127, 13).astype(np.int32)
    rel, jtoks, ttoks, tc = _first_logits_and_tokens(jm, tm, kv, ids, 8)
    assert rel < 1e-4
    assert ttoks == jtoks
    assert tc.pos == 13 + 7


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_generate_quant_cache_vs_jax_cpu_path(pair, kv):
    """Against the JAX CPU path the prefill logits part by the dequant
    rounding only (bf16(q) * bf16(scale) vs bf16(f32(q) * scale))."""
    jm, tm = pair
    ids = np.random.default_rng(8).integers(0, 127, 13).astype(np.int32)
    rel, jtoks, ttoks, _ = _first_logits_and_tokens(jm, tm, kv, ids, 4)
    assert rel < 3e-2
    assert ttoks[0] == jtoks[0]


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_batched_and_ragged_generate_over_quant_caches(pair, jax_kernel_arithmetic, kv):
    """Left padding puts kv_start through both quantized kernels' plain versions."""
    jm, tm = pair
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 127, n).astype(np.int32) for n in (3, 9, 6)]
    jt, jn, _ = jgen.ragged_batched_generate(jm, prompts, jm.init_cache(3, 64, kv_dtype=kv),
                                             JaxSamplingConfig(max_new_tokens=6))
    tt, tn, _ = tgen.ragged_batched_generate(tm, prompts, tm.init_cache(3, 64, kv_dtype=kv),
                                             SamplingConfig(max_new_tokens=6))
    np.testing.assert_array_equal(tt, np.asarray(jt))
    np.testing.assert_array_equal(tn, jn)
    ids = rng.integers(0, 127, (2, 7)).astype(np.int32)
    jb, _ = jgen.batched_generate(jm, ids, np.array([7, 7]), jm.init_cache(2, 64, kv_dtype=kv),
                                  JaxSamplingConfig(max_new_tokens=5))
    tb, _ = tgen.batched_generate(tm, ids, np.array([7, 7]), tm.init_cache(2, 64, kv_dtype=kv),
                                  SamplingConfig(max_new_tokens=5))
    np.testing.assert_array_equal(tb, np.asarray(jb))


# Gemma-2B's attention geometry (head_dim 256, one KV head) at tiny widths
GEMMA_KW = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=2, num_key_value_heads=1, head_dim=256, max_position_embeddings=512,
                eos_token_id=127)


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_gemma_head_dim_256_quant_cache_matches_jax_kernel_arithmetic(jax_kernel_arithmetic, monkeypatch, kv):
    """A tiny Gemma at head_dim 256 over int8 / int4 KV: the port reaches the
    quantized kernels' plain versions at 256 (the route the card takes), the
    JAX model its Pallas kernels in interpret mode; prefill logits within
    1e-4 x max |logit| and 8 greedy tokens equal."""
    from mllm_tpu.models.families import PRESETS as JAX_PRESETS
    from mllm_tpu_torch.models.families import PRESETS

    monkeypatch.setattr(tattn, "KERNEL_HEAD_DIMS", (16, 64, 128, 256))  # this file's fixture drops 256
    calls = []
    for name in ("flash_attention_quant", "decode_attention_quant"):
        fn = getattr(tattn, name)
        monkeypatch.setattr(tattn, name, lambda *a, _fn=fn, _n=name, **k: calls.append(_n) or _fn(*a, **k))
    jm = JaxCausalLM.init(jax.random.PRNGKey(3), JAX_PRESETS["gemma-2b"].replace(**GEMMA_KW))
    params = {k: np.asarray(v) for k, v in jm.parameters().items()}
    tm = causal_lm_from_jax_params(params, PRESETS["gemma-2b"].replace(**GEMMA_KW), CPU)
    ids = np.random.default_rng(10).integers(0, 127, 13).astype(np.int32)
    rel, jtoks, ttoks, _ = _first_logits_and_tokens(jm, tm, kv, ids, 8)
    assert rel < 1e-4
    assert ttoks == jtoks
    assert {"flash_attention_quant", "decode_attention_quant"} <= set(calls)
