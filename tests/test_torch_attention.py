"""Attention parity: the port's plain kernel versions against the Pallas
kernels in interpret mode, and the port's sdpa against mllm_tpu's sdpa.

Inputs are f32 numpy arrays from a seed. Kernel comparisons cover valid rows
only (rows with at least one visible key): a row with none is zeros in the
port and an average of V in the Pallas kernel. Tolerance 1e-4 for the
kernels (the Pallas kernels take base-2 exponents with scale * log2(e)
folded into q, so sums differ in the last bits), 1e-5 for sdpa (the same
arithmetic on both sides).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mllm_tpu.nn.attention import sdpa as jax_sdpa
from mllm_tpu.ops.decode_attention import decode_attention as jax_decode
from mllm_tpu.ops.flash_attention import flash_attention as jax_flash
from mllm_tpu_torch.nn.attention import attend, sdpa
from mllm_tpu_torch.ops.decode_attention import decode_attention, decode_attention_ref
from mllm_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref

KERNEL_TOL = 1e-4


def _qkv(seed, b, sq, h, hkv, d, skv):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d), dtype=np.float32),
            rng.standard_normal((b, hkv, skv, d), dtype=np.float32),
            rng.standard_normal((b, hkv, skv, d), dtype=np.float32))


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


# name: (b, sq, h, hkv, d, skv, q_offset, kv_valid, kv_start, causal, window, block_k)
FLASH_CASES = {
    "causal": (1, 128, 4, 2, 64, 256, 0, 128, None, True, None, 128),
    "chunk_offset_window": (1, 128, 4, 2, 64, 256, 128, 256, None, True, 64, 128),
    "kv_start": (2, 128, 4, 2, 64, 256, 0, 128, [0, 37], True, None, 128),
    "partial_q_tile": (1, 96, 4, 4, 64, 256, 32, 128, None, True, None, 128),
    "noncausal_tail": (2, 64, 4, 2, 64, 256, 0, 200, [0, 5], False, None, 128),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_ref_vs_pallas_interpret(case):
    b, sq, h, hkv, d, skv, qoff, kvl, start, causal, window, bk = FLASH_CASES[case]
    q, k, v = _qkv(1, b, sq, h, hkv, d, skv)
    st = None if start is None else np.asarray(start, np.int32)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset=qoff,
                    kv_valid_len=kvl, kv_start=None if st is None else jnp.asarray(st),
                    causal=causal, window=window, block_q=128, block_k=bk, interpret=True)
    out = flash_attention_ref(*_t(q, k, v), q_offset=qoff, kv_valid_len=kvl,
                              kv_start=None if st is None else torch.from_numpy(st),
                              causal=causal, window=window)
    # valid rows: some key j with start <= j < kvl (and j <= q_pos when causal)
    q_pos = qoff + np.arange(sq)
    lo = np.zeros(b, np.int64) if st is None else st.astype(np.int64)
    valid = np.ones((b, sq), bool) if not causal else (q_pos[None, :] >= lo[:, None])
    valid &= (lo < kvl)[:, None]
    ref, out = np.asarray(ref), out.numpy()
    np.testing.assert_allclose(out[valid], ref[valid], rtol=KERNEL_TOL, atol=KERNEL_TOL)


# name: (b, h, hkv, d, s, kv_valid, kv_start, window, block_k)
DECODE_CASES = {
    "scalar_valid": (2, 4, 2, 64, 512, 300, None, None, 256),
    "per_sequence_valid": (3, 4, 2, 64, 512, [64, 300, 512], None, None, 256),
    "partial_final_block": (2, 4, 2, 128, 384, [300, 384], None, None, 256),
    "kv_start_window": (3, 4, 2, 64, 512, [100, 300, 512], [0, 40, 7], 128, 128),
}


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_ref_vs_pallas_interpret(case):
    b, h, hkv, d, s, kvl, start, window, bk = DECODE_CASES[case]
    q, k, v = _qkv(2, b, 1, h, hkv, d, s)
    kvl_np = np.broadcast_to(np.asarray(kvl, np.int32), (b,))
    st = None if start is None else np.asarray(start, np.int32)
    ref = jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     kv_valid_len=jnp.asarray(kvl_np),
                     kv_start=None if st is None else jnp.asarray(st),
                     window=window, block_k=bk, interpret=True)
    out = decode_attention_ref(*_t(q, k, v), kv_valid_len=torch.from_numpy(kvl_np.copy()),
                               kv_start=None if st is None else torch.from_numpy(st),
                               window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=KERNEL_TOL, atol=KERNEL_TOL)


SDPA_CASES = {
    "causal_gqa": dict(q_offset=0, kv_valid_len=None),
    "offset_valid_window": dict(q_offset=8, kv_valid_len=20, window=5),
    "per_seq_offset_valid_kv_start": dict(q_offset=np.array([3, 9], np.int32),
                                          kv_valid_len=np.array([10, 16], np.int32),
                                          kv_start=np.array([0, 4], np.int32)),
    "noncausal_bias_softcap": dict(causal=False, kv_valid_len=18, bias=True, logit_softcap=5.0),
}


@pytest.mark.parametrize("case", list(SDPA_CASES))
def test_sdpa_vs_jax(case):
    kw = dict(SDPA_CASES[case])
    b, sq, h, hkv, d, skv = 2, 8, 4, 2, 16, 24
    q, k, v = _qkv(3, b, sq, h, hkv, d, skv)
    if kw.pop("bias", False):
        kw["bias"] = np.random.default_rng(4).standard_normal((b, h, sq, skv), dtype=np.float32)
    jkw = {n: (jnp.asarray(x) if isinstance(x, np.ndarray) else x) for n, x in kw.items()}
    tkw = {n: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x) for n, x in kw.items()}
    ref = jax_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **jkw)
    out = sdpa(*_t(q, k, v), **tkw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_wrappers_take_plain_version_on_cpu():
    """On CPU tensors the wrappers are the plain versions and launch nothing;
    `attend` routes a bf16 Sq == 1 to decode and longer queries to flash (an
    f32 query to `sdpa`)."""
    q, k, v = _t(*_qkv(5, 2, 6, 4, 2, 64, 32))
    n_flash, n_dec = flash_attention.launches, decode_attention.launches
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))  # the kernels' dtype; f32 takes sdpa
    torch.testing.assert_close(
        attend(qb, kb, vb, q_offset=3, kv_valid_len=9),
        flash_attention_ref(qb, kb, vb, q_offset=3, kv_valid_len=9), rtol=0, atol=0)
    torch.testing.assert_close(
        attend(qb[:, :1], kb, vb, q_offset=8, kv_valid_len=9),
        decode_attention_ref(qb[:, :1], kb, vb, kv_valid_len=9), rtol=0, atol=0)
    torch.testing.assert_close(attend(q, k, v, q_offset=3, kv_valid_len=9),
                               sdpa(q, k, v, q_offset=3, kv_valid_len=9), rtol=0, atol=0)
    # the query-at-end decode equals the causal flash row
    torch.testing.assert_close(
        decode_attention(q[:, :1], k, v, kv_valid_len=9, window=4),
        flash_attention(q[:, :1], k, v, q_offset=8, kv_valid_len=9, window=4),
        rtol=1e-6, atol=1e-6)
    assert (flash_attention.launches, decode_attention.launches) == (n_flash, n_dec)
