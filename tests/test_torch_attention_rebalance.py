"""The key splits of the head_dim 256 flash kernel and the head_dim 64 decode
kernel, checked on the CPU.

`csrc/flash_attention.cu` at head_dim 256 launches a cluster of
`flash_splits` CTAs a (sequence, head, q-tile): of the q-tile's key tiles
(`flash_qtile_tiles`, computed on the card from the device q_offset, kv_valid
and kv_start) each rank takes a run (`flash_split_runs`), leaves a partial
(m, l, unnormalised O) and the ranks merge in rank order through distributed
shared memory. `csrc/decode_attention.cu` at head_dim 64 splits a sequence's
keys as the other decode kernels do (`decode_split_ranges`), with its own
cluster size (`decode_splits(..., head_dim=64)`); inside a rank each of four
warps takes 16 keys of every 64-key tile, and the warps merge in warp order
before the ranks do. The kernels run only on the card; here each partition
is checked on its own, and the kernels' order of work is computed in f32
torch and held to the plain versions (1e-5) and to the JAX Pallas kernels in
interpret mode on the same f32 inputs from a seed (1e-4 for decode, as
`test_torch_attention_split.py`; 2e-3 for flash over several blocks, as
`test_torch_kvcache.py` at head_dim 256).
"""

import functools
import math
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from mllm_tpu.ops.decode_attention import decode_attention as jax_decode
from mllm_tpu.ops.flash_attention import flash_attention as jax_flash
from mllm_tpu_torch.ops._common import flash_visible_keys
from mllm_tpu_torch.ops.decode_attention import (DECODE_MAX_SPLITS, DECODE_TILE, decode_attention_ref,
                                                 decode_split_ranges, decode_splits)
from mllm_tpu_torch.ops.flash_attention import (FLASH_BQ, FLASH_MAX_SPLITS, FLASH_MIN_RUN, FLASH_TILE_WIDE,
                                                LOG2E, flash_attention_ref, flash_qtile_tiles, flash_split_runs,
                                                flash_splits)
from mllm_tpu_torch.utils.runtime import csrc_dir

NEG_BIG = -1e30  # the kernels' empty-partial m
PLAIN_TOL = 1e-5  # against the plain versions, f32 inputs: only the order of the f32 sums differs
DECODE_JAX_TOL = 1e-4  # the Pallas decode kernel folds scale * log2(e) into q
FLASH_JAX_TOL = 2e-3  # the Pallas flash kernel over several 128-key blocks (test_torch_kvcache.BLOCKS_TOL)
# clusters of 1..8 CTAs of the head_dim 256 kernel that an H100 keeps resident
# (cudaOccupancyMaxActiveClusters on an H100 80GB HBM3), for the rule's own tests
SLOTS = (132, 66, 39, 30, 22, 17, 15, 15)


def source_int(name: str, file: str) -> int:
    """The value of `constexpr int NAME = <int>;` in csrc/FILE."""
    with open(os.path.join(csrc_dir(), file)) as f:
        m = re.search(rf"constexpr int {name} = (\d+);", f.read())
    assert m, f"{name} in {file}"
    return int(m.group(1))


def test_rule_constants_are_the_kernels():
    """The Python statements of the partitions use the kernels' constants."""
    assert FLASH_BQ == source_int("kBQ", "flash_attention.cuh")
    assert FLASH_TILE_WIDE == source_int("kBKWide", "flash_attention.cuh")
    assert FLASH_MIN_RUN == source_int("kMinRun", "flash_attention.cuh")
    assert FLASH_MAX_SPLITS == source_int("kMaxSplits", "flash_attention.cuh")
    assert DECODE_TILE == source_int("kTile", "decode_attention.cuh")
    assert DECODE_MAX_SPLITS == source_int("kMaxSplits", "decode_attention.cuh")


# ---------------------------------------------------------------------------
# flash at head_dim 256
# ---------------------------------------------------------------------------

def flash_chunks(sq, skv, q_offset, kv_valid, kv_start, causal, window, splits, b):
    """{(sequence, q-tile): [(rank, first key, stop key)]}: the keys each rank
    of each q-tile's cluster loads (its run of whole tiles)."""
    out = {}
    for i in range(b):
        for qt in range(-(-sq // FLASH_BQ)):
            kb0, ntiles = flash_qtile_tiles(qt * FLASH_BQ, sq, q_offset, kv_valid[i], kv_start[i], causal,
                                            window, skv)
            out[i, qt] = [(r, kb0 + first * FLASH_TILE_WIDE, kb0 + (first + n) * FLASH_TILE_WIDE)
                          for r, (first, n) in enumerate(flash_split_runs(ntiles, splits)) if n > 0]
    return out


@settings(max_examples=150, deadline=None)
@given(data=st.data(), b=st.integers(1, 3), sq=st.integers(1, 400), causal=st.booleans(),
       window=st.one_of(st.none(), st.integers(1, 300)), splits=st.integers(1, FLASH_MAX_SPLITS))
def test_flash_partition_covers_each_visible_pair_once(data, b, sq, causal, window, splits):
    """Over causal, window, q_offset, kv_start, ragged lengths and Sq not a
    multiple of 128: every visible (query, key) pair falls in exactly one
    rank's run of its q-tile; no run exceeds ceil(ntiles / used) tiles, a
    split q-tile's runs hold at least FLASH_MIN_RUN tiles each, and the ranks
    past `used` hold none."""
    skv = data.draw(st.integers(max(1, sq), 640))
    q_offset = data.draw(st.integers(0, skv - sq)) if causal else 0
    kv_valid = data.draw(st.lists(st.integers(0, skv + 50), min_size=b, max_size=b))
    kv_start = data.draw(st.lists(st.integers(0, skv), min_size=b, max_size=b))
    ok = flash_visible_keys(b, sq, skv, q_offset, torch.tensor(kv_valid), torch.tensor(kv_start), causal, window,
                            "cpu").expand(b, sq, skv)
    chunks = flash_chunks(sq, skv, q_offset, kv_valid, kv_start, causal, window, splits, b)
    for (i, qt), ranks in chunks.items():
        kb0, ntiles = flash_qtile_tiles(qt * FLASH_BQ, sq, q_offset, kv_valid[i], kv_start[i], causal, window, skv)
        runs = flash_split_runs(ntiles, splits)
        assert len(runs) == max(splits, 1)
        used = sum(n > 0 for _, n in runs) or 1
        assert [n for _, n in runs[used:]] == [0] * (len(runs) - used)
        assert sum(n for _, n in runs) == ntiles
        for _, n in runs[:used]:
            assert n <= math.ceil(ntiles / used)
            if used > 1:
                assert n >= FLASH_MIN_RUN
        seen = torch.zeros(skv, dtype=torch.int32)
        for _, start, stop in ranks:
            seen[max(start, 0):min(stop, skv)] += 1
        rows = ok[i, qt * FLASH_BQ:(qt + 1) * FLASH_BQ]  # [rows, Skv]
        need = rows.any(0)
        assert bool((seen[need] == 1).all()), (i, qt, ranks)
        assert int(seen.max()) <= 1


def test_flash_cluster_rule():
    """1 where the grid runs four waves or more, at most FLASH_MAX_SPLITS; a
    short chunk over a long cache is cut finest, the 1536-row prefill in two,
    and the rule never picks a size whose clusters the card cannot keep
    resident. Without host values (a device q_offset or kv_valid) a q-tile is
    estimated as if it ended at the cache's end; with them, from where it
    lies: a short prompt at q_offset 0 is not split."""
    assert flash_splits(1, 1536, 2048, 8, True, None, SLOTS) == 2  # Gemma-2B's prefill bucket
    assert flash_splits(1, 1536, 2048, 8, True, None, SLOTS, 0, 1536) == 2
    assert flash_splits(1, 128, 2048, 8, True, None, SLOTS) == FLASH_MAX_SPLITS  # a 128-row chunk
    assert flash_splits(1, 128, 2048, 8, True, None, SLOTS, 1408, 1536) == FLASH_MAX_SPLITS
    assert flash_splits(1, 128, 2048, 8, True, None, SLOTS, 0, 128) == 1  # a 128-row prompt: 2 tiles
    assert flash_splits(1, 256, 2048, 8, True, None, SLOTS, 0, 256) < flash_splits(1, 256, 2048, 8, True, None,
                                                                                  SLOTS)
    assert flash_splits(64, 1536, 2048, 8, True, None, SLOTS) == 1  # 768 clusters: many waves
    assert flash_splits(1, 128, 2048, 8, True, None, SLOTS[:1]) == 1
    assert flash_splits(1, 128, 2048, 8, True, None, (132, 66, 44, 0, 0, 0, 0, 0)) == 3
    for shape in [(1, 1536, 2048, 8, True, None), (8, 128, 2048, 8, True, None), (1, 300, 2048, 8, True, 64),
                  (4, 256, 2048, 8, False, None), (2, 1, 4096, 8, True, None)]:
        assert 1 <= flash_splits(*shape, SLOTS) <= FLASH_MAX_SPLITS


def flash_split_merge(q, k, v, q_offset, kv_valid, kv_start, window, splits):
    """The head_dim 256 kernel's computation in f32: for each (sequence, head,
    q-tile) each rank's run of 64-key tiles with an online base-2 softmax
    (the kernel's per-tile rescaling), leaving (m, l, O); then the merge in
    rank order, O = sum_r O_r exp2(m_r - m) / l, rows that see no key zeros."""
    b, sq, h, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    scale_log2 = d**-0.5 * LOG2E
    ok = flash_visible_keys(b, sq, skv, q_offset, torch.tensor(kv_valid), torch.tensor(kv_start), True, window,
                            "cpu").expand(b, sq, skv)
    out = torch.zeros(b, sq, h, d)
    for i in range(b):
        for hh in range(h):
            hk = hh // (h // hkv)
            for qt in range(-(-sq // FLASH_BQ)):
                r0, r1 = qt * FLASH_BQ, min((qt + 1) * FLASH_BQ, sq)
                kb0, ntiles = flash_qtile_tiles(r0, sq, q_offset, kv_valid[i], kv_start[i], True, window, skv)
                x_all = q[i, r0:r1, hh] @ k[i, hk].T * scale_log2  # [rows, Skv]
                parts = []
                for first, n in flash_split_runs(ntiles, splits):
                    m = torch.full((r1 - r0,), NEG_BIG)
                    l_sum, acc = torch.zeros(r1 - r0), torch.zeros(r1 - r0, d)
                    for it in range(first, first + n):
                        a = kb0 + it * FLASH_TILE_WIDE
                        keys = slice(max(a, 0), min(a + FLASH_TILE_WIDE, skv))
                        x = torch.where(ok[i, r0:r1, keys], x_all[:, keys], -math.inf)
                        mn = torch.maximum(m, x.max(dim=1).values)
                        alpha = torch.exp2(m - mn)
                        p = torch.exp2(x - mn[:, None])
                        l_sum = l_sum * alpha + p.sum(dim=1)
                        acc = acc * alpha[:, None] + p @ v[i, hk, keys]
                        m = mn
                    parts.append((m, l_sum, acc))
                parts = parts[:max(1, sum(1 for _, n in flash_split_runs(ntiles, splits) if n > 0))]
                mx = torch.stack([m for m, _, _ in parts]).max(dim=0).values
                l_tot = sum(l_r * torch.exp2(m_r - mx) for m_r, l_r, _ in parts)
                inv = torch.where(l_tot > 0, 1.0 / torch.where(l_tot > 0, l_tot, 1.0), 0.0)
                o = torch.zeros(r1 - r0, d)
                for m_r, _, a_r in parts:  # rank order
                    o = o + (torch.exp2(m_r - mx) * inv)[:, None] * a_r
                out[i, r0:r1, hh] = o
    return out


# B=2, Sq 256 at q_offset 64 over 384 keys (kv_valid 320), 2 / 1 heads of 256, kv_start, a window
FLASH_CASE = dict(b=2, sq=256, h=2, hkv=1, d=256, skv=384, q_offset=64, kv_valid=320, kv_start=[0, 40], window=100)


def _flash_inputs():
    c = FLASH_CASE
    rng = np.random.default_rng(11)
    return (rng.standard_normal((c["b"], c["sq"], c["h"], c["d"]), dtype=np.float32),
            rng.standard_normal((c["b"], c["hkv"], c["skv"], c["d"]), dtype=np.float32),
            rng.standard_normal((c["b"], c["hkv"], c["skv"], c["d"]), dtype=np.float32))


@functools.cache
def _jax_flash():
    """The Pallas flash kernel (interpret mode) on FLASH_CASE, and the rows
    that see a key (Pallas writes a row with none as an average of V)."""
    c = FLASH_CASE
    q, k, v = _flash_inputs()
    start = np.asarray(c["kv_start"], np.int32)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset=c["q_offset"],
                    kv_valid_len=c["kv_valid"], kv_start=jnp.asarray(start), window=c["window"], interpret=True)
    ok = flash_visible_keys(c["b"], c["sq"], c["skv"], c["q_offset"], c["kv_valid"], torch.from_numpy(start), True,
                            c["window"], "cpu")
    return np.asarray(ref), ok.any(-1).numpy()


@pytest.mark.parametrize("splits", [1, 2, 3, FLASH_MAX_SPLITS])
def test_flash_split_merge_matches_plain_and_pallas(splits):
    c = FLASH_CASE
    q, k, v = (torch.from_numpy(x) for x in _flash_inputs())
    kv_valid, kv_start = [c["kv_valid"]] * c["b"], c["kv_start"]
    out = flash_split_merge(q, k, v, c["q_offset"], kv_valid, kv_start, c["window"], splits)
    ref = flash_attention_ref(q, k, v, q_offset=c["q_offset"], kv_valid_len=c["kv_valid"],
                              kv_start=torch.tensor(kv_start, dtype=torch.int32), window=c["window"])
    torch.testing.assert_close(out, ref, rtol=PLAIN_TOL, atol=PLAIN_TOL)
    jax_out, seen = _jax_flash()
    np.testing.assert_allclose(out.numpy()[seen], jax_out[seen], rtol=FLASH_JAX_TOL, atol=FLASH_JAX_TOL)


# ---------------------------------------------------------------------------
# decode at head_dim 64
# ---------------------------------------------------------------------------

WARPS = 4  # csrc/decode_attention.cuh kWarps: 16 keys of every tile each
DECODE_CASE = dict(h=8, hkv=2, d=64, s=256, kv_valid=[300, 100, 200, 1], kv_start=[0, 10, 30, 0], window=80)


def test_decode_cluster_rule_at_head_dim_64():
    """Two CTAs an SM at head_dim 64 (OpenELM-1_1B's 32 / 8 heads): B=1 and
    B=4 take the largest cluster, B=8 five; other head dims keep one CTA an
    SM."""
    assert decode_splits(1, 8, 4, 2048, 132, head_dim=64) == DECODE_MAX_SPLITS
    assert decode_splits(4, 8, 4, 2048, 132, head_dim=64) == DECODE_MAX_SPLITS
    assert decode_splits(8, 8, 4, 2048, 132, head_dim=64) == 5
    assert decode_splits(4, 8, 4, 2048, 132) == decode_splits(4, 8, 4, 2048, 132, head_dim=128) == 5
    assert decode_splits(4, 8, 4, 100, 132, head_dim=64) == 2  # two tiles of cache


def decode_split_merge(q, k, v, kv_valid, kv_start, window, splits):
    """The head_dim 64 kernel's computation in f32: per rank (decode_split_ranges)
    each warp's 16 keys of every 64-key tile with an online base-2 softmax,
    the warps merged in warp order, then the ranks in rank order; a sequence
    with no key gets zeros."""
    b, _, h, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    n_rep = h // hkv
    scale_log2 = d**-0.5 * LOG2E
    out = torch.zeros(b, 1, h, d)

    def merge(parts):
        mx = torch.stack([m for m, _, _ in parts]).max(dim=0).values
        e = [torch.exp2(m - mx) for m, _, _ in parts]
        return mx, sum(l_r * e_r for (_, l_r, _), e_r in zip(parts, e)), \
            sum(a_r * e_r[:, None] for (_, _, a_r), e_r in zip(parts, e))

    for i in range(b):
        lo = max(kv_start[i], 0)
        if window:
            lo = max(lo, kv_valid[i] - window)
        hi = min(kv_valid[i], s)
        t0 = lo // DECODE_TILE * DECODE_TILE
        for hk in range(hkv):
            x_all = q[i, 0, hk * n_rep:(hk + 1) * n_rep] @ k[i, hk].T * scale_log2  # [n_rep, S]
            ranks = []
            for start, stop in decode_split_ranges(lo, hi, splits):
                warps = []
                for w in range(WARPS):
                    m, l_sum, acc = torch.full((n_rep,), NEG_BIG), torch.zeros(n_rep), torch.zeros(n_rep, d)
                    tile = (max(start, t0) - t0) // DECODE_TILE
                    while start < stop and t0 + tile * DECODE_TILE < stop:
                        a = t0 + tile * DECODE_TILE + w * 16
                        keys = torch.arange(a, a + 16)
                        vis = (keys >= max(lo, start)) & (keys < min(hi, stop))
                        kk = keys.clamp(max=s - 1)
                        x = torch.where(vis, x_all[:, kk], -math.inf)
                        mn = torch.maximum(m, x.max(dim=1).values)
                        alpha = torch.exp2(m - mn)
                        p = torch.exp2(x - mn[:, None])
                        l_sum = l_sum * alpha + p.sum(dim=1)
                        acc = acc * alpha[:, None] + p @ torch.where(vis[:, None], v[i, hk, kk], 0.0)
                        m = mn
                        tile += 1
                    warps.append((m, l_sum, acc))
                ranks.append(merge(warps))  # warp order
            _, l_tot, acc = merge(ranks)  # rank order
            safe = torch.where(l_tot > 0, l_tot, torch.ones_like(l_tot))
            out[i, 0, hk * n_rep:(hk + 1) * n_rep] = torch.where(l_tot[:, None] > 0, acc / safe[:, None], 0.0)
    return out


def _decode_inputs():
    c = DECODE_CASE
    b = len(c["kv_valid"])
    rng = np.random.default_rng(13)
    return (rng.standard_normal((b, 1, c["h"], c["d"]), dtype=np.float32),
            rng.standard_normal((b, c["hkv"], c["s"], c["d"]), dtype=np.float32),
            rng.standard_normal((b, c["hkv"], c["s"], c["d"]), dtype=np.float32))


@functools.cache
def _jax_decode():
    """The Pallas decode kernel (interpret mode) on DECODE_CASE, kv_valid
    clamped to the cache as JAX takes it."""
    c = DECODE_CASE
    q, k, v = _decode_inputs()
    kvl = np.minimum(np.asarray(c["kv_valid"], np.int32), c["s"])
    ref = jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_valid_len=jnp.asarray(kvl),
                     kv_start=jnp.asarray(np.asarray(c["kv_start"], np.int32)), window=c["window"], block_k=128,
                     interpret=True)
    return np.asarray(ref)


@pytest.mark.parametrize("splits", [1, 2, 5, DECODE_MAX_SPLITS])
def test_decode_split_merge_matches_plain_and_pallas(splits):
    """n_rep 4, B=4, kv_start, a window and a slot past the cache: the warps'
    and ranks' order against decode_attention_ref and the Pallas kernel (the
    slot past the cache only against the plain version: JAX measures the
    window from the clamped length)."""
    c = DECODE_CASE
    q, k, v = (torch.from_numpy(x) for x in _decode_inputs())
    out = decode_split_merge(q, k, v, c["kv_valid"], c["kv_start"], c["window"], splits)
    ref = decode_attention_ref(q, k, v, kv_valid_len=torch.tensor(c["kv_valid"], dtype=torch.int32),
                               kv_start=torch.tensor(c["kv_start"], dtype=torch.int32), window=c["window"])
    torch.testing.assert_close(out, ref, rtol=PLAIN_TOL, atol=PLAIN_TOL)
    inside = np.asarray(c["kv_valid"]) <= c["s"]
    np.testing.assert_allclose(out.numpy()[inside], _jax_decode()[inside], rtol=DECODE_JAX_TOL, atol=DECODE_JAX_TOL)
