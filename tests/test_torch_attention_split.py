"""The decode kernel's key split and its merge, checked on the CPU.

`csrc/decode_attention.cu` cuts the visible keys of each (sequence, KV head)
into runs of whole tiles, one per CTA of a thread-block cluster
(`decode_split_ranges`), lets each CTA leave a partial (m, l, acc) and merges
the partials in rank order through distributed shared memory. The kernel
itself runs only on the card; here the same split and merge are computed in
f32 torch inside the test and held to `decode_attention_ref` and to the JAX
`decode_attention` (Pallas, interpret mode) on the same f32 inputs from a
seed, to 1e-4 (the Pallas kernel folds scale * log2(e) into q and sums in
another order; with f32 inputs the plain version rounds nothing).
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_tpu.ops.decode_attention import decode_attention as jax_decode
from mllm_tpu_torch.ops.decode_attention import (DECODE_MAX_SPLITS, DECODE_TILE, decode_attention_ref,
                                                 decode_split_ranges, decode_splits)

KERNEL_TOL = 1e-4
H, HKV, D, S = 12, 2, 64, 512  # n_rep 6, as the Qwen2-VL-2B geometry
LOG2E = 1.4426950408889634
NEG_BIG = -1e30  # the kernel's empty-partial m

# name: (kv_valid per sequence, kv_start or None, window or None)
SEQUENCES = {
    "empty_and_single_key": ([0, 1, 300], None, None),
    "kv_start": ([300, 200, 512], [17, 150, 0], None),
    "window": ([300, 64, 512], [0, 10, 400], 100),
    "past_the_cache": ([600, 512, 70], None, None),
}
CLUSTERS = (1, 2, 3, 8)


def decode_key_range(kv_valid, kv_start, window, s_max):
    """The keys [lo, hi) a decode query of one sequence sees, as the kernel
    clamps them: hi = min(kv_valid, S); lo = max(kv_start, 0), and with a
    window lo >= kv_valid - window. Empty when hi <= lo."""
    lo = max(int(kv_start), 0)
    if window:
        lo = max(lo, int(kv_valid) - int(window))
    return lo, min(int(kv_valid), s_max)


def _inputs(seed, b):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 1, H, D), dtype=np.float32),
            rng.standard_normal((b, HKV, S, D), dtype=np.float32),
            rng.standard_normal((b, HKV, S, D), dtype=np.float32))


def split_merge(q, k, v, kv_valid, kv_start, window, splits):
    """The kernel's computation in f32: per rank (m, l, acc) over its keys in
    base 2, then the merge in rank order; a sequence with no key gets zeros."""
    b, _, h, d = q.shape
    n_rep = h // HKV
    out = torch.zeros(b, 1, h, d)
    scale_log2 = d**-0.5 * LOG2E
    for i in range(b):
        lo, hi = decode_key_range(kv_valid[i], 0 if kv_start is None else kv_start[i], window, S)
        for hk in range(HKV):
            qg = q[i, 0, hk * n_rep:(hk + 1) * n_rep]  # [n_rep, D]
            parts = []
            for start, stop in decode_split_ranges(lo, hi, splits):
                if stop <= start:
                    parts.append((torch.full((n_rep,), NEG_BIG), torch.zeros(n_rep), torch.zeros(n_rep, d)))
                    continue
                x = qg @ k[i, hk, start:stop].T * scale_log2  # [n_rep, keys]
                m = x.max(dim=1).values
                p = torch.exp2(x - m[:, None])
                parts.append((m, p.sum(dim=1), p @ v[i, hk, start:stop]))
            mx = torch.stack([m for m, _, _ in parts]).max(dim=0).values
            l_sum, acc = torch.zeros(n_rep), torch.zeros(n_rep, d)
            for m, l_r, a_r in parts:  # rank order
                e = torch.exp2(m - mx)
                l_sum = l_sum + l_r * e
                acc = acc + a_r * e[:, None]
            safe = torch.where(l_sum > 0, l_sum, torch.ones_like(l_sum))
            out[i, 0, hk * n_rep:(hk + 1) * n_rep] = torch.where(l_sum[:, None] > 0, acc / safe[:, None], 0.0)
    return out


@functools.cache
def _jax_reference(name):
    """The Pallas kernel (interpret mode) on the sequence set, with kv_valid
    clamped to the cache, and the rows it defines (a visible key)."""
    kv_valid, kv_start, window = SEQUENCES[name]
    b = len(kv_valid)
    q, k, v = _inputs(7, b)
    kvl = np.minimum(np.asarray(kv_valid, np.int32), S)
    st = np.zeros(b, np.int32) if kv_start is None else np.asarray(kv_start, np.int32)
    ref = jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_valid_len=jnp.asarray(kvl),
                     kv_start=jnp.asarray(st), window=window, block_k=128, interpret=True)
    seen = np.array([decode_key_range(kv_valid[i], st[i], window, S)[1]
                     > decode_key_range(kv_valid[i], st[i], window, S)[0] for i in range(b)])
    return np.asarray(ref), seen


@pytest.mark.parametrize("splits", CLUSTERS)
@pytest.mark.parametrize("name", list(SEQUENCES))
def test_split_merge_matches_plain_and_pallas(name, splits):
    kv_valid, kv_start, window = SEQUENCES[name]
    b = len(kv_valid)
    q, k, v = (torch.from_numpy(x) for x in _inputs(7, b))
    out = split_merge(q, k, v, kv_valid, kv_start, window, splits)
    ref = decode_attention_ref(q, k, v, kv_valid_len=torch.tensor(kv_valid, dtype=torch.int32),
                               kv_start=None if kv_start is None else torch.tensor(kv_start, dtype=torch.int32),
                               window=window)
    torch.testing.assert_close(out, ref, rtol=KERNEL_TOL, atol=KERNEL_TOL)
    jax_out, seen = _jax_reference(name)
    if window is None or max(kv_valid) <= S:  # JAX sees the clamped lengths
        np.testing.assert_allclose(out.numpy()[seen], jax_out[seen], rtol=KERNEL_TOL, atol=KERNEL_TOL)


@pytest.mark.parametrize("lo,hi", [(0, 0), (0, 1), (5, 5), (0, 1531), (100, 130), (63, 65), (700, 2048)])
@pytest.mark.parametrize("splits", CLUSTERS)
def test_split_ranges_are_ordered_whole_tile_runs(lo, hi, splits):
    """The ranks' keys are disjoint, in rank order, cover [lo, hi) exactly,
    and each non-empty run starts and ends on a tile boundary of the grid
    rounded down from lo (or at lo / hi); no rank gets more tiles than
    ceil(tiles / splits)."""
    ranges = decode_split_ranges(lo, hi, splits)
    assert len(ranges) == splits
    keys = [j for start, stop in ranges for j in range(start, stop)]
    assert keys == list(range(lo, max(lo, hi)))
    t0 = lo // DECODE_TILE * DECODE_TILE
    tiles = -(-(hi - t0) // DECODE_TILE) if hi > lo else 0
    for start, stop in ranges:
        assert start <= stop
        if stop > start:
            assert start == lo or (start - t0) % DECODE_TILE == 0
            assert stop == hi or (stop - t0) % DECODE_TILE == 0
            span = -(-(stop - t0) // DECODE_TILE) - (start - t0) // DECODE_TILE
            assert span <= math.ceil(tiles / splits)


def test_cluster_size_rule():
    """The host's cluster size fills the card from B * H_kv and S alone: at
    most the portable 8, at most the cache's tiles, 1 when the grid is full."""
    assert decode_splits(1, 2, 6, 2048, 132) == DECODE_MAX_SPLITS
    assert decode_splits(8, 2, 6, 2048, 132) == DECODE_MAX_SPLITS  # 128 CTAs
    assert decode_splits(32, 2, 6, 2048, 132) == 3
    assert decode_splits(128, 2, 6, 2048, 132) == 1
    assert decode_splits(1, 2, 6, 100, 132) == 2  # two tiles of cache
    assert decode_splits(1, 1, 40, 2048, 132) == DECODE_MAX_SPLITS  # 3 head groups
