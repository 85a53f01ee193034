"""The narrow flash bodies (head_dim 64 and 80), checked on the CPU.

`csrc/flash_attention.cu` runs head_dim 64 and 80 on bodies of their own
(`flash_narrow_kernel`): 128-key tiles, three ring stages, D = 80 as one
64-column box and a 16-column rest box, and an overlapped loop in which tile
it + 1's S is issued beside tile it's P V and its softmax runs while that
P V does (`consume_overlapped` in `csrc/flash_attention.cuh`). The grid is
persistent (`flash_persistent_units`): one CTA an SM walks units of one
(sequence, head, q-tile), each over all of its key tiles (`flash_tile_keys(d)`
keys a tile); neither body splits a q-tile's keys over a cluster. The
kernels run only on the card; here the division
is checked on its own, the turns of the overlapped loop are simulated, and
the kernels' order of work is computed in f32 torch and held to the plain
version (1e-5) and to the JAX package on the same f32 inputs from a seed:
the Pallas flash kernel in interpret mode at head_dim 64, causal, and
`attend_padded_head` at 80, non-causal (2e-3, as
`test_torch_attention_rebalance.py` holds the Pallas flash kernel).
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

from mllm_tpu.nn.attention import attend_padded_head as jax_attend_padded_head
from mllm_tpu.ops.flash_attention import flash_attention as jax_flash
from mllm_tpu_torch.ops._common import flash_visible_keys
from mllm_tpu_torch.ops.flash_attention import (FLASH_BQ, FLASH_MAX_SPLITS, FLASH_MIN_RUN, FLASH_SPLIT_HEAD_DIMS,
                                                FLASH_TILE, FLASH_TILE_WIDE, LOG2E, flash_attention_ref,
                                                flash_launch_splits, flash_persistent_units, flash_qtile_tiles,
                                                flash_tile_keys, flash_unit)
from mllm_tpu_torch.utils.runtime import csrc_dir

NEG_BIG = -1e30  # the kernels' empty-partial m
PLAIN_TOL = 1e-5  # against the plain version, f32 inputs: only the order of the f32 sums differs
JAX_TOL = 2e-3  # test_torch_attention_rebalance.FLASH_JAX_TOL: the Pallas flash kernel over several blocks


def source_int(name: str, file: str) -> int:
    """The value of `constexpr int NAME = <int>;` in csrc/FILE."""
    with open(os.path.join(csrc_dir(), file)) as f:
        m = re.search(rf"constexpr int {name} = (\d+);", f.read())
    assert m, f"{name} in {file}"
    return int(m.group(1))


def test_narrow_constants_are_the_kernels():
    """The Python rule uses the narrow bodies' constants: 128-key tiles at
    64 and 80, 64 at 256; the one body that splits is the one the C entry
    point lets split (256), and no narrow kernel carries the split."""
    assert FLASH_TILE == source_int("kBK", "flash_attention.cuh")
    assert FLASH_TILE_WIDE == source_int("kBKWide", "flash_attention.cuh")
    assert FLASH_BQ == source_int("kBQ", "flash_attention.cuh")
    assert FLASH_MIN_RUN == source_int("kMinRun", "flash_attention.cuh")
    assert FLASH_MAX_SPLITS == source_int("kMaxSplits", "flash_attention.cuh")
    assert [flash_tile_keys(d) for d in (64, 80, 128, 256)] == [FLASH_TILE] * 3 + [FLASH_TILE_WIDE]
    assert FLASH_SPLIT_HEAD_DIMS == (256,)
    with open(os.path.join(csrc_dir(), "flash_attention.cu")) as f:
        src = f.read()
    assert "(D != 256 && splits != 1)" in src
    for d in (64, 80):
        assert f"case {d}: return launch_narrow<{d}>" in src
    assert "const auto kernel = flash_fwd_kernel<256, true>;" in src
    assert "template <int D>\n__global__ void __launch_bounds__(kThreads, 1)\n    flash_narrow_kernel(" in src


@pytest.mark.parametrize("d", [64, 80, 128])
def test_launch_splits_without_a_card(d):
    """The 64, 80 and 128 bodies never split (a short chunk at 64 runs the
    persistent grid on fewer CTAs): their cluster size needs no card."""
    assert flash_launch_splits(1, 1536, 2048, 12, d, True, None, 0, 0, 1536) == 1
    assert flash_launch_splits(1, 128, 2048, 16, d, True, None, 0, 1408, 1536) == 1


# ---------------------------------------------------------------------------
# the division
# ---------------------------------------------------------------------------

def grid_order(b: int, h: int, nq: int) -> list:
    """(sequence, head, q-tile) of each unit of the heaviest-first list."""
    return [flash_unit(u, b, h, nq) for u in range(nq * h * b)]


def test_unit_order_is_the_kernels():
    """`flash_unit` and `flash_persistent_units` state the sources' index
    arithmetic (`unit_tiles`, `narrow_unit`)."""
    with open(os.path.join(csrc_dir(), "flash_attention.cuh")) as f:
        cuh = f.read()
    with open(os.path.join(csrc_dir(), "flash_attention.cu")) as f:
        cu = f.read()
    assert "const int qt = p.n_qtiles - 1 - cl / per_tile;" in cuh
    assert "c.h = cl % p.H;" in cuh and "c.b = (cl / p.H) % p.B;" in cuh
    assert "return k * ctas + ((k & 1) ? ctas - 1 - cta : cta);" in cu
    assert "launch_clusters(flash_narrow_kernel<D>, min(p.n_qtiles * p.H * p.B, sms), 1, narrow_smem_bytes<D>()," in cu
    assert flash_unit(0, 2, 3, 4) == (0, 0, 3) and flash_unit(3, 2, 3, 4) == (1, 0, 3)
    assert flash_unit(6, 2, 3, 4) == (0, 0, 2)


# (64, 132): a 256-row chunk of `demo_llm --chunked 256` at 32 heads; (448,
# 132): a 1792-token prompt at 32 heads (14 q-tiles)
@pytest.mark.parametrize("n_units, ctas", [(1, 1), (7, 7), (64, 64), (132, 132), (192, 132), (384, 132),
                                           (448, 132), (1000, 132), (265, 132)])
def test_persistent_units_cover_each_unit_once(n_units, ctas):
    """Every unit to exactly one CTA; a CTA's units alternate forward and
    backward rounds; no CTA holds more than one unit more than another."""
    units = flash_persistent_units(n_units, ctas)
    assert sorted(u for us in units for u in us) == list(range(n_units))
    for i, us in enumerate(units):
        assert us == [k * ctas + (ctas - 1 - i if k & 1 else i) for k in range(len(us))]
    counts = [len(us) for us in units]
    assert max(counts) - min(counts) <= 1


def test_persistent_units_balance_causal_prefill():
    """OpenELM-1_1B's 1536-token prefill (32 heads, 12 q-tiles: 384 units of
    1-12 key tiles over 132 CTAs, 18.9 a CTA on average): the alternating
    rounds give the busiest CTA 21 tiles, where plain strides (unit k ctas +
    i) give it 24."""
    nq, h, sq = 12, 32, 1536
    tiles = [flash_qtile_tiles(flash_unit(u, 1, h, nq)[2] * FLASH_BQ, sq, 0, sq, 0, True, None, sq,
                               FLASH_TILE)[1] for u in range(nq * h)]
    per_cta = [sum(tiles[u] for u in us) for us in flash_persistent_units(nq * h, 132)]
    assert sum(per_cta) == sum(tiles) and max(per_cta) == 21
    strided = [sum(tiles[u] for u in range(i, nq * h, 132)) for i in range(132)]
    assert max(strided) == 24


@settings(max_examples=150, deadline=None)
@given(data=st.data(), b=st.integers(1, 3), sq=st.integers(1, 700), causal=st.booleans(),
       window=st.one_of(st.none(), st.integers(1, 500)), d=st.sampled_from((64, 80)))
def test_narrow_division_covers_each_visible_pair_once(data, b, sq, causal, window, d):
    """Over causal, window, q_offset, kv_start, ragged lengths and Sq not a
    multiple of 128, at the narrow bodies' 128-key tiles: every visible
    (query, key) pair falls in exactly one tile of its unit (sequence, head,
    q-tile); the grid holds every unit once, and the persistent CTAs every
    unit once; and with one kv_valid and no kv_start or window the units come
    heaviest first."""
    tile = flash_tile_keys(d)
    skv = data.draw(st.integers(max(1, sq), 1100))
    q_offset = data.draw(st.integers(0, skv - sq)) if causal else 0
    kv_valid = data.draw(st.lists(st.integers(0, skv + 50), min_size=b, max_size=b))
    kv_start = data.draw(st.lists(st.integers(0, skv), min_size=b, max_size=b))
    ok = flash_visible_keys(b, sq, skv, q_offset, torch.tensor(kv_valid), torch.tensor(kv_start), causal, window,
                            "cpu").expand(b, sq, skv)
    nq = -(-sq // FLASH_BQ)
    order = grid_order(b, 2, nq)
    assert sorted(order) == sorted({(i, hh, qt) for i in range(b) for hh in range(2) for qt in range(nq)})
    ctas = data.draw(st.integers(1, len(order)))
    assert sorted(u for us in flash_persistent_units(len(order), ctas) for u in us) == list(range(len(order)))
    for i, _, qt in order:
        kb0, ntiles = flash_qtile_tiles(qt * FLASH_BQ, sq, q_offset, kv_valid[i], kv_start[i], causal, window,
                                        skv, tile)
        seen = torch.zeros(skv, dtype=torch.int32)
        for it in range(ntiles):
            seen[max(kb0 + it * tile, 0):min(kb0 + (it + 1) * tile, skv)] += 1
        need = ok[i, qt * FLASH_BQ:(qt + 1) * FLASH_BQ].any(0)
        assert bool((seen[need] == 1).all()) and int(seen.max()) <= 1
    if causal and window is None:
        weights = [flash_qtile_tiles(qt * FLASH_BQ, sq, q_offset, kv_valid[0], 0, True, None, skv, tile)[1]
                   for _, _, qt in grid_order(1, 2, nq)]
        assert weights == sorted(weights, reverse=True)


# ---------------------------------------------------------------------------
# the overlapped loop's turns
# ---------------------------------------------------------------------------

def overlapped_events(ntiles: int, it_a: int, it_b: int) -> list:
    """One warpgroup's events in `consume_overlapped`'s order: ("k", t) for
    wait_k(t), ("turn", issued) for each turn with the products it issues
    (("s", t) and ("pv", t)), ("wait1"), ("wait0")."""
    ev = []
    for t in range(it_a):
        ev += [("k", t), ("turn", ())]
    if it_a < it_b:
        ev += [("k", it_a), ("turn", (("s", it_a),)), ("wait0",)]
        for t in range(it_a + 1, it_b):
            ev += [("k", t), ("turn", (("s", t), ("pv", t - 1))), ("wait1",), ("wait0",)]
        if it_b < ntiles:
            ev += [("k", it_b)]
        ev += [("turn", (("pv", it_b - 1),)), ("wait0",)]
        for t in range(it_b + 1, ntiles):
            ev += [("k", t), ("turn", ())]
        if it_b == ntiles:
            return ev
    else:
        for t in range(it_a, ntiles):
            ev += [("k", t), ("turn", ())]
    return ev + [("turn", ())]


@pytest.mark.parametrize("ntiles", [1, 2, 3, 7])
def test_overlapped_turns_match_across_warpgroups(ntiles):
    """Whatever range each warpgroup computes, both take ntiles + 1 turns
    and reach wait_k(t) right before their turn t (so the stale-V pass,
    which both warpgroups meet in wait_k, never waits on a turn the other
    cannot take); each computed tile's S comes before its P V, S of tile t +
    1 is issued before P V of tile t, and every product is waited for."""
    ranges = [(a, b) for a in range(ntiles + 1) for b in range(a, ntiles + 1)]
    for it_a, it_b in ranges:
        ev = overlapped_events(ntiles, it_a, it_b)
        turns = [e for e in ev if e[0] == "turn"]
        assert len(turns) == ntiles + 1
        seen_turns = 0
        for e in ev:
            if e[0] == "turn":
                seen_turns += 1
            elif e[0] == "k":
                assert seen_turns == e[1]
        issued = [x for e in turns for x in e[1]]
        assert [x for x in issued if x[0] == "s"] == [("s", t) for t in range(it_a, it_b)]
        assert [x for x in issued if x[0] == "pv"] == [("pv", t) for t in range(it_a, it_b)]
        for t in range(it_a, it_b):
            assert issued.index(("s", t)) < issued.index(("pv", t))
            if t + 1 < it_b:
                assert issued.index(("s", t + 1)) < issued.index(("pv", t))


# ---------------------------------------------------------------------------
# the arithmetic order
# ---------------------------------------------------------------------------

def narrow_order(q, k, v, q_offset, kv_valid, kv_start, causal, window):
    """The narrow kernels' computation in f32: for each unit (sequence,
    head, q-tile) its 128-key tiles with an online base-2 softmax in the
    overlapped loop's order (tile it's P V added before O is rescaled for
    tile it + 1, which is the per-tile order O = O a + P V), then O / l; a
    row that sees no key is zeros."""
    b, sq, h, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    tile = flash_tile_keys(d)
    scale_log2 = d**-0.5 * LOG2E
    ok = flash_visible_keys(b, sq, skv, q_offset, torch.tensor(kv_valid), torch.tensor(kv_start), causal, window,
                            "cpu").expand(b, sq, skv)
    out = torch.zeros(b, sq, h, d)
    for i in range(b):
        for hh in range(h):
            hk = hh // (h // hkv)
            for qt in range(-(-sq // FLASH_BQ)):
                r0, r1 = qt * FLASH_BQ, min((qt + 1) * FLASH_BQ, sq)
                kb0, ntiles = flash_qtile_tiles(r0, sq, q_offset, kv_valid[i], kv_start[i], causal, window, skv,
                                                tile)
                x_all = q[i, r0:r1, hh] @ k[i, hk].T * scale_log2  # [rows, Skv]
                m = torch.full((r1 - r0,), NEG_BIG)
                l_sum, acc = torch.zeros(r1 - r0), torch.zeros(r1 - r0, d)
                pending = None  # P and V of the tile whose P V is in flight
                for it in range(ntiles):
                    a = kb0 + it * tile
                    keys = slice(max(a, 0), min(a + tile, skv))
                    x = torch.where(ok[i, r0:r1, keys], x_all[:, keys], -math.inf)
                    mn = torch.maximum(m, x.max(dim=1).values)
                    alpha = torch.exp2(m - mn)
                    p = torch.exp2(x - mn[:, None])
                    l_sum = l_sum * alpha + p.sum(dim=1)
                    if pending is not None:
                        acc = acc + pending[0] @ pending[1]
                    acc = acc * alpha[:, None]
                    pending = (p, v[i, hk, keys])
                    m = mn
                if pending is not None:
                    acc = acc + pending[0] @ pending[1]
                inv = torch.where(l_sum > 0, 1.0 / torch.where(l_sum > 0, l_sum, 1.0), 0.0)
                out[i, r0:r1, hh] = inv[:, None] * acc
    return out


# (B, Sq, H, H_kv, D, Skv, q_offset, kv_valid, kv_start, causal, window)
NARROW_CASES = {
    "d64_causal_chunk": (2, 200, 4, 1, 64, 520, 300, [500, 520], [0, 37], True, None),
    "d64_window": (1, 300, 2, 2, 64, 300, 0, [300], [0], True, 140),
    # a 256-row chunk of `demo_llm --chunked 256` (q_offset 1280 over 1536 keys), 2 heads
    "d64_chunked_prefill": (1, 256, 2, 1, 64, 1536, 1280, [1536], [0], True, None),
    "d64_left_pad": (3, 150, 2, 2, 64, 150, 0, [150, 150, 150], [0, 40, 129], True, None),
    "d80_vision": (1, 260, 2, 2, 80, 260, 0, [260], [0], False, None),
    "d80_short_valid": (2, 130, 2, 1, 80, 400, 0, [390, 200], [0, 9], False, None),
}


def _inputs(case: str, seed: int):
    b, sq, h, hkv, d, skv = NARROW_CASES[case][:6]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d), dtype=np.float32),
            rng.standard_normal((b, hkv, skv, d), dtype=np.float32),
            rng.standard_normal((b, hkv, skv, d), dtype=np.float32))


@pytest.mark.parametrize("case", list(NARROW_CASES))
def test_narrow_order_matches_plain(case):
    _, _, _, _, _, _, q_offset, kv_valid, kv_start, causal, window = NARROW_CASES[case]
    q, k, v = (torch.from_numpy(x) for x in _inputs(case, 5))
    out = narrow_order(q, k, v, q_offset, kv_valid, kv_start, causal, window)
    ref = flash_attention_ref(q, k, v, q_offset=q_offset, kv_valid_len=torch.tensor(kv_valid, dtype=torch.int32),
                              kv_start=torch.tensor(kv_start, dtype=torch.int32), causal=causal, window=window)
    torch.testing.assert_close(out, ref, rtol=PLAIN_TOL, atol=PLAIN_TOL)


# the tiniest geometries the JAX package is held to: one sequence, one head
# of 64 over two q-tiles, causal (Pallas in interpret mode); one vision
# image of 160 patches, one head of 80 (attend_padded_head, non-causal)
JAX64 = dict(b=1, sq=256, h=1, hkv=1, d=64)
JAX80 = dict(b=1, sq=160, h=1, hkv=1, d=80)


def _jax_inputs(c: dict, seed: int):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((c["b"], c["sq"], c["h"], c["d"]), dtype=np.float32),
            rng.standard_normal((c["b"], c["hkv"], c["sq"], c["d"]), dtype=np.float32),
            rng.standard_normal((c["b"], c["hkv"], c["sq"], c["d"]), dtype=np.float32))


@functools.cache
def _jax_flash64():
    q, k, v = _jax_inputs(JAX64, 21)
    return np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, interpret=True))


@functools.cache
def _jax_padded80():
    q, k, v = _jax_inputs(JAX80, 23)
    return np.asarray(jax_attend_padded_head(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False))


def test_narrow_order_matches_jax_flash_at_64():
    """head_dim 64, causal: the kernel's order against the Pallas flash
    kernel in interpret mode (called once)."""
    c = JAX64
    q, k, v = (torch.from_numpy(x) for x in _jax_inputs(c, 21))
    out = narrow_order(q, k, v, 0, [c["sq"]], [0], True, None)
    np.testing.assert_allclose(out.numpy(), _jax_flash64(), rtol=JAX_TOL, atol=JAX_TOL)


def test_narrow_order_matches_jax_padded_head_at_80():
    """head_dim 80, non-causal: the kernel's order (rows of 80 columns, no
    padding, one CTA a q-tile) against the JAX `attend_padded_head`."""
    c = JAX80
    q, k, v = (torch.from_numpy(x) for x in _jax_inputs(c, 23))
    out = narrow_order(q, k, v, 0, [c["sq"]], [0], False, None)
    np.testing.assert_allclose(out.numpy(), _jax_padded80(), rtol=JAX_TOL, atol=JAX_TOL)
