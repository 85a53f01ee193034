"""The quantized decode attention and the int8 products of the port, checked on
the CPU in the order their Hopper kernels work.

`csrc/decode_attention_quant.cu` and `csrc/int8_matmul.cu` run only on the
card. Here:
  - the bit constructions their mma fragments use to turn int8 bytes and
    planar int4 nibbles into bf16 (no I2F), and the byte permutes that pair
    them, run in numpy on every value;
  - the decode kernel's order of work (64-key tiles; a cluster rank's tiles
    taken in turns by two halves of four warps, each warp 16 keys of a tile
    with its own online softmax in base 2 and bf16(p * vs) taken against its
    own running max; the eight warps merged in warp order, the ranks in rank
    order) is emulated in f32 torch and held to `decode_attention_quant_ref`
    and to the JAX Pallas kernel in interpret mode, on seeded numpy inputs;
  - the int8 products' order (the stream: each cluster rank's k-rows in
    16-row k-steps, the ranks added in rank order, the column scale last; the
    wgmma kernel: 64-deep k-tiles, the K splits added in rank order) against
    `int8_matmul_ref` and the JAX Pallas kernel in interpret mode;
  - the host plans: every (k-row, column tile) of the stream and every
    (output tile, k-tile) of the wgmma kernel is covered exactly once, the
    splits in rank order, within the card's blocks and shared memory.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mllm_tpu.kv import cache as jcache
from mllm_tpu.ops import decode_attention as jda
from mllm_tpu.ops import quant_matmul as jqm
from mllm_tpu_torch.ops import quant_matmul as qm
from mllm_tpu_torch.ops.decode_attention import (DECODE_TILE, decode_attention_quant_ref, decode_split_ranges,
                                                 decode_splits, stored_values)

LOG2E = 1.4426950408889634
NEG_BIG = -1e30
SMS = 132  # the H100's SMs, which the plans are made for


def bf16_bits_to_f32(bits):
    """uint16 bf16 patterns -> float32 values."""
    return (np.asarray(bits, np.uint32) << 16).view(np.float32)


def to_bf16(x):
    """float32 -> float32 rounded to bf16 (nearest even)."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def prmt(a, b, sel):
    """PTX prmt.b32 (default mode): byte i of the result is byte (sel >> 4i) & 7
    of the 8-byte value b:a."""
    src = (np.asarray(b, np.uint64) << np.uint64(32)) | np.asarray(a, np.uint64)
    out = np.zeros_like(np.asarray(a, np.uint64))
    for i in range(4):
        k = (sel >> (4 * i)) & 7
        out |= ((src >> np.uint64(8 * k)) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out.astype(np.uint32)


def int8_to_bf16x2(v):
    """int4_stream.cuh `int8_to_bf16x2`: the int8 values in bits 0-7 and 16-23
    of v as (low, high) floats: bf16(0x4300 | (b & 0x7f)) - bf16(0x4300 | (b & 0x80))."""
    v = np.asarray(v, np.uint32)
    magic = (v & np.uint32(0x007F007F)) | np.uint32(0x43004300)
    bias = (v & np.uint32(0x00800080)) | np.uint32(0x43004300)
    f = lambda w, s: bf16_bits_to_f32((w >> np.uint32(s)) & np.uint32(0xFFFF))  # noqa: E731
    return to_bf16(f(magic, 0) - f(bias, 0)), to_bf16(f(magic, 16) - f(bias, 16))


def nibbles_to_bf16x2(v):
    """int4_stream.cuh `nibbles_to_bf16x2<false>`: the nibbles in bits 0-3 and
    16-19 of v minus 8: bf16(0x4300 | n) - 136."""
    v = np.asarray(v, np.uint32)
    magic = (v & np.uint32(0x000F000F)) | np.uint32(0x43004300)
    f = lambda w, s: bf16_bits_to_f32((w >> np.uint32(s)) & np.uint32(0xFFFF))  # noqa: E731
    return to_bf16(f(magic, 0) - 136.0), to_bf16(f(magic, 16) - 136.0)


# ---------------------------------------------------------------------------
# Bit constructions
# ---------------------------------------------------------------------------


def test_int8_pairs_to_bf16_exhaustive():
    """Every pair of int8 bytes (65536), with the other two bytes of the word
    set to garbage, converts to the exact pair of integers."""
    lo, hi = np.meshgrid(np.arange(256, dtype=np.uint32), np.arange(256, dtype=np.uint32), indexing="ij")
    garbage = np.uint32(0xA5005A00)
    v = lo | (hi << np.uint32(16)) | garbage
    got_lo, got_hi = int8_to_bf16x2(v)
    np.testing.assert_array_equal(got_lo, lo.astype(np.uint8).view(np.int8).astype(np.float32))
    np.testing.assert_array_equal(got_hi, hi.astype(np.uint8).view(np.int8).astype(np.float32))


def test_planar_nibbles_to_bf16_exhaustive():
    """Every stored int4-KV byte (low nibble: head dim j, high: j + D/2, both
    excess-8) gives its two values through the low and the >> 4 paths, as
    `unpack4_planar` unpacks them."""
    byte = np.arange(256, dtype=np.uint32)
    v = byte | (byte[::-1] << np.uint32(16))
    lo_a, lo_b = nibbles_to_bf16x2(v)
    hi_a, hi_b = nibbles_to_bf16x2(v >> np.uint32(4))
    unpacked = stored_values(torch.from_numpy(byte.astype(np.uint8))[:, None]).numpy()  # [256, 2]
    np.testing.assert_array_equal(lo_a, unpacked[:, 0])
    np.testing.assert_array_equal(hi_a, unpacked[:, 1])
    np.testing.assert_array_equal(lo_b, unpacked[::-1, 0])
    np.testing.assert_array_equal(hi_b, unpacked[::-1, 1])


# (selector, the bytes of b:a that must land in bits 0-7 and 16-23)
SELECTORS = [(0x4140, (0, 1)), (0x4342, (2, 3)), (0x5410, (0, 4)), (0x7632, (2, 6))] + [
    ((i % 4) | ((4 + i % 4) << 8), (i % 4, 4 + i % 4)) for i in range(4)]


@pytest.mark.parametrize("sel,src", SELECTORS, ids=[f"{s:#06x}" for s, _ in SELECTORS])
def test_prmt_pairs_the_right_bytes(sel, src):
    """The permutes that pair two bytes (two rows of a weight stage, two keys
    of a V tile, two columns of an int8 weight tile) put them in the two
    halves the conversion reads; with the >> 8 path for 0x5410 / 0x7632."""
    rng = np.random.default_rng(sel)
    a, b = (rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32) for _ in range(2))
    if sel == 0x4140 or sel == 0x4342:
        b = np.zeros_like(b)
    w = prmt(a, b, sel)
    byte = lambda x, i: ((np.asarray(x, np.uint64) >> np.uint64(8 * i)) & np.uint64(0xFF))  # noqa: E731
    ab = lambda i: byte(a, i) if i < 4 else byte(b, i - 4)  # noqa: E731
    np.testing.assert_array_equal(byte(w, 0), ab(src[0]))
    np.testing.assert_array_equal(byte(w, 2), ab(src[1]))
    lo, hi = int8_to_bf16x2(w)
    np.testing.assert_array_equal(lo, ab(src[0]).astype(np.uint8).view(np.int8))
    np.testing.assert_array_equal(hi, ab(src[1]).astype(np.uint8).view(np.int8))
    if sel in (0x5410, 0x7632):  # the second column of the pair: bytes 1 and 3
        lo, hi = int8_to_bf16x2(w >> np.uint32(8))
        np.testing.assert_array_equal(lo, ab(src[0] + 1).astype(np.uint8).view(np.int8))
        np.testing.assert_array_equal(hi, ab(src[1] + 1).astype(np.uint8).view(np.int8))


# ---------------------------------------------------------------------------
# The decode kernel's order
# ---------------------------------------------------------------------------

H, HKV, S, B = 12, 2, 512, 3  # n_rep 6, as the Qwen2-VL-2B geometry
HALVES, HALF_WARPS = 2, DECODE_TILE // 16
# name: (kv_valid per sequence, kv_start or None, window or None)
QUANT_SEQUENCES = {
    "kv_start": ([300, 200, 512], [17, 150, 0], None),
    "window": ([300, 64, 512], [0, 10, 400], 100),
    "empty_ranks_and_slot": ([0, 1, 70], None, None),
    "past_the_cache": ([600, 512, 130], [0, 0, 64], None),
}
# f32 inputs: the emulation and the plain version differ only in where
# bf16(p * vs) is taken (each warp's running max against the global max), a
# relative 2^-9 on each term; the Pallas kernel takes it against its own
# 128-key blocks' running max, so against it both roundings differ
DECODE_TOL = 2e-3
DECODE_PALLAS_TOL = 4e-3


def decode_key_range(kv_valid, kv_start, window):
    lo = max(int(kv_start), 0)
    if window:
        lo = max(lo, int(kv_valid) - int(window))
    return lo, min(int(kv_valid), S)


def kernel_order_decode(q, k, v, ks, vs, kv_valid, kv_start, window, splits):
    """csrc/decode_attention_quant.cu's arithmetic in f32 torch: qs =
    bf16(q * scale) against the stored integers, x ks, base 2; per warp of a
    half an online softmax over its 16 keys of each of the half's tiles with
    bf16(p * vs); warps merged in order, ranks merged in order."""
    b, _, h, d = q.shape
    n_rep = h // HKV
    scale = torch.tensor(d**-0.5, dtype=torch.bfloat16).float()  # rounded to q's dtype by the wrapper (bf16 q)
    kv_int, vv_int = stored_values(k), stored_values(v)  # [B, HKV, S, D] f32 integers
    out = torch.zeros(b, 1, h, d)
    for i in range(b):
        lo, hi = decode_key_range(kv_valid[i], 0 if kv_start is None else kv_start[i], window)
        t0 = lo // DECODE_TILE * DECODE_TILE
        ntiles = -(-(hi - t0) // DECODE_TILE) if hi > lo else 0
        per = -(-ntiles // splits)  # decode_split_ranges' rule
        for hk in range(HKV):
            qs = (q[i, 0, hk * n_rep:(hk + 1) * n_rep] * scale).to(torch.bfloat16).float()  # [n_rep, D]
            ranks = []
            for r in range(splits):
                first = min(r * per, ntiles)
                mine = min(first + per, ntiles) - first
                warps = []
                for half in range(HALVES):
                    for w in range(HALF_WARPS):
                        m = torch.full((n_rep,), NEG_BIG)
                        l, acc = torch.zeros(n_rep), torch.zeros(n_rep, d)
                        for it in range(half, mine, HALVES):
                            key0 = t0 + (first + it) * DECODE_TILE + 16 * w
                            j = torch.arange(key0, key0 + 16)
                            ok = (j >= lo) & (j < hi)
                            jj = j.clamp(max=S - 1)
                            sc = (qs @ kv_int[i, hk, jj].T) * ks[i, hk, jj] * LOG2E
                            sc = torch.where(ok, sc, torch.tensor(-float("inf")))
                            mn = torch.maximum(m, sc.max(dim=1).values)
                            a = torch.exp2(m - mn)
                            p = torch.exp2(sc - mn[:, None])
                            l = l * a + p.sum(dim=1)
                            vsc = torch.where(ok, vs[i, hk, jj], torch.zeros(()))
                            pv = (p * vsc).to(torch.bfloat16).float()
                            vrows = torch.where(ok[:, None], vv_int[i, hk, jj], torch.zeros(()))
                            acc = acc * a[:, None] + pv @ vrows
                            m = mn
                        warps.append((m, l, acc))
                ranks.append(_merge(warps))
            m, l, acc = _merge(ranks)
            safe = torch.where(l > 0, l, torch.ones_like(l))
            out[i, 0, hk * n_rep:(hk + 1) * n_rep] = torch.where(l[:, None] > 0, acc / safe[:, None], 0.0)
    return out


def _merge(parts):
    """(m, l, acc) partials merged in order, base 2."""
    mx = torch.stack([m for m, _, _ in parts]).max(dim=0).values
    l, acc = torch.zeros_like(parts[0][1]), torch.zeros_like(parts[0][2])
    for m, l_p, a_p in parts:
        e = torch.exp2(m - mx)
        l = l + l_p * e
        acc = acc + a_p * e[:, None]
    return mx, l, acc


@functools.cache
def _quant_inputs(bits, d, seed=11):
    rng = np.random.default_rng(seed)
    cls = jcache.QuantKVCache if bits == 8 else jcache.Quant4KVCache
    kv = []
    for _ in range(2):
        qv, sc = jax.jit(cls._quantize)(jnp.asarray(rng.standard_normal((B, HKV, S, d)), jnp.float32))
        kv += [np.asarray(qv), np.asarray(sc)]
    q = to_bf16(rng.standard_normal((B, 1, H, d)))
    return q, kv  # k, ks, v, vs


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("name", list(QUANT_SEQUENCES))
def test_decode_quant_kernel_order(name, bits, d):
    kv_valid, kv_start, window = QUANT_SEQUENCES[name]
    q, (k, ks, v, vs) = _quant_inputs(bits, d)
    tq, tk, tks, tv, tvs = (torch.from_numpy(np.array(x)) for x in (q, k, ks, v, vs))
    splits = decode_splits(B, HKV, H // HKV, S, SMS)
    out = kernel_order_decode(tq, tk, tv, tks, tvs, kv_valid, kv_start, window, splits)
    start_t = None if kv_start is None else torch.tensor(kv_start, dtype=torch.int32)
    ref = decode_attention_quant_ref(tq, tk, tv, tks, tvs, kv_valid_len=torch.tensor(kv_valid, dtype=torch.int32),
                                     kv_start=start_t, window=window)
    torch.testing.assert_close(out, ref, rtol=DECODE_TOL, atol=DECODE_TOL)
    # the Pallas kernel sees the lengths clamped to the cache; it defines the
    # rows with a visible key
    kvl = np.minimum(np.asarray(kv_valid, np.int32), S)
    st = np.zeros(B, np.int32) if kv_start is None else np.asarray(kv_start, np.int32)
    jout = np.asarray(jda.decode_attention_quant(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ks),
                                                 jnp.asarray(vs), kv_valid_len=jnp.asarray(kvl),
                                                 kv_start=jnp.asarray(st), window=window, block_k=128,
                                                 interpret=True))
    seen = np.array([decode_key_range(kv_valid[i], st[i], window)[1] > decode_key_range(kv_valid[i], st[i], window)[0]
                     for i in range(B)])
    if window is None or max(kv_valid) <= S:
        np.testing.assert_allclose(out.numpy()[seen], jout[seen], rtol=DECODE_PALLAS_TOL, atol=DECODE_PALLAS_TOL)


def test_decode_quant_cases_reach_each_path():
    """The sequences above reach what they are named for: a rank with no
    tile, a half with no tile, a slot with no key, a slot past the cache, and
    both ends of the kernel: one rank writing the output alone (a one-tile
    sequence), and several merged through the cluster."""
    splits = decode_splits(B, HKV, H // HKV, S, SMS)
    used = set()
    for kv_valid, kv_start, window in QUANT_SEQUENCES.values():
        for i in range(B):
            lo, hi = decode_key_range(kv_valid[i], 0 if kv_start is None else kv_start[i], window)
            used.add(sum(e > a for a, e in decode_split_ranges(lo, hi, splits)))
    assert {0, 1, 2, splits} <= used
    assert decode_key_range(QUANT_SEQUENCES["empty_ranks_and_slot"][0][0], 0, None) == (0, 0)
    assert max(QUANT_SEQUENCES["past_the_cache"][0]) > S


# ---------------------------------------------------------------------------
# The int8 products' order
# ---------------------------------------------------------------------------

INT8_TOL = 1e-5  # relative: the same exact products, f32 sums in another order


def _int8_operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = to_bf16(rng.standard_normal((m, k)))
    w = rng.standard_normal((n, k)).astype(np.float32) * 0.02
    q, s = qm.repack_float_to_int8(w)
    return x, q, s


def stream_order(x, q, s, plan):
    """csrc/int8_matmul.cu's stream: per column tile, rank r of the cluster
    sums its k-rows in 16-row k-steps (exact bf16 products, f32 sums), the
    ranks are added in rank order, the column scale last."""
    mt8, tn, cluster, rows_per, clusters = plan
    m, k = x.shape
    n = q.shape[1]
    xt, qt = torch.from_numpy(x), torch.from_numpy(q.astype(np.float32))
    out = torch.zeros(m, n)
    for n0 in range(0, n, tn):
        cols = slice(n0, min(n, n0 + tn))
        total = torch.zeros(m, cols.stop - n0)
        for r in range(cluster):
            part = torch.zeros_like(total)
            for k0 in range(min(r * rows_per, k), min((r + 1) * rows_per, k), 16):
                part = part + xt[:, k0:k0 + 16] @ qt[k0:k0 + 16, cols]
            total = total + part
        out[:, cols] = total * torch.from_numpy(s)[cols]
    return out


def gemm_order(x, q, s, plan):
    """The wgmma kernel: per output tile, rank r of the cluster sums its
    64-deep k-tiles, the ranks are added in rank order, the scale last."""
    _, cluster, kper, _ = plan
    m, k = x.shape
    xt, qt = torch.from_numpy(x), torch.from_numpy(q.astype(np.float32))
    total = torch.zeros(m, q.shape[1])
    for r in range(cluster):
        part = torch.zeros_like(total)
        for kt in range(r * kper, min((r + 1) * kper, -(-k // 64))):
            part = part + xt[:, kt * 64:(kt + 1) * 64] @ qt[kt * 64:(kt + 1) * 64]
        total = total + part
    return total * torch.from_numpy(s)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("m,k,n", [(8, 512, 512), (32, 1024, 1024), (3, 1536, 2048)])
def test_int8_stream_order(m, k, n):
    x, q, s = _int8_operands(m, k, n, seed=m + k)
    plan = qm.int8_plan(m, k, n, SMS)
    out = stream_order(x, q, s, plan)
    ref = qm.int8_matmul_ref(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s))
    assert _rel(out, ref) <= INT8_TOL
    jout = jqm.int8_matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(q), jnp.asarray(s), interpret=True)
    assert _rel(out, torch.from_numpy(np.asarray(jout))) <= INT8_TOL


@pytest.mark.parametrize("m,k,n", [(40, 512, 512), (256, 1024, 512), (1536, 256, 512)])
def test_int8_gemm_order(m, k, n):
    x, q, s = _int8_operands(m, k, n, seed=m + n)
    plan = qm.int8_gemm_plan(m, k, n, SMS)
    out = gemm_order(x, q, s, plan)
    ref = qm.int8_matmul_ref(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s))
    assert _rel(out, ref) <= INT8_TOL
    jout = jqm.int8_matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(q), jnp.asarray(s), interpret=True)
    assert _rel(out, torch.from_numpy(np.asarray(jout))) <= INT8_TOL


# ---------------------------------------------------------------------------
# The int8 plans
# ---------------------------------------------------------------------------

STREAM_ROWS = [r for r in chip_smoke.INT8_ROWS if r[0] <= qm.INT8_STREAM_MAX_M]
GEMM_ROWS = [r for r in chip_smoke.INT8_ROWS if r[0] > qm.INT8_STREAM_MAX_M] + [
    (33, 1536, 2048), (200, 1544, 2064), (1536, 8960, 1536), (48, 1536, 17920)]


def check_stream_plan(m, k, n, sms):
    mt8, tn, cluster, rows_per, clusters = qm.int8_plan(m, k, n, sms)
    assert m <= 8 * mt8 and mt8 in (1, 2, 4) and tn in (256, 512)
    assert 1 <= cluster <= qm.INT8_MAX_CLUSTER and rows_per % 32 == 0
    assert clusters * cluster <= sms * qm.int8_blocks_per_sm(mt8)  # one wave of resident blocks
    assert rows_per <= qm.int8_x_rows_cap(mt8, tn)  # x of a rank fits beside its ring and partial
    tiles = -(-n // tn)
    assert clusters <= tiles
    seen = np.zeros((-(-k // 32), tiles), np.int32)  # (32-row stage, column tile)
    for cid in range(clusters):
        for tile in range(cid, tiles, clusters):
            last = -1
            for rank in range(cluster):  # rank order is split order: ascending rows
                j0, j1 = min(rank * rows_per, k), min((rank + 1) * rows_per, k)
                assert j1 > j0  # every rank has rows
                assert j0 > last
                last = j1 - 1
                seen[j0 // 32:-(-j1 // 32), tile] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("m,k,n", STREAM_ROWS)
def test_int8_stream_plan_covers_each_row_once(m, k, n):
    check_stream_plan(m, k, n, SMS)


@pytest.mark.parametrize("m", range(1, qm.INT8_STREAM_MAX_M + 1))
def test_int8_stream_plan_every_m(m):
    for k, n in [(1536, 2048), (1536, 17920), (8960, 1536), (1536, 151936), (1544, 2064)]:
        check_stream_plan(m, k, n, SMS)


@pytest.mark.parametrize("m,k,n", GEMM_ROWS)
def test_int8_gemm_tile_walk_covers_each_tile_once(m, k, n):
    bm, cluster, kper, clusters = qm.int8_gemm_plan(m, k, n, SMS)
    assert bm == (128 if m <= 128 else 256)
    assert 1 <= cluster <= qm.GEMM_MAX_CLUSTER and clusters * cluster <= SMS  # one CTA an SM, one wave
    mtiles, ntiles, ktiles = -(-m // bm), -(-n // qm.GEMM_BN), -(-k // qm.GEMM_BK)
    seen = np.zeros((mtiles * ntiles, ktiles), np.int32)
    for cid in range(clusters):
        for tile in range(cid, mtiles * ntiles, clusters):  # csrc/int8_matmul.cu: m-tiles fastest
            for rank in range(cluster):
                kt = range(min(rank * kper, ktiles), min((rank + 1) * kper, ktiles))
                assert len(kt) > 0
                seen[tile, kt.start:kt.stop] += 1
    assert (seen == 1).all()
