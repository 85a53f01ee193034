"""The quantized prefill attention of the port, checked on the CPU in the order
its Hopper kernel works.

`csrc/flash_attention_quant.cu` runs only on the card. Here:
  - the converter's index map: a raw int8 row, or a planar int4 row, goes
    through the kernel's bit constructions (int4_stream.cuh's int8 / nibble
    to bf16, the f32 product with the key's scale, the bf16 rounding) to its
    place in the 128-byte-swizzled [kDH][kBK][64] stage that wgmma reads;
    un-swizzled it must be bf16(f32(int) * scale) on every key in [lo, hi)
    and zeros elsewhere, where the integers hold 127 and the scales NaN or
    inf. Every element is written once, and the converter's shared-memory
    accesses are free of bank conflicts;
  - the tile schedule (the CTA order, the key tiles a CTA loads, the tiles
    each consumer warpgroup issues, each thread's masks) covers every visible
    (row, key) pair of `flash_visible_keys` exactly once;
  - the kernel's arithmetic in that order (q pre-scaled in bf16, 128-key tiles,
    online softmax in base 2 with scale 1, P rounded to bf16 against the
    running max) against `flash_attention_quant_ref` and the JAX Pallas kernel
    in interpret mode;
  - the folded rounding of q against the wrapper's old pass and JAX's, bit for
    bit;
  - the shared-memory plan of every (D, bits) instance and the setmaxnreg
    split, read from the sources;
  - `flash_attention_quant_ref` against the JAX kernel in interpret mode for
    the combinations tests/test_torch_kvcache.py lacks (a window with
    kv_start, head_dim 64).
"""

import functools
import math
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_tpu.kv import cache as jcache
from mllm_tpu.ops import flash_attention as jfa
from mllm_tpu_torch.ops._common import flash_visible_keys
from mllm_tpu_torch.ops.decode_attention import stored_values
from mllm_tpu_torch.ops.flash_attention import LOG2E, flash_attention_quant_ref, flash_split_runs, quant_q_scale
from mllm_tpu_torch.utils.runtime import csrc_dir

SMEM_LIMIT = 232448  # dynamic shared memory a block may have (H100)
ONE_BLOCK_TOL = 1e-4  # as tests/test_torch_kvcache.py: one key block, the same arithmetic
BLOCKS_TOL = 2e-3     # several blocks: P rounded to bf16 against a running max
OUT_ULP = 2.0**-8     # bf16 outputs on both sides: one rounding of the output may flip (relative)


def source_int(name: str, file: str) -> int:
    """The value of `constexpr int NAME = <int>;` in csrc/FILE."""
    with open(os.path.join(csrc_dir(), file)) as f:
        m = re.search(rf"constexpr int {name} = (\d+);", f.read())
    assert m, f"{name} in {file}"
    return int(m.group(1))


BQ = source_int("kBQ", "flash_attention.cuh")
BK = source_int("kBK", "flash_attention.cuh")
STAGES = source_int("kStages", "flash_attention.cuh")
RAW_STAGES = source_int("kRawStages", "flash_attention_quant.cu")
BATCH = source_int("kBatch", "flash_attention_quant.cu")
RAW_ROWS = source_int("kRawRows", "flash_attention_quant.cu")
PRODUCER = 128  # producer threads (kProducerThreads)
BK_WIDE = source_int("kBKWide", "flash_attention.cuh")  # keys a tile at head_dim 256
WIDE_THREADS = source_int("kThreadsWide", "flash_attention.cuh")  # the consumers, which convert at 256
WIDE_RAW_STAGES = source_int("kWideRawStages", "flash_attention_quant.cu")
MIN_RUN = source_int("kMinRun", "flash_attention.cuh")
MAX_SPLITS = source_int("kMaxSplits", "flash_attention.cuh")


def to_bf16_bits(x):
    """float32 -> bf16 bit patterns (uint16), round to nearest even."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def bf16_bits_to_f32(bits):
    return (np.asarray(bits, np.uint32) << np.uint32(16)).view(np.float32)


def half(v, shift):
    """The bf16 value in bits [shift, shift + 16) of v, as float32."""
    return bf16_bits_to_f32((v >> np.uint32(shift)) & np.uint32(0xFFFF))


def int8_pair(v):
    """int4_stream.cuh `int8_to_bf16x2`: bytes 0 and 2 of v as exact integers
    (float32): bf16(0x4300 | b & 0x7f) - bf16(0x4300 | b & 0x80)."""
    magic = (v & np.uint32(0x007F007F)) | np.uint32(0x43004300)
    bias = (v & np.uint32(0x00800080)) | np.uint32(0x43004300)
    return half(magic, 0) - half(bias, 0), half(magic, 16) - half(bias, 16)


def nibble_pair(v):
    """int4_stream.cuh `nibbles_to_bf16x2<false>`: the nibbles in bits 0-3 and
    16-19 of v minus 8: bf16(0x4300 | n) - 136."""
    magic = (v & np.uint32(0x000F000F)) | np.uint32(0x43004300)
    return half(magic, 0) - np.float32(136), half(magic, 16) - np.float32(136)


def scaled_chunk(pairs, s):
    """`scaled_chunk`: the integer pairs (0, 2), (1, 3), (4, 6), (5, 7) times s
    in f32, each rounded to bf16: the chunk's 8 bf16 patterns in order."""
    (e0, e2), (e1, e3), (e4, e6), (e5, e7) = pairs
    vals = np.stack([e0, e1, e2, e3, e4, e5, e6, e7], -1).astype(np.float32) * s[..., None].astype(np.float32)
    return to_bf16_bits(vals)


def swizzled(chunk, r, sb=None):
    """`swizzled<SB>`: the element offset of 16-byte chunk `chunk` of key row
    r in a stage of sb key rows (kBK; kBKWide at head_dim 256)."""
    return ((chunk // 8) * (sb or BK) + r) * 64 + ((chunk % 8) ^ (r % 8)) * 8


def converter(d):
    """(threads, rows a raw part, rows a bf16 stage) of `convert_part`: the
    producer warpgroup over kRawRows-key parts of 128-key tiles, or at head
    dim 256 every consumer thread over a whole 64-key tile."""
    return (WIDE_THREADS, BK_WIDE, BK_WIDE) if d > 128 else (PRODUCER, RAW_ROWS, BK)


def geometry(d, bits):
    """`Geo`: (bytes of a stored row, 8-byte units a row, rows apart of a
    converter's units, steps a matrix of a raw stage, loads a batch)."""
    nt, rows, _ = converter(d)
    ds = d if bits == 8 else d // 2
    u_per = ds // 8
    rs = nt // u_per
    steps = rows // rs
    return ds, u_per, rs, steps, min(BATCH, steps)


def converter_ops(d, bits):
    """Every shared-memory access of `convert_part` for one raw stage (the
    rows of one matrix), instruction by instruction: [(kind, byte address of
    each converter thread)] in issue order (a batch's loads, then its stores),
    for the warp accounting of bank conflicts. Loads address the raw stage,
    stores the bf16 stage (1024-byte aligned)."""
    nt, _, sb = converter(d)
    ds, u_per, rs, steps, kb = geometry(d, bits)
    t = np.arange(nt)
    u, r0 = t % u_per, t // u_per
    ops = []
    for j0 in range(0, steps, kb):
        for k in range(kb):
            ops.append(("load", (r0 + (j0 + k) * rs) * ds + u * 8))
        for k in range(kb):
            row = r0 + (j0 + k) * rs
            if bits == 8:
                ops.append(("store", 2 * swizzled(u, row, sb)))
            else:  # odd rows store their high chunk first
                first = np.where(row % 2 == 1, d // 16 + u, u)
                second = np.where(row % 2 == 1, u, d // 16 + u)
                ops += [("store", 2 * swizzled(first, row, sb)), ("store", 2 * swizzled(second, row, sb))]
    return ops


def convert_part(raw, scales, row0, key0, lo, hi, d, bits, out, written):
    """Mirror of `convert_part`: raw [rows, DS] uint8 (the K or V rows of keys
    key0 .. as stored) and their scales [rows] f32 into rows row0 .. of the
    bf16 stage `out` [D / 64 * SB * 64] (bf16 patterns in shared-memory
    order); counts each element written in `written`."""
    nt, rows, sb = converter(d)
    ds, u_per, rs, steps, _ = geometry(d, bits)
    t, j = np.meshgrid(np.arange(nt), np.arange(steps), indexing="ij")
    t, j = t.ravel(), j.ravel()
    u, r = t % u_per, t // u_per + j * rs  # r: the row of the raw stage
    w = raw.reshape(rows, u_per, 2, 4).copy().view(np.uint32)[..., 0]  # little-endian words
    w0, w1 = w[r, u, 0], w[r, u, 1]
    s = scales[r]
    ok = (key0 + r >= lo) & (key0 + r < hi)
    sh = lambda x, n: x >> np.uint32(n)  # noqa: E731
    if bits == 8:
        chunks = [(u, scaled_chunk([int8_pair(w0), int8_pair(sh(w0, 8)), int8_pair(w1), int8_pair(sh(w1, 8))], s))]
    else:
        lo_c = scaled_chunk([nibble_pair(w0), nibble_pair(sh(w0, 8)), nibble_pair(w1), nibble_pair(sh(w1, 8))], s)
        hi_c = scaled_chunk([nibble_pair(sh(w0, 4)), nibble_pair(sh(w0, 12)), nibble_pair(sh(w1, 4)),
                             nibble_pair(sh(w1, 12))], s)
        chunks = [(u, lo_c), (d // 16 + u, hi_c)]
    for chunk, vals in chunks:
        off = swizzled(chunk, row0 + r, sb)
        vals = np.where(ok[:, None], vals, np.uint16(0))
        for e in range(8):
            out[off + e] = vals[:, e]
            np.add.at(written, off + e, 1)


def convert_tile(raw, scales, kb, lo, hi, d, bits):
    """A tile's raw stages (raw [2, SB, DS] of K and V, scales [2, SB]; each
    matrix cut into parts of the converter's rows) through `convert_part`:
    the two bf16 stages, every element written exactly once."""
    _, rows, sb = converter(d)
    out = np.full((2, d // 64 * sb * 64), 0xFFFF, np.uint16)
    written = np.zeros(out.shape, np.int64)
    for m in range(2):
        for h in range(sb // rows):
            part = slice(h * rows, (h + 1) * rows)
            convert_part(raw[m, part], scales[m, part], h * rows, kb + h * rows, lo, hi, d, bits, out[m], written[m])
    assert (written == 1).all(), "every element of the two stages is written exactly once"
    return out


def unswizzle(stage, d):
    """[D / 64 * SB * 64] bf16 patterns in shared-memory order -> [SB, D]."""
    sb = converter(d)[2]
    r = np.arange(sb)[:, None]
    col = np.arange(d)[None, :]
    return stage[swizzled(col // 8, r, sb) + col % 8]


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("bits", [8, 4])
def test_converter_index_map(d, bits):
    """A tile whose keys cut [lo, hi) on both sides: un-swizzled, the stages
    hold bf16(f32(int) * scale) on every key in [lo, hi) and zeros outside,
    where the integers are 127 and the scales NaN / inf (at head_dim 256 the
    consumers' conversion of a 64-key tile)."""
    sb = converter(d)[2]
    rng = np.random.default_rng(d + bits)
    ds = d if bits == 8 else d // 2
    raw = rng.integers(0, 256, (2, sb, ds), dtype=np.uint8)
    raw[:, :5] = 0  # the most negative byte patterns: int8 0, nibble -8
    raw[:, 5:9] = 0xFF
    scales = rng.uniform(1e-3, 0.5, (2, sb)).astype(np.float32)
    kb, lo, hi = 256, 256 + 17, 256 + min(100, sb - 3)
    bad = (np.arange(sb) + kb < lo) | (np.arange(sb) + kb >= hi)
    raw[:, bad] = 127
    scales[:, bad] = np.where(np.arange(sb)[bad] % 2 == 0, np.nan, np.inf)
    out = convert_tile(raw, scales, kb, lo, hi, d, bits)
    for mat in range(2):
        got = unswizzle(out[mat], d)
        vals = stored_values(torch.from_numpy(raw[mat] if bits == 4 else raw[mat].view(np.int8))).numpy()
        want = to_bf16_bits(vals * scales[mat][:, None])
        want[bad] = 0
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("bits", [8, 4])
def test_converter_is_free_of_bank_conflicts(d, bits):
    """Each 16-byte store of a quarter warp falls in 8 distinct 16-byte bank
    groups of the (1024-byte aligned) stage, and each 8-byte raw load of a
    half warp in 16 distinct 8-byte ones: one wavefront a phase."""
    nt = converter(d)[0]
    ops = converter_ops(d, bits)
    assert len(ops) == geometry(d, bits)[3] * (2 if bits == 8 else 3)  # a load and one or two stores a step
    for kind, addr in ops:
        size = 16 if kind == "store" else 8
        lanes = 128 // size  # the lanes of one 128-byte phase: 8 for 16-byte accesses, 16 for 8-byte
        for p0 in range(0, nt, lanes):
            groups = set((addr[p0:p0 + lanes] // size) % (128 // size))
            assert len(groups) == lanes, (kind, d, bits, p0)


# ---------------------------------------------------------------------------
# The tile schedule
# ---------------------------------------------------------------------------


def c_div(a, b):
    """C's integer division (toward zero)."""
    return math.trunc(a / b)


def cta_tiles(blk, b_n, sq, h_n, hkv, skv, q_offset, kv_valid, kv_start, causal, window, bk=None, splits=1):
    """Mirror of `cta_tiles<BK, kSplit>` (flash_attention.cuh): CTA blk of a
    launch of `splits` CTAs a q-tile (the cluster of unit blk / splits; rank
    blk % splits takes its run of the q-tile's bk-key tiles)."""
    bk = bk or BK
    rank, blk = blk % splits, blk // splits
    n_qtiles = -(-sq // BQ)
    qt = n_qtiles - 1 - blk // (h_n * b_n)
    h, b = blk % h_n, (blk // h_n) % b_n
    q0 = qt * BQ
    kvv = min(kv_valid, skv)
    kvs = max(kv_start[b] if kv_start is not None else 0, 0)
    lo, hi = kvs, kvv
    if causal:
        hi = min(hi, q_offset + min(q0 + BQ, sq))
        if window:
            lo = max(lo, q_offset + q0 - window + 1)
    kb0 = lo // bk * bk
    ntiles = -(-(hi - kb0) // bk) if hi > lo else 0
    used = 1
    if splits > 1:
        used = min(splits, max(1, ntiles // MIN_RUN))
        first, last = rank * ntiles // used, (rank + 1) * ntiles // used
        assert (first, last - first if rank < used else 0) == (
            flash_split_runs(ntiles, splits)[rank] if rank < used else (first, 0))
        kb0, ntiles = kb0 + first * bk, (last - first if rank < used else 0)
    return dict(b=b, h=h, q0=q0, kv_start=kvs, kv_valid=kvv, lo=lo, hi=hi, kb0=kb0, ntiles=ntiles, rank=rank,
                used=used)


def warpgroup_rows(c, wg, sq, q_offset, causal, window, bk=None):
    """Mirror of `consume`'s set-up: the tiles [it_a, it_b) the warpgroup
    issues and, for each of its 64 rows (warp, g, and g + 8), [klo, khi)."""
    bk = bk or BK
    windowed = causal and bool(window)
    qa, qb = q_offset + c["q0"] + wg * 64, q_offset + min(c["q0"] + wg * 64 + 64, sq) - 1
    wlo = max(c["kv_start"], qa - window + 1) if windowed else c["kv_start"]
    whi = min(c["kv_valid"], qb + 1) if causal else c["kv_valid"]
    it_a = min(c["ntiles"], max(0, c_div(wlo - c["kb0"], bk)))
    it_b = max(it_a, min(c["ntiles"], c_div(whi - c["kb0"] + bk - 1, bk)))
    rows = {}
    for r in range(wg * 64, wg * 64 + 64):
        qpos = q_offset + c["q0"] + r
        klo = max(c["kv_start"], qpos - window + 1) if windowed else c["kv_start"]
        khi = min(c["kv_valid"], qpos + 1) if causal else c["kv_valid"]
        rows[r] = (klo, khi)
    return it_a, it_b, rows


def thread_keys(kb, klo0, khi0, klo1, khi1, t, bk=None):
    """`online_softmax`'s masks for thread t of a quad: the keys of its two
    rows that stay unmasked (fast path when every key of the tile is in both
    ranges)."""
    bk = bk or BK
    base = kb + 2 * t
    keys = [base + (i // 4) * 8 + (i & 1) for i in range(bk // 2)]
    fast = base >= klo0 and base >= klo1 and base + bk - 7 < khi0 and base + bk - 7 < khi1
    if fast:
        assert all(klo0 <= j < khi0 and klo1 <= j < khi1 for j in keys)
    row0 = [j for i, j in enumerate(keys) if not i & 2 and (fast or klo0 <= j < khi0)]
    row1 = [j for i, j in enumerate(keys) if i & 2 and (fast or klo1 <= j < khi1)]
    return row0, row1


SCHEDULE_CASES = {
    # (B, Sq, H, Hkv, Skv, q_offset, kv_valid, kv_start, causal, window)
    "causal": (1, 300, 2, 1, 300, 0, 300, None, True, None),
    "window": (1, 384, 2, 2, 640, 256, 640, None, True, 100),
    "kv_start": (3, 200, 4, 2, 256, 0, 200, [0, 17, 150], True, None),
    "q_offset_chunk": (2, 128, 2, 1, 1536, 1408, 1536, None, True, None),
    "non_causal": (2, 100, 2, 1, 640, 0, 333, [0, 40], False, None),
}


def check_schedule(case, bk=None, splits=1):
    """Every visible (row, key) pair of `case` is computed by exactly one
    thread of one CTA (one rank of its q-tile's cluster), and only keys the
    converters did not zero."""
    bk = bk or BK
    b_n, sq, h_n, hkv, skv, qoff, kvl, start, causal, window = SCHEDULE_CASES[case]
    n_qtiles = -(-sq // BQ)
    seen = np.zeros((b_n, h_n, sq, skv), np.int64)
    ctas = set()
    for blk in range(n_qtiles * h_n * b_n * splits):  # the heaviest q-tiles come first
        c = cta_tiles(blk, b_n, sq, h_n, hkv, skv, qoff, kvl, start, causal, window, bk, splits)
        ctas.add((c["b"], c["h"], c["q0"], c["rank"]))
        assert blk == 0 or c["q0"] <= prev_q0  # the heaviest q-tiles first
        prev_q0 = c["q0"]
        if c["rank"] >= c["used"]:
            assert c["ntiles"] == 0  # a rank without a run leaves at once
            continue
        for wg in range(2):
            it_a, it_b, rows = warpgroup_rows(c, wg, sq, qoff, causal, window, bk)
            assert 0 <= it_a <= it_b <= c["ntiles"]
            for it in range(it_a, it_b):
                kb = c["kb0"] + it * bk
                for r in range(wg * 64, wg * 64 + 64, 16):  # a warp: rows g and g + 8, g = 0..7
                    for g in range(8):
                        (klo0, khi0), (klo1, khi1) = rows[r + g], rows[r + g + 8]
                        for t in range(4):
                            row0, row1 = thread_keys(kb, klo0, khi0, klo1, khi1, t, bk)
                            for row, keys in ((r + g, row0), (r + g + 8, row1)):
                                s = c["q0"] + row
                                if s < sq and keys:
                                    assert c["lo"] <= min(keys) and max(keys) < c["hi"], "converted as zeros"
                                    seen[c["b"], c["h"], s, keys] += 1
    assert len(ctas) == n_qtiles * h_n * b_n * splits
    ok = flash_visible_keys(b_n, sq, skv, qoff, kvl, None if start is None else torch.tensor(start),
                            causal, window, "cpu").numpy()
    want = np.broadcast_to(ok[:, None], seen.shape).astype(np.int64)
    np.testing.assert_array_equal(seen, want)


@pytest.mark.parametrize("case", list(SCHEDULE_CASES))
def test_tile_schedule_covers_every_visible_pair_once(case):
    check_schedule(case)


@pytest.mark.parametrize("splits", [1, 3, 8])
@pytest.mark.parametrize("case", list(SCHEDULE_CASES))
def test_wide_split_schedule_covers_every_visible_pair_once(case, splits):
    """The head_dim 256 kernel: 64-key tiles, `splits` CTAs a q-tile, each
    rank over its run of `flash_split_runs` (the others leave)."""
    check_schedule(case, BK_WIDE, splits)


# ---------------------------------------------------------------------------
# The kernel's arithmetic in its order, and the plain version
# ---------------------------------------------------------------------------


def _quant_kv(seed, b, hkv, s, d, bits):
    rng = np.random.default_rng(seed)
    cls = jcache.QuantKVCache if bits == 8 else jcache.Quant4KVCache
    out = []
    for _ in range(2):
        q, sc = cls._quantize(jnp.asarray(rng.standard_normal((b, hkv, s, d)), jnp.float32))
        out += [np.asarray(q), np.asarray(sc)]
    return out  # k, ks, v, vs


def kernel_order(q, k, ks, v, vs, *, q_offset, kv_valid, kv_start, causal, window, bk=None, splits=1):
    """The kernel's arithmetic in its order (f32 torch): q pre-scaled in bf16;
    each CTA's key tiles dequantized as the converter does (zeros outside its
    [lo, hi)); per bk-key tile (128; 64 at head_dim 256) S = qt K^T, the
    online softmax in base 2 with scale 1 (masked keys exact zeros), P
    rounded to bf16 against the running max, O += P V; with `splits` CTAs a
    q-tile each rank's run so, the partials (m, l, O) merged in rank order in
    f32 (`merge_ranks`: O = sum_r O_r exp2(m_r - m) / l); rows with no key
    zeros."""
    bk = bk or BK
    b_n, sq, h_n, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    n_rep = h_n // hkv
    qt = (q.float() * quant_q_scale(d**-0.5)).to(torch.bfloat16).float()
    kd = (stored_values(k) * ks.float()[..., None]).to(torch.bfloat16).float()
    vd = (stored_values(v) * vs.float()[..., None]).to(torch.bfloat16).float()
    ok = flash_visible_keys(b_n, sq, skv, q_offset, kv_valid, kv_start, causal, window, "cpu")
    out = torch.zeros(b_n, sq, h_n, d)
    start = None if kv_start is None else kv_start.tolist()
    partials = {}
    for blk in range(-(-sq // BQ) * h_n * b_n * splits):
        c = cta_tiles(blk, b_n, sq, h_n, hkv, skv, q_offset, kv_valid, start, causal, window, bk, splits)
        if c["rank"] >= c["used"]:
            continue
        b, h, q0 = c["b"], c["h"], c["q0"]
        rows = slice(q0, min(q0 + BQ, sq))
        m = torch.full((rows.stop - rows.start, 1), -1e30)
        l = torch.zeros(rows.stop - rows.start, 1)
        o = torch.zeros(rows.stop - rows.start, d)
        for it in range(c["ntiles"]):
            keys = torch.arange(c["kb0"] + it * bk, c["kb0"] + (it + 1) * bk)
            inside = (keys >= c["lo"]) & (keys < c["hi"])
            kc = torch.where(inside[:, None], kd[b, h // n_rep, keys.clamp(max=skv - 1)], torch.zeros(1))
            vc = torch.where(inside[:, None], vd[b, h // n_rep, keys.clamp(max=skv - 1)], torch.zeros(1))
            s = qt[b, rows, h] @ kc.T
            vis = ok[b, rows][:, keys.clamp(max=skv - 1)] & (keys < skv)[None]
            s = s.masked_fill(~vis, -torch.inf)
            mn = torch.maximum(m, s.amax(-1, keepdim=True))
            a = torch.exp2(m - mn)
            p = torch.exp2(s - mn)
            l = l * a + p.sum(-1, keepdim=True)
            o = o * a + p.to(torch.bfloat16).float() @ vc
            m = mn
        partials.setdefault((b, h, q0), []).append((m, l, o))
    for (b, h, q0), parts in partials.items():  # ranks in rank order
        rows = slice(q0, min(q0 + BQ, sq))
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        l = sum(l_r * torch.exp2(m_r - mx) for m_r, l_r, _ in parts)
        inv = torch.where(l > 0, 1.0 / l.clamp_min(1e-30), torch.zeros(1))
        o = torch.zeros(rows.stop - rows.start, d)
        for m_r, _, o_r in parts:
            o = o + (torch.exp2(m_r - mx) * inv) * o_r
        out[b, rows, h] = o
    return out.to(torch.bfloat16)


# (B, Sq, H, Hkv, Skv, d, q_offset, kv_valid, kv_start, window)
ORDER_CASES = {
    "causal_3_tiles": (1, 384, 4, 2, 384, 128, 0, 300, None, None),
    "kv_start_window": (2, 128, 4, 2, 384, 64, 256, 384, [0, 300], 100),
}


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("case", list(ORDER_CASES))
def test_kernel_order_vs_plain_and_pallas(case, bits):
    b, sq, h, hkv, skv, d, qoff, kvl, start, window = ORDER_CASES[case]
    k, ks, v, vs = _quant_kv(11, b, hkv, skv, d, bits)
    q = np.random.default_rng(12).standard_normal((b, sq, h, d)).astype(np.float32)
    qt = torch.from_numpy(q).to(torch.bfloat16)
    st = None if start is None else torch.tensor(start, dtype=torch.int32)
    tk, tks, tv, tvs = (torch.from_numpy(x.copy()) for x in (k, ks, v, vs))
    kw = dict(q_offset=qoff, kv_valid=kvl, kv_start=st, causal=True, window=window)
    got = kernel_order(qt, tk, tks, tv, tvs, **kw).float()
    ref = flash_attention_quant_ref(qt, tk, tv, tks, tvs, q_offset=qoff, kv_valid_len=kvl, kv_start=st,
                                    window=window).float()
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=OUT_ULP, atol=BLOCKS_TOL)
    pallas = jfa.flash_attention_quant(jnp.asarray(qt.float().numpy(), jnp.bfloat16), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(ks), jnp.asarray(vs), q_offset=qoff,
                                       kv_valid_len=kvl, kv_start=None if st is None else jnp.asarray(start),
                                       window=window, block_k=BK, interpret=True)
    lo = np.zeros(b, np.int64) if start is None else np.asarray(start)
    valid = (qoff + np.arange(sq))[None, :] >= lo[:, None]  # rows that see a key
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(pallas.astype(jnp.float32))[valid],
                               rtol=OUT_ULP, atol=BLOCKS_TOL)


# head_dim 256 (Gemma-2B's 8 / 1 heads cut to 2 / 1): one 128-row q-tile at
# q_offset 256 over 384 keys (six 64-key tiles: up to three ranks of two)
WIDE_ORDER_CASE = dict(b=1, sq=128, h=2, hkv=1, skv=384, d=256, q_offset=256, kv_valid=384)


@functools.cache
def _wide_order_inputs(bits):
    c = WIDE_ORDER_CASE
    k, ks, v, vs = _quant_kv(13, c["b"], c["hkv"], c["skv"], c["d"], bits)
    q = np.random.default_rng(14).standard_normal((c["b"], c["sq"], c["h"], c["d"])).astype(np.float32)
    return torch.from_numpy(q).to(torch.bfloat16), (k, ks, v, vs)


@pytest.mark.parametrize("splits", [1, 2, 3, MAX_SPLITS])
@pytest.mark.parametrize("bits", [8, 4])
def test_wide_split_merge_vs_plain_and_pallas(bits, splits):
    """The head_dim 256 kernel with `splits` CTAs a q-tile: each rank's run
    of 64-key tiles in the kernel's order, the partials merged in rank order
    in f32, against flash_attention_quant_ref; and against the Pallas kernel
    in interpret mode once (int8, three ranks)."""
    c = WIDE_ORDER_CASE
    qt, (k, ks, v, vs) = _wide_order_inputs(bits)
    tk, tks, tv, tvs = (torch.from_numpy(x.copy()) for x in (k, ks, v, vs))
    kw = dict(q_offset=c["q_offset"], kv_valid=c["kv_valid"], kv_start=None, causal=True, window=None)
    got = kernel_order(qt, tk, tks, tv, tvs, **kw, bk=BK_WIDE, splits=splits).float()
    ref = flash_attention_quant_ref(qt, tk, tv, tks, tvs, q_offset=c["q_offset"], kv_valid_len=c["kv_valid"]).float()
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=OUT_ULP, atol=BLOCKS_TOL)
    if (bits, splits) == (8, 3):
        pallas = jfa.flash_attention_quant(jnp.asarray(qt.float().numpy(), jnp.bfloat16), jnp.asarray(k),
                                           jnp.asarray(v), jnp.asarray(ks), jnp.asarray(vs), q_offset=c["q_offset"],
                                           kv_valid_len=c["kv_valid"], block_k=128, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas.astype(jnp.float32)), rtol=OUT_ULP,
                                   atol=BLOCKS_TOL)


@pytest.mark.parametrize("d", [64, 128])
def test_folded_q_rounding(d):
    """bf16(f32(q) * quant_q_scale(scale)), the kernel's pre-scale of q in
    shared memory, equals the wrapper's former pass q * torch.tensor(c, bf16)
    and the JAX wrapper's q * jnp.asarray(c, q.dtype), bit for bit."""
    rng = np.random.default_rng(d)
    x = np.concatenate([rng.standard_normal(50000) * 10.0 ** rng.integers(-6, 4, 50000),
                        [0.0, -0.0, 1.0, -1.0, 3e38, -3e38, 1e-30, 65504.0]]).astype(np.float32)
    # (no subnormal products: the CPU's bf16 product flushes them, the card's keeps them)
    q = torch.from_numpy(x).to(torch.bfloat16)
    c = d**-0.5 * LOG2E
    kernel = (q.float() * np.float32(quant_q_scale(d**-0.5))).to(torch.bfloat16)
    torch_pass = q * torch.tensor(c, dtype=q.dtype)
    jax_pass = jnp.asarray(q.float().numpy(), jnp.bfloat16) * jnp.asarray(c, jnp.bfloat16)
    np.testing.assert_array_equal(kernel.view(torch.int16).numpy(), torch_pass.view(torch.int16).numpy())
    np.testing.assert_array_equal(kernel.view(torch.int16).numpy(),
                                  np.asarray(jax_pass).view(np.int16))


# ---------------------------------------------------------------------------
# Budgets read from the sources
# ---------------------------------------------------------------------------


def quant_smem(d, bits, raw, rows=None, matrices=1):
    """`Geo<D, kInt4>::bytes(raw)`: alignment slack, Q and the bf16 ring, raw
    stages of `rows` keys of one matrix (`matrices` = 2: of K and V together)
    with their scales, the mbarriers (Q, full and empty of K and of V a bf16
    stage, one a raw stage)."""
    ds, rows = (d if bits == 8 else d // 2), rows or RAW_ROWS
    stage = matrices * (rows * ds + rows * 4)
    return 1024 + (BQ + 2 * STAGES * BK) * d * 2 + raw * stage + 8 * (1 + 4 * STAGES + RAW_STAGES)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("bits", [8, 4])
def test_shared_memory_plan_fits(d, bits):
    """Every instance fits the 232,448 bytes a block may have with the raw
    stages `Geo::kRaw` gives it (the most, up to kRawStages, that fit), and
    holds at least three raw stages of a tile's K or V (a tile and a half) in
    flight. Raw stages of K and V together would leave int8 at D = 128 one
    tile in flight: two pass the limit."""
    raw = max(n for n in range(1, RAW_STAGES + 1) if quant_smem(d, bits, n) <= SMEM_LIMIT)
    assert quant_smem(d, bits, raw) <= SMEM_LIMIT
    assert raw * RAW_ROWS >= 3 * BK
    if (d, bits) == (128, 8):
        assert quant_smem(d, bits, 1, rows=BK, matrices=2) <= SMEM_LIMIT < quant_smem(d, bits, 2, rows=BK, matrices=2)
    bf16_smem = (BQ + 2 * STAGES * BK) * d * 2 + 1024 + 8 * (1 + 2 * STAGES)  # flash_attention.cu
    assert bf16_smem <= SMEM_LIMIT


def wide_smem(d, bits, raw):
    """`WideGeo<D, kInt4>::bytes(raw)`: alignment slack, Q, one bf16 stage of
    K and of V (64-key tiles), `raw` raw stages of one tile's K or V with its
    scales, the mbarriers (Q, one a raw stage)."""
    ds = d if bits == 8 else d // 2
    return 1024 + (BQ + 2 * BK_WIDE) * d * 2 + raw * (BK_WIDE * ds + BK_WIDE * 4) + 8 * (1 + raw)


@pytest.mark.parametrize("bits", [8, 4])
def test_wide_shared_memory_plan_fits(bits):
    """head_dim 256: the raw stages `WideGeo::kRaw` gives (the most, up to
    kWideRawStages, that fit: six at int8, eight at int4) hold three tiles
    ahead or more, and a split q-tile's partials (`SplitSmem`: O of 128 rows
    padded to 264 columns, m, l and the merge factors of 8 ranks) fit where Q,
    the bf16 stages and the raw stages lay, below the mbarriers."""
    d = 256
    raw = max(n for n in range(1, WIDE_RAW_STAGES + 1) if wide_smem(d, bits, n) <= SMEM_LIMIT)
    assert raw == (6 if bits == 8 else 8) and raw >= 2
    ds = d if bits == 8 else d // 2
    split_smem = BQ * (d + 8) * 4 + 2 * BQ * 4 + MAX_SPLITS * BQ * 4
    assert split_smem <= (BQ + 2 * BK_WIDE) * d * 2 + raw * (BK_WIDE * ds + BK_WIDE * 4)


def test_quant_split_constants_are_the_kernels(monkeypatch):
    """The split's host rule uses the kernel's constants; the quantized
    kernel at 256 takes the header's split (`cta_tiles<kBKWide, kSplit>`,
    clusters up to kMaxSplits) and an unsplit instantiation; the launch rule
    is `flash_splits` over this kernel's own resident clusters at 256 and 1
    elsewhere."""
    from mllm_tpu_torch.ops import flash_attention as fa

    assert (fa.FLASH_TILE_WIDE, fa.FLASH_MIN_RUN, fa.FLASH_MAX_SPLITS, fa.FLASH_BQ) == (BK_WIDE, MIN_RUN, MAX_SPLITS,
                                                                                       BQ)
    with open(os.path.join(csrc_dir(), "flash_attention_quant.cu")) as f:
        src = f.read()
    assert "cta_tiles<kBKWide, kSplit>(p)" in src
    assert "flash_quant_wide_kernel<D, kInt4, true>" in src and "flash_quant_wide_kernel<D, kInt4, false>" in src
    assert "splits > kMaxSplits || (D != 256 && splits != 1)" in src
    slots = (132, 66, 39, 30, 22, 17, 15, 15)  # an H100's resident clusters of the 256 kernels
    asked = []
    monkeypatch.setattr(fa, "flash_quant_cluster_slots", lambda idx, bits: asked.append(bits) or slots)
    for d in (64, 128):
        assert fa.flash_quant_launch_splits(1, 1536, 1536, 12, d, 8, True, None, 0, 0, 1536) == 1
    assert fa.flash_quant_launch_splits(1, 1536, 1536, 8, 256, 8, True, None, 0, 0, 1536) == \
        fa.flash_splits(1, 1536, 1536, 8, True, None, slots, 0, 1536) == 2  # Gemma-2B's 1536-token prefill
    assert fa.flash_quant_launch_splits(1, 512, 2048, 8, 256, 4, True, None, 0, None, 1536) > 1  # a device q_offset
    assert asked == [8, 4]


def test_register_split_fits_the_launch_allocation():
    """setmaxnreg moves registers inside the CTA's own pool, which holds the
    168 registers a thread that 384 threads get at launch: the producer's
    decrease must cover both consumer warpgroups' increase, or they wait
    forever."""
    threads = 3 * 128
    launch = 65536 // threads // 8 * 8
    producer = source_int("kProducerRegs", "flash_attention_quant.cu")
    consumer = source_int("kConsumerRegs", "flash_attention_quant.cu")
    assert launch == 168
    assert producer % 8 == 0 and consumer % 8 == 0 and 24 <= producer <= launch <= consumer <= 256
    assert 128 * producer + 256 * consumer <= threads * launch


# ---------------------------------------------------------------------------
# The plain version against the Pallas kernel: the combinations
# tests/test_torch_kvcache.py lacks
# ---------------------------------------------------------------------------

# name: (b, sq, skv, q_offset, kv_valid, kv_start, window, block_k, d)
REF_CASES = {
    "window_kv_start": (2, 128, 256, 128, 256, [0, 150], 64, 128, 128),
    "d64_chunk_one_block": (1, 128, 256, 128, 256, None, None, 256, 64),
    "d64_window_kv_start": (2, 128, 256, 128, 240, [0, 30], 100, 128, 64),
}


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("case", list(REF_CASES))
def test_flash_quant_ref_vs_pallas_interpret(case, bits):
    b, sq, skv, qoff, kvl, start, window, bk, d = REF_CASES[case]
    h, hkv = 4, 2
    k, ks, v, vs = _quant_kv(4, b, hkv, skv, d, bits)
    q = np.random.default_rng(5).standard_normal((b, sq, h, d)).astype(np.float32)
    st = None if start is None else np.asarray(start, np.int32)
    ref = jfa.flash_attention_quant(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ks),
                                    jnp.asarray(vs), q_offset=qoff, kv_valid_len=kvl,
                                    kv_start=None if st is None else jnp.asarray(st), window=window,
                                    block_k=bk, interpret=True)
    t = lambda x: torch.from_numpy(np.asarray(x))  # noqa: E731
    out = flash_attention_quant_ref(t(q), t(k), t(v), t(ks), t(vs), q_offset=qoff, kv_valid_len=kvl,
                                    kv_start=None if st is None else t(st), window=window)
    lo = np.zeros(b, np.int64) if st is None else st
    valid = (qoff + np.arange(sq))[None, :] >= lo[:, None]  # rows that see a key
    tol = ONE_BLOCK_TOL if bk >= skv else BLOCKS_TOL
    np.testing.assert_allclose(out.numpy()[valid], np.asarray(ref)[valid], rtol=tol, atol=tol)


def test_probes_apply_to_the_sources(tmp_path):
    """Every probe of tools/flash_quant_probes.py finds each pattern it
    replaces exactly once in the current sources (a probe never times a
    stale copy)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools", "flash_quant_probes.py")
    spec = importlib.util.spec_from_file_location("flash_quant_probes", path)
    probes = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probes)
    for name in probes.PROBES:
        out = probes.make_probe(name, str(tmp_path))
        for file, _, new in probes.PROBES[name]:
            with open(os.path.join(out, file)) as f:
                assert new in f.read()
