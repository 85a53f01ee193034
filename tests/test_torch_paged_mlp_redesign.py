"""The paged decode attention and the fused int4 MLP of the port, checked on
the CPU in the order their Hopper kernels work.

`csrc/decode_attention_paged.cu` (the body of `csrc/decode_attention.cuh`)
and `csrc/fused_int4_mlp.cu` run only on the card. Here:
  - the paged kernel's order of work (the slot's table row staged and
    clipped, 64-key tiles inside 128-row pool blocks, the cluster ranks' tiles
    from `decode_split_ranges`, each warp's 16 keys of a tile with its own
    online softmax in base 2, the warps merged in warp order and the ranks in
    rank order) is emulated in f32 torch and held to
    `decode_attention_paged_ref` and to the JAX Pallas kernel in interpret
    mode, on seeded numpy inputs (f32: 1e-4, the two sum in other orders);
  - the fused MLP's order (the int4 stream's 32-row stages, each stage's
    product scaled once; gate and up split along K, each split's partial
    added in split order; h rounded to bf16; down split into chunks added in
    chunk order) is emulated on the plan's items and held to the same
    function with h rounded to bf16 (1e-3: f32 sums in another order), to
    `fused_int4_mlp_ref` (1e-2, the smoke's tolerance: the plain version keeps
    h in f32) and to the Pallas kernel in interpret mode (2e-2: it also rounds
    x's group sums to bf16);
  - the fused plan at the widths of five models: every (tile, packed row) of
    both products is covered once, every block takes its gate/up items before
    its down item, each down tile's chunks lie on blocks of their own, and on
    a resident grid every wait of the kernel is reached (a simulation of its
    counters), so the plan cannot deadlock.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_tpu.ops import decode_attention as jda
from mllm_tpu.ops import fused_mlp as jfm
from mllm_tpu.ops import quant_matmul as jqm
from mllm_tpu_torch.ops import fused_mlp as tfm
from mllm_tpu_torch.ops.decode_attention import (DECODE_TILE, PAGE, decode_attention_paged_ref, decode_split_ranges,
                                                 decode_splits)
from mllm_tpu_torch.ops.quant_matmul import STAGE_ROWS, TILE_N, pow2_rows

LOG2E = 1.4426950408889634
NEG_BIG = -1e30  # the kernel's empty-partial m
SMS = 132  # the H100's SMs, which the plans are made for
WARPS = DECODE_TILE // 16

# ---------------------------------------------------------------------------
# The paged decode kernel's order
# ---------------------------------------------------------------------------

H, HKV, D, MAXB = 12, 2, 64, 4  # n_rep 6, as the Qwen2-VL-2B geometry; 512 keys a slot
PAGED_TOL = 1e-4
# name: (kv_valid per slot, retired slot or None, window or None)
PAGED_CASES = {
    "retired_slot": ([300, 130, 512], 1, None),
    "window": ([300, 64, 512], None, 100),
    "one_tile_and_empty": ([40, 0, 512], None, None),
    "window_inside_a_block": ([200, 511, 129], None, 50),
}


def _paged_inputs(seed, kv_valid, retired):
    """f32 q [B, 1, H, D] and a pool [NB, HKV, 128, D] of K and V whose blocks
    the table [B, MAXB] deals to the slots in a shuffled order, plus two spare
    blocks; a retired slot's row is -1."""
    rng = np.random.default_rng(seed)
    b = len(kv_valid)
    need = [-(-n // PAGE) for n in kv_valid]
    nb = sum(need) + 2
    perm = rng.permutation(nb)
    table = np.full((b, MAXB), -1, np.int32)
    for i, n in enumerate(need):
        table[i, :n] = perm[sum(need[:i]):sum(need[:i + 1])]
    if retired is not None:
        table[retired] = -1
    pool_k, pool_v = (rng.standard_normal((nb, HKV, PAGE, D), dtype=np.float32) for _ in range(2))
    return rng.standard_normal((b, 1, H, D), dtype=np.float32), pool_k, pool_v, table


def _merge(parts):
    """(m, l, acc) partials merged in order, base 2."""
    mx = torch.stack([m for m, _, _ in parts]).max(dim=0).values
    l, acc = torch.zeros_like(parts[0][1]), torch.zeros_like(parts[0][2])
    for m, l_p, a_p in parts:
        e = torch.exp2(m - mx)
        l = l + l_p * e
        acc = acc + a_p * e[:, None]
    return mx, l, acc


def kernel_order_paged(q, k_pool, v_pool, table, kv_valid, window, splits):
    """csrc/decode_attention.cuh with the paged row rule, in f32 torch: the
    slot's table row clipped to [0, NB - 1] (a -1 row reads block 0), key j
    at row j % 128 of block tbl[j // 128]; per rank its 64-key tiles, per warp
    16 keys of each tile with an online softmax in base 2 (probabilities in
    V's dtype); warps merged in order, ranks merged in order."""
    b, _, h, d = q.shape
    nb, hkv = k_pool.shape[:2]
    n_rep, s_max = h // hkv, table.shape[1] * PAGE
    scale_log2 = d**-0.5 * LOG2E
    out = torch.zeros(b, 1, h, d)
    for i in range(b):
        tbl = table[i].clamp(0, nb - 1)  # the staged row
        hi = min(int(kv_valid[i]), s_max)
        lo = max(int(kv_valid[i]) - window, 0) if window else 0
        for hk in range(hkv):
            qg = q[i, 0, hk * n_rep:(hk + 1) * n_rep]
            ranks = []
            for start, stop in decode_split_ranges(lo, hi, splits):
                warps = [(torch.full((n_rep,), NEG_BIG), torch.zeros(n_rep), torch.zeros(n_rep, d))
                         for _ in range(WARPS)]
                for tile0 in range(start // DECODE_TILE * DECODE_TILE, stop if stop > start else start, DECODE_TILE):
                    assert tile0 // PAGE == (tile0 + DECODE_TILE - 1) // PAGE  # inside one pool block
                    for w in range(WARPS):
                        j = torch.arange(tile0 + 16 * w, tile0 + 16 * w + 16)
                        ok = (j >= lo) & (j < hi)
                        jj = torch.where(ok, j, torch.zeros_like(j))
                        blk, row = tbl[jj // PAGE].long(), jj % PAGE
                        kr = torch.where(ok[:, None], k_pool[blk, hk, row], 0.0)  # unseen rows: zeros
                        vr = torch.where(ok[:, None], v_pool[blk, hk, row], 0.0)
                        s = torch.where(ok, qg @ kr.T * scale_log2, -torch.inf)
                        m, l, acc = warps[w]
                        mn = torch.maximum(m, s.max(dim=1).values)
                        a = torch.exp2(m - mn)
                        p = torch.exp2(s - mn[:, None])
                        warps[w] = (mn, l * a + p.sum(dim=1), acc * a[:, None] + p.to(v_pool.dtype).float() @ vr)
                ranks.append(_merge(warps))
            m, l, acc = _merge(ranks)
            safe = torch.where(l > 0, l, torch.ones_like(l))
            out[i, 0, hk * n_rep:(hk + 1) * n_rep] = torch.where(l[:, None] > 0, acc / safe[:, None], 0.0)
    return out


@pytest.mark.parametrize("name", list(PAGED_CASES))
def test_paged_kernel_order(name):
    kv_valid, retired, window = PAGED_CASES[name]
    q, pk, pv, table = _paged_inputs(5, kv_valid, retired)
    b = len(kv_valid)
    splits = decode_splits(b, HKV, H // HKV, MAXB * PAGE, SMS)
    tq, tk, tv, tt = (torch.from_numpy(a) for a in (q, pk, pv, table))
    valid = torch.tensor(kv_valid, dtype=torch.int32)
    out = kernel_order_paged(tq, tk, tv, tt, kv_valid, window, splits)
    ref = decode_attention_paged_ref(tq, tk, tv, tt, kv_valid_len=valid, window=window)
    torch.testing.assert_close(out, ref, rtol=PAGED_TOL, atol=PAGED_TOL)
    jout = jda.decode_attention_paged(jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(table),
                                      kv_valid_len=jnp.asarray(kv_valid, jnp.int32), window=window, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=PAGED_TOL, atol=PAGED_TOL)


def test_paged_cases_reach_each_path():
    """The cases reach what they are named for: a retired slot, a window, a
    slot with no key, a slot of one tile (one rank writes it alone), ranks
    with no tile, and every rank of the cluster with tiles."""
    splits = decode_splits(3, HKV, H // HKV, MAXB * PAGE, SMS)
    assert splits == 8
    ranks_used, tiles = set(), set()
    for kv_valid, _, window in PAGED_CASES.values():
        for n in kv_valid:
            lo, hi = (max(n - window, 0) if window else 0), min(n, MAXB * PAGE)
            ranges = decode_split_ranges(lo, hi, splits)
            ranks_used.add(sum(e > a for a, e in ranges))
            tiles.add(-(-(hi - lo // DECODE_TILE * DECODE_TILE) // DECODE_TILE) if hi > lo else 0)
    assert {0, 1, splits} <= ranks_used and 1 in tiles
    assert PAGED_CASES["retired_slot"][1] is not None and PAGED_CASES["window"][2]


# ---------------------------------------------------------------------------
# The fused MLP kernel's order
# ---------------------------------------------------------------------------

MLP_EMUL_TOL, MLP_REF_TOL, MLP_PALLAS_TOL = 1e-3, 1e-2, 2e-2  # relative to max |y|


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def to_bf16(x):
    return torch.as_tensor(np.asarray(x, np.float32)).to(torch.bfloat16).float()


@functools.cache
def _mlp_ops(d, ff, affine, seed=3):
    """(gate, up, down) numpy operand triples (canonical / block-planar; the
    affine ones raw nibbles, scales and zeros) and block_f, as
    tests/test_torch_fused_mlp.py makes them."""
    rng = np.random.default_rng(seed)
    bf = tfm.pick_block_f(ff)
    w = [rng.standard_normal(s).astype(np.float32) * 0.05 for s in ((ff, d), (ff, d), (d, ff))]
    gate, up = (jqm.prepare_int4(*jqm.repack_float_to_int4(x, 32), 32) for x in w[:2])
    down = jfm.prepare_int4_ff(*jqm.repack_float_to_int4(w[2], 32), None, bf)
    if not affine:
        return tuple((p, s, None) for p, s, _ in (gate, up, down)), bf

    def randomize(p, s, rows):
        live = s != 0
        p = (rng.integers(0, 256, p.shape) * (np.arange(p.shape[0])[:, None] < rows)).astype(np.uint8)
        s = (rng.uniform(0.002, 0.01, s.shape) * live).astype(np.float32)
        z = (rng.standard_normal(s.shape) * 0.02 * live).astype(np.float32)
        return p, s, z

    return (randomize(*gate[:2], d // 2), randomize(*up[:2], d // 2), randomize(*down[:2], ff // 2)), bf


def fused_mlp_items(d, ff, d_out, grid, plan):
    """Each block's work in the order csrc/fused_int4_mlp.cu takes it, for a
    plan (mt8, splits_a, rows_a, splits_b, rows_b) on `grid` blocks: block b's
    A items ("a", gate/up tile, matrix 0 gate / 1 up, split, first packed
    row, end) are b, b + grid, ... of the tile-major list (a tile's gate
    splits, then its up splits), then its B item ("b", down tile, chunk, first
    packed row, end): item grid - 1 - b of the chunks, tile-fastest."""
    _, sa, rows_a, sb, rows_b = plan
    ta, tb = -(-ff // TILE_N), -(-d_out // TILE_N)
    a_items = []
    for i in range(2 * ta * sa):
        split = i % sa
        j0 = split * rows_a
        a_items.append(("a", i // (2 * sa), (i // sa) % 2, split, j0, min(j0 + rows_a, d // 2)))
    blocks = [a_items[b::grid] for b in range(grid)]
    for jb in range(tb * sb):
        chunk = jb // tb
        blocks[grid - 1 - jb].append(("b", jb % tb, chunk, chunk * rows_b, min(chunk * rows_b + rows_b, ff // 2)))
    return blocks



def stage_product(xs_lo, xs_hi, packed, s_lo, s_hi, z_lo, z_hi, acc):
    """One 32-row stage of the int4 stream (int4_stream.cuh consume_stage):
    per half, the exact products of x and the integers summed in f32, scaled
    once (plus z times the stage's sum of x for the affine law). xs_*: [M, 32]
    x of the low / high half's k; packed [32, n] bytes; s_*, z_* [n]."""
    q = torch.from_numpy(packed.astype(np.int32))
    for xh, nib, s, z in ((xs_lo, q & 15, s_lo, z_lo), (xs_hi, q >> 4, s_hi, z_hi)):
        vals = nib.float() if z is not None else nib.float() - 8.0
        acc = acc + (xh @ vals) * s
        if z is not None:
            acc = acc + xh.sum(dim=1, keepdim=True) * z
    return acc


def kernel_order_mlp(x, ops, act, block_f, plan, grid):
    """csrc/fused_int4_mlp.cu on the plan's items (`fused_mlp_items`), in f32
    torch: each A item's partial over its stages; a gate/up tile's g and u
    summed over its splits in split order, h = bf16(act(g) * u); each B
    item's partial over its stages (x = h of the stage's low units and of the
    units half a slab on); the down tile's chunks added in chunk order."""
    (gp, gs, gz), (upk, us, uz), (dp, ds, dz) = ops
    m, d = x.shape
    ff, d_out = gp.shape[1], dp.shape[1]
    khp, ngh, fh = gp.shape[0], gp.shape[0] // 32, block_f // 2
    _, sa, _, sb, _ = plan
    ta, tb = -(-ff // TILE_N), -(-d_out // TILE_N)
    part_a = torch.zeros(2, sa, m, ta * TILE_N)
    part_b = torch.zeros(sb, m, tb * TILE_N)
    items = [it for blk in fused_mlp_items(d, ff, d_out, grid, plan) for it in blk]
    t = lambda a: None if a is None else torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    for kind, tile, mat, split, j0, j1 in (it for it in items if it[0] == "a"):
        q, s, z = (gp, gs, gz) if mat == 0 else (upk, us, uz)
        cols = slice(tile * TILE_N, min(ff, tile * TILE_N + TILE_N))
        acc = torch.zeros(m, cols.stop - cols.start)
        for r in range(j0, j1, STAGE_ROWS):
            g = r // 32
            acc = stage_product(x[:, r:r + 32], x[:, d // 2 + r:d // 2 + r + 32], q[r:r + 32, cols],
                                t(s[g, cols]), t(s[ngh + g, cols]), t(None if z is None else z[g, cols]),
                                t(None if z is None else z[ngh + g, cols]), acc)
        part_a[mat, split, :, cols] = acc
    gsum, usum = torch.zeros(m, ta * TILE_N), torch.zeros(m, ta * TILE_N)
    for s_ in range(sa):  # split order
        gsum, usum = gsum + part_a[0, s_], usum + part_a[1, s_]
    h = to_bf16(tfm._ACT[act](gsum[:, :ff]) * usum[:, :ff])
    for kind, tile, chunk, j0, j1 in (it for it in items if it[0] == "b"):
        cols = slice(tile * TILE_N, min(d_out, tile * TILE_N + TILE_N))
        acc = torch.zeros(m, cols.stop - cols.start)
        for r in range(j0, j1, STAGE_ROWS):
            f_lo = (r // fh) * block_f + r % fh
            acc = stage_product(h[:, f_lo:f_lo + 32], h[:, f_lo + fh:f_lo + fh + 32], dp[r:r + 32, cols],
                                t(ds[f_lo // 32, cols]), t(ds[(f_lo + fh) // 32, cols]),
                                t(None if dz is None else dz[f_lo // 32, cols]),
                                t(None if dz is None else dz[(f_lo + fh) // 32, cols]), acc)
        part_b[chunk, :, cols] = acc
    y = torch.zeros(m, tb * TILE_N)
    for c in range(sb):  # chunk order
        y = y + part_b[c]
    return y[:, :d_out]


def rounded_h_mlp(x, ops, act, block_f):
    """The same function in plain f32 with h rounded to bf16."""
    tops = [tuple(None if a is None else torch.from_numpy(a) for a in op) for op in ops]
    d = x.shape[1]
    w_g = tfm.dequant_int4_canonical(*tops[0], 32, d)
    w_u = tfm.dequant_int4_canonical(*tops[1], 32, d)
    h = to_bf16(tfm._ACT[act](x @ w_g) * (x @ w_u))
    return h @ tfm.dequant_down_blockplanar(*tops[2], 32, block_f)


# (d, ff, m, act, affine, plan or None for the card's): d 64, ff 256 as in
# tests/test_torch_fused_mlp.py, with the plan for a full card and with down
# in four chunks; d 128, ff 512 with gate/up split in two and chunks of one
# stage, which cross a slab's halves
MLP_CASES = [(64, 256, 8, "silu", False, None), (64, 256, 3, "gelu_new", True, None),
             (64, 256, 32, "silu", False, (4, 1, 32, 4, 32)), (128, 512, 5, "silu", True, (1, 2, 32, 8, 32)),
             (128, 512, 1, "gelu_new", False, (1, 2, 32, 2, 128))]


@pytest.mark.parametrize("d,ff,m,act,affine,plan", MLP_CASES)
def test_fused_mlp_kernel_order(d, ff, m, act, affine, plan):
    ops, bf = _mlp_ops(d, ff, affine)
    grid = SMS * tfm.mlp_blocks_per_sm(pow2_rows(-(-m // 8), 4))
    if plan is None:
        plan = tfm.fused_mlp_plan(m, d, ff, d, bf, grid, affine)
    x = to_bf16(np.random.default_rng(m + d).standard_normal((m, d)))
    out = kernel_order_mlp(x, ops, act, bf, plan, grid)
    assert _rel(out, rounded_h_mlp(x, ops, act, bf)) <= MLP_EMUL_TOL
    tops = [tuple(None if a is None else torch.from_numpy(a) for a in op) for op in ops]
    assert _rel(out, tfm.fused_int4_mlp_ref(x, *tops, act=act, block_f=bf)) <= MLP_REF_TOL
    jops = [tuple(None if a is None else jnp.asarray(a) for a in op) for op in ops]
    kern = jfm.fused_int4_mlp(jnp.asarray(x.numpy(), jnp.bfloat16), *jops, act=act, block_f=bf, interpret=True)
    assert _rel(out, np.asarray(kern)) <= MLP_PALLAS_TOL


# ---------------------------------------------------------------------------
# The fused plan
# ---------------------------------------------------------------------------

MODELS = {"qwen2-vl-2b": (1536, 8960), "tinyllama": (2048, 5632), "qwen2-0.5b": (896, 4864),
          "llama-7b": (4096, 11008), "qwen2-7b": (3584, 18944)}


def chunk_tiles(j0, j1, block_f):
    """The gate/up tiles holding the hidden units of down's packed rows
    [j0, j1): per slab the rows touch, the low units and those half a slab on
    (the tiles a down chunk waits for)."""
    fh, tiles, j = block_f // 2, set(), j0
    while j < j1:
        slab, r0 = j // fh, j % fh
        rows = min(j1 - j, fh - r0)
        for half in range(2):
            f0 = slab * block_f + half * fh + r0
            tiles.update(range(f0 // TILE_N, (f0 + rows - 1) // TILE_N + 1))
        j += rows
    return tiles


def kernel_steps(blocks, block_f):
    """Each block's steps in the kernel's order: after its last A item, its
    arrivals at the tiles of its A items; its down chunk waits until every
    item of the tiles holding its hidden units has arrived, then arrives at
    its down tile and waits for the tile's chunks."""
    steps = []
    for items in blocks:
        seq = [("arrive_a", it[1]) for it in items if it[0] == "a"]
        for it in items:
            if it[0] == "b":
                seq += [("tiles", chunk_tiles(it[3], it[4], block_f)), ("arrive_b", it[1]), ("wait_b", it[1])]
        steps.append(seq)
    return steps


def steps_left(steps, sa, sb, ta, tb):
    """Every block runs at once (a resident grid) and takes its steps while
    it can: the steps left when no block can move (none: every wait is
    reached, so the plan cannot deadlock)."""
    arrived_a, arrived_b = [0] * ta, [0] * tb
    pc = [0] * len(steps)
    moved = True
    while moved:
        moved = False
        for bi, seq in enumerate(steps):
            while pc[bi] < len(seq):
                op, arg = seq[pc[bi]]
                if op == "arrive_a":
                    arrived_a[arg] += 1
                elif op == "tiles":
                    if any(arrived_a[t] < 2 * sa for t in arg):
                        break
                elif op == "arrive_b":
                    arrived_b[arg] += 1
                elif arrived_b[arg] < sb:
                    break
                pc[bi] += 1
                moved = True
    return sum(len(seq) - p for seq, p in zip(steps, pc))


@pytest.mark.parametrize("m", [1, 8, 32])
@pytest.mark.parametrize("model", list(MODELS))
def test_fused_plan_covers_once_and_cannot_deadlock(model, m):
    d, ff = MODELS[model]
    bf = tfm.pick_block_f(ff)
    for affine in (False, True):
        mt8 = pow2_rows(-(-m // 8), 4)
        grid = SMS * tfm.mlp_blocks_per_sm(mt8)
        plan = tfm.fused_mlp_plan(m, d, ff, d, bf, grid, affine)
        pmt8, sa, rows_a, sb, rows_b = plan
        assert pmt8 == mt8 and m <= 8 * mt8 and rows_a % STAGE_ROWS == 0 and rows_b % STAGE_ROWS == 0
        ta, tb = -(-ff // TILE_N), -(-d // TILE_N)
        assert tb * sb <= grid  # each down chunk on a block of its own
        blocks = fused_mlp_items(d, ff, d, grid, plan)
        assert len(blocks) == grid
        seen_a = np.zeros((2, ta, d // 2 // STAGE_ROWS), np.int32)
        seen_b = np.zeros((tb, ff // 2 // STAGE_ROWS), np.int32)
        for items in blocks:
            kinds = [it[0] for it in items]
            assert kinds == sorted(kinds) and kinds.count("b") <= 1  # gate/up items first, one down chunk
            for it in items:
                j0, j1 = it[-2:]
                assert j1 > j0 and j0 % STAGE_ROWS == 0 and j1 % STAGE_ROWS == 0
                if it[0] == "a":
                    seen_a[it[2], it[1], j0 // STAGE_ROWS:j1 // STAGE_ROWS] += 1
                else:
                    seen_b[it[1], j0 // STAGE_ROWS:j1 // STAGE_ROWS] += 1
        assert (seen_a == 1).all() and (seen_b == 1).all()
        assert steps_left(kernel_steps(blocks, bf), sa, sb, ta, tb) == 0
        # the x (or h) a block stages beside its ring fits the card's shared memory
        smem = tfm.MLP_STAGES * tfm.mlp_stage_bytes(affine) + 32 * mt8 * tfm.mlp_chunk_rows(mt8, affine)
        assert smem <= tfm.SMEM_PER_SM // tfm.mlp_blocks_per_sm(mt8) - 1024


def test_simulation_finds_a_deadlock():
    """The simulation is not vacuous: a block that owned both chunks of a
    down tile would wait at the tile for its own second chunk."""
    d, ff, bf = 64, 256, 256
    blocks = fused_mlp_items(d, ff, d, 4, (1, 1, 32, 2, 64))
    assert steps_left(kernel_steps(blocks, bf), 1, 2, 1, 1) == 0
    b_items = [it for items in blocks for it in items if it[0] == "b"]
    blocks = [[it for it in items if it[0] == "a"] for items in blocks]
    blocks[0] += b_items
    assert steps_left(kernel_steps(blocks, bf), 1, 2, 1, 1) > 0
