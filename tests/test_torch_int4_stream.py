"""The arithmetic order and the work plans of the int4 weight stream
(csrc/int4_stream.cuh) that int4_matmul.cu and decode_step.cu share, on the CPU.

The kernels run only on the card; these tests hold what surrounds them:
- a torch emulation of the kernels' order (each 32-row ring stage of each
  half, which lies inside one scale group: the integer product of x and the
  nibbles in f32, then times its scale, plus z times the stage's sum of x for
  the affine law, added to the item's sum stage after stage; splits or chunks
  added in order; at group 32 a stage is a group) against the
  plain versions at 1e-5 of max |ref| (f32 on both sides, other summation
  orders), and against the JAX Pallas int4_matmul in interpret mode at 1e-5
  (x with exact bf16 group sums, as tests/test_torch_quant.py feeds it);
- the megakernel's order (products as above over the planned chunks, the
  norms from per-tile sums of squares) against `_trunk_ref` at the CFG of
  tests/test_decode_step.py, within 1e-4 of max |y| (the bf16 rounding of
  the normed input flips in the last bit where the f32 sums differ);
- every host-side plan: each (column tile, k chunk, row chunk) is covered
  exactly once, no padded row is read, staged x fits its buffer, and the
  ring's issue / consume sequence uses each stage once, in the slot it was
  issued to, never overwritten before it is consumed;
- the megakernel's tile barriers: with the blocks' item runs and their
  arrivals (one a tile, after a block's last chunk of it), every barrier is
  reached, also where a product has more items than blocks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_tpu.ops import quant_matmul as jqm
from mllm_tpu_torch.core.config import TextConfig
from mllm_tpu_torch.models.megadecode import MegaDecodeLM
from mllm_tpu_torch.models.transformer import CausalLM
from mllm_tpu_torch.nn.layers import RotaryEmbedding
from mllm_tpu_torch.ops import decode_step as tds
from mllm_tpu_torch.ops import quant_matmul as tqm
from mllm_tpu_torch.ops.fused_mlp import _ACT

STAGE = 32  # packed rows a ring stage holds (kStageRows)
SUB = 128  # the columns the megakernel finishes a tile in, and sums squares over (kSub)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


# ---------------------------------------------------------------------------
# the emulated order
# ---------------------------------------------------------------------------


def _stage(xlo, xhi, qbytes, s_lo, s_hi, z_lo=None, z_hi=None):
    """One 32-row ring stage of both halves: x [m, 32] each, qbytes [32, N] u8."""
    out = 0.0
    for xs, q, s, z in ((xlo, (qbytes & 15), s_lo, z_lo), (xhi, (qbytes >> 4), s_hi, z_hi)):
        q = q.float() if z is not None else q.float() - 8.0
        c = xs @ q
        out = out + c * s[None, :]
        if z is not None:
            out = out + xs.sum(-1, keepdim=True) * z[None, :]
    return out


def int4_items(m, k, n, sms, affine=False):
    """The kernel's work items (`item_of` in csrc/int4_matmul.cu) over its
    plan: (column tile, split or -1 for a whole tile, first and end packed row)."""
    _, full, splits, split_rows, _ = tqm.int4_plan(m, k, n, sms, affine)
    khalf, tiles = k // 2, -(-n // tqm.TILE_N)
    rest = tiles - full
    items = [(t, -1, 0, khalf) for t in range(full)]
    for i in range(rest * splits):
        sp = i // rest
        items.append((full + i % rest, sp, sp * split_rows, min((sp + 1) * split_rows, khalf)))
    return items


def stream_int4_matmul(x, packed, scales, zeros, sms):
    """int4_matmul in the kernel's order, over its plan: a whole tile stage
    after stage, a split tile's splits so and then added in split order."""
    m, k = x.shape
    khalf, n = k // 2, packed.shape[1]
    ngh = packed.shape[0] // 32
    xb = x.to(torch.bfloat16).float()
    out = torch.zeros(m, n)
    parts = {}
    for tile, sp, r0, r1 in int4_items(m, k, n, sms, zeros is not None):
        cols = slice(tile * tqm.TILE_N, min((tile + 1) * tqm.TILE_N, n))
        acc = torch.zeros(m, cols.stop - cols.start)
        for j0 in range(r0, r1, STAGE):
            g = j0 // 32
            zl = zeros[g, cols] if zeros is not None else None
            zh = zeros[ngh + g, cols] if zeros is not None else None
            acc = acc + _stage(xb[:, j0:j0 + STAGE], xb[:, khalf + j0:khalf + j0 + STAGE],
                               packed[j0:j0 + STAGE, cols], scales[g, cols], scales[ngh + g, cols], zl, zh)
        if sp < 0:
            out[:, cols] = acc
        else:
            parts.setdefault(tile, {})[sp] = (cols, acc)
    for tile, by_split in parts.items():
        total = 0.0
        for sp in sorted(by_split):
            cols, acc = by_split[sp]
            total = total + acc
        out[:, cols] = total
    return out


def stream_product(xin, packed, scales, group, block_f, rows):
    """A megakernel product in the kernel's order: chunks of `rows` packed
    rows, stage after stage, the chunks added in order."""
    khalf, n = packed.shape
    fh = block_f // 2 if block_f else khalf
    scales = scales.float()

    def klo(j):
        return j if not block_f else (j // fh) * block_f + j % fh

    total = torch.zeros(xin.shape[0], n)
    for c0 in range(0, khalf, rows):
        acc = torch.zeros(xin.shape[0], n)
        for j0 in range(c0, c0 + rows, STAGE):
            lo, hi = klo(j0), klo(j0) + fh
            acc = acc + _stage(xin[:, lo:lo + STAGE], xin[:, hi:hi + STAGE], packed[j0:j0 + STAGE],
                               scales[lo // group], scales[hi // group])
        total = total + acc
    return total


def _tile_rms_bf16(x, w, eps):
    """The norm from per-128-column sums of squares added in order."""
    ss = sum((x[:, t:t + SUB] ** 2).sum(-1) for t in range(0, x.shape[1], SUB))
    inv = torch.rsqrt(ss / x.shape[1] + eps)[:, None]
    return (x * inv * w.float()).to(torch.bfloat16).float()


def stream_trunk(x, rope, pos, kvs, ops, k_cache, v_cache, plan, *, h, hkv, act, eps, rm, scale, group_a,
                 group_d, block_f):
    """`_trunk_ref` with the products and norms in the megakernel's order."""
    qkv_ops, o_ops, gate_ops, up_ops, down_ops, n1, n2 = ops
    rq, ro, rgu, rd, _ = plan
    b, hd = x.shape[0], 128
    n_q, gq = h * hd, h // hkv
    t = torch.arange(k_cache.shape[3])
    ok = (t[None, :] >= kvs[:, None]) & (t[None, :] < pos[:, None])
    k_news, v_news = [], []
    for l in range(qkv_ops[0].shape[0]):
        xn = _tile_rms_bf16(x, n1[l, 0], eps)
        qkv = stream_product(xn, qkv_ops[0][l], qkv_ops[1][l], group_a, 0, rq) + qkv_ops[2][l, 0].float()
        q = rope(qkv[:, :n_q].reshape(b, h, hd)) * scale
        k = rope(qkv[:, n_q:n_q + hkv * hd].reshape(b, hkv, hd))
        v = qkv[:, n_q + hkv * hd:].reshape(b, hkv, hd)
        k_news.append(k)
        v_news.append(v)
        qg = q.reshape(b, hkv, gq, hd)
        s = torch.einsum("bkgd,bksd->bkgs", qg.to(k_cache.dtype).float(), k_cache[l].float())
        s = s.masked_fill(~ok[:, None, None, :], float("-inf"))
        s0 = (qg * k[:, :, None, :]).sum(-1)
        mx = torch.maximum(s.amax(-1), s0)
        p, p0 = torch.exp(s - mx[..., None]), torch.exp(s0 - mx)
        pv = torch.einsum("bkgs,bksd->bkgd", p.to(v_cache.dtype).float(), v_cache[l].float())
        o = ((p0[..., None] * v[:, :, None, :] + pv) / (p0 + p.sum(-1))[..., None])
        o = o.reshape(b, n_q).to(torch.bfloat16).float()
        x = x + stream_product(o, o_ops[0][l], o_ops[1][l], group_a, 0, ro) * rm
        xn = _tile_rms_bf16(x, n2[l, 0], eps)
        gate = stream_product(xn, gate_ops[0][l], gate_ops[1][l], group_a, 0, rgu)
        up = stream_product(xn, up_ops[0][l], up_ops[1][l], group_a, 0, rgu)
        hmid = (_ACT[act](gate) * up).to(torch.bfloat16).float()
        x = x + stream_product(hmid, down_ops[0][l], down_ops[1][l], group_d, block_f, rd) * rm
    return x, torch.stack(k_news), torch.stack(v_news)


# ---------------------------------------------------------------------------
# int4_matmul
# ---------------------------------------------------------------------------


def _operands(rng, m, k, n, affine):
    w = (rng.standard_normal((n, k)) * 0.02).astype(np.float32)
    p, s, z = jqm.prepare_int4(*jqm.repack_float_to_int4(w, 32), 32)
    if affine:
        live = s != 0
        rows = np.arange(p.shape[0])[:, None] < k // 2
        p = (rng.integers(0, 256, p.shape) * rows).astype(np.uint8)
        s = (rng.uniform(0.001, 0.02, s.shape) * live).astype(np.float32)
        z = (rng.standard_normal(s.shape) * 0.05 * live).astype(np.float32)
    x = (rng.integers(-2, 3, (m, k)) * 0.5).astype(np.float32)  # exact bf16 group sums
    return x, p, s, (z if affine else None)


# chip_smoke.INT4_ROWS scaled down: qkv, o, gate||up, down, the padded head,
# affine rows, K = 960 (K/2 = 480 padded to 512); sms small enough to split K
INT4_ROWS = [(1, 192, 256, False), (2, 192, 384, False), (8, 192, 512, False), (17, 448, 128, False),
             (32, 448, 256, False), (1, 192, 1024, True), (8, 448, 128, True), (8, 960, 256, False),
             (32, 960, 128, True)]


@pytest.mark.parametrize("m,k,n,affine", INT4_ROWS, ids=[f"m{r[0]}_k{r[1]}_n{r[2]}{'_aff' if r[3] else ''}"
                                                         for r in INT4_ROWS])
def test_int4_stream_order(m, k, n, affine):
    x, p, s, z = _operands(np.random.default_rng(m * 1000 + k + n), m, k, n, affine)
    tx, tp, ts = torch.from_numpy(x), torch.from_numpy(p), torch.from_numpy(s)
    tz = None if z is None else torch.from_numpy(z)
    got = stream_int4_matmul(tx, tp, ts, tz, sms=2)
    assert _rel(got, tqm.int4_matmul_ref(tx, tp, ts, 32, tz)) < 1e-5
    want = jqm.int4_matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(p), jnp.asarray(s), 32,
                           None if z is None else jnp.asarray(z), interpret=True)
    assert _rel(got, want) < 1e-5


def _int4_plan_cases():
    for m in (1, 2, 8, 17, 32):
        for k, n in ((1536, 2048), (1536, 1536), (8960, 1536), (1536, 152064), (960, 2048), (64, 4)):
            for sms in (132, 2):
                yield m, k, n, sms


@pytest.mark.parametrize("sms", [132, 2])
def test_int4_plan_covers_each_row_once(sms):
    for (m, k, n, _), affine in ((c, a) for c in _int4_plan_cases() if c[3] == sms for a in (False, True)):
        mt8, full, splits, split_rows, chunk_rows = tqm.int4_plan(m, k, n, sms, affine)
        khalf, tiles = k // 2, -(-n // tqm.TILE_N)
        assert 8 * mt8 >= m and mt8 in (1, 2, 4)
        assert 0 <= full <= tiles and split_rows % STAGE == 0 and chunk_rows % STAGE == 0
        assert (chunk_rows // 16) * 2 * 64 * mt8 * 4 <= tqm.X_STAGE_BYTES
        grid = tqm.int4_grid(mt8, sms, affine)
        assert full == tiles or full % grid == 0  # whole tiles fill whole waves
        items = int4_items(m, k, n, sms, affine)
        # the split items fit the grid: each has a resident block of its own
        # (the cooperative launch's condition), one more wave at most
        assert len(items) - full <= grid
        seen = np.zeros((tiles, khalf), np.int32)
        for tile, sp, r0, r1 in items:
            assert 0 <= r0 < r1 <= khalf  # no empty item, no padded row
            for j0 in range(r0, r1, STAGE):
                seen[tile, j0:j0 + STAGE] += 1
        assert (seen == 1).all(), (m, k, n, sms, affine)


@pytest.mark.parametrize("items,grid", [(1188, 264), (192, 264), (3360, 264), (240, 132), (7, 3), (1, 1)])
def test_item_runs_cover_each_item_once(items, grid):
    """The megakernel's `item_begin`: contiguous runs, balanced to one item."""
    begins = [blk * items // grid for blk in range(grid + 1)]
    runs = [range(begins[i], begins[i + 1]) for i in range(grid)]
    flat = [it for r in runs for it in r]
    assert flat == list(range(items))
    assert max(map(len, runs)) - min(map(len, runs)) <= 1


# ---------------------------------------------------------------------------
# the megakernel
# ---------------------------------------------------------------------------

CFG_KW = dict(vocab_size=512, hidden_size=512, intermediate_size=512, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, head_dim=128,
              max_position_embeddings=256, attention_bias=True, tie_word_embeddings=True,
              model_type="qwen2")  # the CFG of tests/test_decode_step.py
GEOMETRIES = [  # (b, d, n_q, n_qkv, ff, h, block_f)
    (1, 1536, 1536, 2048, 8960, 12, 1280), (8, 1536, 1536, 2048, 8960, 12, 1280),
    (32, 1536, 1536, 2048, 8960, 12, 1280), (4, 512, 512, 1024, 512, 4, 512),
    (17, 2048, 2048, 2560, 5632, 16, 512), (3, 3584, 3584, 4608, 18944, 28, 2368 * 2),
    # more items than blocks on the H100's 132 SMs: gate_up 296 items on 264
    # blocks at b=16 and 518 on 132 at b=32 (Qwen2-7B), 176 on 132 at b=32
    # (a 16-head d=2048 model)
    (16, 3584, 3584, 4608, 18944, 28, 512), (32, 3584, 3584, 4608, 18944, 28, 512),
    (32, 2048, 2048, 6144, 11008, 16, 256)]


@pytest.fixture(scope="module")
def mega():
    torch.manual_seed(0)
    cfg = TextConfig(**CFG_KW)
    return cfg, MegaDecodeLM.from_float(CausalLM.init(cfg, device="cpu"))


@pytest.mark.parametrize("b,pos,kvs", [(1, [70], [0]), (4, [3, 100, 255, 40], [0, 50, 7, 40])],
                         ids=["b1", "b4_ragged"])
def test_mega_stream_order(mega, b, pos, kvs):
    cfg, m = mega
    rng = np.random.default_rng(b)
    L, hkv, h = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.num_attention_heads
    x = torch.from_numpy(rng.standard_normal((b, cfg.hidden_size)).astype(np.float32)) * 0.05
    kc, vc = (torch.from_numpy(rng.standard_normal((L, b, hkv, 256, 128)).astype(np.float32)).bfloat16()
              for _ in range(2))
    rope = RotaryEmbedding.make(128, 256, cfg.rope_theta, device="cpu")
    p = torch.tensor(pos)
    c, s = rope.cos[p].float(), rope.sin[p].float()
    cos_ext, sin_ext = torch.cat([c, c], -1)[:, None], torch.cat([-s, s], -1)[:, None]

    def rope_fn(rows):
        return rows * cos_ext + torch.cat([rows[..., 64:], rows[..., :64]], -1) * sin_ext

    ops = (m.qkv_ops.astuple(), m.o_ops.astuple()[:2], m.gate_ops.astuple()[:2], m.up_ops.astuple()[:2],
           m.down_ops.astuple()[:2], m.norm1_w, m.norm2_w)
    kw = dict(h=h, hkv=hkv, act=cfg.hidden_act, eps=cfg.rms_norm_eps, rm=1.0, scale=128**-0.5,
              group_a=m.group_a, group_d=32, block_f=m.block_f)
    n_q, n_qkv = h * 128, (h + 2 * hkv) * 128
    plan = tds.decode_step_plan(b, cfg.hidden_size, n_q, n_qkv, cfg.intermediate_size, h, sms=2)
    got = stream_trunk(x, rope_fn, p, torch.tensor(kvs), ops, kc, vc, plan, **kw)
    want = tds._trunk_ref(x, rope_fn, p, torch.tensor(kvs), *ops, kc, vc, hd=128, **kw)
    for g, w in zip(got, want):
        assert _rel(g, w) < 1e-4


@pytest.mark.parametrize("geo", GEOMETRIES, ids=[f"b{g[0]}_d{g[1]}" for g in GEOMETRIES])
@pytest.mark.parametrize("sms", [132, 7])
def test_mega_plan_covers_each_chunk_once(geo, sms):
    b, d, n_q, n_qkv, ff, h, block_f = geo
    plan = tds.decode_step_plan(b, d, n_q, n_qkv, ff, h, sms)
    rq, ro, rgu, rd, nsplit = plan
    mt8 = tds.mega_rows_of_x(b)
    assert 8 * mt8 >= b and 1 <= nsplit <= 32
    grid = tds.mega_grid(b, sms)
    for name, khalf, ncols, mats, rows, slab in [("qkv", d // 2, n_qkv, 1, rq, 0), ("o", n_q // 2, d, 1, ro, 0),
                                                 ("gate_up", d // 2, ff, 2, rgu, 0),
                                                 ("down", ff // 2, d, 1, rd, block_f // 2)]:
        assert rows % STAGE == 0 and khalf % rows == 0, name
        assert (rows // 16) * 2 * 64 * mt8 <= tds.X_STAGE_FLOATS
        tiles, chunks = mats * -(-ncols // tds.TILE_N), khalf // rows
        fits = [r for r in range(STAGE, khalf + 1, STAGE)
                if khalf % r == 0 and (r // 16) * 2 * 64 * mt8 <= tds.X_STAGE_FLOATS]
        if any(tiles * (khalf // r) <= grid for r in fits):  # one item a block, where one can be had
            assert tiles * chunks <= grid, name
        else:  # else the fewest items
            assert rows == fits[-1], name
        seen = np.zeros((tiles, khalf), np.int32)
        for blk in range(grid):
            for it in range(blk * tiles * chunks // grid, (blk + 1) * tiles * chunks // grid):
                tile, chunk = it // chunks, it % chunks  # tile-major
                for j0 in range(chunk * rows, (chunk + 1) * rows, STAGE):
                    if slab:  # a stage never crosses a slab of the block-planar layout
                        assert j0 // slab == (j0 + STAGE - 1) // slab
                    seen[tile, j0:j0 + STAGE] += 1
        assert (seen == 1).all(), name
        # finishing: the b x heads (row, head) units of each tile, the block of
        # chunk c taking units c, c + chunks, ... (`finish_units`)
        for tile in range(tiles):
            heads = min(tds.TILE_N, ncols - (tile % (tiles // mats)) * tds.TILE_N) // SUB
            done = np.zeros(b * heads, np.int32)
            for chunk in range(chunks):
                for u0 in range(chunk, b * heads, 2 * chunks):
                    for u in (u0, u0 + chunks):
                        if u < b * heads:
                            done[u] += 1
            assert (done == 1).all(), name
    ws = tds.decode_step_workspace(b, d, n_q, n_qkv, ff, h, plan)
    assert ws >= b * (2 * d + n_qkv + 2 * ff) + (d // 2 // rq) * b * n_qkv


def tile_arrivals(tiles, chunks, grid):
    """Each block's arrivals at the tile barriers of one product, in its order
    (`product` in csrc/decode_step.cu): over the block's contiguous run of the
    tile-major items, one arrival a tile, after its last chunk of the tile,
    adding its chunks of it: [tile, chunks added]."""
    out = []
    for blk in range(grid):
        arr = []
        for it in range(blk * tiles * chunks // grid, (blk + 1) * tiles * chunks // grid):
            if arr and arr[-1][0] == it // chunks:
                arr[-1][1] += 1
            else:
                arr.append([it // chunks, 1])
        out.append(arr)
    return out


def barriers_reached(arrivals, tiles, chunks):
    """Runs the blocks until none can move: a block adds its count at its next
    tile, then waits there until the tile's count is `chunks`. True when every
    block passed every barrier of its list."""
    count, at, waiting = [0] * tiles, [0] * len(arrivals), [False] * len(arrivals)
    moved = True
    while moved:
        moved = False
        for blk, arr in enumerate(arrivals):
            if at[blk] == len(arr):
                continue
            tile, n = arr[at[blk]]
            if not waiting[blk]:
                count[tile] += n
                waiting[blk] = moved = True
            if count[tile] == chunks:
                at[blk] += 1
                waiting[blk], moved = False, True
    return all(a == len(arr) for a, arr in zip(at, arrivals)) and count == [chunks] * tiles


@pytest.mark.parametrize("geo", GEOMETRIES, ids=[f"b{g[0]}_d{g[1]}" for g in GEOMETRIES])
@pytest.mark.parametrize("sms", [132, 7])
def test_mega_tile_barriers_are_reached(geo, sms):
    """Every tile barrier of every product is reached with the plan's item
    runs, also where a block owns several chunks of one tile (more items than
    blocks), which an arrival (and wait) after each item would deadlock."""
    b, d, n_q, n_qkv, ff, h, _ = geo
    grid = tds.mega_grid(b, sms)
    plan = tds.decode_step_plan(b, d, n_q, n_qkv, ff, h, sms)
    for name, khalf, ncols, mats, rows in [("qkv", d // 2, n_qkv, 1, plan[0]), ("o", n_q // 2, d, 1, plan[1]),
                                           ("gate_up", d // 2, ff, 2, plan[2]), ("down", ff // 2, d, 1, plan[3])]:
        tiles, chunks = mats * -(-ncols // tds.TILE_N), khalf // rows
        arrivals = tile_arrivals(tiles, chunks, grid)
        assert barriers_reached(arrivals, tiles, chunks), name
        per_item = [[[t, 1] for t, n in arr for _ in range(n)] for arr in arrivals]
        shared = any(n > 1 for arr in arrivals for _, n in arr)
        assert barriers_reached(per_item, tiles, chunks) != shared, name


def test_ring_issues_and_consumes_each_stage_once():
    """The megakernel's ring (prime before a barrier, issue one stage per
    consumed stage) over two layers of four products: every stage of the
    block's items is consumed once, from the slot it was issued to, and no
    slot is reissued before its stage was consumed."""
    stages_s = 8
    for grid, blk in ((264, 0), (264, 263), (7, 3)):
        plan = tds.decode_step_plan(1, 1536, 1536, 2048, 8960, 12, 132)
        prods = []
        for rows, khalf, tiles in ((plan[0], 768, 4), (plan[1], 768, 3), (plan[2], 768, 36),
                                   (plan[3], 4480, 3)):
            chunks = khalf // rows
            items = range(blk * tiles * chunks // grid, (blk + 1) * tiles * chunks // grid)
            prods.append([(it, st) for it in items for st in range(rows // STAGE)])
        slots = {}  # slot -> (product, stage) issued there and not yet consumed
        issued = consumed = 0
        for layer in range(2):
            for pi, seq in enumerate(prods):
                key = (layer, pi)
                nxt = iter(seq)

                def issue():
                    nonlocal issued
                    st = next(nxt, None)
                    if st is None:
                        return
                    slot = issued % stages_s
                    assert slot not in slots, "a slot reissued before its stage was consumed"
                    slots[slot] = (key, st)
                    issued += 1

                for _ in range(stages_s - 1):  # prime
                    issue()
                for st in seq:  # product: one issue per consumed stage
                    issue()
                    slot = consumed % stages_s
                    assert slots.pop(slot) == (key, st)
                    consumed += 1
        assert not slots and issued == consumed


def attention_items(pos, kvs, h, nsplit, grid):
    """The megakernel's attention items (`split_counts` in csrc/decode_step.cu):
    (slot, q head, split, first key, end key)."""
    keys = [max(p, s) - s for p, s in zip(pos, kvs)]
    b = len(pos)
    room = max(grid - b * h, b * h)
    span = max(1, -(-sum(keys) * h // room))
    items = []
    for r in range(b):
        n = min(nsplit, max(1, -(-keys[r] // span)))
        per = -(-keys[r] // n)
        for qh in range(h):
            for sp in range(n):
                start = kvs[r] + sp * per
                items.append((r, qh, sp, start, min(start + per, kvs[r] + keys[r])))
    return items


@pytest.mark.parametrize("pos,kvs,grid", [
    ([1531], [200], 264), ([1, 17, 100, 511, 513, 1000, 1531, 2000], [0, 0, 5, 100, 0, 50, 0, 3], 264),
    ([200] * 32, [0] * 32, 132), ([0, 0, 5], [0, 0, 5], 264), ([2048] * 4, [0, 2047, 7, 2048], 14)],
    ids=["b1", "b8", "b32", "no_keys", "small_grid"])
def test_attention_splits_cover_each_key_once(pos, kvs, grid):
    """Every cached key of every (slot, q head) falls in one split; a slot
    takes 1 .. nsplit splits; the busiest item holds about the keys over the
    grid, or a slot's keys over nsplit (so b=8's longest slot no longer sets
    the phase)."""
    b, h = len(pos), 12
    nsplit = tds.decode_step_plan(b, 1536, 1536, 2048, 8960, h, grid // tds.mega_grid(b, 1))[4]
    items = attention_items(pos, kvs, h, nsplit, grid)
    for r in range(b):
        for qh in range(h):
            mine = [it for it in items if it[:2] == (r, qh)]
            assert 1 <= len(mine) <= nsplit and [it[2] for it in mine] == list(range(len(mine)))
            seen = np.zeros(2048 + 1, np.int32)
            for _, _, _, a, e in mine:
                seen[a:max(a, e)] += 1
            assert (seen[kvs[r]:pos[r]] == 1).all() and seen.sum() == max(pos[r] - kvs[r], 0)
    total = sum(max(p - s, 0) for p, s in zip(pos, kvs))
    longest = max(max(p - s, 0) for p, s in zip(pos, kvs))
    busiest = max(e - a for *_, a, e in items)
    assert busiest <= 2 * max(-(-total * h // grid), -(-longest // nsplit)) + 1
