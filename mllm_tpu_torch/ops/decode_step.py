"""Whole-trunk int4 decode step: the `fused_decode_step` (b = 1) and
`fused_decode_step_batched` (b <= 32) wrappers around the hand-written Hopper
kernel in `csrc/decode_step.cu`, their plain PyTorch versions, and
`rope_rotation_matrix`.

Counterpart of `mllm_tpu/ops/decode_step.py`: one launch runs every decoder
layer of a decode step. The signatures and operand layouts are the JAX ones:
  qkv_ops  (packed [L, d/2, n_qkv] u8, scales [L, d/Ga, n_qkv], bias [L, 1, n_qkv] f32 or None)
  o_ops    (packed [L, n_q/2, d], scales [L, n_q/Ga, d])
  gate_ops, up_ops (packed [L, d/2, ff], scales [L, d/Ga, ff])
  down_ops (block-planar over ff: packed [L, ff/2, d], scales [L, ff/Gd, d])
  norm1_w, norm2_w [L, 1, d] f32;  k_cache, v_cache [L, B, Hkv, S, 128]
Packed nibbles are planar excess-8 (`MegaDecodeLM.from_float`); scales are
bf16 for the kernel (the plain versions take any float dtype). Both return
(y [b, d] f32 before the final norm, k_new, v_new f32: [L, Hkv, hd] at b = 1,
[L, b, Hkv, hd] batched); the caller writes the new K/V into the cache.

Key t of slot i is visible when kv_start[i] <= t < pos[i], where
0 <= kv_start[i] <= pos[i] < S (checked when the values are on the host). The plain versions
keep the JAX kernels' rounding points (normed inputs, bf16(q) against the
cache, bf16 probabilities before P.V, the attention output and the gated
hidden rounded to bf16) but take one softmax over all keys where the kernels
run an online one, and dequantize each weight in f32 (the Pallas kernels'
bf16 group sum of x is not reproduced; ROADMAP Queue 3).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. `block_k` and `slot_group` are accepted and change nothing: they were
the TPU kernel's VMEM tiling. Each wrapper counts its launches in `.launches`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .fused_mlp import _ACT, _ACT_ID, dequant_down_blockplanar
from .quant_matmul import check_operands, dequant_int4_canonical, launch_or_raise, pow2_rows, sm_count

HEAD_DIM = 128
MAX_BATCH = 32


def rope_rotation_matrix(sin_row: torch.Tensor, cos_row: torch.Tensor, hd: int = HEAD_DIM) -> torch.Tensor:
    """hf-style (rotate_half) RoPE at one position as a [hd, hd] f32 matrix R
    with rope(x) == x @ R:
      out[j]      = x[j] cos[j] - x[j+hd/2] sin[j]
      out[j+hd/2] = x[j+hd/2] cos[j] + x[j] sin[j]
    sin_row/cos_row: [hd/2] at the current position."""
    half = hd // 2
    i = torch.arange(half, device=sin_row.device)
    c = cos_row.reshape(half).float()
    s = sin_row.reshape(half).float()
    r = torch.zeros(hd, hd, device=sin_row.device, dtype=torch.float32)
    r[i, i] = c
    r[i + half, i] = -s
    r[i + half, i + half] = c
    r[i, i + half] = s
    return r


def _geometry(name, x, qkv_ops, gate_ops, k_cache, h, hkv, hd, group_a, block_f):
    """(L, d, ff, n_q, n_qkv, S) after the JAX wrappers' shape checks."""
    L, khalf_d, n_qkv = qkv_ops[0].shape
    d = 2 * khalf_d
    ff = gate_ops[0].shape[2]
    n_q = h * hd
    if x.shape[-1] != d:
        raise ValueError(f"{name}: x {tuple(x.shape)} does not fit d = {d}")
    if hd != HEAD_DIM or n_qkv != (h + 2 * hkv) * hd:
        raise ValueError(f"{name}: head_dim must be 128 and n_qkv (h + 2 hkv) * 128, "
                         f"got head_dim {hd}, n_qkv {n_qkv}, h {h}, hkv {hkv}")
    if ff % block_f or khalf_d % group_a or (n_q // 2) % group_a:
        raise ValueError(f"{name}: ff {ff} % block_f {block_f}, d/2 {khalf_d} and n_q/2 {n_q // 2} "
                         f"% group_a {group_a} must be 0")
    if k_cache.shape[0] != L or k_cache.shape[2] != hkv or k_cache.shape[4] != hd:
        raise ValueError(f"{name}: cache {tuple(k_cache.shape)} does not fit L {L}, hkv {hkv}")
    return L, d, ff, n_q, n_qkv, k_cache.shape[3]


def _rms_bf16(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """bf16(x * rsqrt(mean(x^2) + eps) * w) as f32 (the JAX `_rms` + cast)."""
    var = (x * x).mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * w.float()).to(torch.bfloat16).float()


def _dequant_planar(packed: torch.Tensor, scales: torch.Tensor, group: int) -> torch.Tensor:
    """Planar excess-8 [K/2, N] + scales [K/G, N] -> f32 [K, N]."""
    return dequant_int4_canonical(packed, scales.float(), None, group, 2 * packed.shape[0])


def _trunk_ref(x, rope, pos, kvs, qkv_ops, o_ops, gate_ops, up_ops, down_ops, norm1_w, norm2_w,
               k_cache, v_cache, *, h, hkv, hd, act, eps, rm, scale, group_a, group_d, block_f):
    """The plain trunk: x [b, d]; rope(rows [b, heads, hd]) -> roped rows;
    pos / kvs int [b] tensors. Returns (y [b, d], k_new, v_new [L, b, hkv, hd])."""
    b = x.shape[0]
    L = qkv_ops[0].shape[0]
    n_q, gq = h * hd, h // hkv
    t = torch.arange(k_cache.shape[3], device=x.device)
    ok = (t[None, :] >= kvs[:, None]) & (t[None, :] < pos[:, None])  # [b, S]
    x = x.float()
    k_news, v_news = [], []
    for l in range(L):
        xn = _rms_bf16(x, norm1_w[l, 0], eps)
        qkv = xn @ _dequant_planar(qkv_ops[0][l], qkv_ops[1][l], group_a)
        if qkv_ops[2] is not None:
            qkv = qkv + qkv_ops[2][l, 0].float()
        q = rope(qkv[:, :n_q].reshape(b, h, hd)) * scale
        k = rope(qkv[:, n_q : n_q + hkv * hd].reshape(b, hkv, hd))
        v = qkv[:, n_q + hkv * hd :].reshape(b, hkv, hd)
        k_news.append(k)
        v_news.append(v)

        # softmax over [current token] + visible cached keys
        qg = q.reshape(b, hkv, gq, hd)
        qc = qg.to(k_cache.dtype).float()
        s = torch.einsum("bkgd,bksd->bkgs", qc, k_cache[l].float())
        s = s.masked_fill(~ok[:, None, None, :], float("-inf"))
        s0 = (qg * k[:, :, None, :]).sum(-1)  # [b, hkv, gq] f32
        m = torch.maximum(s.amax(-1), s0)
        p = torch.exp(s - m[..., None])
        p0 = torch.exp(s0 - m)
        denom = p0 + p.sum(-1)
        pv = torch.einsum("bkgs,bksd->bkgd", p.to(v_cache.dtype).float(), v_cache[l].float())
        acc = p0[..., None] * v[:, :, None, :] + pv
        o = (acc / denom[..., None]).reshape(b, n_q).to(torch.bfloat16).float()

        x = x + (o @ _dequant_planar(o_ops[0][l], o_ops[1][l], group_a)) * rm
        xn = _rms_bf16(x, norm2_w[l, 0], eps)
        gate = xn @ _dequant_planar(gate_ops[0][l], gate_ops[1][l], group_a)
        up = xn @ _dequant_planar(up_ops[0][l], up_ops[1][l], group_a)
        hmid = (_ACT[act](gate) * up).to(torch.bfloat16).float()
        w_d = dequant_down_blockplanar(down_ops[0][l], down_ops[1][l].float(), None, group_d, block_f)
        x = x + (hmid @ w_d) * rm
    return x, torch.stack(k_news), torch.stack(v_news)


def _slot_ints(name, v, b, device, default=0) -> torch.Tensor:
    """int or [b] (list, array or tensor) -> int64 [b] on device."""
    if v is None:
        v = default
    t = torch.as_tensor(v, device=device).reshape(-1).long()
    if t.numel() == 1:
        t = t.expand(b)
    if t.numel() != b:
        raise ValueError(f"{name}: {t.numel()} positions for batch {b}")
    return t


def _check_window(name, pos, kv_start, s_max: int) -> None:
    """Raise unless 0 <= kv_start <= pos < s_max for every slot whose values
    are on the host (ints, lists, arrays, CPU tensors). A CUDA tensor is not
    read back, which would stall the host: the kernel clamps its window to the
    cache rows, as the plain version's mask does."""
    def host(v):
        if v is None or isinstance(v, torch.Tensor) and v.device.type != "cpu":
            return None
        return torch.as_tensor(v).reshape(-1).long()

    p, s = host(pos), host(kv_start)
    if p is not None and not ((p >= 0) & (p < s_max)).all():
        raise ValueError(f"{name}: pos {p.tolist()} outside the cache [0, {s_max})")
    if s is not None and not (s >= 0).all():
        raise ValueError(f"{name}: kv_start {s.tolist()} is negative")
    if p is not None and s is not None and (1 in (p.numel(), s.numel()) or p.numel() == s.numel()) \
            and not (s <= p).all():
        raise ValueError(f"{name}: kv_start {s.tolist()} past pos {p.tolist()}")


def fused_decode_step_ref(x, pos, rope_r, qkv_ops, o_ops, gate_ops, up_ops, down_ops, norm1_w, norm2_w,
                          k_cache, v_cache, *, n_heads: int, n_kv_heads: int, head_dim: int,
                          act: str = "silu", eps: float = 1e-6, rm: float = 1.0,
                          scale: Optional[float] = None, group_a: int = 64, group_d: int = 32,
                          block_f: int = 640, block_k: int = 512, kv_start=None):
    """Plain version of `fused_decode_step` (RoPE as x @ rope_r)."""
    _geometry("fused_decode_step", x, qkv_ops, gate_ops, k_cache, n_heads, n_kv_heads, head_dim,
              group_a, block_f)
    rot = rope_r.float()
    y, k_new, v_new = _trunk_ref(
        x.reshape(1, -1), lambda rows: rows @ rot, _slot_ints("pos", pos, 1, x.device),
        _slot_ints("kv_start", kv_start, 1, x.device), qkv_ops, o_ops, gate_ops, up_ops, down_ops,
        norm1_w, norm2_w, k_cache, v_cache, h=n_heads, hkv=n_kv_heads, hd=head_dim, act=act, eps=eps,
        rm=rm, scale=head_dim**-0.5 if scale is None else scale, group_a=group_a, group_d=group_d,
        block_f=block_f)
    return y, k_new[:, 0], v_new[:, 0]


def fused_decode_step_batched_ref(x, pos, sin_rows, cos_rows, qkv_ops, o_ops, gate_ops, up_ops,
                                  down_ops, norm1_w, norm2_w, k_cache, v_cache, *, n_heads: int,
                                  n_kv_heads: int, head_dim: int, act: str = "silu", eps: float = 1e-6,
                                  rm: float = 1.0, scale: Optional[float] = None, group_a: int = 64,
                                  group_d: int = 32, block_f: int = 640, block_k=None, slot_group=None,
                                  kv_start=None):
    """Plain version of `fused_decode_step_batched` (elementwise RoPE per slot)."""
    b = x.shape[0]
    _geometry("fused_decode_step_batched", x, qkv_ops, gate_ops, k_cache, n_heads, n_kv_heads,
              head_dim, group_a, block_f)
    half = head_dim // 2
    c = cos_rows.float().reshape(b, 1, half)
    s = sin_rows.float().reshape(b, 1, half)
    cos_ext, sin_ext = torch.cat([c, c], -1), torch.cat([-s, s], -1)

    def rope(rows):  # x * [c, c] + [x2, x1] * [-s, s]
        return rows * cos_ext + torch.cat([rows[..., half:], rows[..., :half]], -1) * sin_ext

    return _trunk_ref(
        x, rope, _slot_ints("pos", pos, b, x.device), _slot_ints("kv_start", kv_start, b, x.device),
        qkv_ops, o_ops, gate_ops, up_ops, down_ops, norm1_w, norm2_w, k_cache, v_cache, h=n_heads,
        hkv=n_kv_heads, hd=head_dim, act=act, eps=eps, rm=rm,
        scale=head_dim**-0.5 if scale is None else scale, group_a=group_a, group_d=group_d,
        block_f=block_f)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


STAGE_ROWS = 32  # packed rows a ring stage holds (csrc/int4_stream.cuh kStageRows)
TILE_N = 512  # output columns a product item covers (csrc/decode_step.cu kTileN)
SUB_N = 128  # the columns a finishing unit covers (kSub): one head
X_STAGE_FLOATS = 8192  # the largest staged chunk of x the plan asks for, in u32 words
# The plan's cost model (seconds; rates estimated from tools/mega_phases.py
# runs on "NVIDIA H100 80GB HBM3, 700.00 W"): a block streams weights (a
# packed row of a tile and its bf16 scales, ROW_BYTES) at about BLOCK_BPS,
# the grid at about GRID_BPS; partials go through L2 at about L2_BPS; a
# finishing block reads partials at about FINISH_BPS.
ROW_BYTES, BLOCK_BPS, GRID_BPS, L2_BPS, FINISH_BPS = 544, 25e9, 3.0e12, 5e12, 40e9


def mega_rows_of_x(b: int) -> int:
    """8-row tiles of x the kernel instantiates for b rows (1, 2 or 4)."""
    return pow2_rows(-(-b // 8), 4)


def mega_grid(b: int, sms: int) -> int:
    """The blocks the kernel expects to be resident: two an SM up to 16 rows
    of x, one at 32 (registers)."""
    return sms * (2 if mega_rows_of_x(b) <= 2 else 1)


def product_rows(khalf: int, n: int, mats: int, b: int, grid: int) -> int:
    """Packed rows per chunk of one product (`mats` matrices of `n` output
    columns, in tiles of 512): the multiple of 32 dividing khalf, with one
    item at most a block where one can be had (else the fewest items: a
    block then owns several chunks of a tile, and the kernel has it arrive
    at the tile's barrier once, after the last), that the cost model above
    finds fastest. It counts
    a block's weights and the grid's (the grid streams while the busiest
    block's own stages are in flight, so the two add up), the partials
    (b x 512 f32 an item, written and read back), and the finishing: the b x 4
    (row, head) units of a tile spread over its chunks' blocks, each unit the
    sum of one partial a chunk."""
    tiles = mats * -(-n // TILE_N)
    mt8 = mega_rows_of_x(b)
    fits = [r for r in range(STAGE_ROWS, khalf + 1, STAGE_ROWS)
            if khalf % r == 0 and (r // 16) * 2 * 64 * mt8 <= X_STAGE_FLOATS]
    one_each = [r for r in fits if tiles * (khalf // r) <= grid]
    if not one_each:  # more tiles than blocks: the fewest items
        return fits[-1]
    best = None
    for r in one_each:
        chunks = khalf // r
        units = b * TILE_N // SUB_N
        cost = (r * ROW_BYTES / BLOCK_BPS + tiles * khalf * ROW_BYTES / GRID_BPS
                + tiles * chunks * b * TILE_N * 8 / L2_BPS
                + -(-units // chunks) * chunks * SUB_N * 4 / FINISH_BPS)
        if best is None or cost < best[0]:
            best = (cost, r)
    return best[1]


def decode_step_plan(b: int, d: int, n_q: int, n_qkv: int, ff: int, h: int,
                     sms: int) -> tuple[int, int, int, int, int]:
    """(rows_qkv, rows_o, rows_gu, rows_d, nsplit): packed rows per product
    chunk (`product_rows`) and the most key splits a slot may take (the
    kernel deals the keys of all slots over about one (slot, q head, split)
    item a block, `split_counts` in csrc/decode_step.cu): up to twice a slot's
    share of the grid, at most 32."""
    grid = mega_grid(b, sms)
    nsplit = max(1, min(32, -(-2 * grid // (b * h))))
    return (product_rows(d // 2, n_qkv, 1, b, grid), product_rows(n_q // 2, d, 1, b, grid),
            product_rows(d // 2, ff, 2, b, grid), product_rows(ff // 2, d, 1, b, grid), nsplit)


def decode_step_workspace(b: int, d: int, n_q: int, n_qkv: int, ff: int, h: int, plan) -> int:
    """f32 elements of the kernel's workspace (csrc/decode_step.cu `carve`)."""
    rq, ro, rgu, rd, ns = plan
    tiles = lambda n: -(-n // TILE_N)  # noqa: E731
    pieces = [b * d, b * (d // SUB_N), b * n_qkv, b * 2 * ff, (d // 2 // rq) * b * n_qkv,
              (n_q // 2 // ro) * b * d, (d // 2 // rgu) * b * 2 * ff, (ff // 2 // rd) * b * d,
              b * h * ns, b * h * ns, b * h * ns * HEAD_DIM, tiles(n_qkv), tiles(d), 2 * tiles(ff),
              tiles(d), 4]
    return sum(-(-n // 4) * 4 for n in pieces)


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def _launch(name, entry, lead_args, b, x, qkv_ops, o_ops, gate_ops, up_ops, down_ops, norm1_w, norm2_w,
            k_cache, v_cache, *, h, hkv, act, eps, rm, scale, group_a, group_d, block_f, geo):
    """Check the operands, allocate outputs and workspace, and launch."""
    L, d, ff, n_q, n_qkv, s_max = geo
    u8, bf, f32 = torch.uint8, torch.bfloat16, torch.float32
    qkv_b = qkv_ops[2]
    check_operands(name, x, (qkv_ops[0], u8), (qkv_ops[1], bf), (qkv_b, f32), (o_ops[0], u8),
                   (o_ops[1], bf), (gate_ops[0], u8), (gate_ops[1], bf), (up_ops[0], u8),
                   (up_ops[1], bf), (down_ops[0], u8), (down_ops[1], bf), (norm1_w, f32),
                   (norm2_w, f32), (k_cache, bf), (v_cache, bf))
    if act not in _ACT_ID:
        raise ValueError(f"{name}: activation {act!r} not in {sorted(_ACT_ID)}")
    if k_cache.shape[1] != b or v_cache.shape != k_cache.shape:
        raise ValueError(f"{name}: the cache batch {k_cache.shape[1]} must equal b {b}")
    if (not 1 <= b <= MAX_BATCH or d % 256 or ff % 128 or (block_f // 2) % group_d or group_a % 32
            or group_d % 32 or (block_f // 2) % STAGE_ROWS):
        raise ValueError(f"{name}: the CUDA kernel needs 1 <= b <= 32, d % 256 == 0, ff % 128 == 0, "
                         f"groups that are multiples of 32, group_d | block_f/2 and 32 | block_f/2; got "
                         f"b {b}, d {d}, ff {ff}, block_f {block_f}, group_a {group_a}, group_d {group_d}")
    plan = decode_step_plan(b, d, n_q, n_qkv, ff, h, sm_count(x.device.index or 0))
    ws = torch.empty(decode_step_workspace(b, d, n_q, n_qkv, ff, h, plan), device=x.device, dtype=f32)
    y = torch.empty(b, d, device=x.device, dtype=f32)
    k_new = torch.empty(L, b, hkv, HEAD_DIM, device=x.device, dtype=f32)
    v_new = torch.empty_like(k_new)
    with torch.cuda.device(x.device):  # the kernel sizes its grid on the current device
        err = entry(*lead_args, *(_ptr(t) for t in (
            qkv_ops[0], qkv_ops[1], qkv_b, o_ops[0], o_ops[1], gate_ops[0], gate_ops[1], up_ops[0],
            up_ops[1], down_ops[0], down_ops[1], norm1_w, norm2_w, k_cache, v_cache, y, k_new, v_new,
            ws)), (ctypes.c_int * len(plan))(*plan), L, d, ff, h, hkv, s_max, group_a, group_d, block_f,
            _ACT_ID[act], eps, rm, scale, torch.cuda.current_stream(x.device).cuda_stream)
    launch_or_raise(name, err)
    return y, k_new, v_new


def _f32_rows(x: torch.Tensor, b: int, d: int) -> torch.Tensor:
    x2 = x.reshape(b, d).float().contiguous()
    return x2 if x2.data_ptr() % 16 == 0 else x2.clone()


def fused_decode_step(x, pos, rope_r, qkv_ops, o_ops, gate_ops, up_ops, down_ops, norm1_w, norm2_w,
                      k_cache, v_cache, *, n_heads: int, n_kv_heads: int, head_dim: int,
                      act: str = "silu", eps: float = 1e-6, rm: float = 1.0,
                      scale: Optional[float] = None, group_a: int = 64, group_d: int = 32,
                      block_f: int = 640, block_k: int = 512, kv_start=None):
    """One full-trunk decode step of one sequence: x [1, d] (post-embedding),
    pos = tokens already in the cache (a host int, or a one-element int tensor
    on the card that the kernel reads: a write head, so the launch is the same
    at every position), rope_r the [hd, hd] rotation at pos.
    Returns (y [1, d] f32, k_new [L, Hkv, hd] f32 roped, v_new [L, Hkv, hd] f32)."""
    name = "fused_decode_step"
    _check_window(name, pos, kv_start, k_cache.shape[3])
    if x.device.type == "cpu":
        return fused_decode_step_ref(
            x, pos, rope_r, qkv_ops, o_ops, gate_ops, up_ops, down_ops, norm1_w, norm2_w, k_cache,
            v_cache, n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=head_dim, act=act, eps=eps, rm=rm,
            scale=scale, group_a=group_a, group_d=group_d, block_f=block_f, kv_start=kv_start)
    geo = _geometry(name, x, qkv_ops, gate_ops, k_cache, n_heads, n_kv_heads, head_dim, group_a, block_f)
    start = int(kv_start or 0)
    if isinstance(pos, torch.Tensor) and pos.device.type != "cpu":
        if pos.numel() != 1:
            raise ValueError(f"{name}: one position for b = 1, got {pos.numel()}")
        pos_dev, pos = pos.reshape(1).to(device=x.device, dtype=torch.int32), 0
    else:
        pos_dev, pos = None, int(pos)
        _check_window(name, pos, start, geo[5])
    x2 =_f32_rows(x, 1, geo[1])
    rot = rope_r.to(device=x.device, dtype=torch.float32).contiguous()
    if rot.shape != (HEAD_DIM, HEAD_DIM):
        raise ValueError(f"{name}: rope_r must be [128, 128], got {tuple(rot.shape)}")
    y, k_new, v_new = _launch(
        name, _build.library().mllm_fused_decode_step_bf16,
        (x2.data_ptr(), rot.data_ptr(), _ptr(pos_dev), pos, start),
        1, x2, qkv_ops, o_ops, gate_ops, up_ops, down_ops, norm1_w, norm2_w, k_cache, v_cache,
        h=n_heads, hkv=n_kv_heads, act=act, eps=eps, rm=rm,
        scale=head_dim**-0.5 if scale is None else scale, group_a=group_a, group_d=group_d,
        block_f=block_f, geo=geo)
    fused_decode_step.launches += 1
    return y, k_new[:, 0], v_new[:, 0]


fused_decode_step.launches = 0


def fused_decode_step_batched(x, pos, sin_rows, cos_rows, qkv_ops, o_ops, gate_ops, up_ops, down_ops,
                              norm1_w, norm2_w, k_cache, v_cache, *, n_heads: int, n_kv_heads: int,
                              head_dim: int, act: str = "silu", eps: float = 1e-6, rm: float = 1.0,
                              scale: Optional[float] = None, group_a: int = 64, group_d: int = 32,
                              block_f: int = 640, block_k=None, slot_group=None, kv_start=None):
    """One full-trunk decode step of b <= 32 sequences, each at its own
    position: x [b, d], pos int or [b], sin_rows/cos_rows [b, hd/2] at each
    slot's position, kv_start None, int or [b]. Returns (y [b, d] f32,
    k_new [L, b, Hkv, hd] f32 roped, v_new [L, b, Hkv, hd] f32)."""
    name = "fused_decode_step_batched"
    _check_window(name, pos, kv_start, k_cache.shape[3])
    if x.device.type == "cpu":
        return fused_decode_step_batched_ref(
            x, pos, sin_rows, cos_rows, qkv_ops, o_ops, gate_ops, up_ops, down_ops, norm1_w, norm2_w,
            k_cache, v_cache, n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=head_dim, act=act,
            eps=eps, rm=rm, scale=scale, group_a=group_a, group_d=group_d, block_f=block_f,
            kv_start=kv_start)
    b = x.shape[0]
    geo = _geometry(name, x, qkv_ops, gate_ops, k_cache, n_heads, n_kv_heads, head_dim, group_a, block_f)
    x2 = _f32_rows(x, b, geo[1])
    half = HEAD_DIM // 2
    cos = cos_rows.to(device=x.device, dtype=torch.float32).reshape(b, half).contiguous()
    sin = sin_rows.to(device=x.device, dtype=torch.float32).reshape(b, half).contiguous()

    def slot_arg(v, what):  # (device int32 [b] or None, scalar)
        if v is None or isinstance(v, int):
            return None, int(v or 0)
        vec = torch.as_tensor(v).reshape(-1)
        if vec.numel() != b:
            raise ValueError(f"{name}: {vec.numel()} {what} entries for batch {b}")
        return vec.to(device=x.device, dtype=torch.int32).contiguous(), 0

    pos_vec, pos_int = slot_arg(pos, "pos")
    kvs_vec, kvs_int = slot_arg(kv_start, "kv_start")
    y, k_new, v_new = _launch(
        name, _build.library().mllm_fused_decode_step_batched_bf16,
        (x2.data_ptr(), cos.data_ptr(), sin.data_ptr(), _ptr(pos_vec), _ptr(kvs_vec), pos_int, kvs_int, b),
        b, x2, qkv_ops, o_ops, gate_ops, up_ops, down_ops, norm1_w, norm2_w, k_cache, v_cache,
        h=n_heads, hkv=n_kv_heads, act=act, eps=eps, rm=rm,
        scale=head_dim**-0.5 if scale is None else scale, group_a=group_a, group_d=group_d,
        block_f=block_f, geo=geo)
    fused_decode_step_batched.launches += 1
    return y, k_new, v_new


fused_decode_step_batched.launches = 0
