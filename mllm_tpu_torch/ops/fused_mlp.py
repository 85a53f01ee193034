"""Fused int4 gated MLP: the `fused_int4_mlp` wrapper around the hand-written
Hopper kernel in `csrc/fused_int4_mlp.cu`, its plain PyTorch version, and the
block-planar packer of the down projection.

Counterpart of `mllm_tpu/ops/fused_mlp.py`: y = down(act(gate(x)) * up(x)).

Layouts (from `prepare_int4` / `prepare_int4_ff`):
  gate/up: canonical planar excess-8 over K = d (packed [khp, ff]).
  down:    block-planar over K = ff: within each ff block of size `block_f`,
           packed row r holds f = j*F + r (low nibble) and f = j*F + F/2 + r
           (high); scales/zeros rows are in natural f order.

A CPU tensor takes the plain version, which follows the JAX fallback (f32
throughout). On the card, m <= 32 launches the kernel (one cooperative
launch, its plan `fused_mlp_plan`), which rounds the hidden activation to
bf16 as the Pallas kernel does; larger m dequantizes the three weights to
bf16 and runs three `torch.mm` (the JAX fallback route).
`fused_int4_mlp.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from .quant_matmul import (GROUP, INT4_KERNEL_MAX_M, SMEM_PER_BLOCK, SMEM_PER_SM,
                           STAGE_ROWS, TILE_N, bf16_rows, check_operands, dequant_int4_canonical,
                           launch_or_raise, pow2_rows, sm_count, tile_counters)


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


# As in the JAX package's fused_mlp.py, where `jax.nn.gelu` defaults to the
# tanh form: "gelu" here is the tanh approximation, unlike nn.layers.ACT_FN.
_ACT = {
    "silu": F.silu,
    "gelu": _gelu_tanh,
    "gelu_new": _gelu_tanh,
    "relu": F.relu,
}
_ACT_ID = {"silu": 0, "gelu": 1, "gelu_new": 2, "relu": 3}


def pick_block_f(ff: int, cap: int = 2048):
    """Largest F | ff with F a multiple of 256 and <= cap (None if none)."""
    best = None
    for f in range(256, cap + 1, 256):
        if ff % f == 0:
            best = f
    return best


def prepare_int4_ff(packed_t: torch.Tensor, scales_t: torch.Tensor, zeros_t, block_f: int):
    """Planar operands over K = ff -> block-planar excess-8 (torch tensors,
    the same bytes as the JAX function).

    In: packed [..., ff/2, n] planar (row r: f = r low nibble, f = r + ff/2
        high); signed two's-complement nibbles when zeros_t is None (made
        excess-8 with zeros = -8 * scales), raw 0..15 nibbles otherwise;
        scales/zeros [..., ff/G, n] indexed by f // G.
    Out: (packed [..., ff/2, n], scales, zeros): block j owns packed rows
        [j*F/2, (j+1)*F/2), low nibbles f = j*F + r, high f = j*F + F/2 + r;
        the scale rows are already in that (natural f) order."""
    *lead, khp, n = packed_t.shape
    ff = 2 * khp
    if ff % block_f:
        raise ValueError(f"prepare_int4_ff: ff {ff} is not a multiple of block_f {block_f}")
    if zeros_t is None:
        packed_t = packed_t ^ 0x88
        zeros_t = -8.0 * scales_t.float()
    fh = block_f // 2
    lo_rows = np.concatenate([np.arange(j * block_f, j * block_f + fh)
                              for j in range(ff // block_f)])

    def nib(f):
        row = torch.as_tensor(np.where(f < khp, f, f - khp), device=packed_t.device)
        taken = packed_t.index_select(-2, row)
        is_lo = torch.as_tensor(f < khp, device=packed_t.device)[:, None]
        return torch.where(is_lo, taken & 0x0F, taken >> 4)

    return (nib(lo_rows) | (nib(lo_rows + fh) << 4)).to(torch.uint8), scales_t, zeros_t


def dequant_down_blockplanar(dp: torch.Tensor, ds: torch.Tensor, dz, group: int,
                             block_f: int) -> torch.Tensor:
    """Block-planar down operands -> f32 [ff, n_out] in natural f order."""
    fh2, n = dp.shape
    fh = block_f // 2
    nblk = 2 * fh2 // block_f
    lo = (dp & 0x0F).float().reshape(nblk, fh, n)
    hi = (dp >> 4).float().reshape(nblk, fh, n)
    q = torch.stack([lo, hi], dim=1).reshape(2 * fh2, n)  # per block: low rows, then high
    s = ds.repeat_interleave(group, dim=0)
    if dz is None:
        return (q - 8.0) * s
    return q * s + dz.repeat_interleave(group, dim=0)


def fused_int4_mlp_ref(x, gate_ops, up_ops, down_ops, *, act: str = "silu",
                       group: int = GROUP, block_f: int = 1280):
    """Plain version, the JAX fallback: f32 dequant, f32 products, f32 hidden."""
    d = x.shape[-1]
    x2 = x.reshape(-1, d).float()
    w_g = dequant_int4_canonical(*gate_ops, group, d)
    w_u = dequant_int4_canonical(*up_ops, group, d)
    h = _ACT[act](x2 @ w_g) * (x2 @ w_u)
    y = h @ dequant_down_blockplanar(*down_ops, group, block_f)
    return y.reshape(*x.shape[:-1], y.shape[-1])


MLP_STAGES = 3  # ring stages of 32 packed rows (csrc/fused_int4_mlp.cu kStages)
# The plan's cost model (seconds): a least-squares fit (non-negative) to every
# plan that `tools/int4_tune.py --kernel mlp --sweep` timed at Qwen2-VL-2B's
# widths, m = 1, 8, 16, 32, on "NVIDIA H100 80GB HBM3, 700.00 W" (PERF.md):
# MLP_A_STAGE_S a gate/up stage of the busiest block, MLP_B_STAGE_S a stage of
# a down chunk (run once its h is made), and the gate/up partials a chunk
# gathers for its h at MLP_GATHER_BPS.
MLP_A_STAGE_S, MLP_B_STAGE_S, MLP_GATHER_BPS = 3.61e-6, 2.53e-6, 15.5e9


def mlp_stage_bytes(affine: bool) -> int:
    """Shared memory of one ring stage: 32 packed rows of a 512-column tile
    (rows 32 bytes apart) and the tile's scale (and zero) rows of both halves."""
    return STAGE_ROWS * (TILE_N + 32) + (4 if affine else 2) * TILE_N * 4


def mlp_blocks_per_sm(mt8: int) -> int:
    """The blocks an SM is meant to hold: two up to 16 rows of x, one at 32
    (registers)."""
    return 2 if mt8 <= 2 else 1


def mlp_chunk_rows(mt8: int, affine: bool) -> int:
    """The packed rows of the staged-x area (a multiple of 32) beside the
    ring, at mlp_blocks_per_sm blocks an SM (1 KB of each block's share is
    the system's): x staged as the bf16 pairs of both halves for 8 mt8 rows,
    32 mt8 bytes a packed row. A down chunk makes its h there too."""
    per = mlp_blocks_per_sm(mt8)
    budget = min(SMEM_PER_BLOCK, SMEM_PER_SM // per - 1024) - MLP_STAGES * mlp_stage_bytes(affine)
    return max(STAGE_ROWS, budget // (32 * mt8) // STAGE_ROWS * STAGE_ROWS)


@functools.cache
def fused_mlp_plan(m: int, d: int, ff: int, d_out: int, block_f: int, grid: int,
                   affine: bool = False) -> tuple[int, int, int, int, int]:
    """(mt8, splits_a, rows_a, splits_b, rows_b) of the fused_int4_mlp kernel
    on `grid` resident blocks: 8-row tiles of x (1, 2 or 4); gate and up's K
    (d / 2 packed rows) in splits_a runs of rows_a, down's K (ff / 2 packed
    rows) in splits_b chunks of rows_b (every chunk of the down tiles has a
    block of its own: ceil(d_out / 512) * splits_b <= grid; 32 rows of a
    chunk's h and the gate/up partials it gathers fit the staged-x area). The
    pair the cost model above finds fastest: the busiest block's gate/up
    stages, the down chunk's stages, the partials it gathers. Fewer items win
    a tie."""
    mt8 = pow2_rows(-(-m // 8), 4)
    ka, kb = d // 2 // STAGE_ROWS, ff // 2 // STAGE_ROWS
    ta, tb = -(-ff // TILE_N), -(-d_out // TILE_N)
    x_words = mlp_chunk_rows(mt8, affine) * 8 * mt8  # the staged-x area
    best = None
    for sa in range(1, ka + 1):
        ra = -(-ka // sa)
        if -(-ka // ra) != sa or 32 * (8 * mt8 + 4 * sa * m) > x_words:
            continue
        i = np.arange(2 * ta * sa)  # A item i on block i % grid
        st = np.where(i % sa < sa - 1, ra, ka - (sa - 1) * ra)
        a_s = np.bincount(i % grid, st, minlength=grid).max() * MLP_A_STAGE_S
        for rb in range(1, kb + 1):
            sb = -(-kb // rb)
            if tb * sb > grid or -(-kb // sb) != rb:
                continue
            t = a_s + rb * MLP_B_STAGE_S + 4 * 2 * sa * 2 * m * rb * STAGE_ROWS / MLP_GATHER_BPS
            key = (t, 2 * ta * sa + tb * sb)
            if best is None or key < best[0]:
                best = (key, (mt8, sa, ra * STAGE_ROWS, sb, rb * STAGE_ROWS))
    if best is None:
        raise ValueError(f"fused_int4_mlp: no plan for d={d}, ff={ff}, d_out={d_out}, block_f={block_f} "
                         f"on {grid} blocks")
    return best[1]


@functools.cache
def mlp_blocks(device_index: int, mt8: int, affine: bool, chunk_rows: int) -> int:
    """The blocks of the kernel <mt8, affine> an SM keeps resident with
    chunk_rows rows of x staged (the card's occupancy query)."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _build.library().mllm_fused_int4_mlp_blocks(mt8, int(affine), chunk_rows, ctypes.addressof(out))
    launch_or_raise("fused_int4_mlp (occupancy)", err)
    if out.value < 1:
        raise RuntimeError(f"fused_int4_mlp: the kernel <{mt8}, affine={affine}> does not fit an SM")
    return out.value


def fused_int4_mlp(x, gate_ops, up_ops, down_ops, *, act: str = "silu",
                   group: int = GROUP, block_f: int = 1280):
    """x [..., d] -> [..., d_out] f32 through the fused int4 gated MLP.

    gate_ops/up_ops: canonical (packed [khp_d, ff], scales, zeros) over K = d.
    down_ops: block-planar (packed [ff/2, d_out], scales, zeros).
    zeros are all None (symmetric) or all set (affine)."""
    if x.device.type == "cpu":
        return fused_int4_mlp_ref(x, gate_ops, up_ops, down_ops, act=act, group=group,
                                  block_f=block_f)
    gp, gs, gz = gate_ops
    up, us, uz = up_ops
    dp, ds, dz = down_ops
    d = x.shape[-1]
    khp_d, ff = gp.shape
    n_out = dp.shape[1]
    m = x.numel() // d
    if m > INT4_KERNEL_MAX_M:
        xb = x.reshape(-1, d).to(torch.bfloat16)

        def proj(ops):
            w = dequant_int4_canonical(*ops, group, d).to(torch.bfloat16)
            return torch.mm(xb, w, out_dtype=torch.float32)

        h = (_ACT[act](proj(gate_ops)) * proj(up_ops)).to(torch.bfloat16)
        w_d = dequant_down_blockplanar(dp, ds, dz, group, block_f).to(torch.bfloat16)
        y = torch.mm(h, w_d, out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], n_out)
    x2 = bf16_rows("fused_int4_mlp", x, d)
    u8, f32 = torch.uint8, torch.float32
    check_operands("fused_int4_mlp", x2, (gp, u8), (gs, f32), (gz, f32), (up, u8), (us, f32),
                   (uz, f32), (dp, u8), (ds, f32), (dz, f32))
    if act not in _ACT_ID:
        raise ValueError(f"fused_int4_mlp: activation {act!r} not in {sorted(_ACT_ID)}")
    affine = gz is not None
    if (uz is not None) != affine or (dz is not None) != affine:
        raise ValueError("fused_int4_mlp: zeros must be all None (symmetric) or all set")
    if (group != GROUP or d % 64 or block_f % 64 or ff % block_f or n_out % 4
            or up.shape != gp.shape or dp.shape != (ff // 2, n_out) or khp_d < d // 2):
        raise ValueError(
            f"fused_int4_mlp: the CUDA kernel needs group 32, d % 64 == 0, block_f % 64 == 0, "
            f"ff % block_f == 0, d_out % 4 == 0; got group {group}, d {d}, block_f {block_f}, "
            f"gate {tuple(gp.shape)}, up {tuple(up.shape)}, down {tuple(dp.shape)}")
    out = torch.empty(m, n_out, device=x.device, dtype=torch.float32)
    if m == 0:
        return out.reshape(*x.shape[:-1], n_out)
    dev, mt8 = x.device.index or 0, pow2_rows(-(-m // 8), 4)
    cap = mlp_chunk_rows(mt8, affine)
    grid = sm_count(dev) * mlp_blocks(dev, mt8, affine, cap)
    _, sa, rows_a, sb, rows_b = fused_mlp_plan(m, d, ff, n_out, block_f, grid, affine)
    ta, tb = -(-ff // TILE_N), -(-n_out // TILE_N)
    ws = torch.empty(2 * sa * m * ta * TILE_N + sb * m * tb * TILE_N, device=x.device,
                     dtype=torch.float32)  # the partials of the gate/up items, then of the down chunks
    counters = tile_counters(x.device, ta + 2 * tb + 1)  # left zeroed, as int4_matmul leaves them
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    err = _build.library().mllm_fused_int4_mlp_bf16(
        x2.data_ptr(), gp.data_ptr(), gs.data_ptr(), ptr(gz), up.data_ptr(), us.data_ptr(),
        ptr(uz), dp.data_ptr(), ds.data_ptr(), ptr(dz), ws.data_ptr(), counters.data_ptr(), out.data_ptr(),
        m, d, khp_d, ff, n_out, block_f, _ACT_ID[act], mt8, sa, rows_a, sb, rows_b,
        cap, grid, torch.cuda.current_stream(x.device).cuda_stream)
    launch_or_raise("fused_int4_mlp", err)
    fused_int4_mlp.launches += 1
    return out.reshape(*x.shape[:-1], n_out)


fused_int4_mlp.launches = 0
