"""Quantized weight products: the `int8_matmul` and `int4_matmul` wrappers
around the hand-written Hopper kernels in `csrc/int8_matmul.cu` and
`csrc/int4_matmul.cu`, their plain PyTorch versions, and the load-time
packers.

Counterpart of `mllm_tpu/ops/quant_matmul.py`. Layouts, as there:

  int8: values int8 [K, N] (k-major), scales f32 [N] per out-channel;
        y = (x @ q) * s.
  int4: the canonical planar layout of `prepare_int4`: packed uint8
        [khp, N], khp = K/2 padded to a block quantum; row j < K/2 holds
        k = j in the low nibble and k = K/2 + j in the high nibble, rows
        [K/2, khp) are zeros. Scales (and zeros) f32 [2*khp/G, N]: rows
        [0, khp/G) belong to the low half, [khp/G, 2*khp/G) to the high half.
        Nibbles are excess-8: value = (q - 8) * s when zeros is None
        (symmetric, weights quantized from float), else q * s + z.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. `int4_matmul` keeps the JAX package's rule: m <= 32 runs the kernel,
m > 32 dequantizes to bf16 and runs one `torch.mm` (the large product sits
outside the Pallas kernel in JAX too). `int8_matmul` runs its kernel at every
m. Each wrapper counts its kernel launches in `.launches`.

Not ported: `int8_matmul_a8`, the n-axis int4 layout and the ggml repackers
(ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from . import _build

GROUP = 32  # the int4 kernels' quant group
INT4_KERNEL_MAX_M = 32  # larger m dequantizes and runs one matmul (JAX quant_matmul.py:339)

# ---------------------------------------------------------------------------
# Load-time packers (numpy), byte-identical to the JAX package's numpy branch
# ---------------------------------------------------------------------------


def pack_int4_planar_signed(v: np.ndarray) -> np.ndarray:
    """v: int [N, K] values -8..7 -> two's-complement nibbles, planar [K/2, N]."""
    n, k = v.shape
    vt = np.ascontiguousarray(v.T).astype(np.int8)
    lo = (vt[: k // 2] & 0x0F).astype(np.uint8)
    hi = (vt[k // 2 :] & 0x0F).astype(np.uint8)
    return (lo | (hi << 4)).astype(np.uint8)


def repack_float_to_int8(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """float [N, K] -> (values [K, N] int8, scales f32 [N]), per out-channel."""
    w = np.ascontiguousarray(w, dtype=np.float32)
    amax = np.max(np.abs(w), axis=-1)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(w / scale[..., None]), -127, 127).astype(np.int8)
    return np.ascontiguousarray(q.T), scale


def repack_float_to_int4(w: np.ndarray, group: int = GROUP) -> tuple[np.ndarray, np.ndarray]:
    """float [N, K] -> planar int4 (packed [K/2, N] signed nibbles, scales
    f32 [K/G, N]), symmetric."""
    w = np.asarray(w, np.float32)
    n, k = w.shape
    wg = w.reshape(n, k // group, group)
    amax = np.max(np.abs(wg), axis=-1)
    scale = np.where(amax > 0, amax / 7.0, 1.0).astype(np.float32)
    v = np.clip(np.round(wg / scale[..., None]), -8, 7).astype(np.int8)
    return pack_int4_planar_signed(v.reshape(n, k)), np.ascontiguousarray(scale.T)


_INT4_BJ_CANDIDATES = (768, 512, 256)  # the JAX kernel's block quanta


def _pick_int4_pad(khalf: int) -> tuple[int, int]:
    """(block_j, padded khalf): smallest padding first, then largest block."""
    best = None
    for bj in _INT4_BJ_CANDIDATES:
        khp = -(-khalf // bj) * bj
        if best is None or khp < best[1]:
            best = (bj, khp)
    return best


def prepare_int4(packed_t, scales_t, group: int = GROUP, zeros_t=None):
    """Planar operands -> canonical kernel operands (numpy or torch, same bytes).

    In:  packed [..., K/2, N] planar (signed two's-complement nibbles when
         zeros_t is None, raw 0..15 nibbles otherwise), scales/zeros f32
         [..., K/G, N] (low-half rows, then high-half rows).
    Out: (packed_e8 [..., khp, N] uint8, scales [..., 2*khp/G, N],
         zeros [..., 2*khp/G, N]); the padded rows have zero scale and zero,
         so they add nothing. Signed nibbles become excess-8 (q ^ 0x88) with
         zeros = -8 * scales. Leading (stacked-layer) axes pass through."""
    *lead, kh, n = packed_t.shape
    lead = tuple(lead)
    if isinstance(packed_t, torch.Tensor):
        dev = packed_t.device
        zeros_like = lambda shape, dt: torch.zeros(shape, dtype=dt, device=dev)  # noqa: E731
        cat = lambda xs: torch.cat(xs, dim=-2)  # noqa: E731
        u8, f32 = torch.uint8, torch.float32
        if zeros_t is None:
            packed_t = packed_t ^ 0x88
            zeros_t = -8.0 * scales_t.float()
    else:
        zeros_like = np.zeros
        cat = lambda xs: np.concatenate(xs, axis=-2)  # noqa: E731
        u8, f32 = np.uint8, np.float32
        if zeros_t is None:
            packed_t = (packed_t ^ 0x88).astype(np.uint8)
            zeros_t = (-8.0 * scales_t).astype(np.float32)
    _, khp = _pick_int4_pad(kh)
    pad = khp - kh
    if pad:
        ng = kh // group
        zc = zeros_like(lead + (pad // group, n), f32)
        scales_t = cat([scales_t[..., :ng, :], zc, scales_t[..., ng:, :], zc])
        zeros_t = cat([zeros_t[..., :ng, :], zc, zeros_t[..., ng:, :], zc])
        packed_t = cat([packed_t, zeros_like(lead + (pad, n), u8)])
    return packed_t, scales_t, zeros_t


def dequant_int4_canonical(packed_e8: torch.Tensor, scales_p: torch.Tensor,
                           zeros_p: Optional[torch.Tensor], group: int, k: int) -> torch.Tensor:
    """Canonical operands -> f32 [K, N] (zeros_p None: value = (q - 8) * s).

    Computes the rows [0, K/2) of each half only; the padded rows are
    skipped, as the JAX function drops them after computing them."""
    khp = packed_e8.shape[0]
    khalf = k // 2
    ng, ngh = khalf // group, khp // group
    rows = packed_e8[:khalf]
    halves = []
    for q, g0 in (((rows & 0x0F).float(), 0), ((rows >> 4).float(), ngh)):
        s = scales_p[g0 : g0 + ng].repeat_interleave(group, dim=0)
        if zeros_p is None:
            halves.append((q - 8.0) * s)
        else:
            halves.append(q * s + zeros_p[g0 : g0 + ng].repeat_interleave(group, dim=0))
    return torch.cat(halves, dim=0)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def int8_matmul_ref(x: torch.Tensor, qweight_t: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """y[..., N] = (x @ q) * s in f32 (the JAX package's portable path)."""
    k, n = qweight_t.shape
    y = (x.reshape(-1, k).float() @ qweight_t.float()) * scales.float()[None, :]
    return y.reshape(*x.shape[:-1], n)


def int4_matmul_ref(x: torch.Tensor, packed_e8: torch.Tensor, scales_p: torch.Tensor,
                    group: int = GROUP, zeros_p: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y[..., N] = x @ dequant(canonical int4) in f32 (the JAX fallback)."""
    k = x.shape[-1]
    w = dequant_int4_canonical(packed_e8, scales_p, zeros_p, group, k)
    y = x.reshape(-1, k).float() @ w
    return y.reshape(*x.shape[:-1], packed_e8.shape[1])


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


@functools.cache
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_k(base_blocks: int, k_units: int, device: torch.device) -> tuple[int, int]:
    """(splits, k units per split): split the K axis until the grid holds
    about two blocks per SM. The partial products are added in split order
    by a second kernel, so the result does not depend on the schedule."""
    want = -(-2 * sm_count(device.index or 0) // max(base_blocks, 1))
    per = -(-k_units // max(1, min(want, k_units)))
    return -(-k_units // per), per


def bf16_rows(name: str, x: torch.Tensor, k: int) -> torch.Tensor:
    """x [..., K] -> contiguous, 16-byte aligned bf16 [m, K] on its card."""
    x2 = x.reshape(-1, k).to(torch.bfloat16).contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()
    if k % 8:
        raise ValueError(f"{name}: the CUDA kernel needs K % 8 == 0, got K = {k}")
    return x2


def check_operands(name: str, x: torch.Tensor, *operands) -> None:
    """Raise unless each (tensor, dtype) operand is a contiguous, 16-byte
    aligned tensor of that dtype on x's card (None operands are skipped)."""
    for t, dtype in operands:
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name}: operands on {t.device} and {x.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected a {dtype} operand, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be contiguous and 16-byte aligned")


def launch_or_raise(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")


def pow2_rows(m: int, cap: int = 16) -> int:
    """Rows of x per block: the next power of two >= m, at most `cap`."""
    mt = 1
    while mt < min(m, cap):
        mt *= 2
    return mt


def int8_matmul(x: torch.Tensor, qweight_t: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """y[..., N] = x[..., K] @ (qweight_t[K, N] * scales[None, :]), f32 out.

    On the card x is rounded to bf16 (as the JAX wrapper does) and every m
    runs the kernel, prefill included."""
    if x.device.type == "cpu":
        return int8_matmul_ref(x, qweight_t, scales)
    k, n = qweight_t.shape
    x2 = bf16_rows("int8_matmul", x, k)
    check_operands("int8_matmul", x2, (qweight_t, torch.int8), (scales, torch.float32))
    if n % 16 or scales.shape != (n,):
        raise ValueError(f"int8_matmul: the CUDA kernel needs N % 16 == 0 and scales [N], got "
                         f"N = {n}, scales {tuple(scales.shape)}")
    m = x2.shape[0]
    mt = 1 if m <= 16 else 4  # 16 or 64 rows per block
    base = -(-n // 128) * -(-m // (16 * mt))
    splits, per = split_k(base, -(-k // 64), x.device)
    out = torch.empty(m, n, device=x.device, dtype=torch.float32)
    ws = torch.empty(splits, m, n, device=x.device, dtype=torch.float32) if splits > 1 else None
    err = _build.library().mllm_int8_matmul_bf16(
        x2.data_ptr(), qweight_t.data_ptr(), scales.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None, m, k, n, splits, per, mt,
        torch.cuda.current_stream(x.device).cuda_stream)
    launch_or_raise("int8_matmul", err)
    int8_matmul.launches += 1
    return out.reshape(*x.shape[:-1], n)


int8_matmul.launches = 0


TILE_N = 512  # output columns a work item of int4_matmul covers (csrc/int4_matmul.cu kTileN)
STAGE_ROWS = 32  # packed rows a ring stage holds (kStageRows)
X_STAGE_BYTES = 48 * 1024  # shared memory for one staged chunk of x


def int4_grid(mt8: int, sms: int, affine: bool = False) -> int:
    """The blocks int4_matmul keeps resident: two an SM up to 16 rows of x,
    one at 32 (registers) or for the affine law (its zeros make a ring of
    four stages too large for two blocks' shared memory)."""
    return sms * (2 if mt8 <= 2 and not affine else 1)


# The split tiles' cost model (seconds), fitted to tools/int4_tune.py runs on
# "NVIDIA H100 80GB HBM3, 700.00 W": a block streams weights at about
# BLOCK_BPS, the grid at about GRID_BPS; finishing a split tile reads its
# partials at about FINISH_BPS, after ITEM_S of arrival and counter latency.
BLOCK_BPS, GRID_BPS, FINISH_BPS, ITEM_S = 12e9, 3.0e12, 40e9, 2e-6


def int4_plan(m: int, k: int, n: int, sms: int, affine: bool = False) -> tuple[int, int, int, int, int]:
    """(mt8, full, splits, split_rows, chunk_rows) of the int4_matmul kernel:
    8-row tiles of x (1, 2 or 4); the first `full` column tiles of 512 done
    whole, as many as fill whole waves of the grid; the tiles left over each
    divided into `splits` splits of `split_rows` packed rows (multiples of 32)
    whose blocks then add the splits in order, each a share of the tile: the
    count that the cost model above finds fastest, one more wave at most (the
    kernel's cooperative launch needs a resident block for each split item);
    x staged `chunk_rows` packed rows at a time, as many as X_STAGE_BYTES hold
    (the bf16 pairs of both halves for 8 mt8 rows)."""
    khalf = k // 2
    stages = -(-khalf // STAGE_ROWS)
    mt8 = pow2_rows(-(-m // 8), 4)
    tiles = -(-n // TILE_N)
    grid = int4_grid(mt8, sms, affine)
    full = tiles // grid * grid
    rest = tiles - full
    row_bytes = TILE_N + 2 * TILE_N * 4 // GROUP  # a packed row of a tile and its f32 scales

    def cost(splits):
        per = -(-stages // splits) * STAGE_ROWS * row_bytes
        t = max(-(-rest * splits // grid) * per / BLOCK_BPS, rest * stages * STAGE_ROWS * row_bytes / GRID_BPS)
        return t + (ITEM_S + m * TILE_N * 4 * splits / FINISH_BPS if splits > 1 else 0.0)

    splits = min(range(1, min(max(1, grid // rest), stages) + 1), key=cost) if rest else 1
    if splits == 1:
        full = tiles
    split_rows = -(-stages // splits) * STAGE_ROWS
    splits = -(-khalf // split_rows)
    cap = X_STAGE_BYTES // (64 * mt8) // STAGE_ROWS * STAGE_ROWS
    return mt8, full, splits, split_rows, min(stages * STAGE_ROWS, cap)


@functools.cache
def _tile_counters(device: torch.device, tiles: int) -> torch.Tensor:
    """Zeroed u32 counters (two per split column tile) that the kernel leaves
    zeroed after every call: the last block to finish with a tile resets its."""
    return torch.zeros(tiles, device=device, dtype=torch.int32)


def tile_counters(device: torch.device, tiles: int) -> torch.Tensor:
    return _tile_counters(device, max(256, 1 << (tiles - 1).bit_length()))


def int4_matmul(x: torch.Tensor, packed_e8: torch.Tensor, scales_p: torch.Tensor,
                group: int = GROUP, zeros_p: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y[..., N] = x[..., K] @ dequant(canonical int4 operands), f32 out.

    Operands come from `prepare_int4`. On the card, m <= 32 runs the kernel
    on x rounded to bf16; larger m dequantizes the weight to bf16 and runs
    one `torch.mm` with f32 output (the JAX package's fallback route)."""
    if x.device.type == "cpu":
        return int4_matmul_ref(x, packed_e8, scales_p, group, zeros_p)
    k = x.shape[-1]
    khp, n = packed_e8.shape
    m = x.numel() // k
    if m > INT4_KERNEL_MAX_M:
        w = dequant_int4_canonical(packed_e8, scales_p, zeros_p, group, k).to(torch.bfloat16)
        y = torch.mm(x.reshape(-1, k).to(torch.bfloat16), w, out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], n)
    x2 = bf16_rows("int4_matmul", x, k)
    check_operands("int4_matmul", x2, (packed_e8, torch.uint8), (scales_p, torch.float32),
                   (zeros_p, torch.float32))
    if group != GROUP or k % (2 * GROUP) or khp < k // 2 or n % 4:
        raise ValueError(f"int4_matmul: the CUDA kernel needs group {GROUP}, K % 64 == 0, "
                         f"khp >= K/2 and N % 4 == 0; got group {group}, K {k}, khp {khp}, N {n}")
    for t in (scales_p, zeros_p):
        if t is not None and t.shape != (2 * khp // GROUP, n):
            raise ValueError(f"int4_matmul: scales/zeros must be [2*khp/32, N], got {tuple(t.shape)}")
    mt8, full, splits, split_rows, chunk_rows = int4_plan(m, k, n, sm_count(x.device.index or 0),
                                                          zeros_p is not None)
    rest = -(-n // TILE_N) - full
    out = torch.empty(m, n, device=x.device, dtype=torch.float32)
    ws = torch.empty(splits, m, rest * TILE_N, device=x.device, dtype=torch.float32) if rest else None
    counters = tile_counters(x.device, 2 * rest) if rest else None  # arrivals, departures
    if x2.data_ptr() % 16:  # the kernel reads x in 16-byte pieces
        x2 = x2.clone()
    err = _build.library().mllm_int4_matmul_bf16(
        x2.data_ptr(), packed_e8.data_ptr(), scales_p.data_ptr(),
        zeros_p.data_ptr() if zeros_p is not None else None, out.data_ptr(),
        ws.data_ptr() if ws is not None else None, counters.data_ptr() if rest else None, m, k, n, khp,
        full, splits, split_rows, chunk_rows, mt8, torch.cuda.current_stream(x.device).cuda_stream)
    launch_or_raise("int4_matmul", err)
    int4_matmul.launches += 1
    return out.reshape(*x.shape[:-1], n)


int4_matmul.launches = 0
