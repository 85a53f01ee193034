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
outside the Pallas kernel in JAX too). `int8_matmul` runs a kernel at every
m, as the Pallas kernel serves every m: a weight stream up to
INT8_STREAM_MAX_M rows of x, TMA + wgmma above. Each wrapper counts its kernel
launches in `.launches`.

W8A8 (`int8_matmul_a8`): per-token int8 activations times the int8 weights,
an exact s8 x s8 -> s32 product. The JAX package runs it through XLA, not
Pallas, so its counterpart is a torch op: `torch._int_mm` on the card, an
int32 `torch.mm` on the CPU.

The ggml repackers (`repack_q4_0`, `repack_q4_k`, `repack_q8_0`) turn a
checkpoint's Q4_0 / Q4_K / Q8_0 blocks into these layouts at load time,
losslessly for the int4 ones. `int4_take_n` / `int4_take_k` cut canonical
operands by output or input channel (tensor parallelism, head padding), bit
for bit. Not ported: the n-axis int4 layout (on purpose, ROADMAP ground
rules; the canonical layout is cut over tp instead).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from ..core import dtypes as _dt
from . import _build
from ._common import on_cpu, refuse_grad

GROUP = 32  # the int4 kernels' quant group
INT4_KERNEL_MAX_M = 32  # larger m dequantizes and runs one matmul (JAX quant_matmul.py:339)

# ---------------------------------------------------------------------------
# Load-time packers (numpy), byte-identical to the JAX package's numpy branch
# ---------------------------------------------------------------------------


def pack_int4_planar(q: np.ndarray) -> np.ndarray:
    """q: uint8 [N, K] values 0..15 -> planar packed [K/2, N] (the unsigned
    layout of the affine, zero-point path)."""
    n, k = q.shape
    qt = np.ascontiguousarray(q.T)  # [K, N]
    return (qt[: k // 2] | (qt[k // 2 :] << 4)).astype(np.uint8)


def pack_int4_planar_signed(v: np.ndarray) -> np.ndarray:
    """v: int [N, K] values -8..7 -> two's-complement nibbles, planar [K/2, N]."""
    n, k = v.shape
    vt = np.ascontiguousarray(v.T).astype(np.int8)
    lo = (vt[: k // 2] & 0x0F).astype(np.uint8)
    hi = (vt[k // 2 :] & 0x0F).astype(np.uint8)
    return (lo | (hi << 4)).astype(np.uint8)


def _host_f32(w) -> torch.Tensor:
    """A float [N, K] array as an f32 CPU tensor (a read-only mapping is
    only read)."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.as_tensor(np.ascontiguousarray(w, dtype=np.float32))


# The scale of a symmetric quantizer is amax / 127 (int8) or amax / 7 (int4).
# numpy divides (the JAX package's host packers); XLA compiles the same
# division by a constant to a multiplication by the f32 reciprocal (its jitted
# quantizers, and `a8_quantize` below). `recip` picks the second, so either
# side's bits are met. (On a CUDA tensor torch's division by a Python scalar
# is itself a reciprocal multiplication: the dividing rule is for the host.)
_RECIP_127 = 1.0 / 127.0


def _scale(amax: torch.Tensor, qmax: float, recip: bool) -> torch.Tensor:
    s = amax * (1.0 / qmax) if recip else amax / qmax
    return torch.where(amax > 0, s, torch.ones_like(amax))


@torch.no_grad()
def quantize_int8(w: torch.Tensor, recip: bool = False):
    """Per-out-channel symmetric int8 where w lies: float [..., N, K] ->
    (int8 [..., K, N], scales f32 [..., N]); round half to even."""
    wf = w.float()
    sc = _scale(wf.abs().amax(dim=-1), 127.0, recip)
    q = torch.clamp(torch.round(wf / sc[..., None]), -127, 127).to(torch.int8)
    return q.transpose(-1, -2).contiguous(), sc


@torch.no_grad()
def quantize_int4(w: torch.Tensor, group: int = GROUP, recip: bool = False):
    """Symmetric group int4 where w lies: float [..., N, K] -> (packed uint8
    [..., K/2, N] two's-complement nibbles, planar, scales f32 [..., K/G, N])."""
    n, k = w.shape[-2], w.shape[-1]
    lead = w.shape[:-2]
    wg = w.float().reshape(*lead, n, k // group, group)
    sc = _scale(wg.abs().amax(dim=-1), 7.0, recip)
    v = torch.clamp(torch.round(wg / sc[..., None]), -8, 7).to(torch.int8).reshape(*lead, n, k)
    vt = v.transpose(-1, -2)  # [..., K, N]
    lo = (vt[..., : k // 2, :] & 0x0F).to(torch.uint8)
    hi = (vt[..., k // 2 :, :] & 0x0F).to(torch.uint8)
    return (lo | (hi << 4)).contiguous(), sc.transpose(-1, -2).contiguous()


def repack_float_to_int8(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """float [N, K] -> (values [K, N] int8, scales f32 [N]), per out-channel:
    `quantize_int8` on the host's cores, the bytes of the JAX package's numpy
    packer."""
    return tuple(t.numpy() for t in quantize_int8(_host_f32(w)))


def repack_float_to_int4(w: np.ndarray, group: int = GROUP) -> tuple[np.ndarray, np.ndarray]:
    """float [N, K] -> planar int4 (packed [K/2, N] signed nibbles, scales
    f32 [K/G, N]), symmetric: `quantize_int4` on the host's cores, as
    `repack_float_to_int8`."""
    return tuple(t.numpy() for t in quantize_int4(_host_f32(w), group))


def repack_q4_0(raw: np.ndarray, n: int, k: int):
    """ggml Q4_0 rows -> (packed [K/2, N] signed nibbles, scales [K/32, N]).
    Lossless: value = (q - 8) * d."""
    blocks = raw.reshape(n, k // 32, 18)
    d = blocks[..., :2].copy().view(np.float16).astype(np.float32)[..., 0]  # [N, K/32]
    qs = blocks[..., 2:]  # [N, K/32, 16] nibbles: lo = elems 0..15, hi = 16..31
    lo = (qs & 0x0F).astype(np.int8) - 8
    hi = (qs >> 4).astype(np.int8) - 8
    v = np.concatenate([lo, hi], axis=-1).reshape(n, k)  # value = v*d, v in -8..7
    return pack_int4_planar_signed(v), np.ascontiguousarray(d.T)


def repack_q4_k(raw: np.ndarray, n: int, k: int):
    """ggml Q4_K rows -> (packed [K/2, N], scales [K/32, N], zeros [K/32, N]).
    Lossless: value = q * (d * sc) - dmin * m == q * scale + zero a 32-group."""
    flat = raw.reshape(n * (k // 256), 144)
    nb = flat.shape[0]
    d = flat[:, 0:2].copy().view(np.float16).astype(np.float32)[:, 0]
    dmin = flat[:, 2:4].copy().view(np.float16).astype(np.float32)[:, 0]
    sc6, mn6 = _dt._unpack_q4k_scales(flat[:, 4:16])  # [nb, 8] each
    qs = flat[:, 16:144]  # [nb, 128]
    q = np.empty((nb, 256), dtype=np.uint8)
    for chunk in range(4):
        qb = qs[:, chunk * 32 : (chunk + 1) * 32]
        q[:, chunk * 64 : chunk * 64 + 32] = qb & 0x0F
        q[:, chunk * 64 + 32 : chunk * 64 + 64] = qb >> 4
    scales = (d[:, None] * sc6.astype(np.float32)).reshape(n, k // 32)
    zeros = (-(dmin[:, None] * mn6.astype(np.float32))).reshape(n, k // 32)
    return (pack_int4_planar(q.reshape(n, k)), np.ascontiguousarray(scales.T),
            np.ascontiguousarray(zeros.T))


def repack_q8_0(raw: np.ndarray, n: int, k: int):
    """ggml Q8_0 rows -> the int8 layout (values [K, N] int8, scales [N]).
    Q8_0 has a scale a 32-group; the rows are requantized to one scale a row
    for the per-out-channel kernel (error <= 1/254 of a bin)."""
    blocks = raw.reshape(n, k // 32, 34)
    d = blocks[..., :2].copy().view(np.float16).astype(np.float32)[..., 0]  # [N, K/32]
    qs = blocks[..., 2:].copy().view(np.int8).astype(np.float32)  # [N, K/32, 32]
    qv, sc = _dt.quant_q8_per_row_int8((qs * d[..., None]).reshape(n, k))
    return np.ascontiguousarray(qv.T), sc


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


# ---------------------------------------------------------------------------
# Cuts of canonical operands (tensor parallelism, head padding)
# ---------------------------------------------------------------------------


def _zero_where(t: torch.Tensor, drop: torch.Tensor) -> torch.Tensor:
    return torch.where(drop, torch.zeros((), dtype=t.dtype, device=t.device), t)


def int4_take_n(packed_e8: torch.Tensor, scales_p: torch.Tensor, zeros_p: Optional[torch.Tensor],
                index) -> tuple:
    """Canonical operands holding the output channels `index` (natural n, or
    -1 for a zero channel: nibbles, scale and zero all 0, which dequantize to
    exactly 0 in both the symmetric and the affine law), in that order."""
    index = np.asarray(index)
    idx = torch.as_tensor(np.maximum(index, 0), device=packed_e8.device)
    drop = torch.as_tensor(index < 0, device=packed_e8.device)[None, :]
    return tuple(None if t is None else _zero_where(t.index_select(1, idx), drop).contiguous()
                 for t in (packed_e8, scales_p, zeros_p))


def int4_natural(packed_e8: torch.Tensor, scales_p: torch.Tensor, zeros_p: Optional[torch.Tensor],
                 group: int, k: int) -> tuple:
    """Canonical operands over K -> (nibbles uint8 [K, N] in natural k order,
    scales [K/G, N], zeros [K/G, N] or None): the padded rows dropped, the
    nibbles as stored (excess-8 when zeros is None)."""
    kh = k // 2
    ng, ngh = kh // group, packed_e8.shape[0] // group
    rows = packed_e8[:kh]
    q = torch.cat([rows & 0x0F, rows >> 4])
    return (q, *(None if t is None else torch.cat([t[:ng], t[ngh:ngh + ng]]) for t in (scales_p, zeros_p)))


def int4_canonical(q: torch.Tensor, scales: torch.Tensor, zeros: Optional[torch.Tensor], group: int) -> tuple:
    """`int4_natural`'s inverse: natural nibbles [K, N] and group rows [K/G, N]
    -> canonical (packed [khp, N], scales [2*khp/G, N], zeros or None), padded
    by `prepare_int4`'s rule (zero rows, zero scales and zeros)."""
    k, n = q.shape
    kh = k // 2
    _, khp = _pick_int4_pad(kh)
    ng, pad = kh // group, khp - kh
    packed = torch.cat([q[:kh] | (q[kh:] << 4), q.new_zeros(pad, n)])

    def planar(t):
        z = t.new_zeros(pad // group, n)
        return torch.cat([t[:ng], z, t[ng:], z]).contiguous()

    return packed.contiguous(), planar(scales), None if zeros is None else planar(zeros)


def int4_take_k(packed_e8: torch.Tensor, scales_p: torch.Tensor, zeros_p: Optional[torch.Tensor],
                group: int, k: int, index) -> tuple:
    """Canonical operands over K whose input channels are `index` (natural k
    of the K given, or -1 for a zero channel), re-laid over K' = len(index):
    the natural nibbles and group rows gathered, then planar halves and
    padding planned anew for K' (a K range of rank r straddles the nibble
    halves of the whole: at tp 2, rank 0 owns every low nibble). Each aligned
    run of `group` entries must be one whole group of K or all -1, and K' a
    multiple of 2 * group (the canonical halves hold whole groups); the
    values stay bit for bit. A zero channel's scale (and zero) is 0."""
    index = np.asarray(index)
    kn = len(index)
    runs = index.reshape(-1, group) if kn % (2 * group) == 0 else None
    if runs is None or not all((r < 0).all() or (r[0] % group == 0 and (r == r[0] + np.arange(group)).all())
                               for r in runs):
        raise ValueError(f"int4_take_k: the channels taken must be whole groups of {group} (or zero runs) and "
                         f"their number a multiple of {2 * group}; got {kn} channels")
    dev = packed_e8.device
    q, s, z = int4_natural(packed_e8, scales_p, zeros_p, group, k)
    take = lambda t, ix: _zero_where(t.index_select(0, torch.as_tensor(np.maximum(ix, 0), device=dev)),  # noqa: E731
                                     torch.as_tensor(ix < 0, device=dev)[:, None])
    g = np.where(runs[:, 0] < 0, -1, runs[:, 0] // group)
    return int4_canonical(take(q, index), take(s, g), None if z is None else take(z, g), group)


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


INT8_STREAM_MAX_M = 32  # int8_matmul streams the weight up to this m, above it runs the wgmma kernel


def int8_matmul(x: torch.Tensor, qweight_t: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """y[..., N] = x[..., K] @ (qweight_t[K, N] * scales[None, :]), f32 out.

    On the card x is rounded to bf16 (as the JAX wrapper does); m <=
    INT8_STREAM_MAX_M runs the weight-stream kernel (plan `int8_plan`), larger
    m the TMA + wgmma kernel (plan `int8_gemm_plan`), prefill included."""
    if on_cpu(x):
        return int8_matmul_ref(x, qweight_t, scales)
    refuse_grad("int8_matmul", x, scales)
    k, n = qweight_t.shape
    x2 = bf16_rows("int8_matmul", x, k)
    check_operands("int8_matmul", x2, (qweight_t, torch.int8), (scales, torch.float32))
    if n % 16 or scales.shape != (n,):
        raise ValueError(f"int8_matmul: the CUDA kernel needs N % 16 == 0 and scales [N], got "
                         f"N = {n}, scales {tuple(scales.shape)}")
    m = x2.shape[0]
    out = torch.empty(m, n, device=x.device, dtype=torch.float32)
    if m == 0:
        return out.reshape(*x.shape[:-1], n)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if m > INT8_STREAM_MAX_M:
        dev = x.device.index or 0
        bm, cluster, kper, clusters = int8_gemm_plan(m, k, n, sm_count(dev),
                                                     lambda bm, c: max_clusters(dev, bm, 0, 0, c, 0))
        err = _build.library().mllm_int8_gemm_bf16(x2.data_ptr(), qweight_t.data_ptr(), scales.data_ptr(),
                                                   out.data_ptr(), m, k, n, bm, cluster, kper, clusters, stream)
    else:
        dev = x.device.index or 0
        mt8 = pow2_rows(-(-m // 8), 4)
        mt8, tn, cluster, rows_per, clusters = int8_plan(
            m, k, n, sm_count(dev), lambda tn, c, rows: max_clusters(dev, 0, mt8, tn, c, rows))
        err = _build.library().mllm_int8_matmul_bf16(
            x2.data_ptr(), qweight_t.data_ptr(), scales.data_ptr(), out.data_ptr(), m, k, n, tn, cluster,
            rows_per, clusters, mt8, stream)
    launch_or_raise("int8_matmul", err)
    int8_matmul.launches += 1
    return out.reshape(*x.shape[:-1], n)


int8_matmul.launches = 0


A8_MIN_ROWS = 17  # torch._int_mm on a card takes more than 16 rows of x


def a8_amax(x: torch.Tensor, k: int) -> torch.Tensor:
    """max |x| of each token of x [..., K], f32 [m, 1] (exact in x's dtype)."""
    return torch.linalg.vector_norm(x.reshape(-1, k), ord=float("inf"), dim=-1, keepdim=True).float()


def a8_quantize(x: torch.Tensor, k: int, amax: torch.Tensor | None = None):
    """Per-token symmetric int8: x [..., K] -> (int8 [m, K], f32 scales [m, 1]).
    The scale is amax * f32(1/127), as XLA compiles the JAX package's
    `amax / 127.0` under jit; `amax` defaults to `a8_amax(x, k)` (a
    row-parallel caller passes the whole row's). The division widens x to
    f32 as it reads it: four passes over x, no f32 copy of it."""
    x2 = x.reshape(-1, k)
    if amax is None:
        amax = a8_amax(x2, k)
    xs = torch.where(amax > 0, amax * _RECIP_127, torch.ones_like(amax))
    return torch.div(x2, xs).round_().clamp_(-127, 127).to(torch.int8), xs



def int8_matmul_a8(x: torch.Tensor, qweight_nk: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """W8A8: y[..., N] = (int8(x) @ qweight_nk.T) * x_scale * scales, f32 out.

    Per-token scales amax/127, x rounded and clipped to int8, an exact
    s8 x s8 -> s32 product (k * 127^2 < 2^31 for every k of the model zoo),
    then both scales on the f32 result (JAX `int8_matmul_a8`, which takes the
    [K, N] weight). The weight is [N, K], K-contiguous: `torch._int_mm` takes
    that layout 5.4-7.1x faster than [K, N] on an H100 (tools/a8_split.py;
    PERF.md, PR 11). On the card the product is `torch._int_mm`, which takes
    more than 16 rows and K, N multiples of 8: fewer rows are padded with zero
    rows and sliced off. On the CPU it is an int32 `torch.mm`."""
    n, k = qweight_nk.shape
    xq, xs = a8_quantize(x, k)
    return a8_scale(a8_int_product(xq, qweight_nk), xs, scales).reshape(*x.shape[:-1], n)


def a8_int_product(xq: torch.Tensor, qweight_nk: torch.Tensor) -> torch.Tensor:
    """The exact s8 x s8 -> s32 product xq [m, K] @ qweight_nk[N, K].T."""
    n, k = qweight_nk.shape
    m = xq.shape[0]
    if xq.device.type == "cpu":
        return xq.to(torch.int32) @ qweight_nk.to(torch.int32).t()
    if k % 8 or n % 8:
        raise ValueError(f"int8_matmul_a8: torch._int_mm needs K and N multiples of 8, got K = {k}, "
                         f"N = {n}")
    if m < A8_MIN_ROWS:
        xq = torch.cat([xq, xq.new_zeros(A8_MIN_ROWS - m, k)])
    return torch._int_mm(xq, qweight_nk.t())[:m]


def a8_scale(acc: torch.Tensor, xs: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(f32(acc) * xs) * scales, two passes: the W8A8 product's f32 result."""
    return torch.mul(acc, xs).mul_(scales.float()[None, :])


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


INT8_STAGES = 4  # ring stages of 32 k-rows (csrc/int8_matmul.cu kStages)
INT8_MAX_CLUSTER = 16  # K splits of a column tile: the H100's largest (non-portable) cluster
SMEM_PER_SM, SMEM_PER_BLOCK = 233472, 232448  # H100: bytes an SM holds, a block may take
# int8_matmul's stream model (seconds), fitted to tools/int4_tune.py --kernel
# int8 runs on "NVIDIA H100 80GB HBM3, 700.00 W": an SM streams weights at
# about SM_BPS with two blocks on it, SM_BPS_ONE with one; the card at about
# GRID_BPS; a round of a cluster's column tiles costs ROUND_S, a cluster's
# reduction through DSMEM REDUCE_S.
SM_BPS, SM_BPS_ONE, ROUND_S, REDUCE_S = 24e9, 20e9, 0.2e-6, 3.5e-6


def int8_blocks_per_sm(mt8: int) -> int:
    """Blocks of int8_matmul's stream an SM holds: two up to 16 rows of x, one
    at 32 (registers)."""
    return 2 if mt8 <= 2 else 1


def int8_x_rows_cap(mt8: int, tn: int) -> int:
    """The most k-rows of x (a multiple of 32) one block of the stream can
    stage beside its ring and its partial tile, at int8_blocks_per_sm(mt8)
    blocks an SM (1 KB an SM is the system's)."""
    per = int8_blocks_per_sm(mt8)
    budget = min(SMEM_PER_BLOCK, SMEM_PER_SM // per - 1024)
    budget -= INT8_STAGES * STAGE_ROWS * (tn + 32) + 8 * mt8 * tn * 4 + tn * 4 + 1024
    return max(0, budget // (16 * mt8)) // STAGE_ROWS * STAGE_ROWS


def int8_plan(m: int, k: int, n: int, sms: int, capacity=None) -> tuple[int, int, int, int, int]:
    """(mt8, tn, cluster, rows_per, clusters) of int8_matmul's stream (m <=
    INT8_STREAM_MAX_M): 8-row tiles of x (1, 2 or 4); column tiles of tn (256
    or 512) owned by clusters of `cluster` CTAs, rank r of a cluster streaming
    the k-rows [r rows_per, (r + 1) rows_per) of each (rows_per a multiple of
    32, x for them staged once, every rank some rows); `clusters` clusters, at
    most as many as the tiles and as the card keeps resident at once
    (`capacity(tn, cluster, rows_per)`, the kernel's occupancy query on the
    card; by default the blocks the SMs hold, which ignores how clusters pack
    into GPCs), each taking tiles cid, cid + clusters, ... The pair (tn,
    cluster) is the one the model above finds fastest: the bytes the busiest
    SM streams in each round, the bytes of the whole product at GRID_BPS, and
    the rounds and reductions."""
    mt8 = pow2_rows(-(-m // 8), 4)
    per_sm = int8_blocks_per_sm(mt8)
    stages = -(-k // STAGE_ROWS)
    best = None
    for tn in (512, 256):
        tiles = -(-n // tn)
        cap = int8_x_rows_cap(mt8, tn)
        for cluster in range(1, INT8_MAX_CLUSTER + 1):
            rows_per = -(-stages // cluster) * STAGE_ROWS
            if rows_per > cap or (cluster - 1) * rows_per >= k:
                continue
            resident = capacity(tn, cluster, rows_per) if capacity else sms * per_sm // cluster
            if resident < 1:
                continue
            clusters = min(tiles, resident)
            rounds = -(-tiles // clusters)
            on_sm = -(-clusters * cluster // sms)  # blocks sharing the busiest SM
            rate = SM_BPS if on_sm > 1 else SM_BPS_ONE
            t = max(rounds * on_sm * rows_per * tn / rate, k * n / GRID_BPS)
            t += rounds * ROUND_S + (REDUCE_S * rounds if cluster > 1 else 0.0)
            if best is None or t < best[0]:
                best = (t, (mt8, tn, cluster, rows_per, clusters))
    if best is None:
        raise ValueError(f"int8_matmul: no stream plan for m={m}, K={k}, N={n}")
    return best[1]


@functools.cache
def max_clusters(device_index: int, gemm: int, mt8: int, tn: int, cluster: int, rows_per: int) -> int:
    """The clusters of `cluster` CTAs of an int8_matmul kernel the card keeps
    resident at once (cudaOccupancyMaxActiveClusters): the wgmma kernel with
    tiles of `gemm` rows of x (128 or 256), or (gemm 0) the stream <mt8, tn>
    with rows_per k-rows of x staged."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _build.library().mllm_int8_max_clusters(gemm, mt8, tn, cluster, rows_per, ctypes.addressof(out))
    launch_or_raise("int8_matmul (occupancy)", err)
    return out.value


GEMM_BN, GEMM_BK = 128, 64  # int8_matmul's wgmma tile: columns and k-depth (csrc/int8_matmul.cu gemm::kBN, kBK)
GEMM_MAX_CLUSTER = 8  # K splits of a tile: the portable cluster size
# its model (seconds), from tools/int4_tune.py --kernel int8 runs on "NVIDIA
# H100 80GB HBM3, 700.00 W": a k-tile of a 256 x 128 tile (half that at 128
# rows), a tile's epilogue, a K-split tile's reduction through DSMEM
GEMM_KTILE_S, GEMM_TILE_S, GEMM_REDUCE_S = 0.6e-6, 1.5e-6, 2e-6


def int8_gemm_plan(m: int, k: int, n: int, sms: int, capacity=None) -> tuple[int, int, int, int]:
    """(bm, cluster, kper, clusters) of int8_matmul's wgmma kernel (m >
    INT8_STREAM_MAX_M): output tiles of bm rows (wgmma n256, or n128 when m <=
    128) x 128 columns walked by `clusters` clusters of `cluster` CTAs (one
    CTA an SM; at most `capacity(bm, cluster)` clusters, the occupancy query
    on the card, by default sms // cluster), rank r of a cluster taking the
    k-tiles [r kper, (r + 1) kper) of 64 and the ranks' partials added through
    DSMEM: the cluster size the model above finds fastest (K splits fill the
    card when the tiles are few; every rank gets k-tiles)."""
    bm = 128 if m <= 128 else 256
    tiles = -(-m // bm) * -(-n // GEMM_BN)
    ktiles = -(-k // GEMM_BK)
    kt_s = GEMM_KTILE_S * bm / 256
    best = None
    for cluster in range(1, GEMM_MAX_CLUSTER + 1):
        kper = -(-ktiles // cluster)
        if (cluster - 1) * kper >= ktiles:
            continue
        resident = capacity(bm, cluster) if capacity else sms // cluster
        if resident < 1:
            continue
        clusters = min(tiles, resident)
        waves = -(-tiles // clusters)
        t = waves * (kper * kt_s + GEMM_TILE_S + (GEMM_REDUCE_S if cluster > 1 else 0.0))
        if best is None or t < best[0]:
            best = (t, (bm, cluster, kper, clusters))
    return best[1]


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
    if on_cpu(x):
        return int4_matmul_ref(x, packed_e8, scales_p, group, zeros_p)
    refuse_grad("int4_matmul", x, scales_p, zeros_p)
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
