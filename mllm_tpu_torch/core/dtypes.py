"""Data types of the `.mllm` weight container, including ggml-style quantized
block formats, with their numpy decoders and encoders: a copy of
`mllm_tpu/core/dtypes.py` (numpy only), kept in the port so that it imports
nothing of the JAX package.

Parity notes (reference: yirongjie/mllm):
  - DataType enum values mirror mllm/Types.hpp:63-97 so `.mllm`
    files written by the reference toolchain load unchanged.
  - Block layouts mirror the ggml definitions vendored by the reference at
    mllm/backends/cpu/third_party/ggml/ (block_q4_0 et al.).

Quantized weights are kept as packed uint8 arrays (the raw bytes from the
container) and either decoded once at load time into float arrays, or
repacked losslessly into the int4 / int8 kernels' layouts
(`mllm_tpu_torch/ops/quant_matmul.py` `repack_q4_0` / `repack_q4_k` /
`repack_q8_0`). The JAX package's optional native decoders are not copied:
every format decodes through the numpy functions below.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np


class DataType(enum.IntEnum):
    """Matches the reference's C enum numerically (Types.hpp:63-97)."""

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    Q8_0 = 8
    Q8_1 = 9
    Q8_PER_TENSOR = 10
    Q4_K = 12
    Q6_K = 14
    Q8_K = 15
    I8 = 16
    I16 = 17
    I32 = 18
    Q4_0_4_4 = 19
    Q4_0_4_8 = 20
    Q4_0_8_8 = 21
    Q8_0_4_4 = 22
    Q3_K = 23
    Q2_K = 24
    Q1_K = 25
    IQ2_XXS = 26
    IQ2_XS = 27
    IQ1_S = 28
    IQ1_M = 29
    IQ2_S = 30
    KLEIDIAI_Q4_0 = 31
    Q8_0F = 32
    Q2_0 = 33


# Block sizes: (elements_per_block, bytes_per_block).
QK4_0 = 32
QK8_0 = 32
QK_K = 256  # k-quant super-block

_BLOCK_INFO: dict[DataType, tuple[int, int]] = {
    DataType.F32: (1, 4),
    DataType.F16: (1, 2),
    DataType.I8: (1, 1),
    DataType.I16: (1, 2),
    DataType.I32: (1, 4),
    DataType.Q4_0: (QK4_0, 2 + QK4_0 // 2),  # fp16 d + 16B nibbles = 18
    DataType.Q4_1: (QK4_0, 4 + QK4_0 // 2),  # fp16 d + fp16 m + 16B = 20
    DataType.Q8_0: (QK8_0, 2 + QK8_0),  # fp16 d + 32 int8 = 34
    DataType.Q8_0F: (QK8_0, 4 + QK8_0),  # fp32 d + 32 int8 = 36
    DataType.Q4_K: (QK_K, 2 + 2 + 12 + QK_K // 2),  # d, dmin, scales, qs = 144
    DataType.Q6_K: (QK_K, QK_K // 2 + QK_K // 4 + QK_K // 16 + 2),  # = 210
    DataType.Q8_K: (QK_K, 4 + QK_K + QK_K // 16 * 2),  # fp32 d, 256 q, 16 bsums
    DataType.Q2_K: (QK_K, QK_K // 16 + QK_K // 4 + 2 + 2),  # scales, qs, d, dmin = 84
    DataType.Q3_K: (QK_K, QK_K // 8 + QK_K // 4 + 12 + 2),  # hmask, qs, scales, d = 110
    DataType.Q2_0: (32, 2 + 8),  # fp16 d + 8B (32 x 2-bit)
    DataType.IQ2_XXS: (QK_K, 2 + QK_K // 8 * 2),  # fp16 d + 32 uint16 = 66
}


@dataclass(frozen=True)
class BlockSpec:
    elems: int
    nbytes: int


def block_spec(dt: DataType) -> BlockSpec:
    if dt not in _BLOCK_INFO:
        raise NotImplementedError(f"no block spec for {dt!r}")
    e, b = _BLOCK_INFO[dt]
    return BlockSpec(e, b)


def nbytes_for(dt: DataType, n_elems: int) -> int:
    """Byte size of `n_elems` elements stored as dtype `dt` (row-major blocks)."""
    spec = block_spec(dt)
    if n_elems % spec.elems != 0:
        raise ValueError(f"{n_elems} not a multiple of block size {spec.elems} for {dt!r}")
    return n_elems // spec.elems * spec.nbytes


def is_quantized(dt: DataType) -> bool:
    return dt not in (
        DataType.F32,
        DataType.F16,
        DataType.I8,
        DataType.I16,
        DataType.I32,
    )


# ---------------------------------------------------------------------------
# NumPy dequantization (load-time path). Vectorized; the plain dequant that
# the repacked int4 / int8 operands are checked against.
# ---------------------------------------------------------------------------


def _f16(buf: np.ndarray) -> np.ndarray:
    return buf.view(np.float16).astype(np.float32)


def dequant_q4_0(raw: np.ndarray, n_elems: int) -> np.ndarray:
    blocks = raw.reshape(-1, 18)
    d = _f16(blocks[:, :2].copy())[:, 0]  # [nb]
    qs = blocks[:, 2:]  # [nb, 16]
    lo = (qs & 0x0F).astype(np.int8) - 8
    hi = (qs >> 4).astype(np.int8) - 8
    # ggml layout: x[i] = lo[i], x[i+16] = hi[i]
    vals = np.concatenate([lo, hi], axis=1).astype(np.float32)  # [nb, 32]
    return (vals * d[:, None]).reshape(-1)[:n_elems]


def dequant_q8_0(raw: np.ndarray, n_elems: int) -> np.ndarray:
    blocks = raw.reshape(-1, 34)
    d = _f16(blocks[:, :2].copy())[:, 0]
    qs = blocks[:, 2:].view(np.int8).astype(np.float32)
    return (qs * d[:, None]).reshape(-1)[:n_elems]


def _unpack_q4_0_nr_bl(raw: np.ndarray, n_per_row: int, nri: int, bsi: int) -> np.ndarray:
    """Un-interleave GemmPack's row-interleaved Q4_0 into plain Q4_0 blocks.

    Inverse of the reference's `quantize_q4_0_nr_bl` / `make_block_q4_0x{4,8}`
    (GemmPack.cpp:45-74,311-344): rows are grouped in `nri`, each group stores
    per 32-col block one struct of `nri` fp16 deltas followed by the groups'
    nibble bytes interleaved in runs of `bsi` and XOR'd with 0x88 (sign form).
    Returns plain ggml Q4_0 block bytes in row-major row order.
    """
    qk_half = QK4_0 // 2  # 16 nibble-bytes per row per block
    struct_bytes = nri * 2 + nri * qk_half
    structs = raw.reshape(-1, struct_bytes)  # [(nrow/nri)*nb, struct]
    d = structs[:, : nri * 2]  # fp16 deltas, one per interleaved row
    qs = structs[:, nri * 2 :] ^ 0x88  # undo sign-form xor -> biased nibbles
    # out.qs[i] = in[src_id].qs[(i // (nri*bsi)) * bsi + i % bsi],
    # src_id = (i % (nri*bsi)) // bsi  -> reshape [runs, src_id, bsi]
    qs = qs.reshape(-1, qk_half // bsi, nri, bsi)
    qs = qs.transpose(0, 2, 1, 3).reshape(-1, nri, qk_half)  # [structs, row, 16]
    out = np.empty((structs.shape[0], nri, 2 + qk_half), np.uint8)
    out[:, :, :2] = d.reshape(-1, nri, 2)
    out[:, :, 2:] = qs
    # struct order is (row_group, block); row-major rows need (row_group, row, block)
    nb = n_per_row // QK4_0
    return out.reshape(-1, nb, nri, 2 + qk_half).transpose(0, 2, 1, 3).reshape(-1)


def dequant_q4_0_4x4(raw: np.ndarray, n_elems: int, n_per_row: int) -> np.ndarray:
    """Dequantize the reference's Q4_0_4_4 (4-row × 4-byte interleaved Q4_0).

    This is the format `tools/quantizer` writes for MLLM_TYPE_Q4_0_4_4
    (main_quantize.cpp:49-50 -> GemmPack.cpp quantize_row_q4_0_4x4) for ARM
    KleidiAI/i8mm microkernels; here it is un-interleaved at load time.
    """
    if n_per_row % QK4_0 or n_elems % (4 * n_per_row):
        raise ValueError(f"Q4_0_4_4 needs rows%4==0 and row width %32==0, got "
                         f"{n_elems} elems / {n_per_row} per row")
    return dequant_q4_0(_unpack_q4_0_nr_bl(raw, n_per_row, 4, 4), n_elems)


def dequant_q4_0_4x8(raw: np.ndarray, n_elems: int, n_per_row: int) -> np.ndarray:
    return dequant_q4_0(_unpack_q4_0_nr_bl(raw, n_per_row, 4, 8), n_elems)


def dequant_q4_0_8x8(raw: np.ndarray, n_elems: int, n_per_row: int) -> np.ndarray:
    return dequant_q4_0(_unpack_q4_0_nr_bl(raw, n_per_row, 8, 8), n_elems)


def dequant_q8_0f(raw: np.ndarray, n_elems: int) -> np.ndarray:
    blocks = raw.reshape(-1, 36)
    d = blocks[:, :4].copy().view(np.float32)[:, 0]
    qs = blocks[:, 4:].view(np.int8).astype(np.float32)
    return (qs * d[:, None]).reshape(-1)[:n_elems]


def _unpack_q4k_scales(sc: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Unpack the 12-byte 6-bit scale/min fields of a Q4_K/Q5_K super-block.

    sc: [nb, 12] uint8 -> (scales [nb, 8], mins [nb, 8]) uint8 (6-bit values).
    Mirrors ggml get_scale_min_k4.
    """
    nb = sc.shape[0]
    scales = np.empty((nb, 8), dtype=np.uint8)
    mins = np.empty((nb, 8), dtype=np.uint8)
    for j in range(8):
        if j < 4:
            scales[:, j] = sc[:, j] & 63
            mins[:, j] = sc[:, j + 4] & 63
        else:
            scales[:, j] = (sc[:, j + 4] & 0x0F) | ((sc[:, j - 4] >> 6) << 4)
            mins[:, j] = (sc[:, j + 4] >> 4) | ((sc[:, j] >> 6) << 4)
    return scales, mins


def dequant_q4_k(raw: np.ndarray, n_elems: int) -> np.ndarray:
    blocks = raw.reshape(-1, 144)
    nb = blocks.shape[0]
    d = _f16(blocks[:, 0:2].copy())[:, 0]  # super scale
    dmin = _f16(blocks[:, 2:4].copy())[:, 0]  # super min
    scales, mins = _unpack_q4k_scales(blocks[:, 4:16])
    qs = blocks[:, 16:]  # [nb, 128]
    out = np.empty((nb, 256), dtype=np.float32)
    # 4 chunks of 32 bytes; each yields two 32-elem halves (lo, hi nibbles)
    for chunk in range(4):
        q = qs[:, chunk * 32 : (chunk + 1) * 32]
        lo = (q & 0x0F).astype(np.float32)
        hi = (q >> 4).astype(np.float32)
        s_lo = (d * scales[:, 2 * chunk].astype(np.float32))[:, None]
        m_lo = (dmin * mins[:, 2 * chunk].astype(np.float32))[:, None]
        s_hi = (d * scales[:, 2 * chunk + 1].astype(np.float32))[:, None]
        m_hi = (dmin * mins[:, 2 * chunk + 1].astype(np.float32))[:, None]
        out[:, chunk * 64 : chunk * 64 + 32] = lo * s_lo - m_lo
        out[:, chunk * 64 + 32 : chunk * 64 + 64] = hi * s_hi - m_hi
    return out.reshape(-1)[:n_elems]


def dequant_q6_k(raw: np.ndarray, n_elems: int) -> np.ndarray:
    blocks = raw.reshape(-1, 210)
    nb = blocks.shape[0]
    ql = blocks[:, 0:128]
    qh = blocks[:, 128:192]
    sc = blocks[:, 192:208].view(np.int8)
    d = _f16(blocks[:, 208:210].copy())[:, 0]
    out = np.empty((nb, 256), dtype=np.float32)
    # ggml dequantize_row_q6_K: two 128-elem halves per super-block
    for half in range(2):
        ql_h = ql[:, half * 64 : half * 64 + 64]
        qh_h = qh[:, half * 32 : half * 32 + 32]
        sc_h = sc[:, half * 8 : half * 8 + 8].astype(np.float32)
        for l in range(32):
            is_ = l // 16
            q1 = ((ql_h[:, l] & 0xF) | (((qh_h[:, l] >> 0) & 3) << 4)).astype(np.int8) - 32
            q2 = ((ql_h[:, l + 32] & 0xF) | (((qh_h[:, l] >> 2) & 3) << 4)).astype(np.int8) - 32
            q3 = ((ql_h[:, l] >> 4) | (((qh_h[:, l] >> 4) & 3) << 4)).astype(np.int8) - 32
            q4 = ((ql_h[:, l + 32] >> 4) | (((qh_h[:, l] >> 6) & 3) << 4)).astype(np.int8) - 32
            base = half * 128
            out[:, base + l] = d * sc_h[:, is_] * q1
            out[:, base + l + 32] = d * sc_h[:, is_ + 2] * q2
            out[:, base + l + 64] = d * sc_h[:, is_ + 4] * q3
            out[:, base + l + 96] = d * sc_h[:, is_ + 6] * q4
    return out.reshape(-1)[:n_elems]


def dequant_q8_k(raw: np.ndarray, n_elems: int) -> np.ndarray:
    spec = block_spec(DataType.Q8_K)
    blocks = raw.reshape(-1, spec.nbytes)
    d = blocks[:, 0:4].copy().view(np.float32)[:, 0]
    qs = blocks[:, 4 : 4 + 256].view(np.int8).astype(np.float32)
    return (qs * d[:, None]).reshape(-1)[:n_elems]


def dequant_q2_k(raw: np.ndarray, n_elems: int) -> np.ndarray:
    blocks = raw.reshape(-1, 84)
    nb = blocks.shape[0]
    scales = blocks[:, 0:16]
    qs = blocks[:, 16:80]
    d = _f16(blocks[:, 80:82].copy())[:, 0]
    dmin = _f16(blocks[:, 82:84].copy())[:, 0]
    out = np.empty((nb, 256), dtype=np.float32)
    # 2 halves of 128; within each: 4 shifts x 32 elems, 2 sub-scales per 32
    for half in range(2):
        q = qs[:, half * 32 : half * 32 + 32]
        for shift in range(4):
            qv = ((q >> (2 * shift)) & 3).astype(np.float32)  # [nb, 32]
            for sub in range(2):
                isc = half * 8 + shift * 2 + sub
                sc = scales[:, isc]
                dl = (d * (sc & 0xF).astype(np.float32))[:, None]
                ml = (dmin * (sc >> 4).astype(np.float32))[:, None]
                idx = half * 128 + shift * 32 + sub * 16
                out[:, idx : idx + 16] = qv[:, sub * 16 : sub * 16 + 16] * dl - ml
    return out.reshape(-1)[:n_elems]


def dequant_q3_k(raw: np.ndarray, n_elems: int) -> np.ndarray:
    blocks = raw.reshape(-1, 110)
    nb = blocks.shape[0]
    hmask = blocks[:, 0:32]
    qs = blocks[:, 32:96]
    scales_raw = blocks[:, 96:108]
    d = _f16(blocks[:, 108:110].copy())[:, 0]
    # unpack 16 6-bit scales from 12 bytes (ggml kmask scheme)
    aux = np.empty((nb, 16), dtype=np.int8)
    a = scales_raw[:, 0:8]
    b = scales_raw[:, 8:12]
    # ggml: scales[i] for i<8 from low nibbles, i>=8 high nibbles; high 2 bits from b
    for j in range(8):
        aux[:, j] = ((a[:, j] & 0xF) | (((b[:, j % 4] >> (2 * (j // 4))) & 3) << 4)).astype(np.int8) - 32
        aux[:, j + 8] = ((a[:, j] >> 4) | (((b[:, j % 4] >> (2 * (j // 4 + 2))) & 3) << 4)).astype(np.int8) - 32
    out = np.empty((nb, 256), dtype=np.float32)
    for half in range(2):
        q = qs[:, half * 32 : half * 32 + 32]
        for shift in range(4):
            qv = ((q >> (2 * shift)) & 3).astype(np.int8)
            hbit = half * 4 + shift
            hm = ((hmask >> hbit) & 1).astype(np.int8)
            qv = qv - ((1 - hm) << 2)  # subtract 4 where high bit NOT set
            for sub in range(2):
                isc = half * 8 + shift * 2 + sub
                dl = (d * aux[:, isc].astype(np.float32))[:, None]
                idx = half * 128 + shift * 32 + sub * 16
                out[:, idx : idx + 16] = qv[:, sub * 16 : sub * 16 + 16].astype(np.float32) * dl
    return out.reshape(-1)[:n_elems]


def dequant_q2_0(raw: np.ndarray, n_elems: int) -> np.ndarray:
    """mllm Q2_0 (DataType.hpp:30-35): fp16 d + 32 x 2-bit, value = (q - 2) * d.

    Dequant semantics: backends/cpu/third_party/ggml/QuantizeQ2.cpp:67-84."""
    blocks = raw.reshape(-1, 10)
    d = _f16(blocks[:, :2].copy())[:, 0]  # [nb]
    qs = blocks[:, 2:]  # [nb, 8], 4 values per byte
    shifts = np.arange(4, dtype=np.uint8) * 2
    q = ((qs[:, :, None] >> shifts[None, None, :]) & 3).astype(np.int8) - 2  # [nb,8,4]
    out = q.reshape(-1, 32).astype(np.float32) * d[:, None]
    return out.reshape(-1)[:n_elems]


# IQ2_XXS codebook: 256 rows of 8 values from {8, 25, 43} (E8-lattice grid,
# ggml iq2xxs_grid — a data table required for bit-compatibility, stored
# base-3-packed: 2 bits per digit, value = (8, 25, 43)[digit]).
_IQ2XXS_GRID_PACKED = (
    "AAACAAUACAAKABEAFAAgACIAKAAqAEEARABQAFgAYQBkAIAAggCKAKIAAQEEARABFQFAAYQB"
    "mAEAAgICIgKCAgEEBAQQBCEEJARABEIESARgBIEEhASQBKQEAAUCBQgFIAVGBWkFgAWRBQkG"
    "EAZABoQGpAYACAUICAgUCCgIQQhECFAIUgiICAQJQAkCChQKARAEEBAQIRBAEGAQhBCQEJUQ"
    "ABEIESARUBFaEYARJBJFEgAUCBQgFCUUSRSAFBgVYhUAFhYWARgEGBAYQBiBGAAZBRmgGVEa"
    "ACACIAogRCBhIIAggiApIUghACICIgEkBCQQJEAkViQAJUElZCWQJggoICiUKEQqAUAEQBBA"
    "GEAhQCRAQEBIQFZAYECBQIRAkEAAQSBBYUGAQYVBAUIQQkhCVkJoQgBECEQgRIBEmUQSRSRF"
    "AEYBSARIEEhASEVIAElYSWFJgklFSpBKAFAIUBFQGVAgUIBQiFAEUUJRpFGRUpBUklQKVQFW"
    "VFYAWBFYGVhkWEBZCFoEYBBgQGBoYABhVWEYYmBiAGQFZBBlEmWEZUJoAIACgAqAQYCCgASB"
    "GIFAgRGCAYQEhBCEFYRAhGCEAIVGhZSFCYZAhmCGAogEiRGKBJAQkCSQQJChkBaRgJFFkgCU"
    "IpRElFGVgZggmQKgUKCFoAmhAKIYpFCoBKk="
)


def _iq2xxs_grid() -> np.ndarray:
    """Decode the packed codebook -> uint8 [256, 8]."""
    import base64

    packed = np.frombuffer(base64.b64decode(_IQ2XXS_GRID_PACKED), np.uint8)
    digits = np.stack([(packed >> (2 * i)) & 3 for i in range(4)], axis=1).reshape(-1)
    return np.array([8, 25, 43], np.uint8)[digits].reshape(256, 8)


def dequant_iq2_xxs(raw: np.ndarray, n_elems: int) -> np.ndarray:
    """ggml IQ2_XXS (DataType.hpp:49-53: fp16 d + 32 uint16 per 256 elems).

    Per 32-group: 8 bytes = 4 grid-row indices + 4 x 7-bit sign codes +
    4-bit scale; value = d*(0.5+scale)*0.25 * grid * sign
    (QuantizeQ2.cpp:579-602).  Sign code -> 8 sign bits: bit7 is the parity
    completion of the low 7 (ksigns_iq2xs is exactly that table)."""
    blocks = raw.reshape(-1, 66)
    nb = blocks.shape[0]
    d = _f16(blocks[:, :2].copy())[:, 0]  # [nb]
    qs = blocks[:, 2:].reshape(nb, 8, 8)  # [nb, group, 8B]
    aux0 = qs[:, :, 0:4]  # [nb, g, 4] grid indices
    aux1 = qs[:, :, 4:8].copy().view(np.uint32)[:, :, 0]  # [nb, g]
    db = d[:, None] * (0.5 + (aux1 >> 28)).astype(np.float32) * 0.25  # [nb, g]
    grid = _iq2xxs_grid()
    vals = grid[aux0].astype(np.float32)  # [nb, g, 4, 8]
    sign7 = (aux1[:, :, None] >> (7 * np.arange(4, dtype=np.uint32))[None, None, :]) & 127
    parity = np.zeros_like(sign7)
    for b in range(7):
        parity ^= (sign7 >> b) & 1
    sign8 = sign7 | (parity << 7)  # [nb, g, 4]
    bits = (sign8[:, :, :, None] >> np.arange(8, dtype=np.uint32)[None, None, None, :]) & 1
    signs = 1.0 - 2.0 * bits.astype(np.float32)  # [nb, g, 4, 8]
    out = db[:, :, None, None] * vals * signs
    return out.reshape(-1)[:n_elems]


_DEQUANT = {
    DataType.Q4_0: dequant_q4_0,
    DataType.Q8_0: dequant_q8_0,
    DataType.Q8_0F: dequant_q8_0f,
    DataType.Q4_K: dequant_q4_k,
    DataType.Q6_K: dequant_q6_k,
    DataType.Q8_K: dequant_q8_k,
    DataType.Q2_K: dequant_q2_k,
    DataType.Q3_K: dequant_q3_k,
    DataType.Q2_0: dequant_q2_0,
    DataType.IQ2_XXS: dequant_iq2_xxs,
}


_PACKED_DEQUANT = {  # row-interleaved formats: need the row width (shape[-1])
    DataType.Q4_0_4_4: dequant_q4_0_4x4,
    DataType.Q4_0_4_8: dequant_q4_0_4x8,
    DataType.Q4_0_8_8: dequant_q4_0_8x8,
}


def decode(raw: bytes | np.ndarray, dt: DataType, n_elems: int,
           n_per_row: int | None = None) -> np.ndarray:
    """Decode raw container bytes into a float32/int numpy array of n_elems.

    `n_per_row` (the tensor's last-dim width) is required for the
    row-interleaved GemmPack formats (Q4_0_4_4 etc.), whose block stream
    groups rows in fours — flat element count alone can't place them.
    """
    buf = np.frombuffer(raw, dtype=np.uint8) if isinstance(raw, (bytes, bytearray, memoryview)) else raw
    if dt in _PACKED_DEQUANT:
        if n_per_row is None:
            raise ValueError(f"{dt!r} needs n_per_row (tensor row width) to decode")
        return _PACKED_DEQUANT[dt](buf, n_elems, n_per_row)
    if dt == DataType.F32:
        return buf.view(np.float32)[:n_elems].copy()
    if dt == DataType.F16:
        return buf.view(np.float16)[:n_elems].astype(np.float32)
    if dt == DataType.I8:
        return buf.view(np.int8)[:n_elems].copy()
    if dt == DataType.I16:
        return buf.view(np.int16)[:n_elems].copy()
    if dt == DataType.I32:
        return buf.view(np.int32)[:n_elems].copy()
    fn = _DEQUANT.get(dt)
    if fn is None:
        raise NotImplementedError(f"dequant for {dt!r} not implemented")
    return fn(buf, n_elems)


# ---------------------------------------------------------------------------
# Quantization (numpy): used by tools/quantizer and tests.
# ---------------------------------------------------------------------------


def quant_q4_0(x: np.ndarray) -> np.ndarray:
    """Quantize float array (multiple of 32) to ggml Q4_0 bytes."""
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, QK4_0)
    amax_idx = np.argmax(np.abs(x), axis=1)
    maxv = x[np.arange(x.shape[0]), amax_idx]
    d = maxv / -8.0
    inv_d = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 0.0)
    q = np.clip((x * inv_d[:, None]) + 8.5, 0.0, 15.0).astype(np.uint8)
    lo, hi = q[:, :16], q[:, 16:]
    packed = (lo | (hi << 4)).astype(np.uint8)
    out = np.empty((x.shape[0], 18), dtype=np.uint8)
    out[:, :2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:] = packed
    return out.reshape(-1)


def _pack_q4_0_nr_bl(x: np.ndarray, n_per_row: int, nri: int, bsi: int) -> np.ndarray:
    """Pack floats into GemmPack's row-interleaved Q4_0 layout.

    Bit-exact mirror of GemmPack.cpp `quantize_q4_0_nr_bl` +
    `make_block_q4_0x{4,8}`: quantize each row group of `nri` to plain Q4_0,
    then emit per 32-col block one struct {d[nri] f16, interleaved qs runs of
    `bsi` bytes, XOR 0x88 into sign form}.  Inverse of `_unpack_q4_0_nr_bl`.
    """
    qk_half = QK4_0 // 2
    n_elems = x.size
    if n_per_row % QK4_0 or n_elems % (nri * n_per_row):
        raise ValueError(f"row-interleaved Q4_0 needs rows%{nri}==0 and row "
                         f"width %32==0, got {n_elems} elems / {n_per_row} per row")
    nb = n_per_row // QK4_0
    plain = quant_q4_0(x).reshape(-1, nri, nb, 2 + qk_half)  # [g, row, block, q4_0]
    plain = plain.transpose(0, 2, 1, 3)  # struct order: (group, block, row)
    d = plain[..., :2].reshape(-1, nri * 2)
    qs = plain[..., 2:].reshape(-1, nri, qk_half // bsi, bsi).transpose(0, 2, 1, 3)
    out = np.empty((d.shape[0], nri * 2 + nri * qk_half), np.uint8)
    out[:, : nri * 2] = d
    out[:, nri * 2 :] = (qs ^ 0x88).reshape(d.shape[0], -1)
    return out.reshape(-1)


def quant_q4_0_4x4(x: np.ndarray, n_per_row: int) -> np.ndarray:
    """Q4_0_4_4 packer (GemmPack quantize_q4_0_4x4: 4 rows, 4-byte interleave)."""
    return _pack_q4_0_nr_bl(x, n_per_row, 4, 4)


def quant_q4_0_4x8(x: np.ndarray, n_per_row: int) -> np.ndarray:
    return _pack_q4_0_nr_bl(x, n_per_row, 4, 8)


def quant_q4_0_8x8(x: np.ndarray, n_per_row: int) -> np.ndarray:
    return _pack_q4_0_nr_bl(x, n_per_row, 8, 8)


def quant_q8_0(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, QK8_0)
    amax = np.max(np.abs(x), axis=1)
    d = amax / 127.0
    inv_d = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 0.0)
    q = np.round(x * inv_d[:, None]).astype(np.int8)
    out = np.empty((x.shape[0], 34), dtype=np.uint8)
    out[:, :2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:] = q.view(np.uint8)
    return out.reshape(-1)


def quant_q2_0(x: np.ndarray) -> np.ndarray:
    """Quantize float array (multiple of 32) to mllm Q2_0 blocks.

    Matches quantize_row_q2_0_reference (QuantizeQ2.cpp:35-59): d = -amax,
    q = min(3, round(x/d + 2)), value = (q-2)*d."""
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, 32)
    amax = np.max(np.abs(x), axis=1)
    d = -amax
    inv_d = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 0.0)
    # roundf = half-away-from-zero; the operand x/d + 2 is always >= 0, so
    # floor(v + 0.5) matches (np.round would tie-to-even and flip exact .5s)
    q = np.minimum(3.0, np.floor(x * inv_d[:, None] + 2.0 + 0.5)).astype(np.uint8)  # 1..3
    shifts = np.arange(4, dtype=np.uint8) * 2
    packed = (q.reshape(-1, 8, 4) << shifts[None, None, :]).sum(axis=2).astype(np.uint8)
    out = np.empty((x.shape[0], 10), dtype=np.uint8)
    out[:, :2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:] = packed
    return out.reshape(-1)


def _search_affine_groups(g: np.ndarray, nmax: int, weights: np.ndarray,
                          rmin: float, rdelta: float, nstep: int,
                          use_mad: bool):
    """Weighted affine scale/min search over N groups at once — the
    vectorized equivalent of ggml's make_qkx2_quants (reference
    mllm/backends/cpu/third_party/ggml/QuantizeQ2.cpp:86-160,
    QuantizeQ4.cpp:99): for each candidate step size, quantize, solve the
    2x2 weighted least-squares for (scale, min), and keep the candidate
    with the lowest weighted error (MAD or squared).

    g: [N, n] group values; weights: [N, n] >= 0.
    Returns (scale [N] >= 0-ish, neg_min [N] >= 0).  The caller re-derives
    the quant levels from the STORED (6/4-bit) scales, exactly like the
    reference writers do."""
    w = weights
    sum_w = w.sum(1)
    sum_x = (w * g).sum(1)
    minv = np.minimum(g.min(1), 0.0)
    rng = g.max(1) - minv
    degenerate = rng <= 0
    rng_safe = np.where(degenerate, 1.0, rng)

    def err_of(scale, mn, L):
        diff = scale[:, None] * L + mn[:, None] - g
        e = np.abs(diff) if use_mad else diff * diff
        return (w * e).sum(1)

    iscale0 = nmax / rng_safe
    L0 = np.clip(np.round(iscale0[:, None] * (g - minv[:, None])), 0, nmax)
    best_scale = 1.0 / iscale0
    best_min = minv.copy()
    best_err = err_of(best_scale, best_min, L0)
    for step in range(nstep + 1):
        iscale = (rmin + rdelta * step + nmax) / rng_safe
        L = np.clip(np.round(iscale[:, None] * (g - minv[:, None])), 0, nmax)
        sum_l = (w * L).sum(1)
        sum_l2 = (w * L * L).sum(1)
        sum_xl = (w * L * g).sum(1)
        D = sum_w * sum_l2 - sum_l * sum_l
        ok = D > 0
        D_safe = np.where(ok, D, 1.0)
        this_scale = (sum_w * sum_xl - sum_x * sum_l) / D_safe
        this_min = (sum_l2 * sum_x - sum_l * sum_xl) / D_safe
        pos = this_min > 0
        sl2_safe = np.where(sum_l2 > 0, sum_l2, 1.0)
        this_scale = np.where(pos, sum_xl / sl2_safe, this_scale)
        this_min = np.where(pos, 0.0, this_min)
        err = err_of(this_scale, this_min, L)
        upd = ok & (err < best_err)
        best_scale = np.where(upd, this_scale, best_scale)
        best_min = np.where(upd, this_min, best_min)
        best_err = np.where(upd, err, best_err)
    best_scale = np.where(degenerate, 0.0, best_scale)
    best_min = np.where(degenerate, minv, best_min)
    return best_scale, -best_min


def _search_sym_groups(g: np.ndarray, nmax: int) -> np.ndarray:
    """Weighted symmetric scale search over N groups — vectorized
    counterpart of ggml's make_qx_quants / make_q3_quants scale refinement
    (reference Quantize.hpp:182-249, QuantizeQ3.cpp:35-96): scan step sizes
    around -nmax/max with x^2 importance weights and keep the candidate
    maximizing the weighted-least-squares objective sum(w*x*l)^2/sum(w*l^2)
    (equivalently: minimizing weighted residual after the optimal rescale).

    Returns the SIGNED per-group scale [N]; quant levels are re-derived by
    the caller from the stored sub-scales."""
    w = g * g
    ai = np.abs(g).argmax(1)
    mx = g[np.arange(len(g)), ai]  # signed value at the abs max
    degenerate = np.abs(mx) < 1e-30
    mx_safe = np.where(degenerate, 1.0, mx)
    best_scale = np.zeros(len(g))
    best_obj = np.zeros(len(g))
    for step in range(-9, 10):
        iscale = -(nmax + 0.1 * step) / mx_safe
        L = np.clip(np.round(iscale[:, None] * g), -nmax, nmax - 1)
        sumlx = (w * g * L).sum(1)
        suml2 = (w * L * L).sum(1)
        s2 = np.where(suml2 > 0, suml2, 1.0)
        obj = sumlx * sumlx / s2
        upd = (suml2 > 0) & (obj > best_obj)
        best_scale = np.where(upd, sumlx / s2, best_scale)
        best_obj = np.where(upd, obj, best_obj)
    return np.where(degenerate, 0.0, best_scale)


def quant_q4_k(x: np.ndarray) -> np.ndarray:
    """Quantize float array (multiple of 256) to ggml Q4_K super-blocks.

    Full-quality writer: per-32-group weighted affine scale search
    (av+|x| importance weights, 21 candidate steps — the make_qkx2_quants
    recipe, QuantizeQ4.cpp:196-260), then 6-bit super-scale storage and
    level recompute from the STORED fp16 scales, matching the reference
    writer's structure.
    """
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, QK_K)
    nb = x.shape[0]
    g = x.reshape(nb, 8, 32)
    gf = g.reshape(nb * 8, 32)
    av = np.sqrt((gf * gf).mean(1, keepdims=True))
    scale_g, neg_min_g = _search_affine_groups(
        gf, 15, av + np.abs(gf), rmin=-1.0, rdelta=0.1, nstep=20, use_mad=False)
    scale = scale_g.reshape(nb, 8)
    neg_min = neg_min_g.reshape(nb, 8)
    d = np.maximum(scale.max(axis=1), 0.0) / 63.0  # super scale, 6-bit subs
    dmin = np.maximum(neg_min.max(axis=1), 0.0) / 63.0
    d_safe = np.where(d > 0, d, 1.0)
    dmin_safe = np.where(dmin > 0, dmin, 1.0)
    ls = np.clip(np.round(scale / d_safe[:, None]), 0, 63).astype(np.uint8)  # [nb, 8]
    lm = np.clip(np.round(neg_min / dmin_safe[:, None]), 0, 63).astype(np.uint8)
    # effective dequant params from the STORED fp16 super scales
    d = d.astype(np.float16).astype(np.float32)
    dmin = dmin.astype(np.float16).astype(np.float32)
    eff_scale = d[:, None] * ls.astype(np.float32)
    eff_min = dmin[:, None] * lm.astype(np.float32)
    es = np.where(eff_scale > 0, eff_scale, 1.0)
    q = np.clip(np.round((g + eff_min[:, :, None]) / es[:, :, None]), 0, 15).astype(np.uint8)
    q = np.where(eff_scale[:, :, None] > 0, q, np.uint8(0))

    out = np.zeros((nb, 144), dtype=np.uint8)
    out[:, 0:2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:4] = dmin.astype(np.float16)[:, None].view(np.uint8)
    # pack 6-bit scales/mins (ggml get_scale_min_k4 inverse)
    sc_bytes = np.zeros((nb, 12), dtype=np.uint8)
    for j in range(4):
        sc_bytes[:, j] = ls[:, j] | ((ls[:, j + 4] >> 4) << 6)
        sc_bytes[:, j + 4] = lm[:, j] | ((lm[:, j + 4] >> 4) << 6)
        sc_bytes[:, j + 8] = (ls[:, j + 4] & 0x0F) | ((lm[:, j + 4] & 0x0F) << 4)
    out[:, 4:16] = sc_bytes
    # pack quants: 4 chunks of 32 bytes; chunk c = groups 2c (lo) and 2c+1 (hi)
    for chunk in range(4):
        lo = q[:, 2 * chunk]  # [nb, 32]
        hi = q[:, 2 * chunk + 1]
        out[:, 16 + chunk * 32 : 16 + (chunk + 1) * 32] = lo | (hi << 4)
    return out.reshape(-1)


def quant_q6_k(x: np.ndarray) -> np.ndarray:
    """Quantize float array (multiple of 256) to ggml Q6_K super-blocks.

    Full-quality writer: per-16-group weighted symmetric scale search
    (make_qx_quants recipe, rmse_type=1 — Quantize.hpp:182, used by
    QuantizeQ6.cpp:44), int8 sub-scales against the signed max-|scale|
    group, levels recomputed from the stored fp16 super scale.
    """
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, QK_K)
    nb = x.shape[0]
    g = x.reshape(nb, 16, 16)
    scales = _search_sym_groups(g.reshape(nb * 16, 16), 32).reshape(nb, 16)
    ai = np.abs(scales).argmax(axis=1)
    max_scale = scales[np.arange(nb), ai]  # signed value at abs max
    nz = np.abs(max_scale) > 0
    iscale = np.where(nz, -128.0 / np.where(max_scale != 0, max_scale, 1.0), 0.0)
    d = np.where(nz, 1.0 / np.where(iscale != 0, iscale, 1.0), 0.0)
    sc = np.minimum(127, np.round(iscale[:, None] * scales)).astype(np.int8)
    d = d.astype(np.float16).astype(np.float32)  # stored fp16
    eff = d[:, None] * sc.astype(np.float32)
    es = np.where(eff != 0, eff, 1.0)
    q = np.clip(np.round(g / es[:, :, None]), -32, 31).astype(np.int8)
    q = np.where(eff[:, :, None] != 0, q, np.int8(0)) + 32  # 0..63
    q = q.reshape(nb, 256).astype(np.uint8)

    out = np.zeros((nb, 210), dtype=np.uint8)
    # layout per dequant_q6_k: two halves of 128; ql 64B/half, qh 32B/half
    for half in range(2):
        qh_ = q[:, half * 128 : (half + 1) * 128]  # [nb, 128]
        q1, q2, q3, q4 = qh_[:, 0:32], qh_[:, 32:64], qh_[:, 64:96], qh_[:, 96:128]
        ql_lo = (q1 & 0xF) | ((q3 & 0xF) << 4)
        ql_hi = (q2 & 0xF) | ((q4 & 0xF) << 4)
        out[:, half * 64 : half * 64 + 32] = ql_lo
        out[:, half * 64 + 32 : half * 64 + 64] = ql_hi
        qh = (q1 >> 4) | ((q2 >> 4) << 2) | ((q3 >> 4) << 4) | ((q4 >> 4) << 6)
        out[:, 128 + half * 32 : 128 + (half + 1) * 32] = qh
    out[:, 192:208] = sc.view(np.uint8)
    out[:, 208:210] = d.astype(np.float16)[:, None].view(np.uint8)
    return out.reshape(-1)


def quant_q8_k(x: np.ndarray) -> np.ndarray:
    """Quantize float array (multiple of 256) to ggml Q8_K super-blocks.

    Bit-compatible with quantize_row_q8_K_reference
    (mllm/backends/cpu/third_party/ggml/QuantizeQ8.cpp:216-251):
    iscale = -128/max (max = signed value of the abs-max element),
    q = min(127, nearest_int(iscale*x)), d = 1/iscale, bsums = per-16 sums.
    """
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, QK_K)
    nb = x.shape[0]
    amax_idx = np.abs(x).argmax(axis=1)
    mx = x[np.arange(nb), amax_idx]  # signed value at abs-max
    amax = np.abs(mx)
    iscale = np.where(amax > 0, -128.0 / np.where(mx != 0, mx, 1.0), 0.0)
    # ggml nearest_int == round-half-to-even (magic-number add) == np.round
    q = np.minimum(127, np.round(x * iscale[:, None])).astype(np.int8)
    q = np.where(amax[:, None] > 0, q, np.int8(0))
    d = np.where(iscale != 0, 1.0 / np.where(iscale != 0, iscale, 1.0), 0.0).astype(np.float32)
    bsums = q.reshape(nb, 16, 16).astype(np.int32).sum(axis=2).astype(np.int16)
    out = np.zeros((nb, 4 + QK_K + 32), dtype=np.uint8)
    out[:, 0:4] = d[:, None].view(np.uint8)
    out[:, 4 : 4 + QK_K] = q.view(np.uint8)
    out[:, 4 + QK_K :] = bsums.view(np.uint8).reshape(nb, 32)
    return out.reshape(-1)


def quant_q2_k(x: np.ndarray) -> np.ndarray:
    """Quantize float array (multiple of 256) to ggml Q2_K super-blocks.

    Full-quality writer: per-16-group weighted affine scale search with
    MAD objective and |x| importance weights (the make_qkx2_quants recipe,
    QuantizeQ2.cpp:86-179), 4-bit sub-scales/mins, levels recomputed from
    the stored fp16 super scales; identical container layout to
    dequant_q2_k / QuantizeQ2.cpp.
    """
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, QK_K)
    nb = x.shape[0]
    g = x.reshape(nb, 16, 16)
    gf = g.reshape(nb * 16, 16)
    scale_g, neg_min_g = _search_affine_groups(
        gf, 3, np.abs(gf), rmin=-0.5, rdelta=0.1, nstep=15, use_mad=True)
    scale = scale_g.reshape(nb, 16)
    neg_min = neg_min_g.reshape(nb, 16)
    d = np.maximum(scale.max(axis=1), 0.0) / 15.0  # 4-bit sub-scales
    dmin = np.maximum(neg_min.max(axis=1), 0.0) / 15.0
    d_safe = np.where(d > 0, d, 1.0)
    dmin_safe = np.where(dmin > 0, dmin, 1.0)
    ls = np.clip(np.round(scale / d_safe[:, None]), 0, 15).astype(np.uint8)  # [nb, 16]
    lm = np.clip(np.round(neg_min / dmin_safe[:, None]), 0, 15).astype(np.uint8)
    # levels from the STORED fp16 super scales (reference writer structure)
    d = d.astype(np.float16).astype(np.float32)
    dmin = dmin.astype(np.float16).astype(np.float32)
    eff_scale = d[:, None] * ls.astype(np.float32)
    eff_min = dmin[:, None] * lm.astype(np.float32)
    es = np.where(eff_scale > 0, eff_scale, 1.0)
    q = np.clip(np.round((g + eff_min[:, :, None]) / es[:, :, None]), 0, 3).astype(np.uint8)
    q = np.where(eff_scale[:, :, None] > 0, q, np.uint8(0))

    out = np.zeros((nb, 84), dtype=np.uint8)
    out[:, 0:16] = ls | (lm << 4)  # scales: low nibble = scale, high = min
    # quants: mirror dequant_q2_k — byte b of half h packs, at 2-bit lanes
    # `shift`, element (h*128 + shift*32 + b) with sub-group b//16
    q256 = q.reshape(nb, 256)
    qs = np.zeros((nb, 64), dtype=np.uint8)
    for half in range(2):
        for shift in range(4):
            vals = q256[:, half * 128 + shift * 32 : half * 128 + shift * 32 + 32]
            qs[:, half * 32 : half * 32 + 32] |= vals << (2 * shift)
    out[:, 16:80] = qs
    out[:, 80:82] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 82:84] = dmin.astype(np.float16)[:, None].view(np.uint8)
    return out.reshape(-1)


def quant_q3_k(x: np.ndarray) -> np.ndarray:
    """Quantize float array (multiple of 256) to ggml Q3_K super-blocks.

    Full-quality writer: per-16-group weighted symmetric scale search
    (make_q3_quants recipe with x^2 importance weights, QuantizeQ3.cpp:
    35-109), 6-bit signed sub-scales against the signed max-|scale| group,
    levels recomputed from the stored fp16 super scale; identical container
    layout to dequant_q3_k / QuantizeQ3.cpp.
    """
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, QK_K)
    nb = x.shape[0]
    g = x.reshape(nb, 16, 16)
    scales = _search_sym_groups(g.reshape(nb * 16, 16), 4).reshape(nb, 16)
    ai = np.abs(scales).argmax(axis=1)
    max_scale = scales[np.arange(nb), ai]  # signed value at abs max
    nz = np.abs(max_scale) > 0
    iscale = np.where(nz, -32.0 / np.where(max_scale != 0, max_scale, 1.0), 0.0)
    aux = np.clip(np.round(iscale[:, None] * scales), -32, 31).astype(np.int8)
    d = np.where(nz, 1.0 / np.where(iscale != 0, iscale, 1.0), 0.0)
    d = d.astype(np.float16).astype(np.float32)  # stored fp16
    eff = d[:, None] * aux.astype(np.float32)
    es = np.where(eff != 0, eff, 1.0)
    q = np.clip(np.round(g / es[:, :, None]), -4, 3).astype(np.int8)  # [nb,16,16]
    q = np.where(eff[:, :, None] != 0, q, np.int8(0))
    q256 = (q.reshape(nb, 256) + 4).astype(np.uint8)  # 0..7

    out = np.zeros((nb, 110), dtype=np.uint8)
    qs = np.zeros((nb, 64), dtype=np.uint8)
    hmask = np.zeros((nb, 32), dtype=np.uint8)
    for half in range(2):
        for shift in range(4):
            vals = q256[:, half * 128 + shift * 32 : half * 128 + shift * 32 + 32]
            qs[:, half * 32 : half * 32 + 32] |= (vals & 3) << (2 * shift)
            hmask |= (vals >> 2) << (half * 4 + shift)  # 1 bit: q >= 0 after -4
    out[:, 0:32] = hmask
    out[:, 32:96] = qs
    # pack 16 6-bit scales into 12 bytes (inverse of the dequant kmask scheme)
    sa = (aux + 32).astype(np.uint8)  # 0..63
    sc = np.zeros((nb, 12), dtype=np.uint8)
    for j in range(8):
        sc[:, j] = (sa[:, j] & 0xF) | ((sa[:, j + 8] & 0xF) << 4)
    for j in range(8):
        sc[:, 8 + j % 4] |= ((sa[:, j] >> 4) & 3) << (2 * (j // 4))
        sc[:, 8 + j % 4] |= ((sa[:, j + 8] >> 4) & 3) << (2 * (j // 4 + 2))
    out[:, 96:108] = sc
    out[:, 108:110] = d.astype(np.float16)[:, None].view(np.uint8)
    return out.reshape(-1)


def quant_q8_per_row_int8(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int8 quant: the int8_matmul kernel's layout.

    Returns (int8 values [R, C], float32 scales [R]) (not a ggml format).
    """
    x = np.ascontiguousarray(x, dtype=np.float32)
    amax = np.max(np.abs(x), axis=-1)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(x / scale[..., None]), -127, 127).astype(np.int8)
    return q, scale
