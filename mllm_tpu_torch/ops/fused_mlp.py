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
throughout). On the card, m <= 32 launches the kernel, which rounds the hidden
activation to bf16 as the Pallas kernel does; larger m dequantizes the three
weights to bf16 and runs three `torch.mm` (the JAX fallback route).
`fused_int4_mlp.launches` counts kernel launches (the kernel and its split-K
reduction count as one).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from .quant_matmul import (GROUP, INT4_KERNEL_MAX_M, bf16_rows, check_operands,
                           dequant_int4_canonical, launch_or_raise, pow2_rows)


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
    mt = pow2_rows(m)
    out = torch.empty(m, n_out, device=x.device, dtype=torch.float32)
    ws = torch.empty(ff // 64, m, n_out, device=x.device, dtype=torch.float32)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    err = _build.library().mllm_fused_int4_mlp_bf16(
        x2.data_ptr(), gp.data_ptr(), gs.data_ptr(), ptr(gz), up.data_ptr(), us.data_ptr(),
        ptr(uz), dp.data_ptr(), ds.data_ptr(), ptr(dz), ws.data_ptr(), out.data_ptr(),
        m, d, khp_d, ff, n_out, block_f, _ACT_ID[act], mt,
        torch.cuda.current_stream(x.device).cuda_stream)
    launch_or_raise("fused_int4_mlp", err)
    fused_int4_mlp.launches += 1
    return out.reshape(*x.shape[:-1], n_out)


fused_int4_mlp.launches = 0
