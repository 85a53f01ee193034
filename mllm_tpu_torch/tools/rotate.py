"""Rotation-assisted quantization (QuaRot / SpinQuant-lite): counterpart of
`tools/rotate.py` of the JAX repo (the reference's rotation utilities of
its NPU int8 pipeline). Orthogonal rotations spread activation and weight
outliers across channels, so low-bit quantization loses less.

This is the exactness-preserving subset on the v -> o pair: attention
output is linear in V, so rotating each head's value space by an orthogonal
R (v_proj rows by R, o_proj columns by R^T) leaves the model's function
the same in floating point while flattening per-channel outliers before
int8 / int4 quantization.

  python -m mllm_tpu_torch.tools.rotate --check [--device cuda|cpu]   # exactness + outlier metric
API: rotate_vo(model, mode, seed) -> a new CausalLM (fp-equivalent), on the
model's device.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
from torch import nn

from ..examples._demo_common import add_device_arg, device
from ..nn.layers import Linear, shallow_copy


def hadamard(n: int) -> np.ndarray:
    """Sylvester Hadamard matrix (n must be a power of 2), orthonormalized."""
    assert n & (n - 1) == 0, "n must be a power of two"
    h = np.array([[1.0]])
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return (h / np.sqrt(n)).astype(np.float32)


def random_orthogonal(n: int, seed: int = 0) -> np.ndarray:
    """Haar-random orthogonal matrix (QR of gaussian)."""
    rng = np.random.default_rng(seed)
    q, r = np.linalg.qr(rng.standard_normal((n, n)))
    return (q * np.sign(np.diag(r))).astype(np.float32)


def rotation_for(head_dim: int, mode: str = "hadamard", seed: int = 0) -> np.ndarray:
    if mode == "hadamard" and head_dim & (head_dim - 1) == 0:
        # randomized Hadamard: diag(+-1) @ H, cheap and effective (QuaRot)
        rng = np.random.default_rng(seed)
        signs = rng.choice([-1.0, 1.0], head_dim).astype(np.float32)
        return hadamard(head_dim) * signs[None, :]
    return random_orthogonal(head_dim, seed)


def rotate_vo(model, mode: str = "hadamard", seed: int = 0):
    """Rotate each layer's V / O head spaces: function-preserving in fp.
    Returns a new model over the same tensors but the rotated v_proj /
    o_proj (computed in f32 on the model's device, stored in their dtype);
    `model` is left as it was. Needs float, unfused projections."""
    cfg = model.cfg
    hkv, h, hd = cfg.num_key_value_heads, cfg.num_attention_heads, cfg.head_dim_
    blocks = []
    for li, blk in enumerate(model.blocks):
        attn = blk.attn
        if attn.qkv_proj is not None:
            raise ValueError("rotate_vo: call it before fuse_projections")
        for lin in (attn.v_proj, attn.o_proj):
            if type(lin) is not Linear:
                raise TypeError(f"rotate_vo rotates float Linears, got {type(lin).__name__}; rotate before "
                                "quantizing")
        dev, dtype = attn.v_proj.weight.device, attn.v_proj.weight.dtype
        r = torch.as_tensor(rotation_for(hd, mode, seed + li), device=dev)  # [hd, hd]
        wv = attn.v_proj.weight.float().reshape(hkv, hd, -1)
        wv2 = torch.einsum("de,hek->hdk", r, wv).reshape(hkv * hd, -1)
        wo = attn.o_proj.weight.float().reshape(-1, h, hd)
        wo2 = torch.einsum("khd,ed->khe", wo, r).reshape(wo.shape[0], h * hd)
        v_bias = attn.v_proj.bias
        if v_bias is not None:
            v_bias = (v_bias.float().reshape(hkv, hd) @ r.T).reshape(-1).to(v_bias.dtype)
        new_attn = shallow_copy(attn)
        new_attn.v_proj = Linear.from_tensors(wv2.to(dtype), v_bias)
        new_attn.o_proj = Linear.from_tensors(wo2.to(attn.o_proj.weight.dtype), attn.o_proj.bias)
        new_blk = shallow_copy(blk)
        new_blk.attn = new_attn
        blocks.append(new_blk)
    new = shallow_copy(model)
    new.blocks = nn.ModuleList(blocks)
    return new


def outlier_metric(w) -> float:
    """max|w| / rms: lower is friendlier to symmetric quantization."""
    w = np.asarray(w, np.float32)
    return float(np.max(np.abs(w)) / (np.sqrt(np.mean(w**2)) + 1e-12))


@torch.no_grad()
def check(dev) -> dict:
    """A tiny random model and its rotation on `dev`: the largest logit
    difference and v_proj's outlier metric before and after."""
    from ..core.config import TextConfig
    from ..models.transformer import CausalLM

    cfg = TextConfig(vocab_size=64, hidden_size=64, intermediate_size=128,
                     num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                     head_dim=16, max_position_embeddings=64, eos_token_id=63)
    model = CausalLM.init(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    rotated = rotate_vo(model)
    ids = torch.arange(1, 9, device=dev)[None]
    a, _ = model(ids, model.init_cache(1, 16, torch.float32), last_only=False)
    b, _ = rotated(ids, rotated.init_cache(1, 16, torch.float32), last_only=False)
    diff = float((a - b).abs().max())
    print("max fp diff after rotation:", diff)
    w0 = model.blocks[0].attn.v_proj.weight.cpu().numpy()
    w1 = rotated.blocks[0].attn.v_proj.weight.cpu().numpy()
    before, after = outlier_metric(w0), outlier_metric(w1)
    print(f"v_proj outlier metric: {before:.2f} -> {after:.2f}")
    return dict(max_diff=diff, max_logit=float(a.abs().max()), outlier_before=before, outlier_after=after)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    if not args.check:
        ap.print_help()
        return None
    return check(device(args.device))


if __name__ == "__main__":
    main()
