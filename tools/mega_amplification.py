"""How far random weights amplify last-bit differences through the 28-layer
megakernel trunk, on the card.

    python3 tools/mega_amplification.py        # on a CUDA card, from the repo root

Takes the random operand stacks of chip_smoke.py (`mega_operands`) at the
full Qwen2-VL-2B geometry, with their scales as they are (x1) and 4x larger
(x4), a random bf16 cache of 2048 positions and 32 slots at position 200.
For each scale it runs `fused_decode_step_batched` and its plain version at
b = 32, 8 and 1 (the first b slots of the same inputs) and prints one JSON
line per b:
  y_rel        max |kernel - plain| / max |plain| on y;
  y_self       the same between this kernel run and the b = 32 kernel run on
               the same slots (two kernel runs that differ only in how the
               work is split);
  y_absmax     max |plain y|;
  k_rel        kernel vs plain on the new keys of layers 0, 3, ..., 27;
  k_rms        root mean square of the new keys at those layers. The queries
               come from weights of the same scale, and a score against the
               unit-variance cache has about their rms as its spread, so this
               says how close each layer's softmax is to a one-hot.
"""

from __future__ import annotations

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

LAYERS = range(0, 28, 3)
POS = 200


def main():
    from mllm_tpu_torch.core.config import TextConfig
    from mllm_tpu_torch.nn.layers import RotaryEmbedding
    from mllm_tpu_torch.ops import decode_step as ds

    chip_smoke.phase_device()
    chip_smoke.phase_build()
    dev = torch.device("cuda", 0)
    cfg = TextConfig(**chip_smoke.QWEN2VL_2B_LM)
    L, d, hkv = cfg.num_hidden_layers, cfg.hidden_size, cfg.num_key_value_heads
    kw = dict(n_heads=cfg.num_attention_heads, n_kv_heads=hkv, head_dim=chip_smoke.D,
              act=cfg.hidden_act, eps=cfg.rms_norm_eps, group_a=128, group_d=32, block_f=1280)
    rope = RotaryEmbedding.make(chip_smoke.D, chip_smoke.S_CACHE, cfg.rope_theta, device=dev)

    def rel(a, r):
        return ((a - r).abs().max() / r.abs().max()).item()

    for mul in (4.0, 1.0):
        g = torch.Generator(device=dev).manual_seed(1)
        ops, _ = chip_smoke.mega_operands(dev, g, cfg)
        ops = tuple((op[0], (op[1].float() * mul).to(torch.bfloat16), *op[2:]) if isinstance(op, tuple)
                    else op for op in ops)
        kv = [torch.randn(L, 32, hkv, chip_smoke.S_CACHE, chip_smoke.D, device=dev, generator=g)
              .to(torch.bfloat16) for _ in range(2)]
        x = torch.randn(32, d, device=dev, generator=g)
        p = torch.full((32,), POS, device=dev)
        y32 = None
        for b in (32, 8, 1):
            args = (x[:b], [POS] * b, rope.sin[p[:b]], rope.cos[p[:b]], *ops,
                    kv[0][:, :b].contiguous(), kv[1][:, :b].contiguous())
            out = ds.fused_decode_step_batched(*args, **kw)
            ref = ds.fused_decode_step_batched_ref(*args, **kw)
            torch.cuda.synchronize()
            y32 = out[0] if y32 is None else y32
            chip_smoke.emit(scale=mul, b=b, y_rel=rel(out[0], ref[0]), y_self=rel(y32[:b], out[0]),
                            y_absmax=ref[0].abs().max().item(),
                            k_rel=[rel(out[1][l], ref[1][l]) for l in LAYERS],
                            k_rms=[ref[1][l].pow(2).mean().sqrt().item() for l in LAYERS])
        del kv
    print('{"ok": true}', flush=True)


if __name__ == "__main__":
    main()
