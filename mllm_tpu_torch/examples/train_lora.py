"""LoRA fine-tuning CLI: counterpart of `examples/train_lora.py` of the JAX
repo.

  python -m mllm_tpu_torch.examples.train_lora -m <model_dir> -d data.txt \\
      [--rank 8] [--steps 100] [--lr 1e-4] [--seq 256] [--batch 4] \\
      [--out adapters_merged] [--ckpt ckpt_file] [--resume] [--device cuda|cpu]

Fine-tunes rank-r adapters on next-token prediction over a plain-text file
(the model in f32, as the JAX script loads it), checkpoints the adapters,
the optimizer state and the step (`--ckpt`: one torch file, resumable with
`--resume`; the JAX script's orbax checkpoints do not load here), and saves
the MERGED model as f32 safetensors (`--out`), loadable by `auto_model` and
every demo. `--steps` is the number of steps this call runs, after a resumed
step count too, as in the JAX script. The optimizer is `torch.optim.AdamW`
with optax `adamw`'s defaults (weight decay 1e-4, not torch's 1e-2). The
steps' attention takes the plain `sdpa` (the kernels have no backward); the
merged model decodes on the kernels in bf16. On the card unless `--device
cpu`. `main(argv)` returns each step's loss.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ._demo_common import add_device_arg, device

WEIGHT_DECAY = 1e-4  # optax.adamw's default


def batches(ids: np.ndarray, seq: int, bsz: int, seed: int = 0):
    """Endless (x, y) windows of `ids` ([bsz, seq] int64 each, y shifted by
    one), their starts drawn from `numpy.random.default_rng(seed)` as the JAX
    script draws them."""
    rng = np.random.default_rng(seed)
    n = len(ids) - seq - 1
    while True:
        starts = rng.integers(0, max(n, 1), bsz)
        x = np.stack([ids[s : s + seq] for s in starts])
        y = np.stack([ids[s + 1 : s + seq + 1] for s in starts])
        yield x, y


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-d", "--data", required=True, help="plain-text training file")
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--alpha", type=float, default=16.0)
    ap.add_argument("--targets", default=r"(q_proj|k_proj|v_proj|o_proj)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--out", default=None, help="save merged model here")
    ap.add_argument("--ckpt", default=None, help="checkpoint file (with --resume)")
    ap.add_argument("--resume", action="store_true")
    add_device_arg(ap)
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    dev = device(args.device)

    from ..models.registry import auto_model
    from ..training import (TrainState, add_lora, lora_params_filter, make_train_step, merge_lora,
                            restore_checkpoint, save_checkpoint)

    model, tok, cfg = auto_model(args.model, dtype=torch.float32, device=dev)
    with open(args.data) as f:
        ids = np.asarray(tok.encode(f.read(), bos=True), np.int64)
    print(f"data: {len(ids)} tokens; adding rank-{args.rank} adapters to {args.targets}")

    lora = add_lora(model, torch.Generator().manual_seed(0), args.rank, args.alpha, args.targets)
    state = TrainState.create(lora, lambda ps: torch.optim.AdamW(ps, lr=args.lr, weight_decay=WEIGHT_DECAY),
                              trainable=lora_params_filter)
    start = 0
    if args.resume and args.ckpt and os.path.exists(args.ckpt):
        state = restore_checkpoint(args.ckpt, state)
        start = int(state.step)
        print(f"resumed from {args.ckpt} at step {start}")
    step = make_train_step(trainable=lora_params_filter)

    losses = []
    t0 = time.perf_counter()
    for (x, y), _ in zip(batches(ids, args.seq, args.batch), range(args.steps)):
        state, loss = step(state, torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev))
        losses.append(float(loss))
        i = int(state.step)
        if i % 10 == 0 or i == 1:
            print(f"step {i:5d}  loss {losses[-1]:.4f}  "
                  f"{(time.perf_counter() - t0) / i:.2f} s/step", flush=True)
    seconds = time.perf_counter() - t0

    if args.ckpt:
        save_checkpoint(args.ckpt, state)
        print(f"checkpoint -> {args.ckpt}")
    if args.out:
        from ..core.param_loader import save_safetensors_model

        merged = merge_lora(state.model)
        save_safetensors_model(args.out, merged, args.model)
        print(f"merged model -> {args.out}")
    return dict(losses=losses, start_step=start, end_step=int(state.step), seconds=seconds,
                data_tokens=len(ids))


if __name__ == "__main__":
    main()
