"""Phase timeline of the whole-trunk decode megakernel (csrc/decode_step.cu).

    python3 tools/mega_phases.py [--csrc mllm_tpu_torch/csrc] [--rows b1,b8,b32] [--label NAME]

Builds `decode_step.cu` of `--csrc` alone with `-DMLLM_MEGA_STAMPS` (the
default build carries no stamps): thread 0 of every block writes %globaltimer
when its block arrives at a grid barrier and when it leaves. The tool runs one
step on chip_smoke's random operand stacks at the full Qwen2-VL-2B geometry
(28 layers, cache 2048) after two warm-up steps, and prints per phase (the
work between two barriers, named from the barriers a layer) the median over
layers of:
  busy_us   the first block's release from the barrier before to the last
            arrival at the barrier after (the phase's critical path);
  spread_us first arrival to last arrival at the barrier after (how unequal
            the blocks' work is);
  release_us last arrival to the last block's release (the barrier's own
            latency).
Rows: b1 (b=1, pos 1531, kv_start 200, the smoke's main row of
fused_decode_step) and b8 (b=8 at unequal positions, its main row of
fused_decode_step_batched); b32 (b=32 at 200) on request. Prints the card's
name and power limit first, then one JSON line per row and a markdown table.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from mllm_tpu_torch.ops import _build  # noqa: E402
from int4_tune import tree_modules  # noqa: E402

# the phases of a layer, by the barriers a layer has
PHASES = {
    9: ["norm1", "qkv", "attention", "merge", "o_proj", "norm2", "gate_up", "gated", "down"],
    5: ["qkv", "attention", "o_proj", "gate_up", "down"],
}
ROWS = {
    "b1": dict(b=1, pos=[1531], start=[200]),
    "b8": dict(b=8, pos=[1, 17, 100, 511, 513, 1000, 1531, 2000], start=[0, 0, 5, 100, 0, 50, 0, 3]),
    "b32": dict(b=32, pos=[200] * 32, start=None),
}


def build(csrc: str, signatures: dict) -> "ctypes.CDLL":
    import ctypes

    out_dir = os.path.join(os.path.dirname(_build.library_path()), "tune")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "decode_step_stamps.so")
    cmd = [_build.find_nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
           "-DMLLM_MEGA_STAMPS", "-shared", "-I", os.path.abspath(csrc), "-o", lib,
           os.path.join(csrc, "decode_step.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stdout + proc.stderr)
    handle = ctypes.CDLL(lib)
    for name in ("mllm_fused_decode_step_bf16", "mllm_fused_decode_step_batched_bf16"):
        fn = getattr(handle, name)
        fn.argtypes = signatures[name]
        fn.restype = ctypes.c_int
    handle.mllm_mega_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    handle.mllm_mega_stamps.restype = ctypes.c_int
    return handle


MARKS = ["setup", "x_staged", "streamed", "arrived", "finished", "prime0", "prime1"]


def timeline(stamps: torch.Tensor, n_seq: int, layers: int) -> dict:
    """stamps [cap, grid, 16] int64 ns -> per phase name the medians over layers,
    and where the block that arrived last spent the phase (its marks, from the
    first release before the phase)."""
    st = stamps[:n_seq].double()
    arrive, leave = st[..., 0], st[..., 1]
    n_bar = n_seq - 2  # seq 0 = start, seq n_seq - 1 = end
    if n_bar == 9 * layers:  # the earlier kernel: nine phases a layer, then the output
        names = PHASES[9] * layers + ["output"]
    elif n_bar == 5 * layers:  # one phase before the layers, five a layer (the last ends the kernel)
        names = ["pre"] + PHASES[5] * layers
    else:
        names = [f"phase{i}" for i in range(n_seq - 1)]
    rows = {}
    for i in range(1, n_seq):
        released = leave[i - 1].min()  # the first block to leave the barrier before
        last = arrive[i].max()
        crit = int(arrive[i].argmax())
        name = names[i - 1]
        row = dict(busy_us=(last - released).item() / 1e3,
                   spread_us=(last - arrive[i].min()).item() / 1e3,
                   release_us=(leave[i].max() - last).item() / 1e3 if i < n_seq - 1 else 0.0)
        for k, mk in enumerate(MARKS):
            t = st[i, crit, 2 + k].item()
            row[f"last_{mk}_us"] = (t - released.item()) / 1e3 if t else float("nan")
            col = st[i, :, 2 + k]
            row[f"max_{mk}_us"] = ((col.max() - released).item() / 1e3) if bool((col != 0).any()) else float("nan")
        rows.setdefault(name, []).append(row)
    return {name: {k: statistics.median(r[k] for r in rs) for k in rs[0]} | {"count": len(rs)}
            for name, rs in rows.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--csrc", default="mllm_tpu_torch/csrc")
    ap.add_argument("--rows", default="b1,b8")
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    chip_smoke.phase_device()
    dev = torch.device("cuda", 0)
    tree = tree_modules(args.csrc)  # the wrappers, plan and workspace of the package that holds --csrc
    ds = tree["ds"]
    lib = build(args.csrc, tree["build"].SIGNATURES)
    tree["build"].library = lambda: lib  # its wrappers launch the stamped build
    from mllm_tpu_torch.core.config import TextConfig
    from mllm_tpu_torch.nn.layers import RotaryEmbedding

    cfg = TextConfig(**chip_smoke.QWEN2VL_2B_LM)
    L, d = cfg.num_hidden_layers, cfg.hidden_size
    g = torch.Generator(device=dev).manual_seed(1234)
    ops, _ = chip_smoke.mega_operands(dev, g, cfg)
    rope = RotaryEmbedding.make(chip_smoke.D, chip_smoke.S_CACHE, cfg.rope_theta, device=dev)
    kw = dict(n_heads=chip_smoke.H, n_kv_heads=chip_smoke.HKV, head_dim=chip_smoke.D, act=cfg.hidden_act,
              eps=cfg.rms_norm_eps, group_a=128, group_d=32, block_f=1280)
    cap = 16 * L + 8
    stamps = torch.zeros(cap, 1024, 16, dtype=torch.int64, device=dev)  # kStampBlocks, kStampSlots
    table = []
    for row in args.rows.split(","):
        spec = ROWS[row]
        b = spec["b"]
        kv = [torch.randn(L, b, chip_smoke.HKV, chip_smoke.S_CACHE, chip_smoke.D, device=dev,
                          generator=g).to(torch.bfloat16) for _ in range(2)]
        x = torch.randn(b, d, device=dev, generator=g)
        if b == 1:
            pos = spec["pos"][0]
            rot = ds.rope_rotation_matrix(rope.sin[pos], rope.cos[pos])
            run = lambda: ds.fused_decode_step(x, pos, rot, *ops, *kv, kv_start=spec["start"][0], **kw)  # noqa: E731
        else:
            p = torch.tensor(spec["pos"], device=dev)
            run = lambda: ds.fused_decode_step_batched(  # noqa: E731
                x, spec["pos"], rope.sin[p], rope.cos[p], *ops, *kv, kv_start=spec["start"], **kw)
        for _ in range(2):
            run()
        torch.cuda.synchronize()
        stamps.zero_()
        if lib.mllm_mega_stamps(stamps.data_ptr(), cap) != 0:
            raise RuntimeError("mllm_mega_stamps failed")
        run()
        torch.cuda.synchronize()
        lib.mllm_mega_stamps(None, 0)
        grid = int((stamps[0, :, 0] != 0).sum())
        st = stamps[:, :grid].cpu()
        n_seq = int((st[:, 0, 0] != 0).sum())
        start, end = st[0, :, 0].min().item(), st[n_seq - 1, :, 0].max().item()
        phases = timeline(st, n_seq, L)
        out = dict(tool="mega_phases", label=args.label, row=row, b=b, pos=spec["pos"], kv_start=spec["start"],
                   grid=grid, barriers=n_seq - 2, barriers_per_layer=(n_seq - 2) // L,
                   kernel_us=(end - start) / 1e3, phases=phases)
        print(json.dumps(out), flush=True)
        table.append(out)
        del kv
    print("| row | phase | busy µs | spread µs | release µs | per step µs | last block: "
          + " / ".join(MARKS) + " µs |")
    print("| --- | --- | --- | --- | --- | --- | --- |")
    for out in table:
        for name, ph in out["phases"].items():
            total = (ph["busy_us"] + ph["release_us"]) * ph["count"]
            marks = " / ".join(f"{ph[f'last_{mk}_us']:.1f}" for mk in MARKS)
            print(f"| {out['row']} | {name} | {ph['busy_us']:.2f} | {ph['spread_us']:.2f} | "
                  f"{ph['release_us']:.2f} | {total:.1f} | {marks} |")


if __name__ == "__main__":
    main()
