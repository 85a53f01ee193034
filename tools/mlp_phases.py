"""Per-block timeline of the fused int4 MLP kernel (csrc/fused_int4_mlp.cu).

    python3 tools/mlp_phases.py [--csrc mllm_tpu_torch/csrc] [--rows 0,1,2]

Builds `fused_int4_mlp.cu` of `--csrc` alone with `-DMLLM_MLP_STAMPS` (the
default build carries no stamps): thread 0 of every block writes %globaltimer
at each step of its work (the kernel's MlpStep order: start, ring primed,
last gate/up partial written, arrived at the gate/up tiles, the down chunk's
gate/up tiles all arrived, its h made, its partial written, arrived at its
down tile, the tile's chunks all arrived, end). The tool runs the rows of
chip_smoke.FUSED_MLP_ROWS named by their index (default: the main row, m=1)
through the package's wrapper (its plan and workspace) after three warm-up
calls, once more with the stamps on, and prints per step the median and the
latest time over the blocks that reach it (us from the first block's start),
then, for the blocks that hold a down chunk, the median and largest time of
each step after the one before it. Prints the card's name and power limit
first, one JSON line per row, and the kernel time of the row (as
chip_smoke.time_ms takes it, without the stamps' writes: the default build).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from int4_tune import tree_modules  # noqa: E402
from mllm_tpu_torch.ops import _build  # noqa: E402

STEPS = ["start", "primed", "last_gate_up_partial", "arrived_gate_up", "tiles_in", "h_made", "down_partial",
         "arrived_down", "down_barrier", "end"]
BLOCKS, SLOTS = 1024, 16  # the stamps buffer: [block][step] (kStampSteps)


def build(csrc: str, signatures: dict) -> ctypes.CDLL:
    out_dir = os.path.join(os.path.dirname(_build.library_path()), "tune")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "fused_int4_mlp_stamps.so")
    cmd = [_build.find_nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
           "-DMLLM_MLP_STAMPS", "-shared", "-I", os.path.abspath(csrc), "-o", lib,
           os.path.join(csrc, "fused_int4_mlp.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stdout + proc.stderr)
    handle = ctypes.CDLL(lib)
    for name in ("mllm_fused_int4_mlp_bf16", "mllm_fused_int4_mlp_blocks"):
        fn = getattr(handle, name)
        fn.argtypes, fn.restype = signatures[name], ctypes.c_int
    handle.mllm_mlp_stamps.argtypes, handle.mllm_mlp_stamps.restype = [ctypes.c_void_p], ctypes.c_int
    return handle


def timeline(st: torch.Tensor) -> dict:
    """st [blocks, SLOTS] int64 ns (0: not reached) -> per step the median and
    the latest over the blocks that reach it, and per step of the blocks with
    a down chunk its time after the step before it (median, largest); us."""
    st = st.double()
    t0 = st[:, 0][st[:, 0] > 0].min()
    out = {}
    for k, name in enumerate(STEPS):
        col = st[:, k][st[:, k] > 0] - t0
        if len(col):
            out[name] = dict(blocks=len(col), median_us=round(col.median().item() / 1e3, 3),
                             latest_us=round(col.max().item() / 1e3, 3))
    down = st[st[:, STEPS.index("tiles_in")] > 0]
    steps = {}
    for a, b in zip(STEPS[3:-1], STEPS[4:]):
        ka, kb = STEPS.index(a), STEPS.index(b)
        sel = down[(down[:, ka] > 0) & (down[:, kb] > 0)]
        if len(sel):
            dv = ((sel[:, kb] - sel[:, ka]) / 1e3).tolist()
            steps[f"{a} -> {b}"] = dict(median_us=round(statistics.median(dv), 3), largest_us=round(max(dv), 3))
    return dict(steps=out, down_blocks=steps)


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--csrc", default="mllm_tpu_torch/csrc")
    ap.add_argument("--rows", default=str(chip_smoke.MAIN_ROW["fused_int4_mlp"]))
    args = ap.parse_args()
    chip_smoke.phase_device()
    dev = torch.device("cuda", 0)
    tree = tree_modules(args.csrc)  # the wrapper, plan and workspace of the package that holds --csrc
    fm = tree["fm"]
    default_lib = _build.library()
    stamped = build(args.csrc, tree["build"].SIGNATURES)
    g = torch.Generator(device=dev).manual_seed(1234)
    stamps = torch.zeros(BLOCKS, SLOTS, dtype=torch.int64, device=dev)
    operands = {}
    for index in (int(i) for i in args.rows.split(",")):
        m, act, affine, (d, ff) = chip_smoke.FUSED_MLP_ROWS[index]
        if (d, ff) not in operands:
            operands = {(d, ff): chip_smoke.fused_mlp_operands(d, ff, dev, g)}
        block_f = fm.pick_block_f(ff)
        x = torch.randn(m, d, device=dev, generator=g).to(torch.bfloat16)
        gate, up, down = ((*op, (-8.0 * op[1]) if affine else None) for op in operands[(d, ff)][:3])

        def call():
            return fm.fused_int4_mlp(x, gate, up, down, act=act, block_f=block_f)

        tree["build"].library = lambda: default_lib
        fm.mlp_blocks.cache_clear()
        ms = chip_smoke.time_ms(call, 20)
        tree["build"].library = lambda: stamped
        fm.mlp_blocks.cache_clear()
        for _ in range(3):
            call()
        stamps.zero_()
        torch.cuda.synchronize()
        if stamped.mllm_mlp_stamps(stamps.data_ptr()) != 0:
            raise RuntimeError("mllm_mlp_stamps failed")
        call()
        torch.cuda.synchronize()
        stamped.mllm_mlp_stamps(None)
        mt8 = fm.pow2_rows(-(-m // 8), 4)
        grid = fm.sm_count(0) * fm.mlp_blocks(0, mt8, affine, fm.mlp_chunk_rows(mt8, affine))
        plan = fm.fused_mlp_plan(m, d, ff, d, block_f, grid, affine)
        print(json.dumps(dict(row=dict(m=m, d=d, ff=ff, act=act, affine=affine), grid=grid, plan=plan, ms=ms,
                              **timeline(stamps[:grid].cpu()))), flush=True)
    tree["build"].library = lambda: default_lib


if __name__ == "__main__":
    main()
