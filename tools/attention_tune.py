"""Time variants of the attention kernels against each other on one card.

    python3 tools/attention_tune.py --kernel decode \\
        --variant new=mllm_tpu_torch/csrc --variant parent=<dir>/mllm_tpu_torch/csrc \\
        --variant stages2=mllm_tpu_torch/csrc:kStages=2 --variant c4=mllm_tpu_torch/csrc@4
    python3 tools/attention_tune.py --kernel decode_quant \\
        --variant new=mllm_tpu_torch/csrc --variant parent=<dir>/mllm_tpu_torch/csrc --variant bf16=x
    python3 tools/attention_tune.py --kernel paged \\
        --variant new=mllm_tpu_torch/csrc --variant parent=<dir>/mllm_tpu_torch/csrc --variant dense=x
    python3 tools/attention_tune.py --kernel flash_quant \\
        --variant new=mllm_tpu_torch/csrc --variant parent=<dir>/mllm_tpu_torch/csrc \\
        --variant raw128=mllm_tpu_torch/csrc:kRawRows=128 --variant bf16=x

A variant is NAME=CSRC_DIR[:CONSTANT=VALUE,...][@SPLITS]: `csrc/flash_attention.cu`,
`csrc/decode_attention.cu`, `decode_attention_quant.cu`,
`decode_attention_paged.cu` or `flash_attention_quant.cu` of that directory,
with each named `constexpr int CONSTANT = ...;` of the source or of the
headers it includes (directly or through another header) set to VALUE (e.g.
kTile, kStages, kBK, kRawRows) in a copy under build/kernels/tune (the source
and those headers), compiled alone with nvcc for sm_90a (every variant's nvcc started at
once) and called through its C entry point.
`@SPLITS` fixes the decode kernels' cluster size instead of the wrapper's rule
(`decode_splits`). A directory whose decode entry point takes no cluster size
(an older tree's kernel) is called without one. The variant named `sdpa`
is PyTorch's scaled_dot_product_attention over the same keys (main rows);
with `--kernel decode_quant` (`csrc/decode_attention_quant.cu`, rows
chip_smoke.QUANT_DECODE_ROWS at int8 and then int4) the variant named `bf16`
is this tree's bf16 decode_attention over the same keys dequantized to bf16;
with `--kernel paged` (rows chip_smoke.PAGED_ROWS) the variant named `dense`
is this tree's decode_attention over the dense view of the slots' blocks
(`gather_pages`, made outside the timed window). A paged directory whose
entry point takes no cluster size (an older tree's kernel) is called
without one. With `--kernel flash_quant` (`csrc/flash_attention_quant.cu`,
rows chip_smoke.QUANT_FLASH_ROWS at int8 and then int4) the variant named
`bf16` is this tree's bf16 flash_attention over the same keys dequantized to
bf16 (`bf16_flash_ms` of the smoke); a directory whose entry point takes no
q_scale (an older tree's kernel, which took q pre-scaled) is timed as its
wrapper ran it: the elementwise pre-scale of q, then the kernel.

For every row of chip_smoke.FLASH_ROWS or DECODE_ROWS (or only the main row,
`--rows main`), the variants run in turns, in order then in reverse, `--reps`
times, each timed as chip_smoke.time_ms times a kernel (20 launches behind a
GPU spin); one JSON line per row and variant gives every time, the median and
max |kernel - plain version|. Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from mllm_tpu_torch.ops import _build  # noqa: E402
from mllm_tpu_torch.ops.decode_attention import (decode_attention_ref, decode_splits)  # noqa: E402
from mllm_tpu_torch.ops.flash_attention import LOG2E, flash_attention_ref  # noqa: E402
from mllm_tpu_torch.ops.quant_matmul import sm_count  # noqa: E402

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SOURCE = {"flash": "flash_attention.cu", "decode": "decode_attention.cu",
          "decode_quant": "decode_attention_quant.cu", "paged": "decode_attention_paged.cu",
          "flash_quant": "flash_attention_quant.cu"}
ENTRY = {"flash": "mllm_flash_attention_bf16", "decode": "mllm_decode_attention_bf16",
         "decode_quant": "mllm_decode_attention_quant", "paged": "mllm_decode_attention_paged_bf16",
         "flash_quant": "mllm_flash_attention_quant"}
YARDSTICKS = ("sdpa", "bf16", "dense")  # variant names that are calls of this tree, not sources


def parse_variant(spec: str) -> dict:
    name, rest = spec.split("=", 1)
    splits = None
    if "@" in rest:
        rest, splits = rest.rsplit("@", 1)
        splits = int(splits)
    csrc, _, constants = rest.partition(":")
    return dict(name=name, csrc=csrc, constants=[c for c in constants.split(",") if c], splits=splits)


def with_constants(text: str, constants: list) -> str:
    """The source with each `constexpr int NAME = ...;` of `constants`
    (NAME=VALUE strings) set to VALUE; raises on a name it does not define."""
    texts = with_constants_in({"source": text}, constants)
    return texts["source"]


def with_constants_in(texts: dict, constants: list) -> dict:
    """{file: text} with each `constexpr int NAME = ...;` of `constants` set
    to VALUE in the one file that defines it; raises unless exactly one
    definition of NAME is found among them."""
    texts = dict(texts)
    for item in constants:
        name, value = item.split("=")
        found = 0
        for file, text in texts.items():
            texts[file], n = re.subn(rf"(constexpr int {name} = )[^;]+;", rf"\g<1>{int(value)};", text)
            found += n
        if found != 1:
            raise ValueError(f"no single `constexpr int {name}` in the source and its headers")
    return texts


def included_sources(csrc: str, source: str) -> dict:
    """{file: text} of `source` and every header of `csrc` it includes,
    directly or through another header."""
    texts, todo = {}, [source]
    while todo:
        name = todo.pop()
        if name in texts or not os.path.exists(os.path.join(csrc, name)):
            continue  # a system header
        with open(os.path.join(csrc, name)) as f:
            texts[name] = f.read()
        todo += re.findall(r'#include "([^"]+)"', texts[name])
    return texts


def build_variants(kind: str, variants: list, out_dir: str) -> list:
    """Compile every variant's copy at once (one nvcc each, all started
    together), then bind each entry point: var["fn"]. Returns the handles."""
    jobs = []
    for var in variants:
        texts = with_constants_in(included_sources(var["csrc"], SOURCE[kind]), var["constants"])
        key = hashlib.sha256(("".join(texts.values()) + var["csrc"]).encode()).hexdigest()[:12]
        vdir = os.path.join(out_dir, f"{kind}_{var['name']}_{key}")
        lib = os.path.join(vdir, "lib.so")
        proc = None
        if not os.path.exists(lib):
            os.makedirs(vdir, exist_ok=True)
            for name, body in texts.items():
                with open(os.path.join(vdir, name), "w") as f:
                    f.write(body)
            cmd = [_build.find_nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
                   "-v", "-shared", "-I", vdir, "-o", lib, os.path.join(vdir, SOURCE[kind])]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((var, texts[SOURCE[kind]], lib, proc))
    handles = []
    for var, text, lib, proc in jobs:
        if proc is not None:
            out = proc.communicate()[0]
            log = [ln.strip() for ln in out.splitlines()
                   if "registers" in ln or "spill" in ln or "warning" in ln or "error" in ln]
            print(json.dumps(dict(build=var["name"], rc=proc.returncode, ptxas=log)), flush=True)
            if proc.returncode != 0:
                raise RuntimeError(out)
        handle = ctypes.CDLL(lib)
        fn = getattr(handle, ENTRY[kind])
        var["with_splits"] = "int splits" in text
        var["with_q_scale"] = "float q_scale" in text
        splits = [_I] if var["with_splits"] else []
        if kind == "flash_quant":
            fn.argtypes = [_P] * 7 + [_I] * 11 + ([_F] if var["with_q_scale"] else []) + [_P]
        elif kind == "flash":
            fn.argtypes = [_P] * 6 + [_I] * 10 + [_F] + splits + [_P]
        elif kind == "decode":
            fn.argtypes = [_P] * 6 + [_I] * 7 + [_F] + splits + [_P]
        elif kind == "paged":
            fn.argtypes = [_P] * 6 + [_I] * 8 + [_F] + splits + [_P]
        else:
            fn.argtypes = [_P] * 8 + [_I] * 8 + [_F] + splits + [_P]
        fn.restype = ctypes.c_int
        var["fn"] = fn
        handles.append(handle)
    return handles


def caller(kind: str, var: dict, q, k, v, kw):
    """A no-argument call of the variant's kernel on these inputs (the
    variant "sdpa": PyTorch's scaled_dot_product_attention over the same keys,
    for rows with one length, no kv_start and no window)."""
    if var["name"] == "sdpa":
        kvl = kw["kv_valid_len"]
        n = int(kvl[0]) if isinstance(kvl, torch.Tensor) else int(kvl)
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k[:, :, :n], v[:, :, :n], is_causal=kind == "flash", enable_gqa=True)
    out = torch.empty_like(q)
    b, sq, h, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    kvl = kw["kv_valid_len"]
    vec = kvl if isinstance(kvl, torch.Tensor) else None
    start = kw.get("kv_start")
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    stream = torch.cuda.current_stream().cuda_stream
    scale = d**-0.5 * LOG2E
    window = int(kw.get("window") or 0)
    if kind == "flash":
        args = (ptr(q), ptr(k), ptr(v), ptr(out), ptr(vec), ptr(start), b, sq, h, hkv, skv, d,
                kw["q_offset"], 0 if vec is not None else int(kvl), 1, window, scale,
                *([var["splits"] or 1] if var["with_splits"] else []), stream)
    else:
        splits = var["splits"] or decode_splits(b, hkv, h // hkv, skv, sm_count(0))
        args = (ptr(q), ptr(k), ptr(v), ptr(out), ptr(vec), ptr(start), b, h, hkv, skv, d, 0, window,
                scale, *([splits] if var["with_splits"] else []), stream)

    def run():
        err = var["fn"](*args)
        if err != 0:
            raise RuntimeError(f"{var['name']}: launch failed with CUDA error {err}")
        return out

    return run


def quant_caller(var: dict, q, ops, kw, dense):
    """A no-argument call of the variant's quantized decode kernel on (q, k,
    v, k_scale, v_scale) (the variant "bf16": the bf16 decode_attention kernel
    of this tree over the same keys dequantized, `dense`)."""
    if var["name"] == "bf16":
        from mllm_tpu_torch.ops.decode_attention import decode_attention

        return lambda: decode_attention(q, *dense, **kw)
    k, v, ks, vs = ops
    out = torch.empty_like(q)
    b, _, h, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    splits = var["splits"] or decode_splits(b, hkv, h // hkv, skv, sm_count(0))
    args = (ptr(q), ptr(k), ptr(v), ptr(ks), ptr(vs), ptr(out), ptr(kw["kv_valid_len"]), ptr(kw["kv_start"]),
            b, h, hkv, skv, d, 8 if k.dtype == torch.int8 else 4, 0, int(kw["window"] or 0),
            float(torch.tensor(d**-0.5, dtype=q.dtype)), *([splits] if var["with_splits"] else []),
            torch.cuda.current_stream().cuda_stream)

    def run():
        err = var["fn"](*args)
        if err != 0:
            raise RuntimeError(f"{var['name']}: launch failed with CUDA error {err}")
        return out

    return run


def flash_quant_caller(var: dict, q, ops, kw, dense):
    """A no-argument call of the variant's quantized flash kernel on (q, k, v,
    k_scale, v_scale) (the variant "bf16": this tree's bf16 flash_attention
    over the same keys dequantized, `dense`). A kernel that takes q pre-scaled
    runs after the pre-scale its wrapper made, as a call of it did."""
    from mllm_tpu_torch.ops.flash_attention import flash_attention, quant_q_scale

    if var["name"] == "bf16":
        return lambda: flash_attention(q, *dense, **kw)
    k, v, ks, vs = ops
    out = torch.empty_like(q)
    b, sq, h, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    start = kw["kv_start"]
    tail = (b, sq, h, hkv, skv, d, 8 if k.dtype == torch.int8 else 4, kw["q_offset"], int(kw["kv_valid_len"]), 1,
            int(kw["window"] or 0))
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (k.data_ptr(), v.data_ptr(), ks.data_ptr(), vs.data_ptr(), out.data_ptr(),
            start.data_ptr() if start is not None else None)
    c = torch.tensor(d**-0.5 * LOG2E, dtype=q.dtype, device=q.device)

    def run():
        if var["with_q_scale"]:
            err = var["fn"](q.data_ptr(), *ptrs, *tail, quant_q_scale(d**-0.5), stream)
        else:
            qt = (q * c).contiguous()
            err = var["fn"](qt.data_ptr(), *ptrs, *tail, stream)
        if err != 0:
            raise RuntimeError(f"{var['name']}: launch failed with CUDA error {err}")
        return out

    return run


def main_flash_quant(args, variants, dev):
    """--kernel flash_quant: every row of chip_smoke.QUANT_FLASH_ROWS at int8
    and int4 (or the main row at both), against flash_attention_quant_ref."""
    from mllm_tpu_torch.ops.flash_attention import flash_attention_quant_ref

    rows = chip_smoke.QUANT_FLASH_ROWS
    if args.rows == "main":
        rows = [rows[chip_smoke.MAIN_ROW["flash_attention_quant"]]]
    g = torch.Generator(device=dev).manual_seed(1234)
    for bits in (8, 4):
        for row in rows:
            q, kops, pops, kw, shape, dense = chip_smoke.quant_flash_inputs(row, bits, dev, g)
            ref = flash_attention_quant_ref(q, *pops, **kw).float()
            runs = [flash_quant_caller(var, q, kops, kw, dense) for var in variants]
            d = shape["D"]
            kb = 2 * (d if bits == 8 else d // 2) + 8
            time_variants(args, variants, runs, ref, shape, chip_smoke.attention_bound(shape, kb)["bound_ms"])


def paged_caller(var: dict, q, kp, vp, table, kw, dense):
    """A no-argument call of the variant's paged decode kernel (the variant
    "dense": this tree's decode_attention over the dense view `dense`)."""
    from mllm_tpu_torch.ops.decode_attention import PAGE, decode_attention

    if var["name"] == "dense":
        return lambda: decode_attention(q, *dense, **kw)
    out = torch.empty_like(q)
    b, _, h, d = q.shape
    nb, hkv = kp.shape[:2]
    maxb = table.shape[1]
    splits = var["splits"] or decode_splits(b, hkv, h // hkv, maxb * PAGE, sm_count(0))
    args = (q.data_ptr(), kp.data_ptr(), vp.data_ptr(), table.data_ptr(), out.data_ptr(),
            kw["kv_valid_len"].data_ptr(), b, h, hkv, nb, maxb, d, 0, int(kw["window"] or 0), d**-0.5 * LOG2E,
            *([splits] if var["with_splits"] else []), torch.cuda.current_stream().cuda_stream)

    def run():
        err = var["fn"](*args)
        if err != 0:
            raise RuntimeError(f"{var['name']}: launch failed with CUDA error {err}")
        return out

    return run


def main_paged(args, variants, dev):
    """--kernel paged: every row of chip_smoke.PAGED_ROWS (or the main row),
    against decode_attention_paged_ref on the pools with the unseen rows
    zeroed."""
    from mllm_tpu_torch.ops.decode_attention import decode_attention_paged_ref

    rows = chip_smoke.PAGED_ROWS
    if args.rows == "main":
        rows = [rows[chip_smoke.MAIN_ROW["decode_attention_paged"]]]
    g = torch.Generator(device=dev).manual_seed(1234)
    for row in rows:
        q, kp, vp, table, kw, shape, plain_pools, dense = chip_smoke.paged_inputs(row, dev, g)
        ref = decode_attention_paged_ref(q, *plain_pools, table, **kw).float()
        runs = [paged_caller(var, q, kp, vp, table, kw, dense) for var in variants]
        time_variants(args, variants, runs, ref, shape, chip_smoke.attention_bound(shape)["bound_ms"])


def time_variants(args, variants, runs, ref, shape, bound_ms):
    errs = []
    for var, run in zip(variants, runs):
        try:
            out = run()
            torch.cuda.synchronize()
        except Exception:
            print(json.dumps(dict(kernel=args.kernel, variant=var["name"], shape=shape, failed=True)), flush=True)
            raise
        if out.shape != ref.shape:  # SDPA's [B, H, Sq, D]
            out = out.transpose(1, 2)
        errs.append((out.float() - ref).abs().max().item())
    times = [[] for _ in variants]
    for rep in range(args.reps):
        order = range(len(variants)) if rep % 2 == 0 else reversed(range(len(variants)))
        for i in order:
            times[i].append(chip_smoke.time_ms(runs[i], 20))
    for var, err, ts in zip(variants, errs, times):
        print(json.dumps(dict(kernel=args.kernel, variant=var["name"], constants=var["constants"],
                              splits=var["splits"], shape=shape, max_abs_err=err,
                              ms_median=statistics.median(ts), ms=ts, bound_ms=bound_ms)), flush=True)


def main_quant(args, variants, dev):
    """--kernel decode_quant: every row of chip_smoke.QUANT_DECODE_ROWS at int8
    and int4 (or the main row at both), against decode_attention_quant_ref."""
    from mllm_tpu_torch.ops.decode_attention import decode_attention_quant_ref

    rows = chip_smoke.QUANT_DECODE_ROWS
    if args.rows == "main":
        rows = [rows[chip_smoke.MAIN_ROW["decode_attention_quant"]]]
    g = torch.Generator(device=dev).manual_seed(1234)
    for bits in (8, 4):
        for row in rows:
            q, kops, pops, kw, shape, dense = chip_smoke.quant_decode_inputs(row, bits, dev, g)
            ref = decode_attention_quant_ref(q, *pops, **kw).float()
            runs = [quant_caller(var, q, kops, kw, dense) for var in variants]
            kb = 2 * (chip_smoke.D if bits == 8 else chip_smoke.D // 2) + 8
            time_variants(args, variants, runs, ref, shape, chip_smoke.attention_bound(shape, kb)["bound_ms"])


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--kernel", choices=("flash", "decode", "decode_quant", "paged", "flash_quant"), required=True)
    ap.add_argument("--variant", action="append", required=True)
    ap.add_argument("--rows", choices=("main", "all"), default="all")
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    chip_smoke.phase_device()
    dev = torch.device("cuda", 0)
    out_dir = os.path.join(os.path.dirname(_build.library_path()), "tune")
    os.makedirs(out_dir, exist_ok=True)
    variants = [parse_variant(s) for s in args.variant]
    handles = build_variants(args.kernel, [v for v in variants if v["name"] not in YARDSTICKS], out_dir)  # noqa: F841
    if args.kernel == "decode_quant":
        return main_quant(args, variants, dev)
    if args.kernel == "paged":
        return main_paged(args, variants, dev)
    if args.kernel == "flash_quant":
        return main_flash_quant(args, variants, dev)
    kind = "flash_attention" if args.kernel == "flash" else "decode_attention"
    row_list = chip_smoke.FLASH_ROWS if args.kernel == "flash" else chip_smoke.DECODE_ROWS
    if args.rows == "main":
        row_list = [row_list[chip_smoke.MAIN_ROW[kind]]]
    plain = flash_attention_ref if args.kernel == "flash" else decode_attention_ref
    g = torch.Generator(device=dev).manual_seed(1234)
    for row in row_list:
        q, k, v, kp, vp, kw, shape = chip_smoke.attention_inputs(kind, row, dev, g)
        ref = plain(q, kp, vp, **kw).float()
        runs = [caller(args.kernel, var, q, k, v, kw) for var in variants]
        time_variants(args, variants, runs, ref, shape, chip_smoke.attention_bound(shape)["bound_ms"])


if __name__ == "__main__":
    main()
