"""Time variants of int4_matmul, of int8_matmul, of the fused int4 MLP and of
the decode megakernel against each other on one card, in turns.

    python3 tools/int4_tune.py --kernel int4 \\
        --variant new=mllm_tpu_torch/csrc --variant parent=<dir>/mllm_tpu_torch/csrc \\
        --variant s4=mllm_tpu_torch/csrc:kStages=4 [--rows main] [--reps 3]
    python3 tools/int4_tune.py --kernel mega --variant new=... --variant parent=...
    python3 tools/int4_tune.py --kernel int8 --variant new=... --variant parent=... \\
        --variant gemm=mllm_tpu_torch/csrc:qm.INT8_STREAM_MAX_M=0 --variant library --variant cublas
    python3 tools/int4_tune.py --kernel mlp --variant new=... --variant parent=... --variant unfused
    python3 tools/int4_tune.py --kernel mlp --sweep [--rows main]

A variant is NAME=CSRC_DIR[:CONSTANT=VALUE,...]: `int4_matmul.cu`,
`int8_matmul.cu`, `fused_int4_mlp.cu` (each with `split_k.cu` where that
directory has one) or `decode_step.cu` of that directory, with each named
`constexpr int CONSTANT = ...;` set to VALUE (or, for `qm.NAME` / `ds.NAME` /
`fm.NAME`, a constant of the host plan in ops/quant_matmul.py /
ops/decode_step.py / ops/fused_mlp.py set while the variant runs) in a copy under
build/kernels/tune (headers from CSRC_DIR), compiled with nvcc for sm_90a and
launched by the wrappers of the package that holds CSRC_DIR (another tree's
`mllm_tpu_torch`, such as the parent's, is imported under a name of its own),
so each kernel runs with its own host plan, workspace and C signature. The
variant `library` times torch._weight_int4pack_mm on the same weights
(symmetric int4 rows), or torch._weight_int8pack_mm (int8); `cublas` (int8)
times torch.mm on the weight already dequantized to bf16, a yardstick of
another function; `unfused` (mlp) times the unfused route through this
tree's kernels (int4_matmul on gate and up, the activation, int4_matmul on
down: chip_smoke.fused_mlp_calls).

Rows: chip_smoke.INT4_ROWS (every int4_matmul row of the smoke),
chip_smoke.INT8_ROWS (every int8_matmul row), chip_smoke.FUSED_MLP_ROWS
(every fused_int4_mlp row; `--sweep` times every plan of this tree's kernel
at them instead of variants), or
chip_smoke.MEGA_ROWS (b=1 at pos 0 / 100 / 1531, b=8 at unequal positions,
b=32 at 200, b=16 at unequal positions), at full width; `--rows main` keeps the smoke's main row. Each
row runs the variants in order, then in reverse, `--reps` times, each timed as
chip_smoke.time_ms times a kernel (20 launches behind a GPU spin; 10 for the
megakernel); one JSON line per row and variant gives every time, the median,
the error against the plain version and the bound. Prints the card's name and
power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from attention_tune import with_constants  # noqa: E402
from mllm_tpu_torch.ops import _build  # noqa: E402
from mllm_tpu_torch.ops import decode_step as ds  # noqa: E402
from mllm_tpu_torch.ops import fused_mlp as fm  # noqa: E402
from mllm_tpu_torch.ops import quant_matmul as qm  # noqa: E402

SOURCES = {"int4": ("int4_matmul.cu",), "mega": ("decode_step.cu",), "int8": ("int8_matmul.cu",),
           "mlp": ("fused_int4_mlp.cu",)}
OPTIONAL_SOURCES = ("split_k.cu",)  # built beside the kernel where a tree has it (older trees' split-K pass)
YARDSTICKS = ("library", "cublas", "unfused")  # variant names that are calls, not sources
HOST = ("qm.", "ds.", "fm.")  # prefixes of host-plan constants


def parse_variant(spec: str) -> dict:
    """NAME=CSRC[:C=V,...]: a C naming a module constant of the host plan
    (`qm.BLOCK_BPS`, `ds.ITEM_COST`, `fm.MLP_ITEM_S`) is set for that
    variant's calls only; the others are `constexpr int`s of the kernel
    source."""
    name, _, rest = spec.partition("=")
    csrc, _, constants = rest.partition(":")
    items = [c for c in constants.split(",") if c]
    host = [c.split("=") for c in items if c.startswith(HOST)]
    return dict(name=name, csrc=csrc, constants=[c for c in items if not c.startswith(HOST)],
                host=[(*k.split(".", 1), float(v)) for k, v in host])


class host_constants:
    """Sets a variant's host-plan constants while a call runs."""

    def __init__(self, var):
        self.host = [(var[mod], nm, v) for mod, nm, v in var.get("host", [])]

    def __enter__(self):
        self.saved = [(mod, nm, getattr(mod, nm)) for mod, nm, _ in self.host]
        for mod, nm, v in self.host:
            setattr(mod, nm, type(getattr(mod, nm))(v))
        self.clear_plans()

    def __exit__(self, *exc):
        for mod, nm, v in self.saved:
            setattr(mod, nm, v)
        self.clear_plans()

    def clear_plans(self):
        """A cached plan was made under other constants: drop it."""
        for mod, _, _ in self.host:
            if hasattr(getattr(mod, "fused_mlp_plan", None), "cache_clear"):
                mod.fused_mlp_plan.cache_clear()


def tree_modules(csrc: str) -> dict:
    """{"qm", "ds", "fm", "build"}: ops/quant_matmul.py, ops/decode_step.py,
    ops/fused_mlp.py and ops/_build.py of the package that holds csrc: this
    one's, or another tree's imported under a name of its own (its imports
    are relative)."""
    pkg = os.path.dirname(os.path.abspath(csrc))
    if pkg == os.path.dirname(os.path.dirname(os.path.abspath(qm.__file__))):
        return dict(qm=qm, ds=ds, fm=fm, build=_build)
    name = "tree_" + hashlib.sha256(pkg.encode()).hexdigest()[:12]
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, os.path.join(pkg, "__init__.py"),
                                                      submodule_search_locations=[pkg])
        sys.modules[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[name])
    return {key: importlib.import_module(f"{name}.ops.{mod}")
            for key, mod in (("qm", "quant_matmul"), ("ds", "decode_step"), ("fm", "fused_mlp"),
                             ("build", "_build"))}


class tree_library:
    """Points the variant's package at the variant's library while a call runs."""

    def __init__(self, var):
        self.var = var

    def __enter__(self):
        self.saved = self.var["build"].library
        self.var["build"].library = lambda: self.var["lib"]

    def __exit__(self, *exc):
        self.var["build"].library = self.saved


def build_variant(kind: str, var: dict, out_dir: str) -> None:
    """Compile the variant's sources (constants set) into one library, bind
    its entry points with its package's C signatures into var["lib"], and
    its package's modules into var."""
    texts = []
    sources = SOURCES[kind] + tuple(src for src in OPTIONAL_SOURCES if os.path.exists(os.path.join(var["csrc"], src)))
    for src in sources:
        with open(os.path.join(var["csrc"], src)) as f:
            texts.append(with_constants(f.read(), var["constants"] if src == sources[0] else []))
    key = hashlib.sha256(("".join(texts) + var["csrc"]).encode()).hexdigest()[:12]
    vdir = os.path.join(out_dir, f"{kind}_{var['name']}_{key}")
    lib = os.path.join(vdir, "lib.so")
    if not os.path.exists(lib):
        os.makedirs(vdir, exist_ok=True)
        for hdr in os.listdir(var["csrc"]):
            if hdr.endswith(".cuh"):
                shutil.copy(os.path.join(var["csrc"], hdr), vdir)
        paths = []
        for src, text in zip(sources, texts):
            paths.append(os.path.join(vdir, src))
            with open(paths[-1], "w") as f:
                f.write(text)
        cmd = [_build.find_nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
               "-v", "-shared", "-o", lib, *paths]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        print(json.dumps(dict(build=var["name"], rc=proc.returncode,
                              ptxas=chip_smoke.ptxas_summary(proc.stdout + proc.stderr))), flush=True)
        if proc.returncode != 0:
            raise RuntimeError(proc.stdout + proc.stderr)
    var.update(tree_modules(var["csrc"]))
    var["lib"] = ctypes.CDLL(lib)
    for name, argtypes in var["build"].SIGNATURES.items():
        if hasattr(var["lib"], name):
            fn = getattr(var["lib"], name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int


def int4_caller(var, x, p, s, z, k):
    if var["name"] == "library":
        return chip_smoke.int4pack_call(x, p, s, k)

    def run():
        with tree_library(var), host_constants(var):
            return var["qm"].int4_matmul(x, p, s, var["qm"].GROUP, z)

    return run


def int8_caller(var, x, q, s, library_calls):
    """The variant's package's int8_matmul (its own plan and C signature) on
    its library; `library` is torch._weight_int8pack_mm and `cublas` torch.mm
    on the weight already in bf16 (chip_smoke.int8_library_calls)."""
    if var["name"] == "library":
        return library_calls[0][1]
    if var["name"] == "cublas":
        return library_calls[1]

    def run():
        with tree_library(var), host_constants(var):
            return var["qm"].int8_matmul(x, q, s)

    return run


def int8_rows(args, variants, dev, g):
    from mllm_tpu_torch.ops.quantize_model import _q8_device

    rows = chip_smoke.INT8_ROWS
    if args.rows == "main":
        rows = [rows[chip_smoke.MAIN_ROW["int8_matmul"]]]
    for m, k, n in rows:
        q, s = _q8_device(torch.randn(n, k, device=dev, generator=g) * 0.02)
        x = torch.randn(m, k, device=dev, generator=g).to(torch.bfloat16)
        lib = chip_smoke.int8_library_calls(x, q, s)
        calls = {v["name"]: int8_caller(v, x, q, s, lib) for v in variants}
        yield (dict(m=m, K=k, N=n), calls, lambda: qm.int8_matmul_ref(x, q, s),
               chip_smoke.bound(k * n + 4 * n + m * k * 2 + m * n * 4, 2 * m * k * n))


def mlp_rows(args, variants, dev, g):
    """chip_smoke.FUSED_MLP_ROWS: each variant's package's fused_int4_mlp on
    its library; `unfused` the unfused route through this tree's kernels."""
    from mllm_tpu_torch.ops.fused_mlp import pick_block_f

    rows = chip_smoke.FUSED_MLP_ROWS
    if args.rows == "main":
        rows = [rows[chip_smoke.MAIN_ROW["fused_int4_mlp"]]]
    operands = {}
    for m, act, affine, (d, ff) in rows:
        if (d, ff) not in operands:
            operands = {(d, ff): chip_smoke.fused_mlp_operands(d, ff, dev, g)}
        block_f = pick_block_f(ff)
        x = torch.randn(m, d, device=dev, generator=g).to(torch.bfloat16)
        kernel, plain, unfused = chip_smoke.fused_mlp_calls(x, operands[(d, ff)], act, affine, block_f)
        gate, up, down = ((*op, (-8.0 * op[1]) if affine else None) for op in operands[(d, ff)][:3])

        def call(var, x=x, gate=gate, up=up, down=down, act=act, block_f=block_f):
            def run():
                with tree_library(var), host_constants(var):
                    return var["fm"].fused_int4_mlp(x, gate, up, down, act=act, block_f=block_f)
            return run

        calls = {v["name"]: unfused if v["name"] == "unfused" else call(v) for v in variants
                 if v["name"] not in ("library", "cublas")}
        wb = 2 * chip_smoke.int4_bytes(d, ff, affine) + chip_smoke.int4_bytes(ff, d, affine)
        yield (dict(m=m, d=d, ff=ff, block_f=block_f, act=act, affine=affine), calls, plain,
               chip_smoke.bound(wb + m * d * 2 + m * d * 4, 2 * m * 3 * d * ff))


def mlp_sweep(args, dev, g):
    """--kernel mlp --sweep: every plan (splits_a, rows_a, splits_b, rows_b)
    the kernel takes at each row, through this tree's C entry point on the
    grid the wrapper would use: one JSON line per plan (the time, as
    chip_smoke.time_ms takes it, the best of `--reps`, the error against the
    plain version), then the plan `fused_mlp_plan` picks."""
    from mllm_tpu_torch.ops.fused_mlp import fused_mlp_plan, mlp_blocks, mlp_chunk_rows, pick_block_f

    rows = chip_smoke.FUSED_MLP_ROWS
    if args.rows == "main":
        rows = [rows[chip_smoke.MAIN_ROW["fused_int4_mlp"]]]
    operands, lib = {}, _build.library()
    for m, act, affine, (d, ff) in rows:
        if (d, ff) not in operands:
            operands = {(d, ff): chip_smoke.fused_mlp_operands(d, ff, dev, g)}
        bf = pick_block_f(ff)
        x = torch.randn(m, d, device=dev, generator=g).to(torch.bfloat16)
        _, plain, _ = chip_smoke.fused_mlp_calls(x, operands[(d, ff)], act, affine, bf)
        ref = plain()
        gate, up, down = ((*op, (-8.0 * op[1]) if affine else None) for op in operands[(d, ff)][:3])
        mt8 = qm.pow2_rows(-(-m // 8), 4)
        cap = mlp_chunk_rows(mt8, affine)
        grid = qm.sm_count(0) * mlp_blocks(0, mt8, affine, cap)
        ka, kb, ta, tb = d // 64, ff // 64, -(-ff // 512), -(-d // 512)
        counters = qm.tile_counters(dev, ta + 2 * tb + 1)
        out = torch.empty(m, d, device=dev)
        ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
        shape = dict(m=m, d=d, ff=ff, block_f=bf, act=act, affine=affine, grid=grid)
        for ra in sorted({-(-ka // sa) for sa in range(1, ka + 1)}):
            sa = -(-ka // ra)
            for rb in sorted({-(-kb // sb) for sb in range(1, kb + 1)}):
                sb = -(-kb // rb)
                if tb * sb > grid or 32 * (8 * mt8 + 4 * sa * m) > cap * 8 * mt8:
                    continue
                ws = torch.empty(2 * sa * m * ta * 512 + sb * m * tb * 512, device=dev)

                def run(sa=sa, ra=ra, sb=sb, rb=rb, ws=ws):
                    err = lib.mllm_fused_int4_mlp_bf16(
                        x.data_ptr(), gate[0].data_ptr(), gate[1].data_ptr(), ptr(gate[2]), up[0].data_ptr(),
                        up[1].data_ptr(), ptr(up[2]), down[0].data_ptr(), down[1].data_ptr(), ptr(down[2]),
                        ws.data_ptr(), counters.data_ptr(), out.data_ptr(), m, d, gate[0].shape[0], ff, d, bf,
                        fm._ACT_ID[act], mt8, sa, ra * 32, sb, rb * 32, cap, grid,
                        torch.cuda.current_stream().cuda_stream)
                    qm.launch_or_raise("fused_int4_mlp (sweep)", err)
                    return out

                run()
                torch.cuda.synchronize()
                print(json.dumps(dict(kernel="mlp", sweep=shape, splits_a=sa, rows_a=ra * 32, splits_b=sb,
                                      rows_b=rb * 32, rel_err=rel_err(out, ref),
                                      ms=min(chip_smoke.time_ms(run, 20) for _ in range(args.reps)))), flush=True)
        print(json.dumps(dict(kernel="mlp", sweep=shape, planned=fused_mlp_plan(m, d, ff, d, bf, grid, affine))),
              flush=True)


def mega_caller(var, kernel_name, args, kw):
    """The variant's package's wrapper `kernel_name`, launching the variant's library."""

    def run():
        with tree_library(var), host_constants(var):
            return getattr(var["ds"], kernel_name)(*args, **kw)

    return run


def rel_err(out, ref):
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    return max(((o.float() - r.float()).abs().max() / r.float().abs().max()).item() for o, r in zip(outs, refs))


def time_rows(args, variants, rows):
    """rows: (shape dict, {variant name: call}, plain call, bound dict)."""
    for shape, calls, plain, bnd in rows:
        ref = plain()
        torch.cuda.synchronize()
        errs = {}
        for var in variants:
            if var["name"] in calls:
                try:
                    out = calls[var["name"]]()
                except RuntimeError as e:  # a library call that does not run at this shape
                    if var["name"] not in ("library", "cublas"):
                        raise
                    print(json.dumps(dict(kernel=args.kernel, variant=var["name"], shape=shape,
                                          error=str(e)[:200])), flush=True)
                    del calls[var["name"]]
                    continue
                torch.cuda.synchronize()
                errs[var["name"]] = rel_err(out, ref)
        names = [v["name"] for v in variants if v["name"] in calls]
        times = {nm: [] for nm in names}
        for rep in range(args.reps):
            for nm in (names if rep % 2 == 0 else names[::-1]):
                times[nm].append(chip_smoke.time_ms(calls[nm], 10 if args.kernel == "mega" else 20))
        for nm in names:
            print(json.dumps(dict(kernel=args.kernel, variant=nm, shape=shape, rel_err=errs[nm],
                                  ms_median=statistics.median(times[nm]), ms=times[nm], **bnd)), flush=True)


def int4_rows(args, variants, dev, g):
    from mllm_tpu_torch.ops.quantize_model import _q4_device

    rows = chip_smoke.INT4_ROWS
    if args.rows == "main":
        rows = [rows[chip_smoke.MAIN_ROW["int4_matmul"]]]
    for m, k, n, affine in rows:
        p, s, z, x = chip_smoke.int4_operands(m, k, n, affine, dev, g)
        calls = {v["name"]: int4_caller(v, x, p, s, z, k) for v in variants
                 if v["name"] != "library" or not affine}
        wb = chip_smoke.int4_bytes(k, n, affine)
        yield (dict(m=m, K=k, N=n, affine=affine, khp=p.shape[0]), calls,
               lambda: qm.int4_matmul_ref(x, p, s, qm.GROUP, z),
               chip_smoke.bound(wb + m * k * 2 + m * n * 4, 2 * m * k * n))


def mega_rows(args, variants, dev, g):
    from mllm_tpu_torch.core.config import TextConfig
    from mllm_tpu_torch.nn.layers import RotaryEmbedding

    cfg = TextConfig(**chip_smoke.QWEN2VL_2B_LM)
    ops, weight_bytes = chip_smoke.mega_operands(dev, g, cfg)
    rope = RotaryEmbedding.make(chip_smoke.D, chip_smoke.S_CACHE, cfg.rope_theta, device=dev)
    rows = list(enumerate(chip_smoke.MEGA_ROWS))
    if args.rows == "main":
        rows = [r for r in rows if r[0] in chip_smoke.MEGA_MAIN_ROWS]
    for _, (kernel_name, pos, start) in rows:
        b = len(pos) if isinstance(pos, list) else 1
        kv = chip_smoke.mega_cache(cfg, b, dev, g)
        x = torch.randn(b, cfg.hidden_size, device=dev, generator=g)
        _, plain, call_args, kw = chip_smoke.mega_call(kernel_name, x, pos, start, rope, ops, kv, cfg)
        calls = {v["name"]: mega_caller(v, kernel_name, call_args, kw) for v in variants
                 if v["name"] != "library"}
        yield (dict(b=b, pos=pos, kv_start=start), calls, lambda: plain(*call_args, **kw),
               chip_smoke.mega_bound(cfg, weight_bytes, b, chip_smoke.mega_keys(pos, start)))
        del kv


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--kernel", choices=("int4", "mega", "int8", "mlp"), required=True)
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--rows", choices=("main", "all"), default="all")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--sweep", action="store_true",
                    help="--kernel mlp: time every plan of this tree's kernel (no --variant needed)")
    args = ap.parse_args()
    chip_smoke.phase_device()
    dev = torch.device("cuda", 0)
    out_dir = os.path.join(os.path.dirname(_build.library_path()), "tune")
    os.makedirs(out_dir, exist_ok=True)
    if args.sweep:
        return mlp_sweep(args, dev, torch.Generator(device=dev).manual_seed(1234))
    variants = [parse_variant(s) for s in args.variant]
    for var in variants:
        if var["name"] not in YARDSTICKS:
            build_variant(args.kernel, var, out_dir)
    g = torch.Generator(device=dev).manual_seed(1234)
    rows = {"int4": int4_rows, "mega": mega_rows, "int8": int8_rows, "mlp": mlp_rows}[args.kernel](
        args, variants, dev, g)
    time_rows(args, variants, rows)


if __name__ == "__main__":
    main()
