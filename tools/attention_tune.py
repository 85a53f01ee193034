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
    python3 tools/attention_tune.py --kernel flash --wide \
        --variant new=mllm_tpu_torch/csrc --variant parent=<dir>/mllm_tpu_torch/csrc \
        --variant c3=mllm_tpu_torch/csrc@3 --variant run3=mllm_tpu_torch/csrc:kMinRun=3 --variant sdpa=x
    python3 tools/attention_tune.py --kernel decode --geo64 --rows probe \
        --variant new=mllm_tpu_torch/csrc --variant parent=<dir>/mllm_tpu_torch/csrc --variant sdpa=x
    python3 tools/attention_tune.py --kernel flash --geo64 | --geo80 [--rows probe] \
        --variant new=mllm_tpu_torch/csrc --variant parent=<dir>/mllm_tpu_torch/csrc \
        --variant s2=mllm_tpu_torch/csrc:kNarrowStages=2 --variant sdpa=x

A variant is NAME=CSRC_DIR[:CONSTANT=VALUE,...][@SPLITS]: `csrc/flash_attention.cu`,
`csrc/decode_attention.cu`, `decode_attention_quant.cu`,
`decode_attention_paged.cu` or `flash_attention_quant.cu` of that directory,
with each named `constexpr int CONSTANT = ...;` of the source or of the
headers it includes (directly or through another header) set to VALUE (e.g.
kTile, kStages, kBK, kRawRows) in a copy under build/kernels/tune (the source
and those headers), compiled alone with nvcc for sm_90a (every variant's nvcc started at
once) and called through its C entry point.
`@SPLITS` fixes the cluster size (the decode kernels', and the flash kernels' at
head_dim 256, bf16 and quantized; the narrow bodies at 64 and 80 take only 1)
instead of the rule of the variant's own tree (`decode_splits`,
`flash_launch_splits`, `flash_quant_launch_splits` or an older tree's
`flash_splits`, imported from the package that holds its
csrc, so a parent tree's kernel gets the cluster size its wrapper gave it). A directory whose
entry point takes no cluster size (an older tree's kernel) is called without
one. The variant named `sdpa`
is PyTorch's scaled_dot_product_attention over the same keys (main rows);
with `--kernel decode_quant` (`csrc/decode_attention_quant.cu`, rows
chip_smoke.QUANT_DECODE_ROWS at int8 and then int4) the variant named `bf16`
is this tree's bf16 decode_attention over the same keys dequantized to bf16
(and `sdpa`, with `--kernel flash_quant` too, SDPA over them);
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

For every row of chip_smoke.FLASH_ROWS or DECODE_ROWS (with `--wide`,
FLASH_ROWS_256 or DECODE_ROWS_256 at head_dim 256, chip_smoke.WIDE_GEO; the
quantized kernels' and the paged one's rows at WIDE_GEO, flash_quant's
QUANT_FLASH_ROWS_256; with `--geo64`, FLASH_ROWS_64 or DECODE_ROWS_64 at
chip_smoke.GEO64, and for flash FLASH64_CHUNK_ROWS and the main row at
chip_smoke.FLASH64_GQA_GEOS; with `--kernel flash --geo80`, FLASH80_ROWS,
non-causal; or only the main row, `--rows main`; or the main row and one tile
of keys at its batch, `--rows probe`, which for flash at 64 and 80 is the
main row and `flash_probe_rows`: one q-tile over 1, 4 and 12 key tiles, then
1-4 rounds of 128 CTAs of 4 key tiles), the variants run in turns, in order then in reverse, `--reps`
times, each timed as chip_smoke.time_ms times a kernel (20 launches behind a
GPU spin); one JSON line per row and variant gives every time, the median and
max |kernel - plain version|. Prints the card's name and power limit first;
with `--sass`, a digest of each built kernel's SASS (`sass_digest`: equal
digests, equal instructions).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib
import importlib.util
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


def build_variants(kind: str, variants: list, out_dir: str, sass: bool = False) -> list:
    """Compile every variant's copy at once (one nvcc each, all started
    together), then bind each entry point: var["fn"]. Returns the handles.
    With `sass`, prints each variant's `sass_digest` first."""
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
            warnings = [ln.strip() for ln in out.splitlines() if "warning" in ln or "error" in ln]
            # [kernel, registers, spill stores, spill loads] of every kernel of the variant's source
            print(json.dumps(dict(build=var["name"], rc=proc.returncode, ptxas=chip_smoke.ptxas_summary(out),
                                  warnings=warnings)), flush=True)
            if proc.returncode != 0:
                raise RuntimeError(out)
        if sass:
            print(json.dumps(dict(sass=var["name"], kernels=sass_digest(lib))), flush=True)
        handle = ctypes.CDLL(lib)
        fn = getattr(handle, ENTRY[kind])
        var["with_splits"] = "int splits" in text
        var["with_q_scale"] = "float q_scale" in text
        # the device-scalar pointers of the flash entries: kv_valid_vec and
        # q_offset_dev (flash_quant), q_offset_dev (flash), passed as null
        var["dev_scalars"] = ("q_offset_dev" in text) * (2 if kind == "flash_quant" else 1)
        splits = [_I] if var["with_splits"] else []
        if kind == "flash_quant":
            fn.argtypes = [_P] * (7 + var["dev_scalars"]) + [_I] * 11 + ([_F] if var["with_q_scale"] else []) + \
                splits + [_P]
        elif kind == "flash":
            fn.argtypes = [_P] * (6 + var["dev_scalars"]) + [_I] * 10 + [_F] + splits + [_P]
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


def sass_digest(lib: str) -> dict:
    """{kernel: sha256 of its SASS} of a built library (`cuobjdump -sass`,
    each instruction's address and encoding stripped), so two builds of
    the same kernel compare equal when their instructions are."""
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True, check=True).stdout
    digests, name, body = {}, None, []
    for ln in out.splitlines() + ["Function : <end>"]:
        m = re.search(r"Function : (\S+)", ln)
        if m:
            if name is not None:
                digests[name] = hashlib.sha256("\n".join(body).encode()).hexdigest()[:16]
            name, body = m.group(1), []
        elif name is not None:
            ins = re.sub(r"/\*[0-9a-fx]+\*/", "", ln).strip()
            if ins:
                body.append(ins)
    return digests


def tree_ops(csrc: str, mod: str):
    """ops/<mod>.py of the package that holds csrc: this one's, or another
    tree's imported under a name of its own (its imports are relative), so a
    variant's kernel gets the cluster size its own wrapper would give it."""
    pkg = os.path.dirname(os.path.abspath(csrc))
    if pkg == os.path.dirname(os.path.dirname(os.path.abspath(_build.__file__))):
        return importlib.import_module(f"mllm_tpu_torch.ops.{mod}")
    name = "tree_" + hashlib.sha256(pkg.encode()).hexdigest()[:12]
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, os.path.join(pkg, "__init__.py"),
                                                      submodule_search_locations=[pkg])
        sys.modules[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[name])
    return importlib.import_module(f"{name}.ops.{mod}")


def tree_decode_splits(var: dict, b: int, hkv: int, n_rep: int, skv: int, d: int) -> int:
    """The variant's cluster size: its `@SPLITS`, else its own tree's
    `decode_splits` as the bf16 dense wrapper calls it (with head_dim where
    that tree's rule takes it)."""
    if var["splits"]:
        return var["splits"]
    rule = tree_ops(var["csrc"], "decode_attention").decode_splits
    try:
        return rule(b, hkv, n_rep, skv, sm_count(0), head_dim=d)
    except TypeError:
        return rule(b, hkv, n_rep, skv, sm_count(0))


def tree_flash_splits(var: dict, b: int, sq: int, skv: int, h: int, window, d: int, q_offset: int,
                      kv_valid, causal: bool = True) -> int:
    """The variant's flash cluster size: its own tree's rule as its wrapper
    calls it (`flash_launch_splits`, or in an older tree `flash_splits` over
    the card's resident cluster slots; the host q_offset, and kv_valid where
    it is one host int; 1 at a head_dim that tree does not split)."""
    ops = tree_ops(var["csrc"], "flash_attention")
    if hasattr(ops, "flash_launch_splits"):
        return ops.flash_launch_splits(b, sq, skv, h, d, causal, window or None, 0, q_offset, kv_valid)
    if d not in ops.FLASH_SPLIT_HEAD_DIMS:
        return 1
    return ops.flash_splits(b, sq, skv, h, causal, window or None, ops.flash_cluster_slots(0), q_offset, kv_valid)


def tree_flash_quant_splits(var: dict, b: int, sq: int, skv: int, h: int, d: int, bits: int, window,
                            q_offset: int, kv_valid: int) -> int:
    """The variant's quantized flash cluster size: its `@SPLITS`, else its own
    tree's `flash_quant_launch_splits` as its wrapper calls it (host q_offset
    and kv_valid), 1 in a tree without it."""
    if var["splits"]:
        return var["splits"]
    ops = tree_ops(var["csrc"], "flash_attention")
    if not hasattr(ops, "flash_quant_launch_splits"):
        return 1
    return ops.flash_quant_launch_splits(b, sq, skv, h, d, bits, True, window or None, 0, q_offset, kv_valid)


def caller(kind: str, var: dict, q, k, v, kw):
    """A no-argument call of the variant's kernel on these inputs (the
    variant "sdpa": PyTorch's scaled_dot_product_attention over the same keys,
    for rows with one length, no kv_start and no window)."""
    if var["name"] == "sdpa":
        kvl = kw["kv_valid_len"]
        n = int(kvl[0]) if isinstance(kvl, torch.Tensor) else int(kvl)
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k[:, :, :n], v[:, :, :n], is_causal=kind == "flash" and kw.get("causal", True),
            enable_gqa=True)
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
        splits = var["splits"] or (tree_flash_splits(var, b, sq, skv, h, window, d, kw["q_offset"],
                                                     None if vec is not None else int(kvl),
                                                     bool(kw.get("causal", True)))
                                   if var["with_splits"] else 1)
        args = (ptr(q), ptr(k), ptr(v), ptr(out), ptr(vec), ptr(start), *[None] * var["dev_scalars"], b, sq, h, hkv, skv, d,
                kw["q_offset"], 0 if vec is not None else int(kvl), int(kw.get("causal", True)), window, scale,
                *([splits] if var["with_splits"] else []), stream)
    else:
        splits = tree_decode_splits(var, b, hkv, h // hkv, skv, d)
        args = (ptr(q), ptr(k), ptr(v), ptr(out), ptr(vec), ptr(start), b, h, hkv, skv, d, 0, window,
                scale, *([splits] if var["with_splits"] else []), stream)

    def run():
        err = var["fn"](*args)
        if err != 0:
            raise RuntimeError(f"{var['name']}: launch failed with CUDA error {err}")
        return out

    return run


def quant_caller(var: dict, q, ops, kw, dense, row=None):
    """A no-argument call of the variant's quantized decode kernel on (q, k,
    v, k_scale, v_scale) (the variant "bf16": the bf16 decode_attention kernel
    of this tree over the same keys dequantized, `dense`; "sdpa": PyTorch's
    scaled_dot_product_attention over them with the row's mask, as the
    smoke's `dense_sdpa_ms`)."""
    if var["name"] == "bf16":
        from mllm_tpu_torch.ops.decode_attention import decode_attention

        return lambda: decode_attention(q, *dense, **kw)
    if var["name"] == "sdpa":
        m = chip_smoke.decode_mask(q.device, [min(n, dense[0].shape[2]) for n in row[1]], dense[0].shape[2], row[2],
                                   row[3])
        return lambda: torch.nn.functional.scaled_dot_product_attention(q.transpose(1, 2), *dense, attn_mask=m,
                                                                        enable_gqa=True)
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
    if var["name"] == "sdpa":  # over the dequantized keys, as the smoke's `dense_sdpa_ms`
        n = int(kw["kv_valid_len"])
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), dense[0][:, :, :n], dense[1][:, :, :n], is_causal=kw["q_offset"] == 0, enable_gqa=True)
    k, v, ks, vs = ops
    out = torch.empty_like(q)
    b, sq, h, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    start = kw["kv_start"]
    bits = 8 if k.dtype == torch.int8 else 4
    tail = (b, sq, h, hkv, skv, d, bits, kw["q_offset"], int(kw["kv_valid_len"]), 1, int(kw["window"] or 0))
    splits = [tree_flash_quant_splits(var, b, sq, skv, h, d, bits, kw["window"], kw["q_offset"],
                                      int(kw["kv_valid_len"]))] if var["with_splits"] else []
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (k.data_ptr(), v.data_ptr(), ks.data_ptr(), vs.data_ptr(), out.data_ptr(),
            start.data_ptr() if start is not None else None, *[None] * var["dev_scalars"])
    c = torch.tensor(d**-0.5 * LOG2E, dtype=q.dtype, device=q.device)

    def run():
        if var["with_q_scale"]:
            err = var["fn"](q.data_ptr(), *ptrs, *tail, quant_q_scale(d**-0.5), *splits, stream)
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

    rows = chip_smoke.QUANT_FLASH_ROWS_256 if args.wide else chip_smoke.QUANT_FLASH_ROWS
    if args.rows == "main":
        rows = [rows[chip_smoke.MAIN_ROW["flash_attention_quant" + ("@256" if args.wide else "")]]]
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
    """--kernel paged: every row of chip_smoke.PAGED_ROWS (or the main row;
    with --wide at head_dim 256),
    against decode_attention_paged_ref on the pools with the unseen rows
    zeroed."""
    from mllm_tpu_torch.ops.decode_attention import decode_attention_paged_ref

    rows = chip_smoke.PAGED_ROWS
    if args.rows == "main":
        rows = [rows[chip_smoke.MAIN_ROW["decode_attention_paged"]]]
    g = torch.Generator(device=dev).manual_seed(1234)
    for row in rows:
        geo = chip_smoke.WIDE_GEO if args.wide else (chip_smoke.H, chip_smoke.HKV, chip_smoke.D)
        q, kp, vp, table, kw, shape, plain_pools, dense = chip_smoke.paged_inputs(row, dev, g, geo)
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
    and int4 (or the main row at both), against decode_attention_quant_ref;
    at WIDE_GEO with --wide, at GEO64 with --geo64."""
    from mllm_tpu_torch.ops.decode_attention import decode_attention_quant_ref

    rows = chip_smoke.QUANT_DECODE_ROWS
    if args.rows == "main":
        rows = [rows[chip_smoke.MAIN_ROW["decode_attention_quant" + ("@256" if args.wide else "")]]]
    geo = chip_smoke.WIDE_GEO if args.wide else chip_smoke.GEO64 if args.geo64 else (chip_smoke.H, chip_smoke.HKV,
                                                                                     chip_smoke.D)
    g = torch.Generator(device=dev).manual_seed(1234)
    for bits in (8, 4):
        for row in rows:
            q, kops, pops, kw, shape, dense = chip_smoke.quant_decode_inputs(row, bits, dev, g, geo)
            ref = decode_attention_quant_ref(q, *pops, **kw).float()
            runs = [quant_caller(var, q, kops, kw, dense, row) for var in variants]
            kb = 2 * (geo[2] if bits == 8 else geo[2] // 2) + 8
            time_variants(args, variants, runs, ref, shape, chip_smoke.attention_bound(shape, kb)["bound_ms"])


# --kernel flash --geo64 (rows all) adds these chunks of a chunked prefill at
# GEO64 (FLASH_ROWS' fields): 512 rows at q_offset 1024 and 256 at 1280 (the
# smoke's NARROW_SCALAR_ROWS; the second is what `demo_llm --chunked 256`
# sends), and the last 128 rows of 1536: chunks with fewer units than SMs
FLASH64_CHUNK_ROWS = [(1, 512, 1024, 1536, None, None, False), (1, 256, 1280, 1536, None, None, False),
                      (1, 128, 1408, 1536, None, None, False)]


def flash_probe_rows(h: int) -> list:
    """--kernel flash --geo64 | --geo80 --rows probe, after the main row:
    (B, Sq, Skv, causal) rows that separate a CTA's fixed cost from its
    slope, non-causal: one q-tile over 1, 4 and 12 key tiles (h CTAs, one
    an SM), then 1-4 rounds of CTAs: 128 r CTAs (the card holds 132 at once)
    each walking 4 key tiles."""
    return [(1, 128, 128 * n, False) for n in (1, 4, 12)] + [(1, 128 * 128 * r // h, 512, False) for r in (1, 2, 3, 4)]


def run_flash_rows(args, variants, dev, geo, rows, g) -> None:
    """Each (B, Sq, Skv, causal) row at geo = (H, H_kv, D): q [B, Sq, H, D],
    K/V [B, H_kv, Skv, D], every key valid, q_offset Skv - Sq when causal;
    timed against flash_attention_ref beside the bound of its visible pairs."""
    h, hkv, d = geo
    for b, sq, skv, causal in rows:
        q = torch.randn(b, sq, h, d, device=dev, generator=g).to(torch.bfloat16)
        k, v = (torch.randn(b, hkv, skv, d, device=dev, generator=g).to(torch.bfloat16) for _ in range(2))
        qoff = skv - sq if causal else 0
        kw = dict(q_offset=qoff, kv_valid_len=skv, window=None, causal=causal)
        ref = flash_attention_ref(q, k, v, **kw).float()
        shape = dict(B=b, Sq=sq, Skv=skv, H=h, Hkv=hkv, D=d, q_offset=qoff, kv_valid=skv, causal=causal)
        runs = [caller("flash", var, q, k, v, kw) for var in variants]
        pairs = sum(min(skv, qoff + t + 1) for t in range(sq)) if causal else sq * skv
        nbound = chip_smoke.bound(2 * b * sq * h * d * 2 + skv * b * hkv * d * 2 * 2, 4 * b * pairs * h * d)
        time_variants(args, variants, runs, ref, shape, nbound["bound_ms"])


def main_geo80(args, variants, dev):
    """--kernel flash --geo80: chip_smoke.FLASH80_ROWS (the Qwen2-VL tower's
    attention: non-causal, 16 / 16 heads of 80), against flash_attention_ref;
    `--rows probe`: the main row, then flash_probe_rows at that geometry."""
    h, hkv, d = chip_smoke.FLASH80_GEO
    rows = chip_smoke.FLASH80_ROWS[:1] if args.rows in ("main", "probe") else chip_smoke.FLASH80_ROWS
    g = torch.Generator(device=dev).manual_seed(1234)
    for b, s, kvl, poisoned in rows:
        q = torch.randn(b, s, h, d, device=dev, generator=g).to(torch.bfloat16)
        k, v = (torch.randn(b, hkv, s, d, device=dev, generator=g).to(torch.bfloat16) for _ in range(2))
        kp, vp = k, v
        if poisoned:
            (k, kp), (v, vp) = (chip_smoke.poison_outside(x, [0] * b, [kvl] * b) for x in (k, v))
        kw = dict(q_offset=0, kv_valid_len=kvl, window=None, causal=False)
        ref = flash_attention_ref(q, kp, vp, kv_valid_len=kvl, causal=False).float()
        shape = dict(B=b, Sq=s, Skv=s, H=h, Hkv=hkv, D=d, kv_valid=kvl, causal=False, poisoned=poisoned)
        runs = [caller("flash", var, q, k, v, kw) for var in variants]
        nbound = chip_smoke.bound(2 * b * s * h * d * 2 + kvl * hkv * d * 2 * 2, 4 * b * s * kvl * h * d)
        time_variants(args, variants, runs, ref, shape, nbound["bound_ms"])
    if args.rows == "probe":
        run_flash_rows(args, variants, dev, chip_smoke.FLASH80_GEO, flash_probe_rows(h), g)


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--kernel", choices=("flash", "decode", "decode_quant", "paged", "flash_quant"), required=True)
    ap.add_argument("--variant", action="append", required=True)
    ap.add_argument("--rows", choices=("main", "probe", "all"), default="all")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--wide", action="store_true", help="the kernel's rows at head_dim 256")
    ap.add_argument("--geo64", action="store_true",
                    help="the kernel's rows at head_dim 64 (chip_smoke.GEO64; decode_quant too)")
    ap.add_argument("--geo80", action="store_true", help="flash only: chip_smoke.FLASH80_ROWS (non-causal, 80)")
    ap.add_argument("--sass", action="store_true", help="print a digest of each built kernel's SASS")
    args = ap.parse_args()
    chip_smoke.phase_device()
    dev = torch.device("cuda", 0)
    out_dir = os.path.join(os.path.dirname(_build.library_path()), "tune")
    os.makedirs(out_dir, exist_ok=True)
    variants = [parse_variant(s) for s in args.variant]
    handles = build_variants(args.kernel, [v for v in variants if v["name"] not in YARDSTICKS], out_dir,  # noqa: F841
                             args.sass)
    if args.kernel == "decode_quant":
        return main_quant(args, variants, dev)
    if args.kernel == "paged":
        return main_paged(args, variants, dev)
    if args.kernel == "flash_quant":
        return main_flash_quant(args, variants, dev)
    if args.geo80:
        return main_geo80(args, variants, dev)
    kind = "flash_attention" if args.kernel == "flash" else "decode_attention"
    flash = args.kernel == "flash"
    if args.wide:
        row_list = chip_smoke.FLASH_ROWS_256 if flash else chip_smoke.DECODE_ROWS_256
        geo, main_row = chip_smoke.WIDE_GEO, chip_smoke.MAIN_ROW[kind + "@256"]
    elif args.geo64:
        row_list = chip_smoke.FLASH_ROWS_64 if flash else chip_smoke.DECODE_ROWS_64
        geo, main_row = chip_smoke.GEO64, chip_smoke.MAIN_ROW[kind + "@64"]
    else:
        row_list = chip_smoke.FLASH_ROWS if flash else chip_smoke.DECODE_ROWS
        geo, main_row = (chip_smoke.H, chip_smoke.HKV, chip_smoke.D), chip_smoke.MAIN_ROW[kind]
    if args.rows == "main":
        row_list = [row_list[main_row]]
    elif args.rows == "probe" and not (flash and args.geo64):  # the main row, then one tile of keys at its batch
        one_tile = (row_list[main_row][0], 128, 0, 128, None, None, False) if flash else \
            (row_list[main_row][0], [64] * row_list[main_row][0], None, None, False)
        row_list = [row_list[main_row], one_tile]
    elif args.rows == "probe":  # flash at 64: the main row, then flash_probe_rows
        row_list = [row_list[main_row]]
    plain = flash_attention_ref if args.kernel == "flash" else decode_attention_ref
    g = torch.Generator(device=dev).manual_seed(1234)
    rows = [(row, geo) for row in row_list]
    if flash and args.geo64 and args.rows == "all":  # chunks over a longer cache; the bench's other GQA ratios
        rows += [(row, geo) for row in FLASH64_CHUNK_ROWS]
        rows += [(row_list[main_row], g64) for g64 in chip_smoke.FLASH64_GQA_GEOS.values()]
    for row, geo in rows:
        q, k, v, kp, vp, kw, shape = chip_smoke.attention_inputs(kind, row, dev, g, geo)
        ref = plain(q, kp, vp, **kw).float()
        runs = [caller(args.kernel, var, q, k, v, kw) for var in variants]
        time_variants(args, variants, runs, ref, shape, chip_smoke.attention_bound(shape)["bound_ms"])
    if flash and args.geo64 and args.rows == "probe":
        run_flash_rows(args, variants, dev, geo, flash_probe_rows(geo[0]), g)


if __name__ == "__main__":
    main()
