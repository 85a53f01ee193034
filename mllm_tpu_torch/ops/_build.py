"""Builds the hand-written CUDA kernels and binds them with ctypes.

At first use, `nvcc` compiles every `csrc/*.cu` for `sm_90a` (Hopper), one
compiler process per source, all started together, and links the objects into
one shared library with a plain C interface. The library is named by a hash of
the sources (`*.cu` and `*.cuh`) and flags, so an edited source builds anew and
an unchanged one is loaded as it is. Importing this module builds nothing.

Each exported function takes device pointers and the stream as `void*`,
launches on that stream without synchronising, and returns the CUDA error
code of the launch.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

from ..utils.runtime import csrc_dir, kernel_build_dir

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c")
LINK_FLAGS = (*ARCH_FLAGS, "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# the megakernel's shared tail: qkv_q, qkv_s, qkv_b, o_q, o_s, g_q, g_s, u_q, u_s,
# d_q, d_s, n1, n2, k_cache, v_cache, y, k_new, v_new, ws, plan, L, d, ff, h, hkv,
# S, group_a, group_d, block_f, act, eps, rm, scale, stream
_MEGA_COMMON = [*[_P] * 20, *[_I] * 10, _F, _F, _F, _P]

# name -> argtypes of the C entry points in csrc/
SIGNATURES = {
    # q, k, v, out, kv_valid_vec, kv_start, q_offset_dev, B, Sq, H, Hkv, Skv, D,
    # q_offset, kv_valid, causal, window, scale_log2, splits, stream
    "mllm_flash_attention_bf16": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _I, _I, _I, _I, _F, _I, _P],
    # cluster, out (int32*)
    "mllm_flash_max_clusters": [_I, _P],
    # q, k, v, out, kv_valid_vec, kv_start, B, H, Hkv, S, D,
    # kv_valid, window, scale_log2, splits, stream
    "mllm_decode_attention_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _I, _I, _F, _I, _P],
    # q, k, v, k_scale, v_scale, out, kv_valid_vec, kv_start, B, H, Hkv, S, D,
    # bits, kv_valid, window, scale, splits, stream
    "mllm_decode_attention_quant": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                    _I, _I, _I, _F, _I, _P],
    # q (raw, bf16), k, v, k_scale, v_scale, out, kv_start, kv_valid_vec,
    # q_offset_dev, B, Sq, H, Hkv, Skv, D, bits, q_offset, kv_valid, causal,
    # window, q_scale, splits, stream; q_scale is f32(bf16(scale * log2 e)):
    # the kernel takes bf16(f32(q) * q_scale)
    "mllm_flash_attention_quant": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                   _I, _I, _I, _I, _I, _F, _I, _P],
    # bits, cluster, out (int32*)
    "mllm_flash_quant_max_clusters": [_I, _I, _P],
    # q, k_pool, v_pool, table, out, kv_valid_vec, B, H, Hkv, NB, MAXB, D,
    # kv_valid, window, scale_log2, splits, stream
    "mllm_decode_attention_paged_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                         _I, _I, _F, _I, _P],
    # x, q, s, out, M, K, N, tn, cluster, rows_per, clusters, mt8, stream
    "mllm_int8_matmul_bf16": [*[_P] * 4, *[_I] * 8, _P],
    # x, q, s, out, M, K, N, bm, cluster, kper, clusters, stream
    "mllm_int8_gemm_bf16": [*[_P] * 4, *[_I] * 7, _P],
    # gemm (rows of x a wgmma tile, 0: the stream), mt8, tn, cluster, rows_per, out (int*)
    "mllm_int8_max_clusters": [*[_I] * 5, _P],
    # x, q, s, z, out, ws, counters, M, K, N, khp, full, splits, split_rows, chunk_rows, mt8,
    # stream
    "mllm_int4_matmul_bf16": [*[_P] * 7, *[_I] * 9, _P],
    # x, gq, gs, gz, uq, us, uz, dq, ds, dz, ws, counters, out, M, d, khp, ff, d_out,
    # block_f, act, mt8, splits_a, rows_a, splits_b, rows_b, chunk_rows, grid, stream
    "mllm_fused_int4_mlp_bf16": [*[_P] * 13, *[_I] * 14, _P],
    # mt8, affine, chunk_rows, out (int*)
    "mllm_fused_int4_mlp_blocks": [_I, _I, _I, _P],
    # x, rope_r, pos_dev, pos, kv_start, *_MEGA_COMMON
    "mllm_fused_decode_step_bf16": [_P, _P, _P, _I, _I, *_MEGA_COMMON],
    # x, cos, sin, pos_vec, kvs_vec, pos, kv_start, b, *_MEGA_COMMON
    "mllm_fused_decode_step_batched_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, *_MEGA_COMMON],
}


class KernelBuildError(RuntimeError):
    """nvcc is missing, or it refused the sources."""


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(csrc_dir(), "*.cu")))


def source_hash() -> str:
    h = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(csrc_dir(), "*.cu*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    return h.hexdigest()[:16]


def find_nvcc() -> str | None:
    """nvcc on PATH, else in the CUDA toolkit that PyTorch finds
    ($CUDA_HOME, $CUDA_PATH, or the default install location)."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.isfile(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    return None


def library_path() -> str:
    return os.path.join(kernel_build_dir(), f"libmllm_tpu_torch_{source_hash()}.so")


@functools.cache
def build() -> tuple[str, str, float]:
    """Compile the kernels if their library is not built yet.

    Returns (library path, compiler output, seconds spent compiling). Raises
    KernelBuildError with the compiler's output when nvcc is missing or fails.
    """
    out = library_path()
    if os.path.exists(out):
        return out, "", 0.0
    nvcc = find_nvcc()
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found (PATH, $CUDA_HOME/bin, $CUDA_PATH/bin): the CUDA kernels of "
            "mllm_tpu_torch are compiled from csrc/ at first use and need the CUDA toolkit")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.dirname(out)) as objdir:
        jobs = []
        for src in sources():
            obj = os.path.join(objdir, os.path.basename(src) + ".o")
            cmd = [nvcc, *COMPILE_FLAGS, "-o", obj, src]
            jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.STDOUT, text=True)))
        log, failed = "", []
        for cmd, _, proc in jobs:  # each compiler's output is small: pipes do not fill
            text = proc.communicate()[0]
            log += text
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{text}")
        if failed:
            raise KernelBuildError("\n".join(failed))
        cmd = [nvcc, *LINK_FLAGS, "-o", tmp, *(obj for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise KernelBuildError(f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent reader never sees half a library
    return out, log, time.perf_counter() - t0


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library, with argtypes and restype declared."""
    path, _, _ = build()
    lib = ctypes.CDLL(path)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
