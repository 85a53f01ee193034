"""Builds the hand-written CUDA kernels and binds them with ctypes.

At first use, `nvcc` compiles every `csrc/*.cu` into one shared library with a
plain C interface, for `sm_90a` (Hopper). The library is named by a hash of
the sources (`*.cu` and `*.cuh`), so an edited source builds anew and an
unchanged one is loaded as it is. Importing this module builds nothing.

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
import time

from ..utils.runtime import csrc_dir, kernel_build_dir

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# name -> argtypes of the C entry points in csrc/
SIGNATURES = {
    # q, k, v, out, kv_valid_vec, kv_start, B, Sq, H, Hkv, Skv, D,
    # q_offset, kv_valid, causal, window, scale_log2, stream
    "mllm_flash_attention_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _I, _I, _I, _I, _F, _P],
    # q, k, v, out, kv_valid_vec, kv_start, B, H, Hkv, S, D,
    # kv_valid, window, scale_log2, stream
    "mllm_decode_attention_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _I, _I, _F, _P],
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
    h.update(" ".join(NVCC_FLAGS).encode())
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
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *sources()]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent reader never sees half a library
    return out, log, seconds


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
