"""mllm_tpu_torch stands alone: importing every module of it pulls in
neither JAX nor mllm_tpu, and builds no kernel. Checked in a fresh
interpreter, because this test process has imported JAX already."""

import os
import subprocess
import sys

import pytest

from mllm_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import mllm_tpu_torch
from mllm_tpu_torch.ops import _build
names = [m.name for m in pkgutil.walk_packages(mllm_tpu_torch.__path__, "mllm_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib") or m == "mllm_tpu" or m.startswith("mllm_tpu."))
assert not bad, bad
assert _build.build.cache_info().currsize == 0, "importing built the kernels"
print(len(names))
"""


def test_port_imports_no_jax_and_builds_nothing():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20  # every module of the package was imported


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "library_path", lambda: str(tmp_path / "libmissing.so"))
    _build.build.cache_clear()
    try:
        with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
            _build.build()
    finally:
        _build.build.cache_clear()


def test_sources_are_the_kernels():
    names = sorted(os.path.basename(p) for p in _build.sources())
    assert names == ["decode_attention.cu", "flash_attention.cu", "fused_int4_mlp.cu",
                     "int4_matmul.cu", "int8_matmul.cu", "split_k.cu"]
    assert set(_build.SIGNATURES) == {"mllm_flash_attention_bf16", "mllm_decode_attention_bf16",
                                      "mllm_int8_matmul_bf16", "mllm_int4_matmul_bf16",
                                      "mllm_fused_int4_mlp_bf16"}
