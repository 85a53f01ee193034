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


_SERVING_PROBE = """
import sys
from mllm_tpu_torch.generation.engine import ContinuousEngine, collect
from mllm_tpu_torch.kv.cache import PagedKVCache, SlotKVCache, SlotQuantKVCache
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib") or m == "mllm_tpu" or m.startswith("mllm_tpu."))
assert not bad, bad
print("ok")
"""


def test_serving_modules_import_no_jax():
    """The engine and the KV caches, imported on their own, pull in neither."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", _SERVING_PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "ok"


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
    assert names == ["decode_attention.cu", "decode_attention_paged.cu", "decode_attention_quant.cu",
                     "decode_step.cu", "flash_attention.cu", "flash_attention_quant.cu",
                     "fused_int4_mlp.cu", "int4_matmul.cu", "int8_matmul.cu"]
    assert set(_build.SIGNATURES) == {"mllm_flash_attention_bf16", "mllm_decode_attention_bf16",
                                      "mllm_flash_attention_quant", "mllm_decode_attention_quant",
                                      "mllm_decode_attention_paged_bf16",
                                      "mllm_int8_matmul_bf16", "mllm_int8_gemm_bf16", "mllm_int8_max_clusters",
                                      "mllm_int4_matmul_bf16",
                                      "mllm_fused_int4_mlp_bf16", "mllm_fused_int4_mlp_blocks",
                                      "mllm_fused_decode_step_bf16",
                                      "mllm_fused_decode_step_batched_bf16"}
