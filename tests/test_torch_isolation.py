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


_FAMILIES_PROBE = """
import sys
from mllm_tpu_torch.models import bridge, families, loading, moe, registry, transformer
from mllm_tpu_torch.nn.layers import IRotaryEmbedding, LayerNorm, LongRopeEmbedding
from mllm_tpu_torch.ops.quantize_model import quantize_model
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib") or m == "mllm_tpu" or m.startswith("mllm_tpu."))
assert not bad, bad
print("ok")
"""


def test_moe_and_family_modules_import_no_jax():
    """The MoE layers, the family loaders and presets and the new layers,
    imported on their own, pull in neither JAX nor mllm_tpu."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", _FAMILIES_PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "ok"


_WAY_IN_PROBE = """
import sys
import chip_smoke
from mllm_tpu_torch import serve
from mllm_tpu_torch.core import dtypes, gguf, param_loader
from mllm_tpu_torch.models.registry import auto_model, open_loader
from mllm_tpu_torch.tokenizers import base, bpe, chat_templates, hf_json, tiktoken, unigram, wordpiece
from mllm_tpu_torch.utils import log, metrics
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib") or m == "mllm_tpu" or m.startswith("mllm_tpu."))
assert not bad, bad
assert "regex" not in sys.modules, "importing the tokenizers imported regex"
print("ok")
"""


def test_way_in_modules_and_smoke_import_no_jax():
    """The tokenizers, containers, metrics, the server and chip_smoke.py pull
    in neither JAX nor mllm_tpu; `regex` waits until a tokenizer needs it."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", _WAY_IN_PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "ok"


_VL_PROBE = """
import sys
from mllm_tpu_torch.models import clip, qwen2_5_vl, qwen2_vl, vit
from mllm_tpu_torch.models.bridge import clip_from_jax_params, qwen2_vl_from_jax_params, vit_from_jax_params
from mllm_tpu_torch.models.registry import auto_model_any
from mllm_tpu_torch.nn.attention import attend_padded_head
from mllm_tpu_torch.nn.layers import Conv2d, Conv3d, MultimodalRotaryEmbedding, VisionRotaryEmbedding
from mllm_tpu_torch.processor import image, qwen2_vl as processor
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib") or m == "mllm_tpu" or m.startswith("mllm_tpu."))
assert not bad, bad
assert "PIL" not in sys.modules, "importing the processors imported PIL"
print("ok")
"""


def test_vision_language_modules_import_no_jax():
    """The processors, the Qwen2-VL / Qwen2.5-VL / CLIP / ViT models, their
    bridge and the VL layers pull in neither JAX nor mllm_tpu, and PIL waits
    until an image is decoded or resized on the host."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", _VL_PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "ok"


_ANY_PROBE = """
import sys
from mllm_tpu_torch.models import bert, fuyu, imagebind, llava, opt, phi3v
from mllm_tpu_torch.models.bridge import (bert_from_jax_params, fuyu_from_jax_params, imagebind_from_jax_params,
                                          llava_from_jax_params, opt_from_jax_params, phi3v_from_jax_params)
from mllm_tpu_torch.processor import audio
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib") or m == "mllm_tpu" or m.startswith("mllm_tpu."))
assert not bad, bad
print("ok")
"""


def test_auto_model_any_families_import_no_jax():
    """LLaVA, Phi-3-V, Fuyu, ImageBind, OPT, BERT, their bridge and the audio
    copy pull in neither JAX nor mllm_tpu."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", _ANY_PROBE], cwd=REPO, env=env,
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
    assert set(_build.SIGNATURES) == {"mllm_flash_attention_bf16", "mllm_flash_max_clusters", "mllm_decode_attention_bf16",
                                      "mllm_flash_attention_quant", "mllm_flash_quant_max_clusters",
                                      "mllm_decode_attention_quant",
                                      "mllm_decode_attention_paged_bf16",
                                      "mllm_int8_matmul_bf16", "mllm_int8_gemm_bf16", "mllm_int8_max_clusters",
                                      "mllm_int4_matmul_bf16",
                                      "mllm_fused_int4_mlp_bf16", "mllm_fused_int4_mlp_blocks",
                                      "mllm_fused_decode_step_bf16",
                                      "mllm_fused_decode_step_batched_bf16"}


_LAST_MODULES_PROBE = """
import sys
from mllm_tpu_torch.kv.persist import load_cache, save_cache
from mllm_tpu_torch.models import deepseek, elastic, openelm
from mllm_tpu_torch.models.moe import MBPMoEMLP, mbp_forward, to_mbp
from mllm_tpu_torch.nn.layers import ElasticLinear, PredictorSparseMLP
from mllm_tpu_torch.utils import mbp, profiling
from mllm_tpu_torch.utils.metrics import cost_table
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib") or m == "mllm_tpu" or m.startswith("mllm_tpu."))
assert not bad, bad
print("ok")
"""


def test_mla_openelm_elastic_mbp_persist_profiling_import_no_jax():
    """DeepSeek / MiniCPM3, OpenELM, the elastic and sparse models, MBP, the
    cache snapshots and the profiling tools, imported on their own, pull in
    neither JAX nor mllm_tpu."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", _LAST_MODULES_PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "ok"


_PARALLEL_PROBE = """
import sys
from mllm_tpu_torch.training import lora, train
from mllm_tpu_torch.parallel import (comm, dryrun, expert, heads, multihost, pipeline, ring_attention, sharding,
                                     ulysses)
from mllm_tpu_torch.core.param_loader import save_safetensors_model, write_safetensors
import torch_dist_cases
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax", "orbax") or m == "mllm_tpu" or m.startswith("mllm_tpu."))
assert not bad, bad
print("ok")
"""


def test_training_and_parallel_modules_import_no_jax():
    """The training and parallel modules, the safetensors writer and the
    multi-rank tests' rank side (tests/torch_dist_cases.py, which the
    spawned ranks import), imported on their own, pull in neither JAX (nor
    optax / orbax) nor mllm_tpu."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.pathsep.join([REPO, os.path.join(REPO, "tests")])
    proc = subprocess.run([sys.executable, "-c", _PARALLEL_PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "ok"
