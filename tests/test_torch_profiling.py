"""The port's profiling report and cost table against mllm_tpu's:
`Profiler.report` prints the JAX text, `timer` times a block, `torch_trace`
writes a non-empty Chrome trace, and `cost_table` counts the FLOPs and
bytes XLA counts for a product and a small chain, with the JAX keys and the
roofline on the H100's peaks."""

import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mllm_tpu.utils import metrics as jmetrics
from mllm_tpu.utils import profiling as jprof
from mllm_tpu_torch.utils import metrics as tmetrics
from mllm_tpu_torch.utils import profiling as tprof


@pytest.mark.parametrize("kw", [dict(), dict(tag="qwen2 1.5B", compile_s=12.345)], ids=["plain", "tag_compile"])
def test_report_text_equals_jax(kw, capsys):
    figures = dict(load_s=1.23456, prefill_tps=987.65, ttft_s=0.0421, decode_tps=55.5)
    tag = kw.pop("tag", "")
    jprof.Profiler(**figures, **kw).report(tag)
    want = capsys.readouterr().out
    tprof.Profiler(**figures, **kw).report(tag)
    assert capsys.readouterr().out == want
    assert "Decode speed: 55.5 tokens/s" in want


def test_timer():
    with tprof.timer() as box:
        sum(range(1000))
    assert box["s"] > 0


def test_torch_trace_writes_a_trace(tmp_path):
    with tprof.torch_trace(str(tmp_path / "trace")) as path:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(path) as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])


@pytest.mark.parametrize("m,k,n", [(64, 32, 16), (8, 128, 256)])
def test_cost_table_of_a_product_equals_jax(m, k, n):
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((m, k)).astype(np.float32), rng.standard_normal((k, n)).astype(np.float32)
    want = jmetrics.cost_table(lambda x, y: x @ y, jnp.asarray(a), jnp.asarray(b))
    got = tmetrics.cost_table(lambda x, y: x @ y, torch.from_numpy(a), torch.from_numpy(b))
    assert set(got) == set(want)
    assert got["flops"] == want["flops"] == 2 * m * k * n
    assert got["bytes_accessed"] == want["bytes_accessed"] == 4 * (m * k + k * n + m * n)
    assert got["roofline_compute_ms"] == got["flops"] / 989e12 * 1e3
    assert got["roofline_memory_ms"] == got["bytes_accessed"] / 3.35e12 * 1e3
    assert got["bound"] == want["bound"] == "memory"


def test_cost_table_counts_every_aten_op():
    """A chain of two products and an add: FLOPs of the products only, bytes
    of every operation's inputs and outputs; kwargs reach the function."""
    a, b, c = torch.ones(16, 32), torch.ones(32, 8), torch.ones(8, 4)
    got = tmetrics.cost_table(lambda x, y, z, shift=0.0: (x @ y) @ z + shift, a, b, c, shift=1.0)
    assert got["flops"] == 2 * 16 * 32 * 8 + 2 * 16 * 8 * 4
    assert got["bytes_accessed"] >= 4 * (16 * 32 + 32 * 8 + 16 * 8) + 4 * (16 * 8 + 8 * 4 + 16 * 4)
