"""The port's server flags and its tiny-fixture tool.

- `python -m mllm_tpu_torch.serve` takes every flag of `examples/serve.py`
  (read from its source), each choice of it (`-q int4-mixed` included),
  with the JAX server's defaults, and refuses a mode the JAX server does
  not offer.
- `mllm_tpu_torch.tools.make_tiny_fixtures` writes the JAX tool's two
  directories (`tools/make_tiny_fixtures.py`, imported by path, run into
  another directory): the same config.json and tensors, a tokenizer.json of
  the same size and specials (the `tokenizers` trainer starts from 64
  characters of an unordered list, so its tokens vary from run to run in
  both tools) that both packages' tokenizers read alike; each directory
  loads in both packages with equal greedy ids in f32.
"""

import ast
import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_tpu.generation import generate as jgen
from mllm_tpu.generation.sampling import SamplingConfig as JaxSamplingConfig
from mllm_tpu.core.param_loader import SafetensorsLoader as JaxLoader
from mllm_tpu.models import qwen2_vl as jvl
from mllm_tpu.models.registry import auto_model as jax_auto_model
from mllm_tpu_torch import serve
from mllm_tpu_torch.core.param_loader import SafetensorsLoader
from mllm_tpu_torch.generation.generate import generate
from mllm_tpu_torch.generation.sampling import SamplingConfig
from mllm_tpu_torch.models import qwen2_vl as tvl
from mllm_tpu_torch.models.registry import auto_model
from mllm_tpu_torch.tools import make_tiny_fixtures

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
NOT_PORTED = set()  # (flag, value) pairs of the JAX server that the port leaves out: none


def _jax_server_flags() -> list:
    """(option strings, keywords) of each `add_argument` in examples/serve.py."""
    with open(os.path.join(REPO, "examples", "serve.py")) as f:
        tree = ast.parse(f.read())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument":
            names = tuple(a.value for a in node.args)
            kw = {k.arg: ast.literal_eval(k.value) for k in node.keywords if k.arg in ("choices", "default")}
            kw["type"] = next((k.value.id for k in node.keywords if k.arg == "type"), None)
            out.append((names, kw))
    return out


def test_serve_takes_every_flag_of_the_jax_server():
    flags = _jax_server_flags()
    assert len(flags) == 11  # -m -p -l -q, batch window, max batch, engine, kv, paged, image size, prefix cache
    base = serve.parse_args(["-m", "model_dir"])
    tried = 0
    for names, kw in flags:
        dest = max(names, key=len).lstrip("-").replace("-", "_")
        if dest == "model":
            assert base.model == "model_dir"
            continue
        assert getattr(base, dest) == kw.get("default"), dest  # the JAX server's default
        values = kw.get("choices") or ([7] if kw["type"] == "int" else ["x"])
        for name in names:
            for value in values:
                if (names[0], value) in NOT_PORTED:
                    continue
                got = serve.parse_args(["-m", "model_dir", name, str(value)])
                assert getattr(got, dest) == value, (name, value)
                tried += 1
    assert tried >= 20
    assert serve.parse_args(["-m", "model_dir", "-q", "int4-mixed"]).quant == "int4-mixed"
    with pytest.raises(SystemExit):
        serve.parse_args(["-m", "model_dir", "-q", "nf4"])


@pytest.fixture(scope="module")
def fixture_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("fixtures")
    spec = importlib.util.spec_from_file_location("jax_make_tiny_fixtures",
                                                  os.path.join(REPO, "tools", "make_tiny_fixtures.py"))
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    mine = make_tiny_fixtures.main(["both", "--out", str(root / "port")])
    jtool.make_text(str(root / "jax" / "tiny_qwen2"))
    jtool.make_vl(str(root / "jax" / "tiny_qwen2vl"))
    return mine, [str(root / "jax" / "tiny_qwen2"), str(root / "jax" / "tiny_qwen2vl")]


def test_fixtures_equal_the_jax_tools(fixture_dirs):
    from safetensors.numpy import load_file

    from mllm_tpu.tokenizers.hf_json import auto_tokenizer as jax_auto_tokenizer
    from mllm_tpu_torch.tokenizers.hf_json import auto_tokenizer

    mine, theirs = fixture_dirs
    assert [os.path.basename(p) for p in mine] == ["tiny_qwen2", "tiny_qwen2vl"]
    for a, b in zip(mine, theirs):
        assert json.load(open(os.path.join(a, "config.json"))) == json.load(open(os.path.join(b, "config.json")))
        # the trainer's initial alphabet is the first 64 of an unordered list, so the
        # tokens vary from run to run (in both tools): their number and the specials do not
        ka, kb = (json.load(open(os.path.join(p, "tokenizer.json"))) for p in (a, b))
        assert len(ka["model"]["vocab"]) == len(kb["model"]["vocab"])
        assert [t["content"] for t in ka["added_tokens"]] == [t["content"] for t in kb["added_tokens"]]
        text = "hello world, the quick brown fox"
        assert auto_tokenizer(a).encode(text) == jax_auto_tokenizer(a).encode(text)
        ta, tb = (load_file(os.path.join(p, "model.safetensors")) for p in (a, b))
        assert sorted(ta) == sorted(tb)
        assert all(np.array_equal(ta[k], tb[k]) for k in ta)


def test_text_fixture_greedy_equals_jax(fixture_dirs):
    path = fixture_dirs[0][0]
    ids = np.array([5, 17, 33, 90, 101, 7], np.int32)
    jm, jtok, _ = jax_auto_model(path, dtype=jnp.float32)
    want, _ = jgen.generate(jm, ids, jm.init_cache(1, 256, jnp.float32), JaxSamplingConfig(max_new_tokens=8),
                            eos_token_id=jtok.eos_token_id)
    tm, tok, _ = auto_model(path, dtype=torch.float32, device=CPU)
    got, _ = generate(tm, ids, tm.init_cache(1, 256, torch.float32), SamplingConfig(max_new_tokens=8),
                      eos_token_id=tok.eos_token_id)
    assert got.tokens == want.tokens and tok.eos_token_id == jtok.eos_token_id


def test_vl_fixture_greedy_equals_jax(fixture_dirs):
    from mllm_tpu.processor.qwen2_vl import Qwen2VLProcessor as JaxProcessor
    from mllm_tpu.tokenizers.hf_json import auto_tokenizer as jax_auto_tokenizer
    from mllm_tpu_torch.processor.qwen2_vl import Qwen2VLProcessor
    from mllm_tpu_torch.tokenizers.hf_json import auto_tokenizer

    path = fixture_dirs[0][1]
    jcfg = jvl.qwen2_vl_config_from_hf(path)
    jm = jvl.load_qwen2_vl(JaxLoader(path), jcfg, jnp.float32)
    jtok = jax_auto_tokenizer(path)
    jout = JaxProcessor(jtok, image_token_id=jcfg.image_token_id)("hello world this is a tiny fixture")
    want, _ = jvl.vl_generate(jm, jout, jm.init_cache(1, 64, jnp.float32), 8)
    cfg = tvl.qwen2_vl_config_from_hf(path)
    tm = tvl.load_qwen2_vl(SafetensorsLoader(path), cfg, device=CPU, dtype=torch.float32)
    out = Qwen2VLProcessor(auto_tokenizer(path), image_token_id=cfg.image_token_id)(
        "hello world this is a tiny fixture")
    np.testing.assert_array_equal(out.input_ids, jout.input_ids)
    got, _ = tvl.vl_generate(tm, out, tm.init_cache(1, 64, torch.float32), 8)
    assert got == want
