"""The port's reference-parity tool (`mllm_tpu_torch.tools.reference_parity`)
against the JAX tool (`tools/reference_parity.py`, imported by path) and the
C++ engine's goldens (`tests/goldens/reference_qwen05b.json`,
`reference_tinyllama.json`).

- The generated checkpoints at a tiny override of each geometry (the
  vocabulary kept, so the goldens' ids fit): the port's tensors, written by
  its own safetensors writer, bit-equal to the JAX tool's (written by the
  `safetensors` package); config.json equal.
- `greedy_ids` on such a checkpoint from each golden's `input_ids`: the ids
  equal to the JAX tool's decode (its `run_local` loop, f32 on the CPU).
- The tokenizer half (the port's BPE over the reference's vocab files) runs
  where the JAX test runs it, and skips where it skips
  (`tests/test_reference_parity.py`'s paths).
- The full-geometry parity is opt-in under MLLM_RUN_PARITY=1, as in the
  JAX test: all 32 golden output ids.
- The CLI writes through `--gen`, and `--run` without `--device cpu` raises
  `default_device`'s error here.
"""

import functools
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_reference_parity as jtest
from mllm_tpu.models.registry import auto_model as jax_auto_model
from mllm_tpu_torch.tools import reference_parity as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
TINY = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=4)
TINY_TL = dict(hidden_size=64, intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2)
FAMILIES = {"qwen05b": ("GEOM", TINY, "gen_checkpoint", jtest.GOLDEN),
            "tinyllama": ("TINYLLAMA_GEOM", TINY_TL, "gen_checkpoint_tinyllama", jtest.GOLDEN_TL)}


@functools.lru_cache(maxsize=None)
def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_reference_parity",
                                                  os.path.join(REPO, "tools", "reference_parity.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _golden(path):
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def tiny_dirs(tmp_path_factory):
    """family -> (the port's directory, the JAX tool's directory), both at the
    tiny override of the family's geometry."""
    jtool = _jax_tool()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for family, (attr, over, gen, _) in FAMILIES.items():
            geom = dict(getattr(port, attr), **over)
            mp.setattr(port, attr, geom)
            mp.setattr(jtool, attr, geom)
            root = tmp_path_factory.mktemp(family)
            getattr(port, gen)(str(root / "port"))
            getattr(jtool, gen)(str(root / "jax"))
            out[family] = (str(root / "port"), str(root / "jax"))
    return out


@pytest.mark.parametrize("family", list(FAMILIES))
def test_generated_tensors_bit_equal_jax(tiny_dirs, family):
    from safetensors.numpy import load_file

    mine, theirs = tiny_dirs[family]
    got, want = (load_file(os.path.join(p, "model.safetensors")) for p in (mine, theirs))
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        assert got[name].dtype == arr.dtype == np.float32 and got[name].shape == arr.shape, name
        assert np.array_equal(got[name].view(np.uint32), arr.view(np.uint32)), name
    cfgs = [json.load(open(os.path.join(p, "config.json"))) for p in (mine, theirs)]
    assert cfgs[0] == cfgs[1]
    assert got["model.embed_tokens.weight"].shape[0] == cfgs[0]["vocab_size"]  # the vocabulary kept


def _jax_greedy(path: str, ids: list, new: int) -> list:
    """The JAX tool's `run_local` loop from given ids."""
    with jax.default_device(jax.devices("cpu")[0]):
        model, _, _ = jax_auto_model(path, dtype=jnp.float32, with_tokenizer=False)
        cache = model.init_cache(1, len(ids) + new + 8, jnp.float32)
        logits, cache = model(jnp.asarray(np.asarray(ids, np.int32)[None]), cache, last_only=True)
        out = []
        tok = jnp.argmax(logits[:, -1], axis=-1)
        for _ in range(new):
            out.append(int(tok[0]))
            logits, cache = model(tok[:, None].astype(jnp.int32), cache, last_only=True)
            tok = jnp.argmax(logits[:, -1], axis=-1)
        return out


@pytest.mark.parametrize("family", list(FAMILIES))
def test_greedy_ids_equal_jax_from_the_golden_input_ids(tiny_dirs, family):
    golden = _golden(FAMILIES[family][3])
    ids, new = golden["input_ids"], len(golden["output_ids"])
    stats = {}
    got = port.greedy_ids(tiny_dirs[family][0], ids, new, device=CPU, stats=stats)
    assert got == _jax_greedy(tiny_dirs[family][1], ids, new)
    assert len(stats["top2_gaps"]) == new and min(stats["top2_gaps"]) >= 0


def test_greedy_ids_refuses_tf32(tiny_dirs, monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(AssertionError, match="TF32"):
        port.greedy_ids(tiny_dirs["qwen05b"][0], [1, 2, 3], 2, device=CPU)


@pytest.mark.skipif(not os.path.exists(jtest.VOCAB), reason="reference vocab assets absent")
def test_tokenizer_matches_reference():
    assert port.chat_ids(jtest.VOCAB, jtest.MERGES) == _golden(jtest.GOLDEN)["input_ids"]


@pytest.mark.skipif(not os.path.exists(jtest.VOCAB_TL), reason="reference vocab assets absent")
def test_tinyllama_tokenizer_matches_reference():
    assert port.tinyllama_chat_ids(jtest.VOCAB_TL) == _golden(jtest.GOLDEN_TL)["input_ids"]


@pytest.mark.skipif(os.environ.get("MLLM_RUN_PARITY") != "1",
                    reason="set MLLM_RUN_PARITY=1 (writes the 1.9 GB and 4.4 GB checkpoints and decodes "
                           "them in f32 on the CPU for minutes)")
@pytest.mark.parametrize("family", list(FAMILIES))
def test_reference_parity_full_geometry(tmp_path, family):
    golden = _golden(FAMILIES[family][3])
    getattr(port, FAMILIES[family][2])(str(tmp_path))
    got = port.greedy_ids(str(tmp_path), golden["input_ids"], len(golden["output_ids"]), device=CPU)
    assert got == golden["output_ids"]


def test_cli_gen_and_run_needs_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(port, "TINYLLAMA_GEOM", dict(port.TINYLLAMA_GEOM, **TINY_TL, vocab_size=64))
    port.main(["--gen", str(tmp_path), "--family", "tinyllama"])
    cfg = json.load(open(tmp_path / "config.json"))
    assert cfg["model_type"] == "llama" and cfg["vocab_size"] == 64
    assert len(port.greedy_ids(str(tmp_path), [1, 5, 9], 3, device=CPU)) == 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="found none"):
        port.main(["--run", str(tmp_path), "--family", "tinyllama", "--vocab", "absent.mllm"])
