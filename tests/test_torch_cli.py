"""The port's demo CLIs (`mllm_tpu_torch.examples`) against the JAX
package on the same tiny checkpoint directories, run in process with
`--device cpu`.

- demo_llm, deterministic branches: greedy ids equal to the JAX package's
  own `auto_model` + loop (the JAX demo's code) in bf16, the CLI's dtype:
  plain, `-q int8`, `-q int4` (the JAX side on its canonical int4 layout
  with every projection int4, the port's only layout), `--kv int8`,
  `--chunked 8 --turns 2` (turn 2 a full prefix-cache hit), `--batch 3`
  and `--mbp 2` (a tiny qwen2_moe directory).
- demo_llm, random branches: `--sparse`, `--elastic` and sampled decoding
  (plain and chunked) against the port's functions called directly with
  the same seeded `torch.Generator`s.
- The 27 aliases: the set and each alias's default flags equal the JAX
  wrappers' (read from `examples/demo_*.py`); one alias end to end;
  demo_openelm raises NotImplementedError where the JAX package does.
- demo_sd: host and `--compiled` ids equal JAX `speculative_generate`.
- `_demo_common`: `std_parser`'s flags, `vl_decode_loop` against the JAX one.
- No CLI defaults to the CPU: without `--device cpu` each raises
  `default_device`'s error on a machine without a card.
"""

import functools
import json
import os
import pkgutil
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mllm_tpu.generation import generate as jgen
from mllm_tpu.generation.prefill import PromptCache as JaxPromptCache
from mllm_tpu.generation.prefill import prefill_with_prompt_cache as jax_prefill_with_prompt_cache
from mllm_tpu.generation.sampling import SamplingConfig as JaxSamplingConfig
from mllm_tpu.generation.sampling import sample_token as jax_sample_token
from mllm_tpu.generation.speculative import speculative_generate as jax_speculative_generate
from mllm_tpu.models import moe as jmoe
from mllm_tpu.models.registry import auto_model as jax_auto_model
from mllm_tpu.ops import quantize_model as jqmod
from mllm_tpu.tokenizers.chat_templates import render as jax_render
from mllm_tpu.utils import native as jnative
from mllm_tpu_torch import examples
from mllm_tpu_torch.core.config import TextConfig
from mllm_tpu_torch.core.param_loader import write_safetensors
from mllm_tpu_torch.examples import _demo_common, demo_llm, demo_sd
from mllm_tpu_torch.generation.generate import generate
from mllm_tpu_torch.generation.sampling import SamplingConfig
from mllm_tpu_torch.models.registry import auto_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
TINY = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, head_dim=64, max_position_embeddings=512,
            bos_token_id=1, eos_token_id=-2, rms_norm_eps=1e-6, rope_theta=1000000.0)
PROMPT = "Tell me about llamas."
NEW, LIMIT = 8, 256
RUN = ["--prompt", PROMPT, "--max-new", str(NEW), "-l", str(LIMIT), "--device", "cpu"]
MOE = dict(num_experts=4, num_experts_per_tok=2, moe_intermediate=128, shared=256)


def _write_dir(path, seed: int, moe: bool = False) -> str:
    """A qwen2 (or qwen2_moe) checkpoint directory of TINY's geometry: f32
    safetensors, untied random head (a tied one makes a random model repeat
    its input token), config.json and a synthetic byte-level tokenizer."""
    cfg = TextConfig(**TINY)
    rng = np.random.default_rng(seed)
    d, ff = cfg.hidden_size, cfg.intermediate_size
    q, kv = cfg.num_attention_heads * cfg.head_dim_, cfg.num_key_value_heads * cfg.head_dim_

    def lin(n, k):  # a Linear's weight [n, k] (k = 0: a bias [n] of the same scale)
        s = 1 / np.sqrt(k or d)
        return rng.uniform(-s, s, (n, k) if k else n).astype(np.float32)

    t = {"model.embed_tokens.weight": rng.standard_normal((cfg.vocab_size, d), np.float32),
         "model.norm.weight": np.ones(d, np.float32),
         "lm_head.weight": rng.standard_normal((cfg.vocab_size, d), np.float32) * 0.5}
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        for name, (n, k) in {"self_attn.q_proj": (q, d), "self_attn.k_proj": (kv, d),
                             "self_attn.v_proj": (kv, d), "self_attn.o_proj": (d, q)}.items():
            t[p + name + ".weight"] = lin(n, k)
            if name != "self_attn.o_proj":
                t[p + name + ".bias"] = lin(n, 0)
        if moe:
            mff = MOE["moe_intermediate"]
            t[p + "mlp.gate.weight"] = rng.standard_normal((MOE["num_experts"], d), np.float32)
            for e in range(MOE["num_experts"]):
                ep = f"{p}mlp.experts.{e}."
                t[ep + "gate_proj.weight"], t[ep + "up_proj.weight"] = lin(mff, d), lin(mff, d)
                t[ep + "down_proj.weight"] = lin(d, mff)
            sp = p + "mlp.shared_expert."
            t[sp + "gate_proj.weight"], t[sp + "up_proj.weight"] = lin(MOE["shared"], d), lin(MOE["shared"], d)
            t[sp + "down_proj.weight"] = lin(d, MOE["shared"])
            t[p + "mlp.shared_expert_gate.weight"] = lin(1, d)
        else:
            for name, (n, k) in {"mlp.gate_proj": (ff, d), "mlp.up_proj": (ff, d), "mlp.down_proj": (d, ff)}.items():
                t[p + name + ".weight"] = lin(n, k)
        for norm in ("input_layernorm", "post_attention_layernorm"):
            t[p + norm + ".weight"] = np.ones(d, np.float32)
    os.makedirs(path, exist_ok=True)
    write_safetensors(os.path.join(path, "model.safetensors"), t)
    hf = dict(chip_smoke.hf_config(cfg), tie_word_embeddings=False)
    if moe:
        hf.update(model_type="qwen2_moe", architectures=["Qwen2MoeForCausalLM"], num_experts=MOE["num_experts"],
                  num_experts_per_tok=MOE["num_experts_per_tok"], moe_intermediate_size=MOE["moe_intermediate"],
                  shared_expert_intermediate_size=MOE["shared"], norm_topk_prob=False)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f)
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(chip_smoke.synthetic_tokenizer(cfg.vocab_size, seed), f, ensure_ascii=False)
    return str(path)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny models: one intra-op thread, so that parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    return {"dense": _write_dir(root / "dense", 0), "moe": _write_dir(root / "moe", 1, moe=True)}


@pytest.fixture
def jax_canonical_int4(monkeypatch):
    """The JAX package on its canonical int4 layout (the port's), every
    projection int4, its numpy packers."""
    monkeypatch.setenv("MLLM_INT4_IMPL", "pallas")
    monkeypatch.setattr(jqmod, "INT4_MIN_PARAMS", 0)
    monkeypatch.setattr(jnative, "repack_int8", lambda w: None)
    monkeypatch.setattr(jnative, "repack_int4", lambda w, group=32: None)


@functools.lru_cache(maxsize=None)
def _jax_model(path: str, quant=None):
    """The JAX demo's load: (model, tokenizer, cfg, prompt ids [1, S])."""
    m, tok, cfg = jax_auto_model(path, dtype=jnp.bfloat16, quant=quant)
    ids = np.asarray(tok.encode(jax_render(cfg.model_type, PROMPT), bos=True), np.int32)[None, :]
    return m, tok, cfg, ids


def _jax_generate(path: str, quant=None, kv: str = "bf16") -> list:
    m, tok, _, ids = _jax_model(path, quant)
    res, _ = jgen.generate(m, ids, m.init_cache(1, LIMIT, jnp.bfloat16, kv_dtype=kv),
                           JaxSamplingConfig(max_new_tokens=NEW, do_sample=False, temperature=1.0),
                           eos_token_id=tok.eos_token_id)
    return res.tokens


def _cli(path: str, *flags) -> dict:
    return demo_llm.main(["-m", path, *RUN, *flags])


# ---------------------------------------------------------------------------
# demo_llm: deterministic branches against the JAX package
# ---------------------------------------------------------------------------


def test_plain_greedy_equals_jax(dirs):
    got = _cli(dirs["dense"])
    assert got["prompt_len"] == _jax_model(dirs["dense"])[3].shape[1]
    assert got["ids"] == _jax_generate(dirs["dense"])
    assert len(set(got["ids"])) > 1  # the checkpoint does not just repeat a token


def test_quant_int8_greedy_equals_jax(dirs):
    assert _cli(dirs["dense"], "-q", "int8")["ids"] == _jax_generate(dirs["dense"], "int8")


def test_quant_int4_greedy_equals_jax(dirs, jax_canonical_int4):
    assert _cli(dirs["dense"], "-q", "int4")["ids"] == _jax_generate(dirs["dense"], "int4")


def test_kv_int8_greedy_equals_jax(dirs):
    assert _cli(dirs["dense"], "--kv", "int8")["ids"] == _jax_generate(dirs["dense"], kv="int8")


def test_chunked_turns_equal_jax_and_hit_the_prompt_cache(dirs):
    """The JAX demo's chunked branch: a fresh bf16 cache a turn (`--kv` not
    read), prefill through the prompt cache in chunks of 8, greedy decode."""
    got = _cli(dirs["dense"], "--chunked", "8", "--turns", "2", "--kv", "int8")
    m, tok, _, ids = _jax_model(dirs["dense"])
    scfg = JaxSamplingConfig(max_new_tokens=NEW, do_sample=False, temperature=1.0)
    pcache, want = JaxPromptCache(), []
    for turn in range(2):
        cache = m.init_cache(1, LIMIT, jnp.bfloat16)
        logits, cache, matched = jax_prefill_with_prompt_cache(m, cache, ids, ids.shape[1], pcache, chunk=8)
        tokv = jax_sample_token(jax.random.PRNGKey(turn), logits, scfg)
        out = [int(tokv[0])]
        for _ in range(NEW - 1):
            logits, cache = jgen._decode_step(m, cache, tokv)
            tokv = jax_sample_token(jax.random.PRNGKey(turn * 1000 + len(out)), logits, scfg)
            out.append(int(tokv[0]))
        want.append((out, matched))
    assert [(t["ids"], t["matched"]) for t in got["turns"]] == want
    assert got["turns"][0]["matched"] == 0 and got["turns"][1]["matched"] == got["prompt_len"]


def test_batch_equals_jax_ragged(dirs):
    got = _cli(dirs["dense"], "--batch", "3")
    m, _, _, ids = _jax_model(dirs["dense"])
    prompts = [ids[0]] + [ids[0][: max(1, ids.shape[1] - i % 5)] for i in (1, 2)]
    toks, n_valid, _ = jgen.ragged_batched_generate(
        m, prompts, m.init_cache(3, LIMIT, jnp.bfloat16),
        JaxSamplingConfig(max_new_tokens=NEW, do_sample=False, temperature=1.0))
    assert got["prompt_lens"] == [len(p) for p in prompts]
    assert got["ids"] == [np.asarray(toks)[i, : n_valid[i]].tolist() for i in range(3)]


def test_mbp_equals_jax(dirs):
    got = _cli(dirs["moe"], "--mbp", "2")
    m, tok, _, ids = _jax_model(dirs["moe"])
    mm, store = jmoe.to_mbp(m, max_device_entries=2)
    logits, cache = jmoe.mbp_forward(mm, jnp.asarray(ids), m.init_cache(1, LIMIT, jnp.bfloat16))
    want = [int(np.argmax(np.asarray(logits[0, -1])))]
    for _ in range(NEW - 1):
        logits, cache = jmoe.mbp_forward(mm, jnp.asarray([[want[-1]]], jnp.int32), cache)
        want.append(int(np.argmax(np.asarray(logits[0, -1]))))
    assert got["ids"] == want
    assert got["hit_rate"] == store.hit_rate


# ---------------------------------------------------------------------------
# demo_llm: random branches against the port's functions, same generators
# ---------------------------------------------------------------------------


def _port(path: str):
    model, tok, cfg = auto_model(path, dtype=demo_llm.DTYPE, device=CPU)
    ids = np.asarray(tok.encode(jax_render(cfg.model_type, PROMPT), bos=True), np.int64)[None, :]
    return model, ids


def _port_generate(model, ids, scfg=SamplingConfig(max_new_tokens=NEW, do_sample=False, temperature=1.0)):
    res, _ = generate(model, ids, model.init_cache(1, LIMIT, demo_llm.DTYPE), scfg)
    return res.tokens


def test_sparse_equals_port_functions(dirs):
    from mllm_tpu_torch.models.elastic import make_predictors, sparse_model

    model, ids = _port(dirs["dense"])
    preds = make_predictors(model, generator=torch.Generator(device=CPU).manual_seed(0))
    assert _cli(dirs["dense"], "--sparse", "0.0")["ids"] == _port_generate(sparse_model(model, preds, 0.0), ids)


def test_elastic_equals_port_functions(dirs, capsys):
    from mllm_tpu_torch.models.elastic import elastic_model

    model, ids = _port(dirs["dense"])
    assert _cli(dirs["dense"], "--elastic", "0.5")["ids"] == _port_generate(elastic_model(model, 0.5, 0.5), ids)
    assert "[elastic] ratio 0.5: heads 4->2, ffn 512->256" in capsys.readouterr().out


def test_sampled_equals_port_functions(dirs):
    model, ids = _port(dirs["dense"])
    scfg = SamplingConfig(max_new_tokens=NEW, do_sample=True, temperature=0.7, top_k=40)
    got = _cli(dirs["dense"], "--temperature", "0.7", "--top-k", "40")["ids"]
    assert got == _port_generate(model, ids, scfg)  # generate's generator: seeded 0 on the device
    assert got != _port_generate(model, ids)


def test_sampled_chunked_equals_port_functions(dirs):
    """The chunked branch draws turn t's first token from a generator seeded
    t, the n-th after it from one seeded t * 1000 + n (the JAX demo's keys)."""
    from mllm_tpu_torch.generation.generate import decode_step
    from mllm_tpu_torch.generation.prefill import PromptCache, prefill_with_prompt_cache
    from mllm_tpu_torch.generation.sampling import sample_token

    model, ids = _port(dirs["dense"])
    scfg = SamplingConfig(max_new_tokens=NEW, do_sample=True, temperature=0.7, top_p=0.9)
    got = _cli(dirs["dense"], "--chunked", "16", "--turns", "2", "--temperature", "0.7", "--top-p", "0.9")
    pcache = PromptCache()
    for turn in range(2):
        cache = model.init_cache(1, LIMIT, demo_llm.DTYPE)
        logits, cache, _ = prefill_with_prompt_cache(model, cache, ids, ids.shape[1], pcache, chunk=16)
        tokv = sample_token(logits, scfg, torch.Generator(device=CPU).manual_seed(turn))
        want = [int(tokv[0])]
        for _ in range(NEW - 1):
            logits, cache = decode_step(model, cache, tokv)
            tokv = sample_token(logits, scfg, torch.Generator(device=CPU).manual_seed(turn * 1000 + len(want)))
            want.append(int(tokv[0]))
        assert got["turns"][turn]["ids"] == want


# ---------------------------------------------------------------------------
# aliases
# ---------------------------------------------------------------------------


def _jax_wrappers(target: str) -> dict:
    """name -> default flags of each examples/demo_*.py that imports `target`."""
    out = {}
    for fn in sorted(os.listdir(os.path.join(REPO, "examples"))):
        if not (fn.startswith("demo_") and fn.endswith(".py")):
            continue
        with open(os.path.join(REPO, "examples", fn)) as f:
            src = f.read()
        if re.search(rf"^import {target}$", src, re.M):
            m = re.search(r"sys\.argv\[1:1\] = \[(.*?)\]", src)
            out[fn[:-3]] = tuple(re.findall(r"'([^']*)'", m.group(1))) if m else ()
    return out


def _port_modules() -> list:
    return [m.name for m in pkgutil.iter_modules(examples.__path__) if m.name.startswith("demo_")]


def test_alias_set_and_defaults_equal_the_jax_wrappers():
    import importlib

    want = _jax_wrappers("demo_llm")
    assert len(want) == 27
    got = {}
    for name in _port_modules():
        mod = importlib.import_module(f"mllm_tpu_torch.examples.{name}")
        if hasattr(mod, "DEFAULTS"):
            got[name] = mod.DEFAULTS
    assert got == want
    assert set(_jax_wrappers("demo_sd")) == {"demo_qwen_sd"}
    from mllm_tpu_torch.examples import demo_qwen_sd

    assert demo_qwen_sd.main is demo_sd.main
    # every demo of the JAX package has its counterpart, and the port no other
    jax_demos = {fn[:-3] for fn in os.listdir(os.path.join(REPO, "examples"))
                 if fn.startswith("demo_") and fn.endswith(".py")}
    assert set(want) | {"demo_llm", "demo_sd", "demo_qwen_sd"} <= jax_demos
    assert set(_port_modules()) == jax_demos


def test_alias_runs_end_to_end_with_its_default(dirs):
    from mllm_tpu_torch.examples import demo_qwen_batch

    got = demo_qwen_batch.main(["-m", dirs["dense"], *RUN])
    assert got["ids"] == _cli(dirs["dense"], "--batch", "3")["ids"]
    assert len(demo_qwen_batch.main(["-m", dirs["dense"], *RUN, "--batch", "2"])["ids"]) == 2


def test_openelm_alias_fails_where_jax_fails(tmp_path):
    """Neither registry builds OpenELM (ROADMAP G8): both raise NotImplementedError."""
    from mllm_tpu_torch.examples import demo_openelm

    cfg = dict(chip_smoke.openelm_1_1b(), model_type="openelm", num_transformer_layers=2)
    with open(tmp_path / "config.json", "w") as f:
        json.dump(cfg, f)
    with pytest.raises(NotImplementedError) as jax_err:
        jax_auto_model(str(tmp_path), dtype=jnp.bfloat16)
    with pytest.raises(NotImplementedError) as port_err:
        demo_openelm.main(["-m", str(tmp_path), "--device", "cpu"])
    assert "openelm" in str(jax_err.value) and "openelm" in str(port_err.value)


# ---------------------------------------------------------------------------
# demo_sd
# ---------------------------------------------------------------------------


def test_demo_sd_host_and_compiled_equal_jax(dirs):
    path = dirs["dense"]
    host = demo_sd.main(["-m", path, "--max-new", "12", "-l", str(LIMIT), "--device", "cpu"])
    compiled = demo_sd.main(["-m", path, "--max-new", "12", "-l", str(LIMIT), "--device", "cpu", "--compiled"])
    m, tok, _, _ = _jax_model(path)
    ids = np.asarray(tok.encode("Repeat after me: the cat sat on the mat. the cat sat on", bos=True), np.int32)[None]
    want, _, stats = jax_speculative_generate(m, ids, m.init_cache(1, LIMIT, jnp.bfloat16), 12,
                                              eos_token_id=tok.eos_token_id, max_draft=8)
    assert host["ids"] == want and compiled["ids"] == want
    assert (host["steps"], host["drafted"], host["accepted"]) == (stats.steps, stats.drafted, stats.accepted)


# ---------------------------------------------------------------------------
# _demo_common
# ---------------------------------------------------------------------------


def test_std_parser_flags():
    ap = _demo_common.std_parser("x", image=True, default_prompt="p")
    args = ap.parse_args(["-m", "d", "-i", "img.png"])
    assert (args.limits, args.quant, args.device, args.prompt, args.max_new) == (2048, None, "cuda", "p", 128)
    with pytest.raises(SystemExit):
        ap.parse_args(["-m", "d", "-i", "x", "-q", "int4-mixed"])  # a TPU heuristic the port leaves out


def test_vl_decode_loop_equals_jax(dirs, monkeypatch):
    """Greedy decode after a prefill on a CausalLM-shaped (ids, cache) ->
    (logits, cache) model: the tokens the JAX loop streams."""
    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        import _demo_common as jax_common
    finally:
        sys.path.remove(os.path.join(REPO, "examples"))
    m, tok, _, ids = _jax_model(dirs["dense"])
    streamed = []
    monkeypatch.setattr(jax_common, "stream_fn", lambda tok: lambda t: streamed.append(int(t)) or True)
    logits, cache = m(jnp.asarray(ids), m.init_cache(1, LIMIT, jnp.bfloat16))
    jax_common.vl_decode_loop(m, tok, logits, cache, 4)  # eager JAX model calls: a few steps
    model, pids = _port(dirs["dense"])
    with torch.no_grad():
        logits, cache = model(torch.as_tensor(pids), model.init_cache(1, LIMIT, demo_llm.DTYPE))
    got, _ = _demo_common.vl_decode_loop(model, tok, logits, cache, 4)
    assert got == streamed and len(got) == 4


# ---------------------------------------------------------------------------
# no default to the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cli", ["demo_llm", "demo_qwen", "demo_qwen_batch", "demo_sd", "demo_qwen_sd"])
def test_no_card_raises_without_device_cpu(dirs, cli, monkeypatch):
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)  # no card, on any host
    mod = importlib.import_module(f"mllm_tpu_torch.examples.{cli}")
    with pytest.raises(RuntimeError, match="found none"):
        mod.main(["-m", dirs["dense"]])
