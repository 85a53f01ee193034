"""The way in from a checkpoint file: the ggml block formats, the ggml
repackers, the `.mllm` container and GGUF, each held against the JAX package.

- `core/dtypes.py` (a copy): every encoder's bytes and every decoder's f32
  values bit-equal to `mllm_tpu.core.dtypes` (the JAX package's optional
  native decoders are switched off, as the port has none).
- `repack_q4_0` / `repack_q4_k` / `repack_q8_0` and their `prepare_int4`
  operands bit-equal to `mllm_tpu.ops.quant_matmul`'s.
- The `.mllm` reader and writer byte-compatible with the JAX package's
  (the reference-quantizer golden files of tests/test_q4_0_4x4.py included).
- A tiny qwen2 checkpoint of random ggml blocks (Q4_0 q/k/v/o, Q4_K gate/up,
  Q8_0 down, one Q6_K o_proj; f16 tied embedding), written by chip_smoke.py's
  writers as a `.mllm` model directory and as a GGUF file, loaded by both
  packages in f32 on the CPU: logits within 1e-5 of the largest |logit| and
  equal greedy tokens (on the CPU both packages' int4 / int8 products are
  the plain dequant and an f32 matmul, so only summation order differs; the
  Pallas bf16 group-sum gap of ROADMAP Queue 3 does not arise), the port's
  two loads bit-equal to each other, its repacked projections within 1e-5
  of x @ decode(blocks).T (Q8_0: within its requantization's bound).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mllm_tpu.core import dtypes as jdt
from mllm_tpu.core import gguf as jgguf
from mllm_tpu.core import param_loader as jpl
from mllm_tpu.generation.generate import generate as jax_generate
from mllm_tpu.generation.sampling import SamplingConfig as JaxSamplingConfig
from mllm_tpu.models.registry import auto_model as jax_auto_model
from mllm_tpu.ops import quant_matmul as jqm
from mllm_tpu.utils import native as jnative
from mllm_tpu_torch.core import dtypes as dt
from mllm_tpu_torch.core import gguf
from mllm_tpu_torch.core import param_loader as pl
from mllm_tpu_torch.core.config import TextConfig
from mllm_tpu_torch.generation.generate import generate
from mllm_tpu_torch.generation.sampling import SamplingConfig
from mllm_tpu_torch.models.registry import auto_model, open_loader
from mllm_tpu_torch.nn.layers import Int4Linear, Linear, QuantLinear, QuantLinearA8
from mllm_tpu_torch.ops import quant_matmul as qm

CPU = torch.device("cpu")
GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
TINY = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, head_dim=64, max_position_embeddings=256,
            bos_token_id=1, eos_token_id=-2, rms_norm_eps=1e-6, rope_theta=1000000.0)
Q6K_NAME = "model.layers.1.self_attn.o_proj.weight"


@pytest.fixture
def jax_numpy_paths(monkeypatch):
    """The JAX package on its canonical int4 layout, its numpy decoders and packers."""
    monkeypatch.setenv("MLLM_INT4_IMPL", "pallas")
    monkeypatch.setattr(jnative, "dequant", lambda *a, **k: None)
    monkeypatch.setattr(jnative, "repack_int8", lambda w: None)
    monkeypatch.setattr(jnative, "repack_int4", lambda w, group=32: None)


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a.view(np.uint8), b.view(np.uint8))


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


# ---------------------------------------------------------------------------
# block formats and repackers
# ---------------------------------------------------------------------------

ENCODERS = ["quant_q4_0", "quant_q8_0", "quant_q2_0", "quant_q4_k", "quant_q6_k", "quant_q8_k",
            "quant_q2_k", "quant_q3_k"]


@pytest.mark.parametrize("name", ENCODERS)
def test_encoders_and_decoders_bit_equal(jax_numpy_paths, name):
    x = np.random.default_rng(4).standard_normal(512).astype(np.float32)
    raw = getattr(dt, name)(x)
    assert _bits(raw, getattr(jdt, name)(x))
    kind = dt.DataType[name[len("quant_"):].upper()]
    assert _bits(dt.decode(raw, kind, x.size), jdt.decode(raw, jdt.DataType(int(kind)), x.size))


@pytest.mark.parametrize("pack", ["quant_q4_0_4x4", "quant_q4_0_4x8", "quant_q4_0_8x8"])
def test_interleaved_q4_0_bit_equal(jax_numpy_paths, pack):
    x = np.random.default_rng(5).standard_normal((8, 96)).astype(np.float32)
    raw = getattr(dt, pack)(x, 96)
    assert _bits(raw, getattr(jdt, pack)(x, 96))
    kind = {"4x4": dt.DataType.Q4_0_4_4, "4x8": dt.DataType.Q4_0_4_8, "8x8": dt.DataType.Q4_0_8_8}[pack[-3:]]
    assert _bits(dt.decode(raw, kind, x.size, n_per_row=96),
                 jdt.decode(raw, jdt.DataType(int(kind)), x.size, n_per_row=96))


def test_data_types_and_block_specs_match():
    assert {m.name: int(m) for m in dt.DataType} == {m.name: int(m) for m in jdt.DataType}
    for kind in dt.DataType:
        jk = jdt.DataType(int(kind))
        assert dt.is_quantized(kind) == jdt.is_quantized(jk)
        try:
            spec = dt.block_spec(kind)
        except NotImplementedError:
            continue
        assert dataclasses.astuple(spec) == dataclasses.astuple(jdt.block_spec(jk))


@pytest.mark.parametrize("kind", ["Q4_0", "Q4_K", "Q8_0"])
@pytest.mark.parametrize("source", ["random_bytes", "quantized_floats"])
def test_repackers_bit_equal(jax_numpy_paths, kind, source):
    n, k = 96, 512
    rng = np.random.default_rng(6)
    if source == "random_bytes":
        raw = chip_smoke.random_blocks(kind, n, k, 0.05, rng)
    else:
        raw = getattr(dt, f"quant_{kind.lower()}")(rng.standard_normal((n, k)).astype(np.float32).reshape(-1))
    port = getattr(qm, f"repack_{kind.lower()}")(raw, n, k)
    ref = getattr(jqm, f"repack_{kind.lower()}")(raw, n, k)
    assert len(port) == len(ref) and all(_bits(a, b) for a, b in zip(port, ref))
    if kind != "Q8_0":
        zeros = port[2] if kind == "Q4_K" else None
        got = qm.prepare_int4(port[0], port[1], qm.GROUP, zeros)
        want = jqm.prepare_int4(ref[0], ref[1], 32, ref[2] if kind == "Q4_K" else None)
        assert all(_bits(a, b) for a, b in zip(got, want))


def test_pack_int4_planar_bit_equal():
    q = np.random.default_rng(7).integers(0, 16, (24, 64)).astype(np.uint8)
    assert _bits(qm.pack_int4_planar(q), jqm.pack_int4_planar(q))


# ---------------------------------------------------------------------------
# the .mllm container
# ---------------------------------------------------------------------------


def test_mllm_writer_bytes_equal_and_read_back(tmp_path):
    rng = np.random.default_rng(8)
    f32 = rng.standard_normal((8, 64)).astype(np.float32)
    q40 = dt.quant_q4_0(f32.reshape(-1))
    for mod, name in ((pl, "port.mllm"), (jpl, "jax.mllm")):
        w = mod.MllmWriter(tmp_path / name)
        w.add("a.weight", f32)
        w.add("b.weight", f32.astype(np.float16))
        w.add("c.weight", q40, mod.DataType.Q4_0)
        w.write()
    assert (tmp_path / "port.mllm").read_bytes() == (tmp_path / "jax.mllm").read_bytes()
    ld, jld = pl.ParamLoader(tmp_path / "port.mllm"), jpl.ParamLoader(tmp_path / "port.mllm")
    assert list(ld) == list(jld)
    for name in ld:
        assert int(ld.dtype(name)) == int(jld.dtype(name))
        assert _bits(ld.raw(name), jld.raw(name))
        assert _bits(ld.load(name, (8, 64)), jld.load(name, (8, 64)))


def test_multi_file_loader_and_vocab(tmp_path):
    rng = np.random.default_rng(9)
    paths = []
    for i in range(2):
        w = pl.MllmWriter(tmp_path / f"part{i}.mllm")
        w.add(f"t{i}", rng.standard_normal(16).astype(np.float32))
        w.write()
        paths.append(tmp_path / f"part{i}.mllm")
    ld, jld = pl.MultiFileParamLoader(paths), jpl.MultiFileParamLoader(paths)
    assert sorted(ld) == sorted(jld) == ["t0", "t1"]
    assert all(_bits(ld.load(n, (16,)), jld.load(n, (16,))) for n in ld)
    assert isinstance(open_loader(str(tmp_path)), pl.MultiFileParamLoader)
    assert isinstance(open_loader(str(paths[0])), pl.ParamLoader)
    tokens = ["<unk>", "hello", " world", "你好"]
    pl.write_vocab(tmp_path / "port.vocab", tokens, [0.0, -1.0, -2.0, -3.5])
    jpl.write_vocab(tmp_path / "jax.vocab", tokens, [0.0, -1.0, -2.0, -3.5])
    assert (tmp_path / "port.vocab").read_bytes() == (tmp_path / "jax.vocab").read_bytes()
    assert pl.load_vocab(tmp_path / "port.vocab") == jpl.load_vocab(tmp_path / "port.vocab")
    (tmp_path / "merges.txt").write_text("#version: 0.2\nh e\nhe llo\n", encoding="utf-8")
    assert pl.load_merges(tmp_path / "merges.txt") == jpl.load_merges(tmp_path / "merges.txt")


@pytest.mark.parametrize("name,shape", [("model.layers.0.mlp.gate_proj.weight", (160, 64)),
                                        ("model.layers.0.self_attn.o_proj.weight", (64, 64)),
                                        ("model.norm.weight", (64,))])
@pytest.mark.parametrize("golden", ["tiny_q4044.mllm", "tiny_q4k_ref.mllm", "tiny_q6k_ref.mllm"])
def test_reference_goldens_load_equal(jax_numpy_paths, golden, name, shape):
    """`.mllm` files written by the reference C++ quantizer read the same."""
    path = os.path.join(GOLDENS, golden)
    ld, jld = pl.ParamLoader(path), jpl.ParamLoader(path)
    assert int(ld.dtype(name)) == int(jld.dtype(name))
    assert _bits(ld.load(name, shape), jld.load(name, shape))


# ---------------------------------------------------------------------------
# models from .mllm and GGUF
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def containers(tmp_path_factory):
    """A tiny qwen2 checkpoint of random ggml blocks as a .mllm model
    directory and as a GGUF file (chip_smoke.py's writers)."""
    cfg = TextConfig(**TINY)
    tensors = chip_smoke.container_tensors(cfg, seed=2, overrides={Q6K_NAME: "Q6_K"})
    tok = chip_smoke.synthetic_tokenizer(cfg.vocab_size, seed=2)
    root = tmp_path_factory.mktemp("containers")
    chip_smoke.write_mllm_model(str(root / "mllm"), cfg, tensors, tok)
    chip_smoke.write_gguf_model(str(root / "tiny.gguf"), cfg, tensors, tok)
    return cfg, tensors, str(root / "mllm"), str(root / "tiny.gguf")


IDS = np.array([[1, 17, 42, 99, 7, 23, 300, 5]], np.int64)


def _logits_and_tokens(tm, jm):
    jl, _ = jax.jit(lambda m, x, c: m(x, c, last_only=False))(
        jm, jnp.asarray(IDS, jnp.int32), jm.init_cache(1, 32, jnp.float32))
    tl, _ = tm(torch.from_numpy(IDS), tm.init_cache(1, 32, torch.float32), last_only=False)
    jres, _ = jax_generate(jm, IDS, jm.init_cache(1, 32, jnp.float32), JaxSamplingConfig(max_new_tokens=8), bucket=8)
    tres, _ = generate(tm, IDS, tm.init_cache(1, 32, torch.float32), SamplingConfig(max_new_tokens=8), bucket=8)
    return tl.numpy(), np.asarray(jl), tres.tokens, jres.tokens


def _check_layers(tm):
    attn0, attn1, mlp0 = tm.blocks[0].attn, tm.blocks[1].attn, tm.blocks[0].mlp
    assert isinstance(attn0.q_proj, Int4Linear) and attn0.q_proj.zeros_t is None  # Q4_0: symmetric
    assert isinstance(mlp0.gate_proj, Int4Linear) and mlp0.gate_proj.zeros_t is not None  # Q4_K: affine
    assert type(mlp0.down_proj) is QuantLinear  # Q8_0
    assert type(attn1.o_proj) is Linear  # Q6_K: decoded to float


def test_mllm_model_matches_jax(jax_numpy_paths, containers):
    cfg, _, mdir, _ = containers
    tm, tok, tcfg = auto_model(mdir, dtype=torch.float32, device=CPU)
    jm, jtok, jcfg = jax_auto_model(mdir, dtype=jnp.float32)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    _check_layers(tm)
    tl, jl, tt, jt = _logits_and_tokens(tm, jm)
    assert _rel(tl, jl) < 1e-5
    assert tt == jt
    text = "The quick brown fox, 你好"
    assert tok.encode(text, bos=True) == jtok.encode(text, bos=True)


def test_gguf_model_matches_jax(jax_numpy_paths, containers):
    cfg, _, mdir, gpath = containers
    tm, tok, tcfg = gguf.load_gguf_model(gpath, dtype=torch.float32, device=CPU)
    jm, jtok, jcfg = jgguf.load_gguf_model(gpath, dtype=jnp.float32)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (tok.bos_token_id, tok.eos_token_id) == (jtok.bos_token_id, jtok.eos_token_id) == (1, -2)
    _check_layers(tm)
    tl, jl, tt, jt = _logits_and_tokens(tm, jm)
    assert _rel(tl, jl) < 1e-5
    assert tt == jt
    assert tok.encode("hello world") == jtok.encode("hello world")
    # the same blocks through the .mllm directory: the same logits, bit for bit
    mm, _, _ = auto_model(mdir, dtype=torch.float32, device=CPU)
    ml, _ = mm(torch.from_numpy(IDS), mm.init_cache(1, 32, torch.float32), last_only=False)
    assert torch.equal(ml, torch.from_numpy(tl))


def test_gguf_metadata_and_names(containers):
    cfg, tensors, _, gpath = containers
    f, jf = gguf.GGUFFile(gpath), jgguf.GGUFFile(gpath)
    assert f.metadata == jf.metadata
    assert {n: dataclasses.astuple(t) for n, t in f.tensors.items()} == \
        {n: dataclasses.astuple(t) for n, t in jf.tensors.items()}
    ld = gguf.GGUFLoader(gpath)
    for name, (kind, shape, raw) in tensors.items():
        assert name in ld and ld.dtype(name) == dt.DataType[kind]
        assert _bits(ld.raw(name), np.ascontiguousarray(raw).view(np.uint8).reshape(-1))


@pytest.mark.parametrize("m", [1, 8])
def test_repacked_projections_match_their_blocks(containers, m):
    cfg, tensors, mdir, _ = containers
    tm, _, _ = auto_model(mdir, dtype=torch.float32, with_tokenizer=False, device=CPU)
    x = torch.from_numpy(np.random.default_rng(m).standard_normal((m, cfg.hidden_size)).astype(np.float32))
    for name, lin in (("self_attn.q_proj", tm.blocks[0].attn.q_proj), ("mlp.gate_proj", tm.blocks[0].mlp.gate_proj),
                      ("mlp.down_proj", tm.blocks[0].mlp.down_proj)):
        kind, (n, k), raw = tensors[f"model.layers.0.{name}.weight"]
        w = torch.from_numpy(dt.decode(raw, dt.DataType[kind], n * k).reshape(n, k))
        xk = x if k == cfg.hidden_size else torch.from_numpy(
            np.random.default_rng(m).standard_normal((m, k)).astype(np.float32))
        plain = xk @ w.T
        if kind == "Q8_0":  # requantized to a scale a row: each weight moves by at most half a step
            y = qm.int8_matmul(xk, lin.qweight_t, lin.scales)
            bound = 0.5 * lin.scales[None, :] * xk.abs().sum(-1, keepdim=True)
            assert ((y - plain).abs() <= bound * 1.001 + 1e-5 * plain.abs().max()).all()
        else:
            y = qm.int4_matmul(xk, lin.packed_t, lin.scales_t, lin.group, lin.zeros_t)
            assert _rel(y, plain) < 1e-5


@pytest.mark.parametrize("quant", ["int8", "int8-a8", "int4"])
def test_quantized_load_of_a_container_matches_jax(jax_numpy_paths, containers, quant):
    """quant= leaves the ggml blocks as they are and quantizes the float
    weights (here the Q6_K o_proj, decoded) as the JAX package does."""
    _, _, mdir, _ = containers
    tm, _, _ = auto_model(mdir, dtype=torch.float32, quant=quant, with_tokenizer=False, device=CPU)
    jm, _, _ = jax_auto_model(mdir, dtype=jnp.float32, quant=quant, with_tokenizer=False)
    want = {"int8": QuantLinear, "int8-a8": QuantLinearA8, "int4": Int4Linear}[quant]
    assert type(tm.blocks[1].attn.o_proj) is want and type(tm.blocks[0].mlp.down_proj) is QuantLinear
    tl, jl, tt, jt = _logits_and_tokens(tm, jm)
    assert _rel(tl, jl) < 1e-5
    assert tt == jt


def test_q8_0f_loads_where_the_reference_raises(tmp_path):
    """Q8_0F (f32 block scales, 36-byte blocks) loads as a QuantLinear
    requantized to one scale a row; the JAX package's `repack_q8_0` reshapes
    every block as 34 bytes and raises on it (ROADMAP Queue 3)."""
    from mllm_tpu_torch.models.loading import make_linear

    n, k = 16, 64
    w = np.random.default_rng(10).standard_normal((n, k)).astype(np.float32)
    d = np.abs(w.reshape(-1, 32)).max(-1) / 127.0
    q = np.round(w.reshape(-1, 32) / d[:, None]).astype(np.int8)
    raw = np.concatenate([d.astype(np.float32).view(np.uint8).reshape(-1, 4), q.view(np.uint8)], 1).reshape(-1)
    writer = pl.MllmWriter(tmp_path / "q8f.mllm")
    writer.add("w.weight", raw, pl.DataType.Q8_0F)
    writer.write()
    lin = make_linear(pl.ParamLoader(tmp_path / "q8f.mllm"), "w.weight", n, k, None, None, device=CPU,
                      dtype=torch.float32)
    assert type(lin) is QuantLinear
    want_q, want_s = dt.quant_q8_per_row_int8(dt.decode(raw, dt.DataType.Q8_0F, n * k).reshape(n, k))
    assert _bits(lin.qweight_t.numpy(), np.ascontiguousarray(want_q.T)) and _bits(lin.scales.numpy(), want_s)
    with pytest.raises(ValueError):
        jqm.repack_q8_0(raw, n, k)
