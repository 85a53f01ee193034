"""The port's model-file and check tools (`mllm_tpu_torch.tools`) against
the JAX repo's `tools/` scripts, in process on the CPU.

- convertor: the `.mllm` bytes equal to the JAX tool's on a safetensors
  directory (two files, f32 and f16), on a torch `.bin` (bf16 and f32), and
  for `--vocab` (byte-level and SentencePiece-kind tokenizer.json files).
- quantizer: byte-equal to the JAX tool for each of the nine dtypes on
  `tests/goldens/tiny_f32.mllm` (whose tensors all sit under the tool's size
  floor) and on a wider f32 file whose projections pass it; Q4_0_4_4's row
  rule and packer give the bytes of the reference C++ quantizer's golden
  `tiny_q4044.mllm` (tests/test_q4_0_4x4.py holds the JAX tool to it).
- rotate: `rotate_vo` gives the JAX one's weights through the bridge
  (<= 1e-6; Hadamard and random-orthogonal rotations, with a v bias), and
  the rotated model's f32 logits match the unrotated model's (<= 1e-4 x
  max |logit|); `--check` on the CPU.
- ci: `--device cpu` runs every stage ok; a stage forced to fail prints a
  report naming it and exits 1; the dry-run stage's command and its failure.
- No tool that launches work defaults to the CPU.
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from mllm_tpu.core.config import TextConfig as JaxTextConfig
from mllm_tpu.models.transformer import CausalLM as JaxCausalLM
from mllm_tpu.utils import native as jnative
from mllm_tpu_torch.core.config import TextConfig
from mllm_tpu_torch.core.param_loader import ParamLoader, write_safetensors
from mllm_tpu_torch.core.dtypes import DataType
from mllm_tpu_torch.models.bridge import causal_lm_from_jax_params
from mllm_tpu_torch.tools import ci, convertor, quantizer, rotate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(REPO, "tests", "goldens")
F32 = os.path.join(GOLDENS, "tiny_f32.mllm")
CPU = torch.device("cpu")


def _jax_tool(name: str):
    """tools/<name>.py of the JAX repo, imported as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny tensors: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_numpy_paths(monkeypatch):
    """The JAX package's numpy encoders and decoders (the port has no native ones)."""
    monkeypatch.setattr(jnative, "dequant", lambda *a, **k: None)


# ---------------------------------------------------------------------------
# convertor
# ---------------------------------------------------------------------------


def test_convertor_safetensors_dir_equals_jax(tmp_path):
    rng = np.random.default_rng(0)
    src = tmp_path / "hf"
    src.mkdir()
    write_safetensors(src / "model-00001-of-00002.safetensors",
                      {"model.embed_tokens.weight": rng.standard_normal((64, 32), np.float32),
                       "model.norm.weight": np.ones(32, np.float32)})
    write_safetensors(src / "model-00002-of-00002.safetensors",
                      {"model.layers.0.mlp.down_proj.weight": rng.standard_normal((32, 48)).astype(np.float16),
                       "lm_head.weight": rng.standard_normal((64, 32), np.float32)})
    assert convertor.main(["--input", str(src), "--output", str(tmp_path / "port.mllm")]) == 4
    _jax_tool("convertor").convert_weights(str(src), str(tmp_path / "jax.mllm"))
    assert _bytes(tmp_path / "port.mllm") == _bytes(tmp_path / "jax.mllm")
    got = ParamLoader(str(tmp_path / "port.mllm"))
    assert {got.dtype(n) for n in got} == {DataType.F32}


def test_convertor_torch_bin_equals_jax(tmp_path):
    g = torch.Generator().manual_seed(0)
    torch.save({"model.embed_tokens.weight": torch.randn(64, 32, generator=g, dtype=torch.bfloat16),
                "model.layers.0.self_attn.q_proj.weight": torch.randn(32, 32, generator=g),
                "model.layers.0.self_attn.q_proj.bias": torch.randn(32, generator=g, dtype=torch.float16)},
               tmp_path / "pytorch_model.bin")
    src = str(tmp_path / "pytorch_model.bin")
    convertor.main(["--input", src, "--output", str(tmp_path / "port.mllm")])
    _jax_tool("convertor").convert_weights(src, str(tmp_path / "jax.mllm"))
    assert _bytes(tmp_path / "port.mllm") == _bytes(tmp_path / "jax.mllm")


@pytest.mark.parametrize("byte_level", [True, False])
def test_convertor_vocab_equals_jax(tmp_path, byte_level):
    with open(tmp_path / "tokenizer.json", "w", encoding="utf-8") as f:
        json.dump(chip_smoke.synthetic_tokenizer(600, 3, byte_level=byte_level), f, ensure_ascii=False)
    n = convertor.main(["--input", str(tmp_path), "--output", str(tmp_path / "port.mllm"), "--vocab"])
    _jax_tool("convertor").convert_vocab(str(tmp_path), str(tmp_path / "jax.mllm"))
    assert n == 600
    assert _bytes(tmp_path / "port.mllm") == _bytes(tmp_path / "jax.mllm")


# ---------------------------------------------------------------------------
# quantizer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def wide_f32(tmp_path_factory):
    """An f32 `.mllm` whose projections pass the tool's size floor (>= 16384
    weights): hidden 256, a down_proj of K = 512, a norm for the hidden-width
    pre-scan, an embedding the skip rules keep."""
    from mllm_tpu_torch.core.param_loader import MllmWriter

    rng = np.random.default_rng(11)
    path = str(tmp_path_factory.mktemp("quantizer") / "wide_f32.mllm")
    w = MllmWriter(path)
    for name, shape in (("model.norm.weight", (256,)), ("model.embed_tokens.weight", (64, 256)),
                        ("model.layers.0.self_attn.q_proj.weight", (256, 256)),
                        ("model.layers.0.self_attn.q_proj.bias", (256,)),
                        ("model.layers.0.mlp.gate_proj.weight", (512, 256)),
                        ("model.layers.0.mlp.down_proj.weight", (256, 512)),
                        ("model.layers.0.self_attn.k_proj.weight", (65, 256))):  # 65 rows: f32 under Q4_0_4_4
        w.add(name, rng.standard_normal(shape).astype(np.float32), DataType.F32)
    w.write()
    return path


@pytest.mark.parametrize("dtype", quantizer.DTYPES)
@pytest.mark.parametrize("source", ["golden", "wide"])
def test_quantizer_equals_jax(tmp_path, monkeypatch, jax_numpy_paths, wide_f32, source, dtype):
    src = F32 if source == "golden" else wide_f32
    nq, nf = quantizer.main([src, str(tmp_path / "port.mllm"), dtype])
    monkeypatch.setattr(sys, "argv", ["quantizer.py", src, str(tmp_path / "jax.mllm"), dtype])
    _jax_tool("quantizer").main()
    # the golden's tensors all sit under the tool's size floor; the wide file's projections pass it
    if source == "golden":
        assert (nq, nf) == (0, 5)
    else:
        assert (nq, nf) == ((3, 4) if dtype == "Q4_0_4_4" else (4, 3))
    assert _bytes(tmp_path / "port.mllm") == _bytes(tmp_path / "jax.mllm")


def test_q4_0_4_4_packing_equals_the_reference_golden():
    """The tool's row rule and packer on tiny_f32's projections give the
    bytes the reference C++ quantizer wrote into tiny_q4044.mllm (which has
    no size floor; the tool keeps these small tensors f32)."""
    from mllm_tpu_torch.core import dtypes as dt

    src, ref = ParamLoader(F32), ParamLoader(os.path.join(GOLDENS, "tiny_q4044.mllm"))
    hidden = quantizer.hidden_dim(src)
    names = [n for n in src if n in ref and ref.dtype(n) == DataType.Q4_0_4_4]
    assert hidden == 64 and len(names) == 3
    for n in names:
        arr = src.raw(n).view(np.float32)
        got = dt.quant_q4_0_4x4(arr, quantizer.row_width(n, arr.size, hidden))
        assert got.tobytes() == bytes(ref.raw(n))


def test_quantizer_skip_rules():
    assert not quantizer.should_quantize("model.layers.0.input_layernorm.weight", 1 << 16)
    assert not quantizer.should_quantize("model.embed_tokens.weight", 1 << 16)
    assert not quantizer.should_quantize("model.layers.0.mlp.up_proj.weight", (1 << 14) - 256)
    assert quantizer.should_quantize("model.layers.0.mlp.up_proj.weight", 1 << 14)


# ---------------------------------------------------------------------------
# rotate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("head_dim", [16, 24])  # 16: randomized Hadamard; 24: Haar-random orthogonal
def test_rotate_vo_equals_jax_and_keeps_the_function(head_dim):
    kw = dict(vocab_size=64, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, head_dim=head_dim,
              max_position_embeddings=64, eos_token_id=63, attention_bias=True)
    jm = JaxCausalLM.init(jax.random.PRNGKey(0), JaxTextConfig(**kw))
    jrot = _jax_tool("rotate").rotate_vo(jm, seed=3)
    model = causal_lm_from_jax_params({k: np.asarray(v) for k, v in jm.parameters().items()},
                                      TextConfig(**kw), CPU)
    rotated = rotate.rotate_vo(model, seed=3)
    want = {k: np.asarray(v) for k, v in jrot.parameters().items()}
    for li in range(2):
        for name in ("v_proj.weight", "v_proj.bias", "o_proj.weight"):
            got = rotated.get_submodule(f"blocks.{li}.attn.{name.split('.')[0]}")
            got = getattr(got, name.split(".")[1]).detach().numpy()
            ref = next(v for k, v in want.items() if k.endswith(f"{li}.attn.{name}"))
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert model.blocks[0].attn.v_proj is not rotated.blocks[0].attn.v_proj  # the source is left as it was
    ids = torch.arange(1, 13)[None]
    with torch.no_grad():
        a, _ = model(ids, model.init_cache(1, 16, torch.float32), last_only=False)
        b, _ = rotated(ids, rotated.init_cache(1, 16, torch.float32), last_only=False)
    assert float((a - b).abs().max()) <= 1e-4 * float(a.abs().max())


def test_rotate_check_on_the_cpu():
    out = rotate.main(["--check", "--device", "cpu"])
    assert out["max_diff"] <= 1e-4 * out["max_logit"]


def test_rotate_refuses_quantized_projections():
    from mllm_tpu_torch.models.transformer import CausalLM
    from mllm_tpu_torch.ops.quantize_model import quantize_model

    cfg = TextConfig(vocab_size=64, hidden_size=64, intermediate_size=128, num_hidden_layers=1,
                     num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)
    model = quantize_model(CausalLM.init(cfg, device=CPU), "int8", min_size=1)
    with pytest.raises(TypeError, match="rotate before quantizing"):
        rotate.rotate_vo(model)


# ---------------------------------------------------------------------------
# ci
# ---------------------------------------------------------------------------

STAGES = ["device", "build", "generate", "int8_decode", "tokenizer", "image_preprocess", "kv_cache"]


def test_ci_cpu_every_stage_ok(capsys):
    report = ci.main(["--device", "cpu"])
    assert report["ok"] and report["platform"] == "cpu"
    assert list(report["stages"]) == STAGES and all(s["ok"] for s in report["stages"].values())
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == report


def test_ci_failed_stage_exits_1_and_is_named(monkeypatch, capsys):
    from mllm_tpu_torch.processor import image

    def broken(*a, **k):
        raise ValueError("resize broke")

    monkeypatch.setattr(image, "smart_resize", broken)
    with pytest.raises(SystemExit) as e:
        ci.main(["--device", "cpu"])
    assert e.value.code == 1
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["ok"] is False
    assert [n for n, s in report["stages"].items() if not s["ok"]] == ["image_preprocess"]
    assert report["stages"]["image_preprocess"]["error"] == "ValueError: resize broke"


def test_ci_process_exits_1_when_a_stage_fails():
    """As a process, ci exits 1 when a stage fails (here the child's image
    resize is deleted before the run)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    bad = subprocess.run([sys.executable, "-c",
                          "from mllm_tpu_torch.processor import image; del image.smart_resize\n"
                          "from mllm_tpu_torch.tools import ci; ci.main(['--device', 'cpu'])"],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert bad.returncode == 1, bad.stderr
    report = json.loads(bad.stdout.strip().splitlines()[-1])
    assert [n for n, s in report["stages"].items() if not s["ok"]] == ["image_preprocess"]


@pytest.mark.parametrize("rc, out", [(0, "dryrun OK: mesh dp=2 tp=4"), (1, "")])
def test_ci_dryrun_stage(monkeypatch, capsys, rc, out):
    calls = []

    def run(cmd, **kw):
        calls.append((cmd, kw))
        return subprocess.CompletedProcess(cmd, rc, stdout=out, stderr="boom" if rc else "")

    monkeypatch.setattr(ci.subprocess, "run", run)
    if rc:
        with pytest.raises(SystemExit):
            ci.main(["--device", "cpu", "--dryrun"])
        report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    else:
        report = ci.main(["--device", "cpu", "--dryrun"])
    (cmd, kw), = calls
    assert cmd[1:] == ["-m", "mllm_tpu_torch.parallel.dryrun", "--device", "cpu"]
    assert kw["cwd"] == REPO and kw["timeout"] == ci.DRYRUN_BUDGET_S
    assert report["stages"]["multichip_dryrun"]["ok"] is (rc == 0)


# ---------------------------------------------------------------------------
# no default to the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [["--check"], []], ids=["rotate", "ci"])
def test_no_card_raises_without_device_cpu(argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)  # no card, on any host
    tool = rotate if argv else ci
    with pytest.raises(RuntimeError, match="found none"):
        tool.main(argv)


def test_bf16_safetensors_round_trip(tmp_path):
    """`write_safetensors` takes bf16 torch tensors (the CLIs' checkpoints on
    the card); the loader widens them to f32 exactly (the f32 of the same
    bits shifted 16 up), and `in` finds a name without decoding it."""
    from mllm_tpu_torch.core.param_loader import SafetensorsLoader

    g = torch.Generator().manual_seed(1)
    w = torch.randn(24, 40, generator=g).to(torch.bfloat16)
    w.view(-1)[:3] = torch.tensor([float("inf"), float("-inf"), float("nan")], dtype=torch.bfloat16)
    write_safetensors(tmp_path / "m.safetensors", {"w": w, "b": np.arange(5, dtype=np.float32),
                                                   "e": torch.zeros(0, dtype=torch.bfloat16)})
    ld = SafetensorsLoader(str(tmp_path / "m.safetensors"))
    bits = w.view(torch.int16).numpy().astype(np.uint16).astype(np.uint32) << 16
    got = ld.load("w", None, np.float32)
    assert got.shape == (24, 40) and np.array_equal(got.view(np.uint32), bits)
    assert np.array_equal(ld.load("b"), np.arange(5, dtype=np.float32)) and ld.load("e").shape == (0,)
    assert "w" in ld and "x" not in ld


def test_host_packers_equal_jax_on_ties_and_zero_rows(monkeypatch):
    """The packers of `-q int8` / `-q int4` at load (torch on the host) give
    the JAX numpy packers' bytes, ties to even and all-zero rows and groups
    included."""
    from mllm_tpu.ops import quant_matmul as jqm
    from mllm_tpu_torch.ops import quant_matmul as qm

    monkeypatch.setattr(jnative, "repack_int8", lambda w: None)
    monkeypatch.setattr(jnative, "repack_int4", lambda w, group=32: None)
    w = np.random.default_rng(5).standard_normal((48, 256)).astype(np.float32)
    w[0] = 0.0
    w[1, :64] = 0.0  # two zero groups of 32
    w[2] = np.arange(256) % 16 - 7.5  # amax 7.5 in each group of 32: scales 7.5/7, 7.5/127
    w[3, :32] = np.arange(32) % 15 - 7.0 + 0.5 * (np.arange(32) % 2)  # x.5 at scale 1 (int4)
    w[3, 32:] = 0.5 * (np.arange(224) % 255) * (1 - 2 * (np.arange(224) % 2))
    w[3, 255] = 127.0  # int8 scale 1: the x.5 values tie
    for got, want in zip(qm.repack_float_to_int8(w), jqm.repack_float_to_int8(w)):
        assert got.dtype == want.dtype and got.shape == want.shape and got.tobytes() == want.tobytes()
    for got, want in zip(qm.repack_float_to_int4(w, 32), jqm.repack_float_to_int4(w, 32)):
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape and got.tobytes() == want.tobytes()
