"""The port's LoRA CLI (`mllm_tpu_torch.examples.train_lora`) against the
JAX package's (`examples/train_lora.py`) on the CPU, in f32, on a tiny qwen2
directory (`test_torch_cli._write_dir`: hidden 256, 2 layers, a synthetic
tokenizer).

- `batches`: the same windows from the same seed as the JAX generator.
- The CLI's steps from the JAX adapters (carried across with
  `bridge.port_state_dict`): the first step's loss within 1e-5 (relative)
  of the JAX loop's, the later ones within 1e-4 (AdamW divides each update
  by its running RMS, so the two packages' f32 roundings of the gradients
  grow step by step: 2.5e-5 at step 4 on this model) (optax adamw with its defaults; the port's AdamW with
  weight decay 1e-4). The first step does not depend on the adapters' A
  (B starts at 0), so it also holds the port's own draw.
- `--ckpt` / `--resume`: the step count continues, and the resumed steps
  (the batch generator restarts, as in the JAX script) give the JAX loop's
  losses when its state runs on from step 2 over fresh batches.
- `--out`: the merged directory loads in both packages' `auto_model`, logits
  within 1e-5 x max |logit|.
- Without `--device cpu` the CLI raises `default_device`'s error here.
"""

import functools
import importlib.util
import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mllm_tpu.models.registry import auto_model as jax_auto_model
from mllm_tpu.training import TrainState as JaxTrainState
from mllm_tpu.training import add_lora as jax_add_lora
from mllm_tpu.training import lora_params_filter as jax_lora_filter
from mllm_tpu.training import make_train_step as jax_make_train_step
from mllm_tpu_torch import training as port_training
from mllm_tpu_torch.examples import train_lora
from mllm_tpu_torch.models.bridge import port_state_dict
from mllm_tpu_torch.models.registry import auto_model

from test_torch_cli import TINY, _write_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
TOL = 1e-5
STEP_TOL = 1e-4  # steps after the first
RANK, ALPHA, LR, SEQ, BATCH = 4, 16.0, 1e-2, 16, 2
TEXT = "the quick brown fox jumps over the lazy dog; 1234 + 5678 = 6912. " * 12


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_train_lora", os.path.join(REPO, "examples", "train_lora.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("lora")
    d = _write_dir(root / "model", 3)
    data = root / "data.txt"
    data.write_text(TEXT)
    return str(d), str(data), root


@functools.lru_cache(maxsize=None)
def _jax_run(d: str, data: str, steps: int, restart_at: int = 0):
    """The JAX script's loop: (losses, the adapters' JAX parameters at the
    start). With restart_at, the batch generator restarts after that many
    steps (a resumed run)."""
    script = _jax_script()
    model, tok, _ = jax_auto_model(d, dtype=jnp.float32)
    ids = np.asarray(tok.encode(open(data).read(), bos=True), np.int64)
    lora = jax_add_lora(model, jax.random.PRNGKey(0), RANK, ALPHA, r"(q_proj|k_proj|v_proj|o_proj)")
    start = {k: np.asarray(v) for k, v in lora.parameters().items() if "lora_" in k}
    tx = optax.adamw(LR)
    state = JaxTrainState.create(lora, tx, trainable=jax_lora_filter)
    step = jax_make_train_step(tx, trainable=jax_lora_filter)
    gens = [script.batches(ids, SEQ, BATCH)] if not restart_at else [
        itertools.islice(script.batches(ids, SEQ, BATCH), restart_at), script.batches(ids, SEQ, BATCH)]
    losses = []
    for (x, y), _ in zip(itertools.chain(*gens), range(steps)):
        state, loss = step(state, x, y)
        losses.append(float(loss))
    return losses, start


@pytest.fixture
def carried(setup, monkeypatch):
    """The CLI's `add_lora` set to the JAX script's adapters."""
    d, data, _ = setup
    _, start = _jax_run(d, data, 1)
    real = port_training.add_lora

    def add_lora(model, generator, rank, alpha, targets):
        model = real(model, generator, rank, alpha, targets)
        want = port_state_dict(start, TINY["num_hidden_layers"])
        missing, _ = model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in want.items()}, strict=False)
        assert not [k for k in missing if "lora_" in k]
        return model

    monkeypatch.setattr(port_training, "add_lora", add_lora)


def _close(got: list, want: list) -> None:
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert abs(a - b) <= (TOL if i == 0 else STEP_TOL) * abs(b), (i, got, want)


def _cli(d, data, *flags):
    return train_lora.main(["-m", d, "-d", data, "--rank", str(RANK), "--alpha", str(ALPHA), "--lr", str(LR),
                            "--seq", str(SEQ), "--batch", str(BATCH), "--device", "cpu", *flags])


def test_batches_equal_jax():
    ids = np.arange(300, dtype=np.int64) * 7 % 97
    want = _jax_script().batches(ids, SEQ, 3, seed=5)
    for (x, y), (jx, jy) in zip(itertools.islice(train_lora.batches(ids, SEQ, 3, seed=5), 6), want):
        np.testing.assert_array_equal(x, np.asarray(jx))
        np.testing.assert_array_equal(y, np.asarray(jy))
        assert x.shape == (3, SEQ)


def test_first_step_loss_equals_jax_with_its_own_adapters(setup):
    d, data, _ = setup
    want, _ = _jax_run(d, data, 3)
    got = _cli(d, data, "--steps", "1")
    assert abs(got["losses"][0] - want[0]) <= TOL * abs(want[0])


def test_steps_from_the_jax_adapters_equal_jax(setup, carried, capsys):
    d, data, _ = setup
    want, _ = _jax_run(d, data, 3)
    got = _cli(d, data, "--steps", "3")
    assert got["end_step"] == 3
    _close(got["losses"], want)
    out = capsys.readouterr().out
    assert "step     1  loss" in out and "step     2" not in out  # step 1 and every 10th


def test_checkpoint_resume_continues_the_steps(setup, carried, capsys):
    d, data, root = setup
    ckpt = str(root / "ckpt.pt")
    first = _cli(d, data, "--steps", "2", "--ckpt", ckpt)
    assert (first["start_step"], first["end_step"]) == (0, 2) and os.path.isfile(ckpt)
    again = _cli(d, data, "--steps", "2", "--ckpt", ckpt, "--resume")
    assert (again["start_step"], again["end_step"]) == (2, 4)
    assert f"resumed from {ckpt} at step 2" in capsys.readouterr().out
    want, _ = _jax_run(d, data, 4, restart_at=2)
    _close(first["losses"] + again["losses"], want)


def test_merged_directory_loads_in_both_packages(setup):
    d, data, root = setup
    out = str(root / "merged")
    got = _cli(d, data, "--steps", "2", "--out", out)
    assert got["end_step"] == 2 and os.path.isfile(os.path.join(out, "model.safetensors"))
    ids = np.random.default_rng(0).integers(0, TINY["vocab_size"], (1, 12))
    jm, _, _ = jax_auto_model(out, dtype=jnp.float32)
    jl, _ = jm(jnp.asarray(ids, jnp.int32), jm.init_cache(1, 32, jnp.float32), last_only=False)
    tm, tok, _ = auto_model(out, dtype=torch.float32, device=CPU)
    assert tok is not None  # the tokenizer was copied beside the weights
    with torch.no_grad():
        tl, _ = tm(torch.from_numpy(ids), tm.init_cache(1, 32, torch.float32), last_only=False)
    jl = np.asarray(jl, np.float64)
    assert np.abs(tl.double().numpy() - jl).max() <= TOL * np.abs(jl).max()
    base, _, _ = auto_model(d, dtype=torch.float32, device=CPU)
    with torch.no_grad():
        bl, _ = base(torch.from_numpy(ids), base.init_cache(1, 32, torch.float32), last_only=False)
    assert not torch.equal(bl, tl)  # the adapters moved the model


def test_no_card_raises_without_device_cpu(setup, monkeypatch):
    d, data, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="found none"):
        train_lora.main(["-m", d, "-d", data, "--steps", "1"])
