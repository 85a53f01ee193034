"""Training on one device (`mllm_tpu_torch/training/`, `CausalLM.loss` with
remat, `save_safetensors_model`, `KVCache.dtype_bytes`) against
`mllm_tpu/training/` and the JAX model on the same weights (bridged), and the
repair that keeps a loss needing gradients off the CUDA kernels.

Tolerances (f32): losses 1e-5 relative; gradients and updated parameters
1e-5 x max|.|; logits of a reloaded checkpoint 1e-5 x max|.| (2e-5 against
transformers, which sums in its own order).
"""

import json
import types

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from mllm_tpu.core.config import TextConfig as JaxTextConfig
from mllm_tpu.models.transformer import CausalLM as JaxCausalLM
from mllm_tpu.training import TrainState as JaxTrainState
from mllm_tpu.training import add_lora as jax_add_lora
from mllm_tpu.training import lora_params_filter as jax_lora_filter
from mllm_tpu.training import make_train_step as jax_make_train_step
from mllm_tpu.training import merge_lora as jax_merge_lora
from mllm_tpu_torch.core.config import TextConfig
from mllm_tpu_torch.models.bridge import causal_lm_from_jax_params, port_state_dict
from mllm_tpu_torch.training import (LoRALinear, TrainState, add_lora, lora_params_filter, make_train_step,
                                     merge_lora, restore_checkpoint, save_checkpoint)
from mllm_tpu_torch.training.train import partition

CPU = torch.device("cpu")
KW = dict(vocab_size=101, hidden_size=64, intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
          num_key_value_heads=2, head_dim=16, max_position_embeddings=64, eos_token_id=-5)
TOL = 1e-5
RANK, ALPHA = 4, 16.0
ADAMW = dict(lr=5e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _np(params):
    return {k: np.asarray(v) for k, v in params.items()}


def _port(jm, lora_scale=None):
    return causal_lm_from_jax_params(_np(jm.parameters()), TextConfig(**KW), CPU, torch.float32,
                                     lora_scale=lora_scale)


def _batch(seed=0, b=2, s=12):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 101, (b, s))
    return ids, np.roll(ids, -1, axis=1)


def _grads(model, loss_fn):
    """(loss, {name: gradient}) of every float parameter."""
    params = partition(model)
    names = [k for k, p in model.named_parameters() if p.requires_grad]
    loss = loss_fn()
    return loss, dict(zip(names, torch.autograd.grad(loss, params)))


@pytest.fixture(scope="module")
def jm():
    return JaxCausalLM.init(jax.random.PRNGKey(0), JaxTextConfig(**KW))


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_grads_match_jax(jm, remat, masked):
    ids, tgt = _batch()
    mask = (np.random.default_rng(1).random(ids.shape) > 0.3).astype(np.float32)
    jmask = jnp.asarray(mask) if masked else None
    jl, jg = jax.value_and_grad(lambda m: m.loss(jnp.asarray(ids), jnp.asarray(tgt), mask=jmask, remat=remat))(jm)
    tm = _port(jm)
    loss, grads = _grads(tm, lambda: tm.loss(torch.as_tensor(ids), torch.as_tensor(tgt), remat=remat,
                                              mask=torch.as_tensor(mask) if masked else None))
    assert abs(float(loss) - float(jl)) <= TOL * abs(float(jl))
    want = port_state_dict(_np(jg.parameters()), KW["num_hidden_layers"])
    for name, g in grads.items():
        assert _rel(g, want[name]) < TOL, name


def test_remat_gradients_equal(jm):
    """torch.utils.checkpoint recomputation changes neither the loss nor a
    gradient (the JAX test's claim, on the port alone)."""
    ids, tgt = (torch.as_tensor(a) for a in _batch(5))
    tm = _port(jm)
    plain, g0 = _grads(tm, lambda: tm.loss(ids, tgt))
    re, g1 = _grads(tm, lambda: tm.loss(ids, tgt, remat=True))
    assert float(re) == float(plain)
    for name in g0:
        assert _rel(g1[name], g0[name]) < TOL, name


@pytest.fixture(scope="module")
def jax_lora(jm):
    """The JAX LoRA model, one AdamW step of it (optax, every hyperparameter
    set) and the gradients of the stepped model (lora_b nonzero by then)."""
    lora = jax_add_lora(jm, jax.random.PRNGKey(7), rank=RANK, alpha=ALPHA)
    tx = optax.adamw(ADAMW["lr"], b1=ADAMW["b1"], b2=ADAMW["b2"], eps=ADAMW["eps"],
                     weight_decay=ADAMW["weight_decay"])
    state = JaxTrainState.create(lora, tx, trainable=jax_lora_filter)
    step = jax_make_train_step(tx, trainable=jax_lora_filter)
    ids, tgt = _batch(1)
    stepped, loss = step(state, jnp.asarray(ids), jnp.asarray(tgt))
    grads = jax.grad(lambda m: m.loss(jnp.asarray(ids), jnp.asarray(tgt)))(stepped.model)
    return {"lora": lora, "stepped": stepped.model, "loss": float(loss), "grads": _np(grads.parameters()),
            "merged": jax_merge_lora(stepped.model)}


def _torch_adamw(params):
    return torch.optim.AdamW(params, lr=ADAMW["lr"], betas=(ADAMW["b1"], ADAMW["b2"]), eps=ADAMW["eps"],
                             weight_decay=ADAMW["weight_decay"])


def test_lora_adamw_step_matches_optax(jax_lora):
    """One LoRA step: torch.optim.AdamW against optax adamw, both with every
    hyperparameter set (their weight_decay defaults differ)."""
    tm = _port(jax_lora["lora"], lora_scale=ALPHA / RANK)
    state = TrainState.create(tm, _torch_adamw, trainable=lora_params_filter)
    step = make_train_step(trainable=lora_params_filter)
    ids, tgt = _batch(1)
    state, loss = step(state, torch.as_tensor(ids), torch.as_tensor(tgt))
    assert abs(float(loss) - jax_lora["loss"]) <= TOL * abs(jax_lora["loss"])
    assert state.step == 1
    want = port_state_dict(_np(jax_lora["stepped"].parameters()), KW["num_hidden_layers"])
    for name, p in state.model.state_dict().items():
        assert _rel(p, want[name]) < TOL, name


def test_lora_qkv_gradients_nonzero_and_match_jax(jax_lora):
    """The repair's point: a LoRA loss through attention gives every q/k/v/o
    adapter a nonzero gradient, equal to JAX's."""
    tm = _port(jax_lora["stepped"], lora_scale=ALPHA / RANK)
    ids, tgt = _batch(1)
    params = partition(tm, lora_params_filter)
    names = [k for k, p in tm.named_parameters() if p.requires_grad]
    loss = tm.loss(torch.as_tensor(ids), torch.as_tensor(tgt))
    want = port_state_dict(jax_lora["grads"], KW["num_hidden_layers"])
    assert len(names) == 2 * 4 * KW["num_hidden_layers"]
    for name, g in zip(names, torch.autograd.grad(loss, params)):
        assert float(g.abs().max()) > 0, name
        assert _rel(g, want[name]) < TOL, name


def test_add_lora_starts_identical_and_merge_matches_jax(jm, jax_lora):
    """The port's add_lora (its own generator's draws) leaves the loss as it
    was; merge_lora of the bridged stepped JAX adapters equals JAX
    merge_lora's weights; a second add_lora on a sharded-free model raises
    when nothing matches."""
    ids, tgt = (torch.as_tensor(a) for a in _batch(1))
    tm = _port(jm)
    base = float(tm.loss(ids, tgt))
    add_lora(tm, torch.Generator().manual_seed(3), rank=RANK, alpha=ALPHA)
    assert isinstance(tm.blocks[0].attn.q_proj, LoRALinear)
    assert tm.blocks[0].attn.q_proj.scale == ALPHA / RANK
    assert abs(float(tm.loss(ids, tgt)) - base) <= TOL * base
    merged = merge_lora(_port(jax_lora["stepped"], lora_scale=ALPHA / RANK))
    assert not any(isinstance(m, LoRALinear) for m in merged.modules())
    want = port_state_dict(_np(jax_lora["merged"].parameters()), KW["num_hidden_layers"])
    for name, p in merged.state_dict().items():
        assert _rel(p, want[name]) < TOL, name
    with pytest.raises(ValueError, match="no Linear matched"):
        add_lora(_port(jm), torch.Generator(), targets=r"nothing_here")


def test_full_finetune_loss_decreases(jm):
    tm = _port(jm)
    state = TrainState.create(tm, lambda ps: torch.optim.AdamW(ps, lr=3e-3))
    step = make_train_step()
    ids, tgt = (torch.as_tensor(a) for a in _batch())
    losses = []
    for _ in range(6):
        state, loss = step(state, ids, tgt)
        losses.append(float(loss))
    assert losses[-1] < losses[0] and state.step == 6


def test_train_step_trains_what_trainable_names(jm):
    """`trainable` decides what a step trains, as in the JAX step: a state
    whose optimizer holds other parameters than the ones it names raises
    before any update (every float parameter against the adapters, and the
    adapters against trainable=None, which names every float parameter)."""
    ids, tgt = (torch.as_tensor(a) for a in _batch())
    sgd = lambda ps: torch.optim.SGD(ps, lr=1.0)  # noqa: E731
    full = TrainState.create(add_lora(_port(jm), torch.Generator().manual_seed(2), rank=RANK), sgd)
    lora = TrainState.create(add_lora(_port(jm), torch.Generator().manual_seed(2), rank=RANK), sgd,
                             trainable=lora_params_filter)
    for state, step in ((full, make_train_step(trainable=lora_params_filter)), (lora, make_train_step())):
        before = {k: v.clone() for k, v in state.model.state_dict().items()}
        with pytest.raises(ValueError, match="trainable"):
            step(state, ids, tgt)
        assert state.step == 0
        assert all(torch.equal(v, before[k]) for k, v in state.model.state_dict().items())
    state, _ = make_train_step(trainable=lora_params_filter)(lora, ids, tgt)
    assert state.step == 1


def test_checkpoint_roundtrip(jm, tmp_path):
    ids, tgt = (torch.as_tensor(a) for a in _batch(2))
    factory = lambda ps: torch.optim.AdamW(ps, lr=1e-3)  # noqa: E731
    state = TrainState.create(_port(jm), factory)
    step = make_train_step()
    state, _ = step(state, ids, tgt)
    path = str(tmp_path / "ckpt.pt")
    save_checkpoint(path, state)
    save_checkpoint(path, state)  # a checkpoint is replaced
    restored = restore_checkpoint(path, TrainState.create(_port(jm), factory))
    assert restored.step == 1
    for a, b in zip(restored.model.state_dict().values(), state.model.state_dict().values()):
        assert torch.equal(a, b)
    _, l1 = step(state, ids, tgt)
    _, l2 = step(restored, ids, tgt)
    assert float(l1) == float(l2)  # training resumes identically
    other = tmp_path / "notes.txt"
    other.write_text("not a checkpoint")
    with pytest.raises(ValueError, match="not a checkpoint"):
        save_checkpoint(str(other), state)
    assert other.read_text() == "not a checkpoint" and not (tmp_path / "notes.txt.saving").exists()


def test_save_safetensors_roundtrip(tmp_path):
    """Fine-tune -> merge -> save -> reload: the port's file holds the names
    and f32 bytes the safetensors package reads (an oracle only); auto_model
    (the port's and the JAX package's) and transformers reload it with the
    merged model's logits."""
    import transformers
    from safetensors.numpy import load_file

    from mllm_tpu.models.registry import auto_model as jax_auto_model
    from mllm_tpu_torch.core.param_loader import save_safetensors_model
    from mllm_tpu_torch.models.registry import auto_model

    torch.manual_seed(3)
    hf_cfg = transformers.Qwen2Config(vocab_size=101, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                      num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
                                      rope_theta=10000.0, tie_word_embeddings=False, bos_token_id=0, eos_token_id=1)
    transformers.Qwen2ForCausalLM(hf_cfg).save_pretrained(tmp_path / "src")
    model, _, _ = auto_model(str(tmp_path / "src"), dtype=torch.float32, with_tokenizer=False, device="cpu")
    add_lora(model, torch.Generator().manual_seed(1), rank=4)
    state = TrainState.create(model, lambda ps: torch.optim.AdamW(ps, lr=5e-3), trainable=lora_params_filter)
    step = make_train_step(trainable=lora_params_filter)
    ids, tgt = (torch.as_tensor(a) for a in _batch(4))
    for _ in range(3):
        state, _ = step(state, ids, tgt)
    merged = merge_lora(state.model)
    save_safetensors_model(str(tmp_path / "out"), merged, str(tmp_path / "src"))

    stored = load_file(str(tmp_path / "out" / "model.safetensors"))
    hf_names = set(transformers.Qwen2ForCausalLM(hf_cfg).state_dict())
    assert set(stored) == hf_names - {"model.rotary_emb.inv_freq"}
    assert stored["model.layers.0.self_attn.q_proj.weight"].dtype == np.float32
    np.testing.assert_array_equal(stored["model.layers.1.self_attn.q_proj.weight"],
                                  merged.blocks[1].attn.q_proj.weight.detach().numpy())
    assert json.loads((tmp_path / "out" / "config.json").read_text())["hidden_size"] == 32

    with torch.no_grad():
        want = merged(ids, merged.init_cache(2, 32, torch.float32), last_only=False)[0]
        back, _, _ = auto_model(str(tmp_path / "out"), dtype=torch.float32, with_tokenizer=False, device="cpu")
        got = back(ids, back.init_cache(2, 32, torch.float32), last_only=False)[0]
        hf = transformers.Qwen2ForCausalLM.from_pretrained(tmp_path / "out").eval()(ids).logits
    jmodel, _, _ = jax_auto_model(str(tmp_path / "out"), dtype=jnp.float32, with_tokenizer=False)
    jgot, _ = jmodel(jnp.asarray(ids.numpy()), jmodel.init_cache(2, 32, jnp.float32), last_only=False)
    assert _rel(got, want) < TOL
    assert _rel(np.asarray(jgot), want) < TOL
    assert _rel(hf, want) < 2e-5
    with pytest.raises(ValueError, match="LoRALinear"):
        save_safetensors_model(str(tmp_path / "bad"), add_lora(back, torch.Generator(), rank=2))


def test_megadecode_loss_is_the_base_models(jm):
    from mllm_tpu_torch.models.megadecode import MegaDecodeLM

    tm = _port(jm)
    ids, tgt = (torch.as_tensor(a) for a in _batch(6))
    with torch.no_grad():
        got = MegaDecodeLM.loss(types.SimpleNamespace(base=tm), ids, tgt)
        assert float(got) == float(tm.loss(ids, tgt))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kvcache_dtype_bytes_matches_jax(dtype):
    from mllm_tpu.kv.cache import KVCache as JaxKVCache
    from mllm_tpu_torch.kv.cache import KVCache

    want = JaxKVCache.init(1, 1, 8, 1, 4, getattr(jnp, dtype)).dtype_bytes()
    assert KVCache.init(1, 1, 8, 1, 4, device=CPU, dtype=getattr(torch, dtype)).dtype_bytes() == want


# ---------------------------------------------------------------------------
# The repair: no CUDA kernel under a gradient
# ---------------------------------------------------------------------------


def test_attention_route_sends_gradient_calls_to_sdpa():
    from mllm_tpu_torch.nn.attention import attention_route, needs_grad

    q = torch.zeros(1, 4, 2, 64, requires_grad=True)
    assert needs_grad(q) and attention_route(4, head_dim=64, grad=needs_grad(q)) == "sdpa"
    assert attention_route(1, head_dim=64, grad=True, cache="quant") == "sdpa"
    with torch.no_grad():
        assert not needs_grad(q)
        assert attention_route(4, head_dim=64, grad=needs_grad(q)) == "flash"
    assert attention_route(1, head_dim=128, grad=needs_grad(q.detach())) == "decode"


def test_attend_takes_sdpa_under_a_gradient_and_the_kernels_without(monkeypatch):
    """`attend` and `attend_padded_head` with q/k/v requiring grad never
    reach a kernel wrapper; under no_grad (or with frozen inputs) they do."""
    from mllm_tpu_torch.nn import attention as port_attention

    calls = []
    monkeypatch.setattr(port_attention, "flash_attention", lambda *a, **k: calls.append("flash") or a[0] * 0)
    monkeypatch.setattr(port_attention, "decode_attention", lambda *a, **k: calls.append("decode") or a[0] * 0)
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 8, 4, 64, generator=g, requires_grad=True)
    k, v = (torch.randn(1, 2, 8, 64, generator=g, requires_grad=True) for _ in range(2))
    out = port_attention.attend(q, k, v)
    out.sum().backward()
    assert calls == [] and q.grad is not None and float(k.grad.abs().max()) > 0
    port_attention.attend(q[:, :1], k, v, kv_valid_len=1).sum().backward()
    assert calls == []
    with torch.no_grad():
        port_attention.attend(q, k, v)
        port_attention.attend(q[:, :1], k, v, kv_valid_len=8)
    port_attention.attend(q.detach(), k.detach(), v.detach())
    assert calls == ["flash", "decode", "flash"]


def _wrapper_calls():
    """(module, wrapper, a call with a grad-requiring input) for each of the
    ten CUDA kernel wrappers."""
    from mllm_tpu_torch.ops import decode_attention as da
    from mllm_tpu_torch.ops import decode_step as ds
    from mllm_tpu_torch.ops import flash_attention as fa
    from mllm_tpu_torch.ops import fused_mlp as fm
    from mllm_tpu_torch.ops import quant_matmul as qm

    q = torch.zeros(1, 1, 2, 64, requires_grad=True)
    kv = torch.zeros(1, 1, 8, 64)
    x = torch.zeros(1, 64, requires_grad=True)
    s = torch.zeros(1, 1, 8)
    w8 = torch.zeros(64, 16, dtype=torch.int8)
    ops = (torch.zeros(32, 16, dtype=torch.uint8), torch.zeros(2, 16), None)
    tab = torch.zeros(1, 1, dtype=torch.int32)
    mega = (x, 0, torch.eye(128)) + (ops,) * 5 + (torch.ones(64),) * 2 + (kv, kv)
    mega_kw = dict(n_heads=2, n_kv_heads=1, head_dim=128)
    return [
        (fa, fa.flash_attention, lambda: fa.flash_attention(q, kv, kv)),
        (fa, fa.flash_attention_quant, lambda: fa.flash_attention_quant(q, kv, kv, s, s)),
        (da, da.decode_attention, lambda: da.decode_attention(q, kv, kv)),
        (da, da.decode_attention_quant, lambda: da.decode_attention_quant(q, kv, kv, s, s)),
        (da, da.decode_attention_paged, lambda: da.decode_attention_paged(q, kv, kv, tab)),
        (qm, qm.int8_matmul, lambda: qm.int8_matmul(x, w8, torch.ones(16))),
        (qm, qm.int4_matmul, lambda: qm.int4_matmul(x, *ops[:2])),
        (fm, fm.fused_int4_mlp, lambda: fm.fused_int4_mlp(x, ops, ops, ops)),
        (ds, ds.fused_decode_step, lambda: ds.fused_decode_step(*mega, **mega_kw)),
        (ds, ds.fused_decode_step_batched, lambda: ds.fused_decode_step_batched(
            x, 0, torch.zeros(1, 64), torch.zeros(1, 64), *mega[3:], **mega_kw)),
    ]


@pytest.mark.parametrize("index", range(10))
def test_every_kernel_wrapper_refuses_a_gradient_before_launching(index, monkeypatch):
    """With the wrappers' device test patched so that CPU tensors take the
    device branch, each wrapper raises the refusal (naming its kernel) on a
    grad-requiring input before anything else: no argument check, no build,
    no launch."""
    from mllm_tpu_torch.ops import _build, _common

    mod, wrapper, call = _wrapper_calls()[index]
    monkeypatch.setattr(mod, "on_cpu", lambda t: False)
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("reached the kernel library"))
    before = wrapper.launches
    with pytest.raises(RuntimeError, match=f"{wrapper.__name__}: an input requires grad"):
        call()
    assert wrapper.launches == before
    with pytest.raises(RuntimeError, match="requires grad"):
        _common.refuse_grad(wrapper.__name__, torch.zeros(1, requires_grad=True))
    _common.refuse_grad(wrapper.__name__, torch.zeros(1))  # no gradient: no refusal
    with torch.no_grad():
        _common.refuse_grad(wrapper.__name__, (torch.zeros(1, requires_grad=True),))
