"""The pure cuts of int4 weights on the canonical planar layout (tensor
parallelism and head padding) against the JAX package's dequantizers, on
the same numpy operands (CPU):

- `int4_take_k` (a rank's K range, the row cut of o_proj / down_proj) and
  `int4_take_n` (the column cut) for tp 2 and 4, symmetric and affine, with
  K / tp on and off the pad boundary of `prepare_int4`: each rank's
  `dequant_int4_canonical` equals the matching slice of the JAX package's
  dequantized whole, bit for bit;
- `fused_mlp_shard` (a FusedInt4MLP's hidden units): each rank's block-planar
  down operands dequantize to its rows of the JAX package's whole, bit for
  bit, and the ranks' `fused_int4_mlp_ref` partials sum to the whole within
  1e-5 relative (f32, another summation order); the rank's block at
  Qwen2-VL-2B's tp 2 and tp 4 widths, and the kernel's plan for it;
- `pad_heads_for_tp` on int4 projections: the padded model's logits within
  1e-5 x max |logit| of the unpadded one's, and at the geometry of the JAX
  package's `test_pad_heads_int4_xla` within 1e-2 of the JAX padded model's
  (its n-axis int4 product, `int4_xla_matmul`, rounds x and the weight to
  bf16: 2^-8 relative a product; the port's plain version keeps f32);
- `shard_model` refuses a MegaDecodeLM.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mllm_tpu.utils.native as jnative
from mllm_tpu.core.config import TextConfig as JaxTextConfig
from mllm_tpu.models.transformer import CausalLM as JaxCausalLM
from mllm_tpu.ops import fused_mlp as jfm
from mllm_tpu.ops import quant_matmul as jqm
from mllm_tpu_torch.core.config import TextConfig
from mllm_tpu_torch.models.bridge import causal_lm_from_jax_params
from mllm_tpu_torch.nn.layers import Int4Linear
from mllm_tpu_torch.ops import quant_matmul as tqm
from mllm_tpu_torch.ops.fused_mlp import (dequant_down_blockplanar, fit_block_f, fused_int4_mlp_ref,
                                          fused_mlp_plan, pick_block_f)
from mllm_tpu_torch.ops.quantize_model import FusedInt4MLP, Int4Operands, fused_mlp_shard, quantize_model
from mllm_tpu_torch.parallel.heads import pad_heads_for_tp

CPU = torch.device("cpu")
TOL = 1e-5


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _operands(rng, n, k, affine):
    """Canonical operands (numpy) of a random weight [n, k], from the JAX
    package's packers; affine: raw nibbles, scales and zeros (pad rows zero)."""
    w = rng.standard_normal((n, k)).astype(np.float32)
    p, s, z = jqm.prepare_int4(*jqm.repack_float_to_int4(w, 32), 32)
    if not affine:
        return p, s, None
    live = s != 0
    p = (rng.integers(0, 256, p.shape) * (np.arange(p.shape[0])[:, None] < k // 2)).astype(np.uint8)
    return p, (rng.uniform(0.001, 0.02, s.shape) * live).astype(np.float32), \
        (rng.standard_normal(s.shape) * 0.05 * live).astype(np.float32)


def _jax_dequant(p, s, z, k):
    return np.asarray(jqm.dequant_int4_canonical(jnp.asarray(p), jnp.asarray(s), None if z is None else
                                                 jnp.asarray(z), 32, k))


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(autouse=True)
def numpy_packers(monkeypatch):
    """The JAX package's numpy packers (its native one multiplies by a
    reciprocal where numpy divides)."""
    monkeypatch.setattr(jnative, "repack_int8", lambda w: None)
    monkeypatch.setattr(jnative, "repack_int4", lambda w, group=32: None)


@pytest.mark.parametrize("boundary", [True, False], ids=["on_pad_boundary", "padded"])
@pytest.mark.parametrize("affine", [False, True], ids=["symmetric", "affine"])
@pytest.mark.parametrize("tp", [2, 4])
def test_int4_cuts_are_slices_of_the_whole(tp, affine, boundary):
    """K / tp = 512 (K/2 a whole block of 256 rows: no pad rows) or 384
    (192 packed rows padded to 256); N = 96 over tp."""
    k, n = (512 if boundary else 384) * tp, 96
    rng = np.random.default_rng(tp * 4 + 2 * affine + boundary)
    p, s, z = _operands(rng, n, k, affine)
    whole = _jax_dequant(p, s, z, k)
    kr, nr = k // tp, n // tp
    for r in range(tp):
        rows = tqm.int4_take_k(_t(p), _t(s), _t(z), 32, k, np.arange(r * kr, (r + 1) * kr))
        assert rows[0].shape[0] == (kr // 2 if boundary else 256)  # prepare_int4's padding of K/tp
        assert (rows[2] is None) == (not affine)
        got = tqm.dequant_int4_canonical(*rows, 32, kr).numpy()
        assert np.array_equal(got.view(np.uint32), whole[r * kr:(r + 1) * kr].view(np.uint32))
        cols = tqm.int4_take_n(_t(p), _t(s), _t(z), np.arange(r * nr, (r + 1) * nr))
        got = tqm.dequant_int4_canonical(*cols, 32, k).numpy()
        assert np.array_equal(got.view(np.uint32), whole[:, r * nr:(r + 1) * nr].view(np.uint32))


def test_int4_take_k_refuses_a_split_group():
    p, s, z = _operands(np.random.default_rng(0), 32, 256, False)
    with pytest.raises(ValueError, match="whole groups"):
        tqm.int4_take_k(_t(p), _t(s), None, 32, 256, np.arange(16, 16 + 128))
    with pytest.raises(ValueError, match="multiple of 64"):
        tqm.int4_take_k(_t(p), _t(s), None, 32, 256, np.arange(0, 96))


def _fused_mlp(rng, d, ff, affine, block_f):
    """A FusedInt4MLP (and its numpy down operands) of random weights."""
    gate, up = (_operands(rng, ff, d, affine) for _ in range(2))
    wd = rng.standard_normal((d, ff)).astype(np.float32)
    dp, ds = jqm.repack_float_to_int4(wd, 32)
    if affine:
        dp = rng.integers(0, 256, dp.shape).astype(np.uint8)
        ds = rng.uniform(0.001, 0.02, ds.shape).astype(np.float32)
        dz = (rng.standard_normal(ds.shape) * 0.05).astype(np.float32)
        down = tuple(np.asarray(t) for t in jfm.prepare_int4_ff(jnp.asarray(dp), jnp.asarray(ds), jnp.asarray(dz),
                                                                 block_f))
    else:
        down = tuple(np.asarray(t) for t in jfm.prepare_int4_ff(jnp.asarray(dp), jnp.asarray(ds), None, block_f))
        down = (down[0], down[1], None)
    mlp = FusedInt4MLP(*(Int4Operands(*map(_t, ops)) for ops in (gate, up, down)), "silu", block_f)
    return mlp, down


@pytest.mark.parametrize("affine", [False, True], ids=["symmetric", "affine"])
@pytest.mark.parametrize("tp", [2, 4])
def test_fused_mlp_shard_partials_sum_to_the_whole(tp, affine):
    """d 128, ff 1280 (block 1280 whole; 640 / 320 a rank at tp 2 / 4)."""
    d, ff = 128, 1280
    rng = np.random.default_rng(10 + tp + affine)
    mlp, down = _fused_mlp(rng, d, ff, affine, pick_block_f(ff))
    whole_down = np.asarray(jfm._dequant_down_blockplanar(*(None if t is None else jnp.asarray(t) for t in down),
                                                          32, mlp.block_f))
    x = torch.from_numpy(rng.standard_normal((3, d)).astype(np.float32))
    whole = fused_int4_mlp_ref(x, mlp.gate_ops.astuple(), mlp.up_ops.astuple(), mlp.down_ops.astuple(),
                               block_f=mlp.block_f)
    fr, acc = ff // tp, torch.zeros_like(whole)
    for r in range(tp):
        m = fused_mlp_shard(mlp, r, tp)
        assert m.block_f == fit_block_f(fr) and m.bias is None
        got = dequant_down_blockplanar(*m.down_ops.astuple(), 32, m.block_f).numpy()
        assert np.array_equal(got.view(np.uint32), whole_down[r * fr:(r + 1) * fr].view(np.uint32))
        acc += fused_int4_mlp_ref(x, m.gate_ops.astuple(), m.up_ops.astuple(), m.down_ops.astuple(),
                                  block_f=m.block_f)
    assert _rel(acc, whole) < TOL


@pytest.mark.parametrize("tp,block_f", [(2, 896), (4, 448)])
def test_qwen2vl_rank_mlp_stays_fused(tp, block_f):
    """Qwen2-VL-2B (d 1536, ff 8960): F / tp = 4480 / 2240 has no divisor
    that is a multiple of 256 (the Pallas kernel's `pick_block_f`), so the
    rank takes the CUDA kernel's own rule; the kernel's plan exists for it
    at decode batches on an H100's grid (132 SMs, 1 or 2 blocks an SM)."""
    ff = 8960 // tp
    assert pick_block_f(ff) is None and fit_block_f(ff) == block_f
    for m, grid in ((1, 264), (8, 264), (32, 132)):
        mt8, sa, rows_a, sb, rows_b = fused_mlp_plan(m, 1536, ff, 1536, block_f, grid)
        assert sb * rows_b >= ff // 2 and sa * rows_a >= 1536 // 2


def test_fused_mlp_shard_raises_without_a_block():
    """ff 1152 at tp 4: 288 units a rank, which no multiple of 64 divides."""
    mlp, _ = _fused_mlp(np.random.default_rng(3), 64, 1152, False, 1152)
    with pytest.raises(ValueError, match="no block"):
        fused_mlp_shard(mlp, 0, 4)


PAD_INT4 = dict(vocab_size=128, hidden_size=192, intermediate_size=256, num_hidden_layers=2, num_attention_heads=6,
                num_key_value_heads=2, head_dim=32, max_position_embeddings=128, eos_token_id=-3)
PAD_JAX = dict(vocab_size=128, hidden_size=96, intermediate_size=128, num_hidden_layers=2, num_attention_heads=6,
               num_key_value_heads=2, max_position_embeddings=128, eos_token_id=-3)  # test_pad_heads_int4_xla's


JAX_BF16_TOL = 1e-2  # the JAX n-axis int4 product in bf16 against the port's f32 plain version


@pytest.mark.parametrize("geometry", ["int4_heads", "jax_test"])
def test_pad_heads_int4_is_exact(geometry, monkeypatch):
    """6 q / 2 kv heads padded for tp 8 (8 / 8: two zero q heads). int4_heads:
    head_dim 32, so q/k/v/o are all int4 and o_proj's inputs are re-laid;
    jax_test: the JAX test's geometry (head_dim 16, only down_proj int4 on
    both sides), also against the JAX package's padded model."""
    from mllm_tpu.ops.quantize_model import quantize_model as jax_quantize
    from mllm_tpu.parallel.heads import pad_heads_for_tp as jax_pad

    kw = PAD_INT4 if geometry == "int4_heads" else PAD_JAX
    jm = JaxCausalLM.init(jax.random.PRNGKey(1), JaxTextConfig(**kw))
    port = causal_lm_from_jax_params({k: np.asarray(v) for k, v in jm.parameters().items()}, TextConfig(**kw), CPU)
    q = quantize_model(port, "int4", min_size=1, quant_embed_head=False)
    padded = pad_heads_for_tp(q, 8)
    assert (padded.cfg.num_attention_heads, padded.cfg.num_key_value_heads) == (8, 8)
    o = padded.blocks[0].attn.o_proj
    assert isinstance(o, Int4Linear) == (geometry == "int4_heads")
    ids = np.random.default_rng(5).integers(0, 128, (1, 9))
    with torch.no_grad():
        lref = q(torch.from_numpy(ids), q.init_cache(1, 32, torch.float32), last_only=False)[0]
        lpad = padded(torch.from_numpy(ids), padded.init_cache(1, 32, torch.float32), last_only=False)[0]
    assert _rel(lpad, lref) < TOL
    if geometry == "jax_test":
        monkeypatch.setenv("MLLM_INT4_IMPL", "xla")
        jq = jax_pad(jax_quantize(jm, "int4", min_size=1, quant_embed_head=False), 8)
        want = jax.jit(lambda m, x, c: m(x, c, last_only=False))(jq, jnp.asarray(ids, jnp.int32),
                                                                  jq.init_cache(1, 32, jnp.float32))[0]
        assert _rel(lpad, want) < JAX_BF16_TOL


def test_shard_model_refuses_the_megakernel_model():
    """A MegaDecodeLM (one kernel for the whole trunk) is not cut over tp,
    as the JAX package does not cut it: shard_model raises before it reads
    the mesh."""
    from mllm_tpu_torch.models.megadecode import MegaDecodeLM
    from mllm_tpu_torch.models.transformer import CausalLM
    from mllm_tpu_torch.parallel.sharding import shard_model

    cfg = TextConfig(vocab_size=256, hidden_size=256, intermediate_size=512, num_hidden_layers=1,
                     num_attention_heads=2, num_key_value_heads=1, head_dim=128, max_position_embeddings=64)
    mega = MegaDecodeLM.from_float(CausalLM.init(cfg, device=CPU, dtype=torch.float32,
                                                 generator=torch.Generator().manual_seed(0)))
    with pytest.raises(NotImplementedError, match="MegaDecodeLM"):
        shard_model(mega, None)
