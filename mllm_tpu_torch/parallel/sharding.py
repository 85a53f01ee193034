"""Tensor and data parallelism over a (dp, tp) `DeviceMesh`: counterpart of
`mllm_tpu/parallel/sharding.py`.

The JAX package lays parameters out with `NamedSharding`s and lets GSPMD
insert the collectives. Here every rank holds its own slices as plain local
tensors (the CUDA kernels take plain tensors; no DTensor), and the
collectives are explicit, Megatron-style (`comm.py`):

  q/k/v/gate/up [out, in]  column parallel: rows split over tp; the input
                           enters through `copy_to_axis` (all-reduce of its
                           gradient)
  o/down        [out, in]  row parallel: columns split over tp; the f32
                           partial products are summed by `reduce_from_axis`,
                           then the bias is added and the sum rounds once
  embedding     [V, D]     vocab parallel: each rank looks up its rows, the
                           partial embeddings are summed
  lm_head       [V, D]     vocab parallel: each rank's logits are all-gathered
  norms, MoE experts, biases of row-parallel layers: replicated

The same cuts hold for the quantized layers: an int8 `QuantLinear` (qweight_t
[in, out], scales [out]) and an int4 `Int4Linear` on the canonical planar
layout (packed_t [khp, out], scales_t / zeros_t [2 khp/G, out]). A column cut
of an `Int4Linear` selects output channels; a row cut takes the rank's K
range [r K/tp, (r+1) K/tp) in natural k order and lays it out anew
(`ops.quant_matmul.int4_take_k`: the range straddles the nibble halves of the
whole), which needs K/tp a multiple of 64 (whole groups in each half; else
the layer stays whole, with the warning). A `FusedInt4MLP` is cut over its
hidden units (`ops.quantize_model.fused_mlp_shard`: gate/up columns, the
block-planar down rows in blocks of `fit_block_f(F/tp)`) and stays one fused
kernel a rank, its f32 partial sum reduced before the bias and the one
rounding; the tied `Int4EmbedHead` is vocab parallel (lookup rows, `proj`
columns of the 512-padded vocab, logits gathered, then sliced). The JAX
package cuts its n-axis int4 twin (`Int4LinearXLA`) instead; the port keeps
one int4 layout. The pure cuts (`column_shard`, `row_shard`,
`fused_mlp_shard`) take (module, rank, tp) and no process group.
  KV cache      [L, B, Hkv, S, D]: batch rows over dp, kv heads over tp
  paged pool    [L, NB + 1, Hkv, BS, D] (the sink block included): kv heads
                over tp; the block table and the write heads whole
  vision tower  (a Qwen2-VL / Qwen2.5-VL `.visual`): whole on every rank,
                as the JAX `param_spec` leaves it (its qkv / proj / fc1 /
                fc2 / gate / up / down names match no rule); the `.lm` is
                cut as a CausalLM

A dim that the axis does not divide stays whole on every rank, with the
"sharding dropped" warning of the JAX package, but attention heads do not:
tp must divide both head counts (run `heads.pad_heads_for_tp` first on a
text model), or `shard_model` raises a ValueError, where the JAX package
fails at the rotary embedding; a shard with 0 heads is never built. The MLP
is cut only when its width divides. The sharded model's `cfg` is this
rank's: its head counts are the local ones (a VL model's `cfg.text`), so
`init_cache` and the engine's caches hold this rank's kv heads.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..nn.layers import Embedding, Int4Linear, Linear, QuantLinear, QuantLinearA8, matmul_f32, shallow_copy
from ..ops.quant_matmul import int4_take_k, int4_take_n
from ..utils.log import log_warn
from .comm import (axis_group, axis_rank, axis_size, check_world, copy_to_axis, dp_mean,
                   gather_from_axis, mesh_device, reduce_from_axis)


def make_mesh(dp: int = 1, tp: int = 1, device=None):
    """A `DeviceMesh` with dims ("dp", "tp") over ranks 0..dp*tp-1 of the
    initialised world, rank = dp_index * tp + tp_index. device: "cuda" (NCCL)
    or "cpu" (gloo); None is the card, and raises without one. On the card it
    raises when fewer GPUs than dp x tp exist (the JAX one falls back to CPU
    devices; this one does not)."""
    from torch.distributed.device_mesh import DeviceMesh

    from ..utils.runtime import default_device

    dev = torch.device(device) if device is not None else default_device()
    check_world(dp * tp, dev)
    return DeviceMesh(dev.type, torch.arange(dp * tp).reshape(dp, tp), mesh_dim_names=("dp", "tp"))


# path regex -> which axis of the weight is split (weights are [out, in])
_COLUMN = re.compile(r"(q_proj|k_proj|v_proj|gate_proj|up_proj|lm_head|qkv_proj)\.weight")
_ROW = re.compile(r"(o_proj|down_proj)\.weight")
_COLUMN_BIAS = re.compile(r"(q_proj|k_proj|v_proj|gate_proj|up_proj|lm_head|qkv_proj)\.bias")
_EMBED = re.compile(r"embed_tokens\.weight")

# the int8 QuantLinear holds qweight_t [in, out] + scales [out] ("out last"),
# so column parallel splits its last axis and row parallel its first (the JAX
# package's leaf specs, kept equal to them). The canonical planar int4 leaves
# (packed_t, scales_t, zeros_t, gate_ops.*) match no rule, as in the JAX
# package, where that layout stays replicated: the port cuts them by module
# in `shard_model` (column_shard / row_shard / fused_mlp_shard), not by spec
_COL_NAMES = r"(q_proj|k_proj|v_proj|gate_proj|up_proj|lm_head)"
_ROW_NAMES = r"(o_proj|down_proj)"
_COLUMN_QLEAF = re.compile(_COL_NAMES + r"\.(qweight_t|packed_n|scales_g|zshift_g)")
_ROW_QLEAF = re.compile(_ROW_NAMES + r"\.(qweight_t|packed_n|scales_g|zshift_g)")
_COLUMN_QSCALE = re.compile(_COL_NAMES + r"\.scales$")


def param_spec(path: str, ndim: int) -> tuple:
    """Which axis of a parameter is split over "tp", as a tuple of one entry
    per dim ("tp" or None; () for replicated), the JAX PartitionSpec's
    entries. The same regexes as the JAX package."""
    if _EMBED.search(path) or _COLUMN.search(path):
        spec = ("tp", None)
    elif _ROW.search(path):
        spec = (None, "tp")
    elif _COLUMN_QLEAF.search(path):
        spec = (None, "tp")
    elif _ROW_QLEAF.search(path):
        spec = ("tp", None)
    elif _COLUMN_BIAS.search(path) or _COLUMN_QSCALE.search(path):
        spec = ("tp",)
    else:
        return ()
    if ndim == len(spec) + 1:  # a leading layer axis
        spec = (None, *spec)
    return spec


def _divides(mesh, axis: str, size: int, path: str, dim: int, quantum: int = 1) -> bool:
    """True when `axis` divides `size` into parts that are multiples of
    `quantum`; otherwise warn as the JAX package's `_validate_spec` does (the
    dim stays whole)."""
    n = axis_size(mesh, axis)
    if size % (n * quantum) == 0:
        return True
    log_warn("sharding dropped: dim not divisible by mesh axis", param=path or "<anon>", dim=dim,
             size=int(size), axis=axis, axis_size=int(n), quantum=quantum)
    return False


# ---------------------------------------------------------------------------
# Tensor-parallel layers
# ---------------------------------------------------------------------------


def column_shard(lin, ranges):
    """A Linear / QuantLinear / Int4Linear holding the output channels in
    `ranges` (a list of (start, stop)), in that order."""
    idx = torch.cat([torch.arange(a, b) for a, b in ranges])
    if type(lin) is Linear:
        w = lin.weight.detach()[idx.to(lin.weight.device)].contiguous()
        b = None if lin.bias is None else lin.bias.detach()[idx.to(lin.bias.device)].contiguous()
        return Linear.from_tensors(w, b)
    if isinstance(lin, QuantLinear):
        i = idx.to(lin.qweight_t.device)
        return type(lin)(lin.qweight_t[:, i].contiguous(), lin.scales[i].contiguous(),
                         None if lin.bias is None else lin.bias[i].contiguous())
    if isinstance(lin, Int4Linear):
        packed, scales, zeros = int4_take_n(lin.packed_t, lin.scales_t, lin.zeros_t, idx.numpy())
        return Int4Linear(packed, scales, lin.group, zeros,
                          None if lin.bias is None else lin.bias[idx.to(lin.bias.device)].contiguous())
    raise NotImplementedError(f"shard_model: cannot split {type(lin).__name__}")


def row_shard(lin, k: int, r: int, tp: int):
    """Rank r of tp's input channels [r K/tp, (r+1) K/tp) of a Linear /
    QuantLinear / Int4Linear over K = k inputs, without its bias (a
    RowParallelLinear adds the whole bias after the sum over the ranks)."""
    kr = k // tp
    if type(lin) is Linear:
        return Linear.from_tensors(lin.weight.detach()[:, r * kr:(r + 1) * kr].contiguous())
    if isinstance(lin, QuantLinear):
        return type(lin)(lin.qweight_t[r * kr:(r + 1) * kr].contiguous(), lin.scales, None)
    if isinstance(lin, Int4Linear):
        packed, scales, zeros = int4_take_k(lin.packed_t, lin.scales_t, lin.zeros_t, lin.group, k,
                                            np.arange(r * kr, (r + 1) * kr))
        return Int4Linear(packed, scales, lin.group, zeros, None)
    raise NotImplementedError(f"shard_model: cannot split {type(lin).__name__}")


def _shardable(lin) -> bool:
    return type(lin) is Linear or isinstance(lin, (QuantLinear, Int4Linear))


def _n_out(lin) -> int:
    if type(lin) is Linear:
        return lin.weight.shape[0]
    return lin.qweight_t.shape[1] if isinstance(lin, QuantLinear) else lin.packed_t.shape[1]


def _k_quantum(lin) -> int:
    """What a rank's K inputs must be a multiple of: 2 x the group for an
    Int4Linear (whole groups in each nibble half), else 1."""
    return 2 * lin.group if isinstance(lin, Int4Linear) else 1


class ColumnParallelLinear(nn.Module):
    """This rank's output channels of a column-parallel projection: the input
    enters through `copy_to_axis` (its gradient is all-reduced over tp);
    with `gather`, the outputs are all-gathered (the vocab-parallel head)."""

    def __init__(self, inner: nn.Module, mesh, gather: bool = False):
        super().__init__()
        self.inner = inner
        self.mesh = mesh
        self.gather = gather

    def forward(self, x):
        y = self.inner(copy_to_axis(x, self.mesh, "tp"))
        return gather_from_axis(y, self.mesh, "tp") if self.gather else y


class RowParallelLinear(nn.Module):
    """This rank's input channels of a row-parallel projection (weight
    [out, in/tp], an int8 qweight_t [in/tp, out] with its scales, or int4
    operands over in/tp): the f32 partial products are all-reduced over tp,
    then the bias (replicated) is added in f32 and the sum rounds once to x's
    dtype, as the unsplit Linear rounds. A QuantLinearA8's prefill-shaped
    calls take `_a8`."""

    def __init__(self, inner: nn.Module, bias: Optional[torch.Tensor], mesh):
        super().__init__()
        self.inner = inner
        self.bias = None if bias is None else nn.Parameter(bias.detach(), requires_grad=False)
        self.mesh = mesh

    def forward(self, x):
        if isinstance(self.inner, QuantLinearA8) and self.inner.takes_a8(x):
            return self._a8(x)
        if isinstance(self.inner, QuantLinear):
            from ..ops.quant_matmul import int8_matmul

            y = int8_matmul(x, self.inner.qweight_t, self.inner.scales)
        elif isinstance(self.inner, Int4Linear):
            from ..ops.quant_matmul import int4_matmul

            y = int4_matmul(x, self.inner.packed_t, self.inner.scales_t, self.inner.group, self.inner.zeros_t)
        else:
            y = matmul_f32(x, self.inner.weight)
        y = reduce_from_axis(y, self.mesh, "tp")
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(x.dtype)

    def _a8(self, x):
        """W8A8 over this rank's input channels, equal bit for bit to the
        unsplit product: each token's amax is max-reduced over tp before x is
        quantized, and the int32 partial products are summed over tp (exact)
        before the scales. Inference only: int8 weights take no gradient."""
        from ..ops.quant_matmul import a8_amax, a8_int_product, a8_quantize, a8_scale

        group = axis_group(self.mesh, "tp")
        k = self.inner.qweight_nk.shape[1]
        amax = a8_amax(x, k)
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        xq, xs = a8_quantize(x, k, amax)
        acc = a8_int_product(xq, self.inner.qweight_nk)
        dist.all_reduce(acc, group=group)
        y = a8_scale(acc, xs, self.inner.scales)
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(x.dtype).reshape(*x.shape[:-1], -1)


def _row_parallel(lin, mesh, k: int):
    return RowParallelLinear(row_shard(lin, k, axis_rank(mesh, "tp"), axis_size(mesh, "tp")), lin.bias, mesh)


class ParallelFusedInt4MLP(nn.Module):
    """This rank's hidden units of a FusedInt4MLP (`fused_mlp_shard`): the
    input enters through `copy_to_axis`, the fused kernel's f32 partial sum
    is all-reduced over tp, then the whole MLP's bias is added in f32 and the
    sum rounds once to x's dtype, as the unsplit FusedInt4MLP rounds."""

    def __init__(self, inner, bias: Optional[torch.Tensor], mesh):
        super().__init__()
        self.inner = inner
        self.register_buffer("bias", bias)
        self.mesh = mesh

    def forward(self, x):
        from ..ops.fused_mlp import fused_int4_mlp

        m = self.inner
        y = fused_int4_mlp(copy_to_axis(x, self.mesh, "tp"), m.gate_ops.astuple(), m.up_ops.astuple(),
                           m.down_ops.astuple(), act=m.act, block_f=m.block_f)
        y = reduce_from_axis(y, self.mesh, "tp")
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(x.dtype)


class VocabParallelEmbedding(nn.Module):
    """This rank's rows [start, start + V/tp) of the embedding table: ids
    outside them look up zeros, and the partial embeddings are summed over
    tp (`reduce_from_axis`). As the tied lm_head, each rank's logits are
    all-gathered."""

    def __init__(self, weight: torch.Tensor, start: int, mesh):
        super().__init__()
        self.weight = nn.Parameter(weight, requires_grad=False)
        self.start = start
        self.mesh = mesh

    def forward(self, ids):
        local = ids - self.start
        inside = (local >= 0) & (local < self.weight.shape[0])
        x = torch.nn.functional.embedding(torch.where(inside, local, 0), self.weight)
        x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
        return reduce_from_axis(x, self.mesh, "tp")

    def as_lm_head(self, x):
        return gather_from_axis(matmul_f32(copy_to_axis(x, self.mesh, "tp"), self.weight), self.mesh, "tp")


class VocabParallelInt4Head(VocabParallelEmbedding):
    """The tied int4 head (`Int4EmbedHead`) over tp: the lookup as
    VocabParallelEmbedding's, on this rank's rows of the float table; as the
    lm_head, this rank's columns of `proj` (the 512-padded vocab over tp),
    the logits all-gathered and sliced to the vocabulary."""

    def __init__(self, weight: torch.Tensor, start: int, proj: Int4Linear, vocab: int, mesh):
        super().__init__(weight, start, mesh)
        self.proj = proj
        self.vocab = vocab

    def as_lm_head(self, x):
        return gather_from_axis(self.proj(copy_to_axis(x, self.mesh, "tp")), self.mesh, "tp")[..., : self.vocab]


def _shard_attention(attn, mesh, path: str):
    """The rank's heads of an attention block (q/k/v column parallel, o row
    parallel, local head counts in its cfg); the block itself when its
    projection types do not allow a cut (a LoRA layer), or, with the
    warning, when an int4 o_proj's K/tp is not a multiple of 64. Raises a
    ValueError, before cutting anything, when tp does not divide both head
    counts."""
    cfg, tp = attn.cfg, axis_size(mesh, "tp")
    h, hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    projs = [attn.qkv_proj] if attn.qkv_proj is not None else [attn.q_proj, attn.k_proj, attn.v_proj]
    if not all(_shardable(p) for p in projs + [attn.o_proj]):
        return attn
    if h % tp or hkv % tp:
        raise ValueError(f"shard_model: {path} has {h} query / {hkv} kv heads, which tp={tp} does not divide "
                         "(a text model: run parallel.heads.pad_heads_for_tp(model, tp) first; a VL model "
                         "needs a tp that divides its heads)")
    if not _divides(mesh, "tp", h * hd, f"{path}.o_proj.weight", 1, _k_quantum(attn.o_proj)):
        return attn
    r = axis_rank(mesh, "tp")
    hl, hkvl = h // tp, hkv // tp
    q_rng = (r * hl * hd, (r + 1) * hl * hd)
    kv_rng = (r * hkvl * hd, (r + 1) * hkvl * hd)
    out = shallow_copy(attn)
    if attn.qkv_proj is not None:  # q || k || v: each part's slice, fused again
        k0, v0 = h * hd, (h + hkv) * hd
        out.qkv_proj = ColumnParallelLinear(column_shard(attn.qkv_proj, [q_rng, (k0 + kv_rng[0], k0 + kv_rng[1]),
                                                                         (v0 + kv_rng[0], v0 + kv_rng[1])]), mesh)
    else:
        out.q_proj = ColumnParallelLinear(column_shard(attn.q_proj, [q_rng]), mesh)
        out.k_proj = ColumnParallelLinear(column_shard(attn.k_proj, [kv_rng]), mesh)
        out.v_proj = ColumnParallelLinear(column_shard(attn.v_proj, [kv_rng]), mesh)
    out.o_proj = _row_parallel(attn.o_proj, mesh, h * hd)
    out.cfg = cfg.replace(num_attention_heads=hl, num_key_value_heads=hkvl, head_dim=hd)
    return out


def _shard_mlp(mlp, mesh, path: str):
    """The rank's slice of a dense gated MLP (gate/up column parallel, down
    row parallel) or of a FusedInt4MLP (`ParallelFusedInt4MLP`); any other
    FFN (MoE) stays whole, and so does an MLP whose width the cut does not
    divide (with the warning)."""
    from ..models.transformer import MLP
    from ..ops.quantize_model import FusedInt4MLP, fused_mlp_shard

    tp, r = axis_size(mesh, "tp"), axis_rank(mesh, "tp")
    if isinstance(mlp, FusedInt4MLP):
        ff = mlp.gate_ops.astuple()[0].shape[1]
        if not _divides(mesh, "tp", ff, f"{path}.gate_ops.0", 1):
            return mlp
        return ParallelFusedInt4MLP(fused_mlp_shard(mlp, r, tp), mlp.bias, mesh)
    if type(mlp) is not MLP:
        return mlp
    projs = ([mlp.gateup_proj] if mlp.gateup_proj is not None
             else [p for p in (mlp.gate_proj, mlp.up_proj) if p is not None])
    if not all(_shardable(p) for p in projs + [mlp.down_proj]):
        return mlp
    ff = _n_out(projs[0]) // (2 if mlp.gateup_proj is not None else 1)
    if not _divides(mesh, "tp", ff, f"{path}.down_proj.weight", 1, _k_quantum(mlp.down_proj)):
        return mlp
    rng = (r * ff // tp, (r + 1) * ff // tp)
    out = shallow_copy(mlp)
    if mlp.gateup_proj is not None:
        out.gateup_proj = ColumnParallelLinear(column_shard(mlp.gateup_proj, [rng, (ff + rng[0], ff + rng[1])]),
                                               mesh)
    else:
        out.gate_proj = ColumnParallelLinear(column_shard(mlp.gate_proj, [rng]), mesh)
        if mlp.up_proj is not None:
            out.up_proj = ColumnParallelLinear(column_shard(mlp.up_proj, [rng]), mesh)
    out.down_proj = _row_parallel(mlp.down_proj, mesh, ff)
    return out


def shard_model(model, mesh):
    """This rank's shard of a CausalLM, or of a Qwen2-VL / Qwen2.5-VL model
    (its `.lm` cut, its `.visual` whole), under `mesh` (module and tensor
    layout above); the tensors it does not cut are shared with `model`. The
    result keeps the mesh as `.mesh` (sgd_train_step's dp mean reads it).
    A MegaDecodeLM raises: its megakernel runs the whole trunk on one card,
    and the JAX package does not cut it either."""
    from ..models.megadecode import MegaDecodeLM
    from ..ops.quantize_model import Int4EmbedHead

    if isinstance(model, MegaDecodeLM):
        raise NotImplementedError("shard_model: a MegaDecodeLM runs its whole trunk in one kernel on one card and "
                                  "is not cut over tp (nor is it in the JAX package); shard its int4 model, "
                                  "`.base`, instead")
    if hasattr(model, "visual") and hasattr(model, "lm"):
        out = shallow_copy(model)
        out.lm = shard_model(model.lm, mesh)
        out.cfg = dataclasses.replace(model.cfg, text=out.lm.cfg)
        out.mesh = mesh
        return out
    tp = axis_size(mesh, "tp")
    out = shallow_copy(model)
    out.mesh = mesh
    r = axis_rank(mesh, "tp")
    emb = model.embed_tokens
    table = emb.embedding if isinstance(emb, Int4EmbedHead) else emb
    if type(table) is Embedding and _divides(mesh, "tp", table.weight.shape[0], "embed_tokens.weight", 0):
        v = table.weight.shape[0] // tp
        rows = table.weight.detach()[r * v:(r + 1) * v].contiguous()
        if type(emb) is Embedding:
            out.embed_tokens = VocabParallelEmbedding(rows, r * v, mesh)
        elif _divides(mesh, "tp", _n_out(emb.proj), "embed_tokens.proj.packed_t", 1):
            vp = _n_out(emb.proj) // tp
            out.embed_tokens = VocabParallelInt4Head(rows, r * v, column_shard(emb.proj, [(r * vp, (r + 1) * vp)]),
                                                     emb.vocab, mesh)
    head = model.lm_head
    if head is not None and _shardable(head):
        n = _n_out(head)
        if _divides(mesh, "tp", n, "lm_head.weight", 0):
            out.lm_head = ColumnParallelLinear(column_shard(head, [(r * n // tp, (r + 1) * n // tp)]), mesh,
                                               gather=True)
    blocks = []
    for i, blk in enumerate(model.blocks):
        b2 = shallow_copy(blk)
        b2.attn = _shard_attention(blk.attn, mesh, f"blocks.{i}.attn")
        b2.mlp = _shard_mlp(blk.mlp, mesh, f"blocks.{i}.mlp")
        blocks.append(b2)
    out.blocks = nn.ModuleList(blocks)
    a0 = blocks[0].attn.cfg if blocks else model.cfg
    out.cfg = model.cfg.replace(num_attention_heads=a0.num_attention_heads,
                                num_key_value_heads=a0.num_key_value_heads, head_dim=model.cfg.head_dim_)
    return out


def _cut(t: torch.Tensor, dim: int, n: int, r: int) -> torch.Tensor:
    k = t.shape[dim] // n
    return t.narrow(dim, r * k, k).contiguous()


def _cache_cuts(tensors, mesh, batch: bool):
    """Storage tensors of a full-size cache cut to this rank: kv heads (axis
    2) over tp, and with `batch` the rows (axis 1) over dp."""
    tp, dp = axis_size(mesh, "tp"), axis_size(mesh, "dp")
    out = []
    for t in tensors:
        if _divides(mesh, "tp", t.shape[2], "kv_cache", 2):
            t = _cut(t, 2, tp, axis_rank(mesh, "tp"))
        if batch and _divides(mesh, "dp", t.shape[1], "kv_cache", 1):
            t = _cut(t, 1, dp, axis_rank(mesh, "dp"))
        out.append(t)
    return out


def shard_cache(cache, mesh):
    """This rank's part of a full-size dense or quantized KVCache (built from
    the unsharded model): its batch rows over dp, its kv heads over tp; the
    write head is shared."""
    from ..kv.cache import KVCache, QuantKVCache, storage

    parts = _cache_cuts(storage(cache), mesh, batch=True)
    if isinstance(cache, QuantKVCache):
        return type(cache)(*parts, cache.pos)
    if type(cache) is KVCache:
        return KVCache(*parts, cache.pos)
    raise NotImplementedError(f"shard_cache: {type(cache).__name__}")


def shard_slot_cache(cache, mesh):
    """A SlotKVCache, SlotQuantKVCache or PagedKVCache (full size) cut to
    this rank's kv heads over tp (the JAX `shard_slot_cache`): every slot,
    the per-slot write heads whole; of the paged pool every block, the sink
    included, with the block table (device and host copies) whole."""
    from ..kv.cache import PagedKVCache, SlotKVCache, SlotQuantKVCache, storage

    if isinstance(cache, PagedKVCache):
        k, v = _cache_cuts([cache.k_store, cache.v_store], mesh, batch=False)
        return PagedKVCache(k, v, cache.table, cache.pos, cache.table_host)
    parts = _cache_cuts(storage(cache), mesh, batch=False)
    if isinstance(cache, SlotQuantKVCache):
        return SlotQuantKVCache(*parts, cache.pos, bits=cache.bits)
    if type(cache) is SlotKVCache:
        return SlotKVCache(*parts, cache.pos)
    raise NotImplementedError(f"shard_slot_cache: {type(cache).__name__}")


def shard_batch(x, mesh):
    """This rank's rows of a global batch (split over dp; whole, with the
    warning, when dp does not divide them), on the mesh's device."""
    x = torch.as_tensor(x)
    if _divides(mesh, "dp", x.shape[0], "batch", 0):
        x = _cut(x, 0, axis_size(mesh, "dp"), axis_rank(mesh, "dp"))
    return x.to(mesh_device(mesh))


# ---------------------------------------------------------------------------
# Step functions
# ---------------------------------------------------------------------------


def sgd_train_step(model, batch_ids, batch_targets, lr: float = 1e-3):
    """One training step: cross-entropy loss, gradients of every float
    parameter, SGD update p - lr * g (g cast to p's dtype). On a sharded
    model the tp collectives run inside the forward and backward; the
    gradients (and the loss) are averaged over dp here, as GSPMD's psum does
    in the JAX package. Updates the model in place and returns (model,
    loss), the loss the global batch's mean."""
    params = [p for p in model.parameters() if p.is_floating_point()]
    was = [p.requires_grad for p in params]
    try:
        for p in params:
            p.requires_grad_(True)
        loss = model.loss(batch_ids, batch_targets)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    finally:
        for p, w in zip(params, was):
            p.requires_grad_(w)
    with torch.no_grad():
        grads, loss = dp_mean(model, params, grads, loss.detach())
        for p, g in zip(params, grads):
            if g is not None:
                p.sub_(g.to(p.dtype) * lr)
    return model, loss


def sharded_forward(model, input_ids, cache):
    """Sharded inference forward (prefill or decode by the length of ids)."""
    return model(input_ids, cache, last_only=True)


def _greedy_eager(model, ids: torch.Tensor, cache, steps: int, eos_token_id: int) -> torch.Tensor:
    """The JAX sharded_generate loop, eagerly: prefill, then one token a
    step for every row until all rows hit eos; -1 after a row's eos."""
    b = ids.shape[0]
    logits, cache = model(ids, cache, last_only=True)
    tok = logits[:, -1].argmax(-1)
    tokens = torch.full((b, steps), -1, dtype=torch.long, device=ids.device)
    tokens[:, 0] = tok
    done = tok == eos_token_id
    for i in range(1, steps):
        if bool(done.all()):
            break
        logits, cache = model(tok[:, None], cache, last_only=True)
        nxt = torch.where(done, -1, logits[:, -1].argmax(-1))
        tokens[:, i] = nxt
        done = done | (nxt == eos_token_id)
        tok = nxt.clamp_min(0)
    return tokens


@torch.no_grad()
def sharded_generate(model, input_ids, mesh, max_new_tokens: int, max_len: int, eos_token_id: int = -1,
                     cache_dtype=torch.float32):
    """Greedy generation of a CausalLM under a (dp, tp) mesh: heads padded
    for tp (`pad_heads_for_tp`), the model and the batch sharded, prefill and
    the decode loop over this rank's kv heads. Under NCCL each of the rank's
    rows runs `generate_compiled` (the decode loop replayed as CUDA graphs,
    the tp collectives captured in them); under gloo, which no graph can
    capture, the loop runs eagerly on all of the rank's rows at once. The
    rows are all-gathered over dp. Returns tokens [B, max_new_tokens] int64,
    -1 after a row's eos, on every rank."""
    from .heads import pad_heads_for_tp

    model = shard_model(pad_heads_for_tp(model, axis_size(mesh, "tp")), mesh)
    dev = mesh_device(mesh)
    ids = shard_batch(np.asarray(input_ids, np.int64), mesh)
    b = ids.shape[0]
    if dev.type == "cuda":
        from ..generation.generate import generate_compiled

        rows = []
        for i in range(b):
            cache = model.init_cache(1, max_len, cache_dtype)
            toks, _ = generate_compiled(model, ids[i:i + 1], cache, ids.shape[1], max_new_tokens,
                                        eos_token_id=eos_token_id)
            rows.append(toks.to(torch.long))
        tokens = torch.stack(rows)
    else:
        tokens = _greedy_eager(model, ids, model.init_cache(b, max_len, cache_dtype), max_new_tokens,
                               eos_token_id)
    dp = axis_size(mesh, "dp")
    if dp > 1 and tokens.shape[0] * dp == np.asarray(input_ids).shape[0]:
        parts = [torch.empty_like(tokens) for _ in range(dp)]
        dist.all_gather(parts, tokens, group=axis_group(mesh, "dp"))
        tokens = torch.cat(parts)
    return tokens
