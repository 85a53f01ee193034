"""MegaDecodeLM: a CausalLM whose decode step runs the whole-trunk int4
megakernel (`ops/decode_step.py`): one launch for all L decoder layers.

Counterpart of `mllm_tpu/models/megadecode.py`. A decode step of b <= 32
sequences on a dense `KVCache` is an embedding gather, one megakernel launch
(`fused_decode_step` at b = 1, `fused_decode_step_batched` above; over the serving
engine's `SlotKVCache` always the batched one, each slot at its own position),
the write of the new K/V into the cache, the final norm and the int4 head. Prefill,
left-padded (ragged) batches and everything else go through `base`, an int4
CausalLM built from the SAME quantized values the kernel streams; it is also
the kernel's oracle in the tests.

The device of the tensors picks kernel or plain version (there is no TPU-style
gate): on the CPU the megakernel's plain version runs.

Unlike the JAX `from_float`, the port's works IN PLACE, like `quantize_model`:
the float model becomes `base` (its blocks' projections are replaced by int4
layers) and is released layer by layer.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import TextConfig
from ..kv.cache import KVCache, SlotKVCache
from ..nn.layers import Embedding, Int4Linear, Linear
from ..ops import quant_matmul as qm
from ..ops.decode_step import fused_decode_step, fused_decode_step_batched, rope_rotation_matrix
from ..ops.fused_mlp import _ACT, pick_block_f, prepare_int4_ff
from ..ops.quantize_model import FusedInt4MLP, Int4EmbedHead, Int4Operands, _q4_device
from .transformer import MLP, CausalLM, in_dtype

GROUP_A = 128  # quant group of qkv/o/gate/up (AWQ's); down keeps the int4 kernels' 32
BLOCK_F_CAP = 1280  # largest ff slab of the block-planar down layout (1280 at ff 8960)


def _supported(cfg: TextConfig, blk) -> Optional[str]:
    """None if the megakernel covers this model, else the reason."""
    if cfg.head_dim_ != 128:
        return f"head_dim {cfg.head_dim_} != 128"
    if cfg.hidden_size % 256 or (cfg.num_attention_heads * 128) % 256:
        return "hidden/q width not a 256 multiple"
    if cfg.hidden_size % 64 or cfg.intermediate_size % 64:
        return "dims not group-aligned"
    if cfg.intermediate_size % 128:  # the CUDA kernel's down product: ff/2 in 64-row chunks
        return "intermediate_size not a 128 multiple"
    if cfg.norm_type != "rmsnorm" or cfg.model_type.startswith("gemma"):
        return "non-RMSNorm / unit-offset norm"
    if cfg.rope_style != "hf" or cfg.rope_partial != 1.0 or cfg.rope_int8:
        return "unsupported rope flavor"
    if cfg.qk_norm or cfg.sliding_window is not None:
        return "qk-norm / sliding window"
    if cfg.attn_logit_softcap or cfg.query_pre_attn_scalar:
        return "softcap / custom attn scale"
    if cfg.hidden_act not in _ACT:
        return f"activation {cfg.hidden_act}"
    if cfg.post_norm:
        return "post-norm blocks"
    mlp = blk.mlp
    if not isinstance(mlp, MLP) or mlp.up_proj is None and mlp.gateup_proj is None:
        return "non-gated MLP"
    # the kernel has no o_proj or MLP bias (the JAX gate lets them through and drops them)
    if cfg.o_proj_bias or cfg.mlp_bias:
        return "o_proj / MLP bias"
    return None


def stack_block_weights(model: CausalLM) -> dict:
    """[L, ...] stacks of the blocks' float weights, fused or split projections
    alike (the JAX `CausalLM.stack` + `_stack_lin_weights`): w_qkv [L, n_qkv, d],
    b_qkv [L, n_qkv] or None, w_o [L, d, n_q], w_gate / w_up [L, ff, d],
    w_down [L, d, ff], norm1 / norm2 [L, d]."""
    per = {k: [] for k in ("w_qkv", "b_qkv", "w_o", "w_gate", "w_up", "w_down", "norm1", "norm2")}
    for blk in model.blocks:
        attn, mlp = blk.attn, blk.mlp
        qkv = [attn.qkv_proj] if attn.qkv_proj is not None else [attn.q_proj, attn.k_proj, attn.v_proj]
        lins = qkv + [attn.o_proj, mlp.down_proj] + ([mlp.gateup_proj] if mlp.gateup_proj is not None
                                                     else [mlp.gate_proj, mlp.up_proj])
        if any(type(lin) is not Linear for lin in lins):
            raise ValueError("the megakernel quantizes a float model: every projection must be a Linear")
        per["w_qkv"].append(torch.cat([lin.weight for lin in qkv]))
        if all(lin.bias is None for lin in qkv):
            per["b_qkv"].append(None)
        else:
            per["b_qkv"].append(torch.cat([lin.bias if lin.bias is not None
                                           else lin.weight.new_zeros(lin.weight.shape[0]) for lin in qkv]))
        per["w_o"].append(attn.o_proj.weight)
        if mlp.gateup_proj is not None:
            gate, up = mlp.gateup_proj.weight.chunk(2)
        else:
            gate, up = mlp.gate_proj.weight, mlp.up_proj.weight
        per["w_gate"].append(gate)
        per["w_up"].append(up)
        per["w_down"].append(mlp.down_proj.weight)
        per["norm1"].append(blk.input_norm.weight)
        per["norm2"].append(blk.post_attn_norm.weight)
    if len({b is None for b in per["b_qkv"]}) > 1:
        raise ValueError("model has non-uniform blocks (cannot stack)")
    return {k: None if v[0] is None else torch.stack(v) for k, v in per.items()}


class _PaddedHead(nn.Module):
    """Untied lm_head padded to a 512-multiple vocab for the int4 kernel."""

    def __init__(self, proj: Int4Linear, vocab: int):
        super().__init__()
        self.proj = proj
        self.vocab = vocab

    def forward(self, x):
        return self.proj(x)[..., : self.vocab]


def _int4_head(w: torch.Tensor, bias) -> Int4Linear:
    """float [V, d] -> Int4Linear over the vocab padded to a 512 multiple, with
    group-32 scales rounded to bf16 (held in f32, which the kernel takes)."""
    v = w.shape[0]
    wp = F.pad(w, (0, 0, 0, -(-v // 512) * 512 - v))
    packed, scales, _ = qm.prepare_int4(*_q4_device(wp), qm.GROUP)
    return Int4Linear(packed.contiguous(), scales.to(torch.bfloat16).float().contiguous(), qm.GROUP,
                      None, bias)


@torch.no_grad()
def _quant_head(model: CausalLM) -> None:
    """The int4 lm_head of the JAX `_quant_head_pallas`, in place: an untied
    Linear head becomes `_PaddedHead`, a tied embedding `Int4EmbedHead`."""
    if model.lm_head is not None:
        if type(model.lm_head) is Linear:
            v = model.lm_head.weight.shape[0]
            model.lm_head = _PaddedHead(_int4_head(model.lm_head.weight, model.lm_head.bias), v)
    elif isinstance(model.embed_tokens, Embedding):
        emb = model.embed_tokens
        model.embed_tokens = Int4EmbedHead(emb, _int4_head(emb.weight, None), emb.weight.shape[0])


class MegaDecodeLM(nn.Module):
    """See the module docstring. Build with `MegaDecodeLM.from_float` (or
    `models.bridge.mega_decode_from_jax`).

    The operand stacks are buffers named like the JAX parameters
    (`qkv_ops.0`, `qkv_ops.1`, `qkv_ops.2` = qkv bias, ..., `norm1_w`):
    packed uint8 planar excess-8, bf16 scales at group `group_a` (qkv, o,
    gate, up) and 32 (down, block-planar over ff in slabs of `block_f`).
    Constructing one rebuilds `base`'s blocks from the stacks: int4 layers
    that hold views of the packed bytes and f32 copies of the bf16 scales,
    each scale row repeated into the group-32 layout of the port's int4
    kernels (the same dequantized weights)."""

    def __init__(self, base: CausalLM, qkv_ops, o_ops, gate_ops, up_ops, down_ops,
                 norm1_w: torch.Tensor, norm2_w: torch.Tensor, block_f: int, group_a: int):
        super().__init__()
        self.qkv_ops = Int4Operands(*qkv_ops)
        self.o_ops = Int4Operands(*o_ops)
        self.gate_ops = Int4Operands(*gate_ops)
        self.up_ops = Int4Operands(*up_ops)
        self.down_ops = Int4Operands(*down_ops)
        self.register_buffer("norm1_w", norm1_w)
        self.register_buffer("norm2_w", norm2_w)
        self.block_f = int(block_f)
        self.group_a = int(group_a)
        self.base = base
        self._attach_base_blocks()

    def _attach_base_blocks(self) -> None:
        rep = self.group_a // qm.GROUP

        def s32(s):
            return s.float().repeat_interleave(rep, dim=-2).contiguous()

        qp, qs, qb = self.qkv_ops.astuple()
        op, os_ = self.o_ops.astuple()[:2]
        gp, gs = self.gate_ops.astuple()[:2]
        up, us = self.up_ops.astuple()[:2]
        dp, ds = self.down_ops.astuple()[:2]
        cfg = self.base.cfg
        for i, blk in enumerate(self.base.blocks):
            attn = blk.attn
            attn.qkv_proj = Int4Linear(qp[i], s32(qs[i]), qm.GROUP, None, None if qb is None else qb[i, 0])
            attn.q_proj = attn.k_proj = attn.v_proj = None
            attn.o_proj = Int4Linear(op[i], s32(os_[i]), qm.GROUP)
            blk.mlp = FusedInt4MLP(Int4Operands(gp[i], s32(gs[i])), Int4Operands(up[i], s32(us[i])),
                                   Int4Operands(dp[i], ds[i].float().contiguous()), cfg.hidden_act,
                                   self.block_f)

    # -- construction --------------------------------------------------------

    @staticmethod
    @torch.no_grad()
    def from_float(model: CausalLM) -> "MegaDecodeLM":
        """Quantize a float CausalLM once, in place, into (a) the megakernel's
        operand stacks and (b) the int4 `base` sharing the same values, with
        the int4 head. Raises ValueError when the config is outside the
        kernel's contract.

        Scales are bf16 (the kernel streams them so); qkv/o/gate/up group at
        GROUP_A, which divides both packed K halves (`_supported` asks for
        256-multiples); down groups at 32, block-planar over slabs of
        `pick_block_f(ff, BLOCK_F_CAP)`, a 256-multiple."""
        cfg = model.cfg
        why = _supported(cfg, model.blocks[0])
        if why is not None:
            raise ValueError(f"megakernel unsupported: {why}")
        block_f = pick_block_f(cfg.intermediate_size, cap=BLOCK_F_CAP)
        if block_f is None:
            raise ValueError("no ff block size divides intermediate_size")
        w = stack_block_weights(model)

        def q4_e8(name):  # float [L, N, K] -> (packed_e8 [L, K/2, N], bf16 scales [L, K/G, N])
            p, s = _q4_device(w.pop(name), GROUP_A)
            return p ^ 0x88, s.to(torch.bfloat16)

        qkv, o, gate, up = (q4_e8(n) for n in ("w_qkv", "w_o", "w_gate", "w_up"))
        d_p, d_s, _ = prepare_int4_ff(*_q4_device(w.pop("w_down")), None, block_f)
        b_qkv = None if w["b_qkv"] is None else w["b_qkv"][:, None, :].float()
        norm1, norm2 = (w[k][:, None, :].float() for k in ("norm1", "norm2"))
        _quant_head(model)
        return MegaDecodeLM(model, (*qkv, b_qkv), o, gate, up, (d_p.contiguous(), d_s.to(torch.bfloat16)),
                            norm1.contiguous(), norm2.contiguous(), block_f, GROUP_A)

    # -- CausalLM surface (everything but the one-token decode goes to base) ---

    @property
    def cfg(self) -> TextConfig:
        return self.base.cfg

    @property
    def rope(self):
        return self.base.rope

    @property
    def embed_tokens(self):
        return self.base.embed_tokens

    @property
    def lm_head(self):
        return self.base.lm_head

    @property
    def norm(self):
        return self.base.norm

    @property
    def device(self) -> torch.device:
        return self.base.device

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16, kv_dtype: str = "bf16"):
        return self.base.init_cache(batch, max_len, dtype, kv_dtype)

    def hidden_states(self, *a, **k):
        return self.base.hidden_states(*a, **k)

    def logits(self, hidden):
        return self.base.logits(hidden)

    def _mega_eligible(self, input_ids, cache, inputs_embeds, pad_lens) -> bool:
        # SlotKVCache: the serving engine's per-slot write heads, which the
        # batched kernel takes natively
        if type(cache) not in (KVCache, SlotKVCache) or pad_lens is not None:
            return False
        shp = inputs_embeds.shape if inputs_embeds is not None else input_ids.shape
        return shp[1] == 1 and 1 <= shp[0] <= 32 and shp[0] == cache.k.shape[1]

    def forward(self, input_ids, cache, last_only: bool = True, inputs_embeds=None, pad_lens=None):
        """(logits [B, 1, V], cache advanced by one) on the megakernel when
        eligible (dense KVCache or SlotKVCache, one token per sequence, B <= 32
        equal to the cache batch, no pad_lens); otherwise `base` runs the call.

        Over a SlotKVCache every slot runs the batched kernel at its own
        position, clamped to the last cache row as `kv/cache._slot_append`
        clamps the append: only idle slots, whose outputs the engine
        discards, reach it."""
        if not self._mega_eligible(input_ids, cache, inputs_embeds, pad_lens):
            return self.base(input_ids, cache, last_only=last_only, inputs_embeds=inputs_embeds,
                             pad_lens=pad_lens)
        cfg = self.cfg
        x = inputs_embeds if inputs_embeds is not None else self.base.embed_tokens(input_ids)
        if cfg.embedding_multiplier != 1.0:
            x = x * in_dtype(cfg.embedding_multiplier, x.dtype)
        pos, b = cache.pos, x.shape[0]
        rope = self.base.rope
        kw = dict(n_heads=cfg.num_attention_heads, n_kv_heads=cfg.num_key_value_heads,
                  head_dim=cfg.head_dim_, act=cfg.hidden_act, eps=cfg.rms_norm_eps,
                  rm=cfg.residual_multiplier, block_f=self.block_f, group_a=self.group_a)
        ops = (self.qkv_ops.astuple(), self.o_ops.astuple()[:2], self.gate_ops.astuple()[:2],
               self.up_ops.astuple()[:2], self.down_ops.astuple()[:2], self.norm1_w, self.norm2_w,
               cache.k, cache.v)
        if pos.dim() == 1:  # SlotKVCache: a device head per slot
            p = pos.clamp(max=cache.max_len - 1)
            pl = p.long()
            y, k_new, v_new = fused_decode_step_batched(x[:, 0], p, rope.sin[pl], rope.cos[pl], *ops, **kw)
            slots = torch.arange(b, device=x.device)
            cache.k[:, slots, :, pl] = k_new.transpose(0, 1).to(cache.k.dtype)
            cache.v[:, slots, :, pl] = v_new.transpose(0, 1).to(cache.v.dtype)
            hidden = self.base.norm(y[:, None].to(x.dtype))
            return self.base.logits(hidden), cache.advance(1)
        # the device head (KVCache): the kernels read it, the rope rows are
        # gathered on the card, and the new row is written there, so the step
        # is the same launches at every position. A head on the CPU is
        # checked; one on the card clamps to the last row, as the append does.
        if pos.device.type == "cpu" and int(pos) + 1 > cache.max_len:
            raise ValueError(f"KV cache overflow: pos {int(pos)} + 1 token > max_len {cache.max_len}")
        p = pos.clamp(max=cache.max_len - 1)
        pl = p.long().reshape(1)
        if b == 1:
            rot = rope_rotation_matrix(rope.sin[pl], rope.cos[pl], cfg.head_dim_)
            y, k_new, v_new = fused_decode_step(x[0], p, rot, *ops, **kw)
            k_new, v_new = k_new[:, None], v_new[:, None]
        else:  # lockstep: every slot at the cache's write head
            sin, cos = rope.sin[pl].expand(b, -1), rope.cos[pl].expand(b, -1)
            y, k_new, v_new = fused_decode_step_batched(x[:, 0], p.expand(b), sin, cos, *ops, **kw)
        cache.k.index_copy_(3, pl, k_new[:, :, :, None].to(cache.k.dtype))
        cache.v.index_copy_(3, pl, v_new[:, :, :, None].to(cache.v.dtype))
        hidden = self.base.norm(y[:, None].to(x.dtype))
        return self.base.logits(hidden), cache.advance(1)
