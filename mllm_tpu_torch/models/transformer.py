"""Decoder-only transformer: counterpart of `mllm_tpu/models/transformer.py`
for the text families (qwen2, qwen3, llama, mistral, gemma, gemma2,
stablelm, phi3, phonelm, minicpm, and the MoE families, whose blocks hold a
`models.moe.MoEMLP`).

Module and attribute names match the JAX package (`embed_tokens`,
`blocks[i].attn.q_proj`, `input_norm`, `post_attn_norm`, `mlp.gate_proj`,
`norm`, `lm_head`), so the state-dict keys read like `Module.parameters()`
names there, with `blocks.{i}` in place of `blocks.mods.{i}`.

`ops.quantize_model.fuse_projections` sets `attn.qkv_proj` (q||k||v) and
`mlp.gateup_proj` (gate||up) in place of the split projections, as in the
JAX package; `quantize_model` then swaps Linears for quantized layers.

`CausalLM.loss` is the training path: the cacheless trunk (each block under
`torch.utils.checkpoint` with `remat=True`; with `ring=(mesh, axis[,
"ulysses"])` sequence-parallel attention from `parallel/`), f32 logits and
the mean next-token cross-entropy. The JAX package's leaf-stacked blocks are
not a layout here: `torch.nn.ModuleList` holds the blocks, and the bridge
unstacks stacked JAX parameters.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint
from torch import nn

from ..core.config import TextConfig
from ..kv.cache import KVCache, Quant4KVCache, QuantKVCache, valid_len
from ..nn.attention import attend, attend_from_cache
from ..nn.layers import (ACT_FN, Embedding, IRotaryEmbedding, LayerNorm, Linear, RMSNorm,
                         RotaryEmbedding)


def check_supported(cfg: TextConfig) -> None:
    """Raise NotImplementedError for config features the port lacks."""
    if cfg.hidden_act not in ACT_FN:
        raise NotImplementedError(f"activation {cfg.hidden_act} is not one of ACT_FN's "
                                  "(the JAX package's table, copied whole)")
    if cfg.norm_type not in ("rmsnorm", "layernorm"):
        raise NotImplementedError(f"mllm_tpu_torch does not port norm_type={cfg.norm_type}")


def make_norm(cfg: TextConfig, dim: int, *, device, dtype):
    """LayerNorm (with bias) for norm_type "layernorm", else RMSNorm, with
    Gemma's unit offset for the gemma types (JAX `_make_norm`)."""
    if cfg.norm_type == "layernorm":
        return LayerNorm(dim, cfg.rms_norm_eps, device=device, dtype=dtype)
    return RMSNorm(dim, cfg.rms_norm_eps, add_unit_offset=cfg.model_type.startswith("gemma"),
                   device=device, dtype=dtype)


class Attention(nn.Module):
    """GQA attention with RoPE, optional QK-norm and the dense KV cache."""

    def __init__(self, cfg: TextConfig, layer_idx: int, *, device, dtype):
        super().__init__()
        h, hkv, hd, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_, cfg.hidden_size
        kw = dict(device=device, dtype=dtype)
        self.q_proj = Linear(d, h * hd, cfg.attention_bias, **kw)
        self.k_proj = Linear(d, hkv * hd, cfg.attention_bias, **kw)
        self.v_proj = Linear(d, hkv * hd, cfg.attention_bias, **kw)
        self.o_proj = Linear(h * hd, d, cfg.o_proj_bias, **kw)
        self.q_norm = RMSNorm(hd, cfg.rms_norm_eps, **kw) if cfg.qk_norm else None
        self.k_norm = RMSNorm(hd, cfg.rms_norm_eps, **kw) if cfg.qk_norm else None
        self.qkv_proj = None  # fused q||k||v, set by fuse_projections
        self.cfg = cfg
        self.layer_idx = layer_idx

    def _window(self) -> Optional[int]:
        cfg = self.cfg
        if cfg.sliding_window is not None:
            # every `pattern`-th layer is global; pattern == 1 -> all sliding (mistral)
            if cfg.sliding_window_pattern <= 1 or (self.layer_idx + 1) % cfg.sliding_window_pattern != 0:
                return cfg.sliding_window
        return None

    def forward(self, x, rope: RotaryEmbedding, cache: Optional[KVCache], positions, kv_start=None,
                bias=None, causal=True, ring=None):
        """bias/causal: tree speculative decoding passes an additive attention
        bias with causal=False (JAX `Attention.__call__`); it reaches `sdpa`
        through `attention_route`, as the reference sends it to XLA.
        ring: (mesh, axis) or (mesh, axis, "ulysses") on a cacheless call: x
        holds this rank's sequence block, and attention runs over the whole
        sequence by ring attention or by Ulysses' all-to-alls."""
        cfg = self.cfg
        b, s, _ = x.shape
        h, hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
        if self.qkv_proj is not None:  # one product, fewer launches
            qkv = self.qkv_proj(x)
            q = qkv[..., : h * hd].reshape(b, s, h, hd)
            k = qkv[..., h * hd : (h + hkv) * hd].reshape(b, s, hkv, hd)
            v = qkv[..., (h + hkv) * hd :].reshape(b, s, hkv, hd)
        else:
            q = self.q_proj(x).view(b, s, h, hd)
            k = self.k_proj(x).view(b, s, hkv, hd)
            v = self.v_proj(x).view(b, s, hkv, hd)
        if self.q_norm is not None:
            q = self.q_norm(q)
            k = self.k_norm(k)
        q = rope(q, positions)
        k = rope(k, positions)

        scale = cfg.query_pre_attn_scalar**-0.5 if cfg.query_pre_attn_scalar else None
        kw = dict(kv_start=kv_start, causal=causal, window=self._window(), bias=bias, scale=scale,
                  logit_softcap=cfg.attn_logit_softcap)
        if cache is not None:
            cache = cache.update_layer(self.layer_idx, k, v)
            out = attend_from_cache(q, cache, self.layer_idx, q_offset=cache.pos,
                                    kv_valid_len=valid_len(cache, s), **kw)
        elif ring is not None:  # sequence-parallel exact attention
            if bias is not None or self._window() is not None or cfg.attn_logit_softcap is not None:
                raise ValueError("sequence-parallel attention takes plain causal or dense attention only")
            mesh, axis, *mode = ring
            if mode and mode[0] == "ulysses":  # all-to-all head/sequence reshard
                from ..parallel.ulysses import ulysses_attention

                out = ulysses_attention(q, k, v, mesh, axis=axis, causal=causal, scale=scale)
            else:  # K/V blocks rotate around the ring
                from ..parallel.ring_attention import ring_attention

                out = ring_attention(q, k, v, mesh, axis=axis, causal=causal, scale=scale)
        else:  # cacheless (training / scoring) path
            out = attend(q, k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous(),
                         q_offset=0, kv_valid_len=None, **kw)
        return self.o_proj(out.reshape(b, s, h * hd)), cache


class MLP(nn.Module):
    """Gated FFN: down(act(gate(x)) * up(x)); with up_proj None (a checkpoint
    without one) the non-gated down(act(gate(x)))."""

    def __init__(self, cfg: TextConfig, *, device, dtype):
        super().__init__()
        d, i = cfg.hidden_size, cfg.intermediate_size
        kw = dict(device=device, dtype=dtype)
        self.gate_proj = Linear(d, i, cfg.mlp_bias, **kw)
        self.up_proj = Linear(d, i, cfg.mlp_bias, **kw)
        self.down_proj = Linear(i, d, cfg.mlp_bias, **kw)
        self.gateup_proj = None  # fused gate||up, set by fuse_projections
        self.act = cfg.hidden_act

    def forward(self, x):
        if self.gateup_proj is not None:
            gu = self.gateup_proj(x)
            ff = gu.shape[-1] // 2
            return self.down_proj(ACT_FN[self.act](gu[..., :ff]) * gu[..., ff:])
        h = ACT_FN[self.act](self.gate_proj(x))
        if self.up_proj is not None:
            h = h * self.up_proj(x)
        return self.down_proj(h)


def in_dtype(value: float, dtype: torch.dtype) -> float:
    """A Python scalar rounded to `dtype`, as the reference applies its scalar
    multipliers (`jnp.asarray(rm, h.dtype)`): in bf16, 1.4 / sqrt(40) is
    0.22168, not 0.22136. The product of two bf16 values is exact in f32, so
    multiplying a bf16 tensor by the rounded float rounds once, as JAX does."""
    return torch.tensor(value, dtype=dtype).item()


class DecoderBlock(nn.Module):
    def __init__(self, cfg: TextConfig, layer_idx: int, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.hidden_size
        self.input_norm = make_norm(cfg, d, **kw)
        self.attn = Attention(cfg, layer_idx, **kw)
        self.post_attn_norm = make_norm(cfg, d, **kw)
        if cfg.num_experts:
            from .moe import MoEMLP

            self.mlp = MoEMLP(cfg, **kw)
        else:
            self.mlp = MLP(cfg, **kw)
        # gemma2: a norm after attention (before the residual) and after the MLP
        self.pre_ffn_norm = make_norm(cfg, d, **kw) if cfg.post_norm else None
        self.post_ffn_norm = make_norm(cfg, d, **kw) if cfg.post_norm else None
        self.residual_multiplier = cfg.residual_multiplier  # MiniCPM scale_depth/sqrt(L)

    def forward(self, x, rope, cache, positions, kv_start=None, bias=None, causal=True, ring=None):
        rm = self.residual_multiplier
        seq = {} if ring is None else {"ring": ring}  # MLA attention (models/deepseek.py) takes no ring
        h, cache = self.attn(self.input_norm(x), rope, cache, positions, kv_start=kv_start, bias=bias,
                             causal=causal, **seq)
        if self.pre_ffn_norm is not None:
            h = self.pre_ffn_norm(h)
        x = x + (h if rm == 1.0 else h * in_dtype(rm, h.dtype))
        h = self.mlp(self.post_attn_norm(x))
        if self.post_ffn_norm is not None:
            h = self.post_ffn_norm(h)
        x = x + (h if rm == 1.0 else h * in_dtype(rm, h.dtype))
        return x, cache


class CausalLM(nn.Module):
    """Decoder-only LM over the dense KV cache."""

    def __init__(self, cfg: TextConfig, *, device, dtype=torch.float32):
        super().__init__()
        check_supported(cfg)
        kw = dict(device=device, dtype=dtype)
        self.embed_tokens = Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.blocks = nn.ModuleList(
            [DecoderBlock(cfg, i, **kw) for i in range(cfg.num_hidden_layers)])
        self.norm = make_norm(cfg, cfg.hidden_size, **kw)
        self.lm_head = (None if cfg.tie_word_embeddings
                        else Linear(cfg.hidden_size, cfg.vocab_size, False, **kw))
        if cfg.rope_int8:  # the reference's IRoPE (PhoneLM)
            self.rope = IRotaryEmbedding.make(cfg.head_dim_, cfg.max_position_embeddings, cfg.rope_theta,
                                              cfg.rope_style, cfg.rope_partial, device=device)
        else:
            self.rope = RotaryEmbedding.make(
                cfg.head_dim_, cfg.max_position_embeddings, cfg.rope_theta,
                cfg.rope_style, cfg.rope_partial, cfg.rope_scaling_dict(), device=device)
        self.cfg = cfg

    @staticmethod
    def init(cfg: TextConfig, *, device, dtype=torch.float32,
             generator: Optional[torch.Generator] = None) -> "CausalLM":
        """Random weights with the JAX package's init distributions, drawn from
        `generator` (a fresh one seeded with 0 on `device` if None); MoE
        blocks take `MoEMLP.init`'s N(0, 0.02^2) experts and router."""
        from .moe import MoEMLP

        model = CausalLM(cfg, device=device, dtype=dtype)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        for mod in model.modules():
            if isinstance(mod, (Linear, Embedding, MoEMLP)):
                mod.reset_parameters(generator)
        return model

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.weight.device

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16, kv_dtype: str = "bf16"):
        """kv_dtype: "bf16" (a dense KVCache of `dtype`), "int8" / "q8" (a
        QuantKVCache: half the bytes) or "int4" / "q4" (a Quant4KVCache: a
        quarter); the quantized caches round max_len up to 128."""
        cfg = self.cfg
        args = (cfg.num_hidden_layers, batch, max_len, cfg.num_key_value_heads, cfg.head_dim_)
        if kv_dtype in ("int4", "q4", "q4_0"):
            return Quant4KVCache.init(*args, device=self.device)
        if kv_dtype in ("int8", "q8", "q8_0"):
            return QuantKVCache.init(*args, device=self.device)
        return KVCache.init(*args, device=self.device, dtype=dtype)

    def hidden_states(self, input_ids, cache: Optional[KVCache], inputs_embeds=None,
                      pad_lens=None, ring=None, remat: bool = False):
        """Run the trunk; returns (hidden [B,S,D], cache with pos advanced by S).

        Positions and attention lengths come from the cache's write head on
        the device (pos, 0-d, or [B] per slot), with no host round trip;
        positions past the rope table clamp to its last row, as JAX's gather
        does (only idle slots and a finished loop's dead steps reach it).

        pad_lens: [B] left-pad tokens per sequence (ragged batching); rope
        positions shift back by pad_lens (clamped at 0) and the pad prefix is
        masked in attention.

        ring: (mesh, axis[, "ulysses"]) runs a cacheless trunk with
        sequence-parallel attention: input_ids hold this rank's block of the
        sequence, rope positions start at the block's offset, and the hidden
        states returned are the block's.
        remat: on a cacheless forward, each block runs under
        `torch.utils.checkpoint` (use_reentrant=False): its activations are
        recomputed in the backward instead of kept (JAX `jax.checkpoint`)."""
        x = inputs_embeds if inputs_embeds is not None else self.embed_tokens(input_ids)
        if self.cfg.embedding_multiplier != 1.0:
            x = x * in_dtype(self.cfg.embedding_multiplier, x.dtype)
        s = x.shape[1]
        positions = torch.arange(s, device=x.device)[None, :]  # [1, S]
        if cache is not None:  # per-slot write heads [B]: positions [B, S]
            pos0 = cache.pos[:, None] if cache.pos.dim() == 1 else cache.pos
            positions = (pos0 + positions).clamp(max=self.rope.sin.shape[0] - 1)
        elif ring is not None:  # this rank's block of the sequence
            from ..parallel.comm import axis_rank

            positions = positions + axis_rank(ring[0], ring[1]) * s
        kv_start = None
        if pad_lens is not None:
            pad = torch.as_tensor(pad_lens, device=x.device)
            positions = (positions - pad[:, None]).clamp_min(0)  # [B, S]
            kv_start = pad.to(torch.int32)
        for blk in self.blocks:
            if cache is None and remat:
                x = torch.utils.checkpoint.checkpoint(
                    lambda xc, blk=blk: blk(xc, self.rope, None, positions, kv_start=kv_start, ring=ring)[0],
                    x, use_reentrant=False)
            else:
                x, cache = blk(x, self.rope, cache, positions, kv_start=kv_start, ring=ring)
        x = self.norm(x)
        return x, (cache.advance(s) if cache is not None else None)

    def loss(self, input_ids, targets, mask=None, ring=None, remat: bool = False):
        """Next-token cross-entropy over a cacheless forward: the training
        path (JAX `CausalLM.loss`). f32 logits, `log_softmax`, the nll at each
        target; the mean, or with `mask` sum(nll * mask) / max(sum(mask), 1).
        ring: sequence-parallel attention (see hidden_states): input_ids and
        targets are this rank's block, and the loss is the whole sequence's,
        its sums all-reduced over the axis (the all-reduce's backward is the
        identity: each rank's gradients are its block's share, summed over
        the axis as data parallelism sums). remat: per-block recomputation."""
        hidden, _ = self.hidden_states(input_ids, None, ring=ring, remat=remat)
        logp = torch.log_softmax(self.logits(hidden), dim=-1)
        nll = -logp.gather(-1, targets[..., None].long())[..., 0]
        if ring is not None:
            from ..parallel.comm import reduce_from_axis

            if mask is None:
                sums = torch.stack([nll.sum(), nll.new_tensor(float(nll.numel()))])
            else:
                m = mask.to(nll.dtype)
                sums = torch.stack([(nll * m).sum(), m.sum()])
            sums = reduce_from_axis(sums, ring[0], ring[1])
            return sums[0] / sums[1].clamp_min(1.0)
        if mask is not None:
            mask = mask.to(nll.dtype)
            return (nll * mask).sum() / mask.sum().clamp_min(1.0)
        return nll.mean()

    def logits(self, hidden):
        """f32 logits."""
        if self.cfg.logit_divisor != 1.0:  # MiniCPM hidden/dim_model_base
            hidden = hidden / in_dtype(self.cfg.logit_divisor, hidden.dtype)
        if self.lm_head is not None:
            out = self.lm_head(hidden).float()
        else:
            out = self.embed_tokens.as_lm_head(hidden)
        if self.cfg.logit_softcap:
            out = torch.tanh(out / self.cfg.logit_softcap) * self.cfg.logit_softcap
        return out

    def forward(self, input_ids, cache: Optional[KVCache], last_only: bool = True,
                inputs_embeds=None, pad_lens=None):
        """Returns (logits, cache). last_only clips to the final position."""
        hidden, cache = self.hidden_states(input_ids, cache, inputs_embeds, pad_lens=pad_lens)
        if last_only:
            hidden = hidden[:, -1:, :]
        return self.logits(hidden), cache
