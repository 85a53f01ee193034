"""Decoder-only transformer: counterpart of `mllm_tpu/models/transformer.py`
for the dense families (qwen2, qwen3, llama, mistral, ...).

Module and attribute names match the JAX package (`embed_tokens`,
`blocks[i].attn.q_proj`, `input_norm`, `post_attn_norm`, `mlp.gate_proj`,
`norm`, `lm_head`), so the state-dict keys read like `Module.parameters()`
names there, with `blocks.{i}` in place of `blocks.mods.{i}`.

`ops.quantize_model.fuse_projections` sets `attn.qkv_proj` (q||k||v) and
`mlp.gateup_proj` (gate||up) in place of the split projections, as in the
JAX package; `quantize_model` then swaps Linears for quantized layers.

Not in this slice: stacked weights, ring attention and `loss`.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core.config import TextConfig
from ..kv.cache import KVCache
from ..nn.attention import attend, attend_from_cache
from ..nn.layers import ACT_FN, Embedding, Linear, RMSNorm, RotaryEmbedding


def check_supported(cfg: TextConfig) -> None:
    """Raise NotImplementedError for config features this slice lacks."""
    missing = []
    if cfg.norm_type != "rmsnorm":
        missing.append(f"norm_type={cfg.norm_type} (ROADMAP Queue 1 item 3)")
    if cfg.post_norm or cfg.model_type.startswith("gemma"):
        missing.append("gemma norms and softcaps (ROADMAP Queue 1 item 14)")
    if cfg.rope_int8:
        missing.append("int8 RoPE tables (ROADMAP Queue 1 item 3)")
    if cfg.num_experts:
        missing.append("MoE layers (ROADMAP Queue 1 item 14)")
    if cfg.hidden_act not in ACT_FN:
        missing.append(f"activation {cfg.hidden_act} (ROADMAP Queue 1 item 3)")
    if missing:
        raise NotImplementedError("mllm_tpu_torch does not port yet: " + "; ".join(missing))


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

    def forward(self, x, rope: RotaryEmbedding, cache: Optional[KVCache], positions, kv_start=None):
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
        kw = dict(kv_start=kv_start, causal=True, window=self._window(), scale=scale,
                  logit_softcap=cfg.attn_logit_softcap)
        if cache is not None:
            cache = cache.update_layer(self.layer_idx, k, v)
            out = attend_from_cache(q, cache, self.layer_idx, q_offset=cache.pos,
                                    kv_valid_len=cache.pos + s, **kw)
        else:  # cacheless (scoring) path
            out = attend(q, k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous(),
                         q_offset=0, kv_valid_len=None, **kw)
        return self.o_proj(out.reshape(b, s, h * hd)), cache


class MLP(nn.Module):
    """Gated FFN: down(act(gate(x)) * up(x))."""

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
        return self.down_proj(ACT_FN[self.act](self.gate_proj(x)) * self.up_proj(x))


class DecoderBlock(nn.Module):
    def __init__(self, cfg: TextConfig, layer_idx: int, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.input_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        self.attn = Attention(cfg, layer_idx, **kw)
        self.post_attn_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        self.mlp = MLP(cfg, **kw)
        self.residual_multiplier = cfg.residual_multiplier  # MiniCPM scale_depth/sqrt(L)

    def forward(self, x, rope, cache, positions, kv_start=None):
        rm = self.residual_multiplier
        h, cache = self.attn(self.input_norm(x), rope, cache, positions, kv_start=kv_start)
        x = x + (h if rm == 1.0 else h * rm)
        h = self.mlp(self.post_attn_norm(x))
        x = x + (h if rm == 1.0 else h * rm)
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
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        self.lm_head = (None if cfg.tie_word_embeddings
                        else Linear(cfg.hidden_size, cfg.vocab_size, False, **kw))
        self.rope = RotaryEmbedding.make(
            cfg.head_dim_, cfg.max_position_embeddings, cfg.rope_theta,
            cfg.rope_style, cfg.rope_partial, cfg.rope_scaling_dict(), device=device)
        self.cfg = cfg

    @staticmethod
    def init(cfg: TextConfig, *, device, dtype=torch.float32,
             generator: Optional[torch.Generator] = None) -> "CausalLM":
        """Random weights with the JAX package's init distributions, drawn from
        `generator` (a fresh one seeded with 0 on `device` if None)."""
        model = CausalLM(cfg, device=device, dtype=dtype)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        for mod in model.modules():
            if isinstance(mod, (Linear, Embedding)):
                mod.reset_parameters(generator)
        return model

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.weight.device

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16) -> KVCache:
        cfg = self.cfg
        return KVCache.init(cfg.num_hidden_layers, batch, max_len, cfg.num_key_value_heads,
                            cfg.head_dim_, device=self.device, dtype=dtype)

    def hidden_states(self, input_ids, cache: Optional[KVCache], inputs_embeds=None,
                      pad_lens=None):
        """Run the trunk; returns (hidden [B,S,D], cache with pos advanced by S).

        pad_lens: [B] left-pad tokens per sequence (ragged batching); rope
        positions shift back by pad_lens (clamped at 0) and the pad prefix is
        masked in attention."""
        x = inputs_embeds if inputs_embeds is not None else self.embed_tokens(input_ids)
        if self.cfg.embedding_multiplier != 1.0:
            x = x * self.cfg.embedding_multiplier
        s = x.shape[1]
        pos0 = cache.pos if cache is not None else 0
        positions = pos0 + torch.arange(s, device=x.device)[None, :]  # [1, S]
        kv_start = None
        if pad_lens is not None:
            pad = torch.as_tensor(pad_lens, device=x.device)
            positions = (positions - pad[:, None]).clamp_min(0)  # [B, S]
            kv_start = pad.to(torch.int32)
        for blk in self.blocks:
            x, cache = blk(x, self.rope, cache, positions, kv_start=kv_start)
        x = self.norm(x)
        return x, (cache.advance(s) if cache is not None else None)

    def logits(self, hidden):
        """f32 logits."""
        if self.cfg.logit_divisor != 1.0:  # MiniCPM hidden/dim_model_base
            hidden = hidden / self.cfg.logit_divisor
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
