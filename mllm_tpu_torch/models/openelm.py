"""OpenELM: counterpart of `mllm_tpu/models/openelm.py`.

Layer-wise scaling: each layer has its own query / KV head counts and FFN
width; fused qkv with a per-head RMSNorm on q and k, RoPE ("hf") on head_dim
64, a fused gate||up FFN, the head tied to the token embedding. One dense
cache serves every layer: its KV heads are the model's widest layer's, and a
narrower layer writes its heads zero-padded to that count.

Attention goes through `nn.attention.attend` over the layer's live KV heads:
the bf16 flash (prefill) and decode (one token) kernels at head_dim 64 on the
card. The live heads `k[:, :n_kv]` of a [B, n_kv_max, S, D] layer are a
strided view when B > 1 and n_kv < n_kv_max, and the kernels take contiguous
K/V, so they are copied contiguous first (at B = 1 the view is contiguous and
nothing is copied; PERF.md has the copy's cost beside the kernels').

Decoding calls `forward` one token at a time, as the reference's demo does
(the JAX model has no `hidden_states` / `logits`, so `generate` does not
drive it there either).

Weight names follow apple/OpenELM: transformer.layers.{i}.attn.qkv_proj /
attn.out_proj / attn.q_norm / attn.k_norm / ffn.proj_1 / ffn.proj_2 /
attn_norm / ffn_norm, transformer.token_embeddings, transformer.norm.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..kv.cache import KVCache, valid_len
from ..nn.attention import attend
from ..nn.layers import Embedding, Linear, RMSNorm, RotaryEmbedding
from .qwen2_vl import load_params


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


@dataclass(frozen=True)
class OpenELMConfig:
    vocab_size: int = 32000
    model_dim: int = 1280
    num_layers: int = 16
    head_dim: int = 64
    num_query_heads: tuple = ()
    num_kv_heads: tuple = ()
    ffn_dims: tuple = ()
    max_context: int = 2048
    rope_theta: float = 10000.0
    eps: float = 1e-6
    eos_token_id: int = 2
    bos_token_id: int = 1

    @staticmethod
    def from_hf(c: dict) -> "OpenELMConfig":
        n = c.get("num_transformer_layers", 16)
        dim = c.get("model_dim", 1280)
        qh = tuple(c.get("num_query_heads", [12] * n))
        kvh = tuple(c.get("num_kv_heads", [3] * n))
        mult = c.get("ffn_multipliers", [2.0] * n)
        div = c.get("ffn_dim_divisor", 256)
        ffn = tuple(_make_divisible(m * dim, div) for m in mult)
        return OpenELMConfig(
            vocab_size=c.get("vocab_size", 32000),
            model_dim=dim, num_layers=n, head_dim=c.get("head_dim", 64),
            num_query_heads=qh, num_kv_heads=kvh, ffn_dims=ffn,
            max_context=c.get("max_context_length", 2048),
            rope_theta=float(c.get("rope_freq_constant", 10000)),
        )


class OpenELMAttention(nn.Module):
    def __init__(self, d: int, n_q: int, n_kv: int, head_dim: int, layer_idx: int, eps: float, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.qkv = Linear(d, (n_q + 2 * n_kv) * head_dim, False, **kw)
        self.out_proj = Linear(n_q * head_dim, d, False, **kw)
        self.q_norm = RMSNorm(head_dim, eps, **kw)
        self.k_norm = RMSNorm(head_dim, eps, **kw)
        self.n_q, self.n_kv, self.head_dim, self.layer_idx = n_q, n_kv, head_dim, layer_idx

    def forward(self, x, rope, cache: KVCache, positions, n_kv_max: int):
        b, s, _ = x.shape
        hd = self.head_dim
        qkv = self.qkv(x).reshape(b, s, self.n_q + 2 * self.n_kv, hd)
        q = self.q_norm(qkv[:, :, : self.n_q])
        k = self.k_norm(qkv[:, :, self.n_q : self.n_q + self.n_kv])
        v = qkv[:, :, self.n_q + self.n_kv :]
        q = rope(q, positions)
        k = rope(k, positions)
        if self.n_kv < n_kv_max:  # zero-pad the KV heads so one cache serves all layers
            k = F.pad(k, (0, 0, 0, n_kv_max - self.n_kv))
            v = F.pad(v, (0, 0, 0, n_kv_max - self.n_kv))
        cache = cache.update_layer(self.layer_idx, k, v)
        k_full, v_full = cache.layer(self.layer_idx)
        k_live = k_full[:, : self.n_kv].contiguous()  # a copy only when B > 1 and heads were padded
        v_live = v_full[:, : self.n_kv].contiguous()
        out = attend(q, k_live, v_live, q_offset=cache.pos, kv_valid_len=valid_len(cache, s), causal=True)
        return self.out_proj(out.reshape(b, s, self.n_q * hd)), cache


class OpenELMBlock(nn.Module):
    def __init__(self, cfg: OpenELMConfig, i: int, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d, ffn = cfg.model_dim, cfg.ffn_dims[i]
        self.attn_norm = RMSNorm(d, cfg.eps, **kw)
        self.attn = OpenELMAttention(d, cfg.num_query_heads[i], cfg.num_kv_heads[i], cfg.head_dim, i, cfg.eps, **kw)
        self.ffn_norm = RMSNorm(d, cfg.eps, **kw)
        self.proj_1 = Linear(d, 2 * ffn, False, **kw)  # fused gate | up
        self.proj_2 = Linear(ffn, d, False, **kw)
        self.ffn_dim = ffn

    def forward(self, x, rope, cache, positions, n_kv_max: int):
        h, cache = self.attn(self.attn_norm(x), rope, cache, positions, n_kv_max)
        x = x + h
        h = self.proj_1(self.ffn_norm(x))
        x = x + self.proj_2(F.silu(h[..., : self.ffn_dim]) * h[..., self.ffn_dim :])
        return x, cache


class OpenELMForCausalLM(nn.Module):
    def __init__(self, cfg: OpenELMConfig, *, device, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.embed_tokens = Embedding(cfg.vocab_size, cfg.model_dim, **kw)
        self.blocks = nn.ModuleList([OpenELMBlock(cfg, i, **kw) for i in range(cfg.num_layers)])
        self.norm = RMSNorm(cfg.model_dim, cfg.eps, **kw)
        self.rope = RotaryEmbedding.make(cfg.head_dim, cfg.max_context, cfg.rope_theta, "hf", device=device)
        self.cfg = cfg

    @staticmethod
    def init(cfg: OpenELMConfig, *, device, dtype=torch.float32,
             generator: Optional[torch.Generator] = None) -> "OpenELMForCausalLM":
        """Random weights from `generator`: the embedding N(0, 0.02^2),
        Linears U(+-1/sqrt(in)), norms ones."""
        g = generator or torch.Generator(device=device).manual_seed(0)
        model = OpenELMForCausalLM(cfg, device=device, dtype=dtype)
        for mod in model.modules():
            if isinstance(mod, (Linear, Embedding)):
                mod.reset_parameters(g)
        return model

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.weight.device

    @property
    def n_kv_max(self) -> int:
        return max(self.cfg.num_kv_heads)

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16) -> KVCache:
        return KVCache.init(self.cfg.num_layers, batch, max_len, self.n_kv_max, self.cfg.head_dim,
                            device=self.device, dtype=dtype)

    def forward(self, input_ids, cache: KVCache, last_only: bool = True):
        """(f32 logits through the tied head, cache advanced by S); positions
        from the cache's head on the device."""
        s = input_ids.shape[1]
        x = self.embed_tokens(input_ids)
        positions = (cache.pos + torch.arange(s, device=x.device))[None].clamp(max=self.rope.sin.shape[0] - 1)
        for blk in self.blocks:
            x, cache = blk(x, self.rope, cache, positions, self.n_kv_max)
        x = self.norm(x)
        if last_only:
            x = x[:, -1:, :]
        return self.embed_tokens.as_lm_head(x), cache.advance(s)


def load_openelm(loader, cfg: OpenELMConfig, *, device, dtype=torch.float32) -> OpenELMForCausalLM:
    """An apple/OpenELM checkpoint (names in the module docstring)."""
    model = OpenELMForCausalLM(cfg, device=device, dtype=dtype)
    names = {"embed_tokens.weight": "transformer.token_embeddings.weight", "norm.weight": "transformer.norm.weight"}
    sub = {"attn.qkv": "attn.qkv_proj", "attn.out_proj": "attn.out_proj", "attn.q_norm": "attn.q_norm",
           "attn.k_norm": "attn.k_norm", "attn_norm": "attn_norm", "ffn_norm": "ffn_norm",
           "proj_1": "ffn.proj_1", "proj_2": "ffn.proj_2"}
    for i in range(cfg.num_layers):
        for port, ck in sub.items():
            names[f"blocks.{i}.{port}.weight"] = f"transformer.layers.{i}.{ck}.weight"
    load_params(model, loader, names, device=device, dtype=dtype)
    return model
