"""OPT: counterpart of `mllm_tpu/models/opt.py`.

Decoder-only, learned positions (offset 2, read at the cache's write head on
the device), pre- or post-LayerNorm blocks, a ReLU FFN, no rope, the head
tied to the token embedding. Attention goes through `nn.attention.attend` over
the dense cache: the bf16 flash (prefill) and decode (one token) kernels at
OPT's head_dim 64 on the card, their plain versions on the CPU. q is scaled
before the product (scale 1 in the kernel), as the reference does. Decoding
calls `forward` one token at a time, as the reference's demo does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..kv.cache import KVCache, valid_len
from ..nn.attention import attend
from ..nn.layers import Embedding, LayerNorm, Linear, _param
from .qwen2_vl import load_params, read_config


@dataclass(frozen=True)
class OPTConfig:
    vocab_size: int = 50272
    hidden_size: int = 768
    ffn_dim: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 2048
    do_layer_norm_before: bool = True
    eos_token_id: int = 2
    bos_token_id: int = 2


class OPTAttention(nn.Module):
    def __init__(self, d: int, n_heads: int, layer_idx: int, bias: bool = True, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (Linear(d, d, bias, **kw) for _ in range(4))
        self.n_heads = n_heads
        self.layer_idx = layer_idx

    def forward(self, x, cache: KVCache):
        b, s, d = x.shape
        hd = d // self.n_heads
        q = (self.q_proj(x) * hd**-0.5).reshape(b, s, self.n_heads, hd)
        k = self.k_proj(x).reshape(b, s, self.n_heads, hd)
        v = self.v_proj(x).reshape(b, s, self.n_heads, hd)
        cache = cache.update_layer(self.layer_idx, k, v)
        k_full, v_full = cache.layer(self.layer_idx)
        out = attend(q, k_full, v_full, q_offset=cache.pos, kv_valid_len=valid_len(cache, s), causal=True,
                     scale=1.0)
        return self.out_proj(out.reshape(b, s, d)), cache


class OPTBlock(nn.Module):
    def __init__(self, cfg: OPTConfig, layer_idx: int, bias: bool = True, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.hidden_size
        self.ln1 = LayerNorm(d, 1e-5, **kw)
        self.attn = OPTAttention(d, cfg.num_attention_heads, layer_idx, bias, **kw)
        self.ln2 = LayerNorm(d, 1e-5, **kw)
        self.fc1 = Linear(d, cfg.ffn_dim, bias, **kw)
        self.fc2 = Linear(cfg.ffn_dim, d, bias, **kw)
        self.pre_norm = cfg.do_layer_norm_before

    def forward(self, x, cache):
        h = self.ln1(x) if self.pre_norm else x
        h, cache = self.attn(h, cache)
        x = x + h
        if not self.pre_norm:
            x = self.ln1(x)
        h = self.ln2(x) if self.pre_norm else x
        x = x + self.fc2(F.relu(self.fc1(h)))
        if not self.pre_norm:
            x = self.ln2(x)
        return x, cache


class OPTForCausalLM(nn.Module):
    POS_OFFSET = 2  # HF OPTLearnedPositionalEmbedding's offset

    def __init__(self, cfg: OPTConfig, final_ln: bool = True, bias: bool = True, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.embed_tokens = Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.embed_positions = _param(cfg.max_position_embeddings + self.POS_OFFSET, cfg.hidden_size, **kw)
        self.blocks = nn.ModuleList([OPTBlock(cfg, i, bias, **kw) for i in range(cfg.num_hidden_layers)])
        self.final_ln = LayerNorm(cfg.hidden_size, 1e-5, **kw) if final_ln else None
        self.cfg = cfg

    @staticmethod
    def init(cfg: OPTConfig, *, device, dtype=torch.float32,
             generator: Optional[torch.Generator] = None) -> "OPTForCausalLM":
        """Random weights from `generator`: token and position embeddings
        N(0, 0.02^2), Linears U(+-1/sqrt(in)), norms ones / zeros."""
        g = generator or torch.Generator(device=device).manual_seed(0)
        model = OPTForCausalLM(cfg, device=device, dtype=dtype)
        model.embed_tokens.reset_parameters(g)
        model.embed_positions.normal_(0.0, 0.02, generator=g)
        for mod in model.modules():
            if isinstance(mod, Linear):
                mod.reset_parameters(g)
        return model

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.weight.device

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16) -> KVCache:
        hd = self.cfg.hidden_size // self.cfg.num_attention_heads
        return KVCache.init(self.cfg.num_hidden_layers, batch, max_len, self.cfg.num_attention_heads, hd,
                            device=self.device, dtype=dtype)

    def forward(self, input_ids, cache: KVCache, last_only: bool = True):
        """(f32 logits, cache advanced by S); positions from the cache's head
        (past the table they clamp to its last row, as JAX's gather does)."""
        s = input_ids.shape[1]
        pos = (cache.pos + torch.arange(s, device=input_ids.device) + self.POS_OFFSET).clamp(
            max=self.embed_positions.shape[0] - 1)
        x = self.embed_tokens(input_ids) + self.embed_positions[pos][None]
        for blk in self.blocks:
            x, cache = blk(x, cache)
        if self.final_ln is not None:
            x = self.final_ln(x)
        if last_only:
            x = x[:, -1:, :]
        return self.embed_tokens.as_lm_head(x), cache.advance(s)


def opt_config_from_hf(path_or_dict) -> OPTConfig:
    c = read_config(path_or_dict)
    return OPTConfig(
        vocab_size=c.get("vocab_size", 50272),
        hidden_size=c.get("hidden_size", 768),
        ffn_dim=c.get("ffn_dim", 3072),
        num_hidden_layers=c.get("num_hidden_layers", 12),
        num_attention_heads=c.get("num_attention_heads", 12),
        max_position_embeddings=c.get("max_position_embeddings", 2048),
        do_layer_norm_before=c.get("do_layer_norm_before", True),
        eos_token_id=c.get("eos_token_id", 2),
    )


def load_opt(loader, cfg: OPTConfig, *, device, dtype=torch.float32) -> OPTForCausalLM:
    """An HF OPT checkpoint (`model.decoder.*`; biases and the final norm as
    the checkpoint holds them)."""
    pre = "model.decoder."
    bias = pre + "layers.0.self_attn.q_proj.bias" in loader
    final_ln = pre + "final_layer_norm.weight" in loader
    model = OPTForCausalLM(cfg, final_ln, bias, device=device, dtype=dtype)
    names = {"embed_tokens.weight": pre + "embed_tokens.weight",
             "embed_positions": pre + "embed_positions.weight"}
    if final_ln:
        names.update({f"final_ln.{w}": f"{pre}final_layer_norm.{w}" for w in ("weight", "bias")})
    sub = {"ln1": "self_attn_layer_norm", "ln2": "final_layer_norm", "attn.q_proj": "self_attn.q_proj",
           "attn.k_proj": "self_attn.k_proj", "attn.v_proj": "self_attn.v_proj",
           "attn.out_proj": "self_attn.out_proj", "fc1": "fc1", "fc2": "fc2"}
    for i in range(cfg.num_hidden_layers):
        for port, hf in sub.items():
            for w in ("weight", "bias") if bias or port.startswith("ln") else ("weight",):
                names[f"blocks.{i}.{port}.{w}"] = f"{pre}layers.{i}.{hf}.{w}"
    load_params(model, loader, names, device=device, dtype=dtype)
    return model
