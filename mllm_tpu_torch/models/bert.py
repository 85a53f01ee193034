"""BERT encoder: counterpart of `mllm_tpu/models/bert.py`.

Token + position + type embeddings, post-LN encoder blocks with
bidirectional attention (the port's `sdpa`, as the reference sends these
blocks to XLA `sdpa`; padding masked by an additive bias), and the sentence
embedding: a mean over the valid tokens, L2-normalized. Loads HF BERT
checkpoints with or without the `bert.` prefix; `auto_model` pairs it with
the port's WordPiece tokenizer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..nn.attention import sdpa
from ..nn.layers import ACT_FN, LayerNorm, Linear, _param
from .qwen2_vl import load_params, read_config


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_act: str = "gelu"


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.hidden_size
        self.q, self.k, self.v, self.out = (Linear(d, d, True, **kw) for _ in range(4))
        self.out_ln = LayerNorm(d, cfg.layer_norm_eps, **kw)
        self.n_heads = cfg.num_attention_heads

    def forward(self, x, attn_bias):
        b, s, d = x.shape
        hd = d // self.n_heads
        q = self.q(x).reshape(b, s, self.n_heads, hd)
        k = self.k(x).reshape(b, s, self.n_heads, hd).transpose(1, 2)
        v = self.v(x).reshape(b, s, self.n_heads, hd).transpose(1, 2)
        o = sdpa(q, k, v, causal=False, bias=attn_bias)
        return self.out_ln(x + self.out(o.reshape(b, s, d)))


class BertBlock(nn.Module):
    def __init__(self, cfg: BertConfig, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.attn = BertSelfAttention(cfg, **kw)
        self.inter = Linear(cfg.hidden_size, cfg.intermediate_size, True, **kw)
        self.output = Linear(cfg.intermediate_size, cfg.hidden_size, True, **kw)
        self.out_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **kw)
        self.act = cfg.hidden_act

    def forward(self, x, attn_bias):
        x = self.attn(x, attn_bias)
        return self.out_ln(x + self.output(ACT_FN[self.act](self.inter(x))))


class BertModel(nn.Module):
    def __init__(self, cfg: BertConfig, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.hidden_size
        self.word_emb = _param(cfg.vocab_size, d, **kw)
        self.pos_emb = _param(cfg.max_position_embeddings, d, **kw)
        self.type_emb = _param(cfg.type_vocab_size, d, **kw)
        self.emb_ln = LayerNorm(d, cfg.layer_norm_eps, **kw)
        self.blocks = nn.ModuleList([BertBlock(cfg, **kw) for _ in range(cfg.num_hidden_layers)])
        self.cfg = cfg

    @staticmethod
    def init(cfg: BertConfig, *, device, dtype=torch.float32,
             generator: Optional[torch.Generator] = None) -> "BertModel":
        """Random weights from `generator`: embeddings N(0, 0.02^2), Linears
        U(+-1/sqrt(in)), norms ones / zeros."""
        g = generator or torch.Generator(device=device).manual_seed(0)
        model = BertModel(cfg, device=device, dtype=dtype)
        for t in (model.word_emb, model.pos_emb, model.type_emb):
            t.normal_(0.0, 0.02, generator=g)
        for mod in model.modules():
            if isinstance(mod, Linear):
                mod.reset_parameters(g)
        return model

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        """[B, S] ids (and a [B, S] mask of valid tokens) -> hidden [B, S, D]."""
        s = input_ids.shape[1]
        types = self.type_emb[token_type_ids] if token_type_ids is not None else self.type_emb[0][None, None]
        x = self.emb_ln(self.word_emb[input_ids] + self.pos_emb[None, :s] + types)
        bias = None
        if attention_mask is not None:
            bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0, -1e30).to(torch.float32)
        for blk in self.blocks:
            x = blk(x, bias)
        return x

    def sentence_embedding(self, input_ids, attention_mask):
        """The mean of the valid tokens' hidden states, L2-normalized."""
        h = self(input_ids, attention_mask)
        m = attention_mask[..., None].to(h.dtype)
        emb = (h * m).sum(dim=1) / m.sum(dim=1).clamp_min(1e-9)
        return emb / torch.linalg.norm(emb, dim=-1, keepdim=True)


def bert_config_from_hf(path_or_dict) -> BertConfig:
    c = read_config(path_or_dict)
    return BertConfig(
        vocab_size=c.get("vocab_size", 30522),
        hidden_size=c.get("hidden_size", 768),
        intermediate_size=c.get("intermediate_size", 3072),
        num_hidden_layers=c.get("num_hidden_layers", 12),
        num_attention_heads=c.get("num_attention_heads", 12),
        max_position_embeddings=c.get("max_position_embeddings", 512),
        type_vocab_size=c.get("type_vocab_size", 2),
        layer_norm_eps=c.get("layer_norm_eps", 1e-12),
        hidden_act=c.get("hidden_act", "gelu"),
    )


def load_bert(loader, cfg: BertConfig, *, device, dtype=torch.float32) -> BertModel:
    """An HF BERT checkpoint, with or without the `bert.` prefix."""
    model = BertModel(cfg, device=device, dtype=dtype)
    pre = "bert." if "bert.embeddings.word_embeddings.weight" in loader else ""
    e = pre + "embeddings."
    names = {"word_emb": e + "word_embeddings.weight", "pos_emb": e + "position_embeddings.weight",
             "type_emb": e + "token_type_embeddings.weight", "emb_ln.weight": e + "LayerNorm.weight",
             "emb_ln.bias": e + "LayerNorm.bias"}
    sub = {"attn.q": "attention.self.query", "attn.k": "attention.self.key", "attn.v": "attention.self.value",
           "attn.out": "attention.output.dense", "attn.out_ln": "attention.output.LayerNorm",
           "inter": "intermediate.dense", "output": "output.dense", "out_ln": "output.LayerNorm"}
    for i in range(cfg.num_hidden_layers):
        for port, hf in sub.items():
            for w in ("weight", "bias"):
                names[f"blocks.{i}.{port}.{w}"] = f"{pre}encoder.layer.{i}.{hf}.{w}"
    load_params(model, loader, names, device=device, dtype=dtype)
    return model
