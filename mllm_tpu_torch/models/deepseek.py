"""DeepSeek-V3-class models: counterpart of `mllm_tpu/models/deepseek.py`.
MLA (multi-head latent attention) and the grouped sigmoid-routed MoE; also
MiniCPM3 (MLA with a dense MLP and MiniCPM's scalings).

MLA caches the per-head K (nope || rope) and V as ordinary attention does,
so the cache holds K [L, B, H, S, qk_head_dim] and V [L, B, H, S,
v_head_dim]: 192 and 128 for DeepSeek-V3, 96 and 64 for MiniCPM3. Attention
is the port's plain `sdpa`, as the JAX package calls `sdpa` here: no kernel
takes a head_dim of 192 there either.

Module and attribute names are the JAX package's, so `bridge.module_from_jax`
maps its parameters one to one.

Behaviour of the reference that the port keeps:
  - the query's rope half is rotated but not put back: attention takes the
    query as the projection gave it (`deepseek.py:75-106` rotates `q_rot` and
    passes `q`), where transformers rotates it. With small weights the logits
    still agree with transformers within the JAX test's 3e-3;
  - `load_deepseek` builds RoPE without scaling and without YaRN's mscale on
    the softmax scale (DeepSeek-V3's config sets YaRN, factor 40);
  - the routed experts always take the ragged branch;
  - the model registry dispatches none of deepseek_v3 / minicpm3: the
    loaders here are the entry points.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..core.config import TextConfig, from_hf_config
from ..kv.cache import KVCache, valid_len
from ..nn.attention import sdpa
from ..nn.layers import Embedding, Linear, RMSNorm, RotaryEmbedding, apply_rotary
from .moe import grouped_ffn, ragged_experts, stack_experts
from .qwen2_vl import read_config
from .transformer import MLP, CausalLM, DecoderBlock


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: Optional[int] = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_interleave: bool = True

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


def _rope_apply(rope: RotaryEmbedding, x, positions, style: str):
    """RoPE on x [B, S, H, rot] with the table's rows at `positions`, in
    `style` ("llama": interleaved pairs; "hf": halves)."""
    sin = rope.sin[positions][..., None, :]
    cos = rope.cos[positions][..., None, :]
    return apply_rotary(x, sin, cos, style, rope.rot_dim)


class MLAAttention(nn.Module):
    """Multi-head latent attention (DeepseekV3Attention semantics, with the
    reference's query noted in the module docstring). Projections: q through
    q_a -> q_a_norm -> q_b (q_lora_rank set) or q_full; kv_a -> (latent,
    rope part), kv_a_norm -> kv_b -> (k_nope, v); o_proj."""

    def __init__(self, q_a, q_a_norm, q_b, q_full, kv_a, kv_a_norm, kv_b, o_proj, cfg: TextConfig,
                 mla: MLAConfig, layer_idx: int):
        super().__init__()
        self.q_a, self.q_a_norm, self.q_b, self.q_full = q_a, q_a_norm, q_b, q_full
        self.kv_a, self.kv_a_norm, self.kv_b, self.o_proj = kv_a, kv_a_norm, kv_b, o_proj
        self.cfg, self.mla, self.layer_idx = cfg, mla, layer_idx

    @staticmethod
    def empty(cfg: TextConfig, mla: MLAConfig, layer_idx: int, *, device, dtype,
              attention_bias: bool = False) -> "MLAAttention":
        """Uninitialised projections of the config's shapes (biases on q_a,
        kv_a and o_proj with attention_bias, as transformers places them)."""
        d, h, ab = cfg.hidden_size, cfg.num_attention_heads, attention_bias
        kw = dict(device=device, dtype=dtype)
        q_a = q_a_norm = q_b = q_full = None
        if mla.q_lora_rank:
            q_a = Linear(d, mla.q_lora_rank, ab, **kw)
            q_a_norm = RMSNorm(mla.q_lora_rank, cfg.rms_norm_eps, **kw)
            q_b = Linear(mla.q_lora_rank, h * mla.qk_head_dim, False, **kw)
        else:
            q_full = Linear(d, h * mla.qk_head_dim, False, **kw)
        return MLAAttention(
            q_a, q_a_norm, q_b, q_full, Linear(d, mla.kv_lora_rank + mla.qk_rope_head_dim, ab, **kw),
            RMSNorm(mla.kv_lora_rank, cfg.rms_norm_eps, **kw),
            Linear(mla.kv_lora_rank, h * (mla.qk_nope_head_dim + mla.v_head_dim), False, **kw),
            Linear(h * mla.v_head_dim, d, ab, **kw), cfg, mla, layer_idx)

    def forward(self, x, rope: RotaryEmbedding, cache: Optional[KVCache], positions, kv_start=None,
                bias=None, causal=True):
        cfg, mla = self.cfg, self.mla
        b, s, _ = x.shape
        h = cfg.num_attention_heads
        q = self.q_full(x) if self.q_full is not None else self.q_b(self.q_a_norm(self.q_a(x)))
        q = q.reshape(b, s, h, mla.qk_head_dim)
        q_rot = q[..., mla.qk_nope_head_dim:]

        ckv = self.kv_a(x)  # [b, s, kv_lora + rope]
        k_latent = ckv[..., : mla.kv_lora_rank]
        k_rot = ckv[..., mla.kv_lora_rank:].reshape(b, s, 1, mla.qk_rope_head_dim)
        kv = self.kv_b(self.kv_a_norm(k_latent)).reshape(b, s, h, mla.qk_nope_head_dim + mla.v_head_dim)
        k_nope, v = kv[..., : mla.qk_nope_head_dim], kv[..., mla.qk_nope_head_dim:]

        style = "llama" if mla.rope_interleave else "hf"
        q_rot = _rope_apply(rope, q_rot, positions, style)  # not put back into q, as the reference
        k_rot = _rope_apply(rope, k_rot, positions, style).expand(b, s, h, mla.qk_rope_head_dim)
        k = torch.cat([k_nope, k_rot], dim=-1)  # [b, s, h, qk_head]
        scale = mla.qk_head_dim**-0.5

        if cache is not None:
            cache = cache.update_layer(self.layer_idx, k, v)
            k_full, v_full = cache.layer(self.layer_idx)
            q_offset, kv_valid = cache.pos, valid_len(cache, s)
        else:
            k_full, v_full = k.transpose(1, 2), v.transpose(1, 2)
            q_offset, kv_valid = 0, None
        out = sdpa(q, k_full, v_full, q_offset=q_offset, kv_valid_len=kv_valid, kv_start=kv_start,
                   causal=causal, bias=bias, scale=scale)
        return self.o_proj(out.reshape(b, s, h * mla.v_head_dim)), cache


class GroupedTopkRouter(nn.Module):
    """DeepseekV3TopkRouter: sigmoid f32 scores plus the correction bias,
    group-limited top-k (a group scores the sum of its two best; the
    topk_group best groups are kept and the rest masked to 0.0, so a negative
    choice score loses to a masked one, as in transformers), weights taken
    without the bias, normalised, times routed_scaling. Every top-k is a
    stable descending sort: ties go to the lower index, as `jax.lax.top_k`.

    weight [E, d] and bias [E] are f32."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor, top_k: int, n_group: int, topk_group: int,
                 norm_topk: bool, routed_scaling: float):
        super().__init__()
        self.weight = nn.Parameter(weight, requires_grad=False)
        self.bias = nn.Parameter(bias, requires_grad=False)
        self.top_k, self.n_group, self.topk_group = top_k, n_group, topk_group
        self.norm_topk, self.routed_scaling = norm_topk, routed_scaling

    def forward(self, x2d):
        """(top_i int64 [T, k], top_w f32 [T, k])."""
        e = self.weight.shape[0]
        scores = torch.sigmoid(torch.nn.functional.linear(x2d.float(), self.weight.float()))  # [T, E]
        choice = scores + self.bias.float()[None]
        per_group = choice.reshape(-1, self.n_group, e // self.n_group)
        group_scores = torch.sort(per_group, dim=-1, descending=True, stable=True).values[..., :2].sum(-1)
        gidx = torch.sort(group_scores, dim=-1, descending=True, stable=True).indices[:, : self.topk_group]
        gmask = torch.zeros_like(group_scores).scatter_(1, gidx, 1.0)
        smask = gmask[:, :, None].expand(-1, -1, e // self.n_group).reshape(-1, e)
        masked = torch.where(smask > 0, choice, torch.zeros_like(choice))
        top_i = torch.sort(masked, dim=-1, descending=True, stable=True).indices[:, : self.top_k]
        top_w = torch.gather(scores, 1, top_i)
        if self.norm_topk:
            top_w = top_w / (top_w.sum(dim=-1, keepdim=True) + 1e-20)
        return top_i, top_w * self.routed_scaling


class DeepseekMoE(nn.Module):
    """Routed experts on the port's ragged branch (a stable sort by expert,
    `scatter_add_` group sizes, `torch._grouped_mm` on device offsets,
    combined in the model dtype) plus the shared experts. w_gate, w_up
    [E, d, ff]; w_down [E, ff, d]."""

    def __init__(self, router: GroupedTopkRouter, w_gate, w_up, w_down, shared: Optional[MLP], act: str):
        super().__init__()
        self.router = router
        self.w_gate = nn.Parameter(w_gate, requires_grad=False)
        self.w_up = nn.Parameter(w_up, requires_grad=False)
        self.w_down = nn.Parameter(w_down, requires_grad=False)
        self.shared = shared
        self.act = act

    def forward(self, x):
        b, s, d = x.shape
        xf = x.reshape(b * s, d)
        top_i, top_w = self.router(xf)
        y = ragged_experts(xf, top_w, top_i, self.w_gate.shape[0],
                           lambda xs, sizes, _: grouped_ffn(xs, sizes, self.w_gate, self.w_up, self.w_down,
                                                            self.act))
        if self.shared is not None:
            y = y + self.shared(xf)
        return y.reshape(b, s, d).to(x.dtype)


class MLADecoderBlock(DecoderBlock):
    """A DecoderBlock over given modules (MLA attention, an MLP or a
    DeepseekMoE); the residual multiplier is the config's (MiniCPM3)."""

    def __init__(self, input_norm, attn, post_attn_norm, mlp, residual_multiplier: float = 1.0):
        nn.Module.__init__(self)
        self.input_norm, self.attn, self.post_attn_norm, self.mlp = input_norm, attn, post_attn_norm, mlp
        self.pre_ffn_norm = self.post_ffn_norm = None
        self.residual_multiplier = residual_multiplier


def _is_moe_layer(moe_cfg: dict, i: int) -> bool:
    return bool(moe_cfg["n_routed_experts"]) and i >= moe_cfg["first_k_dense_replace"]


class DeepseekForCausalLM(CausalLM):
    """The CausalLM trunk and head (`hidden_states`, `logits`, `forward`, so
    `generate` and `generate_compiled` drive it) over MLA blocks, with a
    cache whose K and V head dims differ."""

    def __init__(self, text: TextConfig, mla: MLAConfig, moe_cfg: dict, *, device, dtype=torch.float32,
                 lm_head: Optional[bool] = None, attention_bias: bool = False):
        """Uninitialised weights of the configs' shapes (`init` fills them at
        random, `load_deepseek` from a checkpoint). lm_head: an untied head
        (default: not text.tie_word_embeddings); attention_bias: biases on
        q_a, kv_a and o_proj (DeepSeek-V3's config has none)."""
        nn.Module.__init__(self)
        kw = dict(device=device, dtype=dtype)
        d = text.hidden_size
        self.embed_tokens = Embedding(text.vocab_size, d, **kw)
        blocks = []
        for i in range(text.num_hidden_layers):
            if _is_moe_layer(moe_cfg, i):
                e, ff = moe_cfg["n_routed_experts"], moe_cfg["moe_intermediate_size"]
                router = GroupedTopkRouter(
                    torch.empty(e, d, device=device), torch.zeros(e, device=device),
                    moe_cfg["num_experts_per_tok"], moe_cfg["n_group"], moe_cfg["topk_group"],
                    moe_cfg["norm_topk_prob"], moe_cfg["routed_scaling_factor"])
                shared = None
                if moe_cfg["n_shared_experts"]:
                    shared = MLP(text.replace(intermediate_size=ff * moe_cfg["n_shared_experts"], mlp_bias=False), **kw)
                mlp = DeepseekMoE(router, torch.empty(e, d, ff, **kw), torch.empty(e, d, ff, **kw),
                                  torch.empty(e, ff, d, **kw), shared, text.hidden_act)
            else:
                mlp = MLP(text.replace(mlp_bias=False), **kw)
            blocks.append(MLADecoderBlock(RMSNorm(d, text.rms_norm_eps, **kw), MLAAttention.empty(text, mla, i, attention_bias=attention_bias, **kw),
                                          RMSNorm(d, text.rms_norm_eps, **kw), mlp, text.residual_multiplier))
        self.blocks = nn.ModuleList(blocks)
        self.norm = RMSNorm(d, text.rms_norm_eps, **kw)
        if lm_head is None:
            lm_head = not text.tie_word_embeddings
        self.lm_head = Linear(d, text.vocab_size, False, **kw) if lm_head else None
        self.rope = RotaryEmbedding.make(mla.qk_rope_head_dim, text.max_position_embeddings, text.rope_theta, "hf",
                                         device=device)
        self.cfg, self.mla, self.moe_cfg = text, mla, dict(moe_cfg)

    @staticmethod
    def init(text: TextConfig, mla: MLAConfig, moe_cfg: dict, *, device, dtype=torch.float32,
             generator: Optional[torch.Generator] = None) -> "DeepseekForCausalLM":
        """Random weights from `generator`: Linears U(+-1/sqrt(in)), the
        embedding, the expert stacks and the router N(0, 0.02^2) (the JAX
        `MoEMLP.init` scale), the router's correction bias U(-0.2, 0.2) (as
        tests/test_deepseek.py sets it) so that group-limited routing is
        exercised; norms ones."""
        g = generator or torch.Generator(device=device).manual_seed(0)
        model = DeepseekForCausalLM(text, mla, moe_cfg, device=device, dtype=dtype)
        for mod in model.modules():
            if isinstance(mod, (Linear, Embedding)):
                mod.reset_parameters(g)
            elif isinstance(mod, DeepseekMoE):
                for p in (mod.router.weight, mod.w_gate, mod.w_up, mod.w_down):
                    p.normal_(0.0, 0.02, generator=g)
                mod.router.bias.uniform_(-0.2, 0.2, generator=g)
        return model

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16) -> KVCache:
        """K [L, B, H, max_len, qk_head_dim], V [L, B, H, max_len, v_head_dim]."""
        cfg, mla = self.cfg, self.mla
        lead = (cfg.num_hidden_layers, batch, cfg.num_attention_heads, max_len)
        return KVCache(torch.zeros(*lead, mla.qk_head_dim, device=self.device, dtype=dtype),
                       torch.zeros(*lead, mla.v_head_dim, device=self.device, dtype=dtype), 0)


def deepseek_config_from_hf(path_or_dict):
    """(TextConfig, MLAConfig, moe_cfg dict) of a DeepSeek-V3 config.json."""
    c = read_config(path_or_dict)
    text = from_hf_config(dict(c), model_type="deepseek_v3")
    mla = MLAConfig(
        q_lora_rank=c.get("q_lora_rank"),
        kv_lora_rank=c.get("kv_lora_rank", 512),
        qk_nope_head_dim=c.get("qk_nope_head_dim", 128),
        qk_rope_head_dim=c.get("qk_rope_head_dim", 64),
        v_head_dim=c.get("v_head_dim", 128),
        rope_interleave=c.get("rope_interleave", True),
    )
    moe_cfg = dict(
        n_routed_experts=c.get("n_routed_experts", 0),
        num_experts_per_tok=c.get("num_experts_per_tok", 8),
        n_group=c.get("n_group", 1),
        topk_group=c.get("topk_group", 1),
        norm_topk_prob=c.get("norm_topk_prob", True),
        routed_scaling_factor=c.get("routed_scaling_factor", 1.0),
        n_shared_experts=c.get("n_shared_experts", 0),
        first_k_dense_replace=c.get("first_k_dense_replace", 0),
        moe_intermediate_size=c.get("moe_intermediate_size", c.get("intermediate_size")),
    )
    return text, mla, moe_cfg


def minicpm3_config_from_hf(path_or_dict):
    """MiniCPM3: MLA attention with a dense MLP and MiniCPM's residual,
    embedding and logit scalings (its LongRope scaling is not read)."""
    c = read_config(path_or_dict)
    text, mla, moe_cfg = deepseek_config_from_hf(c)
    sd = float(c.get("scale_depth", 1.0))
    text = text.replace(
        model_type="minicpm3",
        residual_multiplier=sd / math.sqrt(c.get("num_hidden_layers", 1)),
        embedding_multiplier=float(c.get("scale_emb", 1.0)),
        logit_divisor=float(c.get("hidden_size", 1)) / float(c.get("dim_model_base", c.get("hidden_size", 1))),
    )
    moe_cfg["n_routed_experts"] = 0  # minicpm3 is dense
    return text, mla, moe_cfg


# the port's names in an MLA block -> the checkpoint's under model.layers.{i}.
_HF_NAMES = {"input_norm": "input_layernorm", "post_attn_norm": "post_attention_layernorm",
             "attn.q_a": "self_attn.q_a_proj", "attn.q_a_norm": "self_attn.q_a_layernorm",
             "attn.q_b": "self_attn.q_b_proj", "attn.q_full": "self_attn.q_proj",
             "attn.kv_a": "self_attn.kv_a_proj_with_mqa", "attn.kv_a_norm": "self_attn.kv_a_layernorm",
             "attn.kv_b": "self_attn.kv_b_proj", "attn.o_proj": "self_attn.o_proj",
             "mlp.router.weight": "mlp.gate.weight", "mlp.router.bias": "mlp.gate.e_score_correction_bias",
             "mlp.shared": "mlp.shared_experts", "mlp": "mlp"}
_EXPERTS = ("mlp.experts.{e}.gate_proj.weight", "mlp.experts.{e}.up_proj.weight", "mlp.experts.{e}.down_proj.weight")


def _checkpoint_name(key: str) -> str:
    """A state-dict key of DeepseekForCausalLM -> its HF checkpoint name."""
    if not key.startswith("blocks."):
        return {"embed_tokens.weight": "model.embed_tokens.weight", "norm.weight": "model.norm.weight"}.get(key, key)
    _, i, rest = key.split(".", 2)
    for port in sorted(_HF_NAMES, key=len, reverse=True):
        if rest == port or rest.startswith(port + "."):
            return f"model.layers.{i}.{_HF_NAMES[port]}{rest[len(port):]}"
    raise KeyError(key)


def load_deepseek(loader, text: TextConfig, mla: MLAConfig, moe_cfg: dict, *, device,
                  dtype=torch.bfloat16) -> DeepseekForCausalLM:
    """A DeepSeek-V3 or MiniCPM3 checkpoint (HF names); q_a, kv_a and o_proj
    take biases where the checkpoint has them; the router stays f32."""
    model = DeepseekForCausalLM(
        text, mla, moe_cfg, device=device, dtype=dtype,
        lm_head=not text.tie_word_embeddings and "lm_head.weight" in loader,
        attention_bias="model.layers.0.self_attn.kv_a_proj_with_mqa.bias" in loader)
    state = {}
    for key, t in model.state_dict().items():
        if key.rsplit(".", 1)[-1] in ("w_gate", "w_up", "w_down"):
            continue
        a = loader.load(_checkpoint_name(key), tuple(t.shape), np.float32)
        state[key] = torch.from_numpy(np.array(a, np.float32)).to(device=device, dtype=t.dtype)
    for i, blk in enumerate(model.blocks):
        if isinstance(blk.mlp, DeepseekMoE):
            e, ff = blk.mlp.w_gate.shape[0], blk.mlp.w_gate.shape[2]
            stacks = stack_experts(loader, f"model.layers.{i}.", _EXPERTS, e, text.hidden_size, ff, dtype)
            for name, w in zip(("w_gate", "w_up", "w_down"), stacks):
                state[f"blocks.{i}.mlp.{name}"] = w.to(device)
    model.load_state_dict(state, strict=True)
    return model
