"""Mixture-of-Experts: counterpart of `mllm_tpu/models/moe.py` (`MoEMLP`,
`QuantMoEMLP`, `_quant_expert_stack`, `load_moe_mlp`, and the MBP layer
`MBPMoEMLP` / `to_mbp` / `mbp_forward`, whose experts live in host memory:
`utils/mbp.py`).

A router (f32 logits, softmax, top-k with ties to the lower expert index, as
`jax.lax.top_k` gives them) picks k experts a token; the experts' gated FFNs
run in one of two branches, which keep the JAX branches' rounding points:

  - ragged (JAX `moe.py:104-117`): the [T*k] (token, expert) pairs sorted
    stably by expert, the rows gathered, the group sizes a scatter-add into
    zeros(E) (static size: no `bincount`), one grouped product a projection,
    an index copy back, and the combine `sum_k(y * p)` in the model dtype;
  - dense (JAX `moe.py:141-156`): every expert on every token (g, u and
    y_all in f32, act(g) * u rounded to the weight dtype), combined with the
    scattered probabilities in f32, then cast.

The counterpart of `jax.lax.ragged_dot` (an XLA op, not a Pallas kernel) is
the torch op `torch._grouped_mm` with the offsets `cumsum(group_sizes)` on
the device: nothing is read on the host, so a captured decode step may take
it. Its output has x's dtype (it takes no f32 `out_dtype` for bf16 inputs),
so the int8 experts' ragged branch, whose products JAX keeps in f32, loops
over the experts with the group sizes read on the host and runs the port's
`int8_matmul` kernel on each group (int8 bytes only, the JAX arithmetic: f32
products of bf16 x and the int8 weight, times the expert's per-channel
scale); it syncs once a layer, so a captured step takes the dense branch
instead.

`dense_branch(t, e, k, d, ff, quant)` is the rule between the branches: see
its docstring for the times it rests on.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..core.config import TextConfig
from ..kv.cache import _capturing
from ..nn.layers import ACT_FN, _param, matmul_f32, shallow_copy
from .transformer import MLP


# The cost model of `dense_branch`, fitted to the branch times of one layer
# that chip_smoke.py prints (`moe_branch` rows; NVIDIA H100 80GB HBM3,
# 700.00 W): fixed costs (launches, the ragged branch's sort, gathers and
# scatter) and effective product rates.
HBM_BYTES_PER_MS = 3.35e9
DENSE_FIXED_MS, RAGGED_FIXED_MS = 0.022, 0.064
DENSE_FLOP_PER_MS, RAGGED_FLOP_PER_MS = 300e9, 150e9
QUANT_DENSE_MAX_T = 1024  # int8 experts: the largest t measured, where dense was still 3.3x faster


def dense_branch(t: int, e: int, k: int, d: int, ff: int, quant: bool) -> bool:
    """Whether a call over t tokens runs every expert (dense) rather than the
    routed pairs (ragged), for e experts of width d x ff and top-k routing.

    bf16 experts: the branch of the smaller modelled time, each the larger of
    its bytes and its products over the rates above, plus its fixed cost:
      dense  = 0.022 ms + max(e experts' bytes / HBM, t e 6 d ff / 300 TFLOP/s)
      ragged = 0.064 ms + max(touched experts' bytes / HBM, t k 6 d ff / 150 TFLOP/s)
    with touched = e (1 - (1 - k / e)^t) the experts the t k draws are
    expected to reach. Measured one layer, graph replays (dense / ragged ms;
    chip_smoke.py `moe_branch` rows, t = 1, 2, 4, 8, 16, 32, 128, 1024):
      16 experts, top-4, 1024 x 512:  t=1 0.037 / 0.068, t=32 0.042 / 0.093,
                                      t=128 0.055 / 0.117, t=1024 0.228 / 0.179
      60 experts, top-4, 2048 x 1408: t=1 0.360 / 0.096, t=8 0.374 / 0.226,
                                      t=16 0.384 / 0.333, t=32 0.408 / 0.425,
                                      t=128 0.562 / 0.490, t=1024 2.432 / 0.588
    The model picks the faster branch at every measured point.

    int8 experts: dense up to QUANT_DENSE_MAX_T. Their ragged branch loops
    over the experts on the host (one sync, three launches an expert): 1.1 to
    22.9 ms a layer at t <= 32 and 11.5 ms at t=1024 (60 experts) where the
    dense branch took 0.72 to 0.82 and 3.52 ms; 16 experts: 1.3 to 4.5 ms and
    2.9 ms against 0.06 to 0.07 and 0.33 ms."""
    if quant:
        return t <= QUANT_DENSE_MAX_T
    expert_bytes, flop = 3 * d * ff * 2, 6 * d * ff  # one bf16 expert; one token through it
    touched = e * (1.0 - (1.0 - k / e) ** t)
    dense = DENSE_FIXED_MS + max(e * expert_bytes / HBM_BYTES_PER_MS, t * e * flop / DENSE_FLOP_PER_MS)
    ragged = RAGGED_FIXED_MS + max(touched * expert_bytes / HBM_BYTES_PER_MS, t * k * flop / RAGGED_FLOP_PER_MS)
    return dense <= ragged


def route(xf: torch.Tensor, router_weight: torch.Tensor, top_k: int, norm_topk_prob: bool):
    """(top_p f32 [T, k], top_i int64 [T, k]): softmax over f32 router logits,
    the k largest probabilities, ties to the lower expert index (a stable
    descending sort, as `jax.lax.top_k` orders them); renormalised in f32
    when norm_topk_prob."""
    probs = torch.softmax(matmul_f32(xf, router_weight), dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :top_k], top_i[:, :top_k]
    if norm_topk_prob:
        top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    return top_p, top_i


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [B, M, K] @ b [B, K, N] with an f32 result (f32 accumulation; the
    JAX `einsum(..., preferred_element_type=f32)`)."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def grouped_mm(xs: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """Rows [offs[e-1], offs[e]) of xs times w[e]: the `ragged_dot` of the
    JAX package (its output in xs's dtype, f32 accumulation)."""
    return torch._grouped_mm(xs, w.to(xs.dtype), offs=offs)


def ragged_experts(xf, top_p, top_i, n_experts: int, expert_ffn):
    """The ragged branch: the [T*k] routed (token, expert) pairs sorted
    stably by expert, the rows gathered, the group sizes a scatter-add into
    zeros(E) (static size, no host read), `expert_ffn(xs, sizes,
    expert_sorted)` over them, then unsorted and combined sum_k(y * p) in the
    product's dtype."""
    t, d = xf.shape
    k = top_i.shape[1]
    flat = top_i.reshape(-1)  # [T*k]
    order = torch.sort(flat, stable=True).indices
    xs = xf[order // k]  # [T*k, d]
    sizes = torch.zeros(n_experts, dtype=torch.int32, device=xf.device).scatter_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32))
    ys = expert_ffn(xs, sizes, flat[order])
    y_pairs = torch.empty_like(ys).index_copy_(0, order, ys).reshape(t, k, d)
    return (y_pairs * top_p[..., None].to(ys.dtype)).sum(dim=1)


def grouped_ffn(xs, sizes, w_gate, w_up, w_down, act: str):
    """The gated FFN of each expert over its rows of xs (rows grouped by
    expert, `sizes` [E] on the device): one grouped product a projection."""
    offs = torch.cumsum(sizes, 0, dtype=torch.int32)
    h = grouped_mm(xs, w_gate, offs)
    u = grouped_mm(xs, w_up, offs)
    return grouped_mm(ACT_FN[act](h) * u, w_down, offs)


class MoEMLP(nn.Module):
    """Top-k routed expert FFN with an optional shared expert (JAX `MoEMLP`).

    router_weight [E, d]; w_gate, w_up [E, d, ff]; w_down [E, ff, d];
    shared_expert an MLP of width moe_shared_expert_size; shared_gate [1, d]
    (qwen2_moe's sigmoid gate on the shared expert) or None."""

    def __init__(self, cfg: TextConfig, *, device, dtype, shared_gate: bool = False):
        super().__init__()
        e, d, ff = cfg.num_experts, cfg.hidden_size, cfg.intermediate_size
        kw = dict(device=device, dtype=dtype)
        self.router_weight = _param(e, d, **kw)
        self.w_gate = _param(e, d, ff, **kw)
        self.w_up = _param(e, d, ff, **kw)
        self.w_down = _param(e, ff, d, **kw)
        self.shared_expert = (MLP(cfg.replace(intermediate_size=cfg.moe_shared_expert_size, mlp_bias=False), **kw)
                              if cfg.moe_shared_expert_size else None)
        self.shared_gate = _param(1, d, **kw) if shared_gate else None
        self.top_k = cfg.num_experts_per_tok
        self.norm_topk_prob = cfg.moe_norm_topk_prob
        self.act = cfg.hidden_act

    def reset_parameters(self, generator: torch.Generator) -> None:
        """N(0, 0.02^2) for the router and the expert stacks (JAX
        `MoEMLP.init`); the shared expert's Linears are reset by the caller
        like every Linear."""
        for p in (self.router_weight, self.w_gate, self.w_up, self.w_down):
            p.normal_(0.0, 0.02, generator=generator)
        if self.shared_gate is not None:
            self.shared_gate.normal_(0.0, 0.02, generator=generator)

    @property
    def num_experts(self) -> int:
        return self.w_gate.shape[0]

    def forward(self, x):
        b, s, d = x.shape
        t, k, e = b * s, self.top_k, self.num_experts
        xf = x.reshape(t, d)
        top_p, top_i = route(xf, self.router_weight, k, self.norm_topk_prob)
        quant = isinstance(self, QuantMoEMLP)
        if dense_branch(t, e, k, d, self.w_gate.shape[-1], quant) or (quant and _capturing()):
            y = self._dense_all_experts(xf, top_p, top_i)
        else:
            y = self._ragged(xf, top_p, top_i)
        if self.shared_expert is not None:
            sh = self.shared_expert(xf)
            if self.shared_gate is not None:
                sh = sh * torch.sigmoid(matmul_f32(xf, self.shared_gate)).to(sh.dtype)
            y = y + sh
        return y.reshape(b, s, d).to(x.dtype)

    def _ragged(self, xf, top_p, top_i):
        return ragged_experts(xf, top_p, top_i, self.num_experts, self._expert_ffn)

    def _expert_ffn(self, xs, sizes, expert_sorted):
        return grouped_ffn(xs, sizes, self.w_gate, self.w_up, self.w_down, self.act)

    def _dense_probs(self, t, top_p, top_i):
        return torch.zeros(t, self.num_experts, dtype=torch.float32, device=top_p.device).scatter_(
            1, top_i, top_p)

    def _dense_all_experts(self, xf, top_p, top_i):
        t, d = xf.shape
        e = self.num_experts
        xc = xf.to(self.w_gate.dtype)[None].expand(e, t, d)
        g = bmm_f32(xc, self.w_gate)  # [E, T, ff]
        u = bmm_f32(xc, self.w_up)
        h = (ACT_FN[self.act](g) * u).to(self.w_down.dtype)
        yall = bmm_f32(h, self.w_down)  # [E, T, d]
        return torch.einsum("etd,te->td", yall, self._dense_probs(t, top_p, top_i)).to(xf.dtype)


@torch.no_grad()
def _quant_expert_stack(w: torch.Tensor):
    """float [..., E, K, N] -> (int8 [..., E, K, N], f32 scales [..., E, N]),
    per (expert, out-channel) symmetric; divides by amax / 127 as eager JAX
    does (bit-equal to it)."""
    wf = w.float()
    amax = wf.abs().amax(dim=-2)
    sc = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / sc[..., None, :]), -127, 127).to(torch.int8)
    return q, sc


class QuantMoEMLP(MoEMLP):
    """MoEMLP over int8 per-(expert, out-channel) expert stacks (JAX
    `QuantMoEMLP`): w_gate / w_up int8 [E, d, ff] with f32 s_gate / s_up
    [E, ff]; w_down int8 [E, ff, d] with s_down [E, d].

    The dense branch runs gate and up as ONE `int8_matmul` launch over the
    experts laid side by side (`w_gateup_t` int8 [d, 2 E ff], a buffer outside
    the state dict: the einsum td,edf->etf is one product against it), and
    down over a bf16 copy of w_down made for the call (XLA fuses that
    conversion into the einsum; here the copy costs 4x the int8 bytes more).
    Measured (graph replays, t <= 32; NVIDIA H100 80GB HBM3, 700.00 W):
    gate||up 0.016-0.020 ms against 0.062 ms for a bf16 copy (16 experts of
    1024 x 512), 0.127-0.191 against 1.36-1.38 ms (60 of 2048 x 1408); down
    over the copy 0.022 ms against 0.073-0.105 ms for one int8_matmul launch
    an expert (16), 0.573-0.583 against 0.409-0.553 ms (60), but the 60 launches cost
    ~6 ms a layer of host time on an eager step (Qwen1.5-MoE-A2.7B's int8
    b=1 decode: 5.6 tok/s), so down takes the copy. Its arithmetic is the
    JAX branch's: f32 products of bf16 x and the int8 values, times the
    scales."""

    def __init__(self, router_weight, w_gate, s_gate, w_up, s_up, w_down, s_down, top_k: int,
                 norm_topk_prob: bool, act: str, shared_expert=None, shared_gate=None):
        nn.Module.__init__(self)
        self.router_weight = nn.Parameter(router_weight, requires_grad=False)
        for name, t in (("w_gate", w_gate), ("s_gate", s_gate), ("w_up", w_up), ("s_up", s_up),
                        ("w_down", w_down), ("s_down", s_down)):
            self.register_buffer(name, t)
        self.shared_expert = shared_expert
        self.shared_gate = None if shared_gate is None else nn.Parameter(shared_gate, requires_grad=False)
        self.top_k, self.norm_topk_prob, self.act = top_k, norm_topk_prob, act
        self._side_by_side()

    def _side_by_side(self):
        e, d, ff = self.w_gate.shape
        wt = torch.cat([self.w_gate, self.w_up], dim=0).permute(1, 0, 2).reshape(d, 2 * e * ff)
        self.register_buffer("w_gateup_t", wt.contiguous(), persistent=False)
        self.register_buffer("s_gateup", torch.cat([self.s_gate, self.s_up]).reshape(-1).contiguous(),
                             persistent=False)

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        self._side_by_side()

    @staticmethod
    def from_moe(moe: MoEMLP) -> "QuantMoEMLP":
        (qg, sg), (qu, su), (qd, sd) = (_quant_expert_stack(w) for w in (moe.w_gate, moe.w_up, moe.w_down))
        return QuantMoEMLP(moe.router_weight.detach(), qg, sg, qu, su, qd, sd, moe.top_k,
                           moe.norm_topk_prob, moe.act, moe.shared_expert,
                           None if moe.shared_gate is None else moe.shared_gate.detach())

    def _expert_ffn(self, xs, sizes, expert_sorted):
        """One `int8_matmul` a projection and expert over its rows, the group
        sizes read on the host (one sync)."""
        from ..ops.quant_matmul import int8_matmul

        xb = xs.to(torch.bfloat16)
        ys = torch.empty(xs.shape, dtype=torch.float32, device=xs.device)
        start = 0
        for ex, n in enumerate(sizes.tolist()):
            if n:
                rows = xb[start : start + n]
                h = int8_matmul(rows, self.w_gate[ex], self.s_gate[ex])
                u = int8_matmul(rows, self.w_up[ex], self.s_up[ex])
                hu = (ACT_FN[self.act](h) * u).to(torch.bfloat16)
                ys[start : start + n] = int8_matmul(hu, self.w_down[ex], self.s_down[ex])
                start += n
        return ys.to(xs.dtype)

    def _dense_all_experts(self, xf, top_p, top_i):
        from ..ops.quant_matmul import int8_matmul

        t, d = xf.shape
        e, ff = self.num_experts, self.w_gate.shape[-1]
        gu = int8_matmul(xf.to(torch.bfloat16), self.w_gateup_t, self.s_gateup)  # [T, 2 E ff] f32
        gu = gu.reshape(t, 2, e, ff).permute(1, 2, 0, 3)  # [2, E, T, ff]
        h = (ACT_FN[self.act](gu[0]) * gu[1]).to(torch.bfloat16)
        yall = bmm_f32(h, self.w_down.to(torch.bfloat16)) * self.s_down[:, None, :]
        return torch.einsum("etd,te->td", yall, self._dense_probs(t, top_p, top_i)).to(xf.dtype)


def stack_experts(loader, prefix: str, names: tuple, e: int, d: int, ff: int, dtype):
    """Per-expert HF weights [ff, d] (gate, up) and [d, ff] (down) named
    prefix + names[i].format(e=j) -> stacks [E, d, ff], [E, d, ff], [E, ff, d]
    as torch tensors of `dtype` on the host."""
    g, u, dn = ([], [], [])
    for j in range(e):
        g.append(np.asarray(loader.load(prefix + names[0].format(e=j), (ff, d)), np.float32).T)
        u.append(np.asarray(loader.load(prefix + names[1].format(e=j), (ff, d)), np.float32).T)
        dn.append(np.asarray(loader.load(prefix + names[2].format(e=j), (d, ff)), np.float32).T)
    return tuple(torch.from_numpy(np.ascontiguousarray(np.stack(a))).to(dtype) for a in (g, u, dn))


def load_moe_mlp(loader, prefix: str, cfg: TextConfig, *, device, dtype=torch.bfloat16,
                 expert_names=("experts.{e}.gate_proj.weight", "experts.{e}.up_proj.weight",
                               "experts.{e}.down_proj.weight"),
                 router_name: str = "gate", shared_prefix: Optional[str] = None,
                 shared_gate_name: Optional[str] = None, quant: Optional[str] = None) -> MoEMLP:
    """A MoEMLP from per-expert HF weights, stacked at load (JAX
    `load_moe_mlp`; mixtral passes its w1 / w3 / w2 names). quant "int8",
    "int8-a8" or "int4" quantizes the expert stacks to int8 on the host
    (`_quant_expert_stack`) and the shared expert as `quantize_model` does
    (min_size 1: int8 Linears, or one FusedInt4MLP in "int4"). Any other
    quant ("int4-mixed") leaves the block float, as the JAX `load_moe_mlp`
    does; the mixtral builder passes "int4" for it (`registry.build_model`)."""
    d, e, ff = cfg.hidden_size, cfg.num_experts, cfg.intermediate_size
    shared = shared_prefix is not None and (prefix + shared_prefix + "gate_proj.weight") in loader
    sgate = shared and shared_gate_name is not None and (prefix + shared_gate_name + ".weight") in loader
    mcfg = cfg if shared else cfg.replace(moe_shared_expert_size=0)
    if shared and not cfg.moe_shared_expert_size:
        mcfg = cfg.replace(moe_shared_expert_size=ff)
    moe = MoEMLP(mcfg, device="meta", dtype=dtype, shared_gate=sgate)

    def host(name, shape):
        return torch.from_numpy(np.array(loader.load(name, shape, np.float32), np.float32)).to(dtype)

    state = {"router_weight": host(prefix + router_name + ".weight", (e, d))}
    state["w_gate"], state["w_up"], state["w_down"] = stack_experts(loader, prefix, expert_names, e, d, ff, dtype)
    if shared:
        sff = mcfg.moe_shared_expert_size
        sp = prefix + shared_prefix
        for name, shape in (("gate_proj", (sff, d)), ("up_proj", (sff, d)), ("down_proj", (d, sff))):
            state[f"shared_expert.{name}.weight"] = host(sp + name + ".weight", shape)
        if sgate:
            state["shared_gate"] = host(prefix + shared_gate_name + ".weight", (1, d))
    moe.load_state_dict(state, strict=True, assign=True)
    if quant in ("int8", "int8-a8", "int4"):
        from ..ops.quantize_model import quantize_model

        # the expert stacks quantize whatever their size (an explicit
        # per-model request); "int8-a8" gives plain int8 experts
        moe = quantize_model(moe, "int8" if quant == "int8-a8" else quant, min_size=1,
                             quant_embed_head=False)
    return moe.to(device)


# -- MBP: experts in host memory -------------------------------------------------


class MBPMoEMLP(nn.Module):
    """MoE FFN whose experts live in a host `HostExpertStore` (JAX
    `MBPMoEMLP`): each call routes on the device, copies only the routed
    experts (LRU-cached on the card) and prefetches them for the next layer.
    The router, the shared expert and its sigmoid gate stay on the device.

    Host-driven by construction (the routed set is read on the host), so it
    runs eagerly: a call inside a CUDA-graph capture raises, as the JAX layer
    raises under jit."""

    def __init__(self, router_weight, store, layer: int, n_layers: int, top_k: int, norm_topk_prob: bool,
                 act: str, shared_expert=None, shared_gate=None):
        super().__init__()
        self.router_weight = router_weight
        self.store = store
        self.layer, self.n_layers = layer, n_layers
        self.top_k, self.norm_topk_prob, self.act = top_k, norm_topk_prob, act
        self.shared_expert = shared_expert
        self.shared_gate = shared_gate

    def forward(self, x):
        if _capturing():
            raise RuntimeError("MBPMoEMLP routes data-dependently through a host expert store and cannot "
                               "run inside a CUDA-graph capture: call the model eagerly (mbp_forward)")
        from ..utils.mbp import mbp_moe_forward

        b, s, d = x.shape
        xf = x.reshape(b * s, d)
        y = mbp_moe_forward(xf, self.router_weight, self.store, self.layer, self.n_layers, self.top_k,
                            ACT_FN[self.act], norm_topk=self.norm_topk_prob)
        if self.shared_expert is not None:
            sh = self.shared_expert(xf)
            if self.shared_gate is not None:
                sh = sh * torch.sigmoid(matmul_f32(xf, self.shared_gate)).to(sh.dtype)
            y = y + sh.to(y.dtype)
        return y.reshape(b, s, d).to(x.dtype)


def _host_experts(mlp: MoEMLP, ei: int) -> tuple:
    """Expert ei's (gate [ff, d], up [ff, d], down [d, ff]) on the host, HF
    row-major; int8 experts dequantized to f32 (values times their
    per-out-channel scales)."""
    if isinstance(mlp, QuantMoEMLP):
        ws = ((mlp.w_gate, mlp.s_gate), (mlp.w_up, mlp.s_up), (mlp.w_down, mlp.s_down))
        return tuple((w[ei].float() * s[ei][None, :]).T.contiguous().cpu() for w, s in ws)
    return tuple(w[ei].T.contiguous().cpu() for w in (mlp.w_gate, mlp.w_up, mlp.w_down))


def to_mbp(model, max_device_entries: int = 16, device=None):
    """A loaded MoE model in MBP form (JAX `to_mbp`): every `MoEMLP` /
    `QuantMoEMLP` expert stack moves into one `HostExpertStore` (device: the
    model's by default) and the layer becomes an `MBPMoEMLP`. Returns
    (mbp_model, store); the source model is left as it was, the other
    tensors are shared. `store.hit_rate` reports the prefetch's hits."""
    from ..utils.mbp import HostExpertStore

    blocks = list(model.blocks)
    weights = {}
    for li, blk in enumerate(blocks):
        if isinstance(blk.mlp, MoEMLP):
            for ei in range(blk.mlp.num_experts):
                weights[(li, ei)] = _host_experts(blk.mlp, ei)
    if not weights:
        raise ValueError("model has no MoEMLP layers to offload")
    store = HostExpertStore(weights, device=device if device is not None else model.device,
                            max_device_entries=max_device_entries)
    new_blocks = []
    for li, blk in enumerate(blocks):
        mlp = blk.mlp
        if isinstance(mlp, MoEMLP):
            blk = shallow_copy(blk)
            blk.mlp = MBPMoEMLP(mlp.router_weight, store, li, len(blocks), mlp.top_k, mlp.norm_topk_prob,
                                mlp.act, mlp.shared_expert, mlp.shared_gate)
        new_blocks.append(blk)
    new = shallow_copy(model)
    new.blocks = nn.ModuleList(new_blocks)
    return new, store


def mbp_forward(model, ids, cache, last_only: bool = True):
    """Forward an MBP model (JAX `mbp_forward`): returns (logits, cache with
    its head advanced). The JAX package runs the dense halves of each block
    (embedding, attention half, residual, head) as one jitted program each;
    here they are the model's own eager calls, and only the expert streaming
    is host-driven."""
    return model(ids, cache, last_only=last_only)
