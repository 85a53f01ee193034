"""The rank side of the port's multi-rank CPU tests: a gloo world spawned
once per test file, and the cases each rank runs in it.

This module imports neither JAX nor mllm_tpu: the spawned ranks import it
by name. Weights and inputs come from the test process as numpy (a JAX
model's parameters, bridged here into the port); every case holds the
multi-rank result against the port's single-process result on the same
rank, and hands back what the test process compares with JAX.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

CPU = torch.device("cpu")


WORLD_TIMEOUT_S = 300  # the whole world's run; a collective gives up after COLLECTIVE_TIMEOUT_S
COLLECTIVE_TIMEOUT_S = 120


def run_world(fn, n: int, *args) -> dict:
    """Spawn n gloo ranks (file:// rendezvous in a fresh temporary
    directory), run fn(rank, n, *args) on each, and return rank 0's result.
    A world that has not finished after WORLD_TIMEOUT_S is killed and the
    call raises."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "result.pkl")
        ctx = torch.multiprocessing.start_processes(
            _entry, ("file://" + os.path.join(tmp, "rendezvous"), out, fn, n, args), nprocs=n,
            start_method="spawn", join=False)
        deadline = time.monotonic() + WORLD_TIMEOUT_S
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"{fn.__name__}: the {n}-rank world did not finish in {WORLD_TIMEOUT_S} s")
        with open(out, "rb") as f:
            return pickle.load(f)


def _entry(rank, init, out, fn, n, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=n, rank=rank,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        res = fn(rank, n, *args)
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(res, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def member(mesh) -> bool:
    return mesh.get_coordinate() is not None


def rel(a, b) -> float:
    """max |a - b| / max |b|."""
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def port_model(params: dict, cfg_kw: dict, lora_scale=None):
    from mllm_tpu_torch.core.config import TextConfig
    from mllm_tpu_torch.models.bridge import causal_lm_from_jax_params

    return causal_lm_from_jax_params(params, TextConfig(**cfg_kw), CPU, torch.float32, lora_scale=lora_scale)


def gathered_state(model, mesh) -> dict:
    """The full-size state dict (the unsharded model's names) of a model
    from `shard_model`: column-parallel rows, row-parallel columns and the
    vocab-parallel table all-gathered over tp."""
    from mllm_tpu_torch.parallel.comm import axis_group, axis_size
    from mllm_tpu_torch.parallel.sharding import (ColumnParallelLinear, RowParallelLinear,
                                                  VocabParallelEmbedding)

    n, group = axis_size(mesh, "tp"), axis_group(mesh, "tp")

    def gather(t, dim):
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.detach().contiguous(), group=group)
        return torch.cat(parts, dim)

    out = {}
    for name, mod in model.named_modules():
        pre = name + "." if name else ""
        if isinstance(mod, ColumnParallelLinear):
            out[pre + "weight"] = gather(mod.inner.weight, 0)
            if mod.inner.bias is not None:
                out[pre + "bias"] = gather(mod.inner.bias, 0)
        elif isinstance(mod, RowParallelLinear):
            out[pre + "weight"] = gather(mod.inner.weight, 1)
            if mod.bias is not None:
                out[pre + "bias"] = mod.bias.detach()
        elif isinstance(mod, VocabParallelEmbedding):
            out[pre + "weight"] = gather(mod.weight, 0)
    covered = {k.rsplit(".", 1)[0] for k in out}
    for name, p in model.named_parameters():
        if ".inner." in name or name.rsplit(".", 1)[0] in covered:
            continue
        out[name] = p.detach()
    return out


def state_err(got: dict, want: dict) -> float:
    """Largest max|got - want| / max|want| over the parameters of `want`."""
    missing = set(want) - set(got)
    if missing:
        raise KeyError(f"not in the sharded state: {sorted(missing)}")
    return max(rel(got[k], want[k]) for k in want)


def _greedy(model, ids: np.ndarray, steps: int, max_len: int) -> np.ndarray:
    """Single-process greedy tokens, the way the JAX tests make them."""
    with torch.no_grad():
        cache = model.init_cache(ids.shape[0], max_len, torch.float32)
        logits, cache = model(torch.as_tensor(ids), cache, last_only=True)
        out = [logits[:, -1].argmax(-1)]
        for _ in range(steps - 1):
            logits, cache = model(out[-1][:, None], cache, last_only=True)
            out.append(logits[:, -1].argmax(-1))
    return torch.stack(out, 1).numpy()


# ---------------------------------------------------------------------------
# tests/test_torch_tp.py
# ---------------------------------------------------------------------------


def tp_cases(rank, n, models: dict, inputs: dict) -> dict:
    """Tensor and data parallelism on 4 ranks (sub-meshes of 2 on ranks 0-1)."""
    import logging

    from mllm_tpu_torch.generation.engine import ContinuousEngine, collect
    from mllm_tpu_torch.ops.quantize_model import quantize_model
    from mllm_tpu_torch.parallel.heads import pad_heads_for_tp
    from mllm_tpu_torch.parallel.multihost import host_local_batch, hybrid_mesh, process_batch_slice
    from mllm_tpu_torch.parallel.sharding import (make_mesh, sgd_train_step, shard_batch, shard_cache,
                                                  shard_model, sharded_generate)
    from mllm_tpu_torch.training import TrainState, add_lora, lora_params_filter, make_train_step

    res = {}
    tiny = lambda: port_model(*models["tiny"])  # noqa: E731

    # the tp=4 forward (prefill + a decode step) against the unsharded model
    mesh4 = make_mesh(dp=1, tp=4, device="cpu")
    ids = inputs["fwd_ids"]
    with torch.no_grad():
        base = tiny()
        ref_c = base.init_cache(2, 16, torch.float32)
        ref1, ref_c = base(torch.as_tensor(ids), ref_c, last_only=True)
        ref2, _ = base(ref1[:, -1].argmax(-1)[:, None], ref_c, last_only=True)
        sm = shard_model(pad_heads_for_tp(tiny(), 4), mesh4)
        cache = shard_cache(pad_heads_for_tp(tiny(), 4).init_cache(2, 16, torch.float32), mesh4)
        got1, cache = sm(torch.as_tensor(ids), cache, last_only=True)
        got2, _ = sm(got1[:, -1].argmax(-1)[:, None], cache, last_only=True)
    res["tp4_forward_err"] = max(rel(got1, ref1), rel(got2, ref2))
    res["tp4_local_kv_heads"] = sm.cfg.num_key_value_heads

    # one dp x tp SGD step: loss and every updated parameter
    mesh22 = make_mesh(dp=2, tp=2, device="cpu")
    ids, tgt = inputs["train_ids"], inputs["train_tgt"]
    plain, plain_loss = sgd_train_step(tiny(), torch.as_tensor(ids), torch.as_tensor(tgt), lr=1e-2)
    sharded = shard_model(tiny(), mesh22)
    sharded, loss = sgd_train_step(sharded, shard_batch(ids, mesh22), shard_batch(tgt, mesh22), lr=1e-2)
    res["sgd_loss"] = (float(loss), float(plain_loss))
    res["sgd_state_err"] = state_err(gathered_state(sharded, mesh22), plain.state_dict())
    losses = []
    m = shard_model(tiny(), mesh22)
    for _ in range(4):
        m, l2 = sgd_train_step(m, shard_batch(ids, mesh22), shard_batch(tgt, mesh22), lr=1e-1)
        losses.append(float(l2))
    res["sgd_losses"] = losses

    # sharded LoRA fine-tuning (dp x tp, AdamW on the adapters) against one process
    def lora_run(model, ids_, tgt_, mesh=None):
        add_lora(model, torch.Generator().manual_seed(9), rank=4)
        if mesh is not None:  # adapters first, then the shard (as the JAX test)
            model = shard_model(model, mesh)
        state = TrainState.create(model, lambda ps: torch.optim.AdamW(ps, lr=3e-3, betas=(0.9, 0.999), eps=1e-8,
                                                                    weight_decay=1e-4), lora_params_filter)
        step = make_train_step(trainable=lora_params_filter)
        for _ in range(3):
            state, lo = step(state, ids_, tgt_)
        return state.model, float(lo)

    try:  # adapters go on before the shard
        add_lora(shard_model(tiny(), mesh22), torch.Generator().manual_seed(9), rank=4)
        res["add_lora_on_shard_raises"] = False
    except ValueError as e:
        res["add_lora_on_shard_raises"] = "tensor-parallel shard" in str(e)
    lp, lp_loss = lora_run(tiny(), torch.as_tensor(ids), torch.as_tensor(tgt))
    ls, ls_loss = lora_run(tiny(), shard_batch(ids, mesh22), shard_batch(tgt, mesh22), mesh22)
    res["lora_loss"] = (ls_loss, lp_loss)
    res["lora_state_err"] = state_err(gathered_state(ls, mesh22), lp.state_dict())

    # sharded_generate at the flagship head ratio (12 q / 2 kv): tp 2 and 4, no dropped sharding
    records = []
    handler = logging.Handler()
    handler.emit = lambda rec: records.append(rec.getMessage())
    logging.getLogger("mllm_tpu_torch").addHandler(handler)
    flag = lambda: port_model(*models["flagship"])  # noqa: E731
    gids = inputs["gen_ids"]
    res["gen_single"] = _greedy(flag(), gids, 8, 64)
    mesh2 = make_mesh(dp=1, tp=2, device="cpu")
    if member(mesh2):
        res["gen_tp2"] = sharded_generate(flag(), gids, mesh2, 8, 64).numpy()
    res["gen_tp4"] = sharded_generate(flag(), gids, mesh4, 8, 64).numpy()
    logging.getLogger("mllm_tpu_torch").removeHandler(handler)
    res["gen_dropped_warnings"] = sum("sharding dropped" in r for r in records)
    padded = pad_heads_for_tp(flag(), 4)
    res["gen_tp4_cache_heads"] = shard_cache(padded.init_cache(2, 64, torch.float32), mesh4).k.shape[2]

    # the int8 model under tp=2
    qids = inputs["quant_ids"]
    qmodel = lambda: quantize_model(tiny(), "int8", min_size=1, quant_embed_head=False)  # noqa: E731
    res["quant_single"] = _greedy(qmodel(), qids, 6, 64)
    if member(mesh2):
        qs = shard_model(qmodel(), mesh2)
        res["quant_leaf_cols"] = (qs.blocks[0].mlp.gate_proj.inner.qweight_t.shape[1],
                                  qmodel().blocks[0].mlp.gate_proj.qweight_t.shape[1])
        res["quant_tp2"] = sharded_generate(qmodel(), qids, mesh2, 6, 64).numpy()

    # W8A8 under tp=2: the row-parallel prefill products quantize x with the whole row's amax
    from mllm_tpu_torch.parallel.sharding import RowParallelLinear

    a8model = lambda: quantize_model(tiny(), "int8-a8", min_size=1, quant_embed_head=False)  # noqa: E731
    res["a8_single"] = _greedy(a8model(), qids, 6, 64)
    if member(mesh2):
        calls = []
        a8 = RowParallelLinear._a8
        RowParallelLinear._a8 = lambda self, x: calls.append(1) or a8(self, x)
        try:
            with torch.no_grad():
                ref = a8model()
                want, _ = ref(torch.as_tensor(qids), ref.init_cache(2, 16, torch.float32), last_only=False)
                sm = shard_model(a8model(), mesh2)
                got, _ = sm(torch.as_tensor(qids), shard_cache(a8model().init_cache(2, 16, torch.float32), mesh2),
                            last_only=False)
            res["a8_prefill_err"] = rel(got, want)
            res["a8_row_calls"] = len(calls)
            res["a8_tp2"] = sharded_generate(a8model(), qids, mesh2, 6, 64).numpy()
        finally:
            RowParallelLinear._a8 = a8

    # the continuous-batching engine over tp 2 (and 4, heads padded)
    prompts = inputs["engine_prompts"]

    def engine_run(model, mesh):
        eng = ContinuousEngine(model, slots=2, max_len=64, prompt_bucket=16, kv_dtype=torch.float32,
                               start_thread=False, decode_window=4, mesh=mesh)
        qs = [eng.submit(p, 5) for p in prompts]
        for _ in range(20):
            eng.step()
        return [collect(q, timeout=5) for q in qs]

    eng_model = lambda: port_model(*models["engine"])  # noqa: E731
    res["engine_single"] = engine_run(eng_model(), None)
    for tp, mesh in ((2, mesh2), (4, mesh4)):
        if member(mesh):
            toks = engine_run(shard_model(pad_heads_for_tp(eng_model(), tp), mesh), mesh)
            every = [None] * tp
            dist.all_gather_object(every, toks, group=mesh.get_group(1))
            res[f"engine_tp{tp}"] = toks
            res[f"engine_tp{tp}_ranks_agree"] = all(t == toks for t in every)
    res.update(tp_paged_and_vl_cases(models, inputs, mesh2, mesh4))
    res.update(tp_int4_cases(models, inputs, mesh2, mesh4))

    # the hybrid mesh (dp between hosts, tp inside) and the per-rank batch
    hm = hybrid_mesh(ici={"tp": 2}, dcn={"dp": 2}, device="cpu")
    res["hybrid_dims"] = (hm.mesh_dim_names, tuple(hm.shape))
    hids = inputs["hybrid_ids"]
    rows = process_batch_slice(hids.shape[0], mesh=hm)
    gb = host_local_batch(hids[rows], hm, "dp")
    tg = host_local_batch(np.roll(hids, -1, axis=1)[rows], hm, "dp")
    _, hloss = sgd_train_step(shard_model(port_model(*models["hybrid"]), hm), gb, tg)
    res["hybrid_loss"] = float(hloss)
    res["hybrid_rows"] = (rows.start, rows.stop)
    try:
        hybrid_mesh(ici={"tp": 16}, dcn={"dp": 2}, device="cpu")
        res["hybrid_too_big_raises"] = False
    except ValueError:
        res["hybrid_too_big_raises"] = True
    return res


def _agree(value, mesh) -> bool:
    """True when every rank of `mesh`'s tp group holds `value` equal to this rank's."""
    every = [None] * mesh.size(1)
    dist.all_gather_object(every, value, group=mesh.get_group(1))
    return all(v == value for v in every)


def _raises(fn):
    """The message of the ValueError fn() raises, or None when it returns."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def tp_paged_and_vl_cases(models: dict, inputs: dict, mesh2, mesh4) -> dict:
    """The engine under tp over a paged pool (tp 2 and 4, heads padded; a
    one-block pool that requeues) and with image requests (a Qwen2-VL at tp
    2, its tower whole; f32 and int8 slot caches), against the
    single-process engines; the ranks' tokens, block tables and request
    numbers compared; the head check and the pool's cut."""
    from mllm_tpu_torch.core.param_loader import SafetensorsLoader
    from mllm_tpu_torch.generation.engine import ContinuousEngine, collect
    from mllm_tpu_torch.kv.cache import PagedKVCache
    from mllm_tpu_torch.models import qwen2_vl as tvl
    from mllm_tpu_torch.parallel.comm import axis_rank
    from mllm_tpu_torch.parallel.heads import pad_heads_for_tp
    from mllm_tpu_torch.parallel.sharding import shard_model, shard_slot_cache
    from mllm_tpu_torch.processor.qwen2_vl import Qwen2VLProcessorOutput

    res = {}
    eng_model = lambda: port_model(*models["engine"])  # noqa: E731

    # a paged pool: every step's block table recorded, to compare the ranks'
    def paged_run(model, mesh, pool):
        eng = ContinuousEngine(model, slots=2, max_len=64, prompt_bucket=16, kv_dtype=torch.float32,
                               start_thread=False, decode_window=4, paged=pool, mesh=mesh)
        qs = [eng.submit(p, 5) for p in inputs["paged_prompts"]]
        tables = []
        for _ in range(24):
            eng.step()
            tables.append(eng.cache.table_host.tolist())
        return [collect(q, timeout=5) for q in qs], eng.requeued, tables, eng.cache.k_store.shape[2]

    for pool in (1, 4):
        res[f"paged_single_{pool}"], res[f"paged_single_{pool}_requeued"], _, _ = paged_run(eng_model(), None, pool)
    for tp, mesh, pool in ((2, mesh2, 4), (2, mesh2, 1), (4, mesh4, 1)):
        if member(mesh):
            toks, requeued, tables, heads = paged_run(shard_model(pad_heads_for_tp(eng_model(), tp), mesh), mesh,
                                                      pool)
            key = f"paged_tp{tp}_{pool}"
            res[key], res[key + "_requeued"], res[key + "_pool_heads"] = toks, requeued, heads
            res[key + "_ranks_agree"] = _agree((toks, requeued, tables), mesh)
    # the pool cut by shard_slot_cache: kv heads over tp, the table and heads shared
    if member(mesh2):
        full = PagedKVCache.init(2, 2, 64, 4, 16, device=CPU, dtype=torch.float32, n_blocks=3)
        full.k_store.copy_(torch.arange(full.k_store.numel(), dtype=torch.float32).reshape(full.k_store.shape))
        cut = shard_slot_cache(full, mesh2)
        r = axis_rank(mesh2, "tp")
        res["paged_cut"] = dict(shape=tuple(cut.k_store.shape),
                                equal=torch.equal(cut.k_store, full.k_store[:, :, 2 * r:2 * r + 2]),
                                shared=(cut.table is full.table, cut.pos is full.pos,
                                        cut.table_host is full.table_host))

    # the head check: 12 q / 2 kv heads at tp 4 without pad_heads_for_tp
    res["shard_12_2_tp4"] = _raises(lambda: shard_model(port_model(*models["flagship"]), mesh4))

    # image and text requests through a tiny Qwen2-VL (tower whole, LM at tp 2)
    d = inputs["vl_dir"]
    vl = lambda: tvl.load_qwen2_vl(SafetensorsLoader(d), tvl.qwen2_vl_config_from_hf(d), device=CPU,  # noqa: E731
                                   dtype=torch.float32)
    ids, patches, grid, pos, delta = inputs["vl_request"]
    text = inputs["vl_text"]

    def vl_run(model, mesh, kv, order):
        eng = ContinuousEngine(model, slots=2, max_len=64, prompt_bucket=16, start_thread=False, eos_token_id=-7,
                               decode_window=2, kv_dtype=torch.float32 if kv == "f32" else kv, mesh=mesh)
        admitted = []
        install = eng._install
        eng._install = lambda slot, r, tok: (admitted.append((r.seq, r.vl is not None)), install(slot, r, tok))
        qs = [eng.submit_vl(Qwen2VLProcessorOutput(ids, patches, grid, pos, delta), 5) if kind == "image"
              else eng.submit(text, 5) for kind in order]
        for _ in range(12):
            eng.step()
        return [collect(q, timeout=5) for q in qs], admitted, eng.cache.k.shape[2]

    res["vl_tp4_raises"] = _raises(lambda: shard_model(vl(), mesh4))
    orders = {"f32": ("text", "image", "text"), "int8": ("image", "text")}
    for kv, order in orders.items():
        res[f"vl_single_{kv}"], _, _ = vl_run(vl(), None, kv, order)
    if member(mesh2):
        base = vl()
        svl = shard_model(base, mesh2)
        res["vl_shard"] = dict(local_heads=(svl.cfg.text.num_attention_heads, svl.cfg.text.num_key_value_heads),
                               tower_shared=svl.visual is base.visual,
                               full_heads=(base.cfg.text.num_attention_heads, base.cfg.text.num_key_value_heads))
        for kv, order in orders.items():
            toks, admitted, heads = vl_run(svl, mesh2, kv, order)
            res[f"vl_tp2_{kv}"], res[f"vl_tp2_{kv}_admitted"], res[f"vl_tp2_{kv}_cache_heads"] = toks, admitted, heads
            res[f"vl_tp2_{kv}_ranks_agree"] = _agree((toks, admitted), mesh2)
    return res


def int4_leaf_cuts(model, whole) -> dict:
    """(this rank's size, the whole's) of every int4 leaf that shard_model
    cuts, in natural channels: output channels of the column cuts (q/k/v,
    the head's proj, the fused MLP's gate and up), live input channels of
    the row cuts (o_proj, the fused MLP's down rows). o_proj's input
    channels are read from its operands: those of the groups whose scale is
    nonzero somewhere (canonical padding and a pad head's rows have none)."""
    def live_k(lin):
        return lin.group * int(lin.scales_t.ne(0).any(1).sum())

    out = {}
    for i, (blk, wb) in enumerate(zip(model.blocks, whole.blocks)):
        for name in ("q_proj", "k_proj", "v_proj"):
            out[f"{i}.{name}"] = (getattr(blk.attn, name).inner.packed_t.shape[1],
                                  getattr(wb.attn, name).packed_t.shape[1])
        out[f"{i}.o_proj"] = (live_k(blk.attn.o_proj.inner), live_k(wb.attn.o_proj))
        mine, theirs = blk.mlp.inner, wb.mlp
        out[f"{i}.gate_ops"] = (mine.gate_ops.astuple()[0].shape[1], theirs.gate_ops.astuple()[0].shape[1])
        out[f"{i}.down_ops"] = (mine.down_ops.astuple()[0].shape[0], theirs.down_ops.astuple()[0].shape[0])
    out["head.proj"] = (model.embed_tokens.proj.packed_t.shape[1], whole.embed_tokens.proj.packed_t.shape[1])
    out["head.rows"] = (model.embed_tokens.weight.shape[0], whole.embed_tokens.weight.shape[0])
    return out


def tp_int4_cases(models: dict, inputs: dict, mesh2, mesh4) -> dict:
    """int4 weights under tp on the canonical layout: the int4 model (every
    projection int4, one FusedInt4MLP a block, the tied Int4EmbedHead) at tp 2
    and at tp 4 with its 12 / 2 heads padded (`pad_heads_for_tp` on int4):
    each rank's share of every cut leaf, sharded_generate against the single
    process, the engine over slot caches (tp 2) and a paged pool (tp 4)
    against the single engines; the int4-mixed model (attention int8) once
    through each; and the tiny model in int4, whose o_proj K / tp (32) is no
    multiple of 64: the warning, that block's attention whole, its MLP cut."""
    import logging

    from mllm_tpu_torch.generation.engine import ContinuousEngine, collect
    from mllm_tpu_torch.nn.layers import Int4Linear
    from mllm_tpu_torch.ops.quantize_model import quantize_model
    from mllm_tpu_torch.parallel.heads import pad_heads_for_tp
    from mllm_tpu_torch.parallel.sharding import shard_model, sharded_generate

    res = {}
    ids, steps = inputs["int4_ids"], 6
    quant = lambda mode: quantize_model(port_model(*models["int4"]), "int4", min_size=1,  # noqa: E731
                                        attn_quant="int8" if mode == "int4-mixed" else None)

    def engine_run(model, mesh, paged):
        eng = ContinuousEngine(model, slots=2, max_len=64, prompt_bucket=16, kv_dtype=torch.float32,
                               start_thread=False, decode_window=4, paged=paged, mesh=mesh)
        qs = [eng.submit(p, 5) for p in inputs["int4_prompts"]]
        for _ in range(24):
            eng.step()
        return [collect(q, timeout=5) for q in qs], eng.requeued

    for mode in ("int4", "int4-mixed"):
        res[f"{mode}_single"] = _greedy(quant(mode), ids, steps, 64)
        for tp, mesh in ((2, mesh2), (4, mesh4)):
            if member(mesh):
                res[f"{mode}_tp{tp}"] = sharded_generate(quant(mode), ids, mesh, steps, 64).numpy()
        runs = (("slot", 0, 2, mesh2), ("paged", 1, 4, mesh4)) if mode == "int4" else (("slot", 0, 2, mesh2),)
        for kind, pool, tp, mesh in runs:
            res[f"{mode}_engine_{kind}_single"] = engine_run(quant(mode), None, pool)
            if member(mesh):
                got = engine_run(shard_model(pad_heads_for_tp(quant(mode), tp), mesh), mesh, pool)
                res[f"{mode}_engine_{kind}_tp{tp}"] = got
                res[f"{mode}_engine_{kind}_tp{tp}_ranks_agree"] = _agree(got, mesh)
    for tp, mesh in ((2, mesh2), (4, mesh4)):
        if member(mesh):
            whole = pad_heads_for_tp(quant("int4"), tp)
            res[f"int4_cuts_tp{tp}"] = int4_leaf_cuts(shard_model(whole, mesh), whole)

    # the tiny model in int4: o_proj K / tp = 64 / 2 is no multiple of 64
    records = []
    handler = logging.Handler()
    handler.emit = lambda rec: records.append(rec.getMessage())
    logging.getLogger("mllm_tpu_torch").addHandler(handler)
    tiny4 = lambda: quantize_model(port_model(*models["tiny"]), "int4", min_size=1)  # noqa: E731
    res["tiny_int4_single"] = _greedy(tiny4(), inputs["quant_ids"], steps, 64)
    if member(mesh2):
        sm = shard_model(tiny4(), mesh2)
        res["tiny_int4_tp2"] = sharded_generate(tiny4(), inputs["quant_ids"], mesh2, steps, 64).numpy()
        res["tiny_int4_kept"] = (type(sm.blocks[0].attn.o_proj) is Int4Linear,
                                 type(sm.blocks[0].mlp.down_proj).__name__)
    logging.getLogger("mllm_tpu_torch").removeHandler(handler)
    res["tiny_int4_dropped"] = sum("sharding dropped" in r for r in records)
    return res


# ---------------------------------------------------------------------------
# tests/test_torch_pipeline_ep.py
# ---------------------------------------------------------------------------


def pipeline_ep_cases(rank, n, models: dict, inputs: dict) -> dict:
    """The GPipe pipeline (4 stages) and expert parallelism (4 and 2 ranks)."""
    from mllm_tpu_torch.core.config import TextConfig
    from mllm_tpu_torch.models.moe import MoEMLP
    from mllm_tpu_torch.parallel.comm import make_axis_mesh
    from mllm_tpu_torch.parallel.expert import moe_forward_ep
    from mllm_tpu_torch.parallel.pipeline import pipeline_forward, pipeline_lm_hidden, pipeline_lm_loss
    from mllm_tpu_torch.training.train import partition

    res = {}
    pp = make_axis_mesh("pp", 4, "cpu")
    ws, x = torch.as_tensor(inputs["stage_w"]), torch.as_tensor(inputs["stage_x"])
    with torch.no_grad():
        res["pipeline_forward"] = pipeline_forward(ws, x, lambda w, h: torch.tanh(h @ w), pp).numpy()

    model = port_model(*models["l4"])
    ids, tgt = torch.as_tensor(inputs["pp_ids"]), torch.as_tensor(inputs["pp_tgt"])
    with torch.no_grad():
        ref, _ = model.hidden_states(ids, None)
        got = pipeline_lm_hidden(model, ids, pp, n_microbatches=4)
    res["hidden_err"] = rel(got, ref)

    # the loss and every parameter's gradient (summed over the stages)
    params = partition(model)
    names = [k for k, _ in model.named_parameters()]
    want = model.loss(ids, tgt)
    g_want = torch.autograd.grad(want, params)
    loss = pipeline_lm_loss(model, ids, tgt, pp, n_microbatches=4)
    g = torch.autograd.grad(loss, params, allow_unused=True)
    g = [torch.zeros_like(p) if t is None else t.clone() for p, t in zip(params, g)]
    for t in g:
        dist.all_reduce(t)
    res["pp_loss"] = (float(loss), float(want))
    res["pp_grad_err"] = max(float((a - b).abs().max()) / float(b.abs().max().clamp_min(1e-30))
                             for a, b in zip(g, g_want))
    res["pp_grads"] = {k: t.numpy() for k, t in zip(names, g)}

    # 2 stages of 2 layers on ranks 0-1 (the JAX oracle's mesh)
    pp2 = make_axis_mesh("pp", 2, "cpu")
    if member(pp2):
        res["pp2_loss"] = float(pipeline_lm_loss(model, ids, tgt, pp2, n_microbatches=2))

    # expert parallelism: 4 experts over 4 and 2 ranks, against the MoE module
    e, d, ff, k = 4, 16, 32, 2
    cfg = TextConfig(vocab_size=8, hidden_size=d, intermediate_size=ff, num_hidden_layers=1,
                     num_attention_heads=1, num_key_value_heads=1, num_experts=e, num_experts_per_tok=k,
                     moe_norm_topk_prob=True, hidden_act="silu")
    moe = MoEMLP(cfg, device=CPU, dtype=torch.float32)
    with torch.no_grad():
        for name in ("router_weight", "w_gate", "w_up", "w_down"):
            getattr(moe, name).copy_(torch.as_tensor(inputs["moe"][name]))
    xm = torch.as_tensor(inputs["moe_x"])
    with torch.no_grad():
        want = moe(xm)
        res["ep4"] = moe_forward_ep(moe, xm, make_axis_mesh("ep", 4, "cpu")).numpy()
        ep2 = make_axis_mesh("ep", 2, "cpu")
        if member(ep2):
            res["ep2"] = moe_forward_ep(moe, xm, ep2).numpy()
    res["ep_module"] = want.numpy()
    # its gradient through the expert shards (summed over the ranks) against the module's
    xg = xm.clone().requires_grad_(True)
    for p in moe.parameters():
        p.requires_grad_(True)
    wrt = [xg, moe.w_gate, moe.w_down, moe.router_weight]
    gw = torch.autograd.grad(moe(xg).square().sum(), wrt)
    ge = torch.autograd.grad(moe_forward_ep(moe, xg, make_axis_mesh("ep", 4, "cpu")).square().sum(), wrt)
    summed = [t.clone() for t in ge[1:]]
    for t in summed:
        dist.all_reduce(t)
    res["ep_grad_err"] = max([rel(ge[0], gw[0])] + [rel(a, b) for a, b in zip(summed, gw[1:])])
    return res


# ---------------------------------------------------------------------------
# tests/test_torch_sequence_parallel.py
# ---------------------------------------------------------------------------


def sequence_cases(rank, n, models: dict, inputs: dict) -> dict:
    """Ring and Ulysses attention (4 and 2 ranks), alone and in the trunk."""
    from mllm_tpu_torch.nn.attention import sdpa
    from mllm_tpu_torch.parallel.comm import make_axis_mesh
    from mllm_tpu_torch.parallel.ring_attention import ring_attention
    from mllm_tpu_torch.parallel.ulysses import ulysses_attention
    from mllm_tpu_torch.training.train import partition

    res = {}
    sp = make_axis_mesh("sp", 4, "cpu")
    sp2 = make_axis_mesh("sp", 2, "cpu")

    def block(t, p, r):  # this rank's rows of the sequence axis (1)
        s = t.shape[1] // p
        return t[:, r * s:(r + 1) * s]

    def whole(t, mesh):  # the blocks of every rank of `mesh`, in order
        parts = [torch.empty_like(t) for _ in range(mesh.size(0))]
        dist.all_gather(parts, t.contiguous(), group=mesh.get_group(0))
        return torch.cat(parts, 1)

    q, k, v = (torch.as_tensor(inputs["ring_" + c]) for c in "qkv")
    for causal in (True, False):
        ref = sdpa(q, k.transpose(1, 2), v.transpose(1, 2), causal=causal)
        got = whole(ring_attention(block(q, 4, rank), block(k, 4, rank), block(v, 4, rank), sp, causal=causal), sp)
        res[f"ring_err_{causal}"] = rel(got, ref)
    # the ring's gradients (q, k, v) against sdpa's
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    want = torch.autograd.grad(sdpa(qg, kg.transpose(1, 2), vg.transpose(1, 2), causal=True).square().sum(),
                               [qg, kg, vg])
    out = ring_attention(block(qg, 4, rank), block(kg, 4, rank), block(vg, 4, rank), sp, causal=True)
    got = torch.autograd.grad(out.square().sum(), [qg, kg, vg])
    got = [t.clone() for t in got]
    for t in got:
        dist.all_reduce(t, group=sp.get_group(0))
    res["ring_grad_err"] = max(rel(a, b) for a, b in zip(got, want))

    for (p, h, hkv), mesh in zip(inputs["ulysses_cases"], (sp, sp)):
        uq, uk, uv = (torch.as_tensor(inputs[f"ul_{c}_{h}_{hkv}"]) for c in "qkv")
        ref = sdpa(uq, uk.transpose(1, 2), uv.transpose(1, 2), causal=True)
        got = whole(ulysses_attention(block(uq, p, rank), block(uk, p, rank), block(uv, p, rank), mesh), mesh)
        res[f"ulysses_err_{h}_{hkv}"] = rel(got, ref)

    # the trunk and the loss with sequence-parallel attention: 4 ranks, and 2 (the JAX oracle's mesh)
    model = port_model(*models["tiny"])
    ids = inputs["trunk_ids"]
    tgt = np.roll(ids, -1, axis=1)
    with torch.no_grad():
        ref, _ = model.hidden_states(torch.as_tensor(ids), None)
        ref_loss = model.loss(torch.as_tensor(ids), torch.as_tensor(tgt))
    for mode in ((), ("ulysses",)):
        for p, mesh in ((4, sp), (2, sp2)):
            if not member(mesh):
                continue
            ring = (mesh, "sp", *mode)
            bi, bt = torch.as_tensor(block(ids, p, rank)), torch.as_tensor(block(tgt, p, rank))
            with torch.no_grad():
                hid, _ = model.hidden_states(bi, None, ring=ring)
                res[f"trunk_err_{mode}_{p}"] = rel(whole(hid, mesh), ref)
                if p == 2:
                    res[f"trunk_{mode}_2"] = whole(hid, mesh).numpy()
                res[f"loss_{mode}_{p}"] = (float(model.loss(bi, bt, ring=ring)), float(ref_loss))
    # the ring loss's parameter gradients, summed over the ranks, against one process's
    params = partition(model)
    g_want = torch.autograd.grad(model.loss(torch.as_tensor(ids), torch.as_tensor(tgt)), params)
    bi, bt = torch.as_tensor(block(ids, 4, rank)), torch.as_tensor(block(tgt, 4, rank))
    for mode in ((), ("ulysses",)):
        g = torch.autograd.grad(model.loss(bi, bt, ring=(sp, "sp", *mode), remat=bool(mode)), params)
        g = [t.clone() for t in g]
        for t in g:
            dist.all_reduce(t, group=sp.get_group(0))
        res[f"loss_grad_err_{mode}"] = max(rel(a, b) for a, b in zip(g, g_want))
    return res
