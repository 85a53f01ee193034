"""Multi-rank dry run of every parallel axis: counterpart of
`__graft_entry__.py:dryrun_multichip`.

    python -m mllm_tpu_torch.parallel.dryrun 8 --device cpu   # 8 gloo ranks on the CPU
    python -m mllm_tpu_torch.parallel.dryrun --device cuda    # 1 rank over NCCL on the card

`--device` has no default: the caller names the card or the CPU. Spawns an
n-rank world (gloo for the CPU, NCCL for the card, one GPU a rank) and in
it: a (dp, tp) mesh, the head padding, one training step (forward,
cross-entropy, gradients, SGD) over the sharded model, prefill and one
decode step over the sharded cache, `sharded_generate`, then the pipeline
(trunk and training loss with gradients), expert, ring and Ulysses sections
and the tensor-parallel engine. Prints one progress line per section and `dryrun OK: ...` at the
end; any failure exits non-zero.
"""

from __future__ import annotations

import argparse
import datetime
import os
import socket
import sys
import tempfile
import time

import numpy as np
import torch


def _progress(t0: float, msg: str) -> None:
    print(f"[dryrun +{time.perf_counter() - t0:6.1f}s] {msg}", file=sys.stderr, flush=True)


def _small_cfg(**kw):
    """The flagship head ratio (12 q / 2 kv, Qwen2-VL-2B's) at toy width, so
    the tp path runs the GQA expansion and head padding."""
    from ..core.config import TextConfig

    base = dict(vocab_size=512, hidden_size=192, intermediate_size=256, num_hidden_layers=2,
                num_attention_heads=12, num_key_value_heads=2, head_dim=16, max_position_embeddings=512,
                eos_token_id=511)
    return TextConfig(**{**base, **kw})


def _model(cfg, dev, seed: int):
    from ..models.transformer import CausalLM

    return CausalLM.init(cfg, device=dev, dtype=torch.float32,
                         generator=torch.Generator(device=dev).manual_seed(seed))


def _body(n: int, dev: torch.device) -> str:
    from ..generation.engine import ContinuousEngine, collect
    from ..models.moe import MoEMLP
    from .comm import make_axis_mesh
    from .expert import moe_forward_ep
    from .heads import pad_heads_for_tp
    from .pipeline import pipeline_lm_hidden, pipeline_lm_loss
    from .sharding import make_mesh, sgd_train_step, shard_batch, shard_model, sharded_forward, sharded_generate

    rank = torch.distributed.get_rank()
    t0 = time.perf_counter()
    say = (lambda msg: _progress(t0, msg)) if rank == 0 else (lambda msg: None)
    tp = next(c for c in (8, 4, 2, 1) if n % c == 0)
    dp = n // tp
    rng = np.random.default_rng(0)

    say("sec1: dp x tp train+infer")
    mesh = make_mesh(dp=dp, tp=tp, device=dev.type)
    model = shard_model(pad_heads_for_tp(_model(_small_cfg(), dev, 0), tp), mesh)
    b, s = 2 * dp, 64
    ids = shard_batch(rng.integers(0, 512, (b, s)), mesh)
    tgt = shard_batch(rng.integers(0, 512, (b, s)), mesh)
    model, loss = sgd_train_step(model, ids, tgt, lr=1e-3)
    if not torch.isfinite(loss):
        raise AssertionError(f"train loss {loss}")
    with torch.no_grad():
        cache = model.init_cache(ids.shape[0], 128, torch.float32)
        logits, cache = sharded_forward(model, ids, cache)
        tok = logits[:, -1].argmax(-1)[:, None]
        logits2, cache = sharded_forward(model, tok, cache)
    if tuple(logits2.shape) != (ids.shape[0], 1, 512):
        raise AssertionError(f"decode logits {tuple(logits2.shape)}")

    say("sec2b: tp generate")
    gen_mesh = make_mesh(dp=1, tp=tp, device=dev.type)
    base = _model(_small_cfg(), dev, 0)
    if _member(gen_mesh):
        toks = sharded_generate(base, np.ones((1, 8), np.int64), gen_mesh, max_new_tokens=4, max_len=64)
        if tuple(toks.shape) != (1, 4):
            raise AssertionError(f"sharded_generate tokens {tuple(toks.shape)}")

    say("sec3: DecoderBlock GPipe hidden")
    sub = min(4, n)  # the pipeline, expert and sequence axes' size, as in the JAX dry run
    pp_mesh = make_axis_mesh("pp", sub, dev.type)
    rng_pp = np.random.default_rng(1)
    pp_ids = torch.as_tensor(rng_pp.integers(0, 512, (4, 16)), device=dev)
    f_ids = torch.as_tensor(rng_pp.integers(0, 512, (2, 16)), device=dev)
    f_tgt = torch.as_tensor(rng_pp.integers(0, 512, (2, 16)), device=dev)
    if _member(pp_mesh):
        pp_model = _model(_small_cfg(num_hidden_layers=sub), dev, 1)
        with torch.no_grad():
            hid = pipeline_lm_hidden(pp_model, pp_ids, pp_mesh, n_microbatches=2)
        if tuple(hid.shape) != (4, 16, 192):
            raise AssertionError(f"pipeline hidden {tuple(hid.shape)}")

        say("sec3b: flagship-head GPipe train")
        fcfg = _small_cfg(vocab_size=512, hidden_size=1536, intermediate_size=512, num_hidden_layers=sub,
                          head_dim=128, max_position_embeddings=256, eos_token_id=-2)
        fmodel = _model(fcfg, dev, 2)
        params = [p.requires_grad_(True) for p in fmodel.parameters()]
        pl = pipeline_lm_loss(fmodel, f_ids, f_tgt, pp_mesh, n_microbatches=2)
        grads = torch.autograd.grad(pl, params, allow_unused=True)
        if not torch.isfinite(pl) or all(g is None for g in grads):
            raise AssertionError(f"pipeline loss {pl}")

    say("sec4: expert parallel")
    ep_mesh = make_axis_mesh("ep", sub, dev.type)
    e, dm, ff = sub * 2, 32, 64
    moe_cfg = _small_cfg(hidden_size=dm, intermediate_size=ff, num_experts=e, num_experts_per_tok=2,
                         moe_norm_topk_prob=True)
    moe = MoEMLP(moe_cfg, device=dev, dtype=torch.float32)
    moe.reset_parameters(torch.Generator(device=dev).manual_seed(3))
    xm = torch.randn(2, 4, dm, generator=torch.Generator(device=dev).manual_seed(4), device=dev)
    if _member(ep_mesh):
        with torch.no_grad():
            out_ep = moe_forward_ep(moe, xm, ep_mesh, axis="ep")
            want = moe(xm)
        if not torch.allclose(out_ep, want, rtol=2e-4, atol=2e-5):
            raise AssertionError(f"expert parallel off by {float((out_ep - want).abs().max())}")

    say("sec5: ring attention")
    sp_mesh = make_axis_mesh("sp", sub, dev.type)
    sp_ids = rng.integers(0, 512, (1, 8 * sub))
    sp_tgt = rng.integers(0, 512, (1, 8 * sub))
    sp_loss = torch.zeros(())
    if _member(sp_mesh):
        lo, hi = rank * 8, (rank + 1) * 8
        blk_ids = torch.as_tensor(sp_ids[:, lo:hi], device=dev)
        blk_tgt = torch.as_tensor(sp_tgt[:, lo:hi], device=dev)
        with torch.no_grad():
            sp_loss = base.loss(blk_ids, blk_tgt, ring=(sp_mesh, "sp"))
            say("sec5b: ulysses attention")
            ul_loss = base.loss(blk_ids, blk_tgt, ring=(sp_mesh, "sp", "ulysses"))
        if abs(float(ul_loss) - float(sp_loss)) >= 1e-3:
            raise AssertionError(f"ulysses {float(ul_loss)} != ring {float(sp_loss)}")

    say("sec6: engine tp (sharded serving)")
    etp = min(4, n)
    emesh = make_mesh(dp=1, tp=etp, device=dev.type)
    if _member(emesh):
        emodel = shard_model(pad_heads_for_tp(base, etp), emesh)
        eng = ContinuousEngine(emodel, slots=2, max_len=64, prompt_bucket=16, kv_dtype=torch.float32,
                               start_thread=False, decode_window=4, mesh=emesh)
        eq = [eng.submit((np.arange(6) * (i + 2)) % 512, 5) for i in range(2)]
        for _ in range(16):
            eng.step()
        etoks = [collect(q, timeout=30) for q in eq]
        if not all(len(t) == 5 for t in etoks):
            raise AssertionError(f"engine tokens {etoks}")
    torch.distributed.barrier()
    return f"dryrun OK: mesh dp={dp} tp={tp}, loss={float(loss):.4f}, ring={float(sp_loss):.4f}"


def _member(mesh) -> bool:
    """Whether this rank belongs to `mesh` (a section's mesh may be smaller
    than the world; the other ranks skip the section)."""
    return mesh.get_coordinate() is not None


def _rank(rank: int, n: int, device: str, init: str) -> None:
    import torch.distributed as dist

    backend = "nccl" if device == "cuda" else "gloo"
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=init, world_size=n, rank=rank,
                            timeout=datetime.timedelta(seconds=300))  # a hung collective fails the run
    try:
        line = _body(n, torch.device("cuda", torch.cuda.current_device()) if device == "cuda"
                     else torch.device("cpu"))
        if rank == 0:
            print(line, flush=True)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=None, help="ranks (default 8 on the CPU, 1 on the card)")
    ap.add_argument("--device", choices=("cpu", "cuda"), required=True,
                    help="cuda: NCCL ranks on the cards; cpu: gloo ranks on the CPU")
    args = ap.parse_args(argv)
    n = args.n or (1 if args.device == "cuda" else 8)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("dryrun --device cuda: no CUDA card")
        if torch.cuda.device_count() < n:
            raise SystemExit(f"dryrun --device cuda: {n} ranks need {n} GPUs, found {torch.cuda.device_count()}")
        init = f"tcp://localhost:{_free_port()}"
        torch.multiprocessing.start_processes(_rank, (n, args.device, init), nprocs=n, start_method="spawn")
        return
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        torch.multiprocessing.start_processes(_rank, (n, args.device, init), nprocs=n, start_method="spawn")


if __name__ == "__main__":
    main()
