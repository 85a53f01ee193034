"""Continuous (slot / iteration-level) batching engine: counterpart of
`mllm_tpu/generation/engine.py`.

Requests are admitted into free SLOTS of a shared slot cache while the other
slots keep decoding. The cache is one of `SlotKVCache` (dense), a
`SlotQuantKVCache` (`kv_dtype="int8" | "int4"`) or a `PagedKVCache`
(`paged=N` pool blocks, reserved per request by a host-side allocator).

  - admission prefills a prompt (one request, or up to `slots` one-bucket
    prompts in one batch) into a small cache of the slot cache's storage type,
    installs it into the slot and samples the first token on the device;
  - a decode window runs `decode_window` model calls, each one token for
    every slot at its own write head, with per-slot sampling on the device;
    idle slots compute values that are discarded. On the card every window
    is a replay of a CUDA graph (`graphs.StepGraph`), one for all-greedy
    windows and one for windows that sample, captured at its first use after
    a warm-up model call that changes no state;
  - the scheduler state (current token, activity, budget, sampling params),
    the slot cache's heads and its block table live on the device at fixed
    addresses, edited in place by admission and `with_tables`, so a
    replayed window reads them where it was captured: a window reads
    nothing back, and `_drain` is the one host fetch (a window's tokens and
    the admissions' first tokens in one copy);
  - with `prefix_cache=N` an LRU of N admission caches keyed by prompt
    tokens (`prefill.PromptCache`) lets a request whose prompt shares a
    bucket-aligned prefix with an earlier one prefill only the rest
    (`prefix_hits`, `prefix_tokens_reused`).

With `pipeline=True` window N's tokens are copied into pinned host memory
right after window N is queued, behind an event; window N+1 is queued, and
only then does the host wait on N's event, so the copy and the host's
bookkeeping overlap window N+1 on the card.

A Qwen2-VL model (one with a `visual` tower) takes image and video requests
too (`submit_vl`): admission encodes the image, splices it into the prompt
and prefills with the processor's M-RoPE positions; the slot records the
request's mrope_delta (`SchedState.pos_delta`, 0 for a text request), and
the decode window gives each slot the rope position head + delta, read on the
device, so one captured window serves every mix of requests.

Tensor-parallel serving (`mesh=`, a `parallel.sharding.make_mesh` mesh and
a model from `shard_model(pad_heads_for_tp(model, tp), mesh)`, or, for a
Qwen2-VL / Qwen2.5-VL model, `shard_model(model, mesh)` with a tp that
divides its heads): every rank runs the engine over its shard; the model's
local cfg (a VL model's `cfg.text`) gives each rank's slot cache, or paged
pool, its own kv heads, with every slot, block and table entry. Every rank
takes part in each collective, so every rank must admit the same requests at
the same step: rank 0 of the mesh owns the request queue, and at each step
broadcasts what it took from it (and whether to stop); an image request's
patches follow as one tensor broadcast on the mesh's device. Each rank's
`submit` / `submit_vl` returns a queue that receives the tokens of the
request with the same submission number on rank 0. A VL model's tower is
whole on every rank: each encodes the image on its copy, then runs its shard
of the trunk. The paged allocator runs on every rank and makes the same
decisions from the same inputs (see `_paged_reserve`), so the block tables
agree without being sent. Under NCCL the windows are CUDA graphs with the
collectives captured in them, reading the pool's table and the heads in
place; under gloo, which no graph captures, they run eagerly as on the CPU.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..kv.cache import PagedKVCache, SlotKVCache, SlotQuantKVCache, storage, to_device
from .graphs import StepGraph
from .prefill import PromptCache
from .sampling import SamplingConfig, sample_tokens_batched


class SchedState:
    """Device-resident scheduler state, one entry per slot: cur (int64, the
    current token), active (bool), budget (int32 tokens left), temperature
    (f32, <= 0 greedy), top_k (int32, 0 off), top_p (f32, 0 off), pos_delta
    (int32, the request's M-RoPE offset: 0 for text), and the
    torch.Generator the windows draw from."""

    def __init__(self, cur, active, budget, temperature, top_k, top_p, pos_delta, generator):
        self.cur = cur
        self.active = active
        self.budget = budget
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.pos_delta = pos_delta
        self.generator = generator

    @staticmethod
    def init(slots: int, device, seed: int = 0) -> "SchedState":
        def z(dtype):
            return torch.zeros(slots, dtype=dtype, device=device)

        return SchedState(z(torch.int64), z(torch.bool), z(torch.int32), z(torch.float32),
                          z(torch.int32), z(torch.float32), z(torch.int32),
                          torch.Generator(device=device).manual_seed(seed))

    def set_slots(self, slots, toks, budget, temperature, top_k, top_p, pos_delta=None) -> None:
        """Install admitted requests: slot ids and the per-request values (host
        sequences; toks a device tensor), in place; pos_delta None is 0 for
        every slot (text requests)."""
        dev = self.cur.device
        idx = to_device(np.asarray(slots, np.int64), dev)
        self.cur[idx] = toks.to(torch.int64)
        self.active[idx] = True
        if pos_delta is None:
            pos_delta = np.zeros(len(slots), np.int32)
        for dst, vals in ((self.budget, budget), (self.temperature, temperature),
                          (self.top_k, top_k), (self.top_p, top_p), (self.pos_delta, pos_delta)):
            dst[idx] = to_device(np.asarray(vals), dev, dst.dtype)


def _sampling_params(s: SamplingConfig) -> tuple[float, int, float]:
    """(temperature, top_k, top_p) of a request; greedy is temperature 0."""
    if not s.do_sample:
        return 0.0, 0, 0.0
    return s.temperature, s.top_k, s.top_p


def text_config(model):
    """The language model's TextConfig (VL models nest it as `cfg.text`)."""
    return getattr(model.cfg, "text", model.cfg)


def _install_first(model, cache, state: SchedState, slot: int, small, last_hidden, true_len: int,
                   max_tokens: int, sampling: SamplingConfig, pos_delta: int = 0):
    """Install a prefilled 1-sequence cache into `slot`, sample its first
    token from the hidden state of its last prompt token and record the
    request (and its M-RoPE offset) in `state`. Returns (tok [1], cache,
    small with pos = true_len)."""
    logits = model.logits(last_hidden)[:, 0]
    cache = cache.admit(slot, small, true_len)
    t, k, p = _sampling_params(sampling)
    dev = logits.device
    tok = sample_tokens_batched(logits, torch.full((1,), t, device=dev), torch.full((1,), k, device=dev),
                                torch.full((1,), p, device=dev), state.generator, all_greedy=t <= 0)
    state.set_slots([slot], tok, [max_tokens - 1], [t], [k], [p], [pos_delta])  # the host emits the first token
    return tok, cache, small.with_pos(true_len)


@torch.no_grad()
def _admit_step(model, cache, state: SchedState, slot: int, ids: torch.Tensor, true_len: int,
                max_tokens: int, sampling: SamplingConfig, bucket: int):
    """Prefill `ids` [1, bucket] (true_len valid) into a small cache, install
    it into `slot`, sample the first token on the device and record the slot's
    request in `state`. Returns (tok [1], cache, small). Nothing is read back."""
    cfg = text_config(model)
    small = cache.make_prefill_cache(1, bucket, cache.n_layers, cfg.num_key_value_heads, cfg.head_dim_)
    hidden, small = model.hidden_states(ids, small)
    return _install_first(model, cache, state, slot, small, hidden[:, true_len - 1 : true_len], true_len,
                          max_tokens, sampling)


@torch.no_grad()
def _admit_prefix_step(model, cache, state: SchedState, slot: int, prefix_small, m: int,
                       suffix_ids: torch.Tensor, true_len: int, max_tokens: int,
                       sampling: SamplingConfig, bucket_total: int):
    """Admission with prefix reuse (JAX `_admit_prefix_step`): `prefix_small`
    holds the KV of the first m prompt tokens (a bucket-aligned prefix), so
    only the suffix [1, bucket_total - m] runs through the model, into the
    prefix's cache grown to bucket_total rows; the first token is sampled at
    prompt position true_len - 1. Returns (tok [1], cache, small)."""
    small = _pad_small_seq(prefix_small, bucket_total)
    hidden, small = model.hidden_states(suffix_ids, small)
    return _install_first(model, cache, state, slot, small, hidden[:, true_len - 1 - m : true_len - m],
                          true_len, max_tokens, sampling)


@torch.no_grad()
def _admit_batch(model, cache, state: SchedState, slot_ids: np.ndarray, ids: torch.Tensor,
                 true_lens: np.ndarray, max_tokens: np.ndarray, params: np.ndarray, bucket: int,
                 all_greedy: bool):
    """Admit up to A one-bucket requests in one batched prefill: ids [A,
    bucket], row a for slot slot_ids[a] (a slot id >= B marks a padding row,
    which is dropped); params [A, 3] = (temperature, top_k, top_p).
    Returns (toks [A], cache, small)."""
    cfg = text_config(model)
    a = ids.shape[0]
    small = cache.make_prefill_cache(a, bucket, cache.n_layers, cfg.num_key_value_heads, cfg.head_dim_)
    hidden, small = model.hidden_states(ids, small)
    dev = hidden.device
    last = hidden[torch.arange(a, device=dev), to_device(true_lens - 1, dev, torch.long)]  # [A, D]
    logits = model.logits(last[:, None, :])[:, 0, :]
    toks = sample_tokens_batched(logits, to_device(params[:, 0], dev, torch.float32),
                                 to_device(params[:, 1], dev, torch.int32),
                                 to_device(params[:, 2], dev, torch.float32), state.generator,
                                 all_greedy=all_greedy)
    cache = cache.admit_batch(slot_ids, small, true_lens, bucket)
    rows = np.nonzero(slot_ids < state.cur.shape[0])[0]
    state.set_slots(slot_ids[rows], toks[to_device(rows, dev, torch.long)], max_tokens[rows] - 1,
                    params[rows, 0], params[rows, 1], params[rows, 2])
    return toks, cache, small


@torch.no_grad()
def _admit_vl_step(model, cache, state: SchedState, slot: int, ids: torch.Tensor, patches, positions,
                   true_len: int, pos_delta: int, max_tokens: int, sampling: SamplingConfig, bucket: int,
                   grid_thw):
    """Multimodal admission (JAX `_admit_vl_step`): the vision tower on
    `patches`, the splice into `ids` [1, bucket], the trunk at the
    processor's M-RoPE `positions` [3, 1, bucket] into a small cache, then
    `_install_first` with the slot's pos_delta. Returns (tok [1], cache,
    small)."""
    cfg = text_config(model)
    small = cache.make_prefill_cache(1, bucket, cache.n_layers, cfg.num_key_value_heads, cfg.head_dim_)
    x = model.embed(ids, model.visual(patches, grid_thw))
    hidden, small = model.trunk(x, positions, small)
    return _install_first(model, cache, state, slot, small, hidden[:, true_len - 1 : true_len], true_len,
                          max_tokens, sampling, pos_delta)


def _pad_small_seq(small, new_len: int):
    """Grow a small prefill cache along its sequence axis to `new_len` rows,
    in new storage with zeros after the old rows (dense and quantized small
    caches alike; the write head is kept)."""
    names = [n for n in ("k", "v", "k_scale", "v_scale") if hasattr(small, n)]
    grown = []
    for n in names:
        t = getattr(small, n)
        pad = [0, 0] * (t.dim() - 4) + [0, max(new_len - t.shape[3], 0)]
        grown.append(torch.nn.functional.pad(t, pad))
    return type(small)(*grown, small.pos)


@torch.no_grad()
def _decode_window(model, cache, state: SchedState, eos_ids: torch.Tensor, out: torch.Tensor,
                   all_greedy: bool, model_kw: dict) -> None:
    """out.shape[1] decode iterations with per-slot sampling, all on the device.

    A slot emits while it is active with budget left; EOS or an exhausted
    budget deactivates it, and its later positions in the window are -1.
    Writes out [B, steps] (int64, -1 padding) and advances `state` and the
    cache's heads in place: their addresses do not change, so the window can
    be captured once and replayed. model_kw: extra arguments of every model
    call ({"pos_delta": state.pos_delta} for a VL model, JAX's `is_vl`)."""
    toks, active, budget = state.cur, state.active, state.budget
    c = cache
    for i in range(out.shape[1]):
        logits, c = model(toks[:, None], c, last_only=True, **model_kw)
        nxt = sample_tokens_batched(logits[:, 0, :], state.temperature, state.top_k, state.top_p,
                                    state.generator, all_greedy=all_greedy)
        emit = active & (budget > 0)
        nxt = torch.where(emit, nxt, -1)
        out[:, i] = nxt
        budget = budget - emit.to(budget.dtype)
        hit_eos = (nxt[:, None] == eos_ids[None, :]).any(dim=1)
        active = emit & ~hit_eos & (budget > 0)
        toks = torch.where(nxt >= 0, nxt, toks)  # keep the last valid token
    state.cur.copy_(toks)
    state.active.copy_(active)
    state.budget.copy_(budget)
    cache.pos.copy_(c.pos)


@dataclass
class _Request:
    ids: np.ndarray
    max_tokens: int
    out: queue.Queue
    t_submit: float
    sampling: SamplingConfig = field(default_factory=SamplingConfig)
    vl: Optional[tuple] = None  # (patches, grid_thw, positions [3, 1, S], mrope_delta) of a VL request
    seq: int = -1  # submission number (a tp engine's ranks match requests by it)


@dataclass
class _Window:
    """A dispatched window's tokens on their way to the host."""
    host: torch.Tensor  # out [B * steps] then the admissions' first tokens
    first_slots: list
    gens: list
    event: Optional[torch.cuda.Event]


class ContinuousEngine:
    """Slot scheduler. Thread-safe submit(); optionally runs its own loop thread."""

    def __init__(self, model, *, slots: int = 8, max_len: int = 2048, prompt_bucket: int = 128,
                 eos_token_id=None, kv_dtype="bf16", start_thread: bool = True,
                 decode_window: int = 8, pipeline: bool = False, prefix_cache: int = 0,
                 paged: int = 0, mesh=None):
        self.mesh = mesh
        self._seq = 0  # submissions on this rank (a request's number)
        self._outs: dict = {}  # request number -> its queue, on ranks other than 0
        self._mirror: queue.Queue = queue.Queue()  # the requests rank 0 broadcast
        self._agreed_stop = False  # rank 0's stop flag as broadcast at the last step
        cfg = text_config(model)
        self.model = model
        self.slots = slots
        self.max_len = max_len
        self.bucket = prompt_bucket
        self.window = max(1, decode_window)
        dev = model.device
        geo = (cfg.num_hidden_layers, slots, max_len, cfg.num_key_value_heads, cfg.head_dim_)
        # the paged allocator: blocks reserved per request from a shared pool.
        # A retired slot's blocks are quarantined for two drains before reuse
        # (a pipelined window queued before its table row was cleared may still
        # write them).
        self._free_blocks: list = []
        self._slot_blocks: list = [[] for _ in range(slots)]
        self._deferred_free: list = []
        self._free_pending: list = []
        dense = torch.bfloat16 if kv_dtype in ("bf16", "bfloat16") else kv_dtype
        if paged > 0:
            self.cache = PagedKVCache.init(*geo, device=dev, dtype=dense, n_blocks=paged)
            self._free_blocks = list(range(self.cache.n_blocks))
        elif kv_dtype in ("int8", "q8", "int4", "q4"):
            self.cache = SlotQuantKVCache.init(*geo, device=dev, bits=4 if kv_dtype in ("int4", "q4") else 8)
        else:
            self.cache = SlotKVCache.init(*geo, device=dev, dtype=dense)
        e = eos_token_id if eos_token_id is not None else cfg.eos_token_id
        self.eos = set(e) if isinstance(e, (tuple, list, set)) else {e}
        self._eos_arr = torch.tensor(sorted(self.eos) or [-9999], dtype=torch.int64, device=dev)
        self.pending: queue.Queue = queue.Queue()
        self.req: list[Optional[_Request]] = [None] * slots
        self.emitted = [0] * slots
        self.cur = np.zeros(slots, np.int64)
        self._state = SchedState.init(slots, dev)
        # a Qwen2-VL model's decode steps take each slot's M-RoPE offset
        self.is_vl = hasattr(model, "visual")
        self._decode_kw = {"pos_delta": self._state.pos_delta} if self.is_vl else {}
        self._first: dict = {}  # slot -> first-token device tensor, fetched with the next window
        self.pipeline = pipeline
        self._inflight: Optional[_Window] = None
        self._gen = [0] * slots  # admission generation per slot
        self.steps = 0  # decode windows dispatched
        self.admissions = 0  # admission prefills run (one request, or one batch)
        self.requeued = 0  # admissions put back because the block pool was full
        # every window writes its tokens here; one StepGraph a sampling kind
        self._out = torch.full((slots, self.window), -1, dtype=torch.int64, device=dev)
        self._windows: dict = {}
        # automatic prefix caching: an LRU of admission caches keyed by prompt
        # tokens; reuse is bucket-aligned. 0 = off.
        self._pcache = PromptCache(prefix_cache) if prefix_cache > 0 else None
        self.prefix_hits = 0
        self.prefix_tokens_reused = 0
        self._stop = False
        self._thread = None
        if start_thread:
            self._thread = threading.Thread(target=self.run, daemon=True)
            self._thread.start()

    # -- client API --------------------------------------------------------
    def submit(self, prompt_ids: np.ndarray, max_tokens: int = 64,
               sampling: Optional[SamplingConfig] = None) -> queue.Queue:
        """Returns a queue yielding token ids, then None when finished."""
        return self._enqueue(prompt_ids, max_tokens, sampling, None)

    def submit_vl(self, proc_out, max_tokens: int = 64,
                  sampling: Optional[SamplingConfig] = None) -> queue.Queue:
        """Submit a multimodal (Qwen2-VL) request: `proc_out` a
        `Qwen2VLProcessorOutput` (input_ids, patches, grid_thw, position_ids,
        mrope_delta). Image and text requests share the slots. Under a mesh,
        ranks other than 0 need no image: their queue is filled from rank
        0's request of the same number."""
        if not self.is_vl:
            raise ValueError("the model has no vision tower")
        vl = None
        if self.mesh is None or self._leader():
            vl = (proc_out.patches, tuple(proc_out.grid_thw), np.asarray(proc_out.position_ids, np.int64),
                  int(proc_out.mrope_delta))
        return self._enqueue(proc_out.input_ids, max_tokens, sampling, vl)

    def _enqueue(self, prompt_ids, max_tokens: int, sampling: Optional[SamplingConfig], vl) -> queue.Queue:
        """Number a text or VL request and queue it (rank 0 of a mesh, or no
        mesh), or register its output queue under its number (other ranks)."""
        out: queue.Queue = queue.Queue()
        ids = np.asarray(prompt_ids, np.int64).reshape(-1)
        # capacity guard: past max_len a slot's appends would clamp onto its
        # last row while pos advanced, decoding over stale rows
        if len(ids) >= self.max_len:
            raise ValueError(f"prompt length {len(ids)} >= engine max_len {self.max_len}")
        max_tokens = min(max_tokens, self.max_len - len(ids))
        if self.mesh is not None and not self._leader():
            self._outs[self._seq] = out  # filled from rank 0's request of this number
        else:
            self.pending.put(_Request(ids, max_tokens, out, time.perf_counter(), sampling or SamplingConfig(),
                                      vl=vl, seq=self._seq))
        self._seq += 1
        return out

    def stop(self, timeout: float = 60.0):
        """Stop the loop thread (if any) and wait up to `timeout` seconds for
        it; `_thread` stays set if it is still running."""
        self._stop = True
        if self._thread is not None:
            self._thread.join(timeout)
            if not self._thread.is_alive():
                self._thread = None

    # -- tensor parallelism ------------------------------------------------
    def _leader(self) -> bool:
        from ..parallel.comm import axis_rank

        return axis_rank(self.mesh, "tp") == 0

    def _sync_requests(self) -> None:
        """Rank 0 moves every pending request into the mirror queue and
        broadcasts them (with its stop flag): ids, budget and sampling, and
        of an image request its grid, M-RoPE positions and delta, in one
        object broadcast; then each image's patches as a tensor broadcast on
        the mesh's device (no pickled copy through the host). Every other
        rank puts the same requests, with its own output queues, into its
        mirror queue."""
        import torch.distributed as dist

        from ..parallel.comm import axis_group

        taken = []
        if self._leader():
            while True:
                try:
                    taken.append(self.pending.get_nowait())
                except queue.Empty:
                    break
        dev = self.model.device
        for r in taken:  # the patches on the device once, where admission reads them
            if r.vl is not None and not isinstance(r.vl[0], torch.Tensor):
                r.vl = (to_device(np.asarray(r.vl[0]), dev),) + r.vl[1:]
        group = axis_group(self.mesh, "tp")
        src = dist.get_global_rank(group, 0)
        meta = [None if r.vl is None else (tuple(r.vl[0].shape), r.vl[0].dtype) + r.vl[1:] for r in taken]
        box = [(self._stop, [(r.seq, r.ids, r.max_tokens, r.sampling, m) for r, m in zip(taken, meta)])]
        dist.broadcast_object_list(box, src, group=group)
        stop, items = box[0]
        self._agreed_stop = stop
        if self._leader():
            for r in taken:
                if r.vl is not None:
                    dist.broadcast(r.vl[0].to(dev).contiguous(), src, group=group)
                self._mirror.put(r)
            return
        for seq, ids, max_tokens, sampling, m in items:
            vl = None
            if m is not None:
                shape, dtype, grid_thw, positions, delta = m
                patches = torch.empty(shape, dtype=dtype, device=dev)
                dist.broadcast(patches, src, group=group)
                vl = (patches, grid_thw, positions, delta)
            out = self._outs.pop(seq, None) or queue.Queue()
            self._mirror.put(_Request(ids, max_tokens, out, time.perf_counter(), sampling, vl=vl, seq=seq))

    # -- scheduler ---------------------------------------------------------
    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.req):
            if r is None:
                return i
        return None

    def _paged_reserve(self, slot: int, n: int, max_tokens: int, bucket: int) -> bool:
        """Reserve this request's blocks in table[slot] (False: the pool is
        full). Reserving prompt + full budget up front means decode never
        allocates mid-flight.

        Under a mesh every rank runs this allocator on its own, and the
        ranks' tables cannot diverge: its state changes only here (a
        request taken from the mirror queue, which every rank fills from
        rank 0's broadcast in rank 0's order, and puts back, requeued, by the
        same rule), in `_paged_retire` (a request finished, decided by the
        tokens `_drain` reads, which are equal on every rank: the logits are
        all-gathered and the sampler's generator has the same seed) and in
        `_paged_release` (once a drain, or twice when idle, at the same
        steps on every rank). Equal inputs in the same order give every rank
        the same free list, the same blocks and the same table."""
        if not isinstance(self.cache, PagedKVCache):
            return True
        bs = PagedKVCache.BS
        need = min(max(-(-(n + max_tokens) // bs), bucket // bs), self.cache.table.shape[1])
        if len(self._free_blocks) < need:
            self.requeued += 1
            return False
        # the previous tenant's blocks go to the quarantine
        self._deferred_free.extend(self._slot_blocks[slot])
        self._slot_blocks[slot] = [self._free_blocks.pop() for _ in range(need)]
        tbl = self.cache.table_host.copy()
        tbl[slot] = -1
        tbl[slot, :need] = self._slot_blocks[slot]
        self.cache = self.cache.with_tables(tbl)
        return True

    def _paged_release(self):
        """Advance the quarantine one drain: pending -> free, deferred ->
        pending. Two drains after a table row was cleared, every window
        queued with the old table has finished."""
        self._free_blocks.extend(self._free_pending)
        self._free_pending = self._deferred_free
        self._deferred_free = []

    def _paged_retire(self, slot: int):
        """A request finished: quarantine its blocks and clear its table row,
        so the slot's idle appends (pos keeps advancing) are dropped."""
        if not self._slot_blocks[slot]:
            return
        self._deferred_free.extend(self._slot_blocks[slot])
        self._slot_blocks[slot] = []
        tbl = self.cache.table_host.copy()
        tbl[slot] = -1
        self.cache = self.cache.with_tables(tbl)

    def _prefix_match(self, ids: np.ndarray) -> int:
        """Bucket-aligned reusable prefix length of `ids` (0: no hit)."""
        if self._pcache is None:
            return 0
        _, matched = self._pcache.lookup_common(ids)
        m = min(matched, len(ids) - 1)  # keep >= 1 suffix token for the logits
        return (m // self.bucket) * self.bucket

    def _install(self, slot: int, r: _Request, tok) -> None:
        self.req[slot] = r
        self.emitted[slot] = 0
        self._first[slot] = tok
        self._gen[slot] += 1

    def _admit(self, slot: int, r: _Request) -> bool:
        """Prefill + install a (multi-bucket) prompt into `slot`; its first
        token stays on the device until the next window's fetch. With the
        prefix cache, a bucket-aligned shared prefix is not prefilled again:
        only the suffix runs through the model."""
        n = len(r.ids)
        bucket = min(-(-max(n, 1) // self.bucket) * self.bucket, self.max_len)
        if not self._paged_reserve(slot, n, r.max_tokens, bucket):
            return False
        self.admissions += 1
        m = self._prefix_match(r.ids)
        hit = self._pcache.lookup_prefix_rows(r.ids, m) if m > 0 else None
        dev = self.model.device
        if hit is not None:
            ids = np.zeros((1, bucket - m), np.int64)
            ids[0, : n - m] = r.ids[m:n]
            tok, self.cache, small = _admit_prefix_step(
                self.model, self.cache, self._state, slot, hit, m, to_device(ids, dev), n,
                r.max_tokens, r.sampling, bucket)
            self.prefix_hits += 1
            self.prefix_tokens_reused += m
        else:
            ids = np.zeros((1, bucket), np.int64)
            ids[0, :n] = r.ids[:bucket]
            tok, self.cache, small = _admit_step(self.model, self.cache, self._state, slot,
                                                 to_device(ids, dev), min(n, bucket), r.max_tokens,
                                                 r.sampling, bucket)
        if self._pcache is not None:
            self._pcache.store(r.ids[: min(n, bucket)], small)
        self._install(slot, r, tok)
        return True

    def _admit_vl(self, slot: int, r: _Request) -> bool:
        """Vision admission: encode, splice and prefill one request into
        `slot` (its blocks reserved first on a paged pool); the slot records
        the request's M-RoPE offset."""
        patches, grid_thw, positions, delta = r.vl
        n = len(r.ids)
        bucket = min(-(-max(n, 1) // self.bucket) * self.bucket, self.max_len)
        if not self._paged_reserve(slot, n, r.max_tokens, bucket):
            return False
        self.admissions += 1
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :n] = r.ids
        pos = np.zeros((3, 1, bucket), np.int64)
        pos[:, :, :n] = positions[:, :, :n]
        # pad positions continue past the last real one (rows no query sees)
        pos[:, :, n:] = positions[:, :, n - 1 : n] + np.arange(1, bucket - n + 1)[None, None, :]
        dev = self.model.device
        p = patches if isinstance(patches, torch.Tensor) else to_device(np.asarray(patches), dev)
        tok, self.cache, _ = _admit_vl_step(self.model, self.cache, self._state, slot, to_device(ids, dev),
                                            p.to(dev), to_device(pos, dev), n, delta, r.max_tokens, r.sampling,
                                            bucket, grid_thw)
        self._install(slot, r, tok)
        return True

    def _admit_many(self, batch):
        """Admit several one-bucket requests in ONE batched prefill."""
        a = self.slots
        slot_ids = np.full(a, self.slots, np.int64)  # out of range: a padding row
        ids = np.zeros((a, self.bucket), np.int64)
        lens = np.ones(a, np.int64)
        mt = np.ones(a, np.int64)
        params = np.zeros((a, 3), np.float64)
        for row, (slot, r) in enumerate(batch):
            n = len(r.ids)
            slot_ids[row] = slot
            ids[row, :n] = r.ids
            lens[row] = max(n, 1)
            mt[row] = r.max_tokens
            params[row] = _sampling_params(r.sampling)
        self.admissions += 1
        toks, self.cache, small = _admit_batch(
            self.model, self.cache, self._state, slot_ids, to_device(ids, self.model.device), lens, mt,
            params, self.bucket, all_greedy=not any(r.sampling.do_sample for _, r in batch))
        for row, (slot, r) in enumerate(batch):
            self._install(slot, r, toks[row : row + 1])
            if self._pcache is not None:  # this row's cache (the store copies it)
                one = type(small)(*(t[:, row : row + 1] for t in storage(small)), len(r.ids))
                self._pcache.store(r.ids, one)

    def _emit(self, slot: int, tok: int):
        r = self.req[slot]
        r.out.put(tok)
        self.emitted[slot] += 1
        if tok in self.eos or self.emitted[slot] >= r.max_tokens:
            r.out.put(None)  # finished sentinel
            self.req[slot] = None
            self._paged_retire(slot)

    def _fetch(self, out: torch.Tensor, firsts: dict) -> _Window:
        """Queue the copy of a window's tokens and the pending first tokens to
        the host (pinned memory on a card), behind an event."""
        first_slots = sorted(firsts)
        vals = torch.cat([out.reshape(-1)] + [firsts[s].reshape(-1).to(out.dtype) for s in first_slots])
        event = None
        if vals.is_cuda:
            host = torch.empty(vals.shape, dtype=vals.dtype, pin_memory=True)
            host.copy_(vals, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host = vals
        return _Window(host, first_slots, list(self._gen), event)

    def _drain(self, w: _Window):
        """Wait for a window's tokens and emit them (the only host fetch).

        Tokens are dropped for slots re-admitted since the window was queued
        (w.gens), so a pipelined window cannot leak into a new request."""
        if w.event is not None:
            w.event.synchronize()
        vals = w.host.numpy()
        out_np = vals[: self.slots * self.window].reshape(self.slots, self.window)
        for s, t in zip(w.first_slots, vals[self.slots * self.window :]):
            if self._gen[s] != w.gens[s]:
                continue
            self.cur[s] = int(t)
            self._emit(s, int(t))
        for slot in range(self.slots):
            if self._gen[slot] != w.gens[slot]:
                continue
            if slot in w.first_slots and self.req[slot] is None:
                continue  # the first token finished the request; the window decoded past it
            for i in range(self.window):
                tok = int(out_np[slot, i])
                if tok < 0 or self.req[slot] is None:
                    break
                self.cur[slot] = tok
                self._emit(slot, tok)
        self._paged_release()  # this drain proves the prior window finished

    def step(self) -> bool:
        """One scheduler iteration; returns True if any work was done. Under a
        mesh every rank calls it in step with the others."""
        worked = False
        if self.mesh is not None:
            self._sync_requests()
        source = self._mirror if self.mesh is not None else self.pending
        if self._inflight is None and all(r is None for r in self.req):
            # nothing queued on the card: the whole quarantine is safe to release
            self._paged_release()
            self._paged_release()
        batch = []
        while True:
            slot = self._free_slot()
            if slot is None:
                break
            try:
                r = source.get_nowait()
            except queue.Empty:
                break
            if r.vl is not None:  # multimodal: the vision admission
                if not self._admit_vl(slot, r):
                    source.put(r)
                    break
            elif len(r.ids) <= self.bucket and self._prefix_match(r.ids) == 0:
                if not self._paged_reserve(slot, len(r.ids), r.max_tokens, self.bucket):
                    source.put(r)  # pool full: retry next step
                    break
                self.req[slot] = r  # reserved; installed by _admit_many below
                batch.append((slot, r))
            elif not self._admit(slot, r):
                source.put(r)
                break
            worked = True
        if batch:
            self._admit_many(batch)
        if any(r is not None for r in self.req):
            firsts, self._first = self._first, {}
            self.steps += 1
            greedy_only = not any(r.sampling.do_sample for r in self.req if r is not None)
            self._window_graph(greedy_only)()
            w = self._fetch(self._out, firsts)
            if self.pipeline:
                # window N+1 is queued before the host waits on window N
                prev, self._inflight = self._inflight, w
                if prev is not None:
                    self._drain(prev)
            else:
                self._drain(w)
            worked = True
        elif self._inflight is not None:
            self._drain(self._inflight)
            self._inflight = None
            worked = True
        return worked

    def _window_graph(self, all_greedy: bool) -> StepGraph:
        """The decode window of this sampling kind over the engine's static
        buffers. On the card its warm-up is one model call that changes no
        state: it writes each slot's K/V row at its head, the row that the
        window's first step writes again with the same values; the window is
        then captured and replayed from its first use."""
        if all_greedy not in self._windows:
            def window():
                _decode_window(self.model, self.cache, self._state, self._eos_arr, self._out, all_greedy,
                               self._decode_kw)

            def warmup():
                with torch.no_grad():
                    self.model(self._state.cur[:, None], self.cache, last_only=True, **self._decode_kw)

            gens = () if all_greedy else (self._state.generator,)
            self._windows[all_greedy] = StepGraph(
                window, self._out.device, warmup=warmup, generators=gens, warmup_is_work=False,
                name=f"engine_window_{'greedy' if all_greedy else 'sampled'}")
        return self._windows[all_greedy]

    def run(self):
        while not self._stop or self.mesh is not None:
            if self.mesh is not None:  # every rank steps with rank 0, which says when to stop
                worked = self.step()
                if self._agreed_stop:
                    break
                if not worked:
                    time.sleep(0.005)
                continue
            if not self.step():
                try:
                    r = self.pending.get(timeout=0.05)
                except queue.Empty:
                    continue
                self.pending.put(r)  # picked up by the next step()


def collect(out_q: queue.Queue, timeout: float = 300.0) -> list[int]:
    """Drain a submit() queue until the None sentinel."""
    toks = []
    deadline = time.time() + timeout
    while True:
        t = out_q.get(timeout=max(deadline - time.time(), 0.01))
        if t is None:
            return toks
        toks.append(t)
