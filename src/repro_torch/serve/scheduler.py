"""Continuous-batching scheduler over the compressed KV cache (the port of
``repro.serve.scheduler``), dense and paged, with the prefix cache and the
request lifecycle.

The server owns a ring of decode **slots** over one live decode state and
an admission queue:

    submit -> queue -> [admit: block-chunked prefill interleaved with decode]
           -> decode steps (every slot at its own position)
           -> retire at EOS / length -> slot reused by the next request

Admission follows the reference's split.  The dense and MoE families take
its unified chunk loop: a queued prompt claims a free slot as a PREFILLING
row and runs ``block_size``-token chunks (``model.prefill_chunk``) on a
private batch-1 state, at most ``ServerConfig.prefill_chunk_tokens``
prompt tokens per server step ("chunked", the default), or all of them at
admission ("solo", the blocking baseline; the same numerics, so the same
tokens).  The finished state is spliced into its slot
(``model.insert_decode_row``).  The ssm and hybrid families have no chunk
step (an SSM state is not made of blocks): they take the legacy admission
(``_admit``), one full-length ``model.prefill`` of the exact prompt at
batch 1, spliced into the slot dense or paged, while the live decode
streams wait (``stalled_decode_steps`` counts those stalls).  Every step
then runs one batched ``model.decode_step`` over all ``max_slots`` rows.

The batch shape of the decode step is always ``max_slots`` and each row's
arithmetic never mixes with another row's (the Fetch and Store kernels
work per row; a matrix product's rows are independent for a given shape),
so a request's greedy tokens do not depend on which other requests share
the batch.

Under ``cache_mode="paged"`` (DESIGN.md §10) the slots stop reserving a
full block ring each: compressed blocks live in one shared arena per layer
(``repro_torch.core.pool``), sized from ``ServerConfig.pool_hbm_bytes``.
Admission is a memory-pressure check against the pool, so ``max_slots``
oversubscribes the dense reservation by the compression ratio.  A PREFILLING
row chunks through a batch-1 view of the live arena (``model.
chunk_state_view``), so each full chunk is encoded straight into its pooled
page, reserved one chunk ahead (DESIGN.md §13).  A page-fault sweep assigns
each decoding row its next page just before the flush that needs it.  When
the pool runs dry the reclaim ladder evicts cold prefix-index blocks, then
preempts the youngest page holder: its pages are released, its generated
tokens cleared, and it is requeued at the head; greedy decode then
regenerates the same tokens.  The host keeps a mirror of the page table
(``_pt_host``) and of every row's position, so the sweep and the table
updates read nothing from the device.

``ServerConfig.prefix_cache`` (DESIGN.md §11) shares prompt pages: a radix
index (``serve.prefix``) maps block-aligned prompt prefixes to live
refcounted arena pages; a hit splices the cached page ids into the new
row's page table and the chunk loop starts at the first block that
missed; a row whose flush lands on a shared page (a sliding-window ring
wrap) copies on write; a preempted row parks its prompt blocks in the
index and resumes from them.  Shared pages go through the same Fetch and
Store kernels as any other page.

The request lifecycle (DESIGN.md §15) is total: a request ends ``eos``,
``length``, ``cancelled`` (``Handle.cancel``), ``deadline``
(``Request.deadline_s`` / ``ServerConfig.default_deadline_s``) or ``error``
(over its ``max_requeues`` budget), and every abnormal end goes through one
cleanup path that releases its pages.  ``max_pending`` bounds the queue
(``backpressure`` "reject" raises ``QueueFull``, "block" pumps ``step``), a
``FaultPlan`` forces the pessimistic branch at six named sites, the
``InvariantAuditor`` checks the bookkeeping every ``audit_every`` steps, and
a server that makes no progress for ``stall_steps`` steps raises
``ServeError``.

Observability (DESIGN.md §14): every counter lives in one
``MetricsRegistry`` (``Server.metrics``) that ``stats()`` is a view over.
``ServerConfig.trace`` turns on a ring-buffered event log (``Server.trace``)
of every scheduler decision, stamped with the same floats the ``Result``
timings come from; ``Server.shutdown`` exports the JSON snapshot, its
Prometheus text and the Perfetto-loadable Chrome trace.

``ServerConfig.mesh`` (DESIGN.md §12) serves a dense or MoE model over a
``("data", "model")`` mesh of torch devices (``launch.mesh.
make_serve_mesh``): every layer's live cache is split into one cache a
shard (``distributed.serve_shard``), the rows over "data", the KV heads
over "model", each data shard with its own page pool and prefix index; a
row's pages all come from its shard, and the Fetch and Store run shard by
shard.  PREFILLING rows chunk on a private batch-1 state spliced into the
row's shard at the finish (the dense-state path, as in the reference).
The dense layers run once over the whole batch on the mesh's first device,
so greedy tokens equal the single-device server's.  A 1x1 mesh is no mesh.

The server is cooperative: ``Handle.result`` / ``Handle.tokens`` pump
``Server.step`` until their request completes; ``Server.run`` drains.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import time
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from repro_torch.core import pool as blockpool
from repro_torch.distributed import serve_shard
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import TRACE_LEVELS, EventTrace
from repro_torch.serve.faults import InvariantAuditor, QueueFull, ServeError
from repro_torch.serve.prefix import PrefixIndex


@dataclasses.dataclass
class Request:
    prompt: np.ndarray  # int32 [S]
    max_new_tokens: int = 32
    eos_id: int | None = None
    # Wall-clock bound from submit: a request still queued, prefilling or
    # decoding past it retires with finish_reason "deadline" at the next
    # step.  None falls back to ServerConfig.default_deadline_s.
    deadline_s: float | None = None


@dataclasses.dataclass
class Result:
    tokens: np.ndarray   # int32 [n], n <= max_new_tokens — truncated at eos_id
    prompt_len: int
    gen_s: float         # wall time from prefill end to last token
    prefill_s: float     # this request's own prefill wall time
    # "eos" | "length" end normally; "error" failed alone (``error`` says
    # why), "cancelled" by Handle.cancel(), "deadline" past its bound.
    finish_reason: str = "length"
    queue_wait_s: float = 0.0
    ttft_s: float | None = 0.0     # submit to first token; None without tokens
    token_times: tuple = ()        # monotonic emission time of every token
    error: str | None = None


@dataclasses.dataclass
class ServerConfig:
    max_slots: int = 8   # concurrent decode rows (the batch of the live state)
    max_seq: int = 4096
    greedy: bool = True
    pad_id: int = 0      # fed to inactive rows (their outputs are ignored)
    # Admission order: "fcfs" (arrival) or "ljf" (longest budget first).
    policy: str = "fcfs"
    # Decode-attention backend override (repro_torch.kernels.ops); None keeps
    # the model config's own (default "auto": the Fetch kernel on the card).
    attn_backend: str | None = None
    cache_mode: str | None = None  # None keeps the config's; "dense" | "paged"
    # Paged mode: the arena's byte budget across all layers; None = the
    # dense-equivalent footprint (max_slots full rings).
    pool_hbm_bytes: int | None = None
    # Prefix cache over compressed pages (paged mode only): "off"; "on"
    # (lookup, splice, park on preempt); "noshare" (the same chunked
    # admission with lookup and insert disabled: the accounting baseline,
    # bit-identical to "on").
    prefix_cache: str = "off"
    # A ("data", "model") serving mesh (launch.mesh.make_serve_mesh): "data"
    # shards decode slots, page tables and the arena's pages (a page pool
    # and a prefix index a data shard), "model" shards KV heads inside
    # attention.  None (or a 1x1 mesh) serves on one device.
    mesh: object | None = None
    # "chunked" interleaves prompt chunks with decode; "solo" drains every
    # chunk at admission (the blocking baseline, same tokens).
    prefill_mode: str = "chunked"
    # Per-step chunked-prefill token budget, a positive multiple of the cache
    # block_size; None = 8 blocks.
    prefill_chunk_tokens: int | None = None
    # Structured event trace (DESIGN.md §14): "off" records nothing (the
    # call sites are skipped: zero events, the same launches); "events"
    # every scheduler decision; "full" adds one span per decode step.
    trace: str = "off"
    # Ring capacity of the trace: a longer run keeps the most recent window
    # and counts what it dropped.
    trace_capacity: int = 65536
    # Request lifecycle (DESIGN.md §15).  Preemptions a request may take
    # before it fails alone ("error"); the oldest request in the server is
    # exempt, so the workload drains instead of thrashing.
    max_requeues: int = 32
    # Bounded admission queue: past ``max_pending`` queued requests, submit
    # applies ``backpressure`` ("reject" raises QueueFull, "block" steps the
    # server until the queue drains below the cap).  None = unbounded.
    max_pending: int | None = None
    backpressure: str = "reject"
    default_deadline_s: float | None = None  # for requests without their own
    faults: object = None          # a serve.faults.FaultPlan, or None
    audit_every: int = 0           # InvariantAuditor every N steps (0 = off)
    # No-progress detector: this many steps with work left, no progress and
    # no deadline pending raise ServeError.
    stall_steps: int = 256

    def __post_init__(self):
        if self.cache_mode not in (None, "dense", "paged"):
            raise ValueError(f"cache_mode must be dense|paged, got {self.cache_mode!r}")
        if self.prefill_mode not in ("chunked", "solo"):
            raise ValueError(
                f"prefill_mode must be chunked|solo, got {self.prefill_mode!r}")
        if self.prefill_chunk_tokens is not None and self.prefill_chunk_tokens < 1:
            raise ValueError(
                "prefill_chunk_tokens must be a positive multiple of the "
                f"cache block_size, got {self.prefill_chunk_tokens}")
        if self.trace not in TRACE_LEVELS:
            raise ValueError(f"trace must be off|events|full, got {self.trace!r}")
        if self.trace_capacity < 1:
            raise ValueError(f"trace capacity must be >= 1, got {self.trace_capacity}")
        if self.max_requeues < 0:
            raise ValueError(f"max_requeues must be >= 0, got {self.max_requeues}")
        if self.max_pending is not None and self.max_pending < 1:
            raise ValueError(
                f"max_pending must be >= 1 (or None), got {self.max_pending}")
        if self.backpressure not in ("reject", "block"):
            raise ValueError(
                f"backpressure must be reject|block, got {self.backpressure!r}")
        if self.default_deadline_s is not None and self.default_deadline_s <= 0:
            raise ValueError(
                f"default_deadline_s must be > 0, got {self.default_deadline_s}")
        if self.audit_every < 0:
            raise ValueError(f"audit_every must be >= 0, got {self.audit_every}")
        if self.stall_steps < 1:
            raise ValueError(f"stall_steps must be >= 1, got {self.stall_steps}")


class Handle:
    """One submitted request: streaming tokens and the final result.
    ``result()`` and ``tokens()`` step the server until this request
    retires."""

    def __init__(self, server: "Server", request: Request):
        self._server = server
        self.request = request
        self.id = -1
        self._toks: list[int] = []
        self._finish: str | None = None
        self._error: str | None = None
        self._requeues = 0  # preemptions spent against scfg.max_requeues
        self._hit_pages: list[int] = []  # _can_admit's lookup, spliced at start
        self._prefill_s = 0.0
        self._t_submit = time.monotonic()
        self._t_first: float | None = None  # first prefill work
        self._t_start: float | None = None  # first admission's prefill end
        self._t_end: float | None = None
        self._token_times: list[float] = []

    @property
    def done(self) -> bool:
        return self._finish is not None

    @property
    def error(self) -> str | None:
        """Why this request failed (finish_reason "error"), else None."""
        return self._error

    def cancel(self) -> bool:
        """Retire this request now, queued, PREFILLING or decoding, with
        finish_reason "cancelled", releasing its pages.  False if it had
        already finished."""
        if self.done:
            return False
        self._server._cancel(self)
        return True

    def tokens(self) -> Iterator[int]:
        """Stream generated token ids as they are produced."""
        i = 0
        while True:
            while i < len(self._toks):
                yield self._toks[i]
                i += 1
            if self.done:
                return
            self._server.step()

    def result(self) -> Result:
        """Block (drive the server) until this request finishes."""
        while not self.done:
            self._server.step()
        t_first = self._t_first if self._t_first is not None else self._t_submit
        # Retired before it decoded (still queued, or before its first
        # token): no decode wall time.
        gen_s = (self._t_end - self._t_start
                 if self._t_start is not None and self._t_end is not None else 0.0)
        return Result(
            tokens=np.asarray(self._toks, np.int32),
            prompt_len=len(self.request.prompt),
            gen_s=gen_s,
            prefill_s=self._prefill_s,
            finish_reason=self._finish,
            queue_wait_s=t_first - self._t_submit,
            ttft_s=(self._token_times[0] - self._t_submit if self._token_times else None),
            token_times=tuple(self._token_times),
            error=self._error,
        )

    def _push(self, tok: int) -> bool:
        """Record one generated token; True when the request is done.

        After a preemption clears and replays the tokens, earlier indices
        keep the stamp of their first production (the stream a caller saw),
        and only new indices feed the latency histograms."""
        srv = self._server
        t = time.monotonic()
        self._toks.append(int(tok))
        if len(self._toks) > len(self._token_times):
            self._token_times.append(t)
            if len(self._token_times) == 1:
                srv._h_ttft.observe(t - self._t_submit)
            else:
                srv._h_itl.observe(t - self._token_times[-2])
            if srv._tr is not None:
                # The same float as token_times: the trace's timings equal
                # the Result's exactly.
                srv._tr.emit("token", req=self.id, t=t, index=len(self._token_times) - 1)
        r = self.request
        if r.eos_id is not None and int(tok) == r.eos_id:
            self._finish = "eos"
        elif len(self._toks) >= r.max_new_tokens:
            self._finish = "length"
        else:
            return False
        self._t_end = t
        if srv._tr is not None:
            srv._tr.emit("retire", req=self.id, t=t, reason=self._finish)
        return True


@dataclasses.dataclass
class _PrefillTask:
    """One PREFILLING row's progress.  ``pos`` is block-aligned between
    steps.  Dense mode: ``state`` is its private batch-1 decode state,
    spliced into the slot when the last chunk has run.  Paged mode:
    ``state`` is None; each chunk runs through a batch-1 view of the live
    arena and its blocks land in the row's pooled pages
    (``Server._pt_host[row]``), the first ``len(hit)`` of them spliced from
    the prefix index, while the device page-table row stays cleared until
    the finishing chunk installs it."""

    handle: Handle
    row: int
    forced: np.ndarray   # the tokens the row's cache must come to hold
    n: int
    pos: int             # tokens chunked so far (hits included)
    hit: list            # prefix-cache pages spliced below ``pos``
    state: dict | None
    chunks: int = 0


def _leaves(tree):
    """The tensors of a nested list / dict state (None: none)."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in _leaves(sub)]
    return [] if tree is None else [tree]


class Server:
    """Slot-based continuous-batching server over the compressed KV cache."""

    def __init__(self, cfg: ModelConfig, params, scfg: ServerConfig | None = None,
                 device="cuda", q_chunk: int = 512):
        scfg = scfg if scfg is not None else ServerConfig()
        if not scfg.greedy:
            raise NotImplementedError("only greedy decoding is served for now")
        if scfg.policy not in ("fcfs", "ljf"):
            raise ValueError(f"unknown admission policy {scfg.policy!r}")
        if scfg.max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {scfg.max_slots}")
        self.device = resolve_device(device)
        if params["ln_f"].device.type != self.device.type:
            raise ValueError(f"params live on {params['ln_f'].device}, the server "
                             f"on {self.device}")
        if scfg.attn_backend is not None:
            cfg = dataclasses.replace(cfg, attn_backend=scfg.attn_backend)
        if scfg.cache_mode is not None:
            cfg = dataclasses.replace(cfg, cache_mode=scfg.cache_mode)
        if cfg.cache_mode not in ("dense", "paged"):
            raise ValueError(f"unknown cache_mode {cfg.cache_mode!r}")
        if cfg.encoder_only:
            # The reference's Server admits such a request and fails its
            # first decode step with an IndexError; refuse it up front, with
            # the same type.
            raise IndexError(f"{cfg.name} is encoder-only: it has no decode step to serve")
        self.paged = cfg.cache_mode == "paged"
        if self.paged and M.n_cache_layers(cfg) == 0:
            raise ValueError(
                "paged cache mode needs attention KV caches "
                f"(family {cfg.family!r} has none)")
        self.cfg, self.params, self.scfg = cfg, params, scfg
        self._q_chunk = q_chunk
        B = scfg.max_slots
        self._slots: list[Handle | None] = [None] * B
        self._queue: collections.deque[Handle] = collections.deque()
        self._cur = np.full(B, scfg.pad_id, np.int64)  # last token per slot
        self._pos = np.zeros(B, np.int64)              # per-row decode position
        self._seq = 0
        self._row_seq = [0] * B                        # admission order per row
        self._next_req_id = 0
        self._prefill_tasks: dict[int, _PrefillTask] = {}

        # One registry carries every counter of the server and its pool and
        # index; ``self._tr`` is the trace's hot-path gate, None when off.
        self.metrics = MetricsRegistry()
        self.trace = EventTrace(scfg.trace, scfg.trace_capacity)
        self._tr = self.trace if self.trace.enabled else None
        self._preemptions = self.metrics.counter("serve.preemptions")
        self._h_ttft = self.metrics.histogram("serve.ttft_s")
        self._h_itl = self.metrics.histogram("serve.itl_s")
        self._h_queue = self.metrics.histogram("serve.queue_wait_s")
        self._g_active = self.metrics.gauge("serve.active")
        self._g_pending = self.metrics.gauge("serve.pending")
        # Batched decode steps run (not a registry metric: the reference's
        # registry has none).
        self.decode_steps = 0
        self._pf = {k: self.metrics.counter(f"serve.prefill.{k}")
                    for k in ("prefill_tokens", "chunks", "coscheduled_tokens",
                              "stalled_decode_steps", "prefill_preemptions")}
        # Request lifecycle (DESIGN.md §15): terminal-state counters, the
        # fault plan, the periodic audit, and the no-progress detector.
        self._lc = {k: self.metrics.counter(f"serve.{k}")
                    for k in ("failures", "cancelled", "deadline_exceeded",
                              "requeues", "rejected")}
        self.faults = scfg.faults
        self.auditor = InvariantAuditor(self) if scfg.audit_every else None
        self._steps = 0
        self._progress = 0   # bumps on any token, chunk, admission, retirement
        self._stall = 0      # consecutive steps with work left and no progress
        self._has_deadlines = scfg.default_deadline_s is not None

        # Multi-device serving (DESIGN.md §12): a 1x1 mesh is no mesh, so one
        # device runs exactly the unsharded path.
        mesh = scfg.mesh
        self._n_data = self._n_model = 1
        if mesh is not None:
            n_d, n_m = serve_shard.mesh_counts(mesh)
            if n_d * n_m <= 1:
                mesh = None
            else:
                self._n_data, self._n_model = serve_shard.validate_serve_mesh(mesh, cfg, B)
                home = mesh.devices.flat[0]
                if home.type != self.device.type:
                    raise ValueError(f"the mesh's first device {home} is not where the "
                                     f"server runs ({self.device})")
                self.device = home
        self.mesh = mesh
        # The backend each shard runs: what the unsharded server dispatches.
        self._inner_backend = cfg.attn_backend
        self._slots_per_shard = B // self._n_data
        self._preempt_by_shard = [self.metrics.counter(f"serve.shard{d}.preemptions")
                                  for d in range(self._n_data)]
        # The live state's operations: models.model's, or the same shard by shard.
        self._ops = serve_shard if mesh is not None else M
        if mesh is not None:
            serve_shard.set_serve_mesh(mesh, self._inner_backend)

        # The dense twin of every cache layer's spec.  Block-chunked
        # admission (the reference's unified path) needs a pure-KV family and
        # one block size across layers; every other model, a dense or MoE one
        # with per-layer block sizes among them, takes the full-length
        # admission, whose numerics differ from the chunk path's for lossy
        # layouts (in the reference too: chunks attend earlier blocks through
        # the compressed store, the full-length prefill attends them raw).
        specs = M.cache_specs(cfg, scfg.max_seq) if M.n_cache_layers(cfg) else ()
        uniform_t = len({s.block_size for s in specs}) == 1
        self._spec0 = specs[0] if uniform_t else None
        self.prefill_unified = cfg.family in ("dense", "moe") and uniform_t
        self.prefill_chunked = scfg.prefill_mode == "chunked" and self.prefill_unified
        self._chunk_t = self._chunk_budget = None
        if self.prefill_unified:
            T = self._spec0.block_size
            budget = (scfg.prefill_chunk_tokens if scfg.prefill_chunk_tokens is not None
                      else 8 * T)
            if budget % T:
                raise ValueError(
                    f"prefill_chunk_tokens ({budget}) must be a positive multiple of "
                    f"block_size ({T}): chunked admission flushes whole blocks")
            self._chunk_t, self._chunk_budget = T, budget

        self.pool = None
        if self.paged:
            # One page is one compression block across all layers (they all
            # flush the same logical block at the same step), accounted in
            # post-compression bytes per layer.
            if len({(s.block_size, s.n_blocks) for s in specs}) > 1:
                raise ValueError("paged mode requires a uniform block_size across layers")
            per_layer = tuple(blockpool.page_nbytes(s, cfg.n_kv_heads, cfg.resolved_head_dim)
                              for s in specs)
            nb = self._spec0.n_blocks
            pool_bytes = scfg.pool_hbm_bytes
            if pool_bytes is None:
                pool_bytes = B * nb * sum(per_layer)  # the dense-equivalent footprint
            n_pages = int(pool_bytes // max(sum(per_layer), 1))
            # The page axis splits evenly over the data shards (each shard's
            # pool owns a contiguous id range): round down to a multiple.
            n_pages -= n_pages % self._n_data
            if n_pages < 1:
                raise ValueError(
                    f"pool_hbm_bytes={pool_bytes} holds no page per data shard (one "
                    f"page across layers is {sum(per_layer)} bytes, {self._n_data} "
                    "shard(s))")
            if self._n_data > 1:
                self.pool = serve_shard.ShardedPagedPool(n_pages, per_layer, self._n_data)
                shard_pools = self.pool.shards
            else:
                self.pool = blockpool.PagedBlockPool(n_pages, per_layer)
                shard_pools = [self.pool]
            # One metric tree whatever the sharding: the unsharded pool is
            # shard 0.
            for d, sp in enumerate(shard_pools):
                self.metrics.register(f"pool.shard{d}.high_water_pages", sp.m_high_water)
                self.metrics.register(f"pool.shard{d}.alloc_pages", sp.m_alloc_pages)
                self.metrics.register(f"pool.shard{d}.freed_pages", sp.m_freed_pages)
            # Host mirror of the device page tables (one logical table shared
            # by every layer): rows index slots, entries are pages.
            self._pt_host = np.full((B, nb), -1, np.int64)
            self.state = M.init_decode_state(cfg, B, scfg.max_seq, device=self.device,
                                             pool_pages=n_pages)
        else:
            self.state = M.init_decode_state(cfg, B, scfg.max_seq, device=self.device)
        if mesh is not None:
            self.state = serve_shard.shard_state(self.state, mesh)

        if scfg.prefix_cache not in ("off", "on", "noshare"):
            raise ValueError(
                f"prefix_cache must be off|on|noshare, got {scfg.prefix_cache!r}")
        self.prefix_mode = scfg.prefix_cache != "off"
        self._share = scfg.prefix_cache == "on"
        self.index = None
        self._indexes: list[PrefixIndex] = []
        if self.prefix_mode:
            if not self.paged:
                raise ValueError(
                    "prefix_cache shares pages of the pooled arena; it needs "
                    "cache_mode='paged'")
            if cfg.family not in ("dense", "moe"):
                raise ValueError(
                    "prefix_cache needs a pure-KV decode state (block-chunked "
                    f"prefill has no {cfg.family!r} step)")
            if self._share:
                # One index a data shard: a table can only point at its own
                # shard's pages, so a prefix is reusable by that shard's rows.
                self._indexes = [PrefixIndex(self._chunk_t) for _ in range(self._n_data)]
                self.index = self._indexes[0]
                for d, ix in enumerate(self._indexes):
                    self.metrics.register(f"prefix.index.shard{d}.inserted_blocks",
                                          ix.m_inserted_blocks)
                    self.metrics.register(f"prefix.index.shard{d}.evicted_blocks",
                                          ix.m_evicted_blocks)
            self._pfx = {k: self.metrics.counter(f"prefix.{k}")
                         for k in ("lookups", "hits", "hit_blocks", "reused_tokens",
                                   "prefill_tokens", "prefill_attn_pairs", "resumes",
                                   "resume_reused_blocks", "cow_breaks")}

    # -- intake ---------------------------------------------------------------
    def submit(self, request: Request) -> Handle:
        if request.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(request.prompt) < 1:
            raise ValueError("prompt must hold at least one token")
        if len(request.prompt) + request.max_new_tokens > self.scfg.max_seq:
            raise ValueError(
                f"prompt ({len(request.prompt)}) + max_new_tokens "
                f"({request.max_new_tokens}) exceeds max_seq {self.scfg.max_seq}")
        if self.paged:
            # A request must be able to run SOLO: the most pages it can ever
            # hold has to fit its data shard's pool (a row allocates from its
            # own shard only), or no amount of preemption admits it.
            need = self._lifetime_pages(request)
            cap = self.pool.n_pages if self._n_data == 1 else self.pool.per_shard
            if need > cap:
                raise ValueError(
                    f"request needs up to {need} block pages but "
                    f"{'each data shard' if self._n_data > 1 else 'the pool'} holds "
                    f"{cap}; raise ServerConfig.pool_hbm_bytes")
        if request.deadline_s is not None:
            if request.deadline_s <= 0:
                raise ValueError(f"deadline_s must be > 0, got {request.deadline_s}")
            self._has_deadlines = True
        cap = self.scfg.max_pending
        if cap is not None and len(self._queue) >= cap:
            # Bounded admission: reject, or step the server until the queue
            # drains below the cap (the no-progress detector bounds the wait).
            if self.scfg.backpressure == "reject":
                self._lc["rejected"].inc()
                raise QueueFull(
                    f"admission queue is full ({len(self._queue)} pending, "
                    f"max_pending={cap}); backpressure='reject'")
            while len(self._queue) >= cap:
                self.step()
        h = Handle(self, request)
        h.id = self._next_req_id
        self._next_req_id += 1
        if self._tr is not None:
            self._tr.emit("submit", req=h.id, t=h._t_submit,
                          prompt_len=len(request.prompt),
                          max_new_tokens=request.max_new_tokens)
        self._queue.append(h)
        return h

    def _lifetime_pages(self, request: Request) -> int:
        """Most pages a request can ever hold at once (ring-capped).  The final
        generated token retires the request before it is appended, so the
        cache peaks at prompt + max_new - 1 entries."""
        spec = self._spec0
        total = (len(request.prompt) + request.max_new_tokens - 1) // spec.block_size
        return min(total, spec.n_blocks)

    def _prefill_pages(self, request: Request) -> int:
        """Pages the full-length admission prefill writes (the prompt's whole
        blocks, ring-capped)."""
        return min(len(request.prompt) // self._spec0.block_size, self._spec0.n_blocks)

    @property
    def active(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def pending(self) -> int:
        return len(self._queue)

    @property
    def prefilling(self) -> int:
        return len(self._prefill_tasks)

    @property
    def preemptions(self) -> int:
        """Total rows evicted and requeued."""
        return self._preemptions.value

    # -- shard-local page accounting (DESIGN.md §12) ---------------------------
    # Slot ``row`` lives on data shard ``row // (max_slots / n_data)``, and
    # all of a row's pages come from that shard's pool.
    def _row_shard(self, row: int) -> int:
        return row // self._slots_per_shard if self._n_data > 1 else 0

    def _shard_pool(self, row: int):
        """The row's allocator: the flat pool unsharded, else its shard's."""
        if self._n_data == 1:
            return self.pool
        return self.pool.shards[self._row_shard(row)]

    def _shard_free(self, shard: int) -> int:
        if self._fault("pool_alloc"):
            return 0  # injected exhaustion: callers take the reclaim ladder
        if self._n_data == 1:
            return self.pool.free_pages
        return self.pool.shards[shard].free_pages

    def _alloc(self, n: int, row: int) -> list[int]:
        return self._shard_pool(row).alloc(n)

    def _index_for(self, row: int) -> PrefixIndex:
        """The prefix index of the row's data shard (sharing on)."""
        return self._indexes[self._row_shard(row)]

    # -- request lifecycle: failure isolation, cancel, deadlines ----------------
    def _fault(self, site: str) -> bool:
        """Consult the fault plan at one named injection site."""
        return self.faults is not None and self.faults.fire(site)

    def _all_handles(self) -> list[Handle]:
        """Every unfinished request the server owns, in no order."""
        return ([*self._queue]
                + [t.handle for t in self._prefill_tasks.values()]
                + [s for s in self._slots if s is not None])

    def _oldest_live_id(self) -> int:
        """Lowest submit id still in the server: the request the requeue
        budget never fails (submit ids never change, unlike ``_row_seq``)."""
        return min((h.id for h in self._all_handles()), default=-1)

    def _finalize(self, handle: Handle, reason: str, error: str | None = None,
                  **data) -> None:
        """Mark ``handle`` terminal with ``reason`` ("error" | "cancelled" |
        "deadline") after ``_evict`` released what it held; ``data`` joins
        the trace event."""
        handle._finish = reason
        handle._error = error
        if handle._t_end is None:
            handle._t_end = time.monotonic()
        kind, counter = {"error": ("fail", "failures"),
                         "cancelled": ("cancel", "cancelled"),
                         "deadline": ("deadline", "deadline_exceeded")}[reason]
        self._lc[counter].inc()
        self._progress += 1  # a retirement is progress, even an abnormal one
        if self._tr is not None:
            self._tr.emit(kind, req=handle.id, t=handle._t_end, reason=reason,
                          **({"error": error} if error else {}), **data)

    def _evict(self, handle: Handle) -> None:
        """Remove an unfinished request from the queue, its PREFILLING task
        or its decode slot, releasing its pages and its device page-table
        row.  Progress is dropped, not parked in the prefix index."""
        try:
            self._queue.remove(handle)
            return
        except ValueError:
            pass
        for row, task in self._prefill_tasks.items():
            if task.handle is handle:
                del self._prefill_tasks[row]
                if self.paged:
                    # The device row was never installed mid-prefill.
                    self._release_host_pages(row)
                return
        for row, h in enumerate(self._slots):
            if h is handle:
                self._slots[row] = None
                if self.paged:
                    self._release_row(row)
                return

    def _cancel(self, handle: Handle) -> None:
        """``Handle.cancel``: evict, then finalize as "cancelled"."""
        self._evict(handle)
        self._finalize(handle, "cancelled")

    def _deadline_of(self, handle: Handle) -> float | None:
        d = handle.request.deadline_s
        return d if d is not None else self.scfg.default_deadline_s

    def _sweep_deadlines(self) -> None:
        """Retire every request past its wall-clock bound (from submit),
        whatever its state.  Runs at the top of each step, so a queued
        request cannot outlive its deadline by the depth of the queue."""
        if not self._has_deadlines:
            return
        now = time.monotonic()
        for handle in self._all_handles():
            d = self._deadline_of(handle)
            if d is not None and now - handle._t_submit > d:
                self._evict(handle)
                self._finalize(handle, "deadline", deadline_s=d)

    # -- admission --------------------------------------------------------------
    def _forced(self, handle: Handle) -> np.ndarray:
        """The tokens a (re-)admitted request's cache must come to hold.
        Preemption clears generated tokens (decode replay regenerates them
        bit for bit), so this is the prompt."""
        return np.concatenate([np.asarray(handle.request.prompt, np.int32),
                               np.asarray(handle._toks, np.int32)])

    def _pop_next(self) -> Handle:
        if self.scfg.policy == "ljf":
            # max() keeps the first maximum: equal budgets leave in arrival order.
            pick = max(range(len(self._queue)),
                       key=lambda i: self._queue[i].request.max_new_tokens)
            h = self._queue[pick]
            del self._queue[pick]
            return h
        return self._queue.popleft()

    def _can_admit(self, handle: Handle, row: int) -> bool:
        """Memory-pressure admission (paged), on the row's data shard: the
        pages the first step's chunks flush (the whole prompt's blocks where
        they accumulate in a private state: under a mesh, and in the
        full-length admission), plus one page of decode headroom, must be
        free.  Not the request's whole lifetime: that is what lets slots
        oversubscribe, and preemption covers the over-commitment later.
        With sharing on, the shard's prefix index's hit is stashed on the
        handle and discounted (its blocks are spliced, not prefilled), and
        cold index blocks are evicted before the queue head is parked."""
        if not self.paged:
            return True
        if self._fault("pool_alloc"):
            return False  # injected exhaustion: park the queue head
        shard_pool = self._shard_pool(row)
        if not self.prefill_unified:
            need = min(self._prefill_pages(handle.request) + 1, shard_pool.n_pages)
            return shard_pool.free_pages >= need
        T, nb = self._spec0.block_size, self._spec0.n_blocks
        forced = self._forced(handle)
        n_full = len(forced) // T
        hit: list[int] = []
        if self._share and n_full <= nb:
            # Cap below the forced length so one token is left to run: its
            # logits give the next token.
            hit = self._index_for(row).lookup(forced, min((len(forced) - 1) // T, nb))
        handle._hit_pages = hit
        occupied = max(min(n_full, nb) - len(hit), 0)
        if self.prefill_chunked and self.mesh is None:
            # Pages are reserved one chunk ahead of each flush, so a long
            # prompt can start before the pool could hold all of it.
            occupied = min(self._chunk_budget // T, occupied)
        need = min(occupied + 1, shard_pool.n_pages)
        if (shard_pool.free_pages < need and self._share
                and not self._fault("prefix_evict")):
            # The hit path was just stamped most recent, and is protected as
            # well: the row does not hold its pages yet.
            self._index_for(row).evict(shard_pool, need, protect=hit)
        return shard_pool.free_pages >= need

    def _admit(self, handle: Handle, row: int) -> bool:
        """The full-length admission of the families without a chunk step
        (ssm, hybrid): prefill the request's exact prompt at batch 1 in one
        call (``model.prefill``: every attention layer's whole blocks in one
        Store call) and splice it into slot ``row``, dense or into freshly
        allocated arena pages.  Every live decode stream waits meanwhile.
        Returns False when the request finished at its prefill (a budget of
        1, or an instant EOS) and the slot stays free."""
        req = handle.request
        prompt = torch.as_tensor(np.asarray(req.prompt, np.int64)[None], device=self.device)
        if any(s is not None for s in self._slots):
            # A solo admission freezes every live decode stream.
            self._pf["stalled_decode_steps"].inc()
        t0 = time.monotonic()
        if handle._t_first is None:
            handle._t_first = t0
            self._h_queue.observe(t0 - handle._t_submit)
        if self._tr is not None:
            self._tr.emit("admit", req=handle.id, t=t0, row=row)
        logits, solo = M.prefill(self.params, self.cfg, {"tokens": prompt}, self.scfg.max_seq,
                                 q_chunk=self._q_chunk)
        first = int(torch.argmax(logits[0, -1]))
        t1 = time.monotonic()
        # Summed over preemption replays; t_start keeps the first admission.
        handle._prefill_s += t1 - t0
        if handle._t_start is None:
            handle._t_start = t1
        if handle._push(first):
            self._progress += 1  # retired at admission
            return False
        if self.paged:
            n_blk = self._prefill_pages(req)
            pages = np.full(self._spec0.n_blocks, -1, np.int64)
            pages[:n_blk] = self._alloc(n_blk, row)  # _can_admit checked they are free
            self._pt_host[row] = pages
            self._ops.insert_decode_row_paged(self.state, solo, row, self._device_pages(row))
        else:
            self._ops.insert_decode_row(self.state, solo, row)
        self._slots[row] = handle
        self._cur[row] = first
        self._pos[row] = len(req.prompt)
        self._progress += 1  # an admission is progress
        self._seq += 1
        self._row_seq[row] = self._seq
        return True

    def _start_prefill(self, handle: Handle, row: int) -> None:
        """Claim slot ``row`` as a PREFILLING task: the live arena (paged on
        one device) or a private batch-1 state (dense, or paged under a
        mesh), with any prefix hit spliced into the row's page table and
        retained as the row's own references.  The private state of a paged
        row is seeded from the hit's pages, and the pages of the prompt's
        whole blocks are reserved up front, on the row's data shard: its
        blocks reach them only at the finishing splice."""
        forced = self._forced(handle)
        n = len(forced)
        hit, handle._hit_pages = handle._hit_pages, []
        j = len(hit)
        t0 = time.monotonic()
        if handle._t_first is None:
            handle._t_first = t0
            self._h_queue.observe(t0 - handle._t_submit)
        if self._tr is not None:
            self._tr.emit("prefill_start", req=handle.id, t=t0, row=row, hit_blocks=j,
                          forced_tokens=n)
            if j:
                self._tr.emit("prefix_hit", req=handle.id, blocks=j)
        state = None
        fused = self.paged and self.mesh is None
        nb = self._spec0.n_blocks
        if j:
            self.pool.retain(hit)
        if not fused:
            if j:
                seed = np.full(nb, -1, np.int64)
                seed[:j] = hit
                state = self._ops.gather_prefix_state(
                    self.state, torch.as_tensor(seed, dtype=torch.int32), j)
            else:
                state = M.init_decode_state(self.cfg, 1, self.scfg.max_seq,
                                            device=self.device)
        if self.paged:
            pages = np.full(nb, -1, np.int64)
            pages[:j] = hit  # fused: the rest is reserved one chunk ahead
            occupied = min(n // self._chunk_t, nb)
            if not fused and occupied > j:
                pages[j:occupied] = self._alloc(occupied - j, row)
            self._pt_host[row] = pages
        if self.prefix_mode:
            if self._share:
                self._pfx["lookups"].inc()
            if j:
                self._pfx["hits"].inc()
                self._pfx["hit_blocks"].inc(j)
                self._pfx["reused_tokens"].inc(j * self._chunk_t)
            if handle._requeues:
                self._pfx["resumes"].inc()
                self._pfx["resume_reused_blocks"].inc(j)
        self._prefill_tasks[row] = _PrefillTask(
            handle=handle, row=row, forced=forced, n=n, pos=j * self._chunk_t,
            hit=hit, state=state)
        self._progress += 1  # an admission is progress
        self._seq += 1
        self._row_seq[row] = self._seq
        # The vacated slot keeps (garbage-)decoding until the row is
        # installed; pin its host vectors to something inert.
        self._cur[row] = self.scfg.pad_id
        self._pos[row] = 0

    def _claim_page(self, row: int, slot: int) -> int | None:
        """One rung of the reclaim ladders: make ``_pt_host[row, slot]`` a page
        this row holds alone.  Reuse it in place (refcount 1), or allocate
        one; a shared page is copied on write (the flush rewrites the whole
        block, so the copy is only a new page and a dropped reference).
        Returns the page newly assigned, -1 for reuse in place, None when
        the pool reads as full."""
        existing = int(self._pt_host[row, slot])
        if existing >= 0 and self.pool.refcount(existing) == 1:
            return -1  # ring wrap: overwrite our exclusive page
        if not self._shard_free(self._row_shard(row)):
            return None  # (an injected fault reads as a full pool)
        page = self._alloc(1, row)[0]
        req = self._req_at(row) if self._tr is not None else -1
        if existing >= 0:  # shared: only in prefix mode
            self.pool.release([existing])
            if self.prefix_mode:
                self._pfx["cow_breaks"].inc()
                if self._tr is not None:
                    self._tr.emit("cow_break", req=req, row=row, slot=slot, page=existing)
        self._pt_host[row, slot] = page
        if self._tr is not None:
            self._tr.emit("page_assign", req=req, row=row, slot=slot, page=page)
        return page

    def _req_at(self, row: int) -> int:
        """Id of the request on ``row``: its PREFILLING task's, else its
        decode slot's."""
        task = self._prefill_tasks.get(row)
        return task.handle.id if task is not None else self._slots[row].id

    def _reclaim(self, row: int) -> int | None:
        """The rest of the ladder once the row's shard reads as full: evict
        one cold block of the shard's index (None: retry the claim), else the
        preemption victim, the youngest row of the same shard that holds
        pages (only its pages relieve this row; -1 when the sweep finds
        none)."""
        if self._share and not self._fault("prefix_evict"):
            ev = self._index_for(row).evict(self._shard_pool(row), 1)
            if ev:
                if self._tr is not None:
                    self._tr.emit("prefix_evict", blocks=ev)
                return None
        if self._fault("reclaim_sweep"):
            return -1
        shard = self._row_shard(row)
        return next((r for r in reversed(self._live_rows_by_age())
                     if self._row_shard(r) == shard and (self._pt_host[r] >= 0).any()), -1)

    def _ensure_chunk_page(self, task: _PrefillTask, pos: int) -> bool:
        """Paged: the full chunk at ``pos`` flushes one block, so its ring slot
        needs a page this row holds alone before the chunk runs (the flush of
        an unassigned slot would be dropped).  Reuse, allocate, evict a cold
        index block, then preempt the youngest page holder.  Returns False
        when that preempted this task itself."""
        T, nb = self._spec0.block_size, self._spec0.n_blocks
        row = task.row
        slot = (pos // T) % nb
        while True:
            if self._claim_page(row, slot) is not None:
                return True
            victim = self._reclaim(row)
            if victim is None:
                continue
            if victim < 0:
                # Pool exhausted with nothing to reclaim: requeue (within
                # the budget) or fail only this task's request.
                self._preempt(row, why="pool exhausted with no reclaimable pages")
                return False
            self._preempt(victim)
            if victim == row:
                return False

    def _run_chunk(self, task: _PrefillTask, pos: int, C: int, pages):
        """One chunk of ``C`` forced tokens at ``pos``; returns its logits.
        Paged: through a batch-1 view of the live arena over ``pages``, the
        finishing chunk installing the row."""
        toks = torch.as_tensor(task.forced[None, pos:pos + C], dtype=torch.int64,
                               device=self.device)
        if task.state is not None:
            logits, _ = M.prefill_chunk(self.params, self.cfg, toks, pos, task.state)
            return logits
        view = M.chunk_state_view(self.state, pages, pos)
        logits, _ = M.prefill_chunk(self.params, self.cfg, toks, pos, view)
        if pos + C == task.n:
            M.install_chunk_row(self.state, view, task.row, pages)
        else:
            M.adopt_chunk_stores(self.state, view)
        return logits

    def _count_chunks(self, task: _PrefillTask, pos: int, k: int, C: int) -> None:
        task.chunks += k
        self._pf["chunks"].inc(k)
        if self.prefix_mode:
            self._pfx["prefill_tokens"].inc(k * C)
            self._pfx["prefill_attn_pairs"].inc(sum(
                C * (pos + i * C) + C * (C + 1) // 2 for i in range(k)))

    def _advance_task(self, task: _PrefillTask, budget: int) -> int:
        """Run whole chunks of one PREFILLING task until the budget is spent,
        the task finishes, or a page reclaim preempts it.  Where the budget
        covers several full chunks, a group of a power of two of them has
        its pages reserved first and then runs (the reference's multi-chunk
        dispatch, kept for its order of reclaims; the finishing chunk never
        joins a group when paged).  Returns prompt tokens processed."""
        T = self._chunk_t
        handle, row = task.handle, task.row
        if self._fault("chunk_prefill"):
            # Injected chunk-dispatch failure before any device work: requeue
            # (within the budget) or fail only this request.
            self._preempt(row, why="injected chunk-prefill failure")
            return 0
        spent = 0
        t0 = time.monotonic()
        while row in self._prefill_tasks:
            pos = task.pos
            C = min(T, task.n - pos)
            if spent + C > budget:
                break
            fused = task.state is None
            k = min((budget - spent) // T, (task.n - pos) // T, 8)
            if fused:
                k = min(k, (task.n - pos - 1) // T, self._spec0.n_blocks)
            kb = 1
            while kb * 2 <= k:
                kb *= 2
            if kb >= 2:
                if fused and not all(self._ensure_chunk_page(task, pos + i * T)
                                     for i in range(kb)):
                    break  # the reclaim preempted this very task
                tc = time.monotonic() if self._tr is not None else 0.0
                pages = self._device_pages(row) if fused else None
                for i in range(kb):
                    logits = self._run_chunk(task, pos + i * T, T, pages)
                if self._tr is not None:
                    self._tr.emit("prefill_chunk", req=handle.id, t=tc,
                                  dur=time.monotonic() - tc, row=row, pos=pos,
                                  tokens=kb * T, chunks=kb)
                task.pos = pos + kb * T
                spent += kb * T
                self._count_chunks(task, pos, kb, T)
                if task.pos == task.n:
                    self._finish_task(task, int(torch.argmax(logits[0])))
                    break
                continue
            if fused and C == T and not self._ensure_chunk_page(task, pos):
                break  # the reclaim preempted this very task
            tc = time.monotonic() if self._tr is not None else 0.0
            logits = self._run_chunk(task, pos, C, self._device_pages(row) if fused else None)
            if self._tr is not None:
                self._tr.emit("prefill_chunk", req=handle.id, t=tc,
                              dur=time.monotonic() - tc, row=row, pos=pos, tokens=C,
                              chunks=1)
            task.pos = pos + C
            spent += C
            self._count_chunks(task, pos, 1, C)
            if task.pos == task.n:
                self._finish_task(task, int(torch.argmax(logits[0])))
                break
        handle._prefill_s += time.monotonic() - t0
        self._pf["prefill_tokens"].inc(spent)
        self._progress += spent
        return spent

    def _device_pages(self, row: int) -> torch.Tensor:
        return torch.as_tensor(self._pt_host[row], dtype=torch.int32, device=self.device)

    def _finish_task(self, task: _PrefillTask, first: int) -> None:
        """The last chunk ran: make the row a decode slot (a private state is
        spliced in, into the row's reserved pages when paged; the live
        arena's finishing chunk already installed the row; with sharing on,
        its full prompt blocks enter its shard's index), or retire at once
        on a budget of 1 / instant EOS."""
        handle, row = task.handle, task.row
        del self._prefill_tasks[row]
        if handle._t_start is None:
            handle._t_start = time.monotonic()
        if self._tr is not None:
            self._tr.emit("prefill_finish", req=handle.id, row=row, chunks=task.chunks)
        if handle._push(first):
            # Finished at admission: the slot stays free and nothing is
            # indexed (nothing else rides on this prompt).
            if self.paged:
                self._release_row(row)
            return
        if self.paged:
            n_full = task.n // self._chunk_t
            if task.state is not None:
                self._ops.insert_decode_row_paged(self.state, task.state, row,
                                                  self._device_pages(row))
            if (self._share and n_full and n_full <= self._spec0.n_blocks
                    and not self._fault("prefix_insert")):
                self._index_for(row).insert(task.forced,
                                            self._pt_host[row][:n_full].tolist(), self.pool)
        else:
            self._ops.insert_decode_row(self.state, task.state, row)
        self._slots[row] = handle
        self._cur[row] = first
        self._pos[row] = task.n

    def _run_prefill_budget(self, budget: int, decoding: bool) -> int:
        """Spend the step's prompt-token budget on carried-over PREFILLING
        rows, oldest admission first.  Returns the unspent budget."""
        for row in sorted(self._prefill_tasks, key=lambda r: self._row_seq[r]):
            if budget < 1:
                break
            task = self._prefill_tasks.get(row)
            if task is None:
                continue  # preempted by an earlier task's page reclaim
            spent = self._advance_task(task, budget)
            budget -= spent
            if decoding:
                self._pf["coscheduled_tokens"].inc(spent)
        return budget

    # -- paged page-fault sweep and preemption ----------------------------------
    def _live_rows_by_age(self) -> list[int]:
        """Decoding and prefilling rows, oldest admission first: both hold
        pages, so both are preemption candidates."""
        rows = [r for r, s in enumerate(self._slots) if s is not None]
        rows += list(self._prefill_tasks)
        return sorted(rows, key=lambda r: self._row_seq[r])

    def _release_host_pages(self, row: int) -> None:
        """Drop the row's references on its pages (a page shared with the
        index or another row survives) and clear its host table row."""
        held = self._pt_host[row][self._pt_host[row] >= 0]
        if len(held):
            self.pool.release(held.tolist())
        self._pt_host[row] = -1

    def _release_row(self, row: int) -> None:
        """Release the row's pages and unassign its device page-table row, so
        the slot's continuing idle decode can never write into pages
        re-issued to another request.  The row's token, position and cache
        lengths stay, as in the reference: the idle row keeps decoding on
        them, and under MoE its routing shares the batch's expert capacity
        with the live rows."""
        self._release_host_pages(row)
        self._ops.clear_cache_row(self.state, row)

    def _park(self, row: int, tokens, flushed: int) -> None:
        """Sharing on: put the row's first ``flushed`` blocks into the index
        before its references drop, so re-admission resumes from them."""
        if (self._share and 0 < flushed <= self._spec0.n_blocks
                and not self._fault("prefix_insert")):
            self._index_for(row).insert(tokens, self._pt_host[row][:flushed].tolist(),
                                        self.pool)

    def _preempt(self, row: int, why: str | None = None) -> None:
        """Evict a live or prefilling request and requeue it at the head.

        Its generated tokens are cleared and its pages released; with
        sharing on, its prompt-complete blocks are parked in the index first,
        so re-admission splices them back and chunks only the rest of the
        prompt.  Blocks that hold decode-computed positions are never
        parked: chunk-path bits are not decode bits, and a resume that
        recomputed such a block through the chunk path could flip a near-tie
        argmax.  Greedy decode at the same batch shape regenerates the same
        tokens, so results change only in latency.

        Every preemption spends one unit of the request's ``max_requeues``
        budget.  Over budget the request fails alone (finish_reason
        "error"), unless it is the oldest request in the server: submit
        guarantees that one fits solo, so the workload drains.  ``why``
        names the pressure in the failure message."""
        in_task = row in self._prefill_tasks
        handle = self._prefill_tasks[row].handle if in_task else self._slots[row]
        handle._requeues += 1
        if (handle._requeues > self.scfg.max_requeues
                and handle.id != self._oldest_live_id()):
            self._evict(handle)
            self._finalize(handle, "error", error=(
                f"{why or 'preemption storm'}: request {handle.id} preempted "
                f"{handle._requeues} times with max_requeues={self.scfg.max_requeues}"))
            return
        self._lc["requeues"].inc()
        T = self._spec0.block_size
        task = self._prefill_tasks.pop(row, None)
        if task is not None:
            if self.paged:
                # Through the live arena, every full chunk so far flushed its
                # block into this row's pages; a private state's blocks never
                # reached them (they die with it), so nothing is parked.  A
                # half-prefilled row's device row was never installed, so
                # only the host side releases.
                if task.state is None:
                    self._park(row, task.forced,
                               min(task.pos // T, len(handle.request.prompt) // T))
                self._release_host_pages(row)
            self._pf["prefill_preemptions"].inc()
        else:
            self._slots[row] = None
            # The cache holds _pos tokens; slot i still holds block i only
            # while the ring has not wrapped (the park checks flushed <= nb).
            self._park(row, np.asarray(handle.request.prompt, np.int32),
                       min(int(self._pos[row]) // T, len(handle.request.prompt) // T))
            self._release_row(row)
        handle._toks.clear()
        self._queue.appendleft(handle)
        self._preemptions.inc()
        self._preempt_by_shard[self._row_shard(row)].inc()
        if self._tr is not None:
            self._tr.emit("preempt", req=handle.id, row=row, prefilling=task is not None)

    def _ensure_pages(self) -> None:
        """Give every decoding row whose buffer flushes on the NEXT decode
        step a page it holds alone (the flush of an unassigned slot is
        dropped).  Ring wraparound reuses the slot's page in place, or copies
        it on write when the index or another row shares it.  On exhaustion:
        evict a cold index block, then preempt the youngest page holder;
        submit() guarantees that any request fits solo, so the sweep ends
        with the oldest row progressing."""
        T, nb = self._spec0.block_size, self._spec0.n_blocks
        grants = []
        for row in self._live_rows_by_age():
            if self._slots[row] is None:
                continue  # prefilling, or preempted earlier in this sweep
            pos = int(self._pos[row])
            if (pos + 1) % T:
                continue  # this step only appends to the raw buffer
            slot = ((pos + 1) // T - 1) % nb
            while True:
                page = self._claim_page(row, slot)
                if page is not None:
                    if page >= 0:
                        grants.append((row, slot, page))
                    break
                victim = self._reclaim(row)
                if victim is None:
                    continue
                if victim < 0:
                    # Nothing to reclaim: requeue (within the budget) or
                    # fail only this row's request.
                    self._preempt(row, why="pool exhausted with no reclaimable pages")
                    break
                self._preempt(victim)
                if victim == row:
                    break
        # A row granted a page early in the sweep can be preempted later in
        # it (a younger zero-page row's victim scan picks the youngest page
        # HOLDER).  Its page went back to the free list and may already be
        # re-issued, so its grant must not re-point the cleared device row.
        grants = [g for g in grants if self._slots[g[0]] is not None]
        if grants:
            rows, slots, pages = (torch.as_tensor(x, device=self.device)
                                  for x in zip(*grants))
            self._ops.assign_cache_pages(self.state, rows, slots, pages.to(torch.int32))

    # -- the step ---------------------------------------------------------------
    def step(self) -> bool:
        """One scheduler step: the deadline sweep, admission and chunked
        prefill, one batched decode.  Returns True while work remains
        (active, prefilling, queued).

        Then the periodic audit, and the no-progress detector: a server that
        made no progress for ``stall_steps`` steps with work left raises a
        ``ServeError`` naming the stuck request, unless a deadline pends
        (wall-clock time will retire that request)."""
        self._sweep_deadlines()
        p0 = self._progress
        more = self._step_inner()
        self._steps += 1
        if self.auditor is not None and self._steps % self.scfg.audit_every == 0:
            self.auditor.check()
        if not more or self._progress != p0:
            self._stall = 0
            return more
        if any(self._deadline_of(h) is not None for h in self._all_handles()):
            self._stall = 0
            return more
        self._stall += 1
        if self._stall >= self.scfg.stall_steps:
            stuck = min(self._all_handles(), key=lambda h: h.id)
            where = ("queued" if stuck in self._queue else
                     "prefilling" if any(t.handle is stuck
                                         for t in self._prefill_tasks.values())
                     else "decoding")
            pool = (f", free_pages={self.pool.free_pages}/{self.pool.n_pages}"
                    if self.paged else "")
            raise ServeError(
                f"no progress for {self._stall} consecutive steps; request "
                f"{stuck.id} ({where}, submitted "
                f"{time.monotonic() - stuck._t_submit:.1f}s ago) appears stuck "
                f"(active={self.active}, prefilling={self.prefilling}, "
                f"pending={self.pending}{pool})")
        return more

    def _step_inner(self) -> bool:
        if self.mesh is not None:
            # Another Server may have rebound the inner backend since.
            serve_shard.set_serve_mesh(self.mesh, self._inner_backend)
        free = [i for i, s in enumerate(self._slots)
                if s is None and i not in self._prefill_tasks]
        decoding = any(s is not None for s in self._slots)
        # Carried-over tasks spend the budget first; a task finishing here
        # joins this step's decode and indexes its blocks before the sweep's
        # next lookup, so co-arriving shared prompts reuse each other.
        budget = self._chunk_budget if self.prefill_chunked else 0
        if self._prefill_tasks:
            budget = self._run_prefill_budget(budget, decoding)
        while free and self._queue:
            handle = self._pop_next()
            if self.paged and self._n_data > 1:
                # The free slot whose data shard has the most free pages (a
                # slot pins its row to a shard); ties go to the lowest row.
                row = min(free, key=lambda r: (-self._shard_free(self._row_shard(r)), r))
            else:
                row = free[0]
            if not self._can_admit(handle, row):
                self._queue.appendleft(handle)  # pool pressure: park it
                break
            if not self.prefill_unified:
                if self._admit(handle, row):
                    free.remove(row)
                continue
            self._start_prefill(handle, row)
            free.remove(row)
            task = self._prefill_tasks[row]
            if not self.prefill_chunked:
                if decoding:
                    self._pf["stalled_decode_steps"].inc()
                self._advance_task(task, task.n)
            elif budget >= 1:
                spent = self._advance_task(task, budget)
                budget -= spent
                if decoding:
                    self._pf["coscheduled_tokens"].inc(spent)
            if self._queue and self._queue[0] is handle:
                break  # the chunk loop preempted itself: the pool is too tight
            if row not in self._prefill_tasks and self._slots[row] is None:
                free.append(row)  # finished (and retired) at admission
        if self.paged:
            self._ensure_pages()
        rows = [i for i, s in enumerate(self._slots) if s is not None]
        if not rows:
            return bool(self._queue) or bool(self._prefill_tasks)
        if self._fault("decode_dispatch"):
            # Injected transient failure before the launch: the state is
            # untouched and the next step retries with the same inputs.
            return True
        full = self._tr is not None and self._tr.full
        td = time.monotonic() if full else 0.0
        logits, _ = M.decode_step(
            self.params, self.cfg, torch.as_tensor(self._cur, device=self.device),
            torch.as_tensor(self._pos, device=self.device), self.state)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        if full:
            # One span a batched decode step; the copy to the host above
            # waited for the card, so ``dur`` covers device time too.
            self._tr.emit("decode_step", t=td, dur=time.monotonic() - td, rows=len(rows))
        self.decode_steps += 1
        self._progress += len(rows)
        for row in rows:
            tok = int(nxt[row])
            self._cur[row] = tok
            self._pos[row] += 1
            if self._slots[row]._push(tok):
                self._slots[row] = None  # retire; the slot is reused next step
                if self.paged:
                    self._release_row(row)
        return (bool(self._queue) or bool(self._prefill_tasks)
                or any(s is not None for s in self._slots))

    def run(self) -> None:
        """Drain: step until every submitted request has finished."""
        while self.step():
            pass

    def memory_report(self) -> dict:
        """``cache_memory_report`` of the live decode state (all slots)."""
        return cache_memory_report(self.cfg, self.state)

    def stats(self) -> dict:
        """Serving stats: a view over ``self.metrics``, with the reference's
        key tree, one schema whatever the mesh (``pool`` in paged mode, with
        ``per_shard``; ``prefix`` in prefix mode; ``shards`` with one entry a
        data shard, one unsharded)."""
        self._g_active.set(self.active)
        self._g_pending.set(self.pending)
        s = {
            "cache_mode": "paged" if self.paged else "dense",
            "active": self.active,
            "pending": self.pending,
            "preemptions": self._preemptions.value,
            "prefill": {
                "mode": "chunked" if self.prefill_chunked else "solo",
                "chunk_tokens": self._chunk_budget,
                "prefilling": len(self._prefill_tasks),
                "inflight_tokens": sum(t.n - t.pos for t in self._prefill_tasks.values()),
                **{k: c.value for k, c in self._pf.items()},
            },
            "latency": {
                "ttft_s": self._h_ttft.snapshot(),
                "itl_s": self._h_itl.snapshot(),
                "queue_wait_s": self._h_queue.snapshot(),
            },
            "trace": {
                "level": self.trace.level,
                "events": len(self.trace.events),
                "dropped": self.trace.dropped,
            },
            "lifecycle": {"submitted": self._next_req_id,
                          **{k: c.value for k, c in self._lc.items()}},
        }
        per_pool = None
        if self.paged:
            per_pool = (self.pool.shard_stats() if self._n_data > 1
                        else [self.pool.stats()])
            s["pool"] = {**self.pool.stats(), "per_shard": per_pool}
        s["shards"] = {
            "n_data": self._n_data,
            "n_model": self._n_model,
            "per_shard": [
                {"preemptions": self._preempt_by_shard[d].value,
                 **({k: per_pool[d][k] for k in ("pages_live", "pages_free",
                                                  "high_water_pages")}
                    if per_pool is not None else {})}
                for d in range(self._n_data)],
        }
        if self.prefix_mode:
            p = {k: c.value for k, c in self._pfx.items()}
            p["mode"] = self.scfg.prefix_cache
            p["hit_rate"] = (p["hits"] / p["lookups"]) if p["lookups"] else 0.0
            if self._share:
                p["index"] = PrefixIndex.merge_stats(self._indexes)
            s["prefix"] = p
        return s

    def shutdown(self, metrics_out=None, trace_out=None) -> dict:
        """Export the final telemetry and return the snapshot (DESIGN.md
        §14): ``{"stats", "metrics"}``, with ``audit`` and ``faults`` when
        the server has an auditor or a fault plan.  ``metrics_out`` writes
        it as JSON and the Prometheus text next to it (the suffix swapped
        for ``.prom``); ``trace_out`` writes the Chrome trace-event JSON
        when tracing is on (open it at ui.perfetto.dev).  The server stays
        usable: "shutdown" names the lifecycle hook, not a teardown."""
        snap = {"stats": self.stats(), "metrics": self.metrics.snapshot()}
        if self.auditor is not None:
            snap["audit"] = self.auditor.report()
        if self.faults is not None:
            snap["faults"] = self.faults.stats()
        if metrics_out:
            out = Path(metrics_out)
            out.write_text(json.dumps(snap, indent=2, default=float))
            out.with_suffix(".prom").write_text(self.metrics.prometheus_text())
        if trace_out and self.trace.enabled:
            self.trace.write_chrome(trace_out)
        return snap


def cache_memory_report(cfg: ModelConfig, state) -> dict:
    """Measured bytes of a decode state, the reference's report:
    ``kv_bytes`` the KV caches (in paged mode the whole arena and the page
    tables; under a mesh, the unsharded cache's bytes summed over the
    shards), ``total_bytes`` those plus the SSM states, ``layout`` the
    config's; under a per-layer policy also ``per_layer_layouts``, each
    layer's resolved layout (the reference then holds its caches one a
    layer, where a uniform policy stacks them)."""
    caches = state.get("kv", ())
    kv = sum(c.nbytes() if isinstance(c, serve_shard.ShardedLayerCache) else
             sum(getattr(c, f).numel() * getattr(c, f).element_size() for f in c.FIELDS)
             for c in caches)
    other = sum(t.numel() * t.element_size()
                for key, sub in state.items() if key != "kv" for t in _leaves(sub))
    rep = {"total_bytes": int(kv + other), "kv_bytes": int(kv), "layout": cfg.cache_layout}
    if caches and not cfg.compression_policy().uniform:
        rep["per_layer_layouts"] = [c.spec.layout for c in caches]
    return rep
