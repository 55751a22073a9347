"""Continuous-batching scheduler over the compressed KV cache (the port of
``repro.serve.scheduler``), dense and paged.

The server owns a ring of decode **slots** over one live decode state and
an admission queue:

    submit -> queue -> [admit: block-chunked prefill interleaved with decode]
           -> decode steps (every slot at its own position)
           -> retire at EOS / length -> slot reused by the next request

Admission is the reference's unified chunk loop: a queued prompt claims a
free slot as a PREFILLING row and runs ``block_size``-token chunks
(``model.prefill_chunk``) on a private batch-1 state, at most
``ServerConfig.prefill_chunk_tokens`` prompt tokens per server step
("chunked", the default), or all of them at admission ("solo", the
blocking baseline; the same numerics, so the same tokens).  The finished
state is spliced into its slot (``model.insert_decode_row``).  Every step
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
the pool runs dry the youngest page holder is preempted: its pages are
freed, its generated tokens cleared, and it is requeued at the head, where
it replays its prompt; greedy decode then regenerates the same tokens.  The
host keeps a mirror of the page table (``_pt_host``) and of every row's
position, so the sweep and the table updates read nothing from the device.

The server is cooperative: ``Handle.result`` / ``Handle.tokens`` pump
``Server.step`` until their request completes; ``Server.run`` drains.

Options that belong to later slices of the port (the prefix cache,
sharding, event tracing, fault injection, deadlines and backpressure) raise
``NotImplementedError``.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Iterator

import numpy as np
import torch

from repro_torch.core import pool as blockpool
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.obs.metrics import MetricsRegistry


@dataclasses.dataclass
class Request:
    prompt: np.ndarray  # int32 [S]
    max_new_tokens: int = 32
    eos_id: int | None = None
    deadline_s: float | None = None  # a later slice (lifecycle)


@dataclasses.dataclass
class Result:
    tokens: np.ndarray   # int32 [n], n <= max_new_tokens — truncated at eos_id
    prompt_len: int
    gen_s: float         # wall time from prefill end to last token
    prefill_s: float     # this request's own prefill wall time
    finish_reason: str = "length"  # "eos" | "length"
    queue_wait_s: float = 0.0
    ttft_s: float = 0.0            # submit to first token
    token_times: tuple = ()        # monotonic emission time of every token


# Options of later slices: field -> (the value this slice serves, the slice).
_LATER = {
    "prefix_cache": ("off", "the prefix cache"),
    "mesh": (None, "multi-GPU sharded serving"),
    "trace": ("off", "lifecycle, faults and telemetry"),
    "faults": (None, "lifecycle, faults and telemetry"),
    "audit_every": (0, "lifecycle, faults and telemetry"),
    "max_pending": (None, "lifecycle, faults and telemetry (backpressure)"),
    "default_deadline_s": (None, "lifecycle, faults and telemetry (deadlines)"),
}


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
    # "chunked" interleaves prompt chunks with decode; "solo" drains every
    # chunk at admission (the blocking baseline, same tokens).
    prefill_mode: str = "chunked"
    # Per-step chunked-prefill token budget, a positive multiple of the cache
    # block_size; None = 8 blocks.
    prefill_chunk_tokens: int | None = None
    # Paged mode: the arena's byte budget across all layers; None = the
    # dense-equivalent footprint (max_slots full rings).
    pool_hbm_bytes: int | None = None
    # Later slices of the port (raise NotImplementedError when set).
    prefix_cache: str = "off"
    mesh: object | None = None
    trace: str = "off"
    faults: object = None
    audit_every: int = 0
    max_pending: int | None = None
    default_deadline_s: float | None = None

    def __post_init__(self):
        for name, (served, where) in _LATER.items():
            if getattr(self, name) != served:
                raise NotImplementedError(
                    f"ServerConfig.{name}={getattr(self, name)!r} belongs to a "
                    f"later slice of the port ({where})")
        if self.cache_mode not in (None, "dense", "paged"):
            raise ValueError(f"cache_mode must be dense|paged, got {self.cache_mode!r}")
        if self.prefill_mode not in ("chunked", "solo"):
            raise ValueError(
                f"prefill_mode must be chunked|solo, got {self.prefill_mode!r}")
        if self.prefill_chunk_tokens is not None and self.prefill_chunk_tokens < 1:
            raise ValueError(
                "prefill_chunk_tokens must be a positive multiple of the "
                f"cache block_size, got {self.prefill_chunk_tokens}")


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
        self._prefill_s = 0.0
        self._t_submit = time.monotonic()
        self._t_first: float | None = None  # first prefill work
        self._t_start: float | None = None  # first admission's prefill end
        self._t_end: float | None = None
        self._token_times: list[float] = []

    @property
    def done(self) -> bool:
        return self._finish is not None

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
        return Result(
            tokens=np.asarray(self._toks, np.int32),
            prompt_len=len(self.request.prompt),
            gen_s=self._t_end - self._t_start,
            prefill_s=self._prefill_s,
            finish_reason=self._finish,
            queue_wait_s=self._t_first - self._t_submit,
            ttft_s=self._token_times[0] - self._t_submit,
            token_times=tuple(self._token_times),
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
        r = self.request
        if r.eos_id is not None and int(tok) == r.eos_id:
            self._finish = "eos"
        elif len(self._toks) >= r.max_new_tokens:
            self._finish = "length"
        else:
            return False
        self._t_end = t
        return True


@dataclasses.dataclass
class _PrefillTask:
    """One PREFILLING row's progress.  Dense mode: ``state`` is its private
    batch-1 decode state, spliced into the slot when the last chunk has run.
    Paged mode: ``state`` is None; each chunk runs through a batch-1 view of
    the live arena and its blocks land in the row's pooled pages
    (``Server._pt_host[row]``), while the device page-table row stays
    cleared until the finishing chunk installs it."""

    handle: Handle
    row: int
    prompt: np.ndarray
    pos: int     # tokens chunked so far (block-aligned between steps)
    state: dict | None
    chunks: int = 0


class Server:
    """Slot-based continuous-batching server over the compressed KV cache."""

    def __init__(self, cfg: ModelConfig, params, scfg: ServerConfig | None = None,
                 device="cuda"):
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
        self.paged = cfg.cache_mode == "paged"
        self.cfg, self.params, self.scfg = cfg, params, scfg
        B = scfg.max_slots
        self._slots: list[Handle | None] = [None] * B
        self._queue: collections.deque[Handle] = collections.deque()
        self._cur = np.full(B, scfg.pad_id, np.int64)  # last token per slot
        self._pos = np.zeros(B, np.int64)              # per-row decode position
        self._seq = 0
        self._row_seq = [0] * B                        # admission order per row
        self._next_req_id = 0
        self._prefill_tasks: dict[int, _PrefillTask] = {}

        self.metrics = MetricsRegistry()
        self._preemptions = self.metrics.counter("serve.preemptions")
        self._h_ttft = self.metrics.histogram("serve.ttft_s")
        self._h_itl = self.metrics.histogram("serve.itl_s")
        self._h_queue = self.metrics.histogram("serve.queue_wait_s")
        self._decode_steps = self.metrics.counter("serve.decode_steps")
        self._pf = {k: self.metrics.counter(f"serve.prefill.{k}")
                    for k in ("prefill_tokens", "chunks", "coscheduled_tokens",
                              "stalled_decode_steps", "prefill_preemptions")}

        # The dense twin of every layer's spec: uniform blocks are what
        # block-chunked admission (and one page id for all layers) needs.
        specs = M.cache_specs(cfg, scfg.max_seq)
        if len({s.block_size for s in specs}) != 1:
            raise NotImplementedError(
                "per-layer block sizes need the full-length prefill admission "
                "of a later slice of the port")
        self._spec0 = specs[0]
        T = self._spec0.block_size
        budget = scfg.prefill_chunk_tokens if scfg.prefill_chunk_tokens is not None else 8 * T
        if budget % T:
            raise ValueError(
                f"prefill_chunk_tokens ({budget}) must be a positive multiple of "
                f"block_size ({T}): chunked admission flushes whole blocks")
        self._chunk_t, self._chunk_budget = T, budget
        self.prefill_chunked = scfg.prefill_mode == "chunked"

        self.pool = None
        if self.paged:
            # One page is one compression block across all layers (they all
            # flush the same logical block at the same step), accounted in
            # post-compression bytes per layer.
            per_layer = tuple(blockpool.page_nbytes(s, cfg.n_kv_heads, cfg.resolved_head_dim)
                              for s in specs)
            nb = self._spec0.n_blocks
            pool_bytes = scfg.pool_hbm_bytes
            if pool_bytes is None:
                pool_bytes = B * nb * sum(per_layer)  # the dense-equivalent footprint
            n_pages = int(pool_bytes // max(sum(per_layer), 1))
            if n_pages < 1:
                raise ValueError(
                    f"pool_hbm_bytes={pool_bytes} holds no page (one page across "
                    f"layers is {sum(per_layer)} bytes)")
            self.pool = blockpool.PagedBlockPool(n_pages, per_layer)
            # The unsharded pool is shard 0, under the reference's names.
            self.metrics.register("pool.shard0.high_water_pages", self.pool.m_high_water)
            self.metrics.register("pool.shard0.alloc_pages", self.pool.m_alloc_pages)
            self.metrics.register("pool.shard0.freed_pages", self.pool.m_freed_pages)
            # Host mirror of the device page tables (one logical table shared
            # by every layer): rows index slots, entries are pages.
            self._pt_host = np.full((B, nb), -1, np.int64)
            self.state = M.init_decode_state(cfg, B, scfg.max_seq, device=self.device,
                                             pool_pages=n_pages)
        else:
            self.state = M.init_decode_state(cfg, B, scfg.max_seq, device=self.device)

    # -- intake ---------------------------------------------------------------
    def submit(self, request: Request) -> Handle:
        if request.deadline_s is not None:
            raise NotImplementedError(
                "request deadlines belong to a later slice of the port "
                "(lifecycle, faults and telemetry)")
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
            # hold has to fit the pool, or no amount of preemption admits it.
            need = self._lifetime_pages(request)
            if need > self.pool.n_pages:
                raise ValueError(
                    f"request needs up to {need} block pages but the pool holds "
                    f"{self.pool.n_pages}; raise ServerConfig.pool_hbm_bytes")
        h = Handle(self, request)
        h.id = self._next_req_id
        self._next_req_id += 1
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
        """Pages the admission prefill writes (full prompt blocks, ring-capped)."""
        spec = self._spec0
        return min(len(request.prompt) // spec.block_size, spec.n_blocks)

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

    # -- admission --------------------------------------------------------------
    def _pop_next(self) -> Handle:
        if self.scfg.policy == "ljf":
            # max() keeps the first maximum: equal budgets leave in arrival order.
            pick = max(range(len(self._queue)),
                       key=lambda i: self._queue[i].request.max_new_tokens)
            h = self._queue[pick]
            del self._queue[pick]
            return h
        return self._queue.popleft()

    def _can_admit(self, handle: Handle) -> bool:
        """Memory-pressure admission (paged): the pages the first step's
        chunks flush, plus one page of decode headroom, must be free.  Not
        the request's whole lifetime: that is what lets slots oversubscribe,
        and preemption covers the over-commitment later.  Chunked admission
        reserves pages one chunk ahead of each flush, so a long prompt can
        start before the pool could hold all of it."""
        if not self.paged:
            return True
        occupied = self._prefill_pages(handle.request)
        if self.prefill_chunked:
            occupied = min(self._chunk_budget // self._chunk_t, occupied)
        return self.pool.free_pages >= min(occupied + 1, self.pool.n_pages)

    def _start_prefill(self, handle: Handle, row: int) -> _PrefillTask:
        t0 = time.monotonic()
        if handle._t_first is None:
            handle._t_first = t0
            self._h_queue.observe(t0 - handle._t_submit)
        state = None
        if self.paged:
            self._pt_host[row] = -1  # pages are reserved one chunk ahead
        else:
            state = M.init_decode_state(self.cfg, 1, self.scfg.max_seq, device=self.device)
        task = _PrefillTask(handle=handle, row=row,
                            prompt=np.asarray(handle.request.prompt, np.int64),
                            pos=0, state=state)
        self._prefill_tasks[row] = task
        self._seq += 1
        self._row_seq[row] = self._seq
        # The vacated slot keeps (garbage-)decoding until the row is
        # installed; pin its host vectors to something inert.
        self._cur[row] = self.scfg.pad_id
        self._pos[row] = 0
        return task

    def _ensure_chunk_page(self, task: _PrefillTask, pos: int) -> bool:
        """Paged: the full chunk at ``pos`` flushes one block, so its ring slot
        needs a physical page before the chunk runs (the flush of an
        unassigned slot would be dropped).  Reuse the slot's own page on ring
        wrap, allocate, or preempt the youngest page holder.  Returns False
        when that preempted this task itself."""
        T, nb = self._spec0.block_size, self._spec0.n_blocks
        row = task.row
        slot = (pos // T) % nb
        while True:
            if self._pt_host[row, slot] >= 0:
                return True  # ring wrap: overwrite our own page
            if self.pool.free_pages:
                self._pt_host[row, slot] = self.pool.alloc(1)[0]
                return True
            victim = self._youngest_page_holder()
            self._preempt(victim)
            if victim == row:
                return False

    def _advance_task(self, task: _PrefillTask, budget: int) -> int:
        """Run whole chunks of one PREFILLING task until the budget is spent,
        the task finishes, or a page reclaim preempts it.  Returns prompt
        tokens processed."""
        T, n = self._chunk_t, len(task.prompt)
        row = task.row
        spent = 0
        t0 = time.monotonic()
        while row in self._prefill_tasks:
            pos = task.pos
            C = min(T, n - pos)
            if spent + C > budget:
                break
            toks = torch.as_tensor(task.prompt[None, pos:pos + C], device=self.device)
            if task.state is not None:
                logits, _ = M.prefill_chunk(self.params, self.cfg, toks, pos, task.state)
            else:
                if C == T and not self._ensure_chunk_page(task, pos):
                    break  # the reclaim preempted this very task
                pages = torch.as_tensor(self._pt_host[row], dtype=torch.int32,
                                        device=self.device)
                view = M.chunk_state_view(self.state, pages, pos)
                logits, _ = M.prefill_chunk(self.params, self.cfg, toks, pos, view)
                if pos + C == n:
                    M.install_chunk_row(self.state, view, row, pages)
                else:
                    M.adopt_chunk_stores(self.state, view)
            task.pos = pos + C
            task.chunks += 1
            spent += C
            self._pf["chunks"].inc()
            if task.pos == n:
                self._finish_task(task, int(torch.argmax(logits[0])))
        task.handle._prefill_s += time.monotonic() - t0
        self._pf["prefill_tokens"].inc(spent)
        return spent

    def _finish_task(self, task: _PrefillTask, first: int) -> None:
        """The last chunk ran: make the row a decode slot (dense: splice the
        private state in; paged: the finishing chunk already installed it),
        or retire at once on a budget of 1 / instant EOS."""
        handle, row = task.handle, task.row
        del self._prefill_tasks[row]
        if handle._t_start is None:
            handle._t_start = time.monotonic()
        if handle._push(first):
            if self.paged:
                self._release_row(row)
            return
        if not self.paged:
            M.insert_decode_row(self.state, task.state, row)
        self._slots[row] = handle
        self._cur[row] = first
        self._pos[row] = len(task.prompt)

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

    def _youngest_page_holder(self) -> int:
        """The preemption victim: the youngest row that holds pages (a row
        with none would lose progress without freeing a byte).  A full pool
        always has one, since only rows hold pages."""
        for r in reversed(self._live_rows_by_age()):
            if (self._pt_host[r] >= 0).any():
                return r
        raise RuntimeError("the pool is full but no row holds a page")

    def _release_row(self, row: int) -> None:
        """Free the row's pages and clear its device row (page-table row and
        lengths) together with the host mirrors of its position, so the
        slot's continuing idle decode can never write into pages re-issued
        to another request."""
        held = self._pt_host[row][self._pt_host[row] >= 0]
        if len(held):
            self.pool.release(held.tolist())
        self._pt_host[row] = -1
        M.clear_cache_row(self.state, row)
        self._cur[row] = self.scfg.pad_id
        self._pos[row] = 0

    def _preempt(self, row: int) -> None:
        """Evict a live or prefilling request and requeue it at the head.

        Its pages are freed and its generated tokens cleared; re-admission
        replays the prompt through the same chunk loop, and greedy decode at
        the same batch shape regenerates the identical tokens, so results
        (and a ``Handle.tokens()`` stream in flight) change only in latency.
        A half-prefilled row's device page-table row was never installed,
        so only its host pages release."""
        task = self._prefill_tasks.pop(row, None)
        if task is not None:
            handle = task.handle
            held = self._pt_host[row][self._pt_host[row] >= 0]
            if len(held):
                self.pool.release(held.tolist())
            self._pt_host[row] = -1
            self._pf["prefill_preemptions"].inc()
        else:
            handle = self._slots[row]
            self._slots[row] = None
            self._release_row(row)
        handle._toks.clear()
        self._queue.appendleft(handle)
        self._preemptions.inc()

    def _ensure_pages(self) -> None:
        """Assign a physical page to every decoding row whose buffer flushes
        on the NEXT decode step (the flush of an unassigned slot is dropped).
        Ring wraparound (sliding-window specs) reuses the slot's page in
        place.  On exhaustion the youngest page holder is preempted until the
        flush fits; submit() guarantees that any request fits solo, so the
        sweep ends with the oldest row progressing."""
        T, nb = self._spec0.block_size, self._spec0.n_blocks
        grants = []
        for row in self._live_rows_by_age():
            if self._slots[row] is None:
                continue  # prefilling, or preempted earlier in this sweep
            pos = int(self._pos[row])
            if (pos + 1) % T:
                continue  # this step only appends to the raw buffer
            slot = ((pos + 1) // T - 1) % nb
            while self._slots[row] is not None:
                if self._pt_host[row, slot] >= 0:
                    break  # ring wrap: overwrite our own page
                if self.pool.free_pages:
                    page = self.pool.alloc(1)[0]
                    self._pt_host[row, slot] = page
                    grants.append((row, slot, page))
                    break
                self._preempt(self._youngest_page_holder())
        # A row granted a page early in the sweep can be preempted later in
        # it (a younger zero-page row's victim scan picks the youngest page
        # HOLDER).  Its page went back to the free list and may already be
        # re-issued, so its grant must not re-point the cleared device row.
        grants = [g for g in grants if self._slots[g[0]] is not None]
        if grants:
            rows, slots, pages = (torch.as_tensor(x, device=self.device)
                                  for x in zip(*grants))
            M.assign_cache_pages(self.state, rows, slots, pages.to(torch.int32))

    # -- the step ---------------------------------------------------------------
    def step(self) -> bool:
        """Admission + chunked prefill, then one batched decode over the live
        slots.  Returns True while work remains (active, prefilling, queued)."""
        free = [i for i, s in enumerate(self._slots)
                if s is None and i not in self._prefill_tasks]
        decoding = any(s is not None for s in self._slots)
        budget = self._chunk_budget if self.prefill_chunked else 0
        if self._prefill_tasks:
            budget = self._run_prefill_budget(budget, decoding)
        while free and self._queue:
            handle = self._pop_next()
            if not self._can_admit(handle):
                self._queue.appendleft(handle)  # pool pressure: park it
                break
            row = free.pop(0)
            task = self._start_prefill(handle, row)
            if not self.prefill_chunked:
                if decoding:
                    self._pf["stalled_decode_steps"].inc()
                self._advance_task(task, len(task.prompt))
            elif budget >= 1:
                spent = self._advance_task(task, budget)
                budget -= spent
                if decoding:
                    self._pf["coscheduled_tokens"].inc(spent)
            if self._queue and self._queue[0] is handle:
                break  # the chunk loop preempted itself: the pool is too tight
            if row not in self._prefill_tasks and self._slots[row] is None:
                free.insert(0, row)  # finished (and retired) at admission
        if self.paged:
            self._ensure_pages()
        rows = [i for i, s in enumerate(self._slots) if s is not None]
        if not rows:
            return bool(self._queue) or bool(self._prefill_tasks)
        logits, _ = M.decode_step(
            self.params, self.cfg, torch.as_tensor(self._cur, device=self.device),
            torch.as_tensor(self._pos, device=self.device), self.state)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        self._decode_steps.inc()
        for row in rows:
            tok = int(nxt[row])
            self._cur[row] = tok
            self._pos[row] += 1
            if self._slots[row]._push(tok):
                self._slots[row] = None  # retire; the slot is reused next step
                if self.paged:
                    self._release_row(row)
                else:
                    M.clear_cache_row(self.state, row)
        return (bool(self._queue) or bool(self._prefill_tasks)
                or any(s is not None for s in self._slots))

    def run(self) -> None:
        """Drain: step until every submitted request has finished."""
        while self.step():
            pass

    def memory_report(self) -> dict:
        """Measured bytes of the live decode state (all slots; in paged mode
        the whole arena and the page tables)."""
        kv = sum(getattr(c, f).numel() * getattr(c, f).element_size()
                 for c in self.state["kv"] for f in c.FIELDS)
        return {"total_bytes": int(kv), "kv_bytes": int(kv),
                "layout": self.cfg.cache_layout}

    def stats(self) -> dict:
        """Serving stats: a view over ``self.metrics``, with the reference's
        keys (``pool`` in paged mode; ``shards`` with one entry, as an
        unsharded reference server reports)."""
        s = {
            "cache_mode": "paged" if self.paged else "dense",
            "active": self.active,
            "pending": self.pending,
            "preemptions": self._preemptions.value,
            "decode_steps": self._decode_steps.value,
            "prefill": {
                "mode": "chunked" if self.prefill_chunked else "solo",
                "chunk_tokens": self._chunk_budget,
                "prefilling": len(self._prefill_tasks),
                "inflight_tokens": sum(len(t.prompt) - t.pos
                                       for t in self._prefill_tasks.values()),
                **{k: c.value for k, c in self._pf.items()},
            },
            "latency": {
                "ttft_s": self._h_ttft.snapshot(),
                "itl_s": self._h_itl.snapshot(),
                "queue_wait_s": self._h_queue.snapshot(),
            },
            "lifecycle": {"submitted": self._next_req_id},
        }
        shard = {"preemptions": self._preemptions.value}
        if self.paged:
            ps = self.pool.stats()
            s["pool"] = {**ps, "per_shard": [ps]}
            shard.update(pages_live=ps["pages_live"], pages_free=ps["pages_free"],
                         high_water_pages=ps["high_water_pages"])
        s["shards"] = {"n_data": 1, "n_model": 1, "per_shard": [shard]}
        return s
