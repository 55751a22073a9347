"""Deterministic fault injection and invariant auditing for the serving
stack (the port of ``repro.serve.faults``; DESIGN.md §15).

* ``FaultPlan``: a *seeded*, deterministic schedule of failures at named
  scheduler sites.  The Server consults ``plan.fire(site)`` at each
  decision point; a firing site makes the scheduler take its failure or
  reclaim path (an empty free list, a victimless reclaim sweep, a failing
  chunk dispatch, ...) without any real resource misbehaving.  The same
  ``(seed, rates, at)`` and the same sequence of visits give the same
  firing pattern in any process, and the reference's plan gives it too: the
  schedule is numpy only.
* ``InvariantAuditor``: cross-checks the Server's redundant bookkeeping
  after a scheduler step: the pool's free/live partition and refcount
  balance against the page tables and the prefix index, the host page-table
  mirror against the device tables, and slot/queue/task accounting.

``ServeError`` is the lifecycle error the scheduler raises when it can prove
it is stuck (the no-progress detector), and the base of ``QueueFull``
(bounded-admission rejection).
"""

from __future__ import annotations

import zlib

import numpy as np

__all__ = [
    "FAULT_SITES", "FaultInjected", "FaultPlan",
    "InvariantAuditor", "InvariantViolation",
    "QueueFull", "ServeError",
]

# The named injection sites the scheduler consults.  Each names a decision,
# and firing it forces the pessimistic branch:
#
# ==================  ======================================================
# ``pool_alloc``      a free-page check reads 0: the caller takes its
#                     reclaim ladder (evict index blocks, preempt) as if
#                     the arena were full
# ``reclaim_sweep``   the preemption victim scan comes up empty: the
#                     "pool exhausted with no reclaimable pages" path
#                     (requeue within the budget, else fail the request)
# ``prefix_evict``    a prefix-index eviction reclaims nothing this round
# ``prefix_insert``   indexing or parking flushed blocks is skipped (the
#                     pages release instead of entering the index)
# ``chunk_prefill``   a chunked-prefill dispatch fails before launching:
#                     the task's request is requeued (bounded) or failed
# ``decode_dispatch`` the batched decode fails before launching: the step
#                     skips decoding and retries next step (state untouched,
#                     tokens only delayed)
# ==================  ======================================================
FAULT_SITES = ("pool_alloc", "reclaim_sweep", "prefix_evict",
               "prefix_insert", "chunk_prefill", "decode_dispatch")


class ServeError(RuntimeError):
    """A request-lifecycle error the Server can attribute and explain: a
    provably stuck server, or a rejected submit."""


class QueueFull(ServeError):
    """``Server.submit`` past ``ServerConfig.max_pending`` under the
    "reject" backpressure policy: the admission queue is at capacity."""


class FaultInjected(RuntimeError):
    """Marker for an injected failure (never escapes the Server)."""


class InvariantViolation(AssertionError):
    """The auditor found the Server's redundant bookkeeping disagreeing."""


class FaultPlan:
    """Seeded deterministic failure schedule over the named ``FAULT_SITES``.

    Two triggers a site, combined:

    * ``at``: exact 1-based visit indices, ``{"reclaim_sweep": (1, 3)}``
      fires the first and third time the scheduler consults that site.
    * ``rates``: a probability a visit, ``{"pool_alloc": 0.05}``, drawn from
      a generator of the site's own seeded by ``(seed, crc32(site))``, so a
      printed seed replays the same schedule.

    ``fire(site)`` is the only hot-path call; ``fired`` records every
    (site, visit index) that fired.
    """

    def __init__(self, seed: int = 0, rates: dict | None = None,
                 at: dict | None = None):
        self.seed = int(seed)
        self.rates = {str(k): float(v) for k, v in (rates or {}).items()}
        self.at = {str(k): frozenset(int(i) for i in v)
                   for k, v in (at or {}).items()}
        for site in (*self.rates, *self.at):
            if site not in FAULT_SITES:
                raise ValueError(
                    f"unknown fault site {site!r}; sites are {FAULT_SITES}")
        for site, p in self.rates.items():
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"rate for {site!r} must be in [0, 1], got {p}")
        self.visits = {s: 0 for s in FAULT_SITES}
        self.fired: list[tuple[str, int]] = []
        # One generator a site: the firing order at one site never perturbs
        # another's schedule.
        self._rng = {s: np.random.default_rng((self.seed,
                                               zlib.crc32(s.encode())))
                     for s in self.rates}

    def fire(self, site: str) -> bool:
        """Count one visit to ``site`` and decide whether it faults."""
        n = self.visits[site] = self.visits[site] + 1
        hit = n in self.at.get(site, ())
        rate = self.rates.get(site, 0.0)
        if rate and self._rng[site].random() < rate:
            hit = True
        if hit:
            self.fired.append((site, n))
        return hit

    def stats(self) -> dict:
        return {"seed": self.seed,
                "visits": dict(self.visits),
                "fired": [list(f) for f in self.fired]}

    def __repr__(self):
        return (f"FaultPlan(seed={self.seed}, rates={self.rates}, "
                f"at={dict((k, sorted(v)) for k, v in self.at.items())})")


class InvariantAuditor:
    """Cross-checks a live ``Server``'s redundant bookkeeping.

    The Server keeps some facts in two places on purpose (host page-table
    mirror and device tables, pool refcounts and the rows and index that
    hold the references, free list and live set), because the host side
    drives admission without reading the device.  The auditor recomputes
    each fact and reports every disagreement:

    1.  **Pool partition**, per shard pool: ``free + live == n_pages``, the
        free list holds no duplicate and no live page, every live page has
        refcount >= 1.
    2.  **Refcount balance**: every page's refcount equals the row
        page-table entries that reference it (decoding *and* PREFILLING
        rows) plus the prefix-index nodes (of every shard's index) that hold
        it.
    3.  **Aliasing and affinity**: no row references one page twice, and a
        row's pages all come from its own data shard's pool.
    4.  **Host and device page tables**: a decoding row's device row equals
        the host mirror on every layer (and, under a mesh, on every model
        shard, in global ids); PREFILLING and free rows are fully unassigned
        (-1) on the device (the write-drop guarantee).
    5.  **Slot/queue/task accounting**: slots and prefill tasks are
        disjoint, no finished handle is still scheduled, no handle appears
        twice, ``pending`` matches the queue.

    ``audit()`` returns the violations (empty = clean) and accumulates them
    for ``report()``; ``check()`` raises ``InvariantViolation``.  An audit
    of a paged server reads the device page tables (a device sync).
    """

    def __init__(self, server):
        self.server = server
        self.audits = 0
        self.violations: list[str] = []

    def _shard_pools(self) -> list:
        pool = self.server.pool
        return list(getattr(pool, "shards", [pool]))

    def _scheduled_rows(self) -> tuple[set, set]:
        srv = self.server
        live = {r for r, s in enumerate(srv._slots) if s is not None}
        return live, set(srv._prefill_tasks)

    # -- the audit ------------------------------------------------------------
    def audit(self) -> list[str]:
        srv = self.server
        bad: list[str] = []
        live_rows, task_rows = self._scheduled_rows()

        # 5. slot/queue/task accounting (dense mode too)
        if live_rows & task_rows:
            bad.append(f"rows both decoding and prefilling: "
                       f"{sorted(live_rows & task_rows)}")
        seen: dict[int, str] = {}
        placements = (
            [(h, "queue") for h in srv._queue]
            + [(srv._slots[r], f"slot{r}") for r in live_rows]
            + [(t.handle, f"task{r}") for r, t in srv._prefill_tasks.items()])
        for h, where in placements:
            if h.id in seen:
                bad.append(f"req {h.id} scheduled twice: "
                           f"{seen[h.id]} and {where}")
            seen[h.id] = where
            if h.done:
                bad.append(f"req {h.id} is finished ({h._finish!r}) "
                           f"but still scheduled at {where}")
        if srv.pending != len(srv._queue):
            bad.append(f"pending={srv.pending} != queue len {len(srv._queue)}")

        if srv.paged:
            bad += self._audit_pages(live_rows, task_rows)

        self.audits += 1
        if bad:
            self.violations.extend(bad)
        return bad

    def _audit_pages(self, live_rows: set, task_rows: set) -> list[str]:
        srv = self.server
        bad: list[str] = []
        pt = srv._pt_host
        B = pt.shape[0]

        # 1. pool partition, per shard pool
        for pool in self._shard_pools():
            at = f"pool@{pool.offset}"
            free = pool._free
            if len(set(free)) != len(free):
                bad.append(f"{at}: duplicate free pages")
            overlap = set(free) & pool._live
            if overlap:
                bad.append(f"{at}: pages both free and live: {sorted(overlap)[:8]}")
            if pool.free_pages + pool.live_pages != pool.n_pages:
                bad.append(f"{at}: free({pool.free_pages}) + live({pool.live_pages}) "
                           f"!= n_pages({pool.n_pages})")
            if set(pool._ref) != pool._live:
                bad.append(f"{at}: refcount keys != live set")
            for p, c in pool._ref.items():
                if c < 1:
                    bad.append(f"{at}: live page {p} has refcount {c}")

        # 2./3. refcount balance, aliasing and shard affinity
        expected: dict[int, int] = {}
        scheduled = live_rows | task_rows
        for row in range(B):
            pages = pt[row][pt[row] >= 0]
            if row not in scheduled:
                if len(pages):
                    bad.append(f"unscheduled row {row} still holds pages "
                               f"{pages.tolist()}")
                continue
            if len(set(pages.tolist())) != len(pages):
                bad.append(f"row {row} references a page twice: "
                           f"{pages.tolist()}")
            own = srv._shard_pool(row)
            for p in pages.tolist():
                expected[p] = expected.get(p, 0) + 1
                if not own.owns(p):
                    bad.append(f"row {row} (shard {srv._row_shard(row)}) references "
                               f"foreign page {p}")
        for ix in srv._indexes:
            for p in ix.indexed_pages():
                expected[p] = expected.get(p, 0) + 1
        actual = {}
        for pool in self._shard_pools():
            actual.update(pool._ref)
        for p in sorted(set(expected) | set(actual)):
            e, a = expected.get(p, 0), actual.get(p, 0)
            if e != a:
                bad.append(f"page {p}: pool refcount {a} but "
                           f"{e} referencing owners (rows + index nodes)")

        # 4. device page tables mirror the host (every layer; under a mesh
        # every model shard's, in global ids)
        tabs = []
        for i, c in enumerate(srv.state["kv"]):
            if srv.mesh is None:
                tabs.append((c.page_tab.cpu().numpy().astype(np.int64), f"layer{i}"))
            else:
                tabs += [(t.cpu().numpy().astype(np.int64), f"layer{i}.model{m}")
                         for m, t in enumerate(c.global_page_tabs())]
        for dev, name in tabs:
            for row in range(B):
                want = pt[row] if row in live_rows else np.full_like(pt[row], -1)
                if not np.array_equal(dev[row], want):
                    state = ("live" if row in live_rows else
                             "prefilling" if row in task_rows else "free")
                    bad.append(
                        f"{name} device page table row {row} ({state}) = "
                        f"{dev[row].tolist()} but host expects {want.tolist()}")
            if len(tabs) > 1 and not np.array_equal(dev, tabs[0][0]):
                bad.append(f"{name} page table differs from layer0")
        return bad

    def check(self) -> None:
        bad = self.audit()
        if bad:
            raise InvariantViolation(
                f"invariant audit #{self.audits} found {len(bad)} "
                "violation(s):\n  " + "\n  ".join(bad))

    def report(self) -> dict:
        return {"audits": self.audits,
                "violations": list(self.violations),
                "clean": not self.violations}
