"""Structured scheduler event trace with Perfetto-loadable export
(DESIGN.md §14; the port's own copy of ``repro.obs.trace``, pure Python).

Every scheduler decision the Server makes — admit, prefill chunk splice,
page-fault sweep outcome, CoW break, prefix hit/evict, preempt/requeue,
slot retire, token emission — lands here as one tuple in a bounded ring
buffer, stamped with the *same* ``time.monotonic()`` floats the serving
``Result`` is built from.  That identity is the contract: per-request
timings reconstructed from the trace (``request_timings``) equal
``Result.ttft_s`` / ``Result.token_times`` **exactly** (float-for-float,
asserted in ``tests/test_torch_obs.py``), so a Perfetto timeline and a latency
report can never disagree.

Event vocabulary (``kind`` / required payload):

=================  ==========================================================
``submit``         request entered the queue (``t`` = ``Handle._t_submit``)
``admit``          legacy solo admission claimed a slot
``prefill_start``  chunked admission claimed a slot (``hit_blocks`` spliced)
``prefill_chunk``  one chunk dispatch (``dur`` = host dispatch span,
                   ``pos``/``tokens`` = chunk placement)
``prefill_finish`` all forced tokens flushed; row joins the decode batch
``page_assign``    page-fault sweep bound ``page`` to (``row``, ``slot``)
``cow_break``      ring wrap hit a shared page; row re-pointed to a private
                   one (``page`` = the shared page released)
``prefix_hit``     admission lookup matched ``blocks`` cached blocks
``prefix_evict``   admission pressure evicted ``blocks`` index blocks
``preempt``        live row evicted + requeued (``prefilling`` flags a
                   half-prefilled victim)
``retire``         request finished (``reason`` = eos|length)
``fail``           request failed in isolation (``reason`` = "error",
                   ``error`` = the human-readable cause; DESIGN.md §15)
``cancel``         request cancelled via ``Handle.cancel()``
``deadline``       request retired by its deadline (``deadline_s`` = the
                   effective bound it exceeded)
``token``          one generated token (``t`` = its ``token_times`` stamp,
                   ``index`` = its position in the stream)
``decode_step``    one batched decode dispatch (level ``full`` only;
                   ``rows`` = live batch width, ``dur`` = host wall)
=================  ==========================================================

Levels: ``off`` records nothing (the Server skips the call sites entirely —
zero events, zero added dispatches), ``events`` records every scheduler
decision above except the per-step firehose, ``full`` adds ``decode_step``.
The buffer is a ``deque(maxlen=capacity)``: a long run keeps the most
recent window and counts what it dropped instead of growing without bound.

``to_chrome()`` exports the ring as Chrome trace-event JSON ("traceEvents"
array, microsecond timestamps) that loads directly in Perfetto /
``chrome://tracing``: one named track (tid) per request carrying its
queue -> prefill-chunk -> decode spans plus token/preempt instants, and a
``scheduler`` track (tid 0) for row-addressed pool events.
"""

from __future__ import annotations

import collections
import json
import time

__all__ = ["Event", "EventTrace", "TRACE_LEVELS", "EVENT_KINDS"]

TRACE_LEVELS = ("off", "events", "full")

EVENT_KINDS = (
    "submit", "admit", "prefill_start", "prefill_chunk", "prefill_finish",
    "page_assign", "cow_break", "prefix_hit", "prefix_evict",
    "preempt", "retire", "fail", "cancel", "deadline", "token", "decode_step",
)

# Kinds that end a request's lifecycle (DESIGN.md §15 state machine); the
# reconstruction below treats them all as the request's terminal event.
_TERMINAL_KINDS = ("retire", "fail", "cancel", "deadline")

Event = collections.namedtuple("Event", ("t", "kind", "req", "step", "data"))


class EventTrace:
    """Ring-buffered scheduler event log (one per Server)."""

    def __init__(self, level: str = "off", capacity: int = 65536):
        if level not in TRACE_LEVELS:
            raise ValueError(
                f"trace level must be one of {TRACE_LEVELS}, got {level!r}")
        if capacity < 1:
            raise ValueError(f"trace capacity must be >= 1, got {capacity}")
        self.level = level
        self.capacity = int(capacity)
        self.events: collections.deque[Event] = collections.deque(
            maxlen=self.capacity)
        self.emitted = 0  # total ever emitted (dropped = emitted - len)

    @property
    def enabled(self) -> bool:
        return self.level != "off"

    @property
    def full(self) -> bool:
        return self.level == "full"

    @property
    def dropped(self) -> int:
        return self.emitted - len(self.events)

    def emit(self, kind: str, req: int = -1, step: int = -1,
             t: float | None = None, **data) -> None:
        """Record one event.  ``t`` defaults to now; call sites that share a
        stamp with ``Result`` timing (submit/token) pass it explicitly so
        trace and result can never drift apart."""
        self.events.append(Event(
            time.monotonic() if t is None else t, kind, req, step, data))
        self.emitted += 1

    # -- reconstruction -------------------------------------------------------
    def request_timings(self) -> dict:
        """Per-request timing rebuilt purely from the ring: ``{req: {
        "submit", "first_work", "ttft_s", "token_times", "retired",
        "reason"}}``.  Uses the raw monotonic floats, so for any request
        whose full event span is still in the ring these equal the
        ``Result`` fields exactly."""
        out: dict[int, dict] = {}
        for e in self.events:
            if e.req < 0:
                continue
            r = out.setdefault(e.req, {"submit": None, "first_work": None,
                                       "ttft_s": None, "token_times": [],
                                       "retired": False, "reason": None})
            if e.kind == "submit":
                r["submit"] = e.t
            elif e.kind in ("admit", "prefill_start"):
                if r["first_work"] is None:
                    r["first_work"] = e.t
            elif e.kind == "token":
                i = e.data["index"]
                ts = r["token_times"]
                if i == len(ts):
                    ts.append(e.t)
            elif e.kind in _TERMINAL_KINDS:
                r["retired"] = True
                r["reason"] = e.data.get("reason")
        for r in out.values():
            if r["token_times"] and r["submit"] is not None:
                r["ttft_s"] = r["token_times"][0] - r["submit"]
            r["token_times"] = tuple(r["token_times"])
        return out

    # -- Chrome / Perfetto export ---------------------------------------------
    def to_chrome(self, pid: int = 1) -> dict:
        """Chrome trace-event JSON dict: ``json.dump`` it and load the file
        in Perfetto (ui.perfetto.dev) or ``chrome://tracing``.  Requests
        become named threads of one ``kvcomp.server`` process; derived
        spans (queue, prefill, decode) are synthesized from the event pairs
        so the timeline reads without knowing the vocabulary."""
        evs: list[dict] = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": "kvcomp.server"},
        }, {
            "name": "thread_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": "scheduler"},
        }]

        def us(t: float) -> float:
            return t * 1e6

        # Named per-request tracks.  tid 0 is the scheduler; requests map to
        # tid = req + 1 so request 0 keeps its own lane.
        reqs = sorted({e.req for e in self.events if e.req >= 0})
        for r in reqs:
            evs.append({"name": "thread_name", "ph": "M", "pid": pid,
                        "tid": r + 1, "args": {"name": f"req {r}"}})

        spans: dict[int, dict] = {r: {} for r in reqs}
        for e in self.events:
            tid = e.req + 1 if e.req >= 0 else 0
            args = {"step": e.step, **e.data}
            if e.kind in ("prefill_chunk", "decode_step"):
                evs.append({"name": e.kind, "ph": "X", "pid": pid, "tid": tid,
                            "ts": us(e.t), "dur": us(e.data.get("dur", 0.0)),
                            "args": args})
                continue
            if e.req >= 0:
                s = spans[e.req]
                if e.kind == "submit":
                    s["submit"] = e.t
                elif e.kind in ("admit", "prefill_start"):
                    s.setdefault("work", e.t)
                elif e.kind == "prefill_finish":
                    s.setdefault("decode", e.t)
                elif e.kind == "token":
                    s.setdefault("decode", e.t)
                    s["last"] = e.t
                elif e.kind in _TERMINAL_KINDS:
                    s["retire"] = e.t
            evs.append({"name": e.kind, "ph": "i", "pid": pid, "tid": tid,
                        "ts": us(e.t), "s": "t", "args": args})

        for r, s in spans.items():
            sub, work = s.get("submit"), s.get("work")
            end = s.get("retire", s.get("last"))
            if sub is not None and work is not None:
                evs.append({"name": "queue", "ph": "X", "pid": pid,
                            "tid": r + 1, "ts": us(sub),
                            "dur": us(work - sub), "args": {}})
            dec = s.get("decode")
            if dec is not None and end is not None and end >= dec:
                evs.append({"name": "decode", "ph": "X", "pid": pid,
                            "tid": r + 1, "ts": us(dec),
                            "dur": us(end - dec), "args": {}})
        return {"traceEvents": evs,
                "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped,
                              "level": self.level}}

    def write_chrome(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
