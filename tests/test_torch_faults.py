"""The port's request lifecycle (``repro_torch.serve.faults`` and the
Server's cancel, deadlines, backpressure, requeue budget and fault sites;
DESIGN.md §15), held against the reference on the CPU:

* ``FaultPlan`` is deterministic, and the port's plan fires exactly where
  the reference's does over the same visits;
* a pool-exhaustion event fails or requeues only the request it strikes;
  every survivor's greedy tokens equal a fault-free run's, and the
  ``InvariantAuditor`` stays clean;
* cancel and deadlines retire a request from any state through one cleanup
  path; backpressure rejects or blocks; a stuck server raises ``ServeError``
  unless a deadline pends; the auditor catches seeded corruption;
* the seeded chaos soak (rates at every site) over dense/off, paged/off and
  paged/on: survivors equal the fault-free run, and against the reference
  with the same seed the finish reasons, errors, surviving tokens and the
  plan's fired schedule are equal.
"""

import dataclasses
import os
import sys
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; intra-op threads only oversubscribe them
jax = pytest.importorskip("jax")

from repro.models import registry as JR  # noqa: E402
from repro.serve import faults as JF  # noqa: E402
from repro.serve import scheduler as JS  # noqa: E402
from repro_torch.core import pool as TP  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.serve.faults import (FAULT_SITES, FaultPlan,  # noqa: E402
                                      InvariantViolation, QueueFull, ServeError)
from repro_torch.serve.scheduler import Request, Server, ServerConfig  # noqa: E402
import test_torch_shared as cached  # noqa: E402

# A failure prints this seed; exporting it replays the same schedule.
CHAOS_SEED = int(os.environ.get("REPRO_CHAOS_SEED", "20260808"))

LENS = (7, 13, 19, 26)
NEWS = (3, 6, 4, 5)


# ---------------------------------------------------------------------------
# FaultPlan
# ---------------------------------------------------------------------------


def test_fault_plan_rates_deterministic_and_equal_to_reference():
    rates = {"reclaim_sweep": 0.3, "pool_alloc": 0.1}
    a, b, ref = FaultPlan(seed=7, rates=rates), FaultPlan(seed=7, rates=rates), \
        JF.FaultPlan(seed=7, rates=rates)
    order = ["reclaim_sweep", "pool_alloc"] * 200
    seq_a = [a.fire(s) for s in order]
    assert seq_a == [b.fire(s) for s in order] == [ref.fire(s) for s in order]
    assert a.fired == b.fired == ref.fired
    assert a.stats() == ref.stats()
    assert any(seq_a) and not all(seq_a)
    # a site's schedule does not depend on the other sites' visits
    c = FaultPlan(seed=7, rates=rates)
    only = [c.fire("reclaim_sweep") for _ in range(200)]
    assert only == [f for f, s in zip(seq_a, order) if s == "reclaim_sweep"]
    d = FaultPlan(seed=8, rates=rates)
    assert [d.fire("reclaim_sweep") for _ in range(200)] != only


def test_fault_plan_at_exact_visits_and_stats():
    p = FaultPlan(at={"chunk_prefill": (1, 3)})
    assert [p.fire("chunk_prefill") for _ in range(5)] == [True, False, True, False, False]
    assert p.fired == [("chunk_prefill", 1), ("chunk_prefill", 3)]
    st = p.stats()
    assert st["visits"]["chunk_prefill"] == 5
    assert st["fired"] == [["chunk_prefill", 1], ["chunk_prefill", 3]]
    assert not p.fire("pool_alloc")
    assert p.stats()["visits"]["pool_alloc"] == 1
    assert FAULT_SITES == JF.FAULT_SITES
    assert repr(p) == repr(JF.FaultPlan(at={"chunk_prefill": (1, 3)}))


def test_fault_plan_validation():
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultPlan(rates={"gpu_on_fire": 1.0})
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultPlan(at={"nope": (1,)})
    with pytest.raises(ValueError, match=r"in \[0, 1\]"):
        FaultPlan(rates={"pool_alloc": 1.5})


def test_server_config_lifecycle_validation():
    ok = dict(max_slots=2, max_seq=64)
    for field, bad in (("max_requeues", -1), ("max_pending", 0), ("backpressure", "drop"),
                       ("default_deadline_s", 0.0), ("audit_every", -1), ("stall_steps", 0)):
        with pytest.raises(ValueError, match=field):
            ServerConfig(**ok, **{field: bad})


# ---------------------------------------------------------------------------
# Server integration
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(JR.get_smoke_config("yi_6b"), cache_layout="packed",
                               cache_block=8)
    tcfg = dataclasses.replace(TR.get_smoke_config("yi_6b"), cache_layout="packed",
                               cache_block=8)
    jp, tp = cached.params(jcfg)
    rng = np.random.default_rng(3)
    shared = rng.integers(0, tcfg.vocab_size, 16).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, tcfg.vocab_size, L).astype(np.int32)])
               for L in LENS]
    return jcfg, tcfg, jp, tp, prompts


@pytest.fixture(scope="module")
def pressure(setup):
    """Pressure from decode growth: short prompts admit easily onto a
    6-page pool, then each ring grows toward 5 pages, so two live rows
    overcommit the arena and the reclaim ladder runs mid-decode."""
    tcfg = setup[1]
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tcfg.vocab_size, L).astype(np.int32) for L in (8, 9, 10, 11)]
    return prompts, (40, 38, 36, 34)


def page_bytes(cfg) -> int:
    return sum(TP.page_nbytes(s, cfg.n_kv_heads, cfg.resolved_head_dim)
               for s in TM.cache_specs(cfg, 128))


def make_server(tcfg, tp, **kw):
    return Server(tcfg, tp, ServerConfig(max_slots=2, max_seq=128, **kw), device="cpu")


def run_all(server, prompts, news=NEWS):
    handles = [server.submit(Request(prompt=p, max_new_tokens=n))
               for p, n in zip(prompts, news)]
    server.run()
    return handles, [h.result() for h in handles]


def lifecycle(server) -> dict:
    return server.stats()["lifecycle"]


@pytest.mark.parametrize("pfx", ["off", "on"])
def test_pool_exhaustion_fails_only_the_victim(setup, pressure, pfx):
    """The victim sweep forced empty with no requeue budget: only the
    requesting stream fails, survivors equal the fault-free run under the
    same pool, and refcounts balance."""
    _, tcfg, _, tp, _ = setup
    prompts, news = pressure
    pool = dict(cache_mode="paged", prefix_cache=pfx, pool_hbm_bytes=6 * page_bytes(tcfg))
    clean = make_server(tcfg, tp, **pool, audit_every=1)
    _, base = run_all(clean, prompts, news)
    assert all(r.finish_reason in ("eos", "length") for r in base)
    assert clean.preemptions > 0
    assert clean.auditor.report()["clean"]
    plan = FaultPlan(rates={"reclaim_sweep": 1.0})
    srv = make_server(tcfg, tp, **pool, faults=plan, max_requeues=0, audit_every=1)
    _, res = run_all(srv, prompts, news)
    failed = [i for i, r in enumerate(res) if r.finish_reason == "error"]
    assert failed and len(failed) < len(res)
    for i in failed:
        assert "pool exhausted with no reclaimable pages" in res[i].error
        assert f"request {i}" in res[i].error
    for i, r in enumerate(res):
        if i not in failed:
            assert r.finish_reason == base[i].finish_reason
            assert r.tokens.tolist() == base[i].tokens.tolist(), i
            assert r.error is None
    assert srv.auditor.report()["clean"], srv.auditor.report()
    assert lifecycle(srv)["failures"] == len(failed)
    assert plan.fired


def test_requeue_backoff_within_budget_is_invisible(setup, pressure):
    _, tcfg, _, tp, _ = setup
    prompts, news = pressure
    pool = dict(cache_mode="paged", pool_hbm_bytes=6 * page_bytes(tcfg))
    _, base = run_all(make_server(tcfg, tp, **pool), prompts, news)
    srv = make_server(tcfg, tp, **pool, faults=FaultPlan(rates={"reclaim_sweep": 1.0}),
                      max_requeues=8, audit_every=1)
    _, res = run_all(srv, prompts, news)
    assert [r.tokens.tolist() for r in res] == [r.tokens.tolist() for r in base]
    assert all(r.finish_reason in ("eos", "length") for r in res)
    lc = lifecycle(srv)
    assert lc["failures"] == 0 and lc["requeues"] > 0
    assert srv.auditor.report()["clean"]


def test_chunk_prefill_fault_requeues_one_task(setup):
    _, tcfg, _, tp, prompts = setup
    _, base = run_all(make_server(tcfg, tp), prompts)
    plan = FaultPlan(at={"chunk_prefill": (1,)})
    srv = make_server(tcfg, tp, faults=plan, audit_every=1)
    _, res = run_all(srv, prompts)
    assert [r.tokens.tolist() for r in res] == [r.tokens.tolist() for r in base]
    lc = lifecycle(srv)
    assert lc["requeues"] == 1 and lc["failures"] == 0
    assert plan.fired == [("chunk_prefill", 1)]
    assert srv.auditor.report()["clean"]


def test_decode_dispatch_fault_only_delays(setup):
    _, tcfg, _, tp, prompts = setup
    _, base = run_all(make_server(tcfg, tp), prompts)
    plan = FaultPlan(seed=1, rates={"decode_dispatch": 0.5})
    srv = make_server(tcfg, tp, audit_every=1, faults=plan)
    _, res = run_all(srv, prompts)
    assert [r.tokens.tolist() for r in res] == [r.tokens.tolist() for r in base]
    assert lifecycle(srv)["failures"] == 0 and plan.fired
    assert srv.auditor.report()["clean"]


def test_cancel_queued_and_live(setup):
    """Cancel a queued request (no tokens, no slot) and a decoding one
    (partial tokens kept): pages released, the others unchanged."""
    _, tcfg, _, tp, prompts = setup
    _, base = run_all(make_server(tcfg, tp, cache_mode="paged", prefix_cache="on"), prompts)
    srv = make_server(tcfg, tp, cache_mode="paged", prefix_cache="on", audit_every=1)
    handles = [srv.submit(Request(prompt=p, max_new_tokens=n)) for p, n in zip(prompts, NEWS)]
    assert handles[3].cancel()
    assert not handles[3].cancel()
    srv.step()
    assert srv._slots[0] is handles[0]  # decoding now
    assert handles[0].cancel()
    srv.run()
    res = [h.result() for h in handles]
    assert res[3].finish_reason == "cancelled"
    assert len(res[3].tokens) == 0 and res[3].ttft_s is None
    assert res[3].gen_s == 0.0 and res[3].error is None
    assert res[0].finish_reason == "cancelled" and len(res[0].tokens) >= 1
    for i in (1, 2):
        assert res[i].finish_reason == base[i].finish_reason
        assert res[i].tokens.tolist() == base[i].tokens.tolist()
    lc = lifecycle(srv)
    assert lc["cancelled"] == 2 and lc["failures"] == 0
    assert srv.stats()["latency"]["ttft_s"]["count"] == sum(1 for r in res if len(r.tokens))
    assert srv.auditor.report()["clean"]
    assert srv.pool.live_pages == srv.index.n_blocks


def test_cancel_prefilling(setup):
    """Cancel a half-prefilled row: its host pages return, the device row
    was never installed, the auditor stays clean."""
    _, tcfg, _, tp, prompts = setup
    srv = make_server(tcfg, tp, cache_mode="paged", prefill_chunk_tokens=8, audit_every=1)
    h = srv.submit(Request(prompt=prompts[3], max_new_tokens=4))
    srv.step()
    assert srv.prefilling == 1 and srv.pool.live_pages >= 1
    assert h.cancel()
    assert srv.prefilling == 0 and srv.pool.live_pages == 0
    assert srv.auditor.audit() == []
    assert h.result().finish_reason == "cancelled"


def test_deadlines_default_and_per_request(setup):
    _, tcfg, _, tp, prompts = setup
    srv = make_server(tcfg, tp, cache_mode="paged", default_deadline_s=1e-6, audit_every=1)
    _, res = run_all(srv, prompts)
    assert all(r.finish_reason == "deadline" for r in res)
    assert all(len(r.tokens) == 0 and r.ttft_s is None and r.gen_s == 0.0 for r in res)
    assert lifecycle(srv)["deadline_exceeded"] == len(res)
    assert srv.stats()["latency"]["ttft_s"]["count"] == 0
    assert srv.auditor.report()["clean"]

    srv2 = make_server(tcfg, tp, cache_mode="paged", audit_every=1)
    hs = [srv2.submit(Request(prompt=p, max_new_tokens=n, deadline_s=1e-6 if i == 3 else None))
          for i, (p, n) in enumerate(zip(prompts, NEWS))]
    srv2.run()
    res2 = [h.result() for h in hs]
    assert res2[3].finish_reason == "deadline"
    assert all(r.finish_reason in ("eos", "length") for r in res2[:3])
    assert lifecycle(srv2)["deadline_exceeded"] == 1
    with pytest.raises(ValueError, match="deadline_s"):
        srv2.submit(Request(prompt=prompts[0], max_new_tokens=2, deadline_s=0.0))


def test_backpressure_reject_and_block(setup):
    _, tcfg, _, tp, prompts = setup
    srv = make_server(tcfg, tp, max_pending=2)
    hs = [srv.submit(Request(prompt=prompts[i], max_new_tokens=NEWS[i])) for i in range(2)]
    with pytest.raises(QueueFull, match="max_pending=2"):
        srv.submit(Request(prompt=prompts[2], max_new_tokens=3))
    assert lifecycle(srv)["rejected"] == 1
    srv.run()
    assert all(h.result().finish_reason in ("eos", "length") for h in hs)

    srv2 = make_server(tcfg, tp, max_pending=1, backpressure="block")
    hs2 = [srv2.submit(Request(prompt=p, max_new_tokens=n)) for p, n in zip(prompts, NEWS)]
    srv2.run()
    assert all(h.result().finish_reason in ("eos", "length") for h in hs2)
    assert lifecycle(srv2)["rejected"] == 0


def test_no_progress_raises_descriptive_serve_error(setup):
    _, tcfg, _, tp, prompts = setup
    srv = make_server(tcfg, tp, cache_mode="paged", stall_steps=16,
                      faults=FaultPlan(rates={"pool_alloc": 1.0}))
    h = srv.submit(Request(prompt=prompts[0], max_new_tokens=2))
    with pytest.raises(ServeError, match=r"no progress for 16 .*request 0"):
        h.result()
    assert not h.done


def test_deadline_exempts_stall_detection(setup):
    _, tcfg, _, tp, prompts = setup
    srv = make_server(tcfg, tp, cache_mode="paged", stall_steps=4, default_deadline_s=0.2,
                      faults=FaultPlan(rates={"pool_alloc": 1.0}))
    h = srv.submit(Request(prompt=prompts[0], max_new_tokens=2))
    assert h.result().finish_reason == "deadline"


def test_auditor_detects_seeded_corruption(setup):
    _, tcfg, _, tp, prompts = setup
    srv = make_server(tcfg, tp, cache_mode="paged", prefix_cache="on", audit_every=1)
    hs = [srv.submit(Request(prompt=p, max_new_tokens=n)) for p, n in zip(prompts, NEWS)]
    srv.step()
    srv.step()
    assert srv.auditor.audit() == []
    live = next(iter(srv.pool._live))
    srv.pool.retain([live])  # a leaked reference
    assert any("refcount" in b for b in srv.auditor.audit())
    srv.pool.release([live])
    assert srv.auditor.audit() == []
    row = next(r for r, s in enumerate(srv._slots) if s is not None)
    slot = int(np.argmax(srv._pt_host[row] >= 0))
    keep = srv._pt_host[row, slot]
    srv._pt_host[row, slot] = -1  # host and device disagree
    bad = srv.auditor.audit()
    assert any("device page table" in b for b in bad) and any("refcount" in b for b in bad)
    srv._pt_host[row, slot] = keep
    h = srv._slots[row]
    h._finish = "length"  # a finished handle left scheduled
    with pytest.raises(InvariantViolation, match="still scheduled"):
        srv.auditor.check()
    h._finish = None
    srv.run()
    for h in hs:
        h.result()
    assert srv.auditor.audit() == []


# ---------------------------------------------------------------------------
# Seeded chaos soak, against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,pfx", [("dense", "off"), ("paged", "off"), ("paged", "on")])
def test_chaos_soak(setup, mode, pfx):
    """Rates from one printed seed at every site: every request ends, an
    error names its request, survivors equal the fault-free run, the
    per-step audit stays clean; and the reference Server under the same
    plan gives the same finish reasons, errors, surviving tokens and fired
    schedule.  ``REPRO_CHAOS_SEED=<seed>`` replays a failure."""
    jcfg, tcfg, jp, tp, prompts = setup
    rng = np.random.default_rng((CHAOS_SEED, zlib.crc32(f"{mode}/{pfx}".encode())))
    rates = {s: round(float(u), 3)
             for s, u in zip(FAULT_SITES, rng.uniform(0.02, 0.2, len(FAULT_SITES)))}
    kw = dict(cache_mode=mode, prefix_cache=pfx)
    if mode == "paged":
        kw["pool_hbm_bytes"] = 8 * page_bytes(tcfg)
    plan = FaultPlan(seed=CHAOS_SEED, rates=rates)
    try:
        _, base = run_all(make_server(tcfg, tp, **kw), prompts)
        srv = make_server(tcfg, tp, **kw, faults=plan, max_requeues=4, audit_every=1)
        _, res = run_all(srv, prompts)
        for i, r in enumerate(res):
            assert r.finish_reason in ("eos", "length", "error"), i
            if r.finish_reason == "error":
                assert r.error and f"request {i}" in r.error
            else:
                assert r.tokens.tolist() == base[i].tokens.tolist(), i
        assert srv.auditor.report()["clean"], srv.auditor.report()
        assert plan.fired, "the soak's rates never fired"
        jplan = JF.FaultPlan(seed=CHAOS_SEED, rates=rates)
        jsrv = JS.Server(jcfg, jp, JS.ServerConfig(max_slots=2, max_seq=128, **kw,
                                                   faults=jplan, max_requeues=4),
                         q_chunk=32, kv_chunk=32)
        jh = [jsrv.submit(JS.Request(prompt=p, max_new_tokens=n))
              for p, n in zip(prompts, NEWS)]
        jsrv.run()
        jres = [h.result() for h in jh]
        assert [r.finish_reason for r in res] == [r.finish_reason for r in jres]
        assert [r.error for r in res] == [r.error for r in jres]
        assert [r.tokens.tolist() for r in res] == [r.tokens.tolist() for r in jres]
        assert plan.stats() == jplan.stats()
        assert lifecycle(srv) == jsrv.stats()["lifecycle"]
    except BaseException:
        print(f"\nchaos soak [{mode}/{pfx}] failed; replay with "
              f"REPRO_CHAOS_SEED={CHAOS_SEED}\nplan: {plan!r}\n"
              f"fired: {plan.stats()['fired']}", file=sys.stderr)
        raise


@pytest.mark.parametrize("pfx", ["off", "on"])
def test_fault_storm_matches_reference(setup, pressure, pfx):
    """A harsher plan than the soak's (rates of 0.2 to 0.5, one requeue,
    the 6-page pool under decode growth) fails requests: the port and the
    reference fail the same ones with the same errors, and agree on every
    survivor's tokens, the fired schedule and the lifecycle counters."""
    jcfg, tcfg, jp, tp, _ = setup
    prompts, news = pressure
    rng = np.random.default_rng((CHAOS_SEED, zlib.crc32(f"storm/{pfx}".encode())))
    rates = {s: round(float(u), 3)
             for s, u in zip(FAULT_SITES, rng.uniform(0.2, 0.5, len(FAULT_SITES)))}
    kw = dict(cache_mode="paged", prefix_cache=pfx, pool_hbm_bytes=6 * page_bytes(tcfg),
              max_requeues=1, stall_steps=64)
    plan, jplan = FaultPlan(seed=CHAOS_SEED, rates=rates), JF.FaultPlan(seed=CHAOS_SEED,
                                                                       rates=rates)
    srv = make_server(tcfg, tp, **kw, faults=plan, audit_every=1)
    _, res = run_all(srv, prompts, news)
    jsrv = JS.Server(jcfg, jp, JS.ServerConfig(max_slots=2, max_seq=128, **kw, faults=jplan),
                     q_chunk=32, kv_chunk=32)
    jh = [jsrv.submit(JS.Request(prompt=p, max_new_tokens=n)) for p, n in zip(prompts, news)]
    jsrv.run()
    jres = [h.result() for h in jh]
    assert any(r.finish_reason == "error" for r in res), "the storm failed nothing"
    assert [(r.finish_reason, r.error) for r in res] == [(r.finish_reason, r.error) for r in jres]
    assert [r.tokens.tolist() for r in res] == [r.tokens.tolist() for r in jres]
    assert plan.stats() == jplan.stats()
    assert lifecycle(srv) == jsrv.stats()["lifecycle"]
    assert srv.stats()["preemptions"] == jsrv.stats()["preemptions"]
    assert srv.auditor.report()["clean"], srv.auditor.report()
