"""The port's serving observability (``repro_torch.obs`` and the Server's
event trace, stats and exports; DESIGN.md §14), held against the reference
on the CPU:

* the metrics primitives, the registry's nesting and its Prometheus
  exposition, line for line the reference's on the same contents;
* the event ring (levels, drop count), ``request_timings`` and the Chrome
  export;
* the Server's event stream, without ``t`` and ``dur``, equal to the
  reference Server's under ``trace="events"`` and ``"full"`` in three
  configurations: dense with the prefix cache off, paged with the prefix
  cache on in a pool tight enough to preempt, and the chaos soak's fault
  plan; ``request_timings`` equal to the ``Result``s exactly; the
  ``stats()`` and ``shutdown`` key trees and the Prometheus metric names
  equal to the reference's;
* ``trace="off"``: zero events, the same model calls and tokens as ``full``;
* ``annotate`` never reaches the profiler outside a capture, and does
  inside one.
"""

import dataclasses
import functools
import json
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; intra-op threads only oversubscribe them
jax = pytest.importorskip("jax")

from repro import obs as jobs  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.serve import faults as JF  # noqa: E402
from repro.serve import scheduler as JS  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import pool as TP  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.obs import profiling  # noqa: E402
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry  # noqa: E402
from repro_torch.obs.trace import EventTrace  # noqa: E402
from repro_torch.serve.faults import FAULT_SITES, FaultPlan  # noqa: E402
from repro_torch.serve.scheduler import Request, Server, ServerConfig  # noqa: E402
import test_torch_shared as cached  # noqa: E402

# The chaos soak's seed (tests/test_torch_faults.py).
CHAOS_SEED = 20260808

LENS = (7, 13, 19, 26)
NEWS = (3, 6, 4, 5)


# ---------------------------------------------------------------------------
# Metrics primitives
# ---------------------------------------------------------------------------


def test_counter_and_gauge():
    c = Counter()
    c.inc()
    c.inc(4)
    assert c.value == 5
    g = Gauge()
    g.set(3.0)
    g.set_max(2.0)
    assert g.value == 3.0
    g.set_max(7.5)
    assert g.value == 7.5


def test_histogram_observe_and_quantiles():
    h, ref = Histogram(), jobs.Histogram()
    vals = [0.001, 0.002, 0.004, 0.008, 0.016, 0.032]
    for v in vals:
        h.observe(v)
        ref.observe(v)
    assert h.count == len(vals)
    assert h.sum == pytest.approx(sum(vals))
    assert h.min == min(vals) and h.max == max(vals)
    q = [h.quantile(p) for p in (0.0, 0.25, 0.5, 0.9, 1.0)]
    assert all(a <= b for a, b in zip(q, q[1:]))
    assert min(vals) <= q[0] and q[-1] <= max(vals)
    assert h.snapshot() == ref.snapshot()
    assert Histogram().snapshot()["count"] == 0
    assert Histogram().quantile(0.5) == 0.0


def _fill(reg):
    reg.counter("serve.preemptions").inc(2)
    reg.gauge("pool.shard0.high_water_pages").set(7)
    reg.gauge("serve.active").set(3)
    for v in (0.0004, 0.01, 0.2, 3.0, 500.0):
        reg.histogram("serve.ttft_s").observe(v)
    reg.counter("prefix.index.shard0.evicted-blocks").inc()
    return reg


def test_registry_snapshot_nesting_and_types():
    reg = _fill(MetricsRegistry())
    snap = reg.snapshot()
    assert snap["serve"]["preemptions"] == 2
    assert snap["pool"]["shard0"]["high_water_pages"] == 7
    assert snap["serve"]["ttft_s"]["count"] == 5
    assert snap == _fill(jobs.MetricsRegistry()).snapshot()
    assert reg.counter("serve.preemptions").value == 2
    with pytest.raises(TypeError):
        reg.gauge("serve.preemptions")
    assert "serve.preemptions" in reg
    assert reg.get("nope") is None
    assert reg.get("serve.active").value == 3


def test_prometheus_text_equals_reference_line_for_line():
    text = _fill(MetricsRegistry()).prometheus_text()
    assert text.splitlines() == _fill(jobs.MetricsRegistry()).prometheus_text().splitlines()
    assert "# TYPE kvcomp_serve_preemptions counter" in text
    assert 'kvcomp_serve_ttft_s_bucket{le="+Inf"} 5' in text
    assert "kvcomp_prefix_index_shard0_evicted_blocks 1" in text
    assert _fill(MetricsRegistry()).prometheus_text(prefix="x").startswith("# TYPE x_")


# ---------------------------------------------------------------------------
# EventTrace primitives
# ---------------------------------------------------------------------------


def test_trace_levels_and_ring_drop():
    with pytest.raises(ValueError):
        EventTrace("verbose")
    with pytest.raises(ValueError):
        EventTrace("events", capacity=0)
    tr = EventTrace("events", capacity=4)
    assert tr.enabled and not tr.full
    for i in range(10):
        tr.emit("token", req=0, t=float(i), index=i)
    assert len(tr.events) == 4
    assert tr.emitted == 10 and tr.dropped == 6
    assert not EventTrace("off").enabled


def _synthetic(tr):
    tr.emit("submit", req=3, t=1.0)
    tr.emit("prefill_start", req=3, t=1.5, row=0)
    tr.emit("prefill_chunk", req=3, t=1.55, dur=0.05, row=0, pos=0, tokens=8)
    tr.emit("token", req=3, t=2.0, index=0)
    tr.emit("decode_step", t=2.1, dur=0.01, rows=1)
    tr.emit("token", req=3, t=2.25, index=1)
    tr.emit("token", req=3, t=2.25, index=1)  # replay: same index ignored
    tr.emit("retire", req=3, t=2.3, reason="length")
    return tr


def test_request_timings_and_chrome_export_equal_reference():
    tr = _synthetic(EventTrace("full"))
    tim = tr.request_timings()[3]
    assert tim["submit"] == 1.0 and tim["first_work"] == 1.5
    assert tim["token_times"] == (2.0, 2.25)
    assert tim["ttft_s"] == 1.0
    assert tim["retired"] and tim["reason"] == "length"
    ref = _synthetic(jobs.EventTrace("full"))
    assert tr.request_timings() == ref.request_timings()
    doc = tr.to_chrome()
    assert doc == ref.to_chrome()
    evs = doc["traceEvents"]
    assert {e["ph"] for e in evs} == {"M", "X", "i"}
    assert {"process_name", "thread_name", "prefill_chunk", "decode_step",
            "queue", "decode"} <= {e["name"] for e in evs}
    track = [e for e in evs if e["name"] == "thread_name" and e["tid"] == 4][0]
    assert track["args"]["name"] == "req 3"
    queue = [e for e in evs if e["name"] == "queue"][0]
    assert queue["ts"] == pytest.approx(1.0e6) and queue["dur"] == pytest.approx(0.5e6)
    json.dumps(doc)


# ---------------------------------------------------------------------------
# Server against the reference Server
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    return _setup()


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg = dataclasses.replace(JR.get_smoke_config("yi_6b"), cache_layout="packed",
                               cache_block=8)
    tcfg = dataclasses.replace(TR.get_smoke_config("yi_6b"), cache_layout="packed",
                               cache_block=8)
    jp, tp = cached.params(jcfg)
    rng = np.random.default_rng(3)
    shared = rng.integers(0, tcfg.vocab_size, 16).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, tcfg.vocab_size, L).astype(np.int32)])
               for L in LENS]
    page_b = sum(TP.page_nbytes(s, tcfg.n_kv_heads, tcfg.resolved_head_dim)
                 for s in TM.cache_specs(tcfg, 128))
    return jcfg, tcfg, jp, tp, tuple(prompts), page_b


def _config(name, page_b):
    """(ServerConfig keywords, fault-plan rates or None, news)."""
    if name == "dense/off":
        return dict(cache_mode="dense"), None, NEWS
    if name == "paged/on tight":
        # Decode growth overcommits a 7-page pool: the reclaim ladder evicts
        # index blocks and preempts.
        return (dict(cache_mode="paged", prefix_cache="on", pool_hbm_bytes=7 * page_b),
                None, (20, 18, 16, 14))
    rng = np.random.default_rng((CHAOS_SEED, zlib.crc32(b"paged/on")))
    rates = {s: round(float(u), 3)
             for s, u in zip(FAULT_SITES, rng.uniform(0.02, 0.2, len(FAULT_SITES)))}
    return (dict(cache_mode="paged", prefix_cache="on", pool_hbm_bytes=8 * page_b,
                 max_requeues=4, audit_every=1), rates, NEWS)


CONFIGS = ("dense/off", "paged/on tight", "chaos soak")


def _serve(make, request, prompts, news):
    server = make()
    handles = [server.submit(request(prompt=p, max_new_tokens=n))
               for p, n in zip(prompts, news)]
    server.run()
    return server, handles, [h.result() for h in handles]


@pytest.fixture(scope="module")
def runs(setup):
    """Per configuration: the reference Server under trace "full", and the
    port's under "events" and "full"; built once a test process."""
    return _runs()


@functools.lru_cache(maxsize=None)
def _runs():
    jcfg, tcfg, jp, tp, prompts, page_b = _setup()
    out = {}
    for name in CONFIGS:
        kw, rates, news = _config(name, page_b)
        jplan = JF.FaultPlan(seed=CHAOS_SEED, rates=rates) if rates else None
        ref = _serve(lambda: JS.Server(jcfg, jp, JS.ServerConfig(
            max_slots=2, max_seq=128, trace="full", faults=jplan, **kw),
            q_chunk=32, kv_chunk=32), JS.Request, prompts, news)
        port = {}
        for level in ("events", "full"):
            plan = FaultPlan(seed=CHAOS_SEED, rates=rates) if rates else None
            port[level] = _serve(lambda: Server(tcfg, tp, ServerConfig(
                max_slots=2, max_seq=128, trace=level, faults=plan, **kw), device="cpu"),
                Request, prompts, news)
        out[name] = dict(ref=ref, port=port)
    return out


def _stream(trace, level="full"):
    """The events without their stamps: (kind, req, step, data less dur)."""
    return [(e.kind, e.req, e.step, {k: v for k, v in e.data.items() if k != "dur"})
            for e in trace.events if level == "full" or e.kind != "decode_step"]


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("level", ["events", "full"])
def test_event_stream_equals_reference(runs, name, level):
    ref, port = runs[name]["ref"], runs[name]["port"][level]
    want, got = _stream(ref[0].trace, level), _stream(port[0].trace)
    assert port[0].trace.dropped == ref[0].trace.dropped == 0
    assert got == want
    assert [r.tokens.tolist() for r in port[2]] == [r.tokens.tolist() for r in ref[2]]
    kinds = {k for k, *_ in got}
    assert {"submit", "prefill_start", "prefill_chunk", "prefill_finish", "token",
            "retire"} <= kinds
    assert ("decode_step" in kinds) == (level == "full")
    if name == "paged/on tight":
        assert {"preempt", "prefix_hit", "page_assign", "prefix_evict"} <= kinds
    if name == "chaos soak":
        assert port[0].faults.fired and port[0].faults.stats() == ref[0].faults.stats()


@pytest.mark.parametrize("name", CONFIGS)
def test_request_timings_equal_results_exactly(runs, name):
    server, handles, results = runs[name]["port"]["full"]
    tim = server.trace.request_timings()
    for h, r in zip(handles, results):
        t = tim[h.id]
        assert t["token_times"] == r.token_times
        assert t["ttft_s"] == r.ttft_s
        assert t["retired"] and t["reason"] == r.finish_reason
    n_tok = sum(1 for e in server.trace.events if e.kind == "token")
    assert n_tok == sum(len(r.token_times) for r in results)


def key_tree(d):
    """Shape of a stats tree: nested keys, list lengths normalized."""
    if isinstance(d, dict):
        return {k: key_tree(v) for k, v in sorted(d.items())}
    if isinstance(d, list):
        return [key_tree(d[0])] if d else []
    return "."


def _prom_series(text):
    """Metric names, types and label sets of an exposition (values dropped)."""
    return [line if line.startswith("#") else line.rsplit(" ", 1)[0]
            for line in text.splitlines()]


@pytest.mark.parametrize("name", CONFIGS)
def test_stats_shutdown_and_prometheus_schema_equal_reference(runs, name, tmp_path):
    ref, port = runs[name]["ref"][0], runs[name]["port"]["full"][0]
    st, jst = port.stats(), ref.stats()
    assert key_tree(st) == key_tree(jst)
    assert st["trace"] == {"level": "full", "events": len(port.trace.events), "dropped": 0}
    assert st["trace"]["events"] == jst["trace"]["events"]
    assert st["preemptions"] == jst["preemptions"]
    if name == "paged/on tight":
        assert st["preemptions"] > 0
    mpath, tpath = tmp_path / "metrics.json", tmp_path / "trace.json"
    snap = port.shutdown(metrics_out=mpath, trace_out=tpath)
    jsnap = ref.shutdown(metrics_out=tmp_path / "ref.json")
    assert key_tree(snap) == key_tree(jsnap)
    assert key_tree(json.loads(mpath.read_text())) == key_tree(snap)
    assert _prom_series(mpath.with_suffix(".prom").read_text()) == _prom_series(
        (tmp_path / "ref.prom").read_text())
    doc = json.loads(tpath.read_text())
    tracks = {e["args"]["name"] for e in doc["traceEvents"] if e["name"] == "thread_name"}
    assert tracks == {"scheduler"} | {f"req {i}" for i in range(len(LENS))}


def test_bench_columns_and_format_snapshot(runs):
    server = runs["paged/on tight"]["port"]["full"][0]
    cols = obs.bench_columns(server)
    assert tuple(cols) == obs.BENCH_COLUMNS
    assert cols["ttft_p50_s"] > 0 and cols["preemptions"] == server.preemptions > 0
    text = obs.format_snapshot(server.stats())
    for frag in ("serve[paged]", "lifecycle:", "prefill[", "latency:", "pool:", "shards:",
                 "prefix[on]", "trace[full]"):
        assert frag in text, frag


# The model functions a Server step calls: every device dispatch of a step.
MODEL_CALLS = ("decode_step", "prefill_chunk", "chunk_state_view", "install_chunk_row",
               "adopt_chunk_stores", "insert_decode_row", "clear_cache_row",
               "assign_cache_pages", "init_decode_state")


def test_trace_off_records_nothing_and_calls_the_same(setup, monkeypatch):
    """trace="off" costs nothing: no events, the same model calls (the
    dispatches of every step) as a traced run, and the same tokens."""
    _, tcfg, _, tp, prompts, _ = setup
    from repro_torch.serve import scheduler

    calls = {}
    for fn in MODEL_CALLS:
        real = getattr(TM, fn)

        def counted(*a, _f=real, _n=fn, **k):
            calls[_n] = calls.get(_n, 0) + 1
            return _f(*a, **k)

        monkeypatch.setattr(scheduler.M, fn, counted)
    out = {}
    for level in ("off", "full"):
        calls.clear()
        server, _, res = _serve(lambda: Server(tcfg, tp, ServerConfig(
            max_slots=2, max_seq=128, cache_mode="paged", prefix_cache="on", trace=level),
            device="cpu"), Request, prompts, NEWS)
        out[level] = (server, dict(calls), [r.tokens.tolist() for r in res])
    off, full = out["off"], out["full"]
    assert off[0].trace.emitted == 0 and len(off[0].trace.events) == 0
    assert off[0].stats()["trace"] == {"level": "off", "events": 0, "dropped": 0}
    assert off[0]._tr is None and len(full[0].trace.events) > 0
    assert off[1] == full[1] and off[1]["decode_step"] > 0
    assert off[2] == full[2]


def test_annotate_stays_out_of_the_profiler_outside_a_capture(setup, monkeypatch, tmp_path):
    """Outside ``trace_capture`` the four scopes never touch the profiler
    (``record_function`` raising proves it); inside one they do, and the
    capture writes a Chrome trace holding the kvcomp scopes."""
    _, tcfg, _, tp, prompts, _ = setup
    # Packed through the Fetch's plain version (fused_attention, and the
    # Store's pack_encode), huffman through the blockwise scan and its slot
    # decode: the four scopes.
    cfgs = (dataclasses.replace(tcfg, attn_backend="fused"),
            dataclasses.replace(tcfg, cache_layout="huffman", attn_backend="xla"))
    real = torch.profiler.record_function

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) outside a capture")

    def serve_both():
        for cfg in cfgs:
            _serve(lambda: Server(cfg, tp, ServerConfig(max_slots=2, max_seq=128),
                                  device="cpu"), Request, prompts[:1], (3,))

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    serve_both()
    entered = []

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with profiling.trace_capture(tmp_path) as prof:
        serve_both()
        with obs.annotation("host region"):
            pass
    assert entered.pop() == "kvcomp:host region"
    assert prof is not None and not profiling._capturing
    assert {f"kvcomp/{n}" for n in ("fused_attention", "pack_encode", "huffman_lut_decode",
                                    "blockwise_span_scan")} == set(entered)
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert "kvcomp/blockwise_span_scan" in names
    with profiling.trace_capture(None) as none:
        assert none is None
    # The decorator form chooses the scope at each call.
    seen = []

    @obs.annotate("probe")
    def probe():
        seen.append(profiling._capturing)

    probe()
    with profiling.trace_capture(tmp_path / "b"):
        probe()
    assert seen == [False, True] and entered[-1] == "kvcomp/probe"
