"""Unified serving observability (DESIGN.md §14; the port of ``repro.obs``):
metrics registry, structured scheduler event trace, and kernel profiling
hooks.

    from repro_torch import api, obs

    server = api.serve(cfg, params, trace="events")
    ...; server.run()
    print(obs.format_snapshot(server.stats()))   # the one stats printer
    server.shutdown(metrics_out="metrics.json",  # JSON + .prom exposition
                    trace_out="trace.json")      # Perfetto-loadable

Three pillars, one import:

* ``obs.metrics`` — ``Counter`` / ``Gauge`` / ``Histogram`` /
  ``MetricsRegistry``: every serving counter (scheduler, pool, prefix
  index) routes through one registry whose ``snapshot()`` is the
  documented ``Server.stats()`` tree.
* ``obs.trace`` — ``EventTrace``: ring-buffered scheduler decisions
  (``ServerConfig.trace=off|events|full``) exportable as Chrome
  trace-event JSON with per-request tracks.
* ``obs.profiling`` — ``annotate`` / ``annotation`` / ``trace_capture``:
  named scopes on the compression kernels and opt-in ``torch.profiler``
  capture.
"""

from __future__ import annotations

from repro_torch.obs.metrics import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, LATENCY_BUCKETS_S,
)
from repro_torch.obs.profiling import annotate, annotation, trace_capture  # noqa: F401
from repro_torch.obs.trace import EVENT_KINDS, TRACE_LEVELS, Event, EventTrace  # noqa: F401

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "LATENCY_BUCKETS_S",
    "EventTrace", "Event", "EVENT_KINDS", "TRACE_LEVELS",
    "annotate", "annotation", "trace_capture",
    "format_snapshot", "bench_columns", "BENCH_COLUMNS",
]


def format_snapshot(stats: dict) -> str:
    """Render one ``Server.stats()`` tree as the human-readable block the
    launchers print — the single replacement for the hand-rolled printers
    ``launch.serve`` and ``examples/serve_compressed.py`` used to carry
    separately (they drifted; this one reads the documented schema)."""
    lines: list[str] = []
    lines.append(f"  serve[{stats['cache_mode']}]: active={stats['active']} "
                 f"pending={stats['pending']} "
                 f"preemptions={stats['preemptions']}")
    lc = stats.get("lifecycle")
    if lc:
        lines.append(
            f"  lifecycle: submitted={lc['submitted']} "
            f"failures={lc['failures']} cancelled={lc['cancelled']} "
            f"deadline_exceeded={lc['deadline_exceeded']} "
            f"requeues={lc['requeues']} rejected={lc['rejected']}")
    pf = stats["prefill"]
    lines.append(
        f"  prefill[{pf['mode']}]: chunk_tokens={pf['chunk_tokens']} "
        f"tokens={pf['prefill_tokens']} chunks={pf['chunks']} "
        f"coscheduled={pf['coscheduled_tokens']} "
        f"stalled_decode_steps={pf['stalled_decode_steps']} "
        f"preemptions={pf['prefill_preemptions']}")
    lat = stats.get("latency")
    if lat and lat["ttft_s"]["count"]:
        def ms(v):
            return f"{v * 1e3:.0f}ms"
        lines.append(
            f"  latency: ttft p50={ms(lat['ttft_s']['p50'])} "
            f"p99={ms(lat['ttft_s']['p99'])}  "
            f"itl p50={ms(lat['itl_s']['p50'])} "
            f"p99={ms(lat['itl_s']['p99'])}  "
            f"queue p50={ms(lat['queue_wait_s']['p50'])} "
            f"(n={lat['ttft_s']['count']})")
    if "pool" in stats:
        pl = stats["pool"]
        lines.append(
            f"  pool: {pl['pages_total']} pages x {pl['bytes_per_page']}B "
            f"(live {pl['pages_live']}, high water {pl['high_water_pages']}, "
            f"{pl['bytes_total']:,}B total)")
    if "shards" in stats:
        sh = stats["shards"]
        per = " ".join(
            (f"s{i}:{p['pages_live']}L/{p['pages_free']}F"
             f"(hw {p['high_water_pages']}, pre {p['preemptions']})"
             if "pages_live" in p else f"s{i}:(pre {p['preemptions']})")
            for i, p in enumerate(sh["per_shard"]))
        lines.append(f"  shards: data={sh['n_data']} model={sh['n_model']}"
                     f"{' ' + per if per else ''}")
    if "prefix" in stats:
        px = stats["prefix"]
        line = (f"  prefix[{px['mode']}]: hit_rate={px['hit_rate']:.2f} "
                f"({px['hits']}/{px['lookups']} lookups) "
                f"reused_tokens={px['reused_tokens']} "
                f"prefill_tokens={px['prefill_tokens']} "
                f"resumes={px['resumes']} cow_breaks={px['cow_breaks']}")
        if "pool" in stats:
            pl = stats["pool"]
            line += (f" refs_total={pl['refs_total']} "
                     f"pages_shared={pl['pages_shared']}")
        lines.append(line)
    if "trace" in stats:
        tr = stats["trace"]
        lines.append(f"  trace[{tr['level']}]: events={tr['events']} "
                     f"dropped={tr['dropped']}")
    return "\n".join(lines)


# The histogram-derived columns benchmarks/run.py appends to every CSV row
# (sourced from the serving registry, not re-derived per script).
BENCH_COLUMNS = ("ttft_p50_s", "ttft_p99_s", "itl_p50_s", "itl_p99_s",
                 "preemptions", "cow_breaks")


def bench_columns(server) -> dict:
    """The registry-sourced benchmark columns for one Server: TTFT/ITL
    quantiles straight from the latency histograms plus the preemption and
    copy-on-write counters.  Bench scripts embed this under ``"metrics"``
    in their ``BENCH_*.json`` so ``benchmarks/run.py`` (and CI artifact
    consumers) read one schema."""
    reg = server.metrics
    ttft, itl = reg.histogram("serve.ttft_s"), reg.histogram("serve.itl_s")
    cow = reg.get("prefix.cow_breaks")
    return {
        "ttft_p50_s": ttft.quantile(0.50),
        "ttft_p99_s": ttft.quantile(0.99),
        "itl_p50_s": itl.quantile(0.50),
        "itl_p99_s": itl.quantile(0.99),
        "preemptions": int(server.preemptions),
        "cow_breaks": int(cow.value) if cow is not None else 0,
    }
