"""Serving launcher: continuous-batching generation with the compressed KV
cache (the port of ``repro.launch.serve``).

    python -m repro_torch.launch.serve --arch yi_6b --layout packed --requests 8
    python -m repro_torch.launch.serve --arch yi_6b --layout raw   # baseline
    python -m repro_torch.launch.serve --device cpu ...            # no card
    python -m repro_torch.launch.serve --arch qwen3_moe_30b_a3b   # MoE (or mixtral_8x22b)
    python -m repro_torch.launch.serve --arch zamba2_7b   # hybrid (or mamba2_1_3b, ssm)
    python -m repro_torch.launch.serve --mesh 2,2 --device cpu     # sharded, 4 CPU shards

Requests get heterogeneous prompt lengths and token budgets and are pushed
through the ``api.serve`` Server: slots admit, decode at per-row positions,
retire, and are reused mid-flight.  Prints the throughput line, the stats
snapshot and per-request results.  It serves the smoke-size model of
``--arch`` with random weights from seed 0, on the card unless ``--device
cpu``.  ``--trace events|full --trace-out FILE`` writes a Chrome trace
(open it at ui.perfetto.dev); ``--metrics-out FILE`` writes the JSON
snapshot and its Prometheus text (``.prom``).  Ctrl-C prints the snapshot,
exports the telemetry and exits 130.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch import api
from repro_torch.launch.mesh import make_serve_mesh, parse_mesh_spec
from repro_torch.models import model as M
from repro_torch.models import registry

def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi_6b")
    ap.add_argument("--layout", default="packed",
                    choices=list(api.available_layouts()))
    ap.add_argument("--backend", default=None,
                    choices=list(api.available_backends()) + ["auto"],
                    help="decode-attention backend (default: the model "
                         "config's attn_backend — auto: the Fetch kernel on "
                         "the card, the blockwise scan on the CPU)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=96)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--cache-mode", default="dense", choices=["dense", "paged"],
                    help="paged: pool compressed blocks in a shared arena "
                         "and admit by memory pressure (DESIGN.md §10)")
    ap.add_argument("--pool-bytes", type=int, default=None,
                    help="paged: byte budget for the block pool (default: "
                         "the dense-equivalent footprint of --max-slots)")
    ap.add_argument("--prefix-cache", default="off",
                    choices=["off", "on", "noshare"],
                    help="paged: share block-aligned prompt prefixes through "
                         "the refcounted page index (DESIGN.md §11); noshare "
                         "runs the same chunked admission without sharing")
    ap.add_argument("--span-tokens", type=int, default=None,
                    help="blockwise-scan span width in tokens (default: the "
                         "REPRO_BLOCKWISE_SPAN_TOKENS env var, else 1024)")
    ap.add_argument("--unroll-max", type=int, default=None,
                    help="the reference's unroll bound of the scan; validated "
                         "and kept, read by nothing (the port's scan is a "
                         "host loop)")
    ap.add_argument("--prefill-mode", default="chunked",
                    choices=["chunked", "solo"],
                    help="chunked (default): splice admission prefills "
                         "between decode steps in --prefill-chunk budgets "
                         "(DESIGN.md §13); solo: drain the whole prompt at "
                         "admission, stalling live decoders")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="per-step chunked-prefill token budget; must be a "
                         "positive multiple of the cache block_size "
                         "(default: 8 blocks)")
    ap.add_argument("--mesh", default=None,
                    help="dp,tp serving mesh (DESIGN.md §12), e.g. 2,2: dp "
                         "shards decode slots and pages, tp KV heads; the "
                         "first dp*tp cards, or the CPU dp*tp times with "
                         "--device cpu")
    ap.add_argument("--trace", default="off",
                    choices=["off", "events", "full"],
                    help="scheduler event trace (DESIGN.md §14): events "
                         "records every scheduling decision in a ring "
                         "buffer, full adds decode dispatch spans; off "
                         "keeps the hot path event-free")
    ap.add_argument("--trace-out", default=None,
                    help="write the event trace as Chrome trace-event JSON "
                         "(open in Perfetto; needs --trace events|full)")
    ap.add_argument("--metrics-out", default=None,
                    help="write the metrics snapshot as JSON here, plus a "
                         ".prom Prometheus-text sibling")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request wall-clock deadline in seconds "
                         "(DESIGN.md §15); requests past it retire with "
                         "finish_reason='deadline'")
    ap.add_argument("--max-requeues", type=int, default=32,
                    help="preemption/requeue budget per request; over "
                         "budget a (non-oldest) request fails in isolation "
                         "instead of requeueing (DESIGN.md §15)")
    ap.add_argument("--max-pending", type=int, default=None,
                    help="bound the admission queue; submits past the "
                         "bound apply --backpressure")
    ap.add_argument("--backpressure", default="reject",
                    choices=["reject", "block"],
                    help="full-queue policy: reject raises, block drives "
                         "the server until the queue drains")
    ap.add_argument("--audit-every", type=int, default=0,
                    help="cross-check pool/page-table/prefix-index "
                         "invariants every N steps (0 = off; DESIGN.md §15)")
    ap.add_argument("--fault", action="append", default=[],
                    metavar="SITE[:PROB]",
                    help="inject deterministic faults at a named site "
                         "(repeatable; prob defaults to 1.0), e.g. "
                         "--fault reclaim_sweep:0.05 — sites: "
                         "pool_alloc, reclaim_sweep, prefix_evict, "
                         "prefix_insert, chunk_prefill, decode_dispatch")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed for the --fault schedule (replayable)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs: the card (default) or the "
                         "CPU's plain PyTorch path")
    args = ap.parse_args(argv)

    cfg = registry.get_smoke_config(args.arch)
    cfg = dataclasses.replace(cfg, cache_layout=args.layout)
    if args.span_tokens is not None:
        cfg = dataclasses.replace(cfg, cache_span_tokens=args.span_tokens)
    if args.unroll_max is not None:
        cfg = dataclasses.replace(cfg, cache_unroll_max=args.unroll_max)
    params = M.init_params(cfg, seed=0, device=args.device)
    faults = None
    if args.fault:
        from repro_torch.serve.faults import FaultPlan
        rates = {}
        for spec in args.fault:
            site, _, prob = spec.partition(":")
            rates[site] = float(prob) if prob else 1.0
        faults = FaultPlan(seed=args.fault_seed, rates=rates)
    mesh = None
    if args.mesh:
        # On the CPU every shard is the CPU; on the card, the first dp*tp cards.
        try:
            dp, tp = parse_mesh_spec(args.mesh)
            mesh = make_serve_mesh(args.mesh, devices=(
                ["cpu"] * (dp * tp) if args.device == "cpu" else None))
        except (ValueError, RuntimeError) as e:  # a malformed spec, too few cards
            ap.error(str(e))
    server = api.serve(cfg, params, max_slots=args.max_slots,
                       max_seq=args.max_seq, attn_backend=args.backend,
                       cache_mode=args.cache_mode,
                       pool_hbm_bytes=args.pool_bytes,
                       prefix_cache=args.prefix_cache,
                       prefill_mode=args.prefill_mode,
                       prefill_chunk_tokens=args.prefill_chunk,
                       mesh=mesh, trace=args.trace,
                       max_requeues=args.max_requeues,
                       max_pending=args.max_pending,
                       backpressure=args.backpressure,
                       default_deadline_s=args.deadline,
                       faults=faults,
                       audit_every=args.audit_every,
                       device=args.device)
    rng = np.random.default_rng(0)
    # With the prefix cache enabled, requests share a system-prompt prefix
    # (half of --prompt-len) so the printed hit-rate exercises real reuse.
    shared = (rng.integers(0, cfg.vocab_size, args.prompt_len // 2)
              .astype(np.int32) if args.prefix_cache != "off" else
              np.zeros(0, np.int32))
    handles = []
    for i in range(args.requests):
        # heterogeneous workload: prompts from half to full --prompt-len,
        # budgets from half to full --new-tokens
        plen = max(4, args.prompt_len - (i * args.prompt_len // 2) // max(args.requests - 1, 1))
        n_new = max(2, args.new_tokens - (i * args.new_tokens // 2) // max(args.requests - 1, 1))
        tail = rng.integers(0, cfg.vocab_size,
                            max(plen - len(shared), 1)).astype(np.int32)
        prompt = np.concatenate([shared, tail])
        handles.append(server.submit(api.Request(prompt=prompt,
                                                 max_new_tokens=n_new)))
    t0 = time.monotonic()
    try:
        server.run()
    except KeyboardInterrupt:
        # Ctrl-C must not lose the run's telemetry: print the final
        # snapshot and run the shutdown exports before exiting with the
        # conventional interrupt status.
        wall = time.monotonic() - t0
        print(f"\ninterrupted after {wall:.1f}s: active={server.active} "
              f"prefilling={server.prefilling} pending={server.pending}")
        print(api.obs.format_snapshot(server.stats()))
        server.shutdown(metrics_out=args.metrics_out,
                        trace_out=args.trace_out)
        raise SystemExit(130)
    wall = time.monotonic() - t0
    results = [h.result() for h in handles]
    total = sum(len(r.tokens) for r in results)
    rep = server.memory_report()
    print(f"layout={args.layout} mode={args.cache_mode} "
          f"requests={len(results)} slots={args.max_slots} tokens={total} "
          f"throughput={total / wall:.1f} tok/s "
          f"kv_cache_bytes={rep['kv_bytes']:,}")
    print(api.obs.format_snapshot(server.stats()))
    if args.metrics_out or args.trace_out:
        server.shutdown(metrics_out=args.metrics_out,
                        trace_out=args.trace_out)
    for i, r in enumerate(results[:4]):
        # ttft_s is None for token-less (failed/cancelled/expired) requests
        ttft = f"{r.ttft_s * 1e3:.0f}ms" if r.ttft_s is not None else "-"
        print(f"  req{i}: prompt_len={r.prompt_len} n_tokens={len(r.tokens)} "
              f"queue={r.queue_wait_s * 1e3:.0f}ms "
              f"ttft={ttft} "
              f"prefill={r.prefill_s * 1e3:.0f}ms gen={r.gen_s * 1e3:.0f}ms "
              f"finish={r.finish_reason} tokens={r.tokens[:8].tolist()}…")
    return results


if __name__ == "__main__":
    main()
