"""The dry run's profiler (the port of ``repro.launch.hlo_profile``; the
name is kept so a reader finds the counterpart).

It reads the port's op count, not HLO: ``profile_cell`` counts a cell at
the analysis depth d1 on the single-pod production mesh of meta devices
(``launch.dryrun``) and prints the top copies between devices grouped by
kind x shape and the top matmuls by FLOPs, so a hypothesis about where a
cell's time goes starts from what the port's step does.

    python -m repro_torch.launch.hlo_profile --arch qwen3_moe_30b_a3b --shape prefill_32k
"""

from __future__ import annotations

import argparse
import dataclasses

from repro_torch.launch import dryrun
from repro_torch.models import registry


def profile_cell(arch: str, shape_name: str, top: int = 12) -> dryrun.OpCount:
    """Count ``arch``'s cell at depth d1 and print its top copies and
    matmuls; returns the counter."""
    cfg = registry.get_config(arch)
    mesh = dryrun.meta_mesh(False)
    c1, _, d1, _ = dryrun.analysis_depths(cfg)
    if cfg.ssm_state:
        c1 = dataclasses.replace(c1, ssm_chunk=2048)
    kw = dict(q_chunk=8192, kv_chunk=8192)
    if dryrun.SHAPES[shape_name]["kind"] == "train":
        kw["microbatches"] = 1
    counter, _ = dryrun.count_cell(dryrun.build_cell(c1, shape_name, mesh, **kw))

    print(f"== {arch} {shape_name} (depth-{d1} count) ==")
    print("-- top copies between devices by bytes (per device, one unit depth) --")
    for (kind, shp), b in counter.copy_groups().most_common(top):
        print(f"  {b / 1e9:8.3f} GB  {kind:20s} {shp[:80]}")
    print("-- top matmuls by FLOPs --")
    for key, f in counter.matmuls.most_common(top):
        print(f"  {f / 1e9:10.3f} GFLOP  {key[:100]}")
    for name, k in sorted(counter.kernels.items()):
        print(f"  kernel {name}: {k['calls']} calls, {k['bytes'] / 1e9:.3f} GB, "
              f"{k['flops'] / 1e9:.3f} GFLOP")
    total = counter.collectives()["total"]
    print(f"total copy bytes: {total / 1e9:.2f} GB/device at depth {d1}; "
          f"{counter.flops / 1e12:.3f} TFLOP, {counter.bytes / 1e9:.2f} GB of op traffic")
    return counter


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="top copies and matmuls of a dry-run cell")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(dryrun.SHAPES))
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    profile_cell(registry.canonical(args.arch), args.shape, args.top)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
