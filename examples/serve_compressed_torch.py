"""End-to-end serving with the PyTorch port (the paper's deployment
scenario): train a small LM, then serve a mixed batch of requests with
every registered cache layout through the continuous-batching ``api.serve``
Server, comparing generated text, cache memory and decode throughput.

    PYTHONPATH=src python examples/serve_compressed_torch.py [--device cpu]

The tiny byte-level LM comes from ``repro_torch.launch.tiny_lm`` (trained
on first use, then loaded from ``artifacts/tiny_lm_torch``).  It runs on the
card (the Fetch and Store kernels) unless ``--device cpu`` is given.
"""

import argparse
import dataclasses
import time

import numpy as np

from repro_torch import api
from repro_torch.launch.tiny_lm import get_tiny_lm


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    cfg, params, data = get_tiny_lm(device=args.device)
    prompts = [data.batch_at(900 + i)["tokens"][0][:64].astype(np.int32) for i in range(4)]

    # raw first: the exactness baseline the others are compared to
    order = ["raw"] + [n for n in api.available_layouts() if n != "raw"]
    results = {}
    for layout in order:
        c = dataclasses.replace(cfg, cache_layout=layout)
        server = api.serve(c, params, max_slots=4, max_seq=256, q_chunk=64, kv_chunk=64,
                           device=args.device)
        handles = [server.submit(api.Request(prompt=p, max_new_tokens=24)) for p in prompts]
        t0 = time.monotonic()
        server.run()
        dt = time.monotonic() - t0
        outs = [h.result() for h in handles]
        rep = server.memory_report()
        results[layout] = (outs, dt, rep)
        # aggregate decode throughput: per-request decode rates summed
        tput = sum(len(r.tokens) / r.gen_s for r in outs if r.gen_s > 0)
        print(f"[{layout:8s}] kv_cache={rep['kv_bytes']:>9,}B  "
              f"wall={dt:5.2f}s  decode={tput:6.1f} tok/s")

    raw_toks = [r.tokens for r in results["raw"][0]]
    for layout in order[1:]:
        toks = [r.tokens for r in results[layout][0]]
        agree = np.mean([(a == b).mean() for a, b in zip(raw_toks, toks)])
        saved = 1 - results[layout][2]["kv_bytes"] / results["raw"][2]["kv_bytes"]
        print(f"{layout:8s} vs raw: token agreement {agree:5.1%}, "
              f"cache memory saved {saved:5.1%}")

    # a decoded sample (byte-level -> printable text)
    txt = bytes(int(t) for t in raw_toks[0]).decode("utf8", errors="replace")
    print(f"sample continuation (raw): {txt!r}")
    txt = bytes(int(t) for t in results["packed"][0][0].tokens).decode("utf8", errors="replace")
    print(f"sample continuation (kvcomp): {txt!r}")

    # the paged block pool: the same workload through the shared arena
    c = dataclasses.replace(cfg, cache_layout="packed")
    server = api.serve(c, params, max_slots=len(prompts), max_seq=256, cache_mode="paged",
                       q_chunk=64, kv_chunk=64, device=args.device)
    handles = [server.submit(api.Request(prompt=p, max_new_tokens=24)) for p in prompts]
    server.run()
    paged_toks = [h.result().tokens for h in handles]
    agree = np.mean([(r.tokens == t).mean() for r, t in zip(results["packed"][0], paged_toks)])
    print(f"[paged   ] packed tokens agree with dense: {agree:5.1%}")
    print(api.obs.format_snapshot(server.stats()))
    return results


if __name__ == "__main__":
    main()
