"""Quickstart of the PyTorch port: KVComp through ``repro_torch.api``.

Everything goes through the public facade::

    from repro_torch import api
    from repro_torch.core.policy import CompressionPolicy, TensorPolicy

    policy = CompressionPolicy(layout="packed")       # raw|packed|kivi|huffman
    cache  = api.compress(k, v, policy=policy)        # Store (bulk prefill)
    cache  = api.append(cache, k_new, v_new)          # Store (decode append)
    out    = api.attend(cache, q)                     # Fetch (the fused kernel)
    k2, v2 = api.decompress(cache)                    # reconstruct
    report = api.estimate_ratio(k, v, policy=policy)  # exact size accounting
    api.available_layouts()                           # registry contents

This script walks:

1.  Quantize + entropy-code a KV tensor, print the ratio accounting.
2.  Build a compressed KV cache, append tokens, attend, and compare with
    exact attention (``cache.reference_attend``), for every registered
    layout.
3.  The fused Fetch against the decompress-then-attend baseline
    (``cache.attend_materialized``), and on the card against its plain
    version too.

It runs on the card (the Fetch and Store kernels), or with ``--device cpu``
on their plain PyTorch versions:

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch import api
from repro_torch.core import cache as kvcache
from repro_torch.core.policy import CompressionPolicy, TensorPolicy
from repro_torch.kernels import fused_kv_attn, ops


def fetch_plain(cache, q):
    """The Fetch kernel's plain PyTorch version on the cache's tensors."""
    spec = cache.spec
    return fused_kv_attn.plain(
        q, cache.k_store, cache.k_min, cache.k_step, cache.v_store, cache.v_min, cache.v_step,
        cache.k_buf, cache.v_buf, torch.clamp(cache.n_flushed, max=spec.n_blocks),
        cache.buf_len, tile=spec.impl.tile_decode(spec, cache.head_dim),
        block_size=spec.block_size)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    dev = ap.parse_args(argv).device
    rng = np.random.default_rng(0)

    print("=== 1. quantize + entropy-code ===")
    # heavy-tailed synthetic KV (LLM-like statistics), [ctx, heads, head_dim]
    k = torch.as_tensor((rng.standard_t(3, (1024, 8, 64)) * 0.5).astype(np.float32))
    v = torch.as_tensor((rng.standard_t(3, (1024, 8, 64)) * 0.5).astype(np.float32))
    for layout in api.available_layouts():
        r = api.estimate_ratio(k, v, policy=CompressionPolicy(
            layout=layout, block_size=64,
            k=TensorPolicy(rel_scale=0.05), v=TensorPolicy(rel_scale=0.15)))
        print(f"  {layout:8s}: ratio {r['ratio']:5.2f}x  "
              f"(K {r['k'].bits_per_value:.2f} / V {r['v'].bits_per_value:.2f} "
              f"bits/value incl. metadata)")

    print("=== 2. compressed KV cache (prefill + append + attend) ===")
    B, Hkv, S, D = 2, 4, 200, 64

    def normal(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32), device=dev)

    kc, vc, q = normal(B, Hkv, S, D), normal(B, Hkv, S, D), normal(B, Hkv * 2, D)

    def policy(layout):
        return CompressionPolicy(layout=layout, block_size=32,
                                 k=TensorPolicy(rel_scale=0.05),
                                 v=TensorPolicy(rel_scale=0.15))

    # decode-time appending (paper §3.2.3): the same 3 tokens for every layout
    k_new, v_new = normal(3, B, Hkv, D), normal(3, B, Hkv, D)
    ref = kvcache.reference_attend(torch.cat([kc, k_new.permute(1, 2, 0, 3)], dim=2),
                                   torch.cat([vc, v_new.permute(1, 2, 0, 3)], dim=2), q)
    caches, sizes = {}, {}
    for layout in api.available_layouts():
        cache = api.compress(kc, vc, policy=policy(layout), max_seq=512, device=dev)
        for t in range(3):
            cache = api.append(cache, k_new[t], v_new[t])
        err = float((api.attend(cache, q) - ref).abs().max())
        nbytes = sum(getattr(cache, f).numel() * getattr(cache, f).element_size()
                     for f in cache.FIELDS)
        caches[layout], sizes[layout] = cache, nbytes
        print(f"  [{layout:8s}] total_len={int(cache.total_len[0])}  cache bytes={nbytes:>9,}  "
              f"attend |Δ| vs exact={err:.3f}")
    for layout, nbytes in sizes.items():
        if layout != "raw":
            print(f"  {layout:8s} vs raw allocation: {sizes['raw'] / nbytes:.2f}x smaller")

    print("=== 3. fused Fetch vs decompress-then-attend ===")
    cache = caches["packed"]
    fused = ops.cache_decode_attention(cache, q)  # the kernel on the card, plain on the CPU
    if dev == "cuda":
        err = float((fused - fetch_plain(cache, q)).abs().max())
        print(f"  fetch kernel-vs-plain max diff: {err:.2e}")
    what = "kernel" if dev == "cuda" else "plain"
    err = float((fused - kvcache.attend_materialized(cache, q)).abs().max())
    print(f"  fetch {what}-vs-materialized max diff: {err:.2e}")
    print("done.")


if __name__ == "__main__":
    main()
