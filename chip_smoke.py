#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --split-sweep   # phases 1, 2, then the Fetch at S = 1, 2, 4
    python3 chip_smoke.py --walk-parent DIR   # phases 1, 2, then DIR's walk kernels vs these

Phases, in the order they run (11 after 4, 12 after 9, times last); any
failure exits non-zero before the result lines:

1. Device: needs CUDA; prints the card's name and power limit.
2. Build: compiles the three hand-written kernel libraries from
   ``src/repro_torch/csrc`` (one nvcc each, in parallel) and prints the build
   seconds and ptxas report; the Fetch library's split count must equal the
   wrapper's ``SPLIT_BLOCKS``, and its SASS must hold tensor-core (HMMA)
   instructions.
3. Kernel vs plain at Yi-6B shapes (B=4, Hkv=4, G=8, D=128, T=64, NB=64,
   ragged per-row lengths): the Fetch kernel within FETCH_ATOL of its plain
   version for the packed, kivi, raw and huffman layouts, each row's output
   bit-identical alone and in the batch, and two launches bit-identical;
   on the same blocks the huffman Fetch bit-identical to the packed Fetch;
   the Store kernel's words and bf16 scales bit-exact, dropped rows
   untouched.
4. Paged kernel vs plain at Yi-6B shapes (B=8, arena of 128 pages, shuffled
   page tables, ragged lengths, unassigned entries below a row's live
   blocks): the paged Fetch within FETCH_ATOL of its plain version for
   packed, kivi, raw and huffman, each row alone == in the batch, two
   launches bit-identical, and (no holes) bit-identical to the dense Fetch
   on the same blocks; huffman bit-identical to packed on the same blocks;
   the Store into arena pages bit-exact, rows that do not flush or whose
   entry is unassigned leaving the arena untouched.
11. Huffman decode kernels at Yi-6B width (NBLK = 4 heads x 64 blocks = 256,
   64 streams of 128 codes) on real huffman K slots, with the layout's
   default K book and a fitted skewed book (longest code over 8 bits, so 2
   LUT probes): the public entry points ``huffman_decode`` and
   ``huffman_attn_scores`` once each per book and the slot LUT decode twice
   (with the book's multi-symbol table and with the LUT alone), with the
   counts zeroed just before; codes bit-exact against the plain versions and
   equal to the quantized codes, scores within SCORES_ATOL.  Then both walk
   kernels on ``walk_edge_cases`` (S of 1, 40, 64 and 100; edge books and
   streams) against their plain versions, by the same rule.
5. Serve, dense: a Server on full-width Yi-6B (random weights from a seed,
   float32, all 32 layers; built once and shared by every serving phase), 4
   requests of several hundred to 1000 prompt tokens, 32 new tokens each,
   every request crossing a block boundary in decode.  Launch counts are
   zeroed just before the run and read just after; both kernels must have
   launched.  The output is checked for shape and range.
6. Batched vs solo: the same requests one at a time through a server of the
   same shape; greedy tokens must agree exactly (MIN_AGREEMENT = 1.0).
7. Where the time of one dense decode step (4 rows decoding) and one
   64-token prefill chunk goes: torch.profiler device time by kernel group,
   and the card's idle share of the step's wall time.
8. The smoke-size model on the card against the port's CPU path (the plain
   versions) under the repository's decided-margin rule.
9. Serve, paged: 8 requests of 280 to 750 prompt tokens, 48 new tokens each
   (every one crossing a block boundary in decode), max_slots 8, through
   (a) a pool of two dense rows' bytes, where all 8 must decode at once;
   (b) a pool tight enough to preempt; (c) a dense server of 8 slots.  The
   greedy tokens of (a), (b) and (c) must be identical.  Launch counts are
   zeroed before each run; every pure decode step of (a) must launch the
   paged Fetch and the Store once per layer and the dense Fetch never.  In
   (a) and (c), one decode step with all 8 rows live and one prefill chunk
   are profiled as in phase 7.
12. Serve huffman (``cache_layout="huffman"``, the same weights): (a) dense
   on phase 5's requests and server shape, (b) paged on phase 9(a)'s
   requests and pool bytes.  Every pure decode step must launch the huffman
   Fetch (dense, or paged) once per layer and nothing else; every chunk must
   run the slot LUT decode once a span of its store scan and layer (K and V
   in one launch: 4 spans x 32 layers = 128), in the run and in the profiled
   chunks.  Greedy tokens must equal phase 5's and
   phase 9(a)'s packed tokens exactly (the same codes, entropy-coded).  One
   decode step and one chunk of each are profiled as in phase 7.
10. Times: each kernel and its plain version at the main path's shapes (CUDA
   events, L2 flushed before each launch, after warm-up), launches per
   decode step, and the bound: the larger of bytes over 3.35 TB/s and
   operations over the peak rate of the units that run them (H100 SXM data
   sheet): 495 TFLOP/s TF32 for the Fetch's products (two a product: hi and
   lo), printed beside the bytes alone and the earlier yardstick of float32
   operations over 67 TFLOP/s; 67 TFLOP/s for the other kernels.  The
   Fetch, packed and huffman, is timed at the dense run's last lengths, at
   the paged run's last lengths on a shuffled arena beside the dense Fetch
   on the same blocks, and on long rows (4 rows x 64 blocks, buffer 63),
   with the workspace its split partials take; the Store at a decode step's
   shape (every row flushing, and none: CTAs that return at once, the
   method's launch floor), a chunk's (B=1) and 8 rows into arena pages; the
   slot LUT decode at the chunk path's shape (one span of one row, K and V in
   one launch) and at phase 11's 256 K slots; the walk kernels at phase 11's
   shapes, with the default K book (the JSON rows) and the skewed book.

The last three lines are the card (nvidia-smi), a JSON line with one entry
per kernel, and ``{"ok": true, "device": {...}}``.  ``--split-sweep`` builds
the Fetch library with 1, 2 and 4 ring slots a CTA (``-DFETCH_SPLIT_BLOCKS``)
and times each on phase 10's Fetch cases, in the order 1, 2, 4, 4, 2, 1.
``--walk-parent DIR`` builds the walk kernels of the checkout at DIR (an
earlier commit, unpacked there) and times them against this tree's on phase
11's inputs, in the order parent, this tree, this tree, parent.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

FETCH_ATOL = 1e-4      # Fetch kernel vs plain: float32 sums in another order
SCORES_ATOL = 1e-4     # huffman_attn_scores vs plain: float32 sums in another order
MIN_AGREEMENT = 1.0    # batched vs solo greedy-token agreement: exact
HBM_BYTES_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS = 67e12      # H100 SXM float32, outside the tensor cores
TF32_FLOPS = 495e12    # H100 SXM TF32 tensor cores, dense
B, HKV, G, D, T, NB = 4, 4, 8, 128, 64, 64
PROMPT_LENS = (300, 500, 750, 1000)  # each % 64 >= 33: decode crosses a block
NEW_TOKENS = 32
# The paged serving phase: 8 slots; each prompt % 64 >= 17, so 48 new
# tokens cross a block boundary in decode.
PAGED_LENS = (280, 350, 420, 490, 560, 630, 700, 750)
PAGED_NEW = 48
PB, P_ARENA = 8, 128  # paged kernel checks: rows, arena pages
TIGHT_PAGES = 40      # preempts (4 times in a CPU run of the same lengths)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True)
    return out.stdout.strip().splitlines()[0]


def timed(fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean device ms of ``fn``.  Each launch is enqueued behind an L2 flush
    and a ~1 ms spin, so the card never waits for the host to enqueue it and
    the events time device work alone."""
    import torch

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(iters)]
    for a, b in ev:
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in ev) / iters


def bf16_bits(t):
    import torch

    return t.view(torch.int16)


def make_cache(layout: str, nb_valid, buf_len, seed: int):
    """A Yi-6B-shaped layer cache with random contents in every slot, written
    through the Store kernel (packed layouts) and given per-row lengths."""
    import torch
    from repro_torch.core import cache as C

    b = len(nb_valid)
    spec = C.CacheSpec(layout=layout, block_size=T, max_seq=NB * T)
    c = C.init_layer_cache(spec, b, HKV, D, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    kb = torch.randn((b, HKV, NB, T, D), generator=g, device="cuda").to(torch.bfloat16)
    vb = torch.randn((b, HKV, NB, T, D), generator=g, device="cuda").to(torch.bfloat16)
    slots = torch.arange(NB, device="cuda", dtype=torch.int32)[None].expand(b, NB)
    spec.impl.write_blocks(spec, c, slots, kb, vb)
    c.k_buf.copy_(torch.randn(c.k_buf.shape, generator=g, device="cuda"))
    c.v_buf.copy_(torch.randn(c.v_buf.shape, generator=g, device="cuda"))
    c.n_flushed.copy_(torch.as_tensor(nb_valid, dtype=torch.int32))
    c.buf_len.copy_(torch.as_tensor(buf_len, dtype=torch.int32))
    q = torch.randn((b, HKV * G, D), generator=g, device="cuda")
    return spec, c, q


def make_paged(c, nb_valid, seed: int, holes=()):
    """Re-house a filled cache's live blocks in a shuffled arena of P_ARENA
    pages; the other table entries, and the (row, slot) ``holes`` below a
    row's live blocks, stay unassigned (-1)."""
    import torch
    from repro_torch.core import pool

    g = torch.Generator().manual_seed(seed)
    perm = torch.randperm(P_ARENA, generator=g).tolist()
    pages = torch.full((len(nb_valid), NB), -1, dtype=torch.int32)
    for b, n in enumerate(nb_valid):
        for j in range(n):
            if (b, j) not in holes:
                pages[b, j] = perm.pop()
    return pool.from_dense(c, P_ARENA, pages.cuda())


def fetch_args(spec, c):
    import torch

    args = (c.k_store, c.k_min, c.k_step, c.v_store, c.v_min, c.v_step, c.k_buf,
            c.v_buf, torch.clamp(c.n_flushed, max=NB), c.buf_len)
    if c.spec.paged:
        args += (c.page_tab,)
    return args, dict(tile=spec.impl.tile_decode(spec, D), block_size=T)


def huffman_slot_bytes(spec, c, nb_valid) -> int:
    """Bytes of the live huffman slots of dense cache ``c`` that a decode
    must read: each slot's u16 header and the payload words its streams
    occupy (the worst-case padding after them is never read)."""
    import torch
    from repro_torch.core.layouts import unpack_u16_pairs

    tile = spec.impl.tile_decode(spec, D)
    live = (torch.arange(c.k_store.shape[2], device="cuda")[None, :]
            < torch.as_tensor(nb_valid, device="cuda")[:, None])[:, None, :]  # [B, 1, NB]
    words = 0
    for store, hdr in ((c.k_store, tile.hdr_k), (c.v_store, tile.hdr_v)):
        bits = unpack_u16_pairs(store[..., :hdr], T).sum(-1)  # [B, H, NB]
        words += int(((hdr + (bits + 31) // 32) * live).sum())
    return 4 * words


def fetch_bound_ms(spec, nb_valid, buf_len, paged: bool = False,
                   cache=None) -> dict:
    """Least time for the Fetch work of these inputs: live blocks, valid
    buffer tokens, q in, output out, and the page table when paged (bytes);
    the two products per block and token (ops).  The scales fold into the
    products (q.(mn + st*c) = q.mn + (q*st).c, and the same for V), so
    dequantizing each value is not counted.  Huffman slots count their
    header and the payload words this data fills (from the dense ``cache``)
    and the two LUTs once; the entropy decode's integer work is not counted.

    The kernel runs the products on the tensor cores as two TF32 products
    each (hi and lo), so ``bound_ms`` is the larger of the bytes and those
    operations over the TF32 rate; ``f32_ms`` keeps the earlier yardstick,
    the larger of the bytes and the operations over the float32 rate."""
    B = len(nb_valid)
    live = HKV * int(sum(nb_valid))
    toks = HKV * int(sum(buf_len))
    if spec.layout == "raw":
        blocks = live * 2 * T * D * 2
        per_blk = 4 * G * T * D + G * T
    else:
        if spec.layout == "huffman":
            tile = spec.impl.tile_decode(spec, D)
            blocks = (huffman_slot_bytes(spec, cache, nb_valid) + live * 2 * 2 * (D + T)
                      + 4 * (tile.book_k.decode_lut().size + tile.book_v.decode_lut().size))
        else:
            blocks = live * (4 * (spec.words_k(D) + spec.words_v(D)) + 2 * 2 * (D + T))
        per_blk = 4 * G * T * D + 2 * G * D + 3 * G * T
    nbytes = blocks + toks * 2 * D * 2 + 2 * B * HKV * G * D * 4 + 2 * B * 4
    if paged:
        nbytes += B * NB * 4
    flops = live * per_blk + toks * (4 * G * D + G)
    b_ms, by = bound(nbytes, 2 * flops, TF32_FLOPS)
    f_ms, f_by = bound(nbytes, flops)
    return dict(bound_ms=b_ms, bound_by=by, bytes_ms=1e3 * nbytes / HBM_BYTES_S, f32_ms=f_ms,
                f32_by=f_by)


def bound(nbytes: float, flops: float, rate: float = F32_FLOPS) -> tuple[float, str]:
    t_b, t_f = nbytes / HBM_BYTES_S, flops / rate
    return 1e3 * max(t_b, t_f), "bytes" if t_b >= t_f else "operations"


def same_blocks_identical(nb_valid, buf_len, seed: int, holes=None) -> None:
    """The same random blocks stored packed and huffman hold the same codes
    and scales, so the Fetch kernel's outputs must be bit-identical (dense,
    or paged on the same page map when ``holes`` is given)."""
    import torch
    from repro_torch.kernels import fused_kv_attn

    out = {}
    for layout in ("packed", "huffman"):
        spec, c, q = make_cache(layout, nb_valid, buf_len, seed=seed)
        if holes is not None:
            c = make_paged(c, nb_valid, seed=seed, holes=holes)
        args, kw = fetch_args(spec, c)
        out[layout] = (fused_kv_attn.fused_cache_attention(q, *args, **kw),
                       [getattr(c, f) for f in ("k_min", "k_step", "v_min", "v_step")])
    torch.cuda.synchronize()
    for a, b in zip(out["packed"][1], out["huffman"][1]):
        if not torch.equal(bf16_bits(a), bf16_bits(b)):
            raise AssertionError("packed and huffman scales differ on the same blocks")
    if not torch.equal(out["packed"][0], out["huffman"][0]):
        d = float((out["packed"][0] - out["huffman"][0]).abs().max())
        raise AssertionError(f"huffman Fetch differs from packed on the same blocks: {d}")
    mode = "paged" if holes is not None else "dense"
    print(f"  {mode} fetch on the same blocks: huffman output bit-identical to packed")


def split_rule_checks(spec, c, q) -> None:
    """The Fetch's split rule on the card: two launches on the same inputs
    give the same bits, and each row's output is the same alone as beside
    the batch's longer and shorter rows (dense: the row's slice of the
    stores; paged: the shared arena and the row's table)."""
    import torch
    from repro_torch.kernels import fused_kv_attn

    run = fused_kv_attn.fused_cache_attention
    args, kw = fetch_args(spec, c)
    out = run(q, *args, **kw)
    mode = "paged" if c.spec.paged else "dense"
    if not torch.equal(out, run(q, *args, **kw)):
        raise AssertionError(f"two Fetch launches on the same inputs differ ({spec.layout}, "
                             f"{mode})")
    for r in range(q.shape[0]):
        row = tuple(a if c.spec.paged and i < 6 else a[r:r + 1] for i, a in enumerate(args))
        if not torch.equal(run(q[r:r + 1], *row, **kw), out[r:r + 1]):
            raise AssertionError(f"row {r}'s Fetch output alone differs from its output in "
                                 f"the batch ({spec.layout}, {mode})")
    print(f"  split rule ({spec.layout}, {mode}): two launches bit-identical; "
          f"{q.shape[0]}/{q.shape[0]} rows alone == in the batch")


def phase_kernels(report: dict) -> None:
    """Phase 3: each kernel against its plain version on the card."""
    import torch
    from repro_torch.kernels import fused_kv_attn, pack_encode

    nb_valid, buf_len = [64, 37, 1, 0], [0, 63, 17, 5]
    fetch_err = 0.0
    for i, layout in enumerate(("packed", "kivi", "raw", "huffman")):
        spec, c, q = make_cache(layout, nb_valid, buf_len, seed=i)
        args, kw = fetch_args(spec, c)
        got = fused_kv_attn.fused_cache_attention(q, *args, **kw)
        want = fused_kv_attn.plain(q, *args, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not (err <= FETCH_ATOL and torch.isfinite(got).all()):
            raise AssertionError(f"Fetch kernel vs plain ({layout}): max |err| {err}")
        print(f"  fetch {layout:7s} max|kernel-plain| = {err:.3e} (tol {FETCH_ATOL})")
        if layout == "huffman":
            report["fetch_huffman_err"] = err
        else:
            fetch_err = max(fetch_err, err)
        split_rule_checks(spec, c, q)
    same_blocks_identical(nb_valid, buf_len, seed=9)

    store_err = 0.0
    for layout, dt, n in (("packed", torch.bfloat16, 1), ("kivi", torch.bfloat16, 1),
                          ("packed", torch.float32, 3)):
        spec, c, _ = make_cache(layout, nb_valid, buf_len, seed=7)
        g = torch.Generator(device="cuda")
        g.manual_seed(11)
        kb = torch.randn((B, HKV, n, T, D), generator=g, device="cuda").to(dt)
        vb = torch.randn((B, HKV, n, T, D), generator=g, device="cuda").to(dt)
        slots = torch.tensor([[5 + j for j in range(n)], [NB] * n,
                              [NB - 1 - j for j in range(n)], [j for j in range(n)]],
                             dtype=torch.int32, device="cuda")  # row 1 drops
        names = ("k_store", "k_min", "k_step", "v_store", "v_min", "v_step")
        a = [getattr(c, f).clone() for f in names]
        b = [getattr(c, f).clone() for f in names]
        kw = dict(bits_k=spec.bits_k, bits_v=spec.bits_v, rel_scale_k=spec.rel_scale_k,
                  rel_scale_v=spec.rel_scale_v, kivi=spec.impl.kivi_step)
        pack_encode.pack_encode(kb, vb, slots, *a, **kw)
        pack_encode.pack_encode_plain(kb, vb, slots, *b, **kw)
        torch.cuda.synchronize()
        for f, x, y in zip(names, a, b):
            xb = x if x.dtype == torch.int32 else bf16_bits(x)
            yb = y if y.dtype == torch.int32 else bf16_bits(y)
            if x.dtype != torch.int32:
                store_err = max(store_err, float((x.float() - y.float()).abs().max()))
            if not torch.equal(xb, yb):
                raise AssertionError(f"Store kernel vs plain ({layout}, {dt}): {f} "
                                     f"differs in {int((xb != yb).sum())} entries")
        if not torch.equal(a[0][1], c.k_store[1]):
            raise AssertionError("Store kernel wrote a dropped row")
        print(f"  store {layout:6s} {str(dt):14s} n={n}: words and bf16 scales bit-exact")
    print(f"  store max|kernel-plain| of the bf16 scales = {store_err:.3e} (tol 0)")
    report["fetch_err"], report["store_err"] = fetch_err, store_err


def phase_paged_kernels(report: dict) -> None:
    """Phase 4: the paged Fetch and the Store into arena pages against their
    plain versions on the card."""
    import torch
    from repro_torch.core import pool
    from repro_torch.kernels import fused_kv_attn, pack_encode, runtime

    nb_valid = [40, 33, 12, 1, 0, 5, 9, 17]
    buf_len = [0, 63, 17, 5, 1, 33, 60, 2]
    holes = {(2, 1), (0, 39)}  # unassigned entries below nb_valid
    err = 0.0
    for i, layout in enumerate(("packed", "kivi", "raw", "huffman")):
        spec, c, q = make_cache(layout, nb_valid, buf_len, seed=30 + i)
        pc = make_paged(c, nb_valid, seed=i, holes=holes)
        assert pc.k_store.shape[:3] == (1, HKV, P_ARENA)
        args, kw = fetch_args(spec, pc)
        key = "fused_kv_attn_huffman_paged" if layout == "huffman" else "fused_kv_attn_paged"
        n0 = runtime.launches[key]
        got = fused_kv_attn.fused_cache_attention(q, *args, **kw)
        if runtime.launches[key] != n0 + 1:
            raise AssertionError(f"the paged Fetch did not count a launch as {key}")
        want = fused_kv_attn.plain(q, *args, **kw)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        if not (e <= FETCH_ATOL and torch.isfinite(got).all()):
            raise AssertionError(f"paged Fetch kernel vs plain ({layout}): max |err| {e}")
        print(f"  paged fetch {layout:7s} max|kernel-plain| = {e:.3e} (tol {FETCH_ATOL})")
        if layout == "huffman":
            report["fetch_huffman_paged_err"] = e
        else:
            err = max(err, e)
        split_rule_checks(spec, pc, q)
        # no holes: the paged kernel must give the dense kernel's bits
        full = make_paged(c, nb_valid, seed=i)
        fargs, _ = fetch_args(spec, full)
        dargs, _ = fetch_args(spec, c)
        if not torch.equal(fused_kv_attn.fused_cache_attention(q, *fargs, **kw),
                           fused_kv_attn.fused_cache_attention(q, *dargs, **kw)):
            raise AssertionError(f"paged Fetch on a shuffled arena differs from dense on the "
                                 f"same blocks ({layout})")
        print(f"  paged fetch {layout:7s} on a shuffled arena bit-identical to dense on the "
              f"same blocks")
    report["fetch_paged_err"] = err
    same_blocks_identical(nb_valid, buf_len, seed=19, holes=holes)

    names = pool.STORE_FIELDS
    for layout, dt in (("packed", torch.bfloat16), ("kivi", torch.bfloat16),
                       ("packed", torch.float32)):
        spec, c, _ = make_cache(layout, nb_valid, buf_len, seed=40)
        pc = make_paged(c, nb_valid, seed=7, holes=holes)
        g = torch.Generator(device="cuda")
        g.manual_seed(12)
        kb = torch.randn((PB, HKV, 1, T, D), generator=g, device="cuda").to(dt)
        vb = torch.randn((PB, HKV, 1, T, D), generator=g, device="cuda").to(dt)
        # rows 1 (no flush), 2 (its hole), 4 and 0 (unassigned entries) drop
        logical = torch.tensor([[39], [NB], [1], [0], [0], [2], [8], [16]],
                               dtype=torch.int32, device="cuda")
        slots = pool.lookup_slots(pc.page_tab, logical, NB, P_ARENA).to(torch.int32)
        dropped = (slots[:, 0] == P_ARENA).tolist()
        if dropped != [True, True, True, False, True, False, False, False]:
            raise AssertionError(f"unexpected drop pattern {dropped}")
        a = [getattr(pc, f).clone() for f in names]
        b = [getattr(pc, f).clone() for f in names]
        kw = dict(bits_k=spec.bits_k, bits_v=spec.bits_v, rel_scale_k=spec.rel_scale_k,
                  rel_scale_v=spec.rel_scale_v, kivi=spec.impl.kivi_step)
        pack_encode.pack_encode(kb, vb, slots, *a, **kw)
        pack_encode.pack_encode_plain(kb, vb, slots, *b, **kw)
        torch.cuda.synchronize()
        written = {int(x) for x in slots[:, 0] if int(x) < P_ARENA}
        keep = [p for p in range(P_ARENA) if p not in written]
        for f, x, y in zip(names, a, b):
            old = getattr(pc, f)
            if x.dtype != torch.int32:
                x, y, old = bf16_bits(x), bf16_bits(y), bf16_bits(old)
            if not torch.equal(x, y):
                raise AssertionError(f"arena Store kernel vs plain ({layout}, {dt}): {f} "
                                     f"differs in {int((x != y).sum())} entries")
            if not torch.equal(x[:, :, keep], old[:, :, keep]):
                raise AssertionError(f"arena Store wrote a page no flush was for ({f})")
        print(f"  arena store {layout:6s} {str(dt):14s}: {len(written)} pages written "
              f"bit-exact, {len(keep)} untouched")


NBLK_H = HKV * NB  # phase 11: every block of one layer's K store


def huffman_inputs(seed: int = 60) -> list[dict]:
    """Real huffman K slots at Yi-6B width: random K blocks, quantized as the
    layout quantizes them, encoded (a) with the layout's default K book and
    (b) with a book fitted to the squared histogram of the same codes
    (sharper, so its longest code exceeds 8 bits and needs 2 LUT probes)."""
    import torch
    from repro_torch.core import huffman, layouts
    from repro_torch.core import cache as C

    spec = C.CacheSpec(layout="huffman", block_size=T, max_seq=NB * T)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    k = torch.randn((NBLK_H, T, D), generator=g, device="cuda").to(torch.bfloat16)
    codes, kmn, kst = layouts.quant_block_minmax(k.float(), spec.rel_scale_k, spec.bits_k,
                                                 (-2,), False)
    hist = huffman.histogram(codes).cpu().numpy().astype(np.float64)
    sharp = np.where(hist > 0, np.maximum(1.0, 1e12 * (hist / hist.max()) ** 2), 0)
    books = (("default", spec.impl.book_k(spec)),
             ("skewed", huffman.build_codebook(sharp.astype(np.int64))))
    q = torch.randn((D,), generator=g, device="cuda")
    out = []
    for name, book in books:
        slots = spec.impl._encode(spec, codes, book)  # [NBLK, hdr + payload]
        hdr = spec.impl._slot_words(spec, D, book)[0]
        nbits = layouts.unpack_u16_pairs(slots[:, :hdr], T)
        out.append(dict(name=name, book=book, codes=codes, slots=slots, hdr=hdr,
                        payload=slots[:, hdr:].contiguous(), nbits=nbits,
                        tables=book.as_device_tables("cuda"), lut=book.device_lut("cuda"),
                        multi=book.device_multi_lut("cuda"),
                        max_bits=int(nbits.max()), kmn=kmn.to(torch.bfloat16).float(),
                        kst=kst.to(torch.bfloat16).float(), q=q, scale=1.0 / np.sqrt(D)))
    return out


def walk_edge_cases(device, streams=(1, 40, 64), seed: int = 7) -> list[dict]:
    """Edge cases of the walk kernels (phase 11, and the tests on the CPU and
    the card): the layout's default K and V books, a skewed book whose codes
    run to 16 bits (past the kernels' root-table peek), a one-symbol book,
    and the K book's tables with one child rewired to the root; a zero-bit
    stream, max_bits below nbits, budgets past the payload (reads clamp to
    the last word), random words (bit 31 set in half of them), S of each of
    ``streams``, more symbols a stream than L, and an L that is not a
    multiple of 4 (byte rows out, zero score factors past L).  Each case:
    payload int32 [NBLK, W], nbits int32 [NBLK, S], the tree tables, L,
    max_bits, and k_min / k_step f32 [NBLK, L], q f32 [L] and a scale for
    the scores."""
    import torch
    from repro_torch.core import huffman, layouts

    rng = np.random.default_rng(seed)
    skew = np.zeros(huffman.N_SYMBOLS, np.int64)
    skew[:21] = np.logspace(0, 9, 21)[::-1].astype(np.int64)
    one = np.zeros(huffman.N_SYMBOLS, np.int64)
    one[7] = 1
    k_book, v_book = layouts.default_codebook(21), layouts.default_codebook(8)

    def encode(book, nblk, S, n):
        codes = rng.choice(np.flatnonzero(book.lengths), (nblk, S, n)).astype(np.uint8)
        words = (S * n * int(book.lengths.max()) + 31) // 32 + 1
        payload, nbits, _ = huffman.encode_block_torch(torch.from_numpy(codes).to(device),
                                                       *book.encode_tables(device), words)
        return payload, nbits

    def f32(shape, positive=False):
        x = rng.normal(size=shape).astype(np.float32)
        return torch.from_numpy(np.abs(x) if positive else x).to(device)

    cases = []

    def add(name, book, payload, nbits, L, max_bits=None, tables=None):
        nblk = payload.shape[0]
        cases.append(dict(name=name, payload=payload, nbits=nbits, L=L,
                          tables=tables or book.as_device_tables(device),
                          max_bits=int(nbits.max()) if max_bits is None else max_bits,
                          kmn=f32((nblk, L)), kst=f32((nblk, L), True), q=f32((L,)),
                          scale=float(L) ** -0.5))

    for S in streams:
        payload, nbits = encode(k_book, 3, S, 128)
        nbits[0, S // 2] = 0
        add(f"K book, S={S}, a zero-bit stream", k_book, payload, nbits, 128)
    add("V book, S=40", v_book, *encode(v_book, 2, 40, 128), 128)
    add("skewed book, codes to 16 bits", huffman.build_codebook(skew),
        *encode(huffman.build_codebook(skew), 2, 64, 128), 128)
    payload, nbits = encode(k_book, 2, 64, 128)
    add("K book, max_bits below nbits", k_book, payload, nbits, 128, int(nbits.max()) // 2)
    add("K book, more symbols than L", k_book, payload, nbits, 100)
    # every stream of the last block starts and ends past its own bits, the
    # last ones past the payload
    add("K book, budgets past the payload", k_book, payload, nbits + torch.tensor(
        [[0], [400]], dtype=torch.int32, device=device), 128)
    ch, isym, sym = (t.clone() for t in k_book.as_device_tables(device))
    ch[int(ch[0, 1]), 0] = 0
    add("K tables, a child rewired to the root", k_book, payload, nbits, 128,
        tables=(ch, isym, sym))
    words = torch.from_numpy(rng.integers(0, 1 << 32, (3, 300), dtype=np.uint64)
                             .astype(np.uint32).view(np.int32)).to(device)
    counts = torch.from_numpy(rng.integers(0, 700, (3, 40)).astype(np.int32)).to(device)
    add("one-symbol book, random words", huffman.build_codebook(one), words, counts, 128)
    add("K book, random words, L=99", k_book, words, counts, 99)
    return cases


def phase_huffman_kernels(report: dict) -> None:
    """Phase 11: the huffman decode kernels at Yi-6B width, each driven once
    per codebook through its entry point (counts zeroed just before, read
    just after), then held against its plain version."""
    import torch
    from repro_torch.kernels import huffman_decode, ops, runtime

    inputs = huffman_inputs()
    runtime.reset_launches()
    outs = []
    for x in inputs:
        outs.append((
            ops.huffman_decode(x["payload"], x["nbits"], *x["tables"], D, x["max_bits"]),
            ops.huffman_attn_scores(x["payload"], x["nbits"], *x["tables"], x["kmn"], x["kst"],
                                    x["q"], x["max_bits"], scale=x["scale"]),
            *(huffman_decode.huffman_lut_decode(x["slots"], x["lut"], block_size=T, head_dim=D,
                                                hdr_words=x["hdr"],
                                                probes=x["book"].decode_probes, multi=m)
              for m in (x["multi"], None))))
    torch.cuda.synchronize()
    launches = {k: v for k, v in runtime.launches.items() if v}
    want = {"huffman_decode": 2, "huffman_attn_scores": 2, "huffman_lut_decode": 4}
    print(f"  launches of the driven calls: {launches}")
    if launches != want:
        raise AssertionError(f"huffman kernel launches {launches}, expected {want}")
    err = 0.0
    for x, (codes, scores, multi_codes, lut_codes) in zip(inputs, outs):
        book = x["book"]
        plain = huffman_decode.huffman_decode_plain(x["payload"], x["nbits"], *x["tables"], D,
                                                    x["max_bits"])
        sc_plain = huffman_decode.huffman_attn_scores_plain(
            x["payload"], x["nbits"], *x["tables"], x["kmn"], x["kst"], x["q"], x["max_bits"],
            scale=x["scale"])
        lut_plain = huffman_decode.huffman_lut_decode_plain(
            x["slots"], x["lut"], block_size=T, head_dim=D, hdr_words=x["hdr"],
            probes=book.decode_probes)
        torch.cuda.synchronize()
        e = float((scores - sc_plain).abs().max())
        checks = {"walk codes == plain": torch.equal(codes, plain),
                  "walk codes == quantized codes": torch.equal(codes, x["codes"]),
                  f"scores within {SCORES_ATOL}": e <= SCORES_ATOL
                  and bool(torch.isfinite(scores).all()),
                  "LUT slot codes == plain": torch.equal(lut_codes, lut_plain),
                  "LUT slot codes == quantized codes": torch.equal(lut_codes, x["codes"]),
                  "multi-symbol slot codes == plain": torch.equal(multi_codes, lut_plain)}
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            raise AssertionError(f"huffman kernels, {x['name']} book: failed {bad} "
                                 f"(scores max |err| {e})")
        print(f"  {x['name']:7s} book: max code length {int(book.lengths.max())} bits, "
              f"{book.decode_probes} probe(s), {book.n_nodes} nodes; payload bits a block "
              f"{int(x['nbits'].sum(-1).float().mean())} (mean); walk, LUT and multi-symbol "
              f"codes bit-exact and lossless, scores max|kernel-plain| = {e:.3e} "
              f"(tol {SCORES_ATOL})")
        err = max(err, e)
    codes_err, err = walk_edge_checks(err)
    report["huffman_kernels"] = dict(launches=launches, scores_err=err, codes_err=codes_err)


def walk_edge_checks(scores_err: float) -> tuple[int, float]:
    """Phase 11, edge cases (``walk_edge_cases``, S of 1, 40, 64 and 100):
    both walk kernels against their plain versions, codes bit-exact and
    scores within SCORES_ATOL.  Returns the largest code and score errors,
    the score error at least ``scores_err``."""
    import torch
    from repro_torch.kernels import huffman_decode, ops

    codes_err = 0
    for x in walk_edge_cases("cuda", streams=(1, 40, 64, 100)):
        args = (x["payload"], x["nbits"], *x["tables"])
        codes = ops.huffman_decode(*args, x["L"], x["max_bits"])
        plain = huffman_decode.huffman_decode_plain(*args, x["L"], x["max_bits"])
        sc_args = (*args, x["kmn"], x["kst"], x["q"], x["max_bits"])
        scores = ops.huffman_attn_scores(*sc_args, scale=x["scale"])
        sc_plain = huffman_decode.huffman_attn_scores_plain(*sc_args, scale=x["scale"])
        torch.cuda.synchronize()
        c_err = int((codes.int() - plain.int()).abs().max())
        e = float((scores - sc_plain).abs().max())
        if c_err or not (e <= SCORES_ATOL and bool(torch.isfinite(scores).all())):
            raise AssertionError(f"walk kernels, edge case {x['name']!r}: codes max |err| "
                                 f"{c_err}, scores max |err| {e} (tol {SCORES_ATOL})")
        codes_err, scores_err = max(codes_err, c_err), max(scores_err, e)
        print(f"  edge case {x['name']}: NBLK={x['nbits'].shape[0]}, S={x['nbits'].shape[1]}, "
              f"L={x['L']}, max_bits {x['max_bits']}: codes bit-exact, scores max|kernel-plain| "
              f"= {e:.3e}")
    return codes_err, scores_err


def yi_6b():
    """Full-width Yi-6B with random float32 weights from seed 0."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models import registry

    cfg = registry.get_config("yi_6b")
    t0 = time.monotonic()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"  Yi-6B: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads, head_dim {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}; {cfg.param_count() / 1e9:.2f}B float32 params "
          f"({time.monotonic() - t0:.1f} s to init)")
    return cfg, params


def phase_serve(report: dict, cfg, params) -> None:
    """Phases 5, 6 and 7 on full-width Yi-6B, dense."""
    import torch
    from repro_torch.kernels import runtime
    from repro_torch.models import model as M
    from repro_torch.serve.scheduler import Request, Server, ServerConfig

    spec = M.cache_spec(cfg, 4096)
    print(f"  cache: {spec.layout}, block {spec.block_size}, K {spec.bits_k} bits "
          f"({spec.words_k(D)} words/block), V {spec.bits_v} bits "
          f"({spec.words_v(D)} words/block)")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, L).astype(np.int32) for L in PROMPT_LENS]
    scfg = ServerConfig(max_slots=B, max_seq=4096, attn_backend="fused")

    server = Server(cfg, params, scfg)
    handles = [server.submit(Request(prompt=p, max_new_tokens=NEW_TOKENS)) for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runtime.reset_launches()
    t0 = time.monotonic()
    server.run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(runtime.launches)
    peak = torch.cuda.max_memory_allocated()
    results = [h.result() for h in handles]
    for p, r in zip(prompts, results):
        toks = r.tokens
        if toks.shape != (NEW_TOKENS,) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"bad output for prompt of {len(p)}: {toks}")
        print(f"  prompt {len(p):4d}: ttft {r.ttft_s:.3f} s, tokens {toks[:8].tolist()}...")
    n_tok = sum(len(r.tokens) for r in results)
    st = server.stats()
    print(f"  served {n_tok} tokens in {wall:.2f} s: {n_tok / wall:.1f} tok/s, "
          f"mean ttft {np.mean([r.ttft_s for r in results]):.3f} s, "
          f"{st['decode_steps']} decode steps, {st['prefill']['chunks']} prefill chunks")
    kv = server.memory_report()["kv_bytes"]
    raw = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.resolved_head_dim * 2
    print(f"  KV cache of the live state: {kv / 2**20:.1f} MiB for {B} x 4096 token "
          f"slots = {kv / (B * 4096):.0f} B a token over {cfg.n_layers} layers "
          f"(raw bf16: {raw} B, ratio {raw * B * 4096 / kv:.2f}); peak device "
          f"memory {peak / 2**30:.2f} GiB")
    print(f"  kernels launched on the main path: {launches}")
    for name in ("fused_kv_attn", "pack_encode"):
        if launches[name] < 1:
            raise AssertionError(f"kernel {name} never launched on the main path")
    others = {k: v for k, v in launches.items() if v and k not in ("fused_kv_attn", "pack_encode")}
    if others:
        raise AssertionError(f"the dense packed path launched {others}")
    report.update(launches=launches, tok_s=n_tok / wall, wall_s=wall,
                  ttft_s=[r.ttft_s for r in results], decode_steps=st["decode_steps"],
                  chunks=st["prefill"]["chunks"], tokens=[r.tokens for r in results])

    # Launches per decode step, measured on one more step of the same state.
    runtime.reset_launches()
    M.decode_step(params, cfg, torch.zeros(B, dtype=torch.long, device="cuda"),
                  torch.full((B,), 100, dtype=torch.int32, device="cuda"), server.state)
    torch.cuda.synchronize()
    report["per_step"] = dict(runtime.launches)
    print(f"  launches per decode step: {report['per_step']}")

    print("[6] batched vs solo", flush=True)
    solo = Server(cfg, params, scfg)
    agree = total = 0
    for p, r in zip(prompts, results):
        s = solo.submit(Request(prompt=p, max_new_tokens=NEW_TOKENS)).result().tokens
        agree += int((s == r.tokens).sum())
        total += len(r.tokens)
    frac = agree / total
    print(f"  batched vs solo greedy agreement: {agree}/{total} = {frac:.4f} "
          f"(contract: exact; floor {MIN_AGREEMENT})")
    if frac < MIN_AGREEMENT:
        raise AssertionError(f"batched vs solo agreement {frac} < {MIN_AGREEMENT}")
    report["agreement"] = frac
    print("[7] where the time goes", flush=True)
    phase_profile(cfg, params, server, prompts)
    del server, solo
    torch.cuda.empty_cache()


def phase_reference() -> None:
    """The smoke-size model on the card against the port's CPU path (the
    plain versions) on the same weights: teacher-forced logits, noise bound
    and decided-margin greedy agreement as in the repository's tests."""
    import dataclasses

    import torch
    from repro_torch.models import model as M
    from repro_torch.models import registry

    cfg = dataclasses.replace(registry.get_smoke_config("yi_6b"), attn_backend="fused")
    pc = M.init_params(cfg, seed=3, device="cpu")
    pg = _to(pc, "cuda")
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, 60)
    out = {}
    for dev, p in (("cpu", pc), ("cuda", pg)):
        st = M.init_decode_state(cfg, 1, 128, device=dev)
        logits = []
        for pos in range(0, 40, cfg.cache_block):
            lg, _ = M.prefill_chunk(p, cfg, torch.as_tensor(toks[None, pos:pos + 8], device=dev),
                                    pos, st)
        logits.append(lg)
        for pos in range(40, 60):
            lg, _ = M.decode_step(p, cfg, torch.as_tensor(toks[pos:pos + 1], device=dev),
                                  pos, st)
            logits.append(lg)
        out[dev] = torch.cat(logits).float().cpu().numpy()
    noise = float(np.abs(out["cpu"] - out["cuda"]).max())
    if not (np.isfinite(out["cuda"]).all() and noise < 0.5):
        raise AssertionError(f"card vs CPU logits: noise {noise}")
    top2 = np.sort(out["cpu"], axis=-1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > 2 * noise
    agree = out["cpu"].argmax(-1) == out["cuda"].argmax(-1)
    if not agree[decided].all():
        raise AssertionError("card vs CPU: a decided greedy token differs")
    print(f"  smoke model, card vs CPU plain path: max |dlogit| {noise:.2e}, "
          f"{int(decided.sum())}/{len(decided)} steps decided, all decided agree")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def _kernel_groups(prof) -> tuple[dict, list]:
    """Device ms by kernel group, and the five costliest kernels, from a
    torch.profiler run."""
    from torch.autograd import DeviceType

    groups: dict[str, list] = {}
    kernels = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue  # host-side ops; their kernels are listed on their own
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if not us:
            continue
        n = e.key.lower()
        g = ("fetch kernel" if "fused_kv_attn" in n else
             "store kernel" if "pack_encode" in n else
             "huffman LUT decode kernel" if "huffman_lut_decode" in n else
             "matmul (cuBLAS)" if any(w in n for w in ("gemm", "gemv", "xmma", "cutlass"))
             else "other PyTorch kernels")
        acc = groups.setdefault(g, [0.0, 0])
        acc[0] += us / 1e3
        acc[1] += e.count
        kernels.append((us / 1e3, e.count, e.key[:90]))
    return groups, sorted(kernels, reverse=True)[:5]


def _profiled(fn) -> tuple[float, dict, list]:
    """Wall ms of ``fn`` unprofiled, then its device time by group under
    torch.profiler (the profiler's own host cost would inflate the wall)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.monotonic()
    fn()
    torch.cuda.synchronize()
    wall = 1e3 * (time.monotonic() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return (wall, *_kernel_groups(prof))


def _print_profile(what: str, wall_ms: float, groups: dict, top: list) -> None:
    busy = sum(ms for ms, _ in groups.values())
    print(f"  {what}: wall {wall_ms:.2f} ms (unprofiled), device busy {busy:.2f} ms, "
          f"idle share {max(0.0, 1 - busy / wall_ms):.3f}")
    for g, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"    {g:26s} {ms:9.3f} ms  {ms / busy:6.1%} of device time, {n:6d} launches")
    for ms, n, name in top:
        print(f"      {ms:8.3f} ms in {n:4d} launches: {name}")


def phase_profile(cfg, params, server, prompts) -> None:
    """Where a decode step (4 rows decoding) and a prefill chunk spend their
    time: two consecutive steps, the first timed bare, the second profiled."""
    import torch

    from repro_torch.models import model as M
    from repro_torch.serve.scheduler import Request

    for p in prompts:
        server.submit(Request(prompt=p, max_new_tokens=NEW_TOKENS))
    while server.prefilling or server.pending or server.active < B:
        server.step()
    torch.cuda.synchronize()
    _print_profile("decode step (4 rows)", *_profiled(server.step))
    server.run()

    st = M.init_decode_state(cfg, 1, 4096, device="cuda")
    toks = torch.as_tensor(prompts[-1][None, :640], device="cuda")
    for pos in range(0, 512, T):
        M.prefill_chunk(params, cfg, toks[:, pos:pos + T], pos, st)
    pos = [512]

    def chunk():
        M.prefill_chunk(params, cfg, toks[:, pos[0]:pos[0] + T], pos[0], st)
        pos[0] += T

    _print_profile("prefill chunk (64 tokens at 512, 576)", *_profiled(chunk))


def _chunk_profile(cfg, params, server, prompt) -> float:
    """One 64-token prefill chunk at positions 512 and 576 of ``prompt``, as
    ``server`` admits it: through a batch-1 view of its arena, on pages
    from its pool (paged), or through a private batch-1 state (dense).
    Returns the slot LUT decode's launches a chunk (the two profiled ones)."""
    import torch
    from repro_torch.kernels import runtime
    from repro_torch.models import model as M

    toks = torch.as_tensor(prompt[None, :640], device="cuda")
    if server.paged:
        host = np.full(NB, -1, np.int64)
        host[:10] = server.pool.alloc(10)

        def state(pos):
            pages = torch.as_tensor(host, dtype=torch.int32, device="cuda")
            return M.chunk_state_view(server.state, pages, pos)
    else:
        st = M.init_decode_state(cfg, 1, 4096, device="cuda")

        def state(pos):
            return st
    for pos in range(0, 512, T):
        M.prefill_chunk(params, cfg, toks[:, pos:pos + T], pos, state(pos))
    pos = [512]

    def chunk():
        M.prefill_chunk(params, cfg, toks[:, pos[0]:pos[0] + T], pos[0], state(pos[0]))
        pos[0] += T

    mode = "paged" if server.paged else "dense"
    n0 = runtime.launches["huffman_lut_decode"]
    _print_profile(f"{cfg.cache_layout} {mode} prefill chunk (64 tokens at 512, 576)",
                   *_profiled(chunk))
    return (runtime.launches["huffman_lut_decode"] - n0) / 2


def _serve_run(cfg, params, prompts, scfg, new_tokens: int, profile: bool = False) -> dict:
    """Serve ``prompts`` through one server, stepping by hand: the launch
    counts of every pure decode step (the kernels that launched, and how
    often), the peak number of live rows, and (``profile``) one decode step
    with every row live and, after the run, one prefill chunk."""
    import torch
    from repro_torch.kernels import runtime
    from repro_torch.serve.scheduler import Request, Server

    server = Server(cfg, params, scfg)
    handles = [server.submit(Request(prompt=p, max_new_tokens=new_tokens)) for p in prompts]
    rows = len(prompts)
    torch.cuda.synchronize()
    runtime.reset_launches()
    peak, per_step, wall, out = 0, set(), 0.0, {}
    while True:
        st0, l0 = server.stats(), dict(runtime.launches)
        if (profile and "profile" not in out and server.active == rows
                and not server.prefilling and not server.pending):
            if server.paged:
                live = [r for r, h in enumerate(server._slots) if h is not None]
                tokens = int(sum(server._pos[r] for r in live))
                pool = server.pool
                out["kv_b_per_token"] = pool.live_pages * pool.bytes_per_page / tokens
                print(f"  all {rows} rows live: {pool.live_pages} pages x {pool.bytes_per_page} "
                      f"B over {tokens} cached tokens = {out['kv_b_per_token']:.0f} B a token "
                      f"over {cfg.n_layers} layers")
            out["profile"] = _profiled(server.step)
            mode = "paged" if server.paged else "dense"
            _print_profile(f"{cfg.cache_layout} {mode} decode step ({rows} rows)",
                           *out["profile"])
            continue
        t0 = time.monotonic()
        more = server.step()
        wall += time.monotonic() - t0
        st1 = server.stats()
        if (st1["decode_steps"] == st0["decode_steps"] + 1
                and st1["prefill"]["chunks"] == st0["prefill"]["chunks"]):
            per_step.add(tuple(sorted((k, v - l0[k]) for k, v in runtime.launches.items()
                                      if v - l0[k])))
        peak = max(peak, server.active)
        if not more:
            break
    torch.cuda.synchronize()
    st = server.stats()
    out.update(tokens=[h.result().tokens for h in handles], launches=dict(runtime.launches),
               per_step=per_step, peak=peak, wall=wall, stats=st,
               ttft=[h.result().ttft_s for h in handles],
               kv_bytes=server.memory_report()["kv_bytes"])
    n_tok = sum(len(t) for t in out["tokens"])
    out["tok_s"] = n_tok / wall
    print(f"  served {n_tok} tokens in {wall:.2f} s of steps: {n_tok / wall:.1f} tok/s, "
          f"mean ttft {np.mean(out['ttft']):.3f} s, {st['decode_steps']} decode steps, "
          f"{st['prefill']['chunks']} prefill chunks, peak {peak} rows live, "
          f"{st['preemptions']} preemptions ({st['prefill']['prefill_preemptions']} "
          f"mid-prefill)")
    if "pool" in st:
        p = st["pool"]
        print(f"  pool: {p['pages_total']} pages of {p['bytes_per_page']} B, high water "
              f"{p['high_water_pages']}, {p['alloc_pages']} allocated, {p['freed_pages']} "
              f"freed, {p['pages_live']} live at the end")
    print(f"  launches: {out['launches']}; per pure decode step: "
          f"{[dict(x) for x in sorted(per_step)]}")
    for toks in out["tokens"]:
        if (toks.shape != (new_tokens,) or toks.min() < 0 or toks.max() >= cfg.vocab_size):
            raise AssertionError(f"bad output: {toks}")
    if profile:
        if "profile" not in out:
            raise AssertionError("no step had every row live to profile")
        out["lut_per_chunk"] = _chunk_profile(cfg, params, server, prompts[-1])
    del server
    torch.cuda.empty_cache()
    return out


def phase_paged_serve(report: dict, cfg, params) -> None:
    """Phase 9: paged serving on full-width Yi-6B, ample pool, tight pool,
    and a dense server of the same shape; the greedy tokens of all three
    must be identical."""
    from repro_torch.core import pool
    from repro_torch.models import model as M
    from repro_torch.serve.scheduler import ServerConfig

    specs = M.cache_specs(cfg, 4096)
    page_b = sum(pool.page_nbytes(s, cfg.n_kv_heads, cfg.resolved_head_dim) for s in specs)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, L).astype(np.int32) for L in PAGED_LENS]
    base = dict(max_slots=PB, max_seq=4096, attn_backend="fused")
    print(f"  one page is {page_b} B across {cfg.n_layers} layers ({page_b / 2**20:.3f} MiB)")

    print(f"  (a) ample pool: two dense rows' bytes ({2 * NB} pages)", flush=True)
    a = _serve_run(cfg, params, prompts, ServerConfig(
        cache_mode="paged", pool_hbm_bytes=2 * NB * page_b, **base), PAGED_NEW, profile=True)
    if a["peak"] != PB:
        raise AssertionError(f"only {a['peak']} of {PB} requests decoded at once")
    n_layers = cfg.n_layers
    want = {(("fused_kv_attn_paged", n_layers), ("pack_encode", n_layers))}
    if a["per_step"] != want:
        raise AssertionError(f"paged decode step launches {a['per_step']}, expected {want}")

    print(f"  (b) tight pool: {TIGHT_PAGES} pages", flush=True)
    b = _serve_run(cfg, params, prompts, ServerConfig(
        cache_mode="paged", pool_hbm_bytes=TIGHT_PAGES * page_b, **base), PAGED_NEW)
    if b["stats"]["preemptions"] < 1:
        raise AssertionError("the tight pool preempted nothing")

    print("  (c) dense, 8 slots", flush=True)
    c = _serve_run(cfg, params, prompts, ServerConfig(cache_mode="dense", **base), PAGED_NEW,
                   profile=True)
    for name, run in (("tight", b), ("dense", c)):
        same = sum(int((x == y).all()) for x, y in zip(a["tokens"], run["tokens"]))
        print(f"  ample vs {name}: {same}/{PB} requests with identical greedy tokens")
        if same != PB:
            raise AssertionError(f"paged ample vs {name}: tokens differ")
    report["paged"] = dict(launches=a["launches"], tok_s=a["tok_s"], per_step=n_layers,
                           kv_b_per_token=a["kv_b_per_token"],
                           preemptions=b["stats"]["preemptions"], tokens=a["tokens"],
                           pool_bytes=2 * NB * page_b)


def phase_huffman_serve(report: dict, cfg, params) -> None:
    """Phase 12: full-width Yi-6B with huffman caches, dense on phase 5's
    requests and paged on phase 9(a)'s; tokens equal the packed runs'."""
    import dataclasses

    from repro_torch.core import pool
    from repro_torch.models import model as M
    from repro_torch.serve.scheduler import ServerConfig

    from repro_torch.core import cache as C

    hcfg = dataclasses.replace(cfg, cache_layout="huffman")
    n_layers = cfg.n_layers
    specs = M.cache_specs(hcfg, 4096)
    span = min(max(1, C.BLOCKWISE_SPAN_TOKENS // T), NB)
    spans = -(-NB // span)  # spans of the chunk path's store scan
    page_b = sum(pool.page_nbytes(s, cfg.n_kv_heads, cfg.resolved_head_dim) for s in specs)
    spec = specs[0]
    tile = spec.impl.tile_decode(spec, cfg.resolved_head_dim)
    print(f"  cache: huffman, block {spec.block_size}; K book {int((tile.book_k.lengths > 0).sum())} codes of "
          f"{int(tile.book_k.lengths[tile.book_k.lengths > 0].min())} to "
          f"{int(tile.book_k.lengths.max())} bits, V book "
          f"{int((tile.book_v.lengths > 0).sum())} codes; slots {tile.k_tile[0]} K / "
          f"{tile.v_tile[0]} V words; one page {page_b} B across {n_layers} layers")
    out = {}
    rng = np.random.default_rng(0)
    dense_prompts = [rng.integers(0, cfg.vocab_size, L).astype(np.int32) for L in PROMPT_LENS]
    rng = np.random.default_rng(1)
    paged_prompts = [rng.integers(0, cfg.vocab_size, L).astype(np.int32) for L in PAGED_LENS]
    pool_bytes = report["paged"]["pool_bytes"]
    for mode, prompts, scfg, new, want_tokens in (
            ("dense", dense_prompts, ServerConfig(max_slots=B, max_seq=4096,
                                                  attn_backend="fused"),
             NEW_TOKENS, report["tokens"]),
            ("paged", paged_prompts, ServerConfig(max_slots=PB, max_seq=4096,
                                                  attn_backend="fused", cache_mode="paged",
                                                  pool_hbm_bytes=pool_bytes),
             PAGED_NEW, report["paged"]["tokens"])):
        print(f"  ({'a' if mode == 'dense' else 'b'}) {mode}: {len(prompts)} requests"
              + (f", pool of {pool_bytes} B = {pool_bytes // page_b} huffman pages"
                 if mode == "paged" else ""), flush=True)
        r = _serve_run(hcfg, params, prompts, scfg, new, profile=True)
        key = "fused_kv_attn_huffman" + ("_paged" if mode == "paged" else "")
        if r["per_step"] != {((key, n_layers),)}:
            raise AssertionError(f"huffman {mode} decode step launches {r['per_step']}, "
                                 f"expected {key} x {n_layers} and nothing else")
        # every chunk's store scan decodes each span's K and V in one launch
        want_lut = n_layers * spans
        chunks = r["stats"]["prefill"]["chunks"]
        print(f"  slot LUT decode: {r['launches']['huffman_lut_decode']} launches in "
              f"{chunks} chunks; {r['lut_per_chunk']:g} a profiled chunk ({spans} spans x "
              f"{n_layers} layers = {want_lut})")
        if (r["lut_per_chunk"] != want_lut
                or r["launches"]["huffman_lut_decode"] != want_lut * chunks):
            raise AssertionError(f"huffman {mode}: slot LUT decode launches "
                                 f"{r['launches']['huffman_lut_decode']} in {chunks} chunks, "
                                 f"{r['lut_per_chunk']} a profiled chunk; expected {want_lut} "
                                 f"a chunk")
        same = sum(int((x == y).all()) for x, y in zip(want_tokens, r["tokens"]))
        n_same = sum(int((x == y).sum()) for x, y in zip(want_tokens, r["tokens"]))
        print(f"  huffman vs packed ({mode}): {n_same}/{len(prompts) * new} tokens, "
              f"{same}/{len(prompts)} requests identical")
        if same != len(prompts):
            raise AssertionError(f"huffman {mode} tokens differ from packed")
        if mode == "dense":
            kv = r["kv_bytes"]
            print(f"  KV cache of the live state: {kv / 2**20:.1f} MiB for {B} x 4096 token "
                  f"slots = {kv / (B * 4096):.0f} B a token slot over {n_layers} layers")
        out[mode] = r
    report["huffman"] = dict(
        launches_dense=out["dense"]["launches"], launches_paged=out["paged"]["launches"],
        per_step=n_layers, page_b=page_b, lut_per_chunk=out["dense"]["lut_per_chunk"])


def fetch_cases() -> dict:
    """Phase 10's Fetch inputs, packed and huffman: the dense run's last
    decode-step lengths, the paged run's last lengths on a shuffled arena
    (and the dense cache holding the same blocks), and long rows (every
    slot of the ring live, buffer at 63)."""
    from repro_torch.kernels import fused_kv_attn

    nb_d = [(L + NEW_TOKENS - 1) // T for L in PROMPT_LENS]
    bl_d = [(L + NEW_TOKENS - 1) % T for L in PROMPT_LENS]
    nb_p = [(L + PAGED_NEW - 1) // T for L in PAGED_LENS]
    bl_p = [(L + PAGED_NEW - 1) % T for L in PAGED_LENS]
    nb_l, bl_l = [NB] * B, [T - 1] * B
    out = {}
    for layout in ("packed", "huffman"):
        spec, c, q = make_cache(layout, nb_d, bl_d, seed=21)
        out[layout, "dense"] = dict(spec=spec, c=c, dense=c, q=q, nb=nb_d, bl=bl_d)
        spec, c, q = make_cache(layout, nb_p, bl_p, seed=22)
        out[layout, "paged"] = dict(spec=spec, c=make_paged(c, nb_p, seed=3), dense=c, q=q,
                                    nb=nb_p, bl=bl_p)
        out[layout, "paged blocks, dense"] = dict(spec=spec, c=c, dense=c, q=q, nb=nb_p, bl=bl_p)
        spec, c, q = make_cache(layout, nb_l, bl_l, seed=23)
        out[layout, "long rows"] = dict(spec=spec, c=c, dense=c, q=q, nb=nb_l, bl=bl_l)
    for x in out.values():
        args, kw = fetch_args(x["spec"], x["c"])
        x["run"] = lambda q=x["q"], a=args, k=kw: fused_kv_attn.fused_cache_attention(q, *a, **k)
        x["plain"] = lambda q=x["q"], a=args, k=kw: fused_kv_attn.plain(q, *a, **k)
    return out


def fetch_times(report: dict, cases: dict) -> list[dict]:
    """Phase 10, Fetch part: kernel and plain times of each case, its bound
    (and the float32 yardstick and the bytes alone), and the workspace the
    split partials take; the JSON entries of the four Fetch rows."""
    from repro_torch.kernels import fused_kv_attn

    split = fused_kv_attn.split_blocks()
    steps = {"packed": report["per_step"]["fused_kv_attn"], "huffman": report["huffman"]["per_step"]}
    rows = {}
    for (layout, mode), x in cases.items():
        ms = timed(x["run"])
        plain_ms = None
        if mode != "long rows":  # the plain huffman decode of 1024 blocks takes seconds
            plain_ms = (timed(x["plain"]) if layout == "packed"
                        else timed(x["plain"], iters=5, warmup=1))
        paged = mode == "paged"
        bd = fetch_bound_ms(x["spec"], x["nb"], x["bl"], paged=paged, cache=x["dense"])
        ws = 4 * fused_kv_attn.workspace_elems(len(x["nb"]), HKV, G, D, NB, split)
        plain_s = "" if plain_ms is None else f"plain {plain_ms:.4f} ms, "
        print(f"  fetch ({layout}, {mode}, B={len(x['nb'])}, nb_valid {x['nb']}, buf_len "
              f"{x['bl']}): kernel {ms:.4f} ms, {plain_s}bound {bd['bound_ms']:.6f} ms "
              f"({bd['bound_by']}; bytes alone {bd['bytes_ms']:.6f} ms; float32 yardstick "
              f"{bd['f32_ms']:.6f} ms, {bd['f32_by']}), {ms / bd['bound_ms']:.0f}x the bound; "
              f"split workspace {ws} B; {steps[layout]} launches/decode step")
        rows[layout, mode] = dict(ms=ms, plain_ms=plain_ms, **bd)
    report["fetch_rows"] = rows
    entries = []
    for name, replaces, (layout, mode), launches, err in (
            ("fused_kv_attn", "src/repro/kernels/fused_kv_attn.py:57", ("packed", "dense"),
             report["launches"]["fused_kv_attn"], report["fetch_err"]),
            ("fused_kv_attn_paged", "src/repro/kernels/fused_kv_attn.py:113", ("packed", "paged"),
             report["paged"]["launches"]["fused_kv_attn_paged"], report["fetch_paged_err"]),
            ("fused_kv_attn_huffman", "src/repro/core/layouts.py:822", ("huffman", "dense"),
             report["huffman"]["launches_dense"]["fused_kv_attn_huffman"],
             report["fetch_huffman_err"]),
            ("fused_kv_attn_huffman_paged", "src/repro/core/layouts.py:822",
             ("huffman", "paged"),
             report["huffman"]["launches_paged"]["fused_kv_attn_huffman_paged"],
             report["fetch_huffman_paged_err"])):
        r = rows[layout, mode]
        entries.append({"name": name, "route": "cuda",
                        "source": "src/repro_torch/csrc/fused_kv_attn.cu", "replaces": replaces,
                        "launches": launches, "max_abs_err": err, "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": None})
    return entries


def phase_times(report: dict) -> list[dict]:
    """Phase 10: kernel and plain times at the main path's shapes."""
    import torch
    from repro_torch.kernels import pack_encode

    cases = fetch_cases()
    fetch = fetch_times(report, cases)

    # Store at the main path's shapes: a decode step's [B, 1] slot vector
    # with every row flushing (a flush step; the JSON row) and with none (the
    # other 63 steps of 64: CTAs that return at once, so the method's launch
    # floor), a chunk's B = 1, and 8 rows flushing into arena pages.
    x = cases["packed", "dense"]
    spec, c = x["spec"], x["c"]
    skw = dict(bits_k=spec.bits_k, bits_v=spec.bits_v, rel_scale_k=spec.rel_scale_k,
               rel_scale_v=spec.rel_scale_v, kivi=False)
    stores = (c.k_store, c.k_min, c.k_step, c.v_store, c.v_min, c.v_step)
    pc = cases["packed", "paged"]["c"]
    p_stores = (pc.k_store, pc.k_min, pc.k_step, pc.v_store, pc.v_min, pc.v_step)
    pb = cases["packed", "paged"]["dense"]
    live_pages = {int(v) for v in pc.page_tab.reshape(-1).tolist() if v >= 0}
    free = [pg for pg in range(P_ARENA) if pg not in live_pages][:PB]
    rows = {
        "decode step, every row flushing": (c.k_buf, c.v_buf, stores, torch.arange(
            B, dtype=torch.int32, device="cuda") + 10),
        "decode step, none flushing (launch floor)": (c.k_buf, c.v_buf, stores, torch.full(
            (B,), NB, dtype=torch.int32, device="cuda")),
        "chunk": (c.k_buf[:1], c.v_buf[:1], tuple(t[:1] for t in stores), torch.tensor(
            [10], dtype=torch.int32, device="cuda")),
        "8 rows flushing into arena pages": (pb.k_buf, pb.v_buf, p_stores, torch.tensor(
            free, dtype=torch.int32, device="cuda")),
    }
    store = {}
    for name, (kb, vb, st, slots) in rows.items():
        kb, vb, slots = kb[:, :, None], vb[:, :, None], slots[:, None]
        ms = timed(lambda: pack_encode.pack_encode(kb, vb, slots, *st, **skw))
        nrows = int((slots < st[0].shape[2]).sum())
        n_val = 2 * nrows * HKV * T * D
        s_bytes = (n_val * 2 + slots.numel() * 4
                   + nrows * HKV * (4 * (spec.words_k(D) + spec.words_v(D)) + 2 * 2 * (D + T)))
        b_ms, b_by = bound(s_bytes, 4 * n_val)
        plain = None
        if name.startswith("decode step, every"):
            plain = timed(lambda: pack_encode.pack_encode_plain(kb, vb, slots, *st, **skw))
        store[name] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by)
        print(f"  store ({name}, B={kb.shape[0]}): kernel {ms:.4f} ms"
              + ("" if plain is None else f", plain {plain:.4f} ms")
              + (f", bound {b_ms:.6f} ms ({b_by}), {ms / b_ms:.0f}x the bound" if nrows
                 else ", no block to write"))
    print(f"  store: {report['per_step']['pack_encode']} launches/decode step, 1 a layer a "
          f"chunk")
    s_row = store["decode step, every row flushing"]
    h = huffman_times(report, cases["huffman", "dense"])
    return [
        fetch[0],
        {"name": "pack_encode", "route": "cuda",
         "source": "src/repro_torch/csrc/pack_encode.cu",
         "replaces": "src/repro/kernels/pack_encode.py:46",
         # the Store runs on both paths: the dense and the ample paged run
         "launches": report["launches"]["pack_encode"]
         + report["paged"]["launches"]["pack_encode"],
         "max_abs_err": report["store_err"],
         "ms": s_row["ms"], "plain_ms": s_row["plain_ms"], "bound_ms": s_row["bound_ms"],
         "bound_by": s_row["bound_by"], "library_ms": None},
        *fetch[1:],
        *h,
    ]


def walk_times(report: dict, inputs: list[dict]) -> list[dict]:
    """Phase 10, the walk kernels at phase 11's shapes, with the default K
    book (the JSON rows) and the skewed book.  Bytes: the payload words the
    streams fill, the bit counts, the tree tables once, and the output;
    operations: one a decoded bit, plus the scores' dequant and product (4 a
    code), a lower bound."""
    from repro_torch.kernels import huffman_decode, ops

    hk = report["huffman_kernels"]
    walk, entries = {}, []
    for x in inputs:
        nblk, S = x["nbits"].shape
        bits = x["nbits"].sum(-1)
        pay_bytes = 4 * int(((bits + 31) // 32).sum())
        tab_bytes = 4 * 4 * x["tables"][1].numel()
        steps = int(bits.sum())
        d_args = (x["payload"], x["nbits"], *x["tables"], D, x["max_bits"])
        s_args = (x["payload"], x["nbits"], *x["tables"], x["kmn"], x["kst"], x["q"],
                  x["max_bits"])
        rows = [
            ("huffman_decode", lambda: ops.huffman_decode(*d_args),
             lambda: huffman_decode.huffman_decode_plain(*d_args),
             bound(pay_bytes + 4 * nblk * S + tab_bytes + nblk * S * D, steps)),
            ("huffman_attn_scores", lambda: ops.huffman_attn_scores(*s_args, scale=x["scale"]),
             lambda: huffman_decode.huffman_attn_scores_plain(*s_args, scale=x["scale"]),
             bound(pay_bytes + 4 * nblk * S + tab_bytes + 2 * 4 * nblk * D + 4 * D
                   + 4 * nblk * S, steps + 4 * nblk * S * D)),
        ]
        for name, kern, plain, (b_ms, b_by) in rows:
            k_ms = timed(kern)
            pl_ms = timed(plain, iters=3, warmup=1)
            walk[name, x["name"]] = dict(ms=k_ms, plain_ms=pl_ms, bound_ms=b_ms, bound_by=b_by)
            print(f"  {name} (NBLK={nblk}, S={S}, L={D}, {x['name']} book): kernel {k_ms:.4f} "
                  f"ms, plain {pl_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}), "
                  f"{k_ms / b_ms:.0f}x the bound; {hk['launches'][name]} launches on its path")
    for name, replaces, err in (
            ("huffman_decode", "src/repro/kernels/huffman_decode.py:56", hk["codes_err"]),
            ("huffman_attn_scores", "src/repro/kernels/huffman_decode.py:65", hk["scores_err"])):
        entries.append({"name": name, "route": "cuda",
                        "source": "src/repro_torch/csrc/huffman_decode.cu", "replaces": replaces,
                        "launches": hk["launches"][name], "max_abs_err": err,
                        **walk[name, "default"], "library_ms": None})
    return entries


def huffman_times(report: dict, case: dict) -> list[dict]:
    """Phase 10, huffman part: the walk kernels at phase 11's shapes, the
    slot LUT decode at the chunk path's shape and at phase 11's, and the
    plain huffman Store of a decode step (on the dense huffman Fetch case's
    cache)."""
    import torch
    from repro_torch.core.layouts import unpack_u16_pairs
    from repro_torch.kernels import huffman_decode

    spec, c = case["spec"], case["c"]
    hr = report["huffman"]

    # The plain huffman Store of one layer in a decode step (B rows, drop
    # sentinel or every row flushing): the kernels it launches and their
    # device time (torch.profiler), and its wall a call (host clock over 10
    # calls ending in a synchronize; the host enqueue sets it).
    kb, vb = c.k_buf[:, :, None], c.v_buf[:, :, None]
    flush = torch.arange(B, dtype=torch.int32, device="cuda")[:, None] + 10
    drop = torch.full((B, 1), NB, dtype=torch.int32, device="cuda")
    for name, slots in (("none flushing", drop), ("every row flushing", flush)):
        fn = lambda: spec.impl.write_blocks(spec, c, slots, kb, vb)  # noqa: E731
        fn()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        host_ms = 100 * (time.monotonic() - t0)
        _, groups, _ = _profiled(fn)
        dev_ms = sum(ms for ms, _ in groups.values())
        n = sum(k for _, k in groups.values())
        print(f"  huffman store (plain PyTorch, one layer of a decode step, B={B}, {name}): "
              f"{n} kernel launches, {dev_ms:.4f} ms of kernel time, {host_ms:.3f} ms of wall "
              f"a call")

    inputs = huffman_inputs()
    entries = walk_times(report, inputs)

    # The slot LUT decode as the chunk path calls it: one span (16 slots) of
    # one row's 4 heads, K and V in one launch (the JSON row); and the 256 K
    # slots of phase 11 through the single entry, as timed since PR 13.
    # Bytes: the headers, the payload words the streams fill, the LUTs once
    # and the codes out; operations: one a probe of the LUT.
    def lut_bound(tensors):
        nbytes = ops_ = 0
        for slots, book, hdr in tensors:
            bits = unpack_u16_pairs(slots[:, :hdr], T).sum(-1)
            nbytes += (4 * int((hdr + (bits + 31) // 32).sum()) + 4 * book.decode_lut().size
                       + slots.shape[0] * T * D)
            ops_ += slots.shape[0] * T * D * book.decode_probes
        return bound(nbytes, ops_)

    books = (spec.impl.book_k(spec), spec.impl.book_v(spec))
    span = [spec.impl._slot_args(spec, st[3:4, :, :16], D, book)
            for st, book in zip((c.k_store, c.v_store), books)]
    kw = dict(block_size=T, head_dim=D)
    kv = huffman_decode.huffman_lut_decode_kv(*span, **kw)
    kv_plain = [huffman_decode.huffman_lut_decode_plain(a[0], a[1], hdr_words=a[3],
                                                        probes=a[4], **kw) for a in span]
    lut_err = max(float((o.int() - p.int()).abs().max()) for o, p in zip(kv, kv_plain))
    if not all(torch.equal(o, p) for o, p in zip(kv, kv_plain)):
        raise AssertionError(f"huffman_lut_decode_kv at the chunk call: K and V codes differ "
                             f"from the plain version (max |err| {lut_err})")
    k_ms = timed(lambda: huffman_decode.huffman_lut_decode_kv(*span, **kw))
    pl_ms = timed(lambda: [huffman_decode.huffman_lut_decode_plain(
        a[0], a[1], hdr_words=a[3], probes=a[4], **kw) for a in span], iters=3, warmup=1)
    b_ms, b_by = lut_bound([(a[0], book, a[3]) for a, book in zip(span, books)])
    print(f"  huffman_lut_decode (chunk path: 64 K + 64 V slots, one launch): K and V codes "
          f"== plain; kernel {k_ms:.4f} ms, plain {pl_ms:.4f} ms, bound {b_ms:.6f} ms "
          f"({b_by}), {k_ms / b_ms:.0f}x the bound; {hr['lut_per_chunk']:g} launches a chunk")
    x = inputs[0]
    one = spec.impl._slot_args(spec, x["slots"][None, None], D, x["book"])
    one_ms = timed(lambda: huffman_decode.huffman_lut_decode(
        one[0], one[1], multi=one[2], hdr_words=one[3], probes=one[4], **kw))
    one_b, one_by = lut_bound([(one[0], x["book"], one[3])])
    print(f"  huffman_lut_decode (NBLK={NBLK_H} K slots, single entry): kernel {one_ms:.4f} ms, "
          f"bound {one_b:.6f} ms ({one_by})")
    entries.append({"name": "huffman_lut_decode", "route": "cuda",
                    "source": "src/repro_torch/csrc/huffman_decode.cu", "replaces": None,
                    "launches": hr["launches_dense"]["huffman_lut_decode"]
                    + hr["launches_paged"]["huffman_lut_decode"], "max_abs_err": lut_err,
                    "ms": k_ms, "plain_ms": pl_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": None})
    return entries


def check_build() -> None:
    """Phase 2's checks of the Fetch library: its split count is the
    wrapper's, and its products compiled to tensor-core instructions."""
    import os

    from repro_torch.kernels import fused_kv_attn, runtime

    split = fused_kv_attn.split_blocks()
    if split != fused_kv_attn.SPLIT_BLOCKS:
        raise AssertionError(f"the Fetch library takes {split} ring slots a CTA, the wrapper "
                             f"{fused_kv_attn.SPLIT_BLOCKS}")
    tool = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda") / "bin" / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(runtime.library_path("fused_kv_attn"))],
                          capture_output=True, text=True, check=True).stdout
    hmma = sum("HMMA" in line for line in sass.splitlines())
    if hmma == 0:
        raise AssertionError("the Fetch library's SASS holds no HMMA instruction")
    print(f"    fused_kv_attn: {split} ring slots a CTA; {hmma} HMMA instructions in its SASS")


def split_sweep() -> None:
    """``--split-sweep``: the Fetch built with 1, 2 and 4 ring slots a CTA
    (library variants), each on phase 10's cases, timed in the order 1, 2,
    4, 4, 2, 1; each variant's output is held against the default build's
    within FETCH_ATOL."""
    import torch
    from repro_torch.kernels import fused_kv_attn, runtime

    cases = fetch_cases()
    ref = {k: x["run"]() for k, x in cases.items()}
    times: dict = {}
    for split in (1, 2, 4, 4, 2, 1):
        with runtime.variant("fused_kv_attn", FETCH_SPLIT_BLOCKS=split):
            if fused_kv_attn.split_blocks() != split:
                raise AssertionError(f"variant built with {fused_kv_attn.split_blocks()} slots")
            for k, x in cases.items():
                err = float((x["run"]() - ref[k]).abs().max())
                torch.cuda.synchronize()
                if not err <= FETCH_ATOL:
                    raise AssertionError(f"S={split} {k}: {err} from the default build")
                times.setdefault(k, {}).setdefault(split, []).append(timed(x["run"]))
    for (layout, mode), t in times.items():
        print(f"  fetch ({layout}, {mode}): " + "; ".join(
            f"S={s} " + " / ".join(f"{v:.4f}" for v in ts) + " ms" for s, ts in sorted(t.items())))


def walk_parent(parent: Path) -> None:
    """``--walk-parent DIR``: the walk kernels of the checkout at DIR (its
    huffman_decode library, built from its own sources) against this
    tree's, on phase 11's inputs (default and skewed book), each timed as in
    phase 10 in the order parent, this tree, this tree, parent; every
    output held against the plain version."""
    import torch
    from repro_torch.kernels import huffman_decode, ops, runtime

    times: dict = {}
    for who in ("parent", "this tree", "this tree", "parent"):
        ctx = (runtime.variant("huffman_decode", csrc=parent / "src" / "repro_torch" / "csrc")
               if who == "parent" else contextlib.nullcontext())
        with ctx:
            for x in huffman_inputs():
                d_args = (x["payload"], x["nbits"], *x["tables"], D, x["max_bits"])
                s_args = (x["payload"], x["nbits"], *x["tables"], x["kmn"], x["kst"], x["q"],
                          x["max_bits"])
                codes, scores = ops.huffman_decode(*d_args), ops.huffman_attn_scores(
                    *s_args, scale=x["scale"])
                e = float((scores - huffman_decode.huffman_attn_scores_plain(
                    *s_args, scale=x["scale"])).abs().max())
                if not (torch.equal(codes, x["codes"]) and e <= SCORES_ATOL):
                    raise AssertionError(f"{who}, {x['name']} book: codes or scores differ "
                                         f"(scores max |err| {e})")
                for name, fn in (("huffman_decode", lambda: ops.huffman_decode(*d_args)),
                                 ("huffman_attn_scores", lambda: ops.huffman_attn_scores(
                                     *s_args, scale=x["scale"]))):
                    times.setdefault((name, x["name"], who), []).append(timed(fn))
    for (name, book, who), t in times.items():
        print(f"  {name} ({book} book), {who}: " + " / ".join(f"{v:.4f}" for v in t) + " ms")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import runtime

    t_start = time.monotonic()
    print("[1] device:", card_line(), "| torch", torch.__version__, "cuda", torch.version.cuda,
          flush=True)
    secs = runtime.build()
    print(f"[2] build seconds: {secs}", flush=True)
    for name, log in runtime.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"    {name}: {line.strip()}")
    check_build()
    if sys.argv[1:2] == ["--walk-parent"]:
        print(f"[walk parent] the walk kernels of {sys.argv[2]} against this tree's", flush=True)
        walk_parent(Path(sys.argv[2]))
        print(f"total {time.monotonic() - t_start:.1f} s")
        print(card_line())
        return 0
    if sys.argv[1:] == ["--split-sweep"]:
        print("[split sweep] the Fetch at 1, 2 and 4 ring slots a CTA", flush=True)
        split_sweep()
        print(f"total {time.monotonic() - t_start:.1f} s")
        print(card_line())
        return 0
    report: dict = {}
    print("[3] kernels vs plain at Yi-6B shapes", flush=True)
    phase_kernels(report)
    print("[4] paged kernels vs plain at Yi-6B shapes", flush=True)
    phase_paged_kernels(report)
    print("[11] huffman decode kernels at Yi-6B width", flush=True)
    phase_huffman_kernels(report)
    print("[5] serve full-width Yi-6B, dense", flush=True)
    cfg, params = yi_6b()
    phase_serve(report, cfg, params)
    print("[8] reference check on the smoke model", flush=True)
    phase_reference()
    print("[9] serve full-width Yi-6B, paged", flush=True)
    phase_paged_serve(report, cfg, params)
    print("[12] serve full-width Yi-6B, huffman", flush=True)
    phase_huffman_serve(report, cfg, params)
    del params
    torch.cuda.empty_cache()
    print("[10] kernel times", flush=True)
    kernels = phase_times(report)
    print(f"total {time.monotonic() - t_start:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
