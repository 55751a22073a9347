#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result lines:

1. Device: needs CUDA; prints the card's name and power limit.
2. Build: compiles both hand-written kernels from ``src/repro_torch/csrc``
   (one nvcc each, in parallel) and prints the build seconds and ptxas
   report.
3. Kernel vs plain at Yi-6B shapes (B=4, Hkv=4, G=8, D=128, T=64, NB=64,
   ragged per-row lengths): the Fetch kernel within FETCH_ATOL of its plain
   version for the packed, kivi and raw layouts; the Store kernel's words
   and bf16 scales bit-exact, dropped rows untouched.
4. Serve: a Server on full-width Yi-6B (random weights from a seed, float32,
   all 32 layers), 4 requests of several hundred to 1000 prompt tokens, 32
   new tokens each, every request crossing a block boundary in decode.
   Launch counts are zeroed just before the run and read just after; both
   kernels must have launched.  The output is checked for shape and range,
   and the smoke-size model is held against the port's CPU path (the plain
   versions) under the repository's decided-margin rule.
5. Batched vs solo: the same requests one at a time through a server of the
   same shape; greedy tokens must agree (exact is the contract;
   MIN_AGREEMENT is the floor below which the run fails).
6. Times: each kernel and its plain version at the main path's shapes (CUDA
   events, L2 flushed before each launch, after warm-up), launches per
   decode step, and the bound: the larger of bytes over 3.35 TB/s and
   float32 operations over 67 TFLOP/s (H100 SXM data sheet).  Then where
   the time of one decode step (4 rows decoding) and one 64-token prefill
   chunk goes: torch.profiler device time by kernel group, and the card's
   idle share of the step's wall time.

The last three lines are the card (nvidia-smi), a JSON line with one entry
per kernel, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

FETCH_ATOL = 1e-4      # Fetch kernel vs plain: float32 sums in another order
MIN_AGREEMENT = 0.9    # batched vs solo greedy-token floor (exact expected)
HBM_BYTES_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS = 67e12      # H100 SXM float32, outside the tensor cores
B, HKV, G, D, T, NB = 4, 4, 8, 128, 64, 64
PROMPT_LENS = (300, 500, 750, 1000)  # each % 64 >= 33: decode crosses a block
NEW_TOKENS = 32


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

    spec = C.CacheSpec(layout=layout, block_size=T, max_seq=NB * T)
    c = C.init_layer_cache(spec, B, HKV, D, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    kb = torch.randn((B, HKV, NB, T, D), generator=g, device="cuda").to(torch.bfloat16)
    vb = torch.randn((B, HKV, NB, T, D), generator=g, device="cuda").to(torch.bfloat16)
    slots = torch.arange(NB, device="cuda", dtype=torch.int32)[None].expand(B, NB)
    spec.impl.write_blocks(spec, c, slots, kb, vb)
    c.k_buf.copy_(torch.randn(c.k_buf.shape, generator=g, device="cuda"))
    c.v_buf.copy_(torch.randn(c.v_buf.shape, generator=g, device="cuda"))
    c.n_flushed.copy_(torch.as_tensor(nb_valid, dtype=torch.int32))
    c.buf_len.copy_(torch.as_tensor(buf_len, dtype=torch.int32))
    q = torch.randn((B, HKV * G, D), generator=g, device="cuda")
    return spec, c, q


def fetch_args(spec, c):
    import torch

    return ((c.k_store, c.k_min, c.k_step, c.v_store, c.v_min, c.v_step, c.k_buf,
             c.v_buf, torch.clamp(c.n_flushed, max=NB), c.buf_len),
            dict(tile=spec.impl.tile_decode(spec, D), block_size=T))


def fetch_bound_ms(spec, nb_valid, buf_len) -> tuple[float, str]:
    """Least time for the Fetch work of these inputs: live blocks, valid
    buffer tokens, q in, output out (bytes); the two products per block and
    token (ops).  The scales fold into the products (q.(mn + st*c) = q.mn +
    (q*st).c, and the same for V), so dequantizing each value is a cost of
    the kernel's design, not of the function, and is not counted."""
    live = HKV * int(sum(nb_valid))
    toks = HKV * int(sum(buf_len))
    if spec.layout == "raw":
        blk = 2 * T * D * 2
        per_blk = 4 * G * T * D + G * T
    else:
        blk = 4 * (spec.words_k(D) + spec.words_v(D)) + 2 * 2 * (D + T)
        per_blk = 4 * G * T * D + 2 * G * D + 3 * G * T
    nbytes = live * blk + toks * 2 * D * 2 + 2 * B * HKV * G * D * 4 + 2 * B * 4
    flops = live * per_blk + toks * (4 * G * D + G)
    return bound(nbytes, flops)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_b, t_f = nbytes / HBM_BYTES_S, flops / F32_FLOPS
    return 1e3 * max(t_b, t_f), "bytes" if t_b >= t_f else "operations"


def phase_kernels(report: dict) -> None:
    """Phase 3: each kernel against its plain version on the card."""
    import torch
    from repro_torch.kernels import fused_kv_attn, pack_encode

    nb_valid, buf_len = [64, 37, 1, 0], [0, 63, 17, 5]
    fetch_err = 0.0
    for i, layout in enumerate(("packed", "kivi", "raw")):
        spec, c, q = make_cache(layout, nb_valid, buf_len, seed=i)
        args, kw = fetch_args(spec, c)
        got = fused_kv_attn.fused_cache_attention(q, *args, **kw)
        want = fused_kv_attn.plain(q, *args, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not (err <= FETCH_ATOL and torch.isfinite(got).all()):
            raise AssertionError(f"Fetch kernel vs plain ({layout}): max |err| {err}")
        print(f"  fetch {layout:6s} max|kernel-plain| = {err:.3e} (tol {FETCH_ATOL})")
        fetch_err = max(fetch_err, err)

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


def phase_serve(report: dict) -> None:
    """Phases 4 and 5 on full-width Yi-6B."""
    import torch
    from repro_torch.kernels import runtime
    from repro_torch.models import model as M
    from repro_torch.models import registry
    from repro_torch.serve.scheduler import Request, Server, ServerConfig

    cfg = registry.get_config("yi_6b")
    t0 = time.monotonic()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"  Yi-6B: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads, head_dim {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}; {cfg.param_count() / 1e9:.2f}B float32 params "
          f"({time.monotonic() - t0:.1f} s to init)")
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
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"kernel {name} never launched on the main path")
    report.update(launches=launches, tok_s=n_tok / wall, wall_s=wall,
                  ttft_s=[r.ttft_s for r in results], decode_steps=st["decode_steps"],
                  chunks=st["prefill"]["chunks"])

    # Launches per decode step, measured on one more step of the same state.
    runtime.reset_launches()
    M.decode_step(params, cfg, torch.zeros(B, dtype=torch.long, device="cuda"),
                  torch.full((B,), 100, dtype=torch.int32, device="cuda"), server.state)
    torch.cuda.synchronize()
    report["per_step"] = dict(runtime.launches)
    print(f"  launches per decode step: {report['per_step']}")

    print("[5] batched vs solo", flush=True)
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
    print("[6] where the time goes", flush=True)
    phase_profile(cfg, params, server, prompts)
    del server, solo, params
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

    groups: dict[str, float] = {}
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
             "matmul (cuBLAS)" if any(w in n for w in ("gemm", "gemv", "xmma", "cutlass"))
             else "other PyTorch kernels")
        groups[g] = groups.get(g, 0.0) + us / 1e3
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
    busy = sum(groups.values())
    print(f"  {what}: wall {wall_ms:.2f} ms (unprofiled), device busy {busy:.2f} ms, "
          f"idle share {max(0.0, 1 - busy / wall_ms):.3f}")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"    {g:22s} {ms:9.3f} ms  {ms / busy:6.1%} of device time")
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


def phase_times(report: dict) -> list[dict]:
    """Phase 6: kernel and plain times at the main path's shapes."""
    import torch
    from repro_torch.core import cache as C
    from repro_torch.kernels import fused_kv_attn, pack_encode

    # The last decode step's per-row lengths on the main path.
    nb_valid = [(L + NEW_TOKENS - 1) // T for L in PROMPT_LENS]
    buf_len = [(L + NEW_TOKENS - 1) % T for L in PROMPT_LENS]
    spec, c, q = make_cache("packed", nb_valid, buf_len, seed=21)
    args, kw = fetch_args(spec, c)
    f_ms = timed(lambda: fused_kv_attn.fused_cache_attention(q, *args, **kw))
    f_plain = timed(lambda: fused_kv_attn.plain(q, *args, **kw))
    f_bound, f_by = fetch_bound_ms(spec, nb_valid, buf_len)

    # Store, decode-step shape: the [B, 1] slot vector with every row
    # flushing (a flush step), and with none (the other 63 steps of 64).
    kb, vb = c.k_buf[:, :, None], c.v_buf[:, :, None]
    flush = torch.arange(B, dtype=torch.int32, device="cuda")[:, None] + 10
    drop = torch.full((B, 1), NB, dtype=torch.int32, device="cuda")
    stores = (c.k_store, c.k_min, c.k_step, c.v_store, c.v_min, c.v_step)
    skw = dict(bits_k=spec.bits_k, bits_v=spec.bits_v, rel_scale_k=spec.rel_scale_k,
               rel_scale_v=spec.rel_scale_v, kivi=False)
    s_ms = timed(lambda: pack_encode.pack_encode(kb, vb, flush, *stores, **skw))
    s_drop = timed(lambda: pack_encode.pack_encode(kb, vb, drop, *stores, **skw))
    s_plain = timed(lambda: pack_encode.pack_encode_plain(kb, vb, flush, *stores, **skw))
    n_val = 2 * B * HKV * T * D
    s_bytes = (n_val * 2 + B * 4 + B * HKV * 4 * (spec.words_k(D) + spec.words_v(D))
               + B * HKV * 2 * 2 * (D + T))
    s_bound, s_by = bound(s_bytes, 4 * n_val)
    print(f"  fetch (packed, nb_valid {nb_valid}, buf_len {buf_len}): kernel {f_ms:.4f} ms, "
          f"plain {f_plain:.4f} ms, bound {f_bound:.5f} ms ({f_by}), "
          f"{report['per_step']['fused_kv_attn']} launches/decode step")
    print(f"  store (decode step, B={B}): kernel {s_ms:.4f} ms with every row flushing, "
          f"{s_drop:.4f} ms with none, plain {s_plain:.4f} ms, bound {s_bound:.5f} ms "
          f"({s_by}), {report['per_step']['pack_encode']} launches/decode step")
    return [
        {"name": "fused_kv_attn", "route": "cuda",
         "source": "src/repro_torch/csrc/fused_kv_attn.cu",
         "replaces": "src/repro/kernels/fused_kv_attn.py:57",
         "launches": report["launches"]["fused_kv_attn"], "max_abs_err": report["fetch_err"],
         "ms": f_ms, "plain_ms": f_plain, "bound_ms": f_bound, "bound_by": f_by,
         "library_ms": None},
        {"name": "pack_encode", "route": "cuda",
         "source": "src/repro_torch/csrc/pack_encode.cu",
         "replaces": "src/repro/kernels/pack_encode.py:46",
         "launches": report["launches"]["pack_encode"], "max_abs_err": report["store_err"],
         "ms": s_ms, "plain_ms": s_plain, "bound_ms": s_bound, "bound_by": s_by,
         "library_ms": None},
    ]


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
    report: dict = {}
    print("[3] kernels vs plain at Yi-6B shapes", flush=True)
    phase_kernels(report)
    print("[4] serve full-width Yi-6B", flush=True)
    phase_serve(report)
    print("[4] reference check on the smoke model", flush=True)
    phase_reference()
    print("[6] kernel times", flush=True)
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
