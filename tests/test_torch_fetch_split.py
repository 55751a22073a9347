"""The Fetch kernel's split design on the CPU (``csrc/fused_kv_attn.cu``).

The CUDA kernel runs only on the card, so this file holds a plain emulation
of its arithmetic, as a test helper: ranges of ``SPLIT_BLOCKS`` ring slots a
CTA, the scales folded out of the tiles, both products as TF32 tensor-core
products with the float32 side split into hi and lo, an online softmax per
range, and the fixed-order combine with the raw buffer last.  The emulation
is held against the port's plain version and against the reference's Pallas
kernel in interpret mode, within 1e-4 (the card's FETCH_ATOL), on the
``tests/test_kernels.py`` grid for raw, packed, kivi and huffman, and on edge
rows.  ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold the kernel
itself against the plain version on the card.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import cache as JC  # noqa: E402
from repro.core import pool as JP  # noqa: E402
from repro.kernels import ops as JO  # noqa: E402
from repro_torch.core import cache as TC  # noqa: E402
from repro_torch.core import pool as TP  # noqa: E402
from repro_torch.kernels import fused_kv_attn  # noqa: E402
from repro_torch.kernels.ref import NEG_INIT  # noqa: E402

ATOL = 1e-4  # chip_smoke.FETCH_ATOL: the kernel vs its plain version
LAYOUTS = ["raw", "packed", "kivi", "huffman"]
GRID = [(1, 1, 1, 32, 16, 8), (2, 2, 3, 96, 32, 16), (1, 4, 2, 64, 64, 16),
        (2, 1, 8, 48, 24, 8)]
_jprefill = jax.jit(JC.prefill, static_argnums=0)


# ---------------------------------------------------------------------------
# The emulation
# ---------------------------------------------------------------------------

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round float32 to 10 mantissa bits, ties away."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def _product(a: torch.Tensor, x: torch.Tensor, split: bool) -> torch.Tensor:
    """a @ x as the kernel's tensor cores take it: ``a`` (codes or bf16
    values) is exact in TF32, ``x`` is split into TF32 hi and lo, and the
    two products are summed in float32 (``split=False``: hi alone)."""
    hi = _tf32(x)
    if not split:
        return a @ hi
    return a @ hi + a @ _tf32(x - hi)


def _tile_step(state, qg, kt, vt, units, valid, scale, split):
    """One tile's online-softmax update of (m, l, acc), scales folded:
    s = scale * ((q*st_k).c + q.mn_k); out = (p*st_v).c + p.mn_v."""
    m, l, acc = state
    G, T = qg.shape[0], kt.shape[0]
    kmn, kst, vmn, vst = units
    xk = qg if kst is None else qg * kst
    c0 = torch.zeros(G) if kmn is None else qg @ kmn
    s = scale * (_product(kt, xk.T, split).T + c0[:, None])
    ok = torch.arange(T) < valid
    s = torch.where(ok, s, torch.full_like(s, NEG_INIT))
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.where(ok, torch.exp(s - m_new[:, None]), torch.zeros_like(s))
    alpha = torch.exp(m - m_new)
    cv = torch.zeros(G) if vmn is None else p @ vmn
    xv = p if vst is None else p * vst
    pv = _product(vt.T, xv.T, split).T
    return m_new, l * alpha + p.sum(-1), acc * alpha[:, None] + (pv + cv[:, None])


def _combine(parts):
    """Merge (m, l, acc) partials in the given order."""
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    L = torch.zeros_like(M)
    A = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        w = torch.exp(m - M)
        L = L + l * w
        A = A + acc * w[:, None]
    return A / torch.clamp(L, min=1e-30)[:, None]


def emulate_split_fetch(q, k_store, k_min, k_step, v_store, v_min, v_step, k_buf, v_buf,
                        nb_valid, buf_len, page_tab=None, *, tile, block_size, scale=None,
                        split=None, tf32_split=True):
    """The split kernel's arithmetic in plain PyTorch: per (row, KV head),
    ranges [s*S, s*S + S) of the live ring slots (a paged entry that is
    unassigned skips), each range's own online softmax, then the buffer
    masked by ``buf_len``, merged in that order.  Returns (out, the number
    of partial records per (row, head) the kernel's workspace holds)."""
    S = fused_kv_attn.SPLIT_BLOCKS if split is None else split
    B, Hq, D = q.shape
    T, Hkv, P = block_size, k_store.shape[1], k_store.shape[2]
    G = Hq // Hkv
    NB = page_tab.shape[1] if page_tab is not None else P
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    if tile.has_scales:
        kc, vc = tile._codes(k_store, True), tile._codes(v_store, False)
        units = [x.float() for x in (k_min, k_step, v_min, v_step)]
    else:
        kc, vc = k_store.float(), v_store.float()
    out = torch.empty((B, Hq, D))
    for b in range(B):
        nbv = min(max(int(nb_valid[b]), 0), NB)
        for h in range(Hkv):
            qg = q[b, h * G:(h + 1) * G].float()

            def init():
                return torch.full((G,), NEG_INIT), torch.zeros(G), torch.zeros(G, D)
            parts = []
            for s0 in range(0, nbv, S):
                st = init()
                for n in range(s0, min(s0 + S, nbv)):
                    if page_tab is None:
                        i = (b, h, n)
                    else:
                        page = int(page_tab[b, n])
                        if not 0 <= page < P:
                            continue
                        i = (0, h, page)
                    u = tuple(x[i] for x in units) if tile.has_scales else (None,) * 4
                    st = _tile_step(st, qg, kc[i], vc[i], u, T, scale, tf32_split)
                parts.append(st)
            parts.append(_tile_step(init(), qg, k_buf[b, h].float(), v_buf[b, h].float(),
                                    (None,) * 4, int(buf_len[b]), scale, tf32_split))
            out[b, h * G:(h + 1) * G] = _combine(parts)
    return out, -(-NB // S) + 1


# ---------------------------------------------------------------------------
# Both packages on the same data
# ---------------------------------------------------------------------------

def _setup(layout, B, Hkv, S_tok, D, T, max_seq, rng, pages=None, P=None):
    """One prefill in both packages (re-housed in a paged arena when
    ``pages`` is given), and random bf16 buffers the two share."""
    k = rng.normal(size=(B, Hkv, S_tok, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S_tok, D)).astype(np.float32)
    kw = dict(layout=layout, block_size=T, max_seq=max_seq)
    js, ts = JC.CacheSpec(**kw), TC.CacheSpec(**kw)
    jc = _jprefill(js, jnp.asarray(k), jnp.asarray(v))
    tc = TC.prefill(ts, torch.from_numpy(k), torch.from_numpy(v))
    if pages is not None:
        jc, tc = JP.from_dense(jc, P, pages), TP.from_dense(tc, P, pages)
    bufs = [torch.from_numpy(rng.normal(size=(B, Hkv, T, D)).astype(np.float32)).to(
        torch.bfloat16) for _ in range(2)]
    return js, ts, jc, tc, bufs


def _three_ways(js, ts, jc, tc, bufs, q, nb, bl, D, T):
    """(emulation, its record count, plain version, Pallas kernel in
    interpret mode) on the same inputs."""
    paged = tc.spec.paged
    jbufs = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in bufs]
    jargs = (jc.k_store, jc.k_min, jc.k_step, jc.v_store, jc.v_min, jc.v_step, *jbufs,
             jnp.asarray(nb, jnp.int32), jnp.asarray(bl, jnp.int32))
    targs = (tc.k_store, tc.k_min, tc.k_step, tc.v_store, tc.v_min, tc.v_step, *bufs,
             torch.tensor(nb, dtype=torch.int32), torch.tensor(bl, dtype=torch.int32))
    if paged:
        jargs, targs = jargs + (jc.page_tab,), targs + (tc.page_tab,)
    tt = ts.impl.tile_decode(ts, D)
    kernel = np.asarray(JO.fused_cache_attention(
        jnp.asarray(q), *jargs, tile=js.impl.tile_decode(js, D), block_size=T,
        impl="pallas", interpret=True))
    qt = torch.from_numpy(q)
    emu, records = emulate_split_fetch(qt, *targs, tile=tt, block_size=T)
    plain = fused_kv_attn.plain(qt, *targs, tile=tt, block_size=T)
    return emu, records, plain, kernel


def _check(emu, plain, kernel):
    assert torch.isfinite(emu).all()
    np.testing.assert_allclose(emu.numpy(), plain.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(emu.numpy(), kernel, atol=ATOL, rtol=0)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("B,Hkv,G,S,D,T", GRID)
def test_split_emulation_matches_plain_and_reference_kernel(B, Hkv, G, S, D, T, layout, rng):
    """Ragged rows (a row one block short, buffers of T-1 and 3 tokens):
    the emulation of the split kernel within 1e-4 of the plain version and
    of the reference's Pallas kernel; the workspace holds its records."""
    js, ts, jc, tc, bufs = _setup(layout, B, Hkv, S, D, T, 2 * S, rng)
    nb = [S // T - r for r in range(B)]
    bl = [T - 1, 3][:B]
    q = rng.normal(size=(B, Hkv * G, D)).astype(np.float32)
    emu, records, plain, kernel = _three_ways(js, ts, jc, tc, bufs, q, nb, bl, D, T)
    _check(emu, plain, kernel)
    NB = ts.n_blocks
    assert fused_kv_attn.workspace_elems(B, Hkv, G, D, NB, fused_kv_attn.SPLIT_BLOCKS) == (
        B * Hkv * records * G * (D + 2))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_split_emulation_edge_rows(layout, rng):
    """A row with no live block and an empty buffer (output 0), a full row
    of NB blocks and a full buffer, and a partial row."""
    B, Hkv, G, D, T, NB = 3, 2, 2, 16, 8, 6
    js, ts, jc, tc, bufs = _setup(layout, B, Hkv, NB * T, D, T, NB * T, rng)
    nb, bl = [0, NB, 3], [0, T - 1, 5]
    q = rng.normal(size=(B, Hkv * G, D)).astype(np.float32)
    emu, _, plain, kernel = _three_ways(js, ts, jc, tc, bufs, q, nb, bl, D, T)
    _check(emu, plain, kernel)
    assert torch.equal(emu[0], torch.zeros_like(emu[0]))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_split_emulation_paged_range_unassigned(layout, rng):
    """A paged row whose every entry in one range (ring slots S .. 2S-1) is
    unassigned: that range contributes nothing, in the emulation as in the
    plain version and the reference kernel."""
    B, Hkv, G, D, T, NB = 2, 2, 4, 16, 8, 8
    S = fused_kv_attn.SPLIT_BLOCKS
    P = B * NB + 4
    pages = rng.permutation(P)[:B * NB].reshape(B, NB).astype(np.int32)
    pages[0, S:2 * S] = -1
    js, ts, jc, tc, bufs = _setup(layout, B, Hkv, NB * T, D, T, NB * T, rng, pages, P)
    nb, bl = [NB, 5], [3, 0]
    q = rng.normal(size=(B, Hkv * G, D)).astype(np.float32)
    emu, _, plain, kernel = _three_ways(js, ts, jc, tc, bufs, q, nb, bl, D, T)
    _check(emu, plain, kernel)


def test_tf32_split_error_at_yi_width(rng):
    """Yi-6B width (G 8, D 128, T 64), 16 packed blocks (5-bit K, 3-bit V):
    the split's error against the plain version stays near float32's, while
    plain TF32 (hi alone) would sit near the 1e-4 tolerance; the printout is
    the reason for the split, and only the split's error is asserted."""
    G, D, T, n = 8, 128, 64, 16
    ts = TC.CacheSpec(layout="packed", block_size=T, max_seq=n * T)
    k, v = (torch.from_numpy(rng.normal(size=(1, 1, n * T, D)).astype(np.float32))
            for _ in range(2))
    tc = TC.prefill(ts, k, v)
    q = torch.from_numpy(rng.normal(size=(1, G, D)).astype(np.float32))
    bufs = [torch.from_numpy(rng.normal(size=(1, 1, T, D)).astype(np.float32)).to(
        torch.bfloat16) for _ in range(2)]
    args = (tc.k_store, tc.k_min, tc.k_step, tc.v_store, tc.v_min, tc.v_step, *bufs,
            torch.tensor([n], dtype=torch.int32), torch.tensor([T - 1], dtype=torch.int32))
    tile = ts.impl.tile_decode(ts, D)
    plain = fused_kv_attn.plain(q, *args, tile=tile, block_size=T)
    err = {}
    for name, split in (("TF32 hi + lo", True), ("plain TF32", False)):
        emu, _ = emulate_split_fetch(q, *args, tile=tile, block_size=T, tf32_split=split)
        err[name] = float((emu - plain).abs().max())
    print(f"max |emulation - plain| at Yi-6B width: {err}")
    assert err["TF32 hi + lo"] <= ATOL
