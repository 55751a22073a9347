"""The port's paged block pool (``repro_torch.core.pool``) and paged serving,
held against the reference's on the CPU, with seeded numpy inputs fed to
both packages:

* the allocator, ``page_nbytes`` and ``lookup_slots`` equal the
  reference's;
* arena words, bf16 scales, buffers, lengths and page tables are bit-exact
  against the compiled reference (``jax.jit`` of ``C.append`` on a paged
  spec), unassigned entries and ring reuse included;
* the plain paged Fetch is within 1e-4 of the reference's Pallas kernel in
  interpret mode, ``-1`` entries below ``nb_valid`` included;
* the paged ``Server`` gives the reference paged ``Server``'s greedy tokens
  and preemption count;
* the port's own contracts: paged == dense, chunked == solo, device page
  tables == host mirror with no page shared by two rows, chunk flushes land
  in their pages, and a half-prefilled row preempted and resumed gives its
  solo tokens (DESIGN.md §13; the reference's own test of that aborts in
  XLA on this install).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import cache as JC  # noqa: E402
from repro.core import pool as JP  # noqa: E402
from repro.kernels import ops as JO  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.serve import scheduler as JS  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import cache as TC  # noqa: E402
from repro_torch.core import pool as TP  # noqa: E402
from repro_torch.kernels import fused_kv_attn  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.serve import scheduler as TS  # noqa: E402

LAYOUTS = ["raw", "packed", "kivi", "huffman"]


def bits_of(x):
    """A cache tensor of either package as raw bits (uint16 / uint32)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        x = x.numpy()
        return x.view(np.uint32) if x.dtype == np.int32 else x
    x = np.asarray(x)
    if x.dtype == jnp.bfloat16:
        return x.view(np.uint16)
    return x.view(np.uint32) if x.dtype == np.int32 else x


def assert_same_state(jc, tc):
    for f in TC.LayerKVCache.FIELDS:
        a, b = bits_of(getattr(jc, f)), bits_of(getattr(tc, f))
        assert a.shape == b.shape, (f, a.shape, b.shape)
        np.testing.assert_array_equal(b, a, err_msg=f)


# ---------------------------------------------------------------------------
# Host side: the allocator and the byte accounting
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_op_sequences_match_reference(seed):
    """The same random alloc / retain / release sequence on both pools: the
    same pages handed out and freed, the same errors, the same stats."""
    rng = np.random.default_rng(seed)
    jp, tp = JP.PagedBlockPool(12, (64, 16)), TP.PagedBlockPool(12, (64, 16))
    held: list[int] = []
    for _ in range(300):
        op = rng.integers(0, 3)
        if op == 0:
            n = int(rng.integers(0, 6))
            if n > tp.free_pages:
                for p in (jp, tp):
                    with pytest.raises(Exception, match="need"):
                        p.alloc(n)
                continue
            got = tp.alloc(n)
            assert got == jp.alloc(n)
            assert not set(got) & set(held)  # never handed out twice
            held += got
        elif op == 1 and held:
            pick = [held[i] for i in rng.choice(len(held), min(2, len(held)), replace=False)]
            jp.retain(pick)
            tp.retain(pick)
            held += pick
        elif held:
            k = int(rng.integers(1, min(4, len(held)) + 1))
            assert tp.release(held[:k]) == jp.release(held[:k])
            held = held[k:]
        assert tp.stats() == jp.stats()
        assert tp.live_pages == len(set(held))
        assert tp.free_pages + tp.live_pages == tp.n_pages
        for p in set(held):
            assert tp.refcount(p) == jp.refcount(p) == held.count(p)
    with pytest.raises(RuntimeError, match="not live"):
        tp.release([12])  # never allocated
    with pytest.raises(RuntimeError, match="not live"):
        tp.retain([12])


def test_pool_exhaustion_and_double_release():
    p = TP.PagedBlockPool(4, (100, 20))
    a = p.alloc(3)
    with pytest.raises(TP.PoolExhausted):
        p.alloc(2)
    assert p.free_pages == 1  # a failed alloc takes nothing
    assert p.release(a[:1]) == [a[0]] and p.high_water == 3
    with pytest.raises(RuntimeError, match="not live"):
        p.release(a[:1])
    assert p.live_bytes == 2 * 120 and p.total_bytes == 4 * 120


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("T,H,D,rel", [(8, 2, 16, 0.05), (16, 4, 24, 0.02), (64, 4, 128, 0.05)])
def test_page_nbytes_matches_reference(layout, T, H, D, rel):
    kw = dict(layout=layout, block_size=T, max_seq=8 * T, rel_scale_k=rel, rel_scale_v=3 * rel)
    got = TP.page_nbytes(TC.CacheSpec(**kw), H, D)
    assert got == JP.page_nbytes(JC.CacheSpec(**kw), H, D)
    if layout == "raw":
        assert got == 2 * H * T * D * 2  # K and V bf16 blocks


def test_lookup_slots_matches_reference(rng):
    B, NB, P = 6, 8, 20
    tab = np.stack([rng.permutation(P)[:NB] for _ in range(B)]).astype(np.int32)
    tab[rng.random((B, NB)) < 0.3] = -1
    slots = rng.integers(0, NB + 1, (B, 3)).astype(np.int32)  # NB = no flush
    want = np.asarray(JP.lookup_slots(jnp.asarray(tab), jnp.asarray(slots), NB, P))
    got = TP.lookup_slots(torch.from_numpy(tab), torch.from_numpy(slots), NB, P)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[(slots == NB)] == P).all()


# ---------------------------------------------------------------------------
# Device side: arena state and the Fetch plain version
# ---------------------------------------------------------------------------

_jprefill = jax.jit(JC.prefill, static_argnums=0)
_jappend = jax.jit(JC.append)
_jattend = jax.jit(JC.attend, static_argnames="backend")


def _both_paged(layout, B, Hkv, S, D, T, rng, pages, P, **spec_kw):
    """A dense prefill in both packages, re-housed in a paged arena with
    the same page map."""
    k = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    kw = dict(layout=layout, block_size=T, rel_scale_k=0.02, rel_scale_v=0.05, **spec_kw)
    jd = _jprefill(JC.CacheSpec(**kw), jnp.asarray(k), jnp.asarray(v))
    td = TC.prefill(TC.CacheSpec(**kw), torch.from_numpy(k), torch.from_numpy(v))
    return JP.from_dense(jd, P, pages), TP.from_dense(td, P, pages)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_arena_append_bit_exact(layout, rng):
    """Appends through a shuffled page map: flushes land in the same arena
    pages with the same bits; row 1's unassigned tail entries and the
    fully unassigned row 2 (a retired slot still decoding) drop their
    flushes and leave the arena untouched."""
    B, Hkv, S, D, T = 3, 2, 40, 16, 8
    NB = 128 // T
    P = 40
    pages = np.full((B, NB), -1, np.int32)
    perm = rng.permutation(P)
    pages[0, :8] = perm[:8]       # row 0: room for the prompt + 3 more blocks
    pages[1, :6] = perm[8:14]     # row 1: blocks 6 and up are unassigned
    jc, tc = _both_paged(layout, B, Hkv, S, D, T, rng, pages, P, max_seq=128)
    assert tc.k_store.shape[0] == 1 and tc.k_store.shape[2] == P
    assert_same_state(jc, tc)
    before = {f: getattr(tc, f).clone() for f in TP.STORE_FIELDS}
    for _ in range(3 * T + 2):
        kn = rng.normal(size=(B, Hkv, D)).astype(np.float32)
        vn = rng.normal(size=(B, Hkv, D)).astype(np.float32)
        jc = _jappend(jc, jnp.asarray(kn), jnp.asarray(vn))
        TC.append(tc, torch.from_numpy(kn), torch.from_numpy(vn))
    assert_same_state(jc, tc)
    untouched = np.setdiff1d(np.arange(P), pages[:, 5:8].ravel())
    for f, a in before.items():
        b = getattr(tc, f)
        if b.dim() >= 4:  # pages no flush was meant for are unchanged
            assert torch.equal(a[:, :, untouched], b[:, :, untouched]), f
    q = rng.normal(size=(B, 2 * Hkv, D)).astype(np.float32)
    for backend in ("xla", "fused"):
        want = np.asarray(_jattend(jc, jnp.asarray(q), backend=backend))
        got = TC.attend(tc, torch.from_numpy(q), backend=backend).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0, err_msg=backend)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_arena_ring_reuse_bit_exact(layout, rng):
    """A sliding window wraps its ring by overwriting the slot's page in
    place: no new page, and the arena stays bit-exact against the
    reference through the wrap."""
    T, W = 8, 32
    NB = W // T
    jc, tc = _both_paged(layout, 2, 2, 20, 16, T, rng, None, 2 * NB, max_seq=512, window=W)
    tab = tc.page_tab.clone()
    for _ in range(40):
        kn = rng.normal(size=(2, 2, 16)).astype(np.float32)
        vn = rng.normal(size=(2, 2, 16)).astype(np.float32)
        jc = _jappend(jc, jnp.asarray(kn), jnp.asarray(vn))
        TC.append(tc, torch.from_numpy(kn), torch.from_numpy(vn))
    assert int(tc.n_flushed[0]) > NB  # the ring wrapped
    assert torch.equal(tc.page_tab, tab)
    assert_same_state(jc, tc)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_splice_row_bit_exact(layout, rng):
    """The paged admission splice of a batch-1 dense prefill into row 1 of a
    live arena (``pool.splice_row`` through ``model.insert_decode_row_paged``)
    against the reference's ``splice_row``: the same pages, buffers, lengths
    and page table, bit for bit; the prompt's empty slots (-1) write
    nothing."""
    T, D, NB, P = 8, 16, 8, 24
    kw = dict(layout=layout, block_size=T, max_seq=NB * T, rel_scale_k=0.02,
              rel_scale_v=0.05)
    k = rng.normal(size=(1, 2, 29, D)).astype(np.float32)
    v = rng.normal(size=(1, 2, 29, D)).astype(np.float32)
    jsrc = _jprefill(JC.CacheSpec(**kw), jnp.asarray(k), jnp.asarray(v))
    tsrc = TC.prefill(TC.CacheSpec(**kw), torch.from_numpy(k), torch.from_numpy(v))
    live = np.full((3, NB), -1, np.int32)
    live[0, :2] = [5, 11]
    jdst, tdst = _both_paged(layout, 3, 2, 16, D, T, rng, live, P, max_seq=NB * T)
    pages = np.full(NB, -1, np.int32)
    pages[:3] = [2, 17, 9]  # 29 tokens: 3 full blocks, the rest empty
    jdst = jax.jit(JP.splice_row)(jdst, jsrc, 1, jnp.asarray(pages))
    TM.insert_decode_row_paged({"kv": [tdst]}, {"kv": [tsrc]}, 1, torch.from_numpy(pages))
    assert_same_state(jdst, tdst)


def test_to_dense_round_trip(rng):
    spec = TC.CacheSpec(layout="packed", block_size=8, max_seq=64)
    k = torch.from_numpy(rng.normal(size=(2, 2, 30, 16)).astype(np.float32))
    dense = TC.prefill(spec, k, k)
    pages = torch.from_numpy(rng.permutation(20)[:16].reshape(2, 8).astype(np.int32))
    back = TP.to_dense(TP.from_dense(dense, 20, pages))
    assert not back.spec.paged
    for f in TP.STORE_FIELDS:
        assert torch.equal(getattr(back, f), getattr(dense, f)), f


GRID = [(1, 1, 1, 32, 16, 8), (2, 2, 3, 96, 32, 16), (3, 2, 2, 64, 24, 8),
        (2, 1, 8, 48, 24, 8)]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("B,Hkv,G,S,D,T", GRID)
def test_plain_paged_fetch_matches_reference_kernel(B, Hkv, G, S, D, T, layout, rng):
    """The Fetch wrapper on CPU tensors with a page table (its plain
    version) within 1e-4 of the reference's Pallas kernel in interpret mode
    on the same arena: shuffled pages, and an unassigned entry below a
    row's nb_valid (it must contribute nothing)."""
    spec = dict(layout=layout, block_size=T, max_seq=2 * S, rel_scale_k=0.02,
                rel_scale_v=0.05)
    NB = 2 * S // T
    P = B * NB + 5
    pages = rng.permutation(P)[:B * NB].reshape(B, NB).astype(np.int32)
    pages[0, (S // T) // 2] = -1  # a hole inside row 0's live blocks
    jc, tc = _both_paged(layout, B, Hkv, S, D, T, rng, pages, P, max_seq=2 * S)
    q = rng.normal(size=(B, Hkv * G, D)).astype(np.float32)
    jt, tt = JC.CacheSpec(**spec).impl.tile_decode(JC.CacheSpec(**spec), D), \
        TC.CacheSpec(**spec).impl.tile_decode(TC.CacheSpec(**spec), D)
    nb = np.minimum(np.asarray(jc.n_flushed), NB).astype(np.int32)
    want = JO.fused_cache_attention(
        jnp.asarray(q), jc.k_store, jc.k_min, jc.k_step, jc.v_store, jc.v_min, jc.v_step,
        jc.k_buf, jc.v_buf, jnp.asarray(nb), jc.buf_len, jc.page_tab, tile=jt,
        block_size=T, impl="pallas", interpret=True)
    got = fused_kv_attn.fused_cache_attention(
        torch.from_numpy(q), tc.k_store, tc.k_min, tc.k_step, tc.v_store, tc.v_min,
        tc.v_step, tc.k_buf, tc.v_buf, torch.from_numpy(nb), tc.buf_len, tc.page_tab,
        tile=tt, block_size=T)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    # the hole really is skipped: pointing it at a spare page changes row 0
    tc.page_tab[0, (S // T) // 2] = int(np.setdiff1d(np.arange(P), pages)[0])
    moved = fused_kv_attn.fused_cache_attention(
        torch.from_numpy(q), tc.k_store, tc.k_min, tc.k_step, tc.v_store, tc.v_min,
        tc.v_step, tc.k_buf, tc.v_buf, torch.from_numpy(nb), tc.buf_len, tc.page_tab,
        tile=tt, block_size=T)
    assert not torch.allclose(moved[0], got[0]) and torch.equal(moved[1:], got[1:])


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

LENS = (7, 13, 16, 24, 33)
NEWS = (3, 9, 5, 2, 7)


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(JR.get_smoke_config("yi_6b"), cache_block=8)
    tcfg = dataclasses.replace(TR.get_smoke_config("yi_6b"), cache_block=8)
    jp, _ = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, tcfg.vocab_size, L).astype(np.int32) for L in LENS]
    return jcfg, tcfg, jp, tp, prompts


def _page_bytes(tcfg, max_seq=256):
    return sum(TP.page_nbytes(s, tcfg.n_kv_heads, tcfg.resolved_head_dim)
               for s in TM.cache_specs(tcfg, max_seq))


def _serve(tcfg, tp, prompts, news, watch=None, **scfg):
    kw = dict(max_slots=2, max_seq=256) | scfg
    srv = TS.Server(tcfg, tp, TS.ServerConfig(**kw), device="cpu")
    hs = [srv.submit(TS.Request(prompt=p, max_new_tokens=n)) for p, n in zip(prompts, news)]
    while srv.step():
        if watch is not None:
            watch(srv)
    assert srv.active == 0 and srv.pending == 0 and srv.prefilling == 0
    return [h.result().tokens.tolist() for h in hs], srv


def _solo_greedy(tcfg, tp, prompt, n_new):
    """B=1 chunked prefill, then step-by-step greedy decode, dense."""
    T = tcfg.cache_block
    st = TM.init_decode_state(tcfg, 1, 256, device="cpu")
    for pos in range(0, len(prompt), T):
        lg, _ = TM.prefill_chunk(tp, tcfg, torch.as_tensor(prompt[None, pos:pos + T]), pos, st)
    out = [int(torch.argmax(lg[0]))]
    pos = len(prompt)
    while len(out) < n_new:
        lg, _ = TM.decode_step(tp, tcfg, torch.tensor([out[-1]]), pos, st)
        out.append(int(torch.argmax(lg[0])))
        pos += 1
    return out


def _check_tables(srv):
    """Every layer's device page table mirrors the host's (a PREFILLING row
    stays unassigned on the device until its finishing chunk installs it),
    and no page is held by two (row, slot) entries."""
    want = srv._pt_host.copy()
    want[list(srv._prefill_tasks)] = -1
    for c in srv.state["kv"]:
        np.testing.assert_array_equal(c.page_tab.numpy(), want)
    live = srv._pt_host[srv._pt_host >= 0]
    assert len(live) == len(set(live.tolist())) == srv.pool.live_pages


@pytest.mark.parametrize("layout", LAYOUTS)
def test_paged_server_matches_reference_server(setup, layout):
    """A pool too small for the admitted load: both servers preempt the same
    number of times, and the port's greedy tokens equal the reference's."""
    jcfg, tcfg, jp, tp, _ = setup
    jcfg = dataclasses.replace(jcfg, cache_layout=layout)
    tcfg = dataclasses.replace(tcfg, cache_layout=layout)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, tcfg.vocab_size, 17).astype(np.int32) for _ in range(3)]
    pool_bytes = 5 * _page_bytes(tcfg)
    jsrv = JS.Server(jcfg, jp, JS.ServerConfig(max_slots=3, max_seq=256, cache_mode="paged",
                                               pool_hbm_bytes=pool_bytes),
                     q_chunk=32, kv_chunk=32)
    jh = [jsrv.submit(JS.Request(prompt=p, max_new_tokens=10)) for p in prompts]
    jsrv.run()
    got, srv = _serve(tcfg, tp, prompts, [10] * 3, watch=_check_tables, max_slots=3,
                      cache_mode="paged", pool_hbm_bytes=pool_bytes)
    assert srv.preemptions >= 1, "the workload failed to force a preemption"
    assert srv.preemptions == jsrv.preemptions
    assert got == [h.result().tokens.tolist() for h in jh]
    jst, tst = jsrv.stats()["pool"], srv.stats()["pool"]
    for k in ("pages_total", "high_water_pages", "alloc_pages", "freed_pages", "pages_live"):
        assert tst[k] == jst[k], k
    rep, jrep = srv.memory_report(), jsrv.memory_report()
    assert (rep["layout"], rep["kv_bytes"]) == (layout, jrep["kv_bytes"])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_paged_equals_dense_and_solo(setup, layout):
    """Mixed lengths and budgets through 2 slots: paged (chunked and solo
    admission) == dense == each request's B=1 solo run, and the pool
    drains."""
    _, tcfg, _, tp, prompts = setup
    tcfg = dataclasses.replace(tcfg, cache_layout=layout)
    dense, _ = _serve(tcfg, tp, prompts, NEWS)
    paged, srv = _serve(tcfg, tp, prompts, NEWS, watch=_check_tables, cache_mode="paged")
    solo_adm, _ = _serve(tcfg, tp, prompts, NEWS, cache_mode="paged", prefill_mode="solo",
                         prefill_chunk_tokens=8)
    assert paged == dense == solo_adm
    for p, n, toks in zip(prompts, NEWS, paged):
        assert toks == _solo_greedy(tcfg, tp, p, n)
    st = srv.stats()
    assert st["pool"]["pages_live"] == 0 and st["pool"]["bytes_live"] == 0
    assert st["pool"]["alloc_pages"] == st["pool"]["freed_pages"] > 0


def test_chunk_flushes_land_in_their_pages(setup):
    """Encode-to-page: once a prompt is admitted, its row's pages hold
    exactly the blocks a dense B=1 chunked prefill stores.  A chunk whose
    page was not reserved ahead would drop its flush and leave them empty."""
    _, tcfg, _, tp, prompts = setup
    srv = TS.Server(tcfg, tp, TS.ServerConfig(max_slots=2, max_seq=256, cache_mode="paged",
                                              prefill_chunk_tokens=16), device="cpu")
    srv.submit(TS.Request(prompt=prompts[4], max_new_tokens=4))  # 33 tokens, 4 blocks
    srv.step()
    assert srv.prefilling == 1 and srv.active == 0  # two chunks per step
    srv.step()
    srv.step()
    assert srv.active == 1
    st = TM.init_decode_state(tcfg, 1, 256, device="cpu")
    for pos in range(0, 33, 8):
        TM.prefill_chunk(tp, tcfg, torch.as_tensor(prompts[4][None, pos:pos + 8]), pos, st)
    row = next(r for r, h in enumerate(srv._slots) if h is not None)
    pages = srv._pt_host[row, :4]
    assert (pages >= 0).all() and (srv._pt_host[row, 4:] == -1).all()
    for live, solo in zip(srv.state["kv"], st["kv"]):
        for f in TP.STORE_FIELDS:
            a = getattr(live, f)
            if a.dim() >= 4:
                assert torch.equal(a[0][:, pages], getattr(solo, f)[0][:, :4]), f
        # the tail token, then the first generated one, sit in the buffer
        assert int(live.n_flushed[row]) == 4 and int(live.buf_len[row]) == 2


def test_preempt_half_prefilled_row_resumes(setup):
    """A PREFILLING row loses its pages mid-chunking: an older decoder holds
    part of a pool the long prompt needs, the chunk loop's reclaim preempts
    the younger half-prefilled row itself, and its re-admission still gives
    its solo tokens (DESIGN.md §13)."""
    _, tcfg, _, tp, _ = setup
    rng = np.random.default_rng(23)
    short = rng.integers(0, tcfg.vocab_size, 9).astype(np.int32)
    long = rng.integers(0, tcfg.vocab_size, 40).astype(np.int32)  # 5 blocks
    srv = TS.Server(tcfg, tp, TS.ServerConfig(
        max_slots=2, max_seq=64, cache_mode="paged", prefill_chunk_tokens=8,
        pool_hbm_bytes=5 * _page_bytes(tcfg, 64)), device="cpu")
    h_short = srv.submit(TS.Request(prompt=short, max_new_tokens=16))
    srv.step()  # the short decoder admits first (it is the OLDER row)
    h_long = srv.submit(TS.Request(prompt=long, max_new_tokens=4))
    while srv.step():
        _check_tables(srv)
    assert srv.stats()["prefill"]["prefill_preemptions"] >= 1, \
        "the workload failed to preempt a half-prefilled row"
    assert h_short.result().tokens.tolist() == _solo_greedy(tcfg, tp, short, 16)
    assert h_long.result().tokens.tolist() == _solo_greedy(tcfg, tp, long, 4)
    assert srv.stats()["pool"]["pages_live"] == 0


def test_same_sweep_preemption_drops_stale_grant(setup):
    """A row granted a page early in a page-fault sweep can be preempted
    later in the same sweep (a younger zero-page row picks the youngest page
    HOLDER).  Its grant must not re-point its cleared device row at a page
    re-issued to the other row."""
    _, tcfg, _, tp, _ = setup
    rng = np.random.default_rng(17)
    pa = rng.integers(0, tcfg.vocab_size, 14).astype(np.int32)  # 1 prefill page
    pb = rng.integers(0, tcfg.vocab_size, 6).astype(np.int32)   # none
    got, srv = _serve(tcfg, tp, [pa, pb], [6, 6], watch=_check_tables, cache_mode="paged",
                      pool_hbm_bytes=2 * _page_bytes(tcfg))
    assert srv.preemptions >= 1, "the workload failed to force the same-sweep case"
    assert got == [_solo_greedy(tcfg, tp, pa, 6), _solo_greedy(tcfg, tp, pb, 6)]


def test_streaming_capacity_and_stats(setup):
    """Oversubscription: at a byte budget of two dense rings, paged admission
    runs >= 1.5x the concurrent requests; a stream survives preemption; the
    stats and metric names are the reference's; an oversize request is
    refused at submit."""
    _, tcfg, _, tp, _ = setup
    page_b = _page_bytes(tcfg)
    nb = TM.cache_spec(tcfg, 256).n_blocks
    rng = np.random.default_rng(5)
    reqs = [TS.Request(prompt=rng.integers(0, tcfg.vocab_size, 17).astype(np.int32),
                       max_new_tokens=8) for _ in range(8)]
    srv = TS.Server(tcfg, tp, TS.ServerConfig(max_slots=8, max_seq=256, cache_mode="paged",
                                              pool_hbm_bytes=2 * nb * page_b), device="cpu")
    hs = [srv.submit(r) for r in reqs]
    peak = 0
    while srv.step():
        peak = max(peak, srv.active)
    assert peak >= 1.5 * 2, peak
    for r, h in zip(reqs[:2], hs[:2]):
        assert h.result().tokens.tolist() == _solo_greedy(tcfg, tp, r.prompt, 8)

    tight = TS.Server(tcfg, tp, TS.ServerConfig(max_slots=3, max_seq=256, cache_mode="paged",
                                                pool_hbm_bytes=5 * page_b), device="cpu")
    hs = [tight.submit(r) for r in reqs[:3]]
    streamed = [list(h.tokens()) for h in hs]
    assert tight.preemptions >= 1
    assert all(s == h.result().tokens.tolist() and len(s) == 8 for s, h in zip(streamed, hs))
    st = tight.stats()
    assert st["cache_mode"] == "paged" and st["preemptions"] == tight.preemptions
    assert st["pool"]["per_shard"] == [{k: v for k, v in st["pool"].items() if k != "per_shard"}]
    assert st["shards"]["per_shard"][0]["preemptions"] == tight.preemptions
    snap = tight.metrics.snapshot()
    assert snap["pool"]["shard0"]["high_water_pages"] == st["pool"]["high_water_pages"]
    assert snap["serve"]["preemptions"] == tight.preemptions
    with pytest.raises(ValueError, match="pool"):
        tight.submit(TS.Request(prompt=np.zeros(64, np.int32), max_new_tokens=32))
    tight.submit(TS.Request(prompt=np.zeros(33, np.int32), max_new_tokens=7))  # 39 -> 4 pages
    dense = TS.Server(tcfg, tp, TS.ServerConfig(max_slots=2, max_seq=256), device="cpu")
    assert dense.stats()["cache_mode"] == "dense" and "pool" not in dense.stats()
