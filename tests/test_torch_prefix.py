"""The port's prefix cache (``repro_torch.serve.prefix`` and the Server's
prefix mode; DESIGN.md §11), held against the reference on the CPU:

* ``PrefixIndex``: refcounts, block-aligned exact lookup, LRU leaf
  eviction with ``protect``; a random sequence of lookup / insert / evict
  gives the reference index's pages and stats;
* ``pool.gather_pages`` / ``model.gather_prefix_state`` bit-exact against
  the reference, and a chunked prefill resumed from them equals one from
  token 0;
* the paged ``Server`` with the prefix on gives the reference ``Server``'s
  greedy tokens, prefix stats and pool counters (packed and huffman), and
  its preemptions and resumes from parked pages under a tight pool;
* the port's own contracts: on == noshare == off, chunked == solo, a flush
  never lands on a shared page (sliding-window copy-on-write), and a full
  pool whose pages only the index holds admits after eviction.

One reference run per configuration, shared through module fixtures.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; intra-op threads only oversubscribe them
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import cache as JC  # noqa: E402
from repro.core import pool as JP  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.serve import prefix as JX  # noqa: E402
from repro.serve import scheduler as JS  # noqa: E402
from repro_torch.core import cache as TC  # noqa: E402
from repro_torch.core import pool as TP  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.serve import prefix as TX  # noqa: E402
from repro_torch.serve import scheduler as TS  # noqa: E402
import test_torch_shared as cached  # noqa: E402


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


# ---------------------------------------------------------------------------
# PrefixIndex
# ---------------------------------------------------------------------------


def test_refcount_lifecycle_basics():
    p = TP.PagedBlockPool(4, (64,))
    a = p.alloc(2)
    assert all(p.refcount(x) == 1 for x in a)
    p.retain(a)
    assert all(p.refcount(x) == 2 for x in a)
    assert p.release(a) == []          # still referenced: nothing freed
    assert p.free_pages == 2
    assert sorted(p.release(a)) == sorted(a)
    assert p.free_pages == 4
    with pytest.raises(RuntimeError, match="not live"):
        p.release(a[:1])
    assert p.refcount(a[0]) == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_refcount_no_reissue_while_referenced(seed):
    """A random interleaving of alloc / retain / release against a shadow
    model of the counts: a referenced page is never handed out again, and a
    page rejoins the free list only at zero."""
    rng = np.random.default_rng(seed)
    p = TP.PagedBlockPool(8, (32,))
    refs: dict[int, int] = {}
    for _ in range(400):
        kind, n = int(rng.integers(0, 3)), int(rng.integers(0, 6))
        live = sorted(refs)
        if kind == 0:
            if n <= p.free_pages:
                got = p.alloc(n)
                assert not set(got) & set(live)
                refs.update((g, 1) for g in got)
            else:
                with pytest.raises(TP.PoolExhausted):
                    p.alloc(n)
        elif kind == 1 and live:
            take = live[:max(n, 1)]
            p.retain(take)
            for t in take:
                refs[t] += 1
        elif kind == 2 and live:
            take = live[:max(n, 1)]
            freed, want = p.release(take), []
            for t in take:
                refs[t] -= 1
                if refs[t] == 0:
                    del refs[t]
                    want.append(t)
            assert sorted(freed) == sorted(want)
        assert {x: p.refcount(x) for x in refs} == refs
        assert p.free_pages == p.n_pages - len(refs)
        assert p.stats()["refs_total"] == sum(refs.values())
        assert p.stats()["pages_shared"] == sum(v > 1 for v in refs.values())


def test_prefix_index_block_aligned_exact_lookup():
    p = TP.PagedBlockPool(16, (16,))
    idx = TX.PrefixIndex(block_size=4)
    toks = np.arange(12, dtype=np.int32)
    pages = p.alloc(3)
    assert idx.insert(toks, pages, p) == 3
    assert all(p.refcount(g) == 2 for g in pages)
    assert idx.lookup(toks, 3) == pages
    assert idx.lookup(toks, 2) == pages[:2]
    assert idx.lookup(toks[:8], 3) == pages[:2]
    assert idx.lookup(toks[:7], 3) == pages[:1]      # a partial block is ignored
    div = toks.copy()
    div[5] = 99
    assert idx.lookup(div, 3) == pages[:1]
    assert idx.lookup(np.arange(100, 112, dtype=np.int32), 3) == []
    other = p.alloc(3)
    assert idx.insert(toks, other, p) == 0           # the first writer's pages stay
    assert idx.lookup(toks, 3) == pages
    assert sorted(idx.indexed_pages()) == sorted(pages) and idx.n_blocks == 3


def test_prefix_index_lru_leaf_eviction_and_protect():
    p = TP.PagedBlockPool(8, (16,))
    idx = TX.PrefixIndex(block_size=4)
    a = np.arange(8, dtype=np.int32)
    b = np.concatenate([a[:4], np.arange(50, 54, dtype=np.int32)])
    pa, pb = p.alloc(2), p.alloc(2)
    idx.insert(a, pa, p)
    idx.insert(b, pb, p)
    p.release(pa), p.release(pb)  # only the index holds them now
    assert p.free_pages == 8 - 3  # a shared root block and two leaves
    idx.lookup(a, 2)              # chain a is hot: b's leaf is the coldest
    assert idx.evict(p, need_free=6) >= 1
    assert p.free_pages >= 6
    assert idx.lookup(a, 2) == pa
    assert idx.lookup(b, 2) == pa[:1]
    idx.evict(p, need_free=8, protect=pa)
    assert p.refcount(pa[0]) >= 1 and p.refcount(pa[1]) >= 1
    assert idx.lookup(a, 2) == pa
    assert idx.stats()["evicted_blocks"] == 1
    assert TX.PrefixIndex.merge_stats([idx, idx])["blocks"] == 2 * idx.n_blocks
    assert TX.PrefixIndex.merge_stats([]) == {"blocks": 0, "inserted_blocks": 0,
                                              "evicted_blocks": 0}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_index_op_sequences_match_reference(seed):
    """The same random lookup / insert / evict sequence through the port's
    index and pool and the reference's: the same pages, return values and
    stats at every step."""
    rng = np.random.default_rng(seed)
    T = 4
    bases = [rng.integers(0, 5, 6 * T).astype(np.int32) for _ in range(3)]
    jp, tp = JP.PagedBlockPool(24, (16,)), TP.PagedBlockPool(24, (16,))
    ji, ti = JX.PrefixIndex(T), TX.PrefixIndex(T)
    held: list[list[int]] = []   # the rows' own references
    for _ in range(200):
        toks = bases[int(rng.integers(0, 3))].copy()
        toks[int(rng.integers(0, len(toks)))] = int(rng.integers(0, 5))
        op = int(rng.integers(0, 4))
        if op == 0:
            n = int(rng.integers(1, 6))
            assert ti.lookup(toks, n) == ji.lookup(toks, n)
        elif op == 1:
            n = int(rng.integers(1, 6))
            if n > tp.free_pages:
                continue
            pages = tp.alloc(n)
            assert pages == jp.alloc(n)
            assert ti.insert(toks, pages, tp) == ji.insert(toks, pages, jp)
            held.append(pages)
        elif op == 2 and held:
            pages = held.pop(int(rng.integers(0, len(held))))
            assert tp.release(pages) == jp.release(pages)
        else:
            need = int(rng.integers(0, 25))
            live = sorted(tp._live)
            protect = [x for x in live if rng.random() < 0.3]
            assert ti.evict(tp, need, protect) == ji.evict(jp, need, protect)
        assert ti.stats() == ji.stats()
        assert sorted(ti.indexed_pages()) == sorted(ji.indexed_pages())
        assert tp.stats() == jp.stats()
    assert ti.stats()["inserted_blocks"] > 0 and ti.stats()["evicted_blocks"] > 0


# ---------------------------------------------------------------------------
# gather_pages / gather_prefix_state
# ---------------------------------------------------------------------------

_jprefill = jax.jit(JC.prefill, static_argnums=0)


def _both_paged(layout, B, Hkv, S, D, T, rng, pages, P):
    """A dense prefill in both packages, re-housed in a paged arena."""
    k = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    kw = dict(layout=layout, block_size=T, rel_scale_k=0.02, rel_scale_v=0.05,
              max_seq=8 * T)
    jd = _jprefill(JC.CacheSpec(**kw), jnp.asarray(k), jnp.asarray(v))
    td = TC.prefill(TC.CacheSpec(**kw), torch.from_numpy(k), torch.from_numpy(v))
    return JP.from_dense(jd, P, pages), TP.from_dense(td, P, pages)


@pytest.mark.parametrize("layout", ["raw", "packed", "kivi", "huffman"])
def test_gather_pages_bit_exact(layout, rng):
    T, D, NB, P = 8, 16, 8, 24
    tab = rng.permutation(P)[:2 * NB].reshape(2, NB).astype(np.int32)
    jc, tc = _both_paged(layout, 2, 2, 45, D, T, rng, tab, P)
    seed = np.full(NB, -1, np.int32)
    seed[:4] = tab[1, :4]
    for n in (0, 3, 4):
        want = JP.gather_pages(jc, jnp.asarray(seed), n)
        got = TP.gather_pages(tc, torch.from_numpy(seed), n)
        assert not got.spec.paged and got.batch == 1
        for f in TC.LayerKVCache.FIELDS:
            a, b = bits_of(getattr(want, f)), bits_of(getattr(got, f))
            assert a.shape == b.shape, (f, a.shape, b.shape)
            np.testing.assert_array_equal(b, a, err_msg=f)
    # a two-layer state through the model-level entry point
    jst = JM.gather_prefix_state({"kv": (jc, jc)}, jnp.asarray(seed), 4)
    tst = TM.gather_prefix_state({"kv": [tc, tc]}, torch.from_numpy(seed), 4)
    for jl, tl in zip(jst["kv"], tst["kv"]):
        for f in TC.LayerKVCache.FIELDS:
            np.testing.assert_array_equal(bits_of(getattr(tl, f)), bits_of(getattr(jl, f)))


# ---------------------------------------------------------------------------
# Serving
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
    return jcfg, tcfg, jp, tp


def _page_bytes(tcfg, max_seq=256):
    return sum(TP.page_nbytes(s, tcfg.n_kv_heads, tcfg.resolved_head_dim)
               for s in TM.cache_specs(tcfg, max_seq))


def _requests(cfg, seed, n_shared, tails, new):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, cfg.vocab_size, n_shared).astype(np.int32)
    return [(np.concatenate([shared, rng.integers(0, cfg.vocab_size, L).astype(np.int32)]),
             new) for L in tails]


def _ref(jcfg, jp, reqs, **kw):
    srv = JS.Server(jcfg, jp, JS.ServerConfig(**({"max_slots": 2, "max_seq": 256} | kw)),
                    q_chunk=32, kv_chunk=32)
    hs = [srv.submit(JS.Request(prompt=p, max_new_tokens=n)) for p, n in reqs]
    srv.run()
    return [h.result().tokens.tolist() for h in hs], srv


def _port(tcfg, tp, reqs, server=TS.Server, watch=None, **kw):
    srv = server(tcfg, tp, TS.ServerConfig(**({"max_slots": 2, "max_seq": 256} | kw)),
                 device="cpu")
    hs = [srv.submit(TS.Request(prompt=p, max_new_tokens=n)) for p, n in reqs]
    while srv.step():
        if watch is not None:
            watch(srv)
    assert srv.active == srv.pending == srv.prefilling == 0
    return [h.result().tokens.tolist() for h in hs], srv


def _check_drained(srv):
    """After a drain only the index holds pages, one reference each."""
    n_index = srv.index.n_blocks if srv.index is not None else 0
    assert srv.pool.live_pages == n_index
    assert all(c == 1 for c in srv.pool._ref.values())
    assert (srv._pt_host == -1).all()


def _same_stats(jsrv, tsrv):
    js, ts = jsrv.stats(), tsrv.stats()
    assert ts["prefix"] == js["prefix"]
    assert ts["pool"] == js["pool"]
    assert ts["prefill"] == js["prefill"]
    assert ts["lifecycle"] == js["lifecycle"]
    assert ts["preemptions"] == js["preemptions"]


@pytest.fixture(scope="module")
def reuse(setup):
    """Three requests sharing a 3-block prefix; the reference runs once a
    layout (prefix on), once a test process."""
    return _reuse()


@functools.lru_cache(maxsize=None)
def _reuse():
    jcfg, tcfg, jp, _ = _setup()
    reqs = _requests(tcfg, 3, 24, (1, 2, 3), 6)
    out = {}
    for layout in ("packed", "huffman"):
        out[layout] = _ref(dataclasses.replace(jcfg, cache_layout=layout), jp, reqs,
                           cache_mode="paged", prefix_cache="on")
    return reqs, out


@pytest.mark.parametrize("layout", ["packed", "huffman"])
def test_prefix_on_matches_reference_server(setup, reuse, layout):
    """Real reuse, the reference's tokens, prefix stats and pool counters;
    inside the port on == noshare == off, and the pools drain to the
    index's pages."""
    _, tcfg, _, tp = setup
    tcfg = dataclasses.replace(tcfg, cache_layout=layout)
    reqs, ref = reuse
    want, jsrv = ref[layout]
    got, srv = _port(tcfg, tp, reqs, cache_mode="paged", prefix_cache="on")
    assert got == want
    _same_stats(jsrv, srv)
    px = srv.stats()["prefix"]
    assert px["hits"] >= 2 and px["reused_tokens"] >= 2 * 24
    _check_drained(srv)
    ns, nsrv = _port(tcfg, tp, reqs, cache_mode="paged", prefix_cache="noshare")
    off, osrv = _port(tcfg, tp, reqs, cache_mode="paged")
    assert ns == off == got
    nx = nsrv.stats()["prefix"]
    assert nx["prefill_tokens"] - px["prefill_tokens"] == px["reused_tokens"]
    assert "prefix" not in osrv.stats()
    _check_drained(nsrv)
    _check_drained(osrv)


def test_preempt_resumes_from_parked_pages(setup):
    """A pool too small for the load preempts; the victim's prompt blocks
    park in the index and re-admission splices them back.  Tokens,
    preemptions, resumes and reused blocks equal the reference's, and the
    tokens equal the ample pool's."""
    jcfg, tcfg, jp, tp = setup
    reqs = _requests(tcfg, 11, 24, (1, 2), 24)
    kw = dict(cache_mode="paged", prefix_cache="on", pool_hbm_bytes=6 * _page_bytes(tcfg))
    want, jsrv = _ref(jcfg, jp, reqs, **kw)
    got, srv = _port(tcfg, tp, reqs, **kw)
    assert srv.preemptions >= 1, "the workload failed to force a preemption"
    px = srv.stats()["prefix"]
    assert px["resumes"] >= 1 and px["resume_reused_blocks"] >= 1
    assert got == want
    _same_stats(jsrv, srv)
    _check_drained(srv)
    ample, _ = _port(tcfg, tp, reqs, cache_mode="paged", prefix_cache="on")
    assert got == ample


@pytest.mark.parametrize("share", ["on", "noshare"])
def test_chunked_equals_solo_with_prefix(setup, share):
    """Interleaved chunked admission over the index (hits spliced into a
    task mid-flight) gives the blocking solo drain's tokens, and the
    reference's."""
    jcfg, tcfg, jp, tp = setup
    reqs = _requests(tcfg, 17, 16, (3, 4, 5), 5)
    outs = {}
    for mode in ("chunked", "solo"):
        outs[mode], srv = _port(tcfg, tp, reqs, cache_mode="paged", prefix_cache=share,
                                prefill_mode=mode, prefill_chunk_tokens=8)
        if share == "on":
            assert srv.stats()["prefix"]["hits"] >= 1, mode
        _check_drained(srv)
    assert outs["chunked"] == outs["solo"]
    want, _ = _ref(jcfg, jp, reqs, cache_mode="paged", prefix_cache=share,
                   prefill_chunk_tokens=8)
    assert outs["chunked"] == want


class _CowAuditServer(TS.Server):
    """Asserts after every page-fault sweep that each row flushing on the
    next step writes a page it holds alone: a page shared with the index or
    another row is never a row's writable tail."""

    audited = 0

    def _ensure_pages(self):
        super()._ensure_pages()
        T, nb = self._spec0.block_size, self._spec0.n_blocks
        for row, h in enumerate(self._slots):
            if h is None or (int(self._pos[row]) + 1) % T:
                continue
            slot = ((int(self._pos[row]) + 1) // T - 1) % nb
            page = int(self._pt_host[row, slot])
            assert page >= 0, "flush target unassigned after the sweep"
            assert self.pool.refcount(page) == 1, f"row {row} would flush into shared page {page}"
            type(self).audited += 1


def test_cow_never_writes_a_shared_page(setup):
    """A sliding-window ring wraps onto its spliced (shared) prompt pages:
    every flush lands on a page of refcount 1 (copy on write), and the
    tokens equal noshare's."""
    _, tcfg, _, tp = setup
    tcfg = dataclasses.replace(tcfg, sliding_window=16)
    prompt = np.random.default_rng(5).integers(0, tcfg.vocab_size, 16).astype(np.int32)
    reqs = [(prompt, 20), (prompt, 20)]
    _CowAuditServer.audited = 0
    on, srv = _port(tcfg, tp, reqs, server=_CowAuditServer, cache_mode="paged",
                    prefix_cache="on")
    assert _CowAuditServer.audited > 0, "no flush was audited"
    assert srv.stats()["prefix"]["cow_breaks"] >= 1, "the ring never wrapped onto a shared page"
    assert on[0] == on[1]
    ns, _ = _port(tcfg, tp, reqs, cache_mode="paged", prefix_cache="noshare")
    assert ns == on
    _check_drained(srv)


def test_full_pool_held_by_the_index_admits(setup):
    """A retired request leaves its prompt blocks in the index until they
    fill the pool; the next request, sharing nothing, admits and runs by
    evicting them (no row holds a page, so the reclaim ladder must not look
    for a victim first), with the reference's tokens and stats."""
    jcfg, tcfg, jp, tp = setup
    rng = np.random.default_rng(23)
    first = rng.integers(0, tcfg.vocab_size, 41).astype(np.int32)   # 5 blocks
    second = rng.integers(0, tcfg.vocab_size, 20).astype(np.int32)
    kw = dict(cache_mode="paged", prefix_cache="on", prefill_chunk_tokens=8,
              pool_hbm_bytes=5 * _page_bytes(tcfg))
    srv = TS.Server(tcfg, tp, TS.ServerConfig(max_slots=2, max_seq=256, **kw), device="cpu")
    a = srv.submit(TS.Request(prompt=first, max_new_tokens=2)).result()
    assert srv.pool.free_pages == 0 and srv.index.n_blocks == 5
    b = srv.submit(TS.Request(prompt=second, max_new_tokens=12)).result()
    srv.run()
    st = srv.stats()
    assert st["prefix"]["index"]["evicted_blocks"] >= 3 and st["preemptions"] == 0
    _check_drained(srv)
    jsrv = JS.Server(jcfg, jp, JS.ServerConfig(max_slots=2, max_seq=256, **kw),
                     q_chunk=32, kv_chunk=32)
    ja = jsrv.submit(JS.Request(prompt=first, max_new_tokens=2)).result()
    jb = jsrv.submit(JS.Request(prompt=second, max_new_tokens=12)).result()
    assert (a.tokens.tolist(), b.tokens.tolist()) == (ja.tokens.tolist(), jb.tokens.tolist())
    _same_stats(jsrv, srv)


def test_prefix_mode_requires_paged(setup):
    _, tcfg, _, tp = setup
    with pytest.raises(ValueError, match="paged"):
        TS.Server(tcfg, tp, TS.ServerConfig(max_slots=2, max_seq=256, prefix_cache="on"),
                  device="cpu")
    with pytest.raises(ValueError, match="prefix_cache"):
        TS.Server(tcfg, tp, TS.ServerConfig(max_slots=2, max_seq=256, cache_mode="paged",
                                            prefix_cache="sometimes"), device="cpu")


def test_gathered_prefix_resumes_like_a_full_prefill(setup):
    """Chunk a prompt's first 3 blocks into arena pages, gather them as a
    batch-1 dense state and chunk the rest there: the logits equal a chunked
    prefill from token 0 on a private state, bit for bit."""
    _, tcfg, _, tp = setup
    T = tcfg.cache_block
    prompt = torch.as_tensor(np.random.default_rng(9).integers(0, tcfg.vocab_size, 29)[None])
    solo = TM.init_decode_state(tcfg, 1, 256, device="cpu")
    for pos in range(0, 29, T):
        want, _ = TM.prefill_chunk(tp, tcfg, prompt[:, pos:pos + T], pos, solo)
    paged = TM.init_decode_state(dataclasses.replace(tcfg, cache_mode="paged"), 2, 256,
                                 device="cpu", pool_pages=12)
    pages = torch.full((256 // T,), -1, dtype=torch.int32)
    pages[:3] = torch.tensor([7, 2, 10], dtype=torch.int32)
    for pos in range(0, 3 * T, T):
        view = TM.chunk_state_view(paged, pages, pos)
        TM.prefill_chunk(tp, tcfg, prompt[:, pos:pos + T], pos, view)
    seeded = TM.gather_prefix_state(paged, pages, 3)
    for pos in range(3 * T, 29, T):
        got, _ = TM.prefill_chunk(tp, tcfg, prompt[:, pos:pos + T], pos, seeded)
    assert torch.equal(got, want)
