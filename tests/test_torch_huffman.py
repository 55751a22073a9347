"""The port's huffman layout (``repro_torch.core.huffman``, ``HuffmanLayout``
and the plain versions of the huffman kernels) against the reference on the
CPU, with seeded numpy inputs fed to both packages:

* codebooks (lengths, codewords, decode tree, LUT, probes) equal the
  reference's, for the layout's default books and for skewed histograms that
  force length limiting and 2-probe decodes;
* ``encode_block_torch`` words and bit counts are bit-exact against
  ``encode_block_jax``, words with bit 31 set included;
* the LUT and walk decodes equal the reference's codes, zero-bit and
  truncated streams included;
* the plain ``huffman_decode`` / ``huffman_attn_scores`` match the reference's
  oracles and its Pallas kernels in interpret mode, and the slot LUT decode
  matches ``HuffmanLayout._decode``;
* the plain Fetch on huffman tiles is within 1e-5 of the reference's kernel,
  and bit-identical to the plain Fetch on packed tiles of the same data;
* the port's dense ``Server`` with ``cache_layout="huffman"`` gives the
  reference ``Server``'s greedy tokens.

Store state against the compiled reference is in tests/test_torch_cache.py
and tests/test_torch_pool.py (their layout grids include huffman).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import cache as JC  # noqa: E402
from repro.core import huffman as JH  # noqa: E402
from repro.core import layouts as JL  # noqa: E402
from repro.kernels import ops as JO  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro.kernels.huffman_decode import (huffman_attn_scores_pallas,  # noqa: E402
                                          huffman_decode_pallas)
from repro.models import model as JM  # noqa: E402
from repro.models import registry as JReg  # noqa: E402
from repro.serve import scheduler as JS  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import cache as TC  # noqa: E402
from repro_torch.core import huffman as TH  # noqa: E402
from repro_torch.core import layouts as TL  # noqa: E402
from repro_torch.kernels import fused_kv_attn, ops  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402
from repro_torch.models import registry as TReg  # noqa: E402
from repro_torch.serve import scheduler as TS  # noqa: E402


def _codes(rng, skew, shape):
    return np.clip(np.round(rng.normal(8, skew, size=shape)), 0, 255).astype(np.uint8)


def _skewed_hist():
    """Counts spanning 12 decades over 40 symbols: unlimited Huffman codes
    would exceed 16 bits, so the limiter runs, and the longest code needs 2
    LUT probes."""
    hist = np.zeros(256, np.int64)
    hist[:40] = np.logspace(0, 12, 40).astype(np.int64)
    return hist


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).astype(np.uint32)).view(np.int32))


def _books():
    """(reference book, port book) pairs: the default books of the layout's
    code ranges, data-fitted books of three skews, and the skewed book."""
    rng = np.random.default_rng(5)
    hists = [_skewed_hist()]
    hists += [np.bincount(_codes(rng, s, (4096,)), minlength=256) for s in (0.7, 3.0, 30.0)]
    pairs = [(JL.default_codebook(n), TL.default_codebook(n)) for n in (2, 8, 21, 51, 256)]
    return pairs + [(JH.build_codebook(h), TH.build_codebook(h)) for h in hists]


BOOKS = _books()
SKEWED = BOOKS[5]


@pytest.mark.parametrize("i", range(len(BOOKS)))
def test_codebooks_match_reference(i):
    jb, tb = BOOKS[i]
    for f in ("lengths", "codes_msb", "codes_lsb", "children", "is_symbol", "symbols"):
        np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f), err_msg=f)
    np.testing.assert_array_equal(tb.decode_lut(), jb.decode_lut())
    assert tb.decode_probes == jb.decode_probes
    for a, b in zip(tb.as_device_tables(), jb.as_device_tables()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert torch.equal(tb.device_lut("cpu"), torch.from_numpy(jb.decode_lut()))
    assert tb.device_lut("cpu") is tb.device_lut(torch.device("cpu"))  # one copy a device


def test_skewed_book_needs_two_probes():
    jb, tb = SKEWED
    assert tb.lengths.max() > 8 and tb.decode_probes == 2 == jb.decode_probes
    assert tb.lengths.max() <= TH.MAX_CODE_LEN


@pytest.mark.parametrize("seed", range(4))
def test_encode_block_bit_exact(seed):
    """Batched ``encode_block_torch`` against ``encode_block_jax`` block by
    block: words (bit 31 set in some), bit counts and totals; a capacity too
    small drops the words past it as the reference does."""
    rng = np.random.default_rng(seed)
    skew = (0.7, 3.0, 12.0, 30.0)[seed]
    codes = _codes(rng, skew, (3, 6, 20))
    jb = JH.build_codebook(np.bincount(codes.reshape(-1), minlength=256))
    tb = TH.build_codebook(np.bincount(codes.reshape(-1), minlength=256))
    cl, ln = jb.as_encode_tables()
    high = 0
    for cap in (6 * 20 * 16 // 32 + 2, 5):
        tw, tn, tt = TH.encode_block_torch(torch.from_numpy(codes), *tb.encode_tables("cpu"), cap)
        for n in range(3):
            jw, jn, jt = JH.encode_block_jax(jnp.asarray(codes[n]), cl, ln, cap)
            np.testing.assert_array_equal(_u32(tw[n]), np.asarray(jw))
            np.testing.assert_array_equal(tn[n].numpy(), np.asarray(jn))
            assert int(tt[n]) == int(jt)
        high += int((_u32(tw) >= 2**31).sum())
    assert high > 0  # words with bit 31 set were compared
    w_np, nb_np = JH.encode_block(codes[0], jb)  # and the numpy oracle
    np.testing.assert_array_equal(
        _u32(TH.encode_block_torch(torch.from_numpy(codes[0]), *tb.encode_tables("cpu"),
                                   len(w_np))[0]), w_np)


def test_words_with_bit_31_set_encode_and_decode():
    """A payload whose every word has bit 31 set: the int32 bit patterns
    encode and decode (walk and LUT) exactly as the reference's u32 words."""
    hist = np.zeros(256, np.int64)
    hist[:2] = [1, 1]
    jb, tb = JH.build_codebook(hist), TH.build_codebook(hist)  # 1-bit codes
    codes = np.ones((4, 32), np.uint8)  # all-ones streams
    tw, tn, _ = TH.encode_block_torch(torch.from_numpy(codes), *tb.encode_tables("cpu"), 5)
    assert (_u32(tw[:4]) == 0xFFFFFFFF).all()
    ch = tb.as_device_tables()
    walk = TH.decode_block_torch(tw, tn, *ch, 32, int(tn.sum()))
    lut = TH.decode_block_lut_torch(tw, tn, tb.device_lut("cpu"), 32, tb.decode_probes)
    assert (walk.numpy() == codes).all() and (lut.numpy() == codes).all()
    jwalk = JH.decode_block_jax(jnp.asarray(_u32(tw)), jnp.asarray(tn.numpy().astype(np.uint16)),
                                *jb.as_device_tables(), 32, int(tn.sum()))
    np.testing.assert_array_equal(walk.numpy(), np.asarray(jwalk))


@pytest.mark.parametrize("seed", range(4))
def test_walk_and_lut_decode_match_reference(seed):
    """The walk and the LUT decode of the port equal the reference's codes,
    with a zero-bit stream in the middle and a truncated last stream, for
    1- and 2-probe books (seed 3 uses the skewed book)."""
    rng = np.random.default_rng(seed)
    S, L = int(rng.integers(2, 10)), int(rng.integers(2, 24))
    if seed == 3:
        jb, tb = SKEWED
        p = _skewed_hist()[:40] / _skewed_hist()[:40].sum()
        codes = rng.choice(40, size=(S, L), p=p).astype(np.uint8)
        codes[0, :3] = [0, 1, 2]  # the rarest symbols: the longest codes
    else:
        codes = _codes(rng, float(rng.uniform(0.5, 30.0)), (S, L))
        h = np.bincount(codes.reshape(-1), minlength=256)
        jb, tb = JH.build_codebook(h), TH.build_codebook(h)
    w, nb = JH.encode_block(codes, jb)
    nb = np.insert(nb, S // 2, 0).astype(np.uint16)
    nb[-1] = nb[-1] // 2
    pay = np.concatenate([w, np.zeros(2, np.uint32)])
    jw = np.asarray(JH.decode_block_jax(jnp.asarray(pay), jnp.asarray(nb), *jb.as_device_tables(),
                                        L, int(nb.max())))
    jl = np.asarray(JH.decode_block_lut_jax(jnp.asarray(pay), jnp.asarray(nb),
                                            jnp.asarray(jb.decode_lut()), L, jb.decode_probes))
    tpay, tnb = _i32(pay), torch.from_numpy(nb.astype(np.int32))
    tw = TH.decode_block_torch(tpay, tnb, *tb.as_device_tables(), L, int(nb.max()))
    tl = TH.decode_block_lut_torch(tpay, tnb, tb.device_lut("cpu"), L, tb.decode_probes)
    np.testing.assert_array_equal(tw.numpy(), jw)
    np.testing.assert_array_equal(tl.numpy(), jl)
    assert (tl.numpy()[S // 2] == 0).all()
    np.testing.assert_array_equal(tw.numpy()[:S // 2], codes[:S // 2])


def _encode_blocks(rng, NBLK, S, L):
    """tests/test_kernels.py's helper: blocks encoded with the numpy oracle
    under one fitted book, payloads zero-padded to a common width."""
    codes = _codes(rng, 3.0, (NBLK, S, L))
    book = JH.build_codebook(np.bincount(codes.reshape(-1), minlength=256))
    payloads, nbits = zip(*(JH.encode_block(codes[n], book) for n in range(NBLK)))
    pay = np.zeros((NBLK, max(len(w) for w in payloads)), np.uint32)
    for n, w in enumerate(payloads):
        pay[n, :len(w)] = w
    return codes, book, pay, np.stack(nbits)


@pytest.mark.parametrize("NBLK,S,L", [(1, 4, 8), (3, 8, 16), (2, 16, 12)])
def test_plain_huffman_decode_matches_pallas_kernel(NBLK, S, L, rng):
    """The port's ``huffman_decode`` on CPU tensors (its plain version)
    equals the reference's Pallas kernel in interpret mode and its oracle."""
    codes, jb, pay, nbits = _encode_blocks(rng, NBLK, S, L)
    tb = TH.build_codebook(np.bincount(codes.reshape(-1), minlength=256))
    maxbits = int(nbits.sum(axis=1).max())
    want = np.asarray(huffman_decode_pallas(jnp.asarray(pay), jnp.asarray(nbits),
                                            *jb.as_device_tables(), L, maxbits, interpret=True))
    got = ops.huffman_decode(_i32(pay), torch.from_numpy(nbits.astype(np.int32)),
                             *tb.as_device_tables(), L, maxbits)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), codes)
    for n in range(NBLK):
        ref = JR.huffman_decode_ref(jnp.asarray(pay[n]), jnp.asarray(nbits[n]),
                                    *jb.as_device_tables(), L, maxbits)
        np.testing.assert_array_equal(
            TR.huffman_decode_ref(_i32(pay[n]), torch.from_numpy(nbits[n].astype(np.int32)),
                                  *tb.as_device_tables(), L, maxbits).numpy(), np.asarray(ref))


def test_plain_huffman_scores_match_pallas_kernel(rng):
    """``huffman_attn_scores`` (plain) within 1e-5 of the reference's Pallas
    kernel in interpret mode and of its oracle, scale 0.25."""
    NBLK, S, D = 2, 8, 16
    codes, jb, pay, nbits = _encode_blocks(rng, NBLK, S, D)
    tb = TH.build_codebook(np.bincount(codes.reshape(-1), minlength=256))
    maxbits = int(nbits.sum(axis=1).max())
    kmn = rng.normal(size=(NBLK, D)).astype(np.float32)
    kst = (0.05 * rng.uniform(1, 2, (NBLK, D))).astype(np.float32)
    q = rng.normal(size=(D,)).astype(np.float32)
    want = np.asarray(huffman_attn_scores_pallas(
        jnp.asarray(pay), jnp.asarray(nbits), *jb.as_device_tables(), jnp.asarray(kmn),
        jnp.asarray(kst), jnp.asarray(q), maxbits, scale=0.25, interpret=True))
    tn = torch.from_numpy(nbits.astype(np.int32))
    got = ops.huffman_attn_scores(_i32(pay), tn, *tb.as_device_tables(), torch.from_numpy(kmn),
                                  torch.from_numpy(kst), torch.from_numpy(q), maxbits, scale=0.25)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    for n in range(NBLK):
        ref = JR.huffman_attn_scores_ref(jnp.asarray(pay[n]), jnp.asarray(nbits[n]),
                                         *jb.as_device_tables(), jnp.asarray(kmn[n]),
                                         jnp.asarray(kst[n]), jnp.asarray(q), maxbits)
        mine = TR.huffman_attn_scores_ref(_i32(pay[n]), tn[n], *tb.as_device_tables(),
                                          torch.from_numpy(kmn[n]), torch.from_numpy(kst[n]),
                                          torch.from_numpy(q), maxbits)
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_slot_encode_and_lut_decode_match_reference_layout(rng):
    """``HuffmanLayout._encode`` / ``_decode`` and the slot LUT decode's
    plain version against the reference layout's on the same codes: slots
    bit-exact (u16 header included), codes equal and lossless."""
    T, D = 16, 24
    kw = dict(layout="huffman", block_size=T, max_seq=8 * T, rel_scale_k=0.02,
              rel_scale_v=0.06)
    js, ts = JC.CacheSpec(**kw), TC.CacheSpec(**kw)
    jl, tl = js.impl, ts.impl
    for jbook, tbook in ((jl.book_k(js), tl.book_k(ts)), (jl.book_v(js), tl.book_v(ts))):
        n_codes = int((tbook.lengths > 0).sum())
        codes = rng.integers(0, n_codes, (2, 2, 3, T, D)).astype(np.uint8)
        jslots = np.asarray(jl._encode(js, jnp.asarray(codes), jbook))
        tslots = tl._encode(ts, torch.from_numpy(codes), tbook)
        np.testing.assert_array_equal(_u32(tslots), jslots)
        want = np.asarray(jl._decode(js, jnp.asarray(jslots), D, jbook))
        got = tl._decode(ts, tslots, D, tbook)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), codes)
    nb = torch.from_numpy(rng.integers(0, 2**16, (3, 7)).astype(np.int32))
    hdr = TL.pack_u16_pairs(nb)
    for r in range(3):
        np.testing.assert_array_equal(
            _u32(hdr[r]), np.asarray(JL._pack_u16_pairs(jnp.asarray(nb[r].numpy().astype(np.uint16)))))
    assert torch.equal(TL.unpack_u16_pairs(hdr, 7), nb)


def test_layout_sizes_match_reference():
    """Slot words, bytes a token and the prior books at Yi-6B width and at
    the smoke width."""
    for T, D in ((64, 128), (8, 16)):
        js = JC.CacheSpec(layout="huffman", block_size=T, max_seq=16 * T)
        ts = TC.CacheSpec(layout="huffman", block_size=T, max_seq=16 * T)
        for jbook, tbook in ((js.impl.book_k(js), ts.impl.book_k(ts)),
                             (js.impl.book_v(js), ts.impl.book_v(ts))):
            assert ts.impl._slot_words(ts, D, tbook) == js.impl._slot_words(js, D, jbook)
        assert ts.impl.bytes_per_token(ts, 4, D) == js.impl.bytes_per_token(js, 4, D)
    tile = ts.impl.tile_decode(ts, 16)
    assert tile.kind == "huffman" and tile.k_tile == (sum(ts.impl._slot_words(
        ts, 16, ts.impl.book_k(ts))),)
    other = dataclasses.replace(tile, book_k=None, book_v=None)
    assert other == tile and hash(other) == hash(tile)  # the books stay out of == and hash


def test_plain_fetch_matches_reference_kernel_and_packed(rng):
    """The Fetch wrapper on CPU tensors with huffman tiles: within 1e-5 of
    the reference's Pallas kernel (interpret mode) on the same store, and
    bit-identical to the plain Fetch on the packed tiles of the same data
    (the same codes and scales)."""
    B, Hkv, G, S, D, T = 2, 1, 8, 48, 24, 8
    k = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    q = rng.normal(size=(B, Hkv * G, D)).astype(np.float32)
    js = JC.CacheSpec(layout="huffman", block_size=T, max_seq=2 * S)
    ts = TC.CacheSpec(layout="huffman", block_size=T, max_seq=2 * S)
    jc = jax.jit(JC.prefill, static_argnums=0)(js, jnp.asarray(k), jnp.asarray(v))
    tc = TC.prefill(ts, torch.from_numpy(k), torch.from_numpy(v))
    nb = jnp.minimum(jc.n_flushed, js.n_blocks)
    want = JO.fused_cache_attention(
        jnp.asarray(q), jc.k_store, jc.k_min, jc.k_step, jc.v_store, jc.v_min, jc.v_step,
        jc.k_buf, jc.v_buf, nb, jc.buf_len, tile=js.impl.tile_decode(js, D), block_size=T,
        impl="pallas", interpret=True)
    got = ops.cache_decode_attention(tc, torch.from_numpy(q))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    ps = TC.CacheSpec(layout="packed", block_size=T, max_seq=2 * S)
    pc = TC.prefill(ps, torch.from_numpy(k), torch.from_numpy(v))
    for f in ("k_min", "k_step", "v_min", "v_step", "k_buf", "v_buf"):
        assert torch.equal(getattr(pc, f), getattr(tc, f)), f
    assert torch.equal(ops.cache_decode_attention(pc, torch.from_numpy(q)), got)
    args = (tc.k_store, tc.k_min, tc.k_step, tc.v_store, tc.v_min, tc.v_step, tc.k_buf,
            tc.v_buf, torch.clamp(tc.n_flushed, max=ts.n_blocks), tc.buf_len)
    plain = fused_kv_attn.plain(torch.from_numpy(q), *args, tile=ts.impl.tile_decode(ts, D),
                                block_size=T)
    assert torch.equal(plain, got)


def test_server_matches_reference_server_huffman():
    """Dense, ``cache_layout="huffman"``: 3 requests through 2 slots (one
    joins mid-flight) on both servers give the same greedy tokens; the
    memory report names the layout and holds the reference's bytes."""
    jcfg = dataclasses.replace(JReg.get_smoke_config("yi_6b"), cache_layout="huffman")
    tcfg = dataclasses.replace(TReg.get_smoke_config("yi_6b"), cache_layout="huffman")
    jp, _ = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, tcfg.vocab_size, 17).astype(np.int32) for _ in range(3)]
    jsrv = JS.Server(jcfg, jp, JS.ServerConfig(max_slots=2, max_seq=256), q_chunk=32,
                     kv_chunk=32)
    jh = [jsrv.submit(JS.Request(prompt=p, max_new_tokens=10)) for p in prompts]
    jsrv.run()
    srv = TS.Server(tcfg, tp, TS.ServerConfig(max_slots=2, max_seq=256), device="cpu")
    th = [srv.submit(TS.Request(prompt=p, max_new_tokens=10)) for p in prompts]
    srv.run()
    assert [h.result().tokens.tolist() for h in th] == [h.result().tokens.tolist() for h in jh]
    rep, jrep = srv.memory_report(), jsrv.memory_report()
    assert rep["layout"] == "huffman" and rep["kv_bytes"] == jrep["kv_bytes"]
