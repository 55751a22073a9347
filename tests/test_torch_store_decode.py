"""The slot LUT decode and the Store as the redesigned kernels compute them,
on the CPU, bit-exact (tolerance 0: the codes and words are integers):

* the joint K+V slot decode's plain path equals two single calls and the
  reference's ``HuffmanLayout._decode`` (through ``jax.jit``), for the
  layout's default books and for a skewed book that needs 2 LUT probes;
* the multi-symbol table (``huffman.build_multi_lut``) against a tree walk
  of every peek, and a numpy emulation of the kernel's probe loop
  (``huffman.cuh`` ``multi_decode_stream``) against ``decode_block_lut_torch``
  and ``decode_block_lut_jax``, on random and edge streams (an empty stream,
  a budget that cuts a codeword, budgets past the payload so reads clamp to
  the last word, words with bit 31 set);
* the Store's work split (the kernel's ``split_at`` and index walk,
  emulated): every word written once, every unit's scales once, every
  unit reduced over its whole tile.

Inputs come from seeded numpy generators.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; intra-op threads only oversubscribe them
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import cache as JC  # noqa: E402
from repro.core import huffman as JH  # noqa: E402
from repro_torch.core import bitpack  # noqa: E402
from repro_torch.core import cache as TC  # noqa: E402
from repro_torch.core import huffman as TH  # noqa: E402
from repro_torch.core import layouts as TL  # noqa: E402
from repro_torch.kernels import huffman_decode, pack_encode  # noqa: E402

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


def _kernel_const(name: str, file: str = "pack_encode.cu") -> int:
    """A compile-time constant of a kernel source, as the emulations use it."""
    m = re.search(rf"constexpr int {name} = (\d+);", (CSRC / file).read_text())
    assert m, name
    return int(m.group(1))


def _work_split(n: int) -> list[tuple[int, int]]:
    """pack_encode.cu ``split_at``: CTA z of a block's kSplit takes items
    ``[n * z // kSplit, n * (z + 1) // kSplit)`` of its n words or units."""
    split = _kernel_const("kSplit")
    return [(n * z // split, n * (z + 1) // split) for z in range(split)]


def _hist(decades: float, n: int = 21) -> np.ndarray:
    h = np.zeros(TH.N_SYMBOLS, np.int64)
    h[:n] = np.logspace(0, decades, n)[::-1].astype(np.int64)
    return h


def _u32(t) -> np.ndarray:
    return (np.asarray(t).astype(np.int64) & 0xFFFFFFFF).astype(np.uint32)


# --- the joint K+V slot decode ------------------------------------------------


@pytest.mark.parametrize("books", ["default", "skewed"])
def test_joint_slot_decode_plain_matches_single_calls_and_reference(books, rng):
    """``huffman_lut_decode_kv`` on CPU tensors returns the two single
    calls' codes, which equal the reference layout's jitted ``_decode`` on
    the same slots and the codes that were encoded."""
    T, D = 16, 24
    kw = dict(layout="huffman", block_size=T, max_seq=8 * T)
    js, ts = JC.CacheSpec(**kw), TC.CacheSpec(**kw)
    if books == "default":
        pairs = [(js.impl.book_k(js), ts.impl.book_k(ts)), (js.impl.book_v(js), ts.impl.book_v(ts))]
    else:  # 2 LUT probes a symbol, too long for the multi-symbol table
        h = _hist(9)
        pairs = [(JH.build_codebook(h), TH.build_codebook(h))] * 2
        assert pairs[0][1].decode_probes == 2 and TH.build_multi_lut(pairs[0][1]) is None
    args, jwant, codes = [], [], []
    for jbook, tbook in pairs:
        n = int((tbook.lengths > 0).sum())
        c = rng.integers(0, n, (2, 3, 4, T, D)).astype(np.uint8)
        slots = ts.impl._encode(ts, torch.from_numpy(c), tbook)
        jslots = jnp.asarray(_u32(slots))
        jwant.append(np.asarray(jax.jit(lambda s, b=jbook: js.impl._decode(js, s, D, b))(jslots)))
        args.append(ts.impl._slot_args(ts, slots, D, tbook))
        codes.append(c)
    joint = huffman_decode.huffman_lut_decode_kv(*args, block_size=T, head_dim=D)
    for a, got, want, c in zip(args, joint, jwant, codes):
        single = huffman_decode.huffman_lut_decode(a[0], a[1], block_size=T, head_dim=D,
                                                   hdr_words=a[3], probes=a[4], multi=a[2])
        assert torch.equal(got, single)
        np.testing.assert_array_equal(got.numpy().reshape(c.shape), want)
        np.testing.assert_array_equal(got.numpy().reshape(c.shape), c)


def test_decode_span_is_the_joint_decode(rng):
    """The huffman layout's ``decode_span`` gives its two ``_decode`` calls'
    codes (one joint launch on the card)."""
    T, D = 8, 16
    spec = TC.CacheSpec(layout="huffman", block_size=T, max_seq=8 * T)
    c = TC.init_layer_cache(spec, 2, 2, D, device="cpu")
    kb, vb = (torch.from_numpy(rng.normal(size=(2, 2, 8, T, D)).astype(np.float32))
              for _ in range(2))
    spec.impl.write_blocks(spec, c, torch.arange(8)[None].expand(2, 8), kb, vb)
    kc, _, _, vc, _, _ = spec.impl.decode_span(spec, c, 2, 4)
    assert torch.equal(kc, spec.impl._decode(spec, c.k_store[:, :, 2:6], D,
                                             spec.impl.book_k(spec)).float())
    assert torch.equal(vc, spec.impl._decode(spec, c.v_store[:, :, 2:6], D,
                                             spec.impl.book_v(spec)).float())


# --- the multi-symbol table ----------------------------------------------------


def _walk_peek(book, chunk: int):
    """Symbols and end bits of the whole codewords in the peek's bits
    (LSB-first), from the root, at most MULTI_MAX_SYMBOLS: a tree walk."""
    out, idx = [], 0
    for b in range(TH.MULTI_PEEK_BITS):
        idx = int(book.children[idx, (chunk >> b) & 1])
        if book.is_symbol[idx]:
            out.append((int(book.symbols[idx]), b + 1))
            idx = 0
            if len(out) == TH.MULTI_MAX_SYMBOLS:
                break
    return out


@pytest.mark.parametrize("n_codes,decades", [(21, None), (8, None), (2, None), (21, 3)])
def test_multi_lut_entries_match_a_tree_walk(n_codes, decades):
    """Every entry lists the whole codewords its 12 bits hold (1 to 4), each
    with the bits consumed through it, and the bits consumed in all."""
    book = (TL.default_codebook(n_codes) if decades is None
            else TH.build_codebook(_hist(decades, n_codes)))
    tab = TH.build_multi_lut(book)
    assert tab is not None and tab.shape == (1 << TH.MULTI_PEEK_BITS, 2)
    sym_w, meta = tab[:, 0].view(np.uint32), tab[:, 1].view(np.uint32)
    for chunk in range(1 << TH.MULTI_PEEK_BITS):
        want = _walk_peek(book, chunk)
        cnt = int(meta[chunk] & 7)
        assert 1 <= cnt == len(want)
        got = [(int(sym_w[chunk] >> (8 * k)) & 0xFF, int(meta[chunk] >> (4 + 4 * k)) & 15)
               for k in range(cnt)]
        assert got == want
        assert int(meta[chunk] >> 20) == want[-1][1]
        assert all(int(sym_w[chunk] >> (8 * k)) & 0xFF == 0 for k in range(cnt, 4))


def test_multi_lut_only_for_books_that_fit():
    """No table where a code is longer than the peek, or where the tree is
    not complete (one symbol)."""
    assert TH.build_multi_lut(TH.build_codebook(_hist(9))) is None  # codes of 16 bits
    one = np.zeros(TH.N_SYMBOLS, np.int64)
    one[5] = 10
    assert TH.build_multi_lut(TH.build_codebook(one)) is None
    assert TL.default_codebook(21).device_multi_lut("cpu").shape == (2 << TH.MULTI_PEEK_BITS,)


def _multi_decode_emulated(payload, nbits, tab, n):
    """huffman.cuh ``multi_decode_stream`` for every stream of a block, in
    numpy: a window of two payload words (reads clamp to the last word),
    a 12-bit peek by funnel shift, every codeword of the entry emitted with
    the budget test, and the window moved on by the bits consumed."""
    pay = payload.astype(np.int64) & 0xFFFFFFFF
    last = len(pay) - 1
    nb = nbits.astype(np.int64)
    starts = np.cumsum(nb) - nb
    sym_w = tab[:, 0].view(np.uint32).astype(np.int64)
    meta = tab[:, 1].view(np.uint32).astype(np.int64)
    out = np.zeros((len(nb), n), np.uint8)
    for s in range(len(nb)):
        pos, end = int(starts[s]), int(starts[s] + nb[s])
        w, b = pos >> 5, pos & 31
        lo, hi, nx = pay[min(w, last)], pay[min(w + 1, last)], pay[min(w + 2, last)]
        j = 0
        while j < n:
            e = ((lo | (hi << 32)) >> b) & ((1 << TH.MULTI_PEEK_BITS) - 1)
            for k in range(int(meta[e] & 7)):
                if j + k < n:
                    through = pos + ((int(meta[e]) >> (4 + 4 * k)) & 15)
                    out[s, j + k] = (int(sym_w[e]) >> (8 * k)) & 0xFF if through <= end else 0
            j += int(meta[e] & 7)
            adv = int(meta[e]) >> 20
            pos += adv
            cross = b + adv >= 32
            b = (b + adv) & 31
            if cross:
                lo, hi, w = hi, nx, w + 1
            nx = pay[min(w + 2, last)]
    return out


@pytest.mark.parametrize("book_name", ["K", "V", "mid"])
@pytest.mark.parametrize("seed", range(3))
def test_multi_probe_loop_matches_lut_decodes(book_name, seed):
    """The emulated probe loop gives ``decode_block_lut_torch``'s and
    ``decode_block_lut_jax``'s codes on random streams and on edge streams."""
    rng = np.random.default_rng(seed)
    tb = {"K": TL.default_codebook(21), "V": TL.default_codebook(8),
          "mid": TH.build_codebook(_hist(3))}[book_name]  # mid: 2 LUT probes, 11-bit codes
    jb = JH.CodeBook(**{f: getattr(tb, f) for f in (
        "lengths", "codes_msb", "codes_lsb", "children", "is_symbol", "symbols")})
    S, L = 12, 24
    n = int((tb.lengths > 0).sum())
    codes = rng.integers(0, n, (S, L)).astype(np.uint8)
    codes[3, :6] = np.argmax(tb.lengths)  # longest codes
    w, nb = JH.encode_block(codes, jb)
    pay = np.concatenate([w, rng.integers(0, 2**32, 2, dtype=np.uint64).astype(np.uint32)])
    pay[-1] |= np.uint32(1 << 31)
    nb = nb.astype(np.int64)
    nb[1] = 0                          # an empty stream
    nb[4] = max(1, nb[4] - 2)          # the budget cuts the last codeword
    nb[-1] += 40 + 32 * len(pay)       # a budget past the payload: clamped reads
    tab = TH.build_multi_lut(tb)
    got = _multi_decode_emulated(pay, nb, tab, L)
    tpay = torch.from_numpy(pay.view(np.int32).copy())
    tnb = torch.from_numpy(nb.astype(np.int32))
    want = TH.decode_block_lut_torch(tpay, tnb, tb.device_lut("cpu"), L, tb.decode_probes)
    jwant = JH.decode_block_lut_jax(jnp.asarray(pay), jnp.asarray(nb.astype(np.uint16)),
                                    jnp.asarray(jb.decode_lut()), L, jb.decode_probes)
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(got, np.asarray(jwant))
    assert (got[1] == 0).all()
    np.testing.assert_array_equal(got[0], codes[0])


# --- the Store's work split ---------------------------------------------------


def _div_small(x, d):
    """device.cuh ``div_small`` in float32: x / d from the rounded reciprocal,
    put right by two tests."""
    q = np.trunc(np.float32(x) * (np.float32(1) / np.float32(d))).astype(np.int64)
    q -= q * d > x
    q += (q + 1) * d <= x
    return q


def test_div_small_is_integer_division():
    x = np.arange(1 << 16, dtype=np.int64)
    for d in (1, 3, 8, 16, 24, 64, 96, 128, 512):
        np.testing.assert_array_equal(_div_small(x, d), x // d)
    x = np.random.default_rng(0).integers(0, 1 << 22, 20000)
    for d in (7, 24, 128, 513):
        np.testing.assert_array_equal(_div_small(x, d), x // d)


@pytest.mark.parametrize("T,D,elem", [(64, 128, 2), (64, 128, 4), (8, 24, 2), (16, 16, 4),
                                      (8, 64, 2)])
@pytest.mark.parametrize("bits", [1, 3, 5, 7, 8])
def test_store_work_split(T, D, elem, bits):
    """The kernel's split of a block among its CTAs, emulated: every word
    once, with the (token, channel) of each code it packs; every unit's
    scales once; every unit reduced over its whole tile (V: the token's
    16-byte vectors; K: the channel in every token, over the slices)."""
    threads, slices = _kernel_const("kThreads"), _kernel_const("kSlicesK")
    cpw = 32 // bits
    W, U = (T * D + cpw - 1) // cpw, {"K": D, "V": T}
    written = np.zeros(W, np.int64)
    adv = threads * cpw
    for z, (w_lo, w_hi) in enumerate(_work_split(W)):
        for tid in range(threads):
            i0 = (w_lo + tid) * cpw
            t = int(_div_small(i0, D))
            d = i0 - t * D
            for w in range(w_lo + tid, w_hi, threads):
                written[w] += 1
                ct, cd = t, d
                for k in range(min(cpw, T * D - w * cpw)):
                    assert (ct, cd) == divmod(w * cpw + k, D)
                    cd += 1
                    if cd == D:
                        cd, ct = 0, ct + 1
                t, d = t + adv // D, d + adv % D
                if d >= D:
                    d, t = d - D, t + 1
    assert (written == 1).all()
    for n in U.values():
        owner = np.zeros(n, np.int64)
        for lo, hi in _work_split(n):
            owner[lo:hi] += 1
        assert (owner == 1).all()
    # V: a token's partials are its RV vectors, which cover its D values.
    kvec, RV = 16 // elem, D * elem // 16
    seen = np.zeros((T, D), np.int64)
    for t in range(T):
        for v in range(t * RV, (t + 1) * RV):
            e = v * kvec + np.arange(kvec)
            seen[e // D, e % D] += (e // D == t)
    assert (seen == 1).all()
    # K: thread (slice, c) takes vector c of tokens slice, slice + 8, ...; a
    # channel's partials over the slices cover every token once.
    assert slices * RV <= threads
    seen[:] = 0
    for tid in range(threads):
        sl = int(_div_small(tid, RV))
        c = tid - sl * RV
        if sl < slices:
            for t in range(sl, T, slices):
                seen[t, c * kvec:(c + 1) * kvec] += 1
    assert (seen == 1).all()


def test_store_plain_words_are_the_nostraddle_pack(rng):
    """The yardstick the kernel is held to: ``pack_encode_plain`` writes
    ``quant_block_minmax``'s codes packed without straddling, bf16 scales,
    and leaves dropped rows alone."""
    T, D = 16, 24
    spec = TC.CacheSpec(layout="packed", block_size=T, max_seq=4 * T)
    c = TC.init_layer_cache(spec, 2, 2, D, device="cpu")
    kb, vb = (torch.from_numpy(rng.normal(size=(2, 2, 1, T, D)).astype(np.float32))
              for _ in range(2))
    slots = torch.tensor([[1], [spec.n_blocks]], dtype=torch.int32)
    pack_encode.pack_encode_plain(kb, vb, slots, c.k_store, c.k_min, c.k_step, c.v_store,
                                  c.v_min, c.v_step, bits_k=spec.bits_k, bits_v=spec.bits_v,
                                  rel_scale_k=spec.rel_scale_k, rel_scale_v=spec.rel_scale_v,
                                  kivi=False)
    codes, _, _ = TL.quant_block_minmax(kb[0], spec.rel_scale_k, spec.bits_k, (-2,), False)
    assert torch.equal(c.k_store[0, :, 1],
                       bitpack.pack_nostraddle(codes.reshape(2, T * D), spec.bits_k))
    assert not c.k_store[1].any() and not c.v_store[1].any()
