"""The walk kernels (``csrc/huffman_decode.cu`` ``huffman_decode_kernel`` and
``huffman_attn_scores_kernel``) as they compute, emulated on the CPU in
numpy and held against the tree walk:

* the root table each CTA builds from the tree tables (``build_root_table``)
  against an independent tree walk of every peek;
* the probe loop (``walk_decode_stream``: table probes, the bit-a-step walk
  where a peek holds no return to the root, the budget and the clamp to the
  last payload word) bit-exact (tolerance 0: the codes are integers) against
  ``walk_decode_jax`` through ``jax.jit`` and ``walk_decode_torch``;
* the folded score arithmetic (``row_score``: factors kmn * q and kst * q a
  block, four running sums a row) within SCORES_ATOL of
  ``huffman_attn_scores_ref``.

The cases are ``chip_smoke.walk_edge_cases`` (phase 11 runs the same on the
card): the layout's default K and V books, a skewed book with codes past the
peek, a one-symbol book, tables with a child rewired to the root; a zero-bit
stream, max_bits below nbits, budgets past the payload, random words, S of
1, 40 and 64, more symbols than L.  Inputs come from seeded numpy
generators.
"""

import functools
import re
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import huffman as JH  # noqa: E402
from repro_torch.kernels import huffman_decode  # noqa: E402
from repro_torch.kernels.ref import huffman_attn_scores_ref  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

SOURCE = (ROOT / "src" / "repro_torch" / "csrc" / "huffman_decode.cu").read_text()


def _const(name: str) -> int:
    m = re.search(rf"constexpr (?:int|uint32_t) {name} = (\w+);", SOURCE)
    assert m, name
    return int(m.group(1), 0)


PEEK, SYMS = _const("kPeekBits"), _const("kPeekSymbols")
LEAF, CHILD = 1 << 18, 0x1FF


@functools.lru_cache(maxsize=None)
def _cases():
    return chip_smoke.walk_edge_cases("cpu")


CASES = [x["name"] for x in _cases()]


def _case(name):
    return next(x for x in _cases() if x["name"] == name)


def _u32(t) -> np.ndarray:
    return np.asarray(t).astype(np.int64).astype(np.uint32)


def _nodes(tables) -> np.ndarray:
    """The kernel's node records: child 0 and child 1 (clamped to the last
    node), the leaf flag, the symbol's low 8 bits."""
    ch, isym, sym = (np.asarray(t).astype(np.int64) for t in tables)
    top = len(isym) - 1
    c = np.where(ch < 0, top, np.minimum(ch, top))
    return (c[:, 0] | c[:, 1] << 9 | (isym != 0) * LEAF | (sym & 0xFF) << 24).astype(np.int64)


def _root_table(nodes: np.ndarray):
    """``build_root_table``: every entry's walk, step by step with selects."""
    c = np.arange(1 << PEEK)
    rec = np.full(c.shape, nodes[0])
    idx, syms, meta, cnt, used = (np.zeros(c.shape, np.int64) for _ in range(5))
    for b in range(PEEK):
        nxt = (rec >> (9 * ((c >> b) & 1))) & CHILD
        r = nodes[nxt]
        live = cnt < SYMS
        leaf = live & ((r & LEAF) != 0)
        syms |= np.where(leaf, (r >> 24) << (8 * cnt), 0)
        meta |= np.where(leaf, (b + 1) << (4 + 4 * cnt), 0)
        used = np.where(live & (leaf | (nxt == 0)), b + 1, used)
        idx = np.where(live, np.where(leaf, 0, nxt), idx)
        rec = np.where(live, np.where(leaf, nodes[0], r), rec)
        cnt += leaf
    return (np.where(used > 0, syms, idx), np.where(used > 0, cnt | meta | used << 20, 0))


def _walk_peek(ch, isym, sym, c: int):
    """An independent tree walk of peek c on the tables as given: the first
    SYMS leaves (symbol, end bit), the bits up to the last return to the
    root, and the node reached."""
    out, idx, used = [], 0, 0
    for b in range(PEEK):
        idx = int(ch[idx, (c >> b) & 1])
        if isym[idx]:
            out.append((int(sym[idx]) & 0xFF, b + 1))
            idx, used = 0, b + 1
            if len(out) == SYMS:
                break
        elif idx == 0:
            used = b + 1
    return out, used, idx


def _decode_stream(words, pos, end, tab_x, tab_y, nodes, L):
    """``walk_decode_stream`` for one stream: its codes [L]."""
    last = len(words) - 1
    row = np.zeros(L + SYMS, np.uint8)  # the row's room past L, as the kernel's stride gives

    def peek(p):
        w = p >> 5
        lo, hi = int(words[min(w, last)]), int(words[min(w + 1, last)])
        return ((lo | hi << 32) >> (p & 31)) & ((1 << PEEK) - 1)

    col = 0
    while pos < end and col < L:
        e = peek(pos)
        x, y = int(tab_x[e]), int(tab_y[e])
        adv = y >> 20
        if adv == 0:
            if end - pos <= PEEK:
                break
            idx, p = x, pos + PEEK
            while p < end:
                bit = (int(words[min(p >> 5, last)]) >> (p & 31)) & 1
                idx = (int(nodes[idx]) >> (9 * bit)) & CHILD
                p += 1
                if nodes[idx] & LEAF:
                    row[col] = int(nodes[idx]) >> 24
                    col += 1
                    break
                if idx == 0:
                    break
            pos = p
            continue
        for k in range(y & 7):
            row[col + k] = 0 if pos + ((y >> (4 + 4 * k)) & 15) > end else (x >> (8 * k)) & 0xFF
        col += y & 7
        pos += adv
    return row[:L]


@functools.lru_cache(maxsize=None)
def _emulated(name: str) -> np.ndarray:
    """The kernel's codes for a case, emulated: uint8 [NBLK, S, L]."""
    x = _case(name)
    nodes = _nodes(x["tables"])
    tab_x, tab_y = _root_table(nodes)
    payload, nbits = _u32(x["payload"]), np.asarray(x["nbits"]).astype(np.int64)
    starts = np.cumsum(nbits, -1) - nbits
    out = np.zeros((*nbits.shape, x["L"]), np.uint8)
    for blk in range(nbits.shape[0]):
        for s in range(nbits.shape[1]):
            pos = int(starts[blk, s])
            out[blk, s] = _decode_stream(payload[blk], pos, pos + min(int(nbits[blk, s]),
                                                                        x["max_bits"]),
                                         tab_x, tab_y, nodes, x["L"])
    return out


BOOK_CASES = ["K book, S=64, a zero-bit stream", "V book, S=40", "skewed book, codes to 16 bits",
              "K tables, a child rewired to the root", "one-symbol book, random words"]


@pytest.mark.parametrize("name", BOOK_CASES)
def test_root_table_entries_match_a_tree_walk(name):
    """Every entry of the root table holds the whole codewords of its peek
    (at most SYMS, each with the bits through it), the bits up to the last
    return to the root, or, where there is none, the node the walk reached."""
    tables = _case(name)["tables"]
    ch, isym, sym = (np.asarray(t) for t in tables)
    tab_x, tab_y = _root_table(_nodes(tables))
    fallback = 0
    for c in range(1 << PEEK):
        out, used, idx = _walk_peek(ch, isym, sym, c)
        x, y = int(tab_x[c]), int(tab_y[c])
        if used == 0:
            assert (x, y) == (idx, 0), c
            fallback += 1
            continue
        assert y >> 20 == used and y & 7 == len(out), c
        for k, (s, end) in enumerate(out):
            assert (x >> (8 * k)) & 0xFF == s and (y >> (4 + 4 * k)) & 15 == end, c
    # only the skewed book's codes run past the peek with no return to the root
    assert (fallback > 0) == (name == "skewed book, codes to 16 bits")


def _jax_walk(x) -> np.ndarray:
    ch, isym, sym = (jnp.asarray(np.asarray(t)) for t in x["tables"])
    walk = jax.jit(jax.vmap(lambda p, n: JH.walk_decode_jax(p, n, ch, isym, sym, x["L"],
                                                            x["max_bits"])))
    return np.asarray(walk(jnp.asarray(_u32(x["payload"])),
                           jnp.asarray(np.asarray(x["nbits"]).astype(np.uint16))))


@pytest.mark.parametrize("name", CASES)
def test_probe_loop_matches_the_tree_walk(name):
    """The emulated kernel's codes equal the reference's jitted walk and the
    port's plain walk (the CPU path of the ``huffman_decode`` wrapper)."""
    x = _case(name)
    got = _emulated(name)
    np.testing.assert_array_equal(got, _jax_walk(x).astype(np.uint8))
    plain = huffman_decode.huffman_decode(x["payload"], x["nbits"], *x["tables"], x["L"],
                                          x["max_bits"])
    np.testing.assert_array_equal(got, plain.numpy())


@pytest.mark.parametrize("name", CASES)
def test_folded_scores_match_the_reference(name):
    """``row_score`` on the emulated codes: a term fma(c, kst*q, kmn*q) a
    column (factors zero past L), a running float32 sum for each column mod
    4, then ((s0 + s1) + (s2 + s3)) times the scale: within SCORES_ATOL of
    the reference's dequant and product."""
    x = _case(name)
    L = x["L"]
    L4 = -(-L // 4) * 4
    f32 = np.float32
    codes = np.zeros((*x["nbits"].shape, L4))
    codes[..., :L] = _emulated(name)
    kmn, kst, q = (np.asarray(x[k]) for k in ("kmn", "kst", "q"))
    kq, g = np.zeros((len(kmn), L4), f32), np.zeros((len(kmn), L4), f32)
    kq[:, :L], g[:, :L] = kmn * q, kst * q
    # one rounding, as an fma: c * g is exact in float64 (8 by 24 bits)
    terms = (codes * g[:, None, :] + kq[:, None, :]).astype(f32)
    acc = np.zeros((*codes.shape[:2], 4), f32)
    for d in range(L4):
        acc[..., d % 4] += terms[..., d]
    got = ((acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])) * f32(x["scale"])
    want = huffman_attn_scores_ref(x["payload"], x["nbits"], *x["tables"], x["kmn"], x["kst"],
                                   x["q"], x["max_bits"]).numpy() * x["scale"]
    assert np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= chip_smoke.SCORES_ATOL
