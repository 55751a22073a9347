"""Canonical Huffman coding of quantization codes (the port of
``repro.core.huffman``; paper §3.1.2, §3.3.1).

* Host side, numpy, copied from the reference: ``build_codebook`` (canonical,
  deterministic, length-limited to ``MAX_CODE_LEN`` bits), the ``CodeBook``
  with its array-based decode tree, the chunked direct-lookup table
  ``build_decode_lut``, and the numpy oracles ``encode_block`` /
  ``decode_block``.
* Device side, plain PyTorch, batched over any leading dims:
  ``encode_block_torch`` (every symbol's bit offset from an exclusive cumsum
  of code lengths, then the low and high word contributions), the paper's
  branchless tree walk ``walk_decode_torch`` / ``decode_block_torch``, and
  the chunked LUT decode ``decode_block_lut_torch`` (at most 2 probes a
  symbol).  These are the plain versions of the CUDA kernels in
  ``csrc/huffman_decode.cu`` and of the Fetch kernel's huffman tile decode.

Bit order: LSB-first within little-endian u32 words (global bit position p
lives at word ``p >> 5``, bit ``p & 31``).  Words are int32 tensors holding
the bit patterns of the reference's u32 words; every shift here widens them
to int64 and masks to 32 bits first, so bit 31 never shifts in sign bits.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np
import torch

from repro_torch.core.bitpack import to_int32_bits

N_SYMBOLS = 256
MAX_CODE_LEN = 16
# Stream bits consumed per LUT probe of the chunked direct-lookup decoder.
LUT_CHUNK_BITS = 8
# Stream bits one probe of the slot decode kernel's multi-symbol table
# peeks, and the most codewords an entry holds (build_multi_lut).
MULTI_PEEK_BITS = 12
MULTI_MAX_SYMBOLS = 4
MAX_NODES = 2 * N_SYMBOLS  # decode tables are padded to this many nodes

_U32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Codebook construction (host side, once per layer)
# ---------------------------------------------------------------------------


def _huffman_lengths(hist: np.ndarray) -> np.ndarray:
    """Code lengths from a histogram via the classic heap algorithm.

    Deterministic: ties broken by a monotone sequence id.  Symbols with zero
    count get length 0 (absent from the code).
    """
    hist = np.asarray(hist, dtype=np.int64)
    present = np.nonzero(hist > 0)[0]
    lengths = np.zeros(N_SYMBOLS, dtype=np.int32)
    if len(present) == 0:
        return lengths
    if len(present) == 1:
        lengths[present[0]] = 1
        return lengths
    # Heap of (count, uid, tree); tree is either a leaf symbol or (l, r).
    uid = 0
    heap: list[tuple[int, int, object]] = []
    for s in present:
        heap.append((int(hist[s]), uid, int(s)))
        uid += 1
    heapq.heapify(heap)
    while len(heap) > 1:
        c1, _, t1 = heapq.heappop(heap)
        c2, _, t2 = heapq.heappop(heap)
        heapq.heappush(heap, (c1 + c2, uid, (t1, t2)))
        uid += 1
    stack = [(heap[0][2], 0)]
    while stack:
        node, depth = stack.pop()
        if isinstance(node, int):
            lengths[node] = max(depth, 1)
        else:
            l, r = node
            stack.append((l, depth + 1))
            stack.append((r, depth + 1))
    return lengths


def _flatten_histogram(hist: np.ndarray) -> np.ndarray:
    """Reduce skew so the longest Huffman code shortens (length limiting)."""
    h = np.asarray(hist, dtype=np.int64)
    return np.where(h > 0, (h + 1) // 2, 0)


@dataclasses.dataclass(frozen=True)
class CodeBook:
    """Canonical Huffman codebook + array-based decode tree.

    lengths   : [256] int32 code length per symbol (0 = absent).
    codes_msb : [256] uint32 canonical codeword, MSB-first.
    codes_lsb : [256] uint32 bit-reversed codeword (LSB-first emission
                order), what the encoder ORs into the stream.
    children  : [n_nodes, 2] int32; the stream bit selects children[idx, bit].
    is_symbol : [n_nodes] int32, 1 at leaves.
    symbols   : [n_nodes] int32, the decoded symbol at leaves (0 else).
    """

    lengths: np.ndarray
    codes_msb: np.ndarray
    codes_lsb: np.ndarray
    children: np.ndarray
    is_symbol: np.ndarray
    symbols: np.ndarray

    @property
    def n_nodes(self) -> int:
        return int(self.children.shape[0])

    @property
    def decode_probes(self) -> int:
        """LUT probes per symbol: one per started LUT_CHUNK_BITS of the
        longest codeword (<= 2 under the MAX_CODE_LEN limit)."""
        return max(1, -(-int(self.lengths.max()) // LUT_CHUNK_BITS))

    def decode_lut(self) -> np.ndarray:
        """Flat ``[n_nodes * 256]`` int32 chunked-decode LUT (built once and
        cached on the instance: codebooks are frozen)."""
        lut = getattr(self, "_lut", None)
        if lut is None:
            lut = np.ascontiguousarray(build_decode_lut(self).reshape(-1))
            object.__setattr__(self, "_lut", lut)
        return lut

    def _per_device(self, name: str, device, make):
        """``make(device)``, made once per device and kept on the instance."""
        dev = torch.device(device)
        cache = self.__dict__.setdefault("_on_device", {})
        if (name, dev) not in cache:
            cache[name, dev] = make(dev)
        return cache[name, dev]

    def device_lut(self, device) -> torch.Tensor:
        """The flat LUT as an int32 tensor on ``device``: one copy per device,
        so a decode step copies nothing from the host."""
        return self._per_device("lut", device,
                                lambda dev: torch.from_numpy(self.decode_lut()).to(dev))

    def device_multi_lut(self, device) -> torch.Tensor | None:
        """``build_multi_lut`` flat (int32 [2 * 2**MULTI_PEEK_BITS]) on
        ``device``, one copy per device; None where the book does not fit it."""
        def make(dev):
            tab = build_multi_lut(self)
            return None if tab is None else torch.from_numpy(tab.reshape(-1)).to(dev)
        return self._per_device("multi", device, make)

    def encode_tables(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """(codes_lsb, lengths) as int64 [256] tensors on ``device``, one copy
        per device."""
        return self._per_device("enc", device, lambda dev: tuple(
            torch.from_numpy(a.astype(np.int64)).to(dev) for a in (self.codes_lsb, self.lengths)))

    def as_device_tables(self, device="cpu"):
        """Decode tables as int32 tensors padded to MAX_NODES nodes:
        children [512, 2], is_symbol [512], symbols [512]."""
        ch = np.zeros((MAX_NODES, 2), np.int32)
        isym = np.zeros((MAX_NODES,), np.int32)
        sym = np.zeros((MAX_NODES,), np.int32)
        n = self.n_nodes
        ch[:n] = self.children
        isym[:n] = self.is_symbol
        sym[:n] = self.symbols
        return tuple(torch.from_numpy(a).to(device) for a in (ch, isym, sym))


def _reverse_bits(code: int, length: int) -> int:
    out = 0
    for _ in range(length):
        out = (out << 1) | (code & 1)
        code >>= 1
    return out


def _build_tree(lengths: np.ndarray, codes_msb: np.ndarray):
    """Array-based tree: node 0 is the root; children[i] = [left, right]."""
    children = [[0, 0]]
    is_symbol = [0]
    symbols = [0]
    for s in range(N_SYMBOLS):
        L = int(lengths[s])
        if L == 0:
            continue
        code = int(codes_msb[s])
        idx = 0
        for b in range(L - 1, -1, -1):
            bit = (code >> b) & 1
            nxt = children[idx][bit]
            if nxt == 0:
                children.append([0, 0])
                is_symbol.append(0)
                symbols.append(0)
                nxt = len(children) - 1
                children[idx][bit] = nxt
            idx = nxt
        is_symbol[idx] = 1
        symbols[idx] = s
    return (np.asarray(children, np.int32), np.asarray(is_symbol, np.int32),
            np.asarray(symbols, np.int32))


def build_codebook(hist) -> CodeBook:
    """Build a canonical, length-limited codebook from a histogram."""
    hist = np.asarray(hist, dtype=np.int64)
    if hist.shape != (N_SYMBOLS,):
        raise ValueError(f"hist must have shape ({N_SYMBOLS},), got {hist.shape}")
    work = hist.copy()
    lengths = _huffman_lengths(work)
    # Length-limit by flattening the histogram (u16 bit counts a stream).
    for _ in range(64):
        if lengths.max() <= MAX_CODE_LEN:
            break
        work = _flatten_histogram(work)
        lengths = _huffman_lengths(work)
    assert lengths.max() <= MAX_CODE_LEN, "length limiting failed to converge"

    # Canonical code assignment: sort by (length, symbol).
    codes_msb = np.zeros(N_SYMBOLS, np.uint32)
    codes_lsb = np.zeros(N_SYMBOLS, np.uint32)
    order = sorted(s for s in range(N_SYMBOLS) if lengths[s] > 0)
    order.sort(key=lambda s: (lengths[s], s))
    code = 0
    prev_len = 0
    for s in order:
        L = int(lengths[s])
        code <<= L - prev_len
        codes_msb[s] = code
        codes_lsb[s] = _reverse_bits(code, L)
        code += 1
        prev_len = L
    children, is_symbol, symbols = _build_tree(lengths, codes_msb)
    return CodeBook(lengths=lengths, codes_msb=codes_msb, codes_lsb=codes_lsb,
                    children=children, is_symbol=is_symbol, symbols=symbols)


def build_decode_lut(book: CodeBook) -> np.ndarray:
    """Chunked-decode LUT ``[n_nodes, 256]`` int32 (host side, once).

    Entry ``[s, c]`` walks the ``LUT_CHUNK_BITS`` bits of chunk ``c``
    (LSB-first, the stream's bit order) down the tree from node ``s`` and
    stops at the FIRST leaf:

        bits  0..7   symbol   (decoded symbol; 0 when no leaf was reached)
        bits  8..11  consumed (stream bits used, <= 8)
        bit   12     emit     (1 iff a leaf was reached inside the chunk)
        bits 16..    next     (continuation node: root after a leaf, else
                               the interior node after 8 bits)
    """
    n = book.n_nodes
    chunks = np.arange(1 << LUT_CHUNK_BITS, dtype=np.int32)
    idx = np.broadcast_to(np.arange(n, dtype=np.int32)[:, None], (n, chunks.size)).copy()
    sym = np.zeros((n, chunks.size), np.int32)
    consumed = np.zeros((n, chunks.size), np.int32)
    emitted = np.zeros((n, chunks.size), bool)
    for b in range(LUT_CHUNK_BITS):
        bit = (chunks[None, :] >> b) & 1
        nxt = book.children[idx, bit]
        live = ~emitted
        consumed = np.where(live, consumed + 1, consumed)
        leaf = live & (book.is_symbol[nxt] == 1)
        sym = np.where(leaf, book.symbols[nxt], sym)
        idx = np.where(live, nxt, idx)
        emitted |= leaf
    nxt_state = np.where(emitted, 0, idx)  # reset-to-root at leaves
    return (sym | (consumed << 8) | (emitted.astype(np.int32) << 12)
            | (nxt_state << 16)).astype(np.int32)


def build_multi_lut(book: CodeBook) -> np.ndarray | None:
    """Multi-symbol decode table ``[2**MULTI_PEEK_BITS, 2]`` int32 (host
    side, once), the port's own: the slot decode kernel's probe loop.

    Entry ``c`` decodes, from the root, every whole codeword that the
    ``MULTI_PEEK_BITS`` bits of ``c`` (LSB-first) hold, at most
    ``MULTI_MAX_SYMBOLS``:

        word 0   symbol k at bits 8k .. 8k+7
        word 1   bits 0..2 count (>= 1); bits 4+4k .. 7+4k the bits consumed
                 through symbol k; bits 20..23 the bits consumed in all

    The symbols are the tree's, in stream order, so the decode equals the
    chunked LUT's.  Only for a complete tree (Kraft sum 1, two or more
    symbols) whose every code fits the peek: then every entry holds at least
    one codeword.  Otherwise None, and the decode keeps the LUT's probes.
    """
    ln = book.lengths[book.lengths > 0].astype(np.int64)
    if (len(ln) < 2 or ln.max() > MULTI_PEEK_BITS
            or (1 << MAX_CODE_LEN) != int((1 << (MAX_CODE_LEN - ln)).sum())):
        return None
    n = 1 << MULTI_PEEK_BITS
    rows = np.arange(n)
    idx = np.zeros(n, np.int64)
    count = np.zeros(n, np.int64)
    syms = np.zeros((n, MULTI_MAX_SYMBOLS), np.int64)
    ends = np.zeros((n, MULTI_MAX_SYMBOLS), np.int64)
    for b in range(MULTI_PEEK_BITS):
        nxt = book.children[idx, (rows >> b) & 1]
        leaf = (book.is_symbol[nxt] == 1) & (count < MULTI_MAX_SYMBOLS)
        k = np.minimum(count, MULTI_MAX_SYMBOLS - 1)
        syms[rows, k] = np.where(leaf, book.symbols[nxt], syms[rows, k])
        ends[rows, k] = np.where(leaf, b + 1, ends[rows, k])
        count += leaf
        idx = np.where(leaf, 0, nxt)
    assert count.min() >= 1
    meta = count | (ends[rows, count - 1] << 20)
    for k in range(MULTI_MAX_SYMBOLS):
        meta |= ends[:, k] << (4 + 4 * k)
    sym_word = (syms << (8 * np.arange(MULTI_MAX_SYMBOLS))).sum(-1)
    return np.stack([sym_word, meta], -1).astype(np.uint32).view(np.int32)


def histogram(codes: torch.Tensor) -> torch.Tensor:
    """Histogram of uint8 codes over the 256 symbols (on the codes' device)."""
    return torch.bincount(codes.reshape(-1).to(torch.int64), minlength=N_SYMBOLS)


# ---------------------------------------------------------------------------
# Numpy oracles (exact; the ground truth for every other implementation)
# ---------------------------------------------------------------------------


def encode_block(codes: np.ndarray, book: CodeBook):
    """Encode a 2D block, one stream per row, tightly bit-packed in order.
    Returns (payload_words u32[...], nbits u16[S])."""
    codes = np.asarray(codes, np.uint8)
    S, L = codes.shape
    lengths = book.lengths
    nbits = lengths[codes.astype(np.int64)].sum(axis=1).astype(np.uint16)
    total = int(nbits.astype(np.int64).sum())
    words = np.zeros((total + 31) // 32 or 1, np.uint32)
    pos = 0
    for s in range(S):
        for j in range(L):
            sym = int(codes[s, j])
            cw = int(book.codes_lsb[sym])
            ln = int(lengths[sym])
            for b in range(ln):
                if (cw >> b) & 1:
                    words[(pos + b) >> 5] |= np.uint32(1 << ((pos + b) & 31))
            pos += ln
    return words, nbits


def decode_block(words: np.ndarray, nbits: np.ndarray, book: CodeBook, n_per_stream: int):
    """Branchless decode oracle, a literal transcription of the paper's loop."""
    words = np.asarray(words, np.uint32)
    nbits = np.asarray(nbits, np.int64)
    S = len(nbits)
    out = np.zeros((S, n_per_stream), np.uint8)
    starts = np.concatenate([[0], np.cumsum(nbits)])[:-1]
    for s in range(S):
        idx = 0
        w = 0
        buf = np.zeros(n_per_stream + 1, np.int64)  # +1 slack: last write lands at w==n
        for p in range(int(starts[s]), int(starts[s] + nbits[s])):
            bit = (int(words[p >> 5]) >> (p & 31)) & 1
            idx = int(book.children[idx, bit])
            isym = int(book.is_symbol[idx])
            buf[min(w, n_per_stream)] = book.symbols[idx] if isym else buf[min(w, n_per_stream)]
            w += isym
            idx &= ~(-isym)
        out[s] = buf[:n_per_stream]
    return out


# ---------------------------------------------------------------------------
# Plain PyTorch versions (batched over leading dims)
# ---------------------------------------------------------------------------


def _u32(words: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2^32)."""
    return words.to(torch.int64) & _U32


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, -1) - x


def encode_block_torch(codes: torch.Tensor, codes_lsb: torch.Tensor, lengths: torch.Tensor,
                       capacity_words: int):
    """Encode blocks codes [..., S, L] (one stream per row) -> (payload int32
    [..., capacity_words], nbits int32 [..., S] (u16 values), total_bits
    int64 [...]).

    Every symbol's global bit offset is an exclusive cumsum of code lengths
    (the reference's ``encode_block_jax``).  A codeword of at most 16 bits
    straddles at most two words; both contributions are scatter-added
    (bitwise disjoint, so add == or) in int64, and words past the capacity
    drop.  ``codes_lsb`` / ``lengths`` are int [256] tables."""
    *lead, S, L = codes.shape
    flat = codes.reshape(-1, S * L).to(torch.int64)
    ln = lengths.to(torch.int64)[flat]
    cw = codes_lsb.to(torch.int64)[flat]
    ends = torch.cumsum(ln, -1)
    offs = ends - ln
    nbits = ln.reshape(-1, S, L).sum(-1) & 0xFFFF
    word_idx = offs >> 5
    bit_in = offs & 31
    low = (cw << bit_in) & _U32
    high = cw >> (32 - bit_in)  # cw < 2^16, so the shift by 32 at bit_in 0 gives 0
    cap = capacity_words
    payload = torch.zeros((flat.shape[0], cap + 1), dtype=torch.int64, device=codes.device)
    payload.scatter_add_(1, torch.clamp(word_idx, max=cap), low)  # column cap = dropped
    payload.scatter_add_(1, torch.clamp(word_idx + 1, max=cap), high)
    return (to_int32_bits(payload[:, :cap]).reshape(*lead, cap),
            nbits.to(torch.int32).reshape(*lead, S), ends[:, -1].reshape(lead))


def walk_decode_torch(payload: torch.Tensor, nbits: torch.Tensor, children: torch.Tensor,
                      is_symbol: torch.Tensor, symbols: torch.Tensor, n_per_stream: int,
                      max_bits: int) -> torch.Tensor:
    """The branchless lockstep tree walk (``walk_decode_jax``): payload
    int32 [..., W], nbits [..., S] -> float32 [..., S, n_per_stream].

    Iteration p reads every stream's p-th bit (gathers clamp to the
    payload), steps ``idx = children[idx, bit]``, writes the symbol at the
    stream's column w when a leaf is reached, advances w, and resets to the
    root.  Streams past their nbits are masked; nothing lands past
    ``n_per_stream``."""
    W = payload.shape[-1]
    pw = _u32(payload)
    nb = nbits.to(torch.int64)
    starts = _exclusive_cumsum(nb)
    ch = children.to(torch.int64)
    isym_t, sym_t = is_symbol.to(torch.int64), symbols.to(torch.float32)
    idx = torch.zeros_like(nb)
    w = torch.zeros_like(nb)
    out = torch.zeros((*nb.shape, n_per_stream), dtype=torch.float32, device=payload.device)
    col = torch.arange(n_per_stream, device=payload.device)
    for p in range(max_bits):
        gpos = starts + p
        word = torch.gather(pw, -1, torch.clamp(gpos >> 5, max=W - 1))
        bit = (word >> (gpos & 31)) & 1
        idx = ch[idx, bit]
        isym = isym_t[idx] * (p < nb)
        hit = (col == w[..., None]) & (isym[..., None] == 1)
        out = torch.where(hit, sym_t[idx][..., None], out)
        w = w + isym
        idx = idx * (1 - isym)
    return out


def decode_block_torch(payload, nbits, children, is_symbol, symbols, n_per_stream: int,
                       max_stream_bits: int) -> torch.Tensor:
    """The tree walk's codes as uint8 [..., S, n_per_stream]."""
    return walk_decode_torch(payload, nbits, children, is_symbol, symbols, n_per_stream,
                             max_stream_bits).to(torch.uint8)


def peek_chunk(payload: torch.Tensor, pos: torch.Tensor, n_words: int) -> torch.Tensor:
    """LUT_CHUNK_BITS stream bits at bit positions ``pos`` [..., S] of
    ``payload`` (int64 u32 values [..., W]); straddles at most two words.
    Word reads clamp to the last payload word, so garbage walks past the
    end stay in bounds."""
    w = torch.clamp(pos >> 5, max=n_words - 1)
    b = pos & 31
    lo = torch.gather(payload, -1, w) >> b
    # Only the low 8 bits of the result matter, and a bit of the next word
    # lands there from its low 7 bits: masking first keeps the shift in range.
    hi = (torch.gather(payload, -1, torch.clamp(w + 1, max=n_words - 1)) & 0xFF) << (32 - b)
    return (lo | hi) & ((1 << LUT_CHUNK_BITS) - 1)


def decode_block_lut_torch(payload: torch.Tensor, nbits: torch.Tensor, lut: torch.Tensor,
                           n_per_stream: int, n_probes: int = 2) -> torch.Tensor:
    """Chunked direct-lookup decode (``decode_block_lut_jax``): payload int32
    [..., W], nbits [..., S], the flat LUT -> uint8 [..., S, n_per_stream].

    Every stream decodes its j-th symbol in lockstep with ``n_probes`` table
    probes.  A symbol whose codeword would run past its stream's nbits
    budget decodes to 0, as the tree walk leaves padded and truncated
    streams."""
    W = payload.shape[-1]
    pw = _u32(payload)
    nb = nbits.to(torch.int64)
    pos = _exclusive_cumsum(nb)
    ends = pos + nb
    lut64 = lut.to(torch.int64)
    out = torch.zeros((*nb.shape, n_per_stream), dtype=torch.uint8, device=payload.device)
    for j in range(n_per_stream):
        state = torch.zeros_like(nb)
        sym = torch.zeros_like(nb)
        done = torch.zeros(nb.shape, dtype=torch.bool, device=nb.device)
        for _ in range(n_probes):
            e = lut64[state * (1 << LUT_CHUNK_BITS) + peek_chunk(pw, pos, W)]
            take = ~done
            emit = ((e >> 12) & 1) == 1
            sym = torch.where(take & emit, e & 0xFF, sym)
            pos = torch.where(take, pos + ((e >> 8) & 0xF), pos)
            state = torch.where(take, e >> 16, state)
            done = done | emit
        out[..., j] = torch.where(pos <= ends, sym, torch.zeros_like(sym)).to(torch.uint8)
    return out
