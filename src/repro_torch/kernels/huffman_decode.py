"""The Huffman decode kernels (``csrc/huffman_decode.cu``) and their plain
versions.

* ``huffman_decode`` replaces the Pallas kernel
  ``repro.kernels.huffman_decode._decode_kernel``: the paper's tree walk of
  each stream -> uint8 codes.  On the card a thread a stream probes a root
  table that each CTA builds from the tree tables (every whole codeword of
  10 stream bits a probe), and walks a bit a step only past it.
* ``huffman_attn_scores`` replaces ``_fused_scores_kernel``: the same decode,
  then the K dequant and the scores ``(K.q) * scale``.
* ``huffman_lut_decode`` has no Pallas counterpart: it decodes whole cache
  slots (u16 header + payload) into the chunked LUT's codes, for the huffman
  layout's blockwise chunk path; ``huffman_lut_decode_kv`` decodes a span's
  K and V slots in one launch (``HuffmanLayout.decode_span``).  Given a
  book's multi-symbol table (``CodeBook.device_multi_lut``) the kernel reads
  it in place of the LUT: the same codes in fewer probes.

Each wrapper takes its plain version (``kernels.ref`` and ``core.huffman``)
only for CPU tensors; for CUDA tensors it launches its kernel or raises (the
walk kernels raise where two blocks' payload, bit counts and code rows do
not fit a CTA's shared memory); under the dry run's op count each charges
its kernel's work and launches nothing.  Words are
int32 tensors holding u32 bit patterns; bit counts are int32 tensors of u16
values; tree tables are ``CodeBook.as_device_tables``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import huffman
from repro_torch.core.layouts import unpack_u16_pairs
from repro_torch.kernels import runtime
from repro_torch.kernels.ref import huffman_attn_scores_ref
from repro_torch.kernels.ref import huffman_decode_ref as huffman_decode_plain

NAME = "huffman_decode"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_WALK_ARGTYPES = [_P] * 6 + [_I] * 7 + [_P]
_SCORES_ARGTYPES = [_P] * 9 + [_I] * 6 + [_F, _I, _P]
_LUT_ARGTYPES = ([_P] * 4 + [_I] * 4) * 2 + [_I] * 3 + [_P]


def huffman_attn_scores_plain(payload, nbits, children, is_symbol, symbols, k_min, k_step, q,
                              max_bits: int, scale: float = 1.0) -> torch.Tensor:
    return huffman_attn_scores_ref(payload, nbits, children, is_symbol, symbols, k_min,
                                   k_step, q, max_bits) * scale


def huffman_lut_decode_plain(slots, lut, *, block_size: int, head_dim: int, hdr_words: int,
                             probes: int) -> torch.Tensor:
    nbits = unpack_u16_pairs(slots[..., :hdr_words], block_size)
    return huffman.decode_block_lut_torch(slots[..., hdr_words:], nbits, lut, head_dim, probes)


def _check_walk(kernel, payload, nbits, children, is_symbol, symbols):
    dev = payload.device
    runtime.require(dev.type == "cuda", f"{kernel}: payload on {dev}")
    NBLK, W = payload.shape
    S = nbits.shape[-1]
    n_nodes = children.shape[0]
    runtime.require(W >= 1 and 1 <= n_nodes <= huffman.MAX_NODES,
                    f"{kernel}: {W} payload words, {n_nodes} tree nodes")
    i32 = torch.int32
    for name, t, shape in (("payload", payload, (NBLK, W)), ("nbits", nbits, (NBLK, S)),
                           ("children", children, (n_nodes, 2)),
                           ("is_symbol", is_symbol, (n_nodes,)), ("symbols", symbols, (n_nodes,))):
        runtime.check_tensor(kernel, name, t, i32, shape, dev)
    return dev, NBLK, W, S, n_nodes


def huffman_decode(payload, nbits, children, is_symbol, symbols, n_per_stream: int,
                   max_bits: int) -> torch.Tensor:
    """Decode every block: payload int32 [NBLK, W], nbits int32 [NBLK, S],
    tree tables int32 [MAXN, 2] / [MAXN] / [MAXN] -> uint8 [NBLK, S,
    n_per_stream]."""
    if runtime.charging():
        NBLK, S = nbits.shape
        runtime.charge(NAME, _walk_bytes(payload, nbits, children) + NBLK * S * n_per_stream,
                       32 * payload.numel())
        return torch.empty((NBLK, S, n_per_stream), dtype=torch.uint8, device=payload.device)
    if payload.device.type == "cpu":
        return huffman_decode_plain(payload, nbits, children, is_symbol, symbols,
                                    n_per_stream, max_bits)
    dev, NBLK, W, S, n_nodes = _check_walk("huffman_decode", payload, nbits, children,
                                           is_symbol, symbols)
    out = torch.empty((NBLK, S, n_per_stream), dtype=torch.uint8, device=dev)
    if NBLK:
        runtime.launch(NAME, _WALK_ARGTYPES, payload.data_ptr(), nbits.data_ptr(),
                       children.data_ptr(), is_symbol.data_ptr(), symbols.data_ptr(),
                       out.data_ptr(), NBLK, W, S, n_per_stream, n_nodes, max_bits,
                       *runtime.stream_args(dev))
    return out


def huffman_attn_scores(payload, nbits, children, is_symbol, symbols, k_min, k_step, q,
                        max_bits: int, scale: float = 1.0) -> torch.Tensor:
    """Walk decode + K dequant + scores: k_min / k_step f32 [NBLK, D], q f32
    [D] -> f32 [NBLK, S] (one stream a cached token)."""
    if runtime.charging():
        NBLK, S = nbits.shape
        D = q.shape[-1]
        runtime.charge("huffman_attn_scores",
                       _walk_bytes(payload, nbits, children) + 2 * 4 * NBLK * D + 4 * D
                       + 4 * NBLK * S, 32 * payload.numel() + 4 * NBLK * S * D)
        return torch.empty((NBLK, S), dtype=torch.float32, device=payload.device)
    if payload.device.type == "cpu":
        return huffman_attn_scores_plain(payload, nbits, children, is_symbol, symbols, k_min,
                                         k_step, q, max_bits, scale)
    name = "huffman_attn_scores"
    dev, NBLK, W, S, n_nodes = _check_walk(name, payload, nbits, children, is_symbol,
                                           symbols)
    D = q.shape[-1]
    f32 = torch.float32
    for arg, t, shape in (("k_min", k_min, (NBLK, D)), ("k_step", k_step, (NBLK, D)),
                          ("q", q, (D,))):
        runtime.check_tensor(name, arg, t, f32, shape, dev)
    out = torch.empty((NBLK, S), dtype=f32, device=dev)
    if NBLK:
        runtime.launch(NAME, _SCORES_ARGTYPES, payload.data_ptr(), nbits.data_ptr(),
                       children.data_ptr(), is_symbol.data_ptr(), symbols.data_ptr(),
                       k_min.data_ptr(), k_step.data_ptr(), q.data_ptr(), out.data_ptr(),
                       NBLK, W, S, D, n_nodes, max_bits, float(scale),
                       *runtime.stream_args(dev), count=name, entry=f"{name}_launch")
    return out


def huffman_lut_decode(slots, lut, *, block_size: int, head_dim: int, hdr_words: int,
                       probes: int, multi=None) -> torch.Tensor:
    """Decode whole huffman slots: slots int32 [N, hdr + payload] (the u16
    bit counts of ``block_size`` streams, then the payload), the flat LUT
    int32 -> codes uint8 [N, block_size, head_dim].  ``multi``: the book's
    multi-symbol table, or None (the kernel then probes the LUT)."""
    if runtime.charging():
        return _lut_charge(((slots, lut, multi, hdr_words, probes),), block_size, head_dim)[0]
    if slots.device.type == "cpu":
        return huffman_lut_decode_plain(slots, lut, block_size=block_size, head_dim=head_dim,
                                        hdr_words=hdr_words, probes=probes)
    return _lut_launch(((slots, lut, multi, hdr_words, probes),), block_size, head_dim)[0]


def huffman_lut_decode_kv(k, v, *, block_size: int, head_dim: int):
    """The slot decode of K and V in one launch: ``k`` and ``v`` are each
    ``(slots, lut, multi, hdr_words, probes)`` as ``huffman_lut_decode``
    takes them -> (K codes, V codes)."""
    if runtime.charging():
        return _lut_charge((k, v), block_size, head_dim)
    if k[0].device.type == "cpu":
        return tuple(huffman_lut_decode_plain(sl, lut, block_size=block_size, head_dim=head_dim,
                                              hdr_words=hw, probes=pr)
                     for sl, lut, _, hw, pr in (k, v))
    return _lut_launch((k, v), block_size, head_dim)


def _walk_bytes(payload, nbits, children) -> int:
    """Bytes a walk kernel reads under an op count: every payload word (the
    words a stream fills depend on the data), the bit counts and the three
    tree tables once.  Its operations: one a payload bit."""
    return 4 * payload.numel() + 4 * nbits.numel() + 4 * 4 * children.shape[0]


def _lut_charge(tensors, T: int, D: int) -> tuple:
    """Charge one slot-decode launch under an op count: every slot word, the
    LUT once and the codes out (bytes); one operation a code and probe.
    Returns empty codes."""
    nbytes = ops = 0
    outs = []
    for slots, lut, _, _, probes in tensors:
        N = slots.shape[0]
        nbytes += 4 * slots.numel() + 4 * lut.numel() + N * T * D
        ops += N * T * D * probes
        outs.append(torch.empty((N, T, D), dtype=torch.uint8, device=slots.device))
    runtime.charge("huffman_lut_decode", nbytes, ops)
    return tuple(outs)


def _lut_launch(tensors, T: int, D: int) -> tuple:
    """One slot-decode launch over 1 or 2 (slots, lut, multi, hdr_words,
    probes) tensors; returns their codes."""
    name = "huffman_lut_decode"
    dev = tensors[0][0].device
    runtime.require(dev.type == "cuda", f"{name}: slots on {dev}")
    runtime.require(1 <= T <= 512 and D >= 4 and D % 4 == 0,
                    f"{name}: block_size must be in [1, 512] and head_dim a multiple of 4, got "
                    f"{T}, {D}")
    flat, outs = [], []
    for slots, lut, multi, hdr_words, probes in tensors:
        N, W = slots.shape
        runtime.require(hdr_words == (T + 1) // 2 and W > hdr_words and probes in (1, 2),
                        f"{name}: {W} slot words, {hdr_words} header words for {T} streams, "
                        f"{probes} probes")
        runtime.check_tensor(name, "slots", slots, torch.int32, (N, W), dev)
        runtime.check_tensor(name, "lut", lut, torch.int32, (lut.numel(),), dev)
        runtime.require(lut.numel() % (1 << huffman.LUT_CHUNK_BITS) == 0,
                        f"{name}: the LUT has {lut.numel()} entries, not whole 256-entry rows")
        if multi is not None:
            runtime.check_tensor(name, "multi", multi, torch.int32,
                                 (2 << huffman.MULTI_PEEK_BITS,), dev)
            # the kernel stages the table with 16-byte copies
            runtime.require(multi.data_ptr() % 16 == 0,
                            f"{name}: the multi-symbol table must be 16-byte aligned")
        out = torch.empty((N, T, D), dtype=torch.uint8, device=dev)
        outs.append(out)
        flat += [slots.data_ptr(), lut.data_ptr(), None if multi is None else multi.data_ptr(),
                 out.data_ptr(), N, W, hdr_words, probes]
    if len(tensors) == 1:
        flat += [None, None, None, None, 0, 1, 0, 1]
    if sum(t[0].shape[0] for t in tensors):
        runtime.launch(NAME, _LUT_ARGTYPES, *flat, T, D, *runtime.stream_args(dev), count=name,
                       entry=f"{name}_launch")
    return tuple(outs)
