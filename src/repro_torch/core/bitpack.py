"""Bit-packing (the port of ``repro.core.bitpack``).

* No-straddle packing (the serving layouts): each 32-bit word holds
  ``32 // bits`` whole codes.
* Straddling packing at any width 1..8 (``pack_bits`` / ``unpack_bits``) and
  the ragged per-block adaptive container (``pack_adaptive`` /
  ``unpack_adaptive``, deterministic cumsum offsets: the atomic-free Block
  Offsets Array), which ``core.codec`` reports on.

Words live in ``torch.int32`` tensors holding the bit patterns of the
reference's uint32 words (PyTorch has no uint32 shift on the CPU): compare
them with ``numpy.view(np.uint32)``.  Unpacking shifts the int32 words
arithmetically and masks the low ``bits`` bits, which is exact because a
code never straddles bit 31.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def codes_per_word(bits: int) -> int:
    return 32 // bits


def nostraddle_words(n_codes: int, bits: int) -> int:
    return (n_codes + codes_per_word(bits) - 1) // codes_per_word(bits)


def to_int32_bits(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor of the same bit pattern."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def pack_nostraddle(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """[..., L] integer codes -> [..., nostraddle_words(L, bits)] int32 words."""
    if not (1 <= bits <= 16):
        raise ValueError(f"bits must be in [1, 16], got {bits}")
    *lead, L = codes.shape
    cpw = codes_per_word(bits)
    W = nostraddle_words(L, bits)
    c = codes.to(torch.int64) & ((1 << bits) - 1)
    pad = W * cpw - L
    if pad:
        c = torch.cat([c, c.new_zeros(*lead, pad)], dim=-1)
    shifts = torch.arange(cpw, device=codes.device, dtype=torch.int64) * bits
    return to_int32_bits((c.reshape(*lead, W, cpw) << shifts).sum(-1))


def unpack_nostraddle(words: torch.Tensor, bits: int, n_codes: int) -> torch.Tensor:
    """Inverse of pack_nostraddle: [..., W] int32 -> [..., n_codes] uint8."""
    return unpack_nostraddle_tile(words, bits, n_codes).to(torch.uint8)


def unpack_nostraddle_tile(words: torch.Tensor, bits: int, n_codes: int) -> torch.Tensor:
    """[..., W] int32 words -> [..., n_codes] int32 codes (shift + mask only:
    the decode the Fetch kernel runs on each shared-memory tile)."""
    *lead, W = words.shape
    cpw = codes_per_word(bits)
    shifts = torch.arange(cpw, device=words.device, dtype=torch.int32) * bits
    vals = (words.to(torch.int32)[..., None] >> shifts) & ((1 << bits) - 1)
    return vals.reshape(*lead, W * cpw)[..., :n_codes]


def packed_words(n_codes: int, bits: int) -> int:
    """u32 words holding ``n_codes`` values at ``bits`` bits each, straddling."""
    return (n_codes * bits + 31) // 32


def pack_bits(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack codes (< 2**bits) along the last axis LSB-first into u32 words,
    a value straddling two words where it must: [..., L] -> int32 [...,
    packed_words(L, bits)] (bit patterns of the u32 words)."""
    if not (1 <= bits <= 8):
        raise ValueError(f"bits must be in [1, 8], got {bits}")
    *lead, L = codes.shape
    W = packed_words(L, bits)
    c = codes.reshape(-1, L).to(torch.int64) & ((1 << bits) - 1)
    pos = torch.arange(L, device=codes.device, dtype=torch.int64) * bits
    word, bit_in = pos >> 5, pos & 31
    out = torch.zeros((c.shape[0], W + 1), dtype=torch.int64, device=codes.device)
    idx = word[None].expand_as(c)
    out.scatter_add_(1, idx, (c << bit_in) & 0xFFFFFFFF)  # disjoint bits: add == or
    out.scatter_add_(1, idx + 1, c >> (32 - bit_in))      # the spill (0 unless straddling)
    return to_int32_bits(out[:, :W]).reshape(*lead, W)


def unpack_bits(words: torch.Tensor, bits: int, n_codes: int) -> torch.Tensor:
    """Inverse of pack_bits: [..., W] int32 -> [..., n_codes] uint8."""
    if not (1 <= bits <= 8):
        raise ValueError(f"bits must be in [1, 8], got {bits}")
    w = words.to(torch.int64) & 0xFFFFFFFF
    pos = torch.arange(n_codes, device=words.device, dtype=torch.int64) * bits
    word, bit_in = pos >> 5, pos & 31
    nxt = torch.clamp(word + 1, max=w.shape[-1] - 1)
    val = (w[..., word] >> bit_in) | (w[..., nxt] << (32 - bit_in))
    return (val & ((1 << bits) - 1)).to(torch.uint8)


def choose_bits(codes: torch.Tensor, dims: tuple[int, ...], pow2: bool = False) -> torch.Tensor:
    """Per-block bit width ceil(log2(max+1)), at least 1; optionally rounded
    up to {1, 2, 4, 8}."""
    mx = torch.amax(codes.to(torch.int32), dim=dims)
    b = torch.ceil(torch.log2(torch.clamp(mx, min=1).to(torch.float32) + 1.0)).to(torch.int32)
    b = torch.clamp(b, min=1)
    if pow2:
        b = torch.ones_like(b) << torch.ceil(torch.log2(b.to(torch.float32))).to(torch.int32)
    return b


@dataclasses.dataclass
class AdaptivePacked:
    """Ragged container: per-block adaptive widths, deterministic offsets.

    payload : int32 [capacity_words] (u32 bit patterns), blocks back to back
    offsets : int32 [n_blocks] word offset of each block (an exclusive
              cumsum of the blocks' word counts)
    bits    : int32 [n_blocks] width of each block
    nwords  : int32 [n_blocks] words of each block
    """

    payload: torch.Tensor
    offsets: torch.Tensor
    bits: torch.Tensor
    nwords: torch.Tensor
    block_codes: int

    @property
    def payload_bits(self) -> torch.Tensor:
        return self.nwords.sum() * 32

    @property
    def meta_bits(self) -> int:
        # a u32 offset and a u8 width a block
        return int(self.offsets.shape[0]) * (32 + 8)


def pack_adaptive(codes: torch.Tensor, capacity_words: int, pow2: bool = False) -> AdaptivePacked:
    """Pack [n_blocks, block_codes] codes, each block at its own width,
    into one payload at cumsum offsets (words past the capacity drop)."""
    n_blocks, L = codes.shape
    bits = choose_bits(codes, (1,), pow2=pow2).to(torch.int64)
    per_block = (L * bits + 31) // 32
    offsets = torch.cumsum(per_block, 0) - per_block
    payload = torch.zeros((capacity_words + 1,), dtype=torch.int64, device=codes.device)
    for b in ((1, 2, 4, 8) if pow2 else range(1, 9)):
        Wb = packed_words(L, b)
        pk = pack_bits(codes, b).to(torch.int64) & 0xFFFFFFFF
        sel = (bits == b)[:, None]
        tgt = torch.where(sel, offsets[:, None] + torch.arange(Wb, device=codes.device),
                          torch.full_like(pk, capacity_words))
        payload.scatter_add_(0, torch.clamp(tgt, max=capacity_words).reshape(-1),
                             torch.where(sel, pk, torch.zeros_like(pk)).reshape(-1))
    return AdaptivePacked(payload=to_int32_bits(payload[:capacity_words]),
                          offsets=offsets.to(torch.int32), bits=bits.to(torch.int32),
                          nwords=per_block.to(torch.int32), block_codes=L)


def unpack_adaptive(packed: AdaptivePacked) -> torch.Tensor:
    """Inverse of pack_adaptive -> uint8 [n_blocks, block_codes]."""
    L = packed.block_codes
    n_blocks = packed.offsets.shape[0]
    dev = packed.payload.device
    out = torch.zeros((n_blocks, L), dtype=torch.uint8, device=dev)
    for b in range(1, 9):
        Wb = packed_words(L, b)
        idx = packed.offsets.to(torch.int64)[:, None] + torch.arange(Wb, device=dev)
        words = packed.payload[torch.clamp(idx, max=packed.payload.shape[0] - 1)]
        out = torch.where((packed.bits == b)[:, None], unpack_bits(words, b, L), out)
    return out


# ---------------------------------------------------------------------------
# Numpy oracle (for kernel and property tests), as in the reference
# ---------------------------------------------------------------------------


def pack_bits_np(codes: np.ndarray, bits: int) -> np.ndarray:
    """Straddling pack in numpy: [..., L] codes -> [..., packed_words] uint32."""
    codes = np.asarray(codes, np.uint32) & ((1 << bits) - 1)
    *lead, L = codes.shape
    W = packed_words(L, bits)
    out = np.zeros((*lead, W), np.uint32)
    flat_c = codes.reshape(-1, L)
    flat_o = out.reshape(-1, W)
    for j in range(L):
        pos = j * bits
        w, s = pos >> 5, pos & 31
        flat_o[:, w] |= (flat_c[:, j] << s) & 0xFFFFFFFF
        if s + bits > 32:
            flat_o[:, w + 1] |= flat_c[:, j] >> (32 - s)
    return out


def unpack_bits_np(words: np.ndarray, bits: int, n_codes: int) -> np.ndarray:
    """Inverse of ``pack_bits_np``: [..., W] words -> [..., n_codes] uint8."""
    words = np.asarray(words, np.uint64)
    *lead, W = words.shape
    flat_w = words.reshape(-1, W)
    out = np.zeros((flat_w.shape[0], n_codes), np.uint8)
    mask = (1 << bits) - 1
    for j in range(n_codes):
        pos = j * bits
        w, s = pos >> 5, pos & 31
        v = flat_w[:, w] >> s
        if s + bits > 32 and w + 1 < W:
            v |= flat_w[:, w + 1] << (32 - s)
        out[:, j] = (v & mask).astype(np.uint8)
    return out.reshape(*lead, n_codes)
