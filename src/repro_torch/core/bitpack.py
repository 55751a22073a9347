"""No-straddle bit-packing: each 32-bit word holds ``32 // bits`` whole codes.

The port's counterpart of the no-straddle subset of ``repro.core.bitpack``.
Words live in ``torch.int32`` tensors holding the bit patterns of the
reference's uint32 words (PyTorch has no uint32 shift on the CPU): compare
them with ``numpy.view(np.uint32)``.  Unpacking shifts the int32 words
arithmetically and masks the low ``bits`` bits, which is exact because a
code never straddles bit 31.
"""

from __future__ import annotations

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
