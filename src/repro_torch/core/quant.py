"""Error-bounded quantizers for offline KV-cache size accounting (the port of
``repro.core.quant``, on plain tensors).

The paper's two quantization granularities (§3.1.1) plus the KIVI baseline
(§4.1), as ``api.estimate_ratio`` runs them:

* K ``BlockQuant`` (``quantize_k_block``): ``[ctx, heads, head_dim]`` split
  along ``ctx`` into blocks; min/max per (block, head, channel) unit and
  ``step = rel_scale * (max - min)``.
* K ``ChannelQuant`` (``quantize_k_channel``): min/max per (head, channel)
  over the whole segment (an ablation baseline).
* V ``TokenQuant`` (``quantize_v_token``): min/max per (token, head) over
  ``head_dim``.
* ``kivi_quantize_k`` / ``kivi_quantize_v``: fixed-bit asymmetric baseline,
  ``step = (max - min) / (2^b - 1)``.

Shared contract: ``code = clip(round((x - min)/step), 0, n_levels-1)`` as
uint8, ``x_hat = min + code * step``.  Every step here divides as the
reference's eager call does (``(max - min) / (2^b - 1)`` is a true
division, not a multiplication by the reciprocal): codes, mins and steps
are bit-exact against the reference's eager functions.  The serving path's
kivi Store follows the reference's compiled step instead
(``core.layouts.quant_block_minmax``).
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch

# Codes are uint8: at most 256 levels for the error-bounded quantizer.
N_LEVELS_U8 = 256

GranularityK = Literal["block", "channel"]


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Configuration of the KVComp quantizer (the reference's).  The step of
    each unit is ``rel_scale * (max - min)``; the defaults are the paper's
    turning points (Fig. 5): K BlockQuant 0.05, V TokenQuant 0.15."""

    block_size: int = 64
    rel_scale_k: float = 0.05
    rel_scale_v: float = 0.15
    k_granularity: GranularityK = "block"
    # KIVI baseline parameters.
    kivi_bits: int = 2
    kivi_group: int = 32
    residual_window: int = 32  # recent tokens kept unquantized (KIVI-style)

    def __post_init__(self):
        if self.block_size <= 0:
            raise ValueError(f"block_size must be positive, got {self.block_size}")
        if not (0.0 < self.rel_scale_k <= 1.0) or not (0.0 < self.rel_scale_v <= 1.0):
            raise ValueError("rel_scale must be in (0, 1]")
        if self.kivi_bits not in (1, 2, 3, 4, 8):
            raise ValueError(f"kivi_bits must be in {{1,2,3,4,8}}, got {self.kivi_bits}")


@dataclasses.dataclass
class Quantized:
    """Integer codes + per-unit affine parameters.  ``codes`` has the input's
    shape; ``minval`` / ``step`` broadcast against it (unit axes size 1)."""

    codes: torch.Tensor  # uint8
    minval: torch.Tensor
    step: torch.Tensor

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return (self.minval + self.codes.to(torch.float32) * self.step).to(dtype)

    @property
    def payload_bits_raw(self) -> int:
        """Bits of the code payload at 8 bits a code (before entropy coding)."""
        return self.codes.numel() * 8

    @property
    def meta_bits(self) -> int:
        """Bits of affine metadata (a 16-bit min and step a unit)."""
        return (self.minval.numel() + self.step.numel()) * 16


def _affine_quantize(x: torch.Tensor, minval: torch.Tensor, step: torch.Tensor,
                     n_levels: int) -> torch.Tensor:
    # A constant unit (step 0) gets code 0; dequant gives its min exactly.
    safe_step = torch.where(step > 0, step, torch.ones_like(step))
    q = torch.round((x - minval) / safe_step)
    return torch.clamp(q, 0, n_levels - 1).to(torch.uint8)


def _minmax(x: torch.Tensor, axes: tuple[int, ...]):
    return torch.amin(x, dim=axes, keepdim=True), torch.amax(x, dim=axes, keepdim=True)


def quantize_k_block(x: torch.Tensor, rel_scale: float, block_size: int) -> Quantized:
    """K BlockQuant.  x: [ctx, heads, head_dim], ctx % block_size == 0."""
    ctx, heads, hd = x.shape
    if ctx % block_size != 0:
        raise ValueError(f"ctx={ctx} not a multiple of block_size={block_size}")
    xb = x.reshape(ctx // block_size, block_size, heads, hd).to(torch.float32)
    mn, mx = _minmax(xb, (1,))
    step = rel_scale * (mx - mn)
    return Quantized(codes=_affine_quantize(xb, mn, step, N_LEVELS_U8), minval=mn, step=step)


def quantize_k_channel(x: torch.Tensor, rel_scale: float) -> Quantized:
    """KIVI-like ChannelQuant over the whole segment (per head, channel)."""
    xb = x.to(torch.float32)
    mn, mx = _minmax(xb, (0,))
    step = rel_scale * (mx - mn)
    return Quantized(codes=_affine_quantize(xb, mn, step, N_LEVELS_U8), minval=mn, step=step)


def quantize_v_token(x: torch.Tensor, rel_scale: float) -> Quantized:
    """V TokenQuant: units are (token, head), min/max over head_dim."""
    xb = x.to(torch.float32)
    mn, mx = _minmax(xb, (-1,))
    step = rel_scale * (mx - mn)
    return Quantized(codes=_affine_quantize(xb, mn, step, N_LEVELS_U8), minval=mn, step=step)


def kivi_quantize_k(x: torch.Tensor, bits: int, group: int) -> Quantized:
    """KIVI baseline for K: channel-wise asymmetric b-bit over token groups.
    x: [ctx, heads, head_dim], ctx % group == 0."""
    ctx, heads, hd = x.shape
    if ctx % group != 0:
        raise ValueError(f"ctx={ctx} not a multiple of group={group}")
    xb = x.reshape(ctx // group, group, heads, hd).to(torch.float32)
    mn, mx = _minmax(xb, (1,))
    n = 1 << bits
    step = (mx - mn) / (n - 1)
    return Quantized(codes=_affine_quantize(xb, mn, step, n), minval=mn, step=step)


def kivi_quantize_v(x: torch.Tensor, bits: int) -> Quantized:
    """KIVI baseline for V: token-wise asymmetric b-bit."""
    xb = x.to(torch.float32)
    mn, mx = _minmax(xb, (-1,))
    n = 1 << bits
    step = (mx - mn) / (n - 1)
    return Quantized(codes=_affine_quantize(xb, mn, step, n), minval=mn, step=step)


@dataclasses.dataclass(frozen=True)
class QuantStats:
    """Error and code-stream diagnostics of one quantized tensor."""

    max_abs_err: float
    mean_abs_err: float
    clip_fraction: float
    code_entropy_bits: float  # empirical entropy of the code stream

    @staticmethod
    def measure(x: torch.Tensor, q: Quantized) -> "QuantStats":
        xf = torch.as_tensor(x).to(torch.float32).reshape(q.codes.shape)
        err = torch.abs(xf - q.dequantize())
        # A code is clipped iff it sits at the top level while the ideal
        # level is above it (x >= min, so the bottom never clips).
        safe_step = torch.where(q.step > 0, q.step, torch.ones_like(q.step))
        ideal = torch.round((xf - q.minval) / safe_step)
        clipped = (ideal > q.codes.to(torch.float32)).to(torch.float32).mean()
        hist = torch.bincount(q.codes.reshape(-1).to(torch.int64), minlength=256)
        p = hist.to(torch.float32) / max(int(hist.sum()), 1)
        ent = -torch.sum(torch.where(p > 0, p * torch.log2(torch.where(p > 0, p, 1.0)), 0.0))
        return QuantStats(max_abs_err=float(err.max()), mean_abs_err=float(err.mean()),
                          clip_fraction=float(clipped), code_entropy_bits=float(ent))
