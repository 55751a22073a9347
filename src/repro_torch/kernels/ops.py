"""Kernel entry points + the decode-attention backend registry.

Backends (same names as the reference's ``repro.kernels.ops``):

* ``"fused"`` — the Fetch kernel (``kernels.fused_kv_attn``) for CUDA
  tensors, its plain version for CPU tensors; needs a layout with
  ``supports_fused``.
* ``"xla"``   — the blockwise lazily-dequantized scan
  (``core.cache.attend_blockwise``), plain PyTorch, every layout.
* ``"auto"``  — ``fused`` for CUDA tensors of fused-capable layouts, ``xla``
  otherwise.

``REPRO_ATTN_BACKEND`` replaces an ``auto`` selection (explicit requests
win), so CI steers every default-configured path on the CPU through both.
"""

from __future__ import annotations

import os

import torch

from repro_torch.kernels.fused_kv_attn import fused_cache_attention  # noqa: F401  (entry point)
from repro_torch.kernels.pack_encode import quant_pack  # noqa: F401  (entry point)

_BACKENDS: dict[str, object] = {}

ENV_BACKEND = "REPRO_ATTN_BACKEND"


def register_backend(name: str):
    """Decorator: register ``fn(cache, q, scale) -> [B, Hq, D]`` under ``name``."""

    def deco(fn):
        _BACKENDS[name] = fn
        return fn

    return deco


def available_backends() -> tuple[str, ...]:
    return tuple(sorted(_BACKENDS))


def resolve_backend(backend: str | None, layout, device: torch.device) -> str:
    """Collapse (requested backend, env override, layout capability, device)
    to a registered backend name."""
    name = backend or "auto"
    if name == "auto":
        name = os.environ.get(ENV_BACKEND) or "auto"
    if name == "auto":
        name = "fused" if (device.type == "cuda" and layout.supports_fused) else "xla"
    if name == "fused" and not layout.supports_fused:
        name = "xla"
    if name not in _BACKENDS:
        raise ValueError(
            f"unknown attention backend {name!r}; available: {available_backends()}")
    return name


def decode_attention(cache, q: torch.Tensor, scale: float | None = None,
                     backend: str | None = None) -> torch.Tensor:
    """Decode attention over (store ∥ buffer): the registry dispatch point.
    ``backend=None`` defers to ``cache.spec.attn_backend``."""
    name = resolve_backend(backend if backend is not None else cache.spec.attn_backend,
                           cache.spec.impl, q.device)
    return _BACKENDS[name](cache, q, scale)


@register_backend("xla")
def _xla_backend(cache, q, scale=None):
    from repro_torch.core import cache as kvcache  # late: core imports this module

    return kvcache.attend_blockwise(cache, q, scale)


@register_backend("fused")
def _fused_backend(cache, q, scale=None):
    return cache_decode_attention(cache, q, scale=scale)


def cache_decode_attention(cache, q: torch.Tensor, scale: float | None = None) -> torch.Tensor:
    """Fused decode attention straight from a LayerKVCache."""
    spec = cache.spec
    tile = spec.impl.tile_decode(spec, cache.head_dim)
    if tile is None:
        raise ValueError(f"the Fetch kernel needs a fused-capable layout, got {spec.layout!r}")
    out = fused_cache_attention(
        q.to(torch.float32).contiguous(),
        cache.k_store, cache.k_min, cache.k_step,
        cache.v_store, cache.v_min, cache.v_step,
        cache.k_buf, cache.v_buf,
        torch.clamp(cache.n_flushed, max=spec.n_blocks), cache.buf_len,
        tile=tile, block_size=spec.block_size, scale=scale)
    return out.to(q.dtype)
