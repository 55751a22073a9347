"""Compression policies: the paper's LLM-aware knobs as one declarative
object (the port of ``repro.core.policy``).

K and V get different granularities and error bounds, and the right setting
may vary per layer: ``CompressionPolicy`` holds a base (layout, block_size,
per-tensor rel_scale/bits) plus per-layer overrides, and resolves them to
per-layer ``CacheSpec``s.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.cache import CacheSpec
from repro_torch.core.layouts import get_layout

# The paper's Fig. 5 turning points.
DEFAULT_REL_SCALE_K = 0.05
DEFAULT_REL_SCALE_V = 0.15


@dataclasses.dataclass(frozen=True)
class TensorPolicy:
    """Per-tensor (K or V) quantizer knobs; ``None`` = inherit."""

    rel_scale: float | None = None
    bits: int | None = None

    def merged(self, base: "TensorPolicy") -> "TensorPolicy":
        return TensorPolicy(
            rel_scale=self.rel_scale if self.rel_scale is not None else base.rel_scale,
            bits=self.bits if self.bits is not None else base.bits,
        )


@dataclasses.dataclass(frozen=True)
class LayerOverride:
    """Overrides applied to an explicit set of attention-layer indices."""

    layers: tuple[int, ...]
    layout: str | None = None
    block_size: int | None = None
    k: TensorPolicy = TensorPolicy()
    v: TensorPolicy = TensorPolicy()
    attn_backend: str | None = None  # per-layer decode-attention backend
    span_tokens: int | None = None   # per-layer blockwise-scan span knob
    unroll_max: int | None = None    # kept for the reference's signature (CacheSpec)


@dataclasses.dataclass(frozen=True)
class CompressionPolicy:
    """Layout + quantizer configuration for a whole model's KV caches.

    ``attn_backend`` picks the decode-attention backend of each layer's
    cache (``repro_torch.kernels.ops``); ``mode`` the storage container,
    whole-model: every layer of a paged model must flush the same logical
    block at the same step for one page id to serve all layers, so paged
    policies refuse per-layer ``block_size`` overrides.  ``span_tokens``
    and ``unroll_max`` are the blockwise scan's knobs (``None`` = the
    environment variable or the module default, see
    ``repro_torch.core.cache.blockwise_knobs``).  Every field except
    ``mode`` and ``kivi_bits`` is overridable per layer.
    """

    layout: str = "packed"
    block_size: int = 64
    k: TensorPolicy = TensorPolicy(rel_scale=DEFAULT_REL_SCALE_K)
    v: TensorPolicy = TensorPolicy(rel_scale=DEFAULT_REL_SCALE_V)
    kivi_bits: int = 2
    attn_backend: str = "auto"
    mode: str = "dense"  # "dense" rings per slot | "paged" (repro_torch.core.pool)
    span_tokens: int | None = None
    unroll_max: int | None = None
    overrides: tuple[LayerOverride, ...] = ()

    def __post_init__(self):
        get_layout(self.layout)  # fail fast on unknown names
        if self.mode not in ("dense", "paged"):
            raise ValueError(f"mode must be dense|paged, got {self.mode!r}")
        for ov in self.overrides:
            if ov.layout is not None:
                get_layout(ov.layout)
            if self.mode == "paged" and ov.block_size is not None:
                raise ValueError(
                    "paged mode needs a uniform block_size across layers "
                    "(one page id serves every layer's arena); drop the "
                    f"block_size override on layers {ov.layers}")

    @property
    def uniform(self) -> bool:
        """True when every layer resolves to the same spec."""
        return not self.overrides

    def resolve(self, layer: int) -> "CompressionPolicy":
        """Collapse overrides for one layer into an override-free policy."""
        layout, block, k, v = self.layout, self.block_size, self.k, self.v
        backend, span, unroll = self.attn_backend, self.span_tokens, self.unroll_max
        for ov in self.overrides:
            if layer in ov.layers:
                layout = ov.layout if ov.layout is not None else layout
                block = ov.block_size if ov.block_size is not None else block
                k = ov.k.merged(k)
                v = ov.v.merged(v)
                backend = ov.attn_backend if ov.attn_backend is not None else backend
                span = ov.span_tokens if ov.span_tokens is not None else span
                unroll = ov.unroll_max if ov.unroll_max is not None else unroll
        return dataclasses.replace(self, layout=layout, block_size=block, k=k, v=v,
                                   attn_backend=backend, span_tokens=span,
                                   unroll_max=unroll, overrides=())

    def spec_for_layer(self, layer: int, *, max_seq: int, window: int | None = None,
                       pool_pages: int = 0) -> CacheSpec:
        """Resolve one layer's spec.  ``pool_pages`` sizes the shared paged
        arena and is only known where the pool is (the ``Server``); without
        it a paged policy resolves to its dense twin, which is what every
        private batch-1 state and bulk prefill uses."""
        r = self.resolve(layer)
        mode = r.mode if pool_pages > 0 else "dense"
        return CacheSpec(
            layout=r.layout,
            block_size=r.block_size,
            rel_scale_k=r.k.rel_scale if r.k.rel_scale is not None else DEFAULT_REL_SCALE_K,
            rel_scale_v=r.v.rel_scale if r.v.rel_scale is not None else DEFAULT_REL_SCALE_V,
            kivi_bits=r.kivi_bits,
            max_seq=max_seq,
            window=window,
            bits_k_override=r.k.bits,
            bits_v_override=r.v.bits,
            attn_backend=r.attn_backend,
            mode=mode,
            pool_pages=pool_pages if mode == "paged" else 0,
            span_tokens=r.span_tokens,
            unroll_max=r.unroll_max,
        )

    def layer_specs(self, n_layers: int, *, max_seq: int, window: int | None = None,
                    pool_pages: int = 0) -> tuple[CacheSpec, ...]:
        return tuple(self.spec_for_layer(i, max_seq=max_seq, window=window,
                                         pool_pages=pool_pages)
                     for i in range(n_layers))
