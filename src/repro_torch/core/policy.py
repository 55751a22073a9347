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
    """Overrides applied to an explicit set of attention-layer indices: the
    layout and the per-tensor quantizer.  The block size stays uniform, as
    block-chunked admission needs."""

    layers: tuple[int, ...]
    layout: str | None = None
    k: TensorPolicy = TensorPolicy()
    v: TensorPolicy = TensorPolicy()


@dataclasses.dataclass(frozen=True)
class CompressionPolicy:
    """Layout + quantizer configuration for a whole model's KV caches."""

    layout: str = "packed"
    block_size: int = 64
    k: TensorPolicy = TensorPolicy(rel_scale=DEFAULT_REL_SCALE_K)
    v: TensorPolicy = TensorPolicy(rel_scale=DEFAULT_REL_SCALE_V)
    kivi_bits: int = 2
    attn_backend: str = "auto"
    mode: str = "dense"  # "dense" rings per slot | "paged" (repro_torch.core.pool)
    overrides: tuple[LayerOverride, ...] = ()

    def __post_init__(self):
        get_layout(self.layout)  # fail fast on unknown names
        if self.mode not in ("dense", "paged"):
            raise ValueError(f"mode must be dense|paged, got {self.mode!r}")
        for ov in self.overrides:
            if ov.layout is not None:
                get_layout(ov.layout)

    def resolve(self, layer: int) -> "CompressionPolicy":
        """Collapse overrides for one layer into an override-free policy."""
        layout, k, v = self.layout, self.k, self.v
        for ov in self.overrides:
            if layer in ov.layers:
                layout = ov.layout if ov.layout is not None else layout
                k = ov.k.merged(k)
                v = ov.v.merged(v)
        return dataclasses.replace(self, layout=layout, k=k, v=v, overrides=())

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
        )

    def layer_specs(self, n_layers: int, *, max_seq: int, window: int | None = None,
                    pool_pages: int = 0) -> tuple[CacheSpec, ...]:
        return tuple(self.spec_for_layer(i, max_seq=max_seq, window=window,
                                         pool_pages=pool_pages)
                     for i in range(n_layers))
