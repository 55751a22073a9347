"""Pluggable cache-layout strategies (the port of ``repro.core.layouts``).

Every way of storing a layer's KV blocks is a ``CacheLayout`` registered by
name; the cache manager and the attention backends dispatch through the
registry.  A layout owns:

* ``init_store``   — allocate the six store tensors of a ``LayerKVCache``.
* ``write_blocks`` — the Store stage: quantize + encode whole blocks into
                     ring slots, or arena pages in paged mode.  Updates the
                     cache's store tensors in place (no copy per flush).  The packed layouts
                     launch the Store kernel (``kernels.pack_encode``).
* ``decode_span``  — lazy decode of a few blocks for the blockwise scan
                     (the ``xla`` backend, plain PyTorch).
* ``tile_decode``  — the ``FusedTileSpec`` the Fetch kernel
                     (``kernels.fused_kv_attn``) and its plain version use.

Built-in layouts here: ``raw`` (bf16, exact), ``packed`` (error-bounded
quantizer + no-straddle packing) and ``kivi`` (fixed-bit baseline).  The
reference's ``huffman`` layout belongs to a later slice of the port.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch.core import bitpack

RAW_BITS_PER_VALUE = 16  # KV caches are bf16 at rest


def bits_for_rel_scale(rel_scale: float) -> int:
    """Static bit width that covers every code of an error-bounded quantizer:
    max code = round(1/rel_scale)."""
    return max(1, math.ceil(math.log2(round(1.0 / rel_scale) + 1)))


def quant_block_minmax(x: torch.Tensor, rel_scale: float, bits: int,
                       unit_axes: tuple[int, ...], kivi: bool):
    """Quantize blocks x [..., T, D] (f32).  Returns codes u8 + (min, step)
    with the unit axes reduced — bit-identical to the reference."""
    mn = torch.amin(x, dim=unit_axes, keepdim=True)
    mx = torch.amax(x, dim=unit_axes, keepdim=True)
    if kivi:
        # (max-min) times the float32 reciprocal of 2^b-1: the reference's
        # compiled path (XLA folds its division by the constant into this
        # multiplication), which is what its server stores.
        step = (mx - mn) * float(np.float32(1) / np.float32(2**bits - 1))
    else:
        step = rel_scale * (mx - mn)
    safe = torch.where(step > 0, step, torch.ones_like(step))
    codes = torch.clamp(torch.round((x - mn) / safe), 0, 2**bits - 1).to(torch.uint8)
    return codes, mn.squeeze(unit_axes), step.squeeze(unit_axes)


@dataclasses.dataclass(frozen=True)
class FusedTileSpec:
    """What the Fetch kernel needs to decode one store tile (the port's
    counterpart of the reference's ``FusedTileSpec``, whose decode callables
    become a description the CUDA kernel reads).

    k_tile / v_tile : one block's store tile shape, ``(W,)`` packed words or
        ``(T, D)`` raw values.
    has_scales      : packed tiles carry (min, step) units; raw tiles do not.
    bits_k / bits_v : code widths of packed tiles (0 for raw).
    ``decode_k`` / ``decode_v`` are the plain versions of the kernel's tile
    decode, batched over any leading dims: tiles ``[..., *tile]`` and units
    ``[..., D]`` (K) / ``[..., T]`` (V) -> ``[..., T, D]`` float32.
    """

    k_tile: tuple[int, ...]
    v_tile: tuple[int, ...]
    has_scales: bool
    block_size: int
    head_dim: int
    bits_k: int = 0
    bits_v: int = 0

    def _codes(self, tile, bits):
        T, D = self.block_size, self.head_dim
        return bitpack.unpack_nostraddle_tile(tile, bits, T * D).reshape(
            *tile.shape[:-1], T, D).to(torch.float32)

    def decode_k(self, tile, mn=None, st=None):
        if not self.has_scales:
            return tile.to(torch.float32)
        codes = self._codes(tile, self.bits_k)
        return (mn.to(torch.float32)[..., None, :]
                + codes * st.to(torch.float32)[..., None, :])

    def decode_v(self, tile, mn=None, st=None):
        if not self.has_scales:
            return tile.to(torch.float32)
        codes = self._codes(tile, self.bits_v)
        return (mn.to(torch.float32)[..., :, None]
                + codes * st.to(torch.float32)[..., :, None])


def scatter_slots(store: torch.Tensor, slots: torch.Tensor,
                  vals: torch.Tensor) -> None:
    """Write per-row block payloads into store slots, in place.

    store : [Bs, H, NBs, ...], a per-row ring (Bs = B) or the paged arena
    (Bs = 1, NBs = pool pages); slots : int [B, n] ring slots or arena
    pages, where a slot outside ``[0, NBs)`` is the drop sentinel (that
    entry writes nothing); vals : [B, H, n, ...].

    The write needs no host-side look at ``slots``: a dropped entry repeats
    the first live entry's write (same place, same bits), or, when no entry
    is live, rewrites slot 0 of row 0 with its own value.  Duplicate indices
    then always carry identical bits, so no write order can change the
    result.  Two live entries on one place (two rows sharing a page, which
    the pool never allows) would race; on the CPU that raises.
    """
    Bs, NBs = store.shape[0], store.shape[2]
    B, n = slots.shape
    E, dev = B * n, store.device
    flat = slots.reshape(E).long()
    ok = (flat >= 0) & (flat < NBs)
    rows = (torch.arange(B, device=dev).repeat_interleave(n) if Bs > 1
            else torch.zeros(E, dtype=torch.long, device=dev))
    if dev.type == "cpu" and ok.any():
        live = rows[ok] * NBs + flat[ok]
        if len(torch.unique(live)) != len(live):
            raise RuntimeError("two live writes target one store slot")
    rep = torch.argmax(ok.to(torch.int32))  # first live entry (0 if none)
    any_ok = ok[rep]
    src = torch.where(ok, torch.arange(E, device=dev), rep)
    zero = torch.zeros_like(flat)
    tb = torch.where(any_ok, rows[src], zero)
    ts = torch.where(any_ok, flat[src], zero)
    new = vals.movedim(2, 1).reshape(E, *vals.shape[1:2], *vals.shape[3:])[src]
    # Advanced indices at dims 0 and 2 around a slice: the indexed dims move
    # to the front, so the selection is [E, H, ...].
    store[tb, :, ts] = torch.where(any_ok, new.to(store.dtype), store[tb, :, ts])


class CacheLayout:
    """Strategy interface for one way of storing a layer's KV blocks."""

    name: str = "?"
    supports_fused: bool = False  # the Fetch kernel can decode its tiles
    kivi_step: bool = False       # fixed-bit (KIVI) vs error-bounded steps

    def bits_k(self, spec) -> int:
        raise NotImplementedError

    def bits_v(self, spec) -> int:
        raise NotImplementedError

    def init_store(self, spec, batch, n_kv_heads, head_dim, dtype, device):
        """Allocate (k_store, k_min, k_step, v_store, v_min, v_step) with
        ``spec.store_blocks`` blocks (ring slots, or arena pages)."""
        raise NotImplementedError

    def write_blocks(self, spec, cache, slots, kb, vb) -> None:
        """Store stage: write raw blocks kb/vb [B, H, n, T, D] into per-row
        ring slots, or arena pages, [B, n] (out-of-range slot = drop), in
        place."""
        raise NotImplementedError

    def decode_span(self, spec, cache, start: int, count: int):
        """Decode blocks [start, start+count) for the blockwise scan:
        ``(k_codes, k_mn, k_st, v_codes, v_mn, v_st)`` with codes f32
        ``[B, H, C, T, D]`` and units ``[B, H, C, D]`` / ``[B, H, C, T]``, or
        ``None`` units when the codes already are the values."""
        raise NotImplementedError

    def tile_decode(self, spec, head_dim: int) -> FusedTileSpec | None:
        return _tile_spec(self.name, spec, head_dim) if self.supports_fused else None

    def _tile_decode(self, spec, head_dim: int) -> FusedTileSpec:
        raise NotImplementedError

    def attend_block(self, cache, q, scale=None, backend=None):
        """Decode attention over (store ∥ buffer) through the backend
        registry of ``repro_torch.kernels.ops``."""
        from repro_torch.kernels import ops  # late: kernels import core

        return ops.decode_attention(cache, q, scale, backend=backend)


@functools.lru_cache(maxsize=256)
def _tile_spec(layout_name: str, spec, head_dim: int) -> FusedTileSpec:
    return get_layout(layout_name)._tile_decode(spec, head_dim)


_REGISTRY: dict[str, CacheLayout] = {}


def register_layout(name: str):
    """Class decorator: instantiate and register a layout under ``name``."""

    def deco(cls):
        inst = cls()
        inst.name = name
        _REGISTRY[name] = inst
        return cls

    return deco


def get_layout(name: str) -> CacheLayout:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown cache layout {name!r}; available: {available_layouts()}"
        ) from None


def available_layouts() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


@register_layout("raw")
class RawLayout(CacheLayout):
    supports_fused = True  # passthrough tiles

    def bits_k(self, spec) -> int:
        return RAW_BITS_PER_VALUE

    def bits_v(self, spec) -> int:
        return RAW_BITS_PER_VALUE

    def init_store(self, spec, batch, n_kv_heads, head_dim, dtype, device):
        shape = (batch, n_kv_heads, spec.store_blocks, spec.block_size, head_dim)
        dummy = torch.zeros((1,), dtype=dtype, device=device)
        return (torch.zeros(shape, dtype=dtype, device=device), dummy, dummy,
                torch.zeros(shape, dtype=dtype, device=device), dummy, dummy)

    def write_blocks(self, spec, cache, slots, kb, vb) -> None:
        scatter_slots(cache.k_store, slots, kb)
        scatter_slots(cache.v_store, slots, vb)

    def decode_span(self, spec, cache, start, count):
        sl = slice(start, start + count)
        return cache.k_store[:, :, sl], None, None, cache.v_store[:, :, sl], None, None

    def _tile_decode(self, spec, head_dim):
        shape = (spec.block_size, head_dim)
        return FusedTileSpec(k_tile=shape, v_tile=shape, has_scales=False,
                             block_size=spec.block_size, head_dim=head_dim)


@register_layout("packed")
class PackedLayout(CacheLayout):
    supports_fused = True

    def bits_k(self, spec) -> int:
        return bits_for_rel_scale(spec.rel_scale_k)

    def bits_v(self, spec) -> int:
        return bits_for_rel_scale(spec.rel_scale_v)

    def init_store(self, spec, batch, n_kv_heads, head_dim, dtype, device):
        B, H, T, D, NB = batch, n_kv_heads, spec.block_size, head_dim, spec.store_blocks
        z = lambda *s, dt=dtype: torch.zeros(s, dtype=dt, device=device)  # noqa: E731
        return (z(B, H, NB, spec.words_k(D), dt=torch.int32), z(B, H, NB, D), z(B, H, NB, D),
                z(B, H, NB, spec.words_v(D), dt=torch.int32), z(B, H, NB, T), z(B, H, NB, T))

    def write_blocks(self, spec, cache, slots, kb, vb) -> None:
        from repro_torch.kernels import pack_encode  # late: kernels import core

        pack_encode.pack_encode(
            kb.contiguous(), vb.contiguous(), slots.to(torch.int32).contiguous(),
            cache.k_store, cache.k_min, cache.k_step,
            cache.v_store, cache.v_min, cache.v_step,
            bits_k=spec.bits_k, bits_v=spec.bits_v, rel_scale_k=spec.rel_scale_k,
            rel_scale_v=spec.rel_scale_v, kivi=self.kivi_step)

    def decode_span(self, spec, cache, start, count):
        B, H = cache.k_store.shape[:2]
        T, D = spec.block_size, cache.head_dim
        sl = slice(start, start + count)
        kc = bitpack.unpack_nostraddle(cache.k_store[:, :, sl], spec.bits_k, T * D)
        vc = bitpack.unpack_nostraddle(cache.v_store[:, :, sl], spec.bits_v, T * D)
        return (kc.reshape(B, H, count, T, D).to(torch.float32),
                cache.k_min[:, :, sl], cache.k_step[:, :, sl],
                vc.reshape(B, H, count, T, D).to(torch.float32),
                cache.v_min[:, :, sl], cache.v_step[:, :, sl])

    def _tile_decode(self, spec, head_dim):
        return FusedTileSpec(k_tile=(spec.words_k(head_dim),),
                             v_tile=(spec.words_v(head_dim),), has_scales=True,
                             block_size=spec.block_size, head_dim=head_dim,
                             bits_k=spec.bits_k, bits_v=spec.bits_v)


@register_layout("kivi")
class KiviLayout(PackedLayout):
    kivi_step = True  # step = (max−min)/(2^b − 1)

    def bits_k(self, spec) -> int:
        return spec.kivi_bits

    def bits_v(self, spec) -> int:
        return spec.kivi_bits
