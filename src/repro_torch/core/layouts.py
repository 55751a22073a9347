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
* ``fetch``        — bulk dequantized K/V of a whole dense ring, built on
                     ``decode_span`` (reconstruction, tests and the
                     ``cache.attend_materialized`` baseline only).
* ``size_report``  — exact size accounting of an offline-quantized tensor
                     (``core.quant``), metadata included.

Built-in layouts: ``raw`` (bf16, exact), ``packed`` (error-bounded
quantizer + no-straddle packing), ``kivi`` (fixed-bit baseline) and
``huffman`` (the paper's maximal-ratio path: per-block Huffman streams with
u16 per-stream bit counts, decoded by the chunked direct-lookup decoder).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch.core import bitpack, huffman
from repro_torch.kernels import runtime
from repro_torch.obs.profiling import annotate

RAW_BITS_PER_VALUE = 16  # KV caches are bf16 at rest


# ---------------------------------------------------------------------------
# Size accounting (paper §3.3.2's ~1/128 metadata analysis)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RatioReport:
    """Exact size accounting for one compressed tensor."""

    n_values: int
    payload_bits: int
    scale_bits: int
    stream_meta_bits: int
    offset_meta_bits: int
    codebook_bits: int

    @property
    def total_bits(self) -> int:
        return (self.payload_bits + self.scale_bits + self.stream_meta_bits
                + self.offset_meta_bits + self.codebook_bits)

    @property
    def ratio(self) -> float:
        return self.n_values * RAW_BITS_PER_VALUE / max(self.total_bits, 1)

    @property
    def bits_per_value(self) -> float:
        return self.total_bits / max(self.n_values, 1)


def raw_ratio(q) -> RatioReport:
    """Uncompressed baseline: 16 bits a value, no metadata."""
    n = q.codes.numel()
    return RatioReport(n_values=n, payload_bits=n * RAW_BITS_PER_VALUE, scale_bits=0,
                       stream_meta_bits=0, offset_meta_bits=0, codebook_bits=0)


def kivi_ratio(q, bits: int) -> RatioReport:
    """KIVI baseline: fixed b-bit payload + 16-bit (min, step) a unit."""
    n = q.codes.numel()
    return RatioReport(n_values=n, payload_bits=n * bits, scale_bits=q.meta_bits,
                       stream_meta_bits=0, offset_meta_bits=0, codebook_bits=0)


def huffman_ratio(q, book: huffman.CodeBook, streams_shape: tuple[int, int]) -> RatioReport:
    """Huffman path sizes from the code histogram (exact bits)."""
    hist = np.bincount(q.codes.reshape(-1).cpu().numpy(), minlength=huffman.N_SYMBOLS)
    n = q.codes.numel()
    n_streams = n // streams_shape[1]
    n_blocks = max(n_streams // streams_shape[0], 1)
    return RatioReport(
        n_values=n, payload_bits=int((hist * book.lengths).sum()), scale_bits=q.meta_bits,
        stream_meta_bits=n_streams * 16,  # u16 bit count a stream
        offset_meta_bits=n_blocks * 32,   # u32 offset a block
        codebook_bits=book.serialized_bits)


def packed_ratio(q, block_codes: int) -> RatioReport:
    """Adaptive fixed-length path sizes: each block at the width of its
    largest code, padded to whole 32-bit words."""
    codes = q.codes.reshape(-1, block_codes).cpu().numpy()
    mx = codes.max(axis=1).astype(np.int64)
    b = np.maximum(np.ceil(np.log2(mx + 1)), 1).astype(np.int64)
    n_blocks = codes.shape[0]
    return RatioReport(
        n_values=q.codes.numel(), payload_bits=int((((block_codes * b) + 31) // 32 * 32).sum()),
        scale_bits=q.meta_bits,
        stream_meta_bits=n_blocks * 8,  # u8 width a block
        offset_meta_bits=n_blocks * 32, codebook_bits=0)


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

    kind            : ``raw`` (bf16 passthrough), ``packed`` (no-straddle
        words, packed and kivi) or ``huffman`` (u16 header + Huffman streams).
    k_tile / v_tile : one block's store tile shape, ``(W,)`` words or
        ``(T, D)`` raw values.
    has_scales      : quantized tiles carry (min, step) units; raw tiles do not.
    bits_k / bits_v : code widths of packed tiles (0 for raw).
    hdr_k / hdr_v, probes_k / probes_v, book_k / book_v : huffman tiles' header
        words, LUT probes a symbol and codebooks (their flat LUTs are what the
        kernel reads; the books stay out of ``==`` and ``hash``).
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
    kind: str = "packed"
    hdr_k: int = 0
    hdr_v: int = 0
    probes_k: int = 0
    probes_v: int = 0
    book_k: huffman.CodeBook | None = dataclasses.field(default=None, compare=False, repr=False)
    book_v: huffman.CodeBook | None = dataclasses.field(default=None, compare=False, repr=False)

    def luts(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """The huffman books' flat LUTs on ``device`` (one copy per device)."""
        return self.book_k.device_lut(device), self.book_v.device_lut(device)

    def _codes(self, tile, key: bool):
        T, D = self.block_size, self.head_dim
        if self.kind == "huffman":
            hdr, book, probes = ((self.hdr_k, self.book_k, self.probes_k) if key
                                 else (self.hdr_v, self.book_v, self.probes_v))
            return huffman.decode_block_lut_torch(
                tile[..., hdr:], unpack_u16_pairs(tile[..., :hdr], T),
                book.device_lut(tile.device), D, probes).to(torch.float32)
        return bitpack.unpack_nostraddle_tile(
            tile, self.bits_k if key else self.bits_v, T * D).reshape(
            *tile.shape[:-1], T, D).to(torch.float32)

    def decode_k(self, tile, mn=None, st=None):
        if not self.has_scales:
            return tile.to(torch.float32)
        return (mn.to(torch.float32)[..., None, :]
                + self._codes(tile, True) * st.to(torch.float32)[..., None, :])

    def decode_v(self, tile, mn=None, st=None):
        if not self.has_scales:
            return tile.to(torch.float32)
        return (mn.to(torch.float32)[..., :, None]
                + self._codes(tile, False) * st.to(torch.float32)[..., :, None])


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
    if dev.type == "cpu" and not runtime.charging() and ok.any():
        live = rows[ok] * NBs + flat[ok]
        if len(torch.unique(live)) != len(live):
            raise RuntimeError("two live writes target one store slot")
    rep = torch.argmax(ok.to(torch.int32))  # first live entry (0 if none)
    any_ok = ok[rep[None]][0]  # a tensor index: no host read of rep
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
    needs_codebook: bool = False  # size_report takes a fitted CodeBook
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

    def decode_block(self, spec, cache, n: int):
        """Decode ONE store block: ``decode_span(spec, cache, n, 1)`` with the
        block axis dropped, codes (or values) f32 ``[B, H, T, D]``."""
        kc, k_mn, k_st, vc, v_mn, v_st = self.decode_span(spec, cache, n, 1)
        one = lambda a: None if a is None else a[:, :, 0]  # noqa: E731
        return (one(kc).to(torch.float32), one(k_mn), one(k_st),
                one(vc).to(torch.float32), one(v_mn), one(v_st))

    def fetch(self, spec, cache):
        """Bulk Fetch of a dense cache: dequantized K and V bf16
        ``[B, H, NB, T, D]`` of every ring slot, through ``decode_span`` over
        the whole ring.  Reconstruction and tests only; the decode path
        never materializes the store."""
        kc, k_mn, k_st, vc, v_mn, v_st = self.decode_span(spec, cache, 0, cache.k_store.shape[2])
        if k_mn is None:
            return kc, vc
        f32 = torch.float32
        k = k_mn.to(f32)[..., None, :] + kc * k_st.to(f32)[..., None, :]
        v = v_mn.to(f32)[..., :, None] + vc * v_st.to(f32)[..., :, None]
        return k.to(torch.bfloat16), v.to(torch.bfloat16)

    def decompress_k(self, spec, cache) -> torch.Tensor:
        return self.fetch(spec, cache)[0]

    def decompress_v(self, spec, cache) -> torch.Tensor:
        return self.fetch(spec, cache)[1]

    def size_report(self, q, *, block_size: int, head_dim: int, kivi_bits: int = 2,
                    book: huffman.CodeBook | None = None) -> RatioReport:
        """Exact accounting of an offline-quantized tensor (``core.quant``)
        stored under this layout."""
        raise NotImplementedError

    def bytes_per_token(self, spec, n_kv_heads: int, head_dim: int) -> float:
        """Analytic device bytes a cached token and layer (payload and
        scales): the dry run's roofline model (``launch.dryrun``)."""
        raise NotImplementedError

    def tile_decode(self, spec, head_dim: int) -> FusedTileSpec | None:
        return fused_tile_spec(self.name, spec, head_dim)

    def _tile_decode(self, spec, head_dim: int) -> FusedTileSpec:
        raise NotImplementedError

    def attend_block(self, cache, q, scale=None, backend=None):
        """Decode attention over (store ∥ buffer) through the backend
        registry of ``repro_torch.kernels.ops``."""
        from repro_torch.kernels import ops  # late: kernels import core

        return ops.decode_attention(cache, q, scale, backend=backend)


@functools.lru_cache(maxsize=256)
def fused_tile_spec(layout_name: str, spec, head_dim: int) -> FusedTileSpec | None:
    """The layout's (memoized) tile spec, or None when the Fetch kernel
    cannot decode its tiles (``supports_fused`` is authoritative)."""
    lay = get_layout(layout_name)
    return lay._tile_decode(spec, head_dim) if lay.supports_fused else None


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
                             block_size=spec.block_size, head_dim=head_dim, kind="raw")

    def size_report(self, q, *, block_size, head_dim, kivi_bits=2, book=None):
        return raw_ratio(q)

    def bytes_per_token(self, spec, n_kv_heads, head_dim):
        return 2.0 * n_kv_heads * head_dim * 2  # K and V, bf16


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

    def quantize_blocks(self, spec, k: torch.Tensor, v: torch.Tensor):
        """The lossy stage of every quantizing layout, plain: raw blocks
        ``[B, H, NB, T, D]`` -> (codes u8, min, step) of K (BlockQuant: over
        the block's tokens, per channel) and of V (TokenQuant: over D, per
        token), in float32."""
        k_codes, k_mn, k_st = quant_block_minmax(k.to(torch.float32), spec.rel_scale_k,
                                                 spec.bits_k, (-2,), self.kivi_step)
        v_codes, v_mn, v_st = quant_block_minmax(v.to(torch.float32), spec.rel_scale_v,
                                                 spec.bits_v, (-1,), self.kivi_step)
        return k_codes, k_mn, k_st, v_codes, v_mn, v_st

    def compress_blocks(self, spec, k: torch.Tensor, v: torch.Tensor):
        """Raw blocks ``[B, H, NB, T, D]`` -> the packed stores and bf16
        scales, plain: what ``write_blocks``' Store kernel writes."""
        k_codes, k_mn, k_st, v_codes, v_mn, v_st = self.quantize_blocks(spec, k, v)
        B, H, NB, T, D = k.shape
        bf = torch.bfloat16
        return (bitpack.pack_nostraddle(k_codes.reshape(B, H, NB, T * D), spec.bits_k),
                k_mn.to(bf), k_st.to(bf),
                bitpack.pack_nostraddle(v_codes.reshape(B, H, NB, T * D), spec.bits_v),
                v_mn.to(bf), v_st.to(bf))

    def write_blocks(self, spec, cache, slots, kb, vb) -> None:
        from repro_torch.kernels import pack_encode  # late: kernels import core

        with annotate("pack_encode"):
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

    def size_report(self, q, *, block_size, head_dim, kivi_bits=2, book=None):
        return packed_ratio(q, block_size * head_dim)

    def bytes_per_token(self, spec, n_kv_heads, head_dim):
        payload = n_kv_heads * head_dim * (spec.bits_k + spec.bits_v) / 8
        # scales: K a (block, channel), V a token, each a bf16 minimum and step
        meta = n_kv_heads * (2 * head_dim * 2 * 2 / spec.block_size + 2 * 2)
        return payload + meta


@register_layout("kivi")
class KiviLayout(PackedLayout):
    kivi_step = True  # step = (max−min)/(2^b − 1)

    def bits_k(self, spec) -> int:
        return spec.kivi_bits

    def bits_v(self, spec) -> int:
        return spec.kivi_bits

    def size_report(self, q, *, block_size, head_dim, kivi_bits=2, book=None):
        return kivi_ratio(q, kivi_bits)


@functools.lru_cache(maxsize=64)
def default_codebook(n_codes: int) -> huffman.CodeBook:
    """Static prior codebook covering codes [0, n_codes): triangular, peaked
    at the code range's center (the error-bounded quantizer's codes of
    LLM-like data are bell-shaped, paper Fig. 3).  Covering the whole code
    range keeps the layout lossless for any input."""
    hist = np.zeros(huffman.N_SYMBOLS, np.int64)
    c = np.arange(n_codes, dtype=np.float64)
    center = (n_codes - 1) / 2.0
    hist[:n_codes] = 1 + np.round(1000.0 * (n_codes - np.abs(c - center))).astype(np.int64)
    return huffman.build_codebook(hist)


def pack_u16_pairs(nbits: torch.Tensor) -> torch.Tensor:
    """u16 per-stream bit counts [..., S] -> int32 header words [..., (S+1)//2]
    (stream 2i in the low half of word i, stream 2i+1 in the high half)."""
    nb = nbits.to(torch.int64) & 0xFFFF
    if nb.shape[-1] % 2:
        nb = torch.cat([nb, torch.zeros_like(nb[..., :1])], dim=-1)
    return bitpack.to_int32_bits(nb[..., 0::2] | (nb[..., 1::2] << 16))


def unpack_u16_pairs(hdr: torch.Tensor, S: int) -> torch.Tensor:
    """int32 header words [..., Hw] -> the S bit counts [..., S] (int32)."""
    v = hdr.to(torch.int64) & 0xFFFFFFFF
    pairs = torch.stack([v & 0xFFFF, v >> 16], dim=-1)
    return pairs.reshape(*hdr.shape[:-1], -1)[..., :S].to(torch.int32)


@register_layout("huffman")
class HuffmanLayout(PackedLayout):
    """Huffman-coded blocks behind the same six-tensor cache contract.

    Slot of one block (K and V alike): ``(T+1)//2`` header words holding the
    T per-stream u16 bit counts (one stream per token, D codes each), then a
    worst-case payload (``T*D*max_code_len`` bits under the static prior
    codebook, plus a word).  The scales are the packed layout's, and the codes
    are the packed layout's codes (same quantizer, lossless entropy coding),
    so ``q.(mn + st*c)`` applies unchanged after the entropy decode.

    The Store is plain PyTorch, as in the reference (quantize, then
    ``encode_block_torch``, then ``scatter_slots``).  The Fetch kernel decodes
    whole slots in shared memory with the chunked LUT (``tile_decode``); the
    blockwise chunk path decodes a span's K and V slots in one launch of the
    slot LUT decode kernel (``kernels.huffman_decode.huffman_lut_decode_kv``).
    """

    supports_fused = True
    needs_codebook = True

    def _n_codes(self, spec, bits: int, rel_scale: float) -> int:
        n = round(1.0 / rel_scale) + 1
        return int(min(n, 2**bits, huffman.N_SYMBOLS))

    def book_k(self, spec) -> huffman.CodeBook:
        return default_codebook(self._n_codes(spec, spec.bits_k, spec.rel_scale_k))

    def book_v(self, spec) -> huffman.CodeBook:
        return default_codebook(self._n_codes(spec, spec.bits_v, spec.rel_scale_v))

    def _slot_words(self, spec, head_dim: int, book: huffman.CodeBook) -> tuple[int, int]:
        """(header_words, payload_words) of one block's slot."""
        T = spec.block_size
        hdr = (T + 1) // 2
        payload = (T * head_dim * int(book.lengths.max()) + 31) // 32 + 1
        return hdr, payload

    def init_store(self, spec, batch, n_kv_heads, head_dim, dtype, device):
        B, H, T, D, NB = batch, n_kv_heads, spec.block_size, head_dim, spec.store_blocks
        wk = sum(self._slot_words(spec, D, self.book_k(spec)))
        wv = sum(self._slot_words(spec, D, self.book_v(spec)))
        z = lambda *s, dt=dtype: torch.zeros(s, dtype=dt, device=device)  # noqa: E731
        return (z(B, H, NB, wk, dt=torch.int32), z(B, H, NB, D), z(B, H, NB, D),
                z(B, H, NB, wv, dt=torch.int32), z(B, H, NB, T), z(B, H, NB, T))

    def _encode(self, spec, codes: torch.Tensor, book: huffman.CodeBook) -> torch.Tensor:
        """codes u8 [..., T, D] -> slots int32 [..., hdr + payload]."""
        _, pay_w = self._slot_words(spec, codes.shape[-1], book)
        payload, nbits, _ = huffman.encode_block_torch(
            codes, *book.encode_tables(codes.device), pay_w)
        return torch.cat([pack_u16_pairs(nbits), payload], dim=-1)

    def _slot_args(self, spec, store: torch.Tensor, head_dim: int, book: huffman.CodeBook):
        """What the slot decode takes of slots [B, H, C, W] under ``book``:
        (slots [B*H*C, W], LUT, multi-symbol table or None, header words,
        probes)."""
        dev = store.device
        return (store.reshape(-1, store.shape[-1]).contiguous(), book.device_lut(dev),
                book.device_multi_lut(dev), self._slot_words(spec, head_dim, book)[0],
                book.decode_probes)

    def _decode(self, spec, store: torch.Tensor, head_dim: int,
                book: huffman.CodeBook) -> torch.Tensor:
        """slots int32 [B, H, C, W] -> codes u8 [B, H, C, T, D]: the slot LUT
        decode kernel on the card, its plain version on the CPU."""
        from repro_torch.kernels import huffman_decode  # late: kernels import core

        slots, lut, multi, hdr, probes = self._slot_args(spec, store, head_dim, book)
        with annotate("huffman_lut_decode"):
            codes = huffman_decode.huffman_lut_decode(
                slots, lut, block_size=spec.block_size, head_dim=head_dim, hdr_words=hdr,
                probes=probes, multi=multi)
        return codes.reshape(*store.shape[:3], spec.block_size, head_dim)

    def write_blocks(self, spec, cache, slots, kb, vb) -> None:
        kc, kmn, kst, vc, vmn, vst = self.quantize_blocks(spec, kb, vb)
        bf = torch.bfloat16
        for store, val in ((cache.k_store, self._encode(spec, kc, self.book_k(spec))),
                           (cache.k_min, kmn.to(bf)), (cache.k_step, kst.to(bf)),
                           (cache.v_store, self._encode(spec, vc, self.book_v(spec))),
                           (cache.v_min, vmn.to(bf)), (cache.v_step, vst.to(bf))):
            scatter_slots(store, slots, val)

    def decode_span(self, spec, cache, start, count):
        """K and V of the span in one slot-decode launch."""
        from repro_torch.kernels import huffman_decode  # late: kernels import core

        sl = slice(start, start + count)
        D, T = cache.head_dim, spec.block_size
        ks, vs = cache.k_store[:, :, sl], cache.v_store[:, :, sl]
        with annotate("huffman_lut_decode"):
            kc, vc = huffman_decode.huffman_lut_decode_kv(
                self._slot_args(spec, ks, D, self.book_k(spec)),
                self._slot_args(spec, vs, D, self.book_v(spec)), block_size=T, head_dim=D)
        kc = kc.reshape(*ks.shape[:3], T, D)
        vc = vc.reshape(*vs.shape[:3], T, D)
        return (kc.to(torch.float32), cache.k_min[:, :, sl], cache.k_step[:, :, sl],
                vc.to(torch.float32), cache.v_min[:, :, sl], cache.v_step[:, :, sl])

    def _tile_decode(self, spec, head_dim):
        book_k, book_v = self.book_k(spec), self.book_v(spec)
        hk, pk = self._slot_words(spec, head_dim, book_k)
        hv, pv = self._slot_words(spec, head_dim, book_v)
        return FusedTileSpec(k_tile=(hk + pk,), v_tile=(hv + pv,), has_scales=True,
                             block_size=spec.block_size, head_dim=head_dim, kind="huffman",
                             hdr_k=hk, hdr_v=hv, probes_k=book_k.decode_probes,
                             probes_v=book_v.decode_probes, book_k=book_k, book_v=book_v)

    def size_report(self, q, *, block_size, head_dim, kivi_bits=2, book=None):
        if book is None:
            raise ValueError("huffman size_report needs a fitted codebook (book=)")
        return huffman_ratio(q, book, (block_size, head_dim))

    def bytes_per_token(self, spec, n_kv_heads: int, head_dim: int) -> float:
        """Allocated (worst-case slot) bytes a cached token and layer, scales
        included."""
        T = spec.block_size
        wk = sum(self._slot_words(spec, head_dim, self.book_k(spec)))
        wv = sum(self._slot_words(spec, head_dim, self.book_v(spec)))
        payload = n_kv_heads * 4.0 * (wk + wv) / T
        meta = n_kv_heads * (2 * head_dim * 2 * 2 / T + 2 * 2)
        return payload + meta
