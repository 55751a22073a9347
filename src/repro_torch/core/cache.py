"""Compressed KV-cache manager, dense mode (the port of ``repro.core.cache``).

A per-layer cache keeps its main storage compressed (a ring of block slots,
encoded by the ``CacheLayout`` named in ``CacheSpec.layout``) and a small
raw append buffer.  New KV vectors accumulate in the buffer; when a row's
buffer fills one compression block, the block is quantized, encoded and
written into slot ``n_flushed % NB`` of that row's ring.

Lengths are per row (``n_flushed`` and ``buf_len`` are int32 ``[B]``), so
every row of a continuous batch appends, flushes and attends at its own
position.

Unlike the pure-function reference, the functions here update the cache's
tensors in place (the store ring and the buffers are large; copying them
on every token would double the decode path's memory traffic) and return
the same ``LayerKVCache``.  They never read a device value on the host, so
a decode step launches its kernels without waiting for the card.

Paged mode (one shared arena per layer) belongs to a later slice of the
port: every function here raises ``NotImplementedError`` for it.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import bitpack, layouts
from repro_torch.kernels.runtime import resolve_device

BLOCKWISE_SPAN_TOKENS = 1024  # ~tokens decoded per blockwise-scan step


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    """Static cache configuration (hashable)."""

    layout: str = "packed"
    block_size: int = 64
    rel_scale_k: float = 0.05
    rel_scale_v: float = 0.15
    kivi_bits: int = 2
    max_seq: int = 4096
    window: int | None = None  # sliding-window size (tokens), None = full
    bits_k_override: int | None = None
    bits_v_override: int | None = None
    attn_backend: str = "auto"
    mode: str = "dense"

    def __post_init__(self):
        if self.mode not in ("dense", "paged"):
            raise ValueError(f"mode must be dense|paged, got {self.mode!r}")
        if self.window is not None and self.window % self.block_size:
            raise ValueError(
                f"block_size ({self.block_size}) must divide window "
                f"({self.window}): the sliding-window ring evicts whole "
                f"compression blocks")

    @property
    def impl(self) -> layouts.CacheLayout:
        return layouts.get_layout(self.layout)

    @property
    def paged(self) -> bool:
        return self.mode == "paged"

    @property
    def bits_k(self) -> int:
        if self.bits_k_override is not None:
            return self.bits_k_override
        return self.impl.bits_k(self)

    @property
    def bits_v(self) -> int:
        if self.bits_v_override is not None:
            return self.bits_v_override
        return self.impl.bits_v(self)

    @property
    def n_blocks(self) -> int:
        """Ring length: blocks addressable per row."""
        span = self.max_seq if self.window is None else min(self.window, self.max_seq)
        return max(1, math.ceil(span / self.block_size))

    def words_k(self, head_dim: int) -> int:
        return bitpack.nostraddle_words(self.block_size * head_dim, self.bits_k)

    def words_v(self, head_dim: int) -> int:
        return bitpack.nostraddle_words(self.block_size * head_dim, self.bits_v)


def _dense_only(spec: CacheSpec) -> None:
    if spec.paged:
        raise NotImplementedError(
            "paged cache mode belongs to a later slice of the port "
            "(the paged block pool, ROADMAP.md item 5)")


@dataclasses.dataclass
class LayerKVCache:
    """One layer's cache.  Leading dims: [B, Hkv, ...].

    Packed layouts:
      k_store : int32 [B, Hkv, NB, Wk]   (bit patterns of the packed u32 words)
      k_min/k_step : bf16 [B, Hkv, NB, D]  (BlockQuant units)
      v_store : int32 [B, Hkv, NB, Wv]
      v_min/v_step : bf16 [B, Hkv, NB, T]  (TokenQuant units)
    raw layout: bf16 [B, Hkv, NB, T, D] blocks with [1] dummy scales.
    Shared by every layout:
      k_buf / v_buf : bf16 [B, Hkv, T, D] raw append buffer
      n_flushed : int32 [B] blocks ever flushed per row (ring index)
      buf_len   : int32 [B] valid buffer entries per row
    """

    k_store: torch.Tensor
    k_min: torch.Tensor
    k_step: torch.Tensor
    v_store: torch.Tensor
    v_min: torch.Tensor
    v_step: torch.Tensor
    k_buf: torch.Tensor
    v_buf: torch.Tensor
    n_flushed: torch.Tensor
    buf_len: torch.Tensor
    spec: CacheSpec

    FIELDS = ("k_store", "k_min", "k_step", "v_store", "v_min", "v_step",
              "k_buf", "v_buf", "n_flushed", "buf_len")

    @property
    def head_dim(self) -> int:
        return self.k_buf.shape[-1]

    @property
    def batch(self) -> int:
        return self.k_buf.shape[0]


def init_layer_cache(spec: CacheSpec, batch: int, n_kv_heads: int, head_dim: int,
                     dtype=torch.bfloat16, device="cuda") -> LayerKVCache:
    _dense_only(spec)
    dev = resolve_device(device)
    B, H, T, D = batch, n_kv_heads, spec.block_size, head_dim
    stores = spec.impl.init_store(spec, B, H, D, dtype, dev)
    return LayerKVCache(
        *stores,
        k_buf=torch.zeros((B, H, T, D), dtype=dtype, device=dev),
        v_buf=torch.zeros((B, H, T, D), dtype=dtype, device=dev),
        n_flushed=torch.zeros((B,), dtype=torch.int32, device=dev),
        buf_len=torch.zeros((B,), dtype=torch.int32, device=dev),
        spec=spec,
    )


def prefill(spec: CacheSpec, k: torch.Tensor, v: torch.Tensor,
            dtype=torch.bfloat16) -> LayerKVCache:
    """Build a cache on ``k``'s device from prompt KV [B, Hkv, S, D]: whole
    blocks are compressed, the remainder lands in the raw buffer."""
    _dense_only(spec)
    B, H, S, D = k.shape
    T, NB = spec.block_size, spec.n_blocks
    n_full = S // T
    cache = init_layer_cache(spec, B, H, D, dtype, device=k.device)
    keep = min(n_full, NB)  # window models only retain the last NB blocks
    if n_full:
        lo, hi = (n_full - keep) * T, n_full * T
        kb = k[:, :, lo:hi].reshape(B, H, keep, T, D)
        vb = v[:, :, lo:hi].reshape(B, H, keep, T, D)
        slots = ((torch.arange(keep, device=k.device) + (n_full - keep)) % NB)
        spec.impl.write_blocks(spec, cache, slots[None].expand(B, keep), kb, vb)
    rem = S - n_full * T
    if rem:
        cache.k_buf[:, :, :rem] = k[:, :, n_full * T:].to(dtype)
        cache.v_buf[:, :, :rem] = v[:, :, n_full * T:].to(dtype)
    cache.n_flushed.fill_(n_full)
    cache.buf_len.fill_(rem)
    return cache


def append(cache: LayerKVCache, k_new: torch.Tensor, v_new: torch.Tensor) -> LayerKVCache:
    """Append one token's KV [B, Hkv, D] at each row's ``buf_len``; a row
    whose buffer fills flushes it into its next ring slot.  In place.

    The Store stage runs on every call: rows that do not flush pass the drop
    sentinel slot ``NB`` and write nothing, so no host-side check of which
    rows flush is needed (the reference skips the encode with a device-side
    ``lax.cond``)."""
    spec = cache.spec
    _dense_only(spec)
    T, NB = spec.block_size, spec.n_blocks
    B = cache.batch
    pos = cache.buf_len.long()  # [B], always < T
    rows = torch.arange(B, device=pos.device)
    cache.k_buf[rows, :, pos] = k_new.to(cache.k_buf.dtype)
    cache.v_buf[rows, :, pos] = v_new.to(cache.v_buf.dtype)
    will_flush = (pos + 1) == T
    slots = torch.where(will_flush, cache.n_flushed.long() % NB,
                        torch.full_like(pos, NB))[:, None]  # [B, 1]
    spec.impl.write_blocks(spec, cache, slots, cache.k_buf[:, :, None],
                           cache.v_buf[:, :, None])
    cache.n_flushed += will_flush.to(torch.int32)
    cache.buf_len.copy_(torch.where(will_flush, torch.zeros_like(pos), pos + 1))
    return cache


def attend(cache: LayerKVCache, q: torch.Tensor, scale: float | None = None,
           backend: str | None = None) -> torch.Tensor:
    """Single-token attention against the cache — the decode entry point.

    q : [B, H, D] with H = Hkv * G (GQA); returns [B, H, D].  Dispatches
    through the attention-backend registry (``repro_torch.kernels.ops``):
    ``fused`` runs the Fetch kernel (its plain version on the CPU), ``xla``
    the blockwise scan below.
    """
    _dense_only(cache.spec)
    return cache.spec.impl.attend_block(cache, q, scale, backend=backend)


def attend_blockwise(cache: LayerKVCache, q: torch.Tensor,
                     scale: float | None = None) -> torch.Tensor:
    """The plain decode path (the ``xla`` backend): a blockwise
    lazily-dequantized flash-decode scan over the store, then the raw buffer
    merged by the two-part softmax combine."""
    from repro_torch.kernels import ref as kref  # late: kernels import core

    B, Hq, D = q.shape
    Hkv = cache.k_buf.shape[1]
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Hkv, G, D).to(torch.float32)
    m, l, acc = _store_scan(cache, qg, scale)
    out = kref.combine_with_buffer_ref(
        acc.reshape(B, Hq, D), m.reshape(B, Hq), l.reshape(B, Hq),
        q, cache.k_buf, cache.v_buf, cache.buf_len, scale=scale)
    return out.to(q.dtype)


def _store_scan(cache: LayerKVCache, qg: torch.Tensor, scale: float):
    """Blockwise flash-decode scan over the flushed store only.

    ``qg``: f32 ``[B, Hkv, G', D]`` — generic in the grouped-query axis, so
    the chunked-prefill path folds its chunk positions into ``G' = C * G``.
    Dequantization folds into the products (``q·(mn + st∘c) = q·mn +
    q·(st∘c)`` and its V mirror), so no dequantized block is formed.
    Returns ``(m, l, acc)``; ``m = NEG_INIT, l = 0`` where nothing is
    flushed."""
    from repro_torch.kernels import ref as kref

    spec = cache.spec
    B, Hkv, G, D = qg.shape
    T, NB = spec.block_size, spec.n_blocks
    span = min(max(1, BLOCKWISE_SPAN_TOKENS // T), NB)
    nb_valid = torch.clamp(cache.n_flushed, max=NB)  # [B]
    f32 = torch.float32
    m = torch.full((B, Hkv, G), kref.NEG_INIT, dtype=f32, device=qg.device)
    l = torch.zeros((B, Hkv, G), dtype=f32, device=qg.device)
    acc = torch.zeros((B, Hkv, G, D), dtype=f32, device=qg.device)
    for n0 in range(0, NB, span):
        # The last (ragged) span clamps its window back; blocks before n0
        # were already consumed, so the mask drops them.
        start = min(n0, NB - span)
        kc, k_mn, k_st, vc, v_mn, v_st = spec.impl.decode_span(spec, cache, start, span)
        has_scales = k_mn is not None
        if has_scales:
            kc = kc * k_st.to(f32)[:, :, :, None, :]
        s = torch.einsum("bhgd,bhxd->bhgx", qg,
                         kc.to(f32).reshape(B, Hkv, span * T, D)
                         ).reshape(B, Hkv, G, span, T)
        if has_scales:
            s = s + torch.einsum("bhgd,bhcd->bhgc", qg, k_mn.to(f32))[..., None]
        s = s * scale
        idx = start + torch.arange(span, device=qg.device)
        ok = (idx[None, :] >= n0) & (idx[None, :] < nb_valid[:, None])  # [B, C]
        okx = ok[:, None, None, :, None]
        s = torch.where(okx, s, torch.full_like(s, kref.NEG_INIT))
        m_new = torch.maximum(m, s.reshape(B, Hkv, G, span * T).amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None, None]) * okx
        l = l * alpha + p.sum(dim=(-2, -1))
        if has_scales:
            pv = p * v_st.to(f32)[:, :, None]
            upd = (torch.einsum("bhgct,bhct->bhg", p, v_mn.to(f32))[..., None]
                   + torch.einsum("bhgx,bhxd->bhgd", pv.reshape(B, Hkv, G, span * T),
                                  vc.to(f32).reshape(B, Hkv, span * T, D)))
        else:
            upd = torch.einsum("bhgx,bhxd->bhgd", p.reshape(B, Hkv, G, span * T),
                               vc.to(f32).reshape(B, Hkv, span * T, D))
        acc = acc * alpha[..., None] + upd
        m = m_new
    return m, l, acc


def attend_chunk(cache: LayerKVCache, q: torch.Tensor, k_new: torch.Tensor,
                 v_new: torch.Tensor, scale: float | None = None) -> torch.Tensor:
    """Attention for one block-chunked prefill step: ``C`` new tokens attend
    the flushed compressed store plus the chunk's own raw K/V causally.

    ``q``: ``[B, C, Hq, D]``; ``k_new``/``v_new``: ``[B, Hkv, C, D]``.  Chunks
    start at block boundaries (the raw buffer is empty).  The store partials
    come from ``_store_scan`` with the chunk axis folded into the query
    group, merged with the intra-chunk causal scores by the two-part
    online-softmax combine."""
    from repro_torch.kernels import ref as kref

    _dense_only(cache.spec)
    B, C, Hq, D = q.shape
    Hkv = k_new.shape[1]
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    f32 = torch.float32
    qf = q.to(f32).reshape(B, C, Hkv, G, D).permute(0, 2, 1, 3, 4)  # [B,Hkv,C,G,D]
    m, l, acc = _store_scan(cache, qf.reshape(B, Hkv, C * G, D), scale)
    m = m.reshape(B, Hkv, C, G)
    l = l.reshape(B, Hkv, C, G)
    acc = acc.reshape(B, Hkv, C, G, D)
    s = torch.einsum("bhcgd,bhxd->bhcgx", qf, k_new.to(f32)) * scale
    causal = (torch.arange(C, device=q.device)[:, None]
              >= torch.arange(C, device=q.device)[None, :])
    mask = causal[None, None, :, None, :]
    s = torch.where(mask, s, torch.full_like(s, kref.NEG_INIT))
    m_new = torch.maximum(m, s.amax(-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None]) * mask
    l_new = l * alpha + p.sum(-1)
    acc_new = acc * alpha[..., None] + torch.einsum("bhcgx,bhxd->bhcgd", p, v_new.to(f32))
    out = acc_new / torch.clamp(l_new, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3, 4).reshape(B, C, Hq, D).to(q.dtype)


def append_chunk(cache: LayerKVCache, k_new: torch.Tensor, v_new: torch.Tensor) -> LayerKVCache:
    """Append one chunk's KV ``[B, Hkv, C, D]`` at a block boundary (the raw
    buffer must be empty).  A full chunk (``C == block_size``) compresses
    straight into the ring; a partial one lands in the raw buffer.  In place."""
    spec = cache.spec
    _dense_only(spec)
    T, NB = spec.block_size, spec.n_blocks
    C = k_new.shape[2]
    dt = cache.k_buf.dtype
    if not 1 <= C <= T:
        raise ValueError(f"chunk of {C} tokens vs block_size {T}")
    if C == T:
        slots = (cache.n_flushed.long() % NB)[:, None]
        spec.impl.write_blocks(spec, cache, slots, k_new[:, :, None].to(dt),
                               v_new[:, :, None].to(dt))
        cache.n_flushed += 1
        return cache
    cache.k_buf[:, :, :C] = k_new.to(dt)
    cache.v_buf[:, :, :C] = v_new.to(dt)
    cache.buf_len.fill_(C)
    return cache
