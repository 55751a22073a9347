"""Paged compressed-block pool (the port of ``repro.core.pool``; DESIGN.md §10).

Dense mode reserves ``max_seq / block_size`` ring blocks per slot up front,
so admission is bounded by ``max_slots`` rather than by the memory the
compressed blocks occupy.  This module supplies the paged alternative at
compression-block granularity:

* one shared **arena** of physical block pages per layer (the store tensors
  of a paged ``LayerKVCache`` have batch extent 1 and ``CacheSpec.pool_pages``
  pages on the block axis instead of a per-row ring),
* a per-row **page table** ``int32 [B, NB]`` mapping each logical ring slot
  to its physical page (``-1`` = unassigned; reads mask it, writes drop),
* a host-side **free-list allocator** (``PagedBlockPool``) that accounts
  occupancy in post-compression bytes per page, so the serving scheduler
  admits by actual memory pressure and oversubscribes slots by the
  compression ratio.

Page allocation is host-side and page indirection is device-side: the
scheduler assigns pages before a row's buffer flush can land, and the
decode step only reads the page table (``lookup_slots`` on the write path,
``span_view`` gathers and the Fetch kernel's table on the read path).  The
functions here update the caches in place, as the rest of the port does.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core.layouts import scatter_slots
from repro_torch.obs.metrics import Counter, Gauge

STORE_FIELDS = ("k_store", "k_min", "k_step", "v_store", "v_min", "v_step")


# ---------------------------------------------------------------------------
# Byte accounting
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=256)
def page_nbytes(spec, n_kv_heads: int, head_dim: int, dtype=torch.bfloat16) -> int:
    """Post-compression bytes one physical page occupies for this layer.

    One page holds one compression block across all six store tensors
    (payload and quantization scales) for all ``n_kv_heads`` heads.  Computed
    from the layout's own store shapes by differencing a one-block and a
    two-block allocation on the ``meta`` device (no memory is touched, and
    the layout dummies cancel)."""

    def nbytes(n_blocks: int) -> int:
        s = dataclasses.replace(spec, mode="dense", pool_pages=0,
                                max_seq=n_blocks * spec.block_size, window=None)
        stores = s.impl.init_store(s, 1, n_kv_heads, head_dim, dtype, torch.device("meta"))
        return sum(t.numel() * t.element_size() for t in stores)

    return nbytes(2) - nbytes(1)


# ---------------------------------------------------------------------------
# Host-side allocator
# ---------------------------------------------------------------------------


class PoolExhausted(RuntimeError):
    """Raised by ``alloc`` when the free list cannot satisfy a request."""


class PagedBlockPool:
    """Refcounted free-list allocator over ``n_pages`` physical block pages.

    Pure host-side bookkeeping (the device only sees page indices through
    the page tables).  ``page_nbytes_per_layer`` is the post-compression
    bytes one page occupies in each layer's arena; a page id is allocated
    once for all layers (a uniform ``block_size`` means every layer flushes
    the same logical block at the same step), so occupancy is
    ``live_pages * sum(page_nbytes_per_layer)``.

    Pages are reference-counted: ``alloc`` hands a page out at refcount 1,
    each sharer ``retain``\\ s it, and every owner drops its reference with
    ``release``; the page returns to the free list when the count reaches
    zero.  A page is never handed out twice while a reference is
    outstanding, never released below zero, and never retained or released
    without having been allocated.

    ``offset`` re-bases the page ids to ``[offset, offset + n_pages)``: each
    data shard of a sharded server (``repro_torch.distributed.serve_shard``)
    hands out ids from its own slice of the global page range, so ids stay
    unique across shards and an id names its shard by integer division.
    """

    def __init__(self, n_pages: int, page_nbytes_per_layer, offset: int = 0):
        if n_pages < 1:
            raise ValueError(f"pool needs >= 1 page, got {n_pages}")
        if offset < 0:
            raise ValueError(f"page-id offset must be >= 0, got {offset}")
        self.n_pages = int(n_pages)
        self.offset = int(offset)
        self.page_nbytes_per_layer = tuple(int(b) for b in page_nbytes_per_layer)
        self._free: list[int] = list(range(self.offset + self.n_pages - 1,
                                           self.offset - 1, -1))
        self._live: set[int] = set()
        self._ref: dict[int, int] = {}  # page -> outstanding references
        # Standalone metric objects, adopted by the Server's MetricsRegistry
        # under ``pool.shard{d}.*`` names.
        self.m_high_water = Gauge()
        self.m_alloc_pages = Counter()
        self.m_freed_pages = Counter()

    @property
    def high_water(self) -> int:
        """Most pages ever simultaneously live."""
        return int(self.m_high_water.value)

    def owns(self, page) -> bool:
        """Whether ``page`` falls in this pool's id range (live or not)."""
        return self.offset <= int(page) < self.offset + self.n_pages

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def live_pages(self) -> int:
        return len(self._live)

    def alloc(self, n: int) -> list[int]:
        """Pop ``n`` pages off the free list (each at refcount 1); raises
        ``PoolExhausted`` (allocating nothing) when fewer than ``n`` are
        free."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            raise PoolExhausted(f"need {n} pages, {len(self._free)}/{self.n_pages} free")
        pages = [self._free.pop() for _ in range(n)]
        self._live.update(pages)
        for p in pages:
            self._ref[p] = 1
        self.m_alloc_pages.inc(n)
        self.m_high_water.set_max(len(self._live))
        return pages

    def retain(self, pages) -> None:
        """Add one reference to each page.  A page that is not live cannot be
        retained."""
        for p in pages:
            p = int(p)
            if p not in self._live:
                raise RuntimeError(f"retaining page {p} that is not live")
            self._ref[p] += 1

    def release(self, pages) -> list[int]:
        """Drop one reference per page; pages whose count reaches zero go back
        on the free list.  Returns the pages actually freed.  Releasing a page
        that is not live (double release, or never allocated) raises."""
        freed: list[int] = []
        for p in pages:
            p = int(p)
            if p not in self._live:
                raise RuntimeError(f"releasing page {p} that is not live")
            self._ref[p] -= 1
            if self._ref[p] == 0:
                del self._ref[p]
                self._live.remove(p)
                self._free.append(p)
                freed.append(p)
        self.m_freed_pages.inc(len(freed))
        return freed

    def refcount(self, page) -> int:
        """Outstanding references on one page (0 = not live)."""
        return self._ref.get(int(page), 0)

    @property
    def bytes_per_page(self) -> int:
        return sum(self.page_nbytes_per_layer)

    @property
    def live_bytes(self) -> int:
        return self.live_pages * self.bytes_per_page

    @property
    def total_bytes(self) -> int:
        return self.n_pages * self.bytes_per_page

    def stats(self) -> dict:
        return {
            "pages_total": self.n_pages,
            "pages_live": self.live_pages,
            "pages_free": self.free_pages,
            "high_water_pages": self.high_water,
            "alloc_pages": self.m_alloc_pages.value,
            "freed_pages": self.m_freed_pages.value,
            "refs_total": sum(self._ref.values()),
            "pages_shared": sum(1 for c in self._ref.values() if c > 1),
            "bytes_per_page": self.bytes_per_page,
            "bytes_live": self.live_bytes,
            "bytes_total": self.total_bytes,
            "bytes_live_by_layer": [self.live_pages * b for b in self.page_nbytes_per_layer],
        }


# ---------------------------------------------------------------------------
# Device-side page indirection (no host reads)
# ---------------------------------------------------------------------------


def lookup_slots(page_tab: torch.Tensor, slots: torch.Tensor, n_blocks: int,
                 pool_pages: int) -> torch.Tensor:
    """Translate logical ring slots ``[B, n]`` to physical pages.

    Keeps the write-drop rule: a slot of ``n_blocks`` (the cache's "this row
    does not flush" sentinel) or an unassigned table entry (``-1``) maps to
    ``pool_pages``, out of range for the arena, so the Store writes nothing.
    That is what makes retired rows harmless: the scheduler clears their
    table row, and any flush their still-running decode attempts lands
    nowhere."""
    phys = torch.gather(page_tab, 1, torch.clamp(slots, 0, n_blocks - 1).long())
    return torch.where((slots >= n_blocks) | (phys < 0),
                       torch.full_like(phys, pool_pages), phys)


class _GatherView:
    """Dense-looking view of a paged cache's stores over one block span.

    Gathers pages ``page_tab[:, start:start+count]`` out of the shared arena
    into per-row ``[B, H, count, ...]`` tensors, so a layout's
    ``decode_span`` reads paged storage unchanged (from block 0 of the
    view).  Unassigned entries clamp to page 0; the caller masks them."""

    def __init__(self, cache, start: int, count: int):
        pages = cache.page_tab[:, start:start + count]
        idx = torch.clamp(pages, 0, cache.spec.pool_pages - 1).long()  # [B, C]
        for f in STORE_FIELDS:
            a = getattr(cache, f)
            if a.dim() >= 4:  # layout dummies (raw's scales) pass through
                a = a[0][:, idx].movedim(1, 0)
            setattr(self, f, a)
        self.head_dim = cache.head_dim


def span_view(cache, start: int, count: int) -> _GatherView:
    """Dense-looking view of blocks ``[start, start+count)`` of every row."""
    return _GatherView(cache, start, count)


def to_dense(cache):
    """Materialize a paged cache as an equivalent dense ``LayerKVCache``
    (every row's pages gathered into a private ring).  A test bridge, never
    on the decode path."""
    from repro_torch.core import cache as kvcache  # late: cache imports this module

    spec = cache.spec
    if not spec.paged:
        return cache
    view = _GatherView(cache, 0, spec.n_blocks)
    return kvcache.LayerKVCache(
        **{f: getattr(view, f) for f in STORE_FIELDS},
        k_buf=cache.k_buf.clone(), v_buf=cache.v_buf.clone(),
        n_flushed=cache.n_flushed.clone(), buf_len=cache.buf_len.clone(),
        page_tab=torch.zeros((1,), dtype=torch.int32, device=cache.k_buf.device),
        spec=dataclasses.replace(spec, mode="dense", pool_pages=0))


def from_dense(cache, pool_pages: int, pages=None):
    """Re-house a dense cache's blocks in a fresh paged arena.

    ``pages``: int ``[B, NB]`` physical page of each ring slot (distinct
    where >= 0; ``-1`` leaves a slot unassigned).  Defaults to the row-major
    identity ``page(b, i) = b * NB + i``.  A test bridge: build a cache state
    with the dense machinery, scatter it into a (shuffled) page set, and
    check that every decode path agrees on the paged storage."""
    from repro_torch.core import cache as kvcache  # late: cache imports this module

    spec = cache.spec
    if spec.paged:
        raise ValueError("from_dense takes a dense cache")
    B, NB = cache.batch, spec.n_blocks
    dev = cache.k_buf.device
    if pages is None:
        if pool_pages < B * NB:
            raise ValueError(f"identity mapping needs {B * NB} pages, pool has {pool_pages}")
        pages = torch.arange(B * NB, dtype=torch.int32).reshape(B, NB)
    pages = torch.as_tensor(pages, dtype=torch.int32).to(dev)
    pspec = dataclasses.replace(spec, mode="paged", pool_pages=pool_pages)
    paged = kvcache.init_layer_cache(pspec, B, cache.k_buf.shape[1], cache.head_dim,
                                     cache.k_buf.dtype, device=dev)
    for f in STORE_FIELDS:
        arena = getattr(paged, f)
        if arena.dim() >= 4:
            scatter_slots(arena, pages, getattr(cache, f))
    for f in ("k_buf", "v_buf", "n_flushed", "buf_len"):
        getattr(paged, f).copy_(getattr(cache, f))
    paged.page_tab.copy_(pages)
    return paged


# ---------------------------------------------------------------------------
# Scheduler-facing splice and page-table maintenance (in place)
# ---------------------------------------------------------------------------


def _copy_row(dst, src, row: int) -> None:
    """Buffers and lengths of the batch-1 ``src`` into row ``row`` of ``dst``."""
    for f in ("k_buf", "v_buf", "n_flushed", "buf_len"):
        getattr(dst, f)[row].copy_(getattr(src, f)[0])


def splice_row(dst, src, row: int, pages: torch.Tensor):
    """Land a batch-1 *dense* cache in row ``row`` of a paged batched cache
    (the paged counterpart of ``model.insert_decode_row``).

    ``pages`` is int32 ``[NB]``: the physical page for logical block ``i``
    (``-1`` for blocks the prompt did not fill; those writes drop).  A solo
    prefill never wraps its ring, so dense slot ``i`` is logical block ``i``
    and the splice is one page scatter per store."""
    for f in STORE_FIELDS:
        d = getattr(dst, f)
        if d.dim() >= 4:  # layout dummies stay
            scatter_slots(d, pages[None], getattr(src, f))
    _copy_row(dst, src, row)
    dst.page_tab[row].copy_(pages)
    return dst


def chunk_view(cache, pages: torch.Tensor, pos0: int):
    """Batch-1 view of one row's chunked prefill that writes the live arena
    in place (DESIGN.md §13).

    ``cache`` is the live paged batched cache, ``pages`` is int32 ``[NB]``
    (the physical page of logical block ``i`` for the blocks this row's
    prefill has flushed or is about to flush, ``-1`` beyond), and ``pos0`` is
    the block-aligned token position the next chunk starts at.  The view
    SHARES the arena store tensors: a chunk appended through it
    (``cache.append_chunk`` -> the Store kernel) quantizes and packs
    straight into the pooled pages.  Its buffers start empty and its page
    table is the single row ``pages``; the live table is untouched, so the
    row stays write-dropped for the decoding batch until ``install_row``."""
    T = cache.spec.block_size
    dev = cache.k_buf.device
    one = (1, *cache.k_buf.shape[1:])
    return dataclasses.replace(
        cache,
        k_buf=torch.zeros(one, dtype=cache.k_buf.dtype, device=dev),
        v_buf=torch.zeros(one, dtype=cache.v_buf.dtype, device=dev),
        n_flushed=torch.full((1,), pos0 // T, dtype=torch.int32, device=dev),
        buf_len=torch.zeros((1,), dtype=torch.int32, device=dev),
        page_tab=pages[None])


def _check_shared_arena(dst, src) -> None:
    for f in STORE_FIELDS:
        if getattr(dst, f) is not getattr(src, f):
            raise ValueError(f"the chunk view's {f} is not the live arena's")


def adopt_stores(dst, src):
    """Fold a ``chunk_view``'s arena stores back into the live cache.  The
    view shares the live store tensors and the Store kernel writes them in
    place, so there is nothing to copy: this checks that the view still
    holds the live arena (a replaced store would lose the chunk's blocks)."""
    _check_shared_arena(dst, src)
    return dst


def install_row(dst, src, row: int, pages: torch.Tensor):
    """Land a finished chunked prefill in row ``row`` of the live cache.

    ``src`` is the final ``chunk_view``: its stores are the live arena after
    the last flush, its batch-1 buffers hold the prompt's sub-block tail,
    and ``pages`` is the row's page table.  The page-table row flips from
    write-drop (-1) to live here, so the next decode step attends the
    prefilled blocks."""
    _check_shared_arena(dst, src)
    _copy_row(dst, src, row)
    dst.page_tab[row].copy_(pages)
    return dst


def gather_pages(cache, pages: torch.Tensor, n_flushed: int):
    """Prefix-hit seed: cached arena pages as a batch-1 *dense* cache at a
    block boundary (DESIGN.md §11).

    ``pages`` is int32 ``[NB]``: the physical page of logical block ``i``
    for the first ``n_flushed`` blocks (``-1`` beyond; those slots gather
    page 0, which ``n_flushed`` keeps out of sight).  The result is the
    state a solo block-chunked prefill of those blocks would have built:
    stores copied bit for bit out of the arena, raw buffer empty, so a
    chunked prefill resumes at block ``n_flushed``.  A new cache; the live
    one is untouched."""
    from repro_torch.core import cache as kvcache  # late: cache imports this module

    idx = torch.clamp(pages, 0, cache.spec.pool_pages - 1).long()
    dev = cache.k_buf.device
    stores = {}
    for f in STORE_FIELDS:
        a = getattr(cache, f)
        stores[f] = a[:, :, idx] if a.dim() >= 4 else a.clone()  # dummies pass
    return kvcache.LayerKVCache(
        **stores,
        k_buf=torch.zeros_like(cache.k_buf[:1]), v_buf=torch.zeros_like(cache.v_buf[:1]),
        n_flushed=torch.full((1,), int(n_flushed), dtype=torch.int32, device=dev),
        buf_len=torch.zeros((1,), dtype=torch.int32, device=dev),
        page_tab=torch.zeros((1,), dtype=torch.int32, device=dev),
        spec=dataclasses.replace(cache.spec, mode="dense", pool_pages=0))


def assign_pages(cache, rows: torch.Tensor, slots: torch.Tensor, pages: torch.Tensor):
    """Point ``page_tab[rows[i], slots[i]] = pages[i]`` (int ``[n]`` each).
    The scheduler calls this just before the decode step that flushes those
    blocks."""
    cache.page_tab[rows, slots] = pages
    return cache


def clear_row(cache, row: int):
    """Unassign every page of one row (retire / preempt): later flushes of
    that slot's idle decode drop, and reads skip it."""
    cache.page_tab[row] = -1
    return cache
