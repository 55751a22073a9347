"""Sharded serving over a ``("data", "model")`` mesh (the port of
``repro.distributed.serve_shard``; DESIGN.md §12).

One Server drives every device of the mesh:

* **"data"** shards the continuous batch: decode slots, page-table rows,
  the raw buffers' batch axis and, in paged mode, the arena's page axis.
  Row ``r`` lives on data shard ``r // (max_slots / n_data)``; shard ``d``
  owns the global page ids ``[d * P_loc, (d+1) * P_loc)``, handed out by its
  own offset ``PagedBlockPool``.  The scheduler allocates a row's pages from
  the row's own shard, so every page a row references is local to it and no
  softmax ever combines across shards: sharded greedy decoding is bit for
  bit the single-device run.
* **"model"** shards KV heads inside attention only.  ``n_model`` divides
  ``n_kv_heads``, so a contiguous chunk of query heads holds whole GQA
  groups.

The reference leaves placement to GSPMD.  The port makes it explicit: each
layer's live cache is a ``ShardedLayerCache``, one ``LayerKVCache`` a
(d, m) shard on that shard's device, holding ``max_slots / n_data`` rows,
``n_kv_heads / n_model`` heads and, paged, ``P_loc`` arena pages addressed
by LOCAL ids (the host mirror, the pools, the prefix index and ``stats()``
keep the global ids).  ``cache.append`` runs the Store of each shard on its
slice of rows and heads; the ``"sharded"`` attention backend runs the inner
backend (the Fetch kernel, or the blockwise scan) on each shard and puts the
outputs back in (row, head) order on the home device, pure data movement.
The embedding, the projections, the FFN and the unembedding run once over
the whole batch on the home device (the mesh's first), with one copy of
the parameters: the matrix products keep M = ``max_slots``, as unsharded,
and ``moe_apply`` ranks its pairs over the whole batch.

A mesh may repeat a device (``launch.mesh.make_serve_mesh(spec,
devices=["cpu"] * 4)``): logical shards then share it, each with tensors of
its own, so one shard's in-place Store never sees another's rows.

The state operations the scheduler calls (``insert_decode_row``,
``insert_decode_row_paged``, ``assign_cache_pages``, ``clear_cache_row``,
``gather_prefix_state``) have the signatures of ``models.model``'s and run
those on each shard's slice.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import cache as kvcache
from repro_torch.core.pool import STORE_FIELDS, PagedBlockPool
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import model as M


# ---------------------------------------------------------------------------
# Mesh bookkeeping
# ---------------------------------------------------------------------------


def mesh_counts(mesh) -> tuple[int, int]:
    """(n_data, n_model); a missing axis counts 1."""
    shape = dict(mesh.shape)
    return int(shape.get("data", 1)), int(shape.get("model", 1))


def validate_serve_mesh(mesh, cfg, max_slots: int) -> tuple[int, int]:
    """Check a serving mesh against the model and the server's shape.
    Returns (n_data, n_model)."""
    names = set(mesh.axis_names)
    if names != {"data", "model"}:
        raise ValueError(
            f"serving mesh wants axes ('data', 'model'), got {tuple(mesh.axis_names)}"
            " — build it with repro_torch.launch.mesh.make_serve_mesh")
    n_d, n_m = mesh_counts(mesh)
    if cfg.family not in ("dense", "moe"):
        raise ValueError(
            f"sharded serving supports dense/moe decode state, not family={cfg.family!r}")
    n_kv = cfg.n_kv_heads or cfg.n_heads
    if n_kv % n_m:
        raise ValueError(
            f"mesh model axis ({n_m}) must divide n_kv_heads ({n_kv}); use a "
            f"({n_d * n_m},1) mesh for pure data parallelism")
    if cfg.n_heads % n_m:
        raise ValueError(f"mesh model axis ({n_m}) must divide n_heads ({cfg.n_heads})")
    if max_slots % n_d:
        raise ValueError(
            f"mesh data axis ({n_d}) must divide max_slots ({max_slots}): "
            "decode slots shard as contiguous per-shard chunks")
    return n_d, n_m


# ---------------------------------------------------------------------------
# Per-shard page accounting
# ---------------------------------------------------------------------------


class ShardedPagedPool:
    """``n_shards`` offset ``PagedBlockPool``\\ s over one global page range.

    Shard ``d`` hands out ids ``[d * per_shard, (d+1) * per_shard)``, the
    pages of data shard ``d``'s arena slice.  ``alloc`` names its shard (the
    scheduler allocates from the row's shard); ``retain`` / ``release`` /
    ``refcount`` route by page id.  The aggregate accounting is the flat
    pool's interface, with ``sum(shard free) == free_pages``."""

    def __init__(self, n_pages: int, page_nbytes_per_layer, n_shards: int):
        if n_shards < 1:
            raise ValueError(f"need >= 1 shard, got {n_shards}")
        if n_pages % n_shards:
            raise ValueError(f"n_pages ({n_pages}) must divide over {n_shards} shards")
        self.n_pages = int(n_pages)
        self.per_shard = self.n_pages // n_shards
        self.page_nbytes_per_layer = tuple(int(b) for b in page_nbytes_per_layer)
        self.shards = [PagedBlockPool(self.per_shard, self.page_nbytes_per_layer,
                                      offset=d * self.per_shard)
                       for d in range(n_shards)]

    def shard_of(self, page) -> int:
        return int(page) // self.per_shard

    def alloc(self, n: int, shard: int = 0) -> list[int]:
        return self.shards[shard].alloc(n)

    def retain(self, pages) -> None:
        for p in pages:
            self.shards[self.shard_of(p)].retain([p])

    def release(self, pages) -> list[int]:
        freed: list[int] = []
        for p in pages:
            freed.extend(self.shards[self.shard_of(p)].release([p]))
        return freed

    def refcount(self, page) -> int:
        return self.shards[self.shard_of(page)].refcount(page)

    @property
    def free_pages(self) -> int:
        return sum(s.free_pages for s in self.shards)

    @property
    def live_pages(self) -> int:
        return sum(s.live_pages for s in self.shards)

    @property
    def high_water(self) -> int:
        return sum(s.high_water for s in self.shards)

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
        per = [s.stats() for s in self.shards]
        agg = {k: sum(p[k] for p in per) for k in per[0]
               if k not in ("bytes_per_page", "bytes_live_by_layer")}
        agg["bytes_per_page"] = self.bytes_per_page
        agg["bytes_live_by_layer"] = [sum(xs) for xs in
                                      zip(*(p["bytes_live_by_layer"] for p in per))]
        return agg

    def shard_stats(self) -> list[dict]:
        return [s.stats() for s in self.shards]


# ---------------------------------------------------------------------------
# Partition specs: which axis of each cache field splits on which mesh axis
# ---------------------------------------------------------------------------


def _field_axes(name: str, arr: torch.Tensor, spec, lead: int, n_d: int,
                n_m: int) -> dict:
    """The axis of one LayerKVCache field that "data" and "model" split (None:
    kept whole), the reference's ``_cache_field_spec`` rule for rule: an
    axis splits only where its extent has the expected role and the mesh
    axis divides it."""
    shp, nd = tuple(arr.shape), arr.dim()
    ax = {"data": None, "model": None}

    def heads_ok(a: int) -> bool:
        return a < nd and shp[a] > 0 and shp[a] % n_m == 0

    if name in STORE_FIELDS:
        if nd - lead < 4:  # layout dummies (raw's scales) stay whole
            return ax
        if heads_ok(lead + 1):
            ax["model"] = lead + 1
        if spec.paged:
            # the shared arena: batch extent 1, pages split over "data"
            if shp[lead + 2] == spec.pool_pages and spec.pool_pages % n_d == 0:
                ax["data"] = lead + 2
        elif shp[lead] % n_d == 0:
            ax["data"] = lead
    elif name in ("k_buf", "v_buf"):
        if shp[lead] % n_d == 0:
            ax["data"] = lead
        if heads_ok(lead + 1):
            ax["model"] = lead + 1
    elif name in ("n_flushed", "buf_len"):
        if shp[lead] % n_d == 0:
            ax["data"] = lead
    elif name == "page_tab" and spec.paged and nd - lead == 2 and shp[lead] % n_d == 0:
        ax["data"] = lead
    return ax


def cache_partition_specs(c: kvcache.LayerKVCache, mesh) -> dict[str, dict]:
    """Field -> ``{"data": axis or None, "model": axis or None}`` for one
    unsharded cache under ``mesh`` (a leading layer axis, where present,
    stays whole)."""
    n_d, n_m = mesh_counts(mesh)
    lead = c.n_flushed.dim() - 1
    return {f: _field_axes(f, getattr(c, f), c.spec, lead, n_d, n_m)
            for f in kvcache.LayerKVCache.FIELDS}


# ---------------------------------------------------------------------------
# The sharded cache
# ---------------------------------------------------------------------------


def _piece(t: torch.Tensor, ax: dict, d: int, m: int, n_d: int, n_m: int) -> torch.Tensor:
    for name, i, n in (("data", d, n_d), ("model", m, n_m)):
        a = ax[name]
        if a is not None:
            size = t.shape[a] // n
            t = t.narrow(a, i * size, size)
    return t


def _local_pages(pt: torch.Tensor, base: int, p_loc: int) -> torch.Tensor:
    """Global page ids -> a shard's local ids; pages of another shard, and
    -1, become -1 (unassigned: the Store drops, the Fetch skips)."""
    mine = (pt >= base) & (pt < base + p_loc)
    return torch.where(mine, pt - base, torch.full_like(pt, -1))


def _global_pages(pt: torch.Tensor, base: int) -> torch.Tensor:
    """A shard's local page ids -> global ids (-1 stays)."""
    return torch.where(pt >= 0, pt + base, pt)


@dataclasses.dataclass
class ShardedLayerCache:
    """One layer's live cache over a serving mesh: ``shards[d][m]`` is the
    ``LayerKVCache`` of data shard ``d`` and model shard ``m``, on its mesh
    device, with local page ids.  ``spec`` is the global spec (its backend
    "sharded", its ``pool_pages`` the global count); ``axes`` maps each
    field to the axes it splits (``cache_partition_specs``); ``home`` is
    where the dense layers run and where attention outputs are gathered."""

    shards: list
    spec: kvcache.CacheSpec
    axes: dict
    home: torch.device

    @property
    def n_data(self) -> int:
        return len(self.shards)

    @property
    def n_model(self) -> int:
        return len(self.shards[0])

    @property
    def rows(self) -> int:
        """Rows a data shard holds."""
        return self.shards[0][0].batch

    @property
    def heads(self) -> int:
        """KV heads a model shard holds."""
        return self.shards[0][0].k_buf.shape[1]

    @property
    def p_loc(self) -> int:
        return self.shards[0][0].spec.pool_pages

    @property
    def batch(self) -> int:
        return self.rows * self.n_data

    @property
    def head_dim(self) -> int:
        return self.shards[0][0].head_dim

    def caches(self) -> list[kvcache.LayerKVCache]:
        return [c for row in self.shards for c in row]

    def nbytes(self) -> int:
        """Bytes of the unsharded cache: a field kept whole on every shard
        (the row lengths on each model shard, a layout's dummies) counts
        once."""
        total = 0
        for f, ax in self.axes.items():
            t = getattr(self.shards[0][0], f)
            n = ((self.n_data if ax["data"] is not None else 1)
                 * (self.n_model if ax["model"] is not None else 1))
            total += t.numel() * t.element_size() * n
        return total

    def append(self, k_new: torch.Tensor, v_new: torch.Tensor) -> "ShardedLayerCache":
        """``cache.append`` on each shard's rows and heads (one Store each)."""
        R, H = self.rows, self.heads
        for d, row in enumerate(self.shards):
            for m, c in enumerate(row):
                dev = c.k_buf.device
                kvcache.append(c, k_new[d * R:(d + 1) * R, m * H:(m + 1) * H].to(dev),
                               v_new[d * R:(d + 1) * R, m * H:(m + 1) * H].to(dev))
        return self

    def attend(self, q: torch.Tensor, scale: float | None = None) -> torch.Tensor:
        """Decode attention of each shard (its own backend, on its device) over
        its rows and its query heads, gathered in (row, head) order on the
        query's device."""
        R, Hq = self.rows, q.shape[1] // self.n_model
        outs = []
        for d, row in enumerate(self.shards):
            parts = []
            for m, c in enumerate(row):
                ql = q[d * R:(d + 1) * R, m * Hq:(m + 1) * Hq].to(c.k_buf.device)
                parts.append(kernel_ops.decode_attention(c, ql, scale).to(q.device))
            outs.append(torch.cat(parts, dim=1))
        return torch.cat(outs, dim=0)

    def global_page_tabs(self) -> list[torch.Tensor]:
        """Paged: each model shard's page tables over all rows, in global ids,
        on the home device (int32 [B, NB])."""
        out = []
        for m in range(self.n_model):
            tabs = []
            for d in range(self.n_data):
                tabs.append(_global_pages(self.shards[d][m].page_tab.to(self.home),
                                          d * self.p_loc))
            out.append(torch.cat(tabs))
        return out

    def gather(self) -> kvcache.LayerKVCache:
        """The unsharded cache on the home device, in global page ids, with
        the shards' own backend."""
        fields = {}
        for f, ax in self.axes.items():
            grid = [[getattr(c, f).to(self.home) for c in row] for row in self.shards]
            if f == "page_tab" and self.spec.paged:
                grid = [[_global_pages(t, d * self.p_loc) for t in row]
                        for d, row in enumerate(grid)]
            rows = [torch.cat(row, dim=ax["model"]) if ax["model"] is not None else row[0]
                    for row in grid]
            fields[f] = torch.cat(rows, dim=ax["data"]) if ax["data"] is not None else rows[0]
        inner = self.shards[0][0].spec.attn_backend
        return kvcache.LayerKVCache(**fields, spec=dataclasses.replace(
            self.spec, attn_backend=inner))


def shard_state(state, mesh):
    """Split an unsharded decode state (dense or MoE: ``{"kv": [...]}``) over
    ``mesh``: each layer becomes a ``ShardedLayerCache`` whose shards hold
    copies of their slices on their mesh devices (never views: shards that
    share a device must not alias), page tables in local ids.  Attention
    outputs gather on the mesh's first device."""
    n_d, n_m = mesh_counts(mesh)
    grid = mesh.devices.reshape(n_d, n_m)
    out = []
    for c in state["kv"]:
        axes = cache_partition_specs(c, mesh)
        if axes["k_buf"]["data"] is None or axes["k_buf"]["model"] is None:
            raise ValueError(
                f"a cache of {c.batch} rows and {c.k_buf.shape[1]} KV heads does not "
                f"split over a ({n_d}, {n_m}) mesh (validate_serve_mesh)")
        if c.spec.paged and axes["k_store"]["data"] is None:
            raise ValueError(f"{c.spec.pool_pages} arena pages do not split over {n_d} "
                             "data shards")
        p_loc = c.spec.pool_pages // n_d if c.spec.paged else 0
        lspec = (dataclasses.replace(c.spec, pool_pages=p_loc) if c.spec.paged
                 else c.spec)
        shards = []
        for d in range(n_d):
            row = []
            for m in range(n_m):
                dev = grid[d, m]
                fields = {f: _piece(getattr(c, f), axes[f], d, m, n_d, n_m)
                          for f in kvcache.LayerKVCache.FIELDS}
                if c.spec.paged:
                    fields["page_tab"] = _local_pages(fields["page_tab"], d * p_loc, p_loc)
                row.append(kvcache.LayerKVCache(
                    **{f: t.to(dev, copy=True) for f, t in fields.items()}, spec=lspec))
            shards.append(row)
        out.append(ShardedLayerCache(
            shards=shards, spec=dataclasses.replace(c.spec, attn_backend="sharded"),
            axes=axes, home=grid[0, 0]))
    return {**state, "kv": out}


def gather_state(state):
    """The unsharded twin of a sharded state, on the home device (global page
    ids, the inner backend): a test and inspection bridge."""
    return {**state, "kv": [c.gather() for c in state["kv"]]}


# ---------------------------------------------------------------------------
# State operations (the signatures of models.model's), shard by shard
# ---------------------------------------------------------------------------


def _sub(state, d: int, m: int) -> dict:
    return {"kv": [c.shards[d][m] for c in state["kv"]]}


def _heads_of(src, m: int, n_m: int, dev) -> dict:
    """Model shard ``m``'s heads of a batch-1 dense state, on ``dev``."""
    def one(c):
        H = c.k_buf.shape[1] // n_m
        fields = {}
        for f in kvcache.LayerKVCache.FIELDS:
            t = getattr(c, f)
            fields[f] = (t.narrow(1, m * H, H) if t.dim() >= 4 else t).to(dev)
        return dataclasses.replace(c, **fields)

    return {"kv": [one(c) for c in src["kv"]]}


def _row(state, row: int) -> tuple[int, int, "ShardedLayerCache"]:
    c0 = state["kv"][0]
    return row // c0.rows, row % c0.rows, c0


def insert_decode_row(dst_state, src_state, row: int):
    """Splice a batch-1 dense state into row ``row``: each model shard of the
    row's data shard takes its heads."""
    d, r, c0 = _row(dst_state, row)
    for m in range(c0.n_model):
        sub = _sub(dst_state, d, m)
        M.insert_decode_row(sub, _heads_of(src_state, m, c0.n_model,
                                           c0.shards[d][m].k_buf.device), r)
    return dst_state


def insert_decode_row_paged(dst_state, src_state, row: int, pages: torch.Tensor):
    """Paged splice into row ``row``: the row's pages (global ids, all of
    the row's own data shard) translate to that shard's local ids."""
    d, r, c0 = _row(dst_state, row)
    for m in range(c0.n_model):
        dev = c0.shards[d][m].k_buf.device
        loc = _local_pages(pages.to(dev), d * c0.p_loc, c0.p_loc)
        M.insert_decode_row_paged(_sub(dst_state, d, m),
                                  _heads_of(src_state, m, c0.n_model, dev), r, loc)
    return dst_state


def assign_cache_pages(state, rows, slots, pages):
    """``page_tab[rows[i], slots[i]] = pages[i]`` in global terms, each entry
    on its row's data shard in local ids."""
    c0 = state["kv"][0]
    rows, slots, pages = (torch.as_tensor(x).cpu() for x in (rows, slots, pages))
    for d in range(c0.n_data):
        sel = (rows // c0.rows) == d
        if not bool(sel.any()):
            continue
        for m in range(c0.n_model):
            dev = c0.shards[d][m].k_buf.device
            M.assign_cache_pages(_sub(state, d, m), (rows[sel] % c0.rows).to(dev),
                                 slots[sel].to(dev),
                                 (pages[sel] - d * c0.p_loc).to(torch.int32).to(dev))
    return state


def clear_cache_row(state, row: int):
    """Unassign row ``row``'s pages on every model shard of its data shard."""
    d, r, c0 = _row(state, row)
    for m in range(c0.n_model):
        M.clear_cache_row(_sub(state, d, m), r)
    return state


def gather_prefix_state(state, pages: torch.Tensor, n_blocks: int):
    """A prefix-hit seed: the hit pages (global ids, all of one data shard,
    ``pages[0]`` among them) gathered from each model shard's arena slice of
    that data shard into one batch-1 dense state with every head, on the
    home device."""
    c0 = state["kv"][0]
    d = int(pages[0]) // c0.p_loc
    parts = []
    for m in range(c0.n_model):
        dev = c0.shards[d][m].k_buf.device
        parts.append(M.gather_prefix_state(
            _sub(state, d, m), _local_pages(pages.to(dev), d * c0.p_loc, c0.p_loc), n_blocks))
    home = c0.home

    def merge(caches):
        return dataclasses.replace(caches[0], **{
            f: (torch.cat([getattr(c, f).to(home) for c in caches], dim=1)
                if getattr(caches[0], f).dim() >= 4 else getattr(caches[0], f).to(home))
            for f in kvcache.LayerKVCache.FIELDS})

    return {"kv": [merge([p["kv"][i] for p in parts]) for i in range(len(parts[0]["kv"]))]}


# ---------------------------------------------------------------------------
# The "sharded" attention backend
# ---------------------------------------------------------------------------

# The backend that a cache pinned to "sharded" but not split over a mesh
# passes through to (the reference's trace-time context).  The Server binds
# it at construction and again at each step.
_CTX: dict = {"inner": "auto"}


def set_serve_mesh(mesh, inner: str | None = "auto") -> None:
    """Bind the inner backend of the ``"sharded"`` backend.  The placement
    itself travels with the state (``shard_state``), so ``mesh`` (a serving
    mesh, or None) is only checked."""
    if mesh is not None and set(mesh.axis_names) != {"data", "model"}:
        raise ValueError(f"serving mesh wants axes ('data', 'model'), got {mesh.axis_names}")
    _CTX["inner"] = inner or "auto"


def _resolve_inner(layout, device: torch.device) -> str:
    inner = kernel_ops.resolve_backend(_CTX["inner"], layout, device)
    return "xla" if inner == "sharded" else inner  # self-nesting (REPRO_ATTN_BACKEND=sharded)


@kernel_ops.register_backend("sharded")
def _sharded_backend(cache, q: torch.Tensor, scale: float | None = None) -> torch.Tensor:
    """Each shard's own backend on its rows and heads; a cache that is not
    split over a mesh (a batch-1 solo state, a one-device server) goes
    straight to the inner backend."""
    if isinstance(cache, ShardedLayerCache):
        return cache.attend(q, scale)
    return kernel_ops._BACKENDS[_resolve_inner(cache.spec.impl, q.device)](cache, q, scale)
