"""Block-aligned prefix-cache index over compressed pages (the port of
``repro.serve.prefix``; DESIGN.md §11).

Serving traffic shares long system prompts and few-shot prefixes.  A
compressed page holds ``block_size`` tokens at the post-compression
footprint, so sharing cached pages reuses prefill work and arena bytes at
once.  The index is a radix tree whose edges are whole compression blocks
(``block_size`` token ids each) and whose nodes each own ONE physical page
of the ``repro_torch.core.pool`` arena: the compressed encoding of that
block, valid for any request whose prompt walks the same token path from
the root (block-chunked admission makes equal-prefix pages bit-identical,
so a cached page and a recomputed one are interchangeable).

Node keys are the raw int32 token bytes of the block, not hashes: two
distinct prefixes never share a page.  Every node holds one pool reference
(``PagedBlockPool.retain`` on insert, ``release`` on eviction), so a page
stays live while the index or any row's page table points at it.  Lookup
and insert stamp the touched path with a logical clock; eviction releases
the least recently used *leaf* first (a parent evicted before its children
would break every cached path through it).

Pure host bookkeeping, like the pool allocator: the device only sees the
page ids the scheduler splices into page tables.
"""

from __future__ import annotations

import numpy as np

from repro_torch.obs.metrics import Counter


class _Node:
    __slots__ = ("key", "page", "parent", "children", "stamp")

    def __init__(self, key: bytes, page: int, parent: "_Node | None"):
        self.key = key
        self.page = page
        self.parent = parent
        self.children: dict[bytes, _Node] = {}
        self.stamp = 0


class PrefixIndex:
    """Radix tree: block-aligned token prefixes -> live arena page ids."""

    def __init__(self, block_size: int):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.block_size = int(block_size)
        self._children: dict[bytes, _Node] = {}  # the root's children
        self._clock = 0
        self._n_blocks = 0
        # Standalone counters, adopted by the Server's MetricsRegistry under
        # ``prefix.index.shard0.*``.
        self.m_inserted_blocks = Counter()
        self.m_evicted_blocks = Counter()

    @property
    def inserted_blocks(self) -> int:
        return self.m_inserted_blocks.value

    @property
    def evicted_blocks(self) -> int:
        return self.m_evicted_blocks.value

    # -- internals ------------------------------------------------------------
    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _keys(self, tokens, n_blocks: int) -> list[bytes]:
        T = self.block_size
        t = np.ascontiguousarray(np.asarray(tokens, np.int32)[: n_blocks * T])
        return [t[i * T : (i + 1) * T].tobytes() for i in range(n_blocks)]

    def _leaves(self) -> list[_Node]:
        out, stack = [], list(self._children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            else:
                out.append(n)
        return out

    # -- queries and mutation ---------------------------------------------------
    def lookup(self, tokens, max_blocks: int) -> list[int]:
        """Page ids of the longest cached block-aligned prefix of ``tokens``,
        at most ``max_blocks`` of them, in block order (possibly empty).  The
        matched path is stamped most recently used, so admission-pressure
        eviction does not reclaim pages about to be spliced."""
        stamp = self._tick()
        pages: list[int] = []
        children = self._children
        for key in self._keys(tokens, max(int(max_blocks), 0)):
            node = children.get(key)
            if node is None:
                break
            node.stamp = stamp
            pages.append(node.page)
            children = node.children
        return pages

    def insert(self, tokens, pages, pool) -> int:
        """Index the first ``len(pages)`` blocks of ``tokens``; each new node
        retains its page in ``pool`` (the index's own reference).  A block
        already indexed keeps its original page (both hold the same bits,
        and the old one keeps its sharers).  Returns the nodes created."""
        stamp = self._tick()
        created = 0
        parent: _Node | None = None
        children = self._children
        for key, page in zip(self._keys(tokens, len(pages)), pages):
            node = children.get(key)
            if node is None:
                node = _Node(key, int(page), parent)
                pool.retain([node.page])
                children[key] = node
                created += 1
                self._n_blocks += 1
                self.m_inserted_blocks.inc()
            node.stamp = stamp
            parent = node
            children = node.children
        return created

    def evict(self, pool, need_free: int, protect=()) -> int:
        """Release LRU leaf blocks until ``pool.free_pages >= need_free`` or
        nothing evictable is left.  ``protect`` holds page ids that must
        survive (a hit path not yet retained by the admitting row).  Returns
        the blocks evicted: an eviction does not always free a page (a block
        a live row still references is only unshared), but it always makes
        progress, since that row's page becomes exclusive and its next
        ring-wrap flush can reuse it in place."""
        protect = frozenset(int(p) for p in protect)
        evicted = 0
        while pool.free_pages < need_free:
            leaves = [n for n in self._leaves() if n.page not in protect]
            if not leaves:
                break
            victim = min(leaves, key=lambda n: n.stamp)
            pool.release([victim.page])
            siblings = (victim.parent.children if victim.parent is not None
                        else self._children)
            del siblings[victim.key]
            self._n_blocks -= 1
            self.m_evicted_blocks.inc()
            evicted += 1
        return evicted

    def indexed_pages(self) -> list[int]:
        """Every node's retained page id (one pool reference each): the
        index's side of the ``InvariantAuditor``'s refcount balance."""
        out, stack = [], list(self._children.values())
        while stack:
            n = stack.pop()
            out.append(n.page)
            stack.extend(n.children.values())
        return out

    # -- reporting ------------------------------------------------------------
    @property
    def n_blocks(self) -> int:
        """Blocks (= nodes = retained pages) indexed now."""
        return self._n_blocks

    def stats(self) -> dict:
        return {
            "blocks": self._n_blocks,
            "inserted_blocks": self.inserted_blocks,
            "evicted_blocks": self.evicted_blocks,
        }

    @staticmethod
    def merge_stats(indexes) -> dict:
        """Sum ``stats()`` over several indexes (a sharded server keeps one
        index a data shard and reports one prefix section)."""
        per = [ix.stats() for ix in indexes]
        keys = per[0] if per else {"blocks": 0, "inserted_blocks": 0,
                                   "evicted_blocks": 0}
        return {k: sum(p[k] for p in per) for k in keys}
