"""Paged KV storage bookkeeping: refcounted page pool + radix prefix cache
(pure Python; a copy of the JAX package's ``repro.serve.paging``).

This module is pure Python — it allocates page *ids* and maps token-id
prefixes to chains of them; the actual KV arrays live on the engine
(`serve/engine.py`), which gathers/scatters pages by index
(`models/transformer_lm.gather_pages` / `store_pages`). Keeping the
bookkeeping free of tensors is what lets the property tests drive
thousands of allocation/eviction orders without running a model
(tests/test_torch_serve.py).

Sharing model (copy-on-write at admission granularity):

  * a page holds ``page_size`` consecutive KV positions and is immutable
    once published to the radix tree — readers only ever *gather* it
  * the radix tree maps token-id prefixes (in full-page chunks) to page
    chains; matching a prefix hands back shared page ids, which the engine
    copies into the request's private slot row — that copy IS the "write"
    of copy-on-write, taken eagerly at admission so decode never touches
    shared storage
  * a request extending a shared prefix therefore writes only its private
    row; at retirement its *new* full pages are frozen into freshly
    allocated pages and published, sharing every existing prefix node
  * refcounts: the tree holds one reference per published page; live
    requests pin (incref) their matched chain from admission to retirement
    so eviction can never recycle a page mid-flight. Eviction only
    considers leaf nodes with refcount 1 (tree-only), LRU first.

KV reusability is exactly prefix-deep: the KV written at position ``i`` is
a pure function of tokens ``0..i`` (per-token activation scales make the
int8 codes row-local; attention at ``i`` only reads positions ``<= i``),
so two requests agreeing on their first ``L`` tokens have bitwise-equal KV
there (in the port: the same codes and accumulators; see
serve/engine.py for what the port claims of the floats around them).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple


class PagePool:
    """Refcounted allocator over ``n_pages`` opaque page ids."""

    def __init__(self, n_pages: int):
        if n_pages < 1:
            raise ValueError(f"n_pages must be >= 1, got {n_pages}")
        self.n_pages = n_pages
        # min-heap: the lowest free id is handed out first (deterministic
        # layouts make the aliasing tests exact)
        self._free: List[int] = list(range(n_pages))
        self._ref: List[int] = [0] * n_pages

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def live(self) -> List[int]:
        """Page ids with a nonzero refcount (sorted)."""
        return [p for p in range(self.n_pages) if self._ref[p] > 0]

    def refcount(self, page: int) -> int:
        return self._ref[page]

    def alloc(self) -> Optional[int]:
        """One page at refcount 1, or None when the pool is exhausted."""
        if not self._free:
            return None
        page = heapq.heappop(self._free)
        self._ref[page] = 1
        return page

    def incref(self, page: int) -> None:
        if self._ref[page] <= 0:
            raise RuntimeError(f"incref on free page {page}")
        self._ref[page] += 1

    def decref(self, page: int) -> None:
        if self._ref[page] <= 0:
            raise RuntimeError(f"decref on free page {page}")
        self._ref[page] -= 1
        if self._ref[page] == 0:
            heapq.heappush(self._free, page)


@dataclasses.dataclass
class _Node:
    """One radix-tree edge: a full page of token ids -> its page."""
    page: int
    last_used: int
    children: Dict[Tuple[int, ...], "_Node"] = dataclasses.field(
        default_factory=dict)


class PrefixCache:
    """Radix tree over token-id prefixes, full-page granularity.

    ``match`` returns the longest cached chain of full pages; ``insert``
    publishes a finished sequence, allocating pages only for the chunks the
    tree does not already hold (the caller copies the KV for exactly the
    returned assignments). Both run in O(len(tokens) / page_size) dict
    hops.
    """

    def __init__(self, page_size: int, n_pages: int):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = page_size
        self.pool = PagePool(n_pages)
        self._root: Dict[Tuple[int, ...], _Node] = {}
        self._clock = 0
        self.hits = 0            # match() calls returning >= 1 page
        self.misses = 0
        self.evictions = 0

    # ---- helpers ---------------------------------------------------------
    def _chunks(self, tokens: Sequence[int]) -> List[Tuple[int, ...]]:
        ps = self.page_size
        toks = [int(t) for t in tokens]
        return [tuple(toks[i:i + ps])
                for i in range(0, len(toks) - len(toks) % ps, ps)]

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _nodes(self):
        """(parent_children_dict, chunk, node) for every node, DFS."""
        stack = [(self._root, c, n) for c, n in self._root.items()]
        while stack:
            parent, chunk, node = stack.pop()
            yield parent, chunk, node
            stack.extend((node.children, c, n)
                         for c, n in node.children.items())

    @property
    def n_nodes(self) -> int:
        return sum(1 for _ in self._nodes())

    def pages(self) -> List[int]:
        """Every page id currently published in the tree (sorted)."""
        return sorted(n.page for _, _, n in self._nodes())

    # ---- the cache operations --------------------------------------------
    def match(self, tokens: Sequence[int]) -> List[int]:
        """Longest cached full-page chain covering a prefix of ``tokens``.

        Returns the page ids in order; the caller owns pinning them
        (``acquire``) before gathering. The matched token count is
        ``len(chain) * page_size``.
        """
        chain: List[int] = []
        level = self._root
        for chunk in self._chunks(tokens):
            node = level.get(chunk)
            if node is None:
                break
            node.last_used = self._tick()
            chain.append(node.page)
            level = node.children
        if chain:
            self.hits += 1
        else:
            self.misses += 1
        return chain

    def acquire(self, chain: Sequence[int]) -> None:
        """Pin a matched chain for the lifetime of a request."""
        for page in chain:
            self.pool.incref(page)

    def release(self, chain: Sequence[int]) -> None:
        for page in chain:
            self.pool.decref(page)

    def insert(self, tokens: Sequence[int]) -> List[Tuple[int, int]]:
        """Publish ``tokens``; returns [(page_id, page_index), ...] for the
        chunks that were newly allocated — the caller must copy positions
        ``[page_index * page_size, (page_index + 1) * page_size)`` of the
        finished sequence into each page. Existing prefix nodes are shared
        untouched. Stops early (keeping the tree prefix-closed) when the
        pool is exhausted and nothing is evictable."""
        new: List[Tuple[int, int]] = []
        pinned: List[int] = []
        level = self._root
        for idx, chunk in enumerate(self._chunks(tokens)):
            node = level.get(chunk)
            if node is None:
                page = self._alloc_with_eviction()
                if page is None:
                    break
                node = _Node(page=page, last_used=self._tick())
                level[chunk] = node
                new.append((page, idx))
            else:
                node.last_used = self._tick()
            # pin the path: an eviction triggered by a *later* chunk's
            # allocation must not tear out a node of this very chain (the
            # just-inserted node is a refcount-1 leaf — evicting it would
            # recycle its page into the next chunk and orphan the subtree)
            self.pool.incref(node.page)
            pinned.append(node.page)
            level = node.children
        for page in pinned:
            self.pool.decref(page)
        return new

    # ---- eviction --------------------------------------------------------
    def _alloc_with_eviction(self) -> Optional[int]:
        page = self.pool.alloc()
        while page is None and self._evict_one():
            page = self.pool.alloc()
        return page

    def _evict_one(self) -> bool:
        """Drop the least-recently-used evictable leaf (refcount 1 — held
        only by the tree; pinned chains of live requests never qualify)."""
        victim = None
        for parent, chunk, node in self._nodes():
            if node.children or self.pool.refcount(node.page) != 1:
                continue
            if victim is None or node.last_used < victim[2].last_used:
                victim = (parent, chunk, node)
        if victim is None:
            return False
        parent, chunk, node = victim
        del parent[chunk]
        self.pool.decref(node.page)
        self.evictions += 1
        return True

    def stats(self) -> Dict[str, int]:
        return {"nodes": self.n_nodes, "free_pages": self.pool.n_free,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions}
