"""Radix prefix cache over the paged KV pool (SGLang's RadixAttention), a
host-only copy of the JAX package's ``serving/radix.py``.

Maps token-prefix paths to **full** physical pages: every tree edge is one
page-sized token chunk, and the node at the end of the edge owns the
physical page holding that chunk's KV. Matching is therefore page-aligned
by construction — a request can only reuse a cached prefix in whole-page
units, which is exactly the granularity the paged decode step addresses.

The tree holds one external reference (``pool.retain``) per node page, so
a cached page survives the releasing of every slot that wrote or mapped
it. Eviction is LRU over *unpinned leaves*: a leaf whose page has
refcount 1 (only the tree's own ref) may be dropped; a page also mapped by
any live slot has refcount >= 2 and is never reclaimed. Victims are chosen
by oldest ``last_use`` (monotonic counter, deterministic — goldens must
not depend on wall-clock), with the physical page id breaking ties.

The tree never touches device memory: inserts record pages some slot
already wrote, matches hand back page ids for the admission path to map
read-only (``pool.map_shared``), and eviction just drops refs.
"""

from __future__ import annotations

from repro_torch.serving.paging import PagePool


class _Node:
    __slots__ = ("chunk", "page", "children", "parent", "last_use")

    def __init__(self, chunk, page, parent):
        self.chunk = chunk          # tuple of page_size token ids (root: ())
        self.page = page            # physical page holding this chunk's KV
        self.children = {}          # chunk tuple -> _Node
        self.parent = parent
        self.last_use = 0


class RadixCache:
    """Radix tree over finished prompts, one node per full KV page."""

    def __init__(self, page_size: int):
        self.page_size = page_size
        self.root = _Node((), None, None)
        self._clock = 0

    # -- queries ------------------------------------------------------------

    def _chunks(self, tokens):
        ps = self.page_size
        n_full = len(tokens) // ps
        return [tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])
                for i in range(n_full)]

    def match(self, tokens) -> list[int]:
        """Longest cached page-aligned prefix of ``tokens``; returns the
        physical pages along the path and freshens their LRU stamps."""
        self._clock += 1
        node, pages = self.root, []
        for chunk in self._chunks(tokens):
            child = node.children.get(chunk)
            if child is None:
                break
            child.last_use = self._clock
            pages.append(child.page)
            node = child
        return pages

    def insert(self, tokens, pages: list[int], pool: PagePool) -> list[bool]:
        """Record ``tokens``'s full-page chunks as cached in ``pages``
        (the physical pages some slot just wrote / mapped, in order).
        New nodes retain their page; chunks already present keep the
        tree's existing page. Returns per-chunk "newly inserted" flags."""
        self._clock += 1
        node, new = self.root, []
        for chunk, page in zip(self._chunks(tokens), pages):
            child = node.children.get(chunk)
            if child is None:
                child = _Node(chunk, page, node)
                pool.retain(page)
                node.children[chunk] = child
                new.append(True)
            else:
                new.append(False)
            child.last_use = self._clock
            node = child
        return new

    # -- eviction -----------------------------------------------------------

    def _evictable_leaves(self, pool: PagePool):
        out, stack = [], [self.root]
        while stack:
            node = stack.pop()
            for child in node.children.values():
                if child.children:
                    stack.append(child)
                elif pool.refcnt[child.page] == 1:   # only the tree's ref
                    out.append(child)
        return out

    def evict(self, need: int, pool: PagePool) -> int:
        """LRU-drop unpinned leaves until ``need`` pages were freed (or no
        candidate remains). Returns the number actually freed."""
        freed = 0
        while freed < need:
            leaves = self._evictable_leaves(pool)
            if not leaves:
                break
            victim = min(leaves, key=lambda n: (n.last_use, n.page))
            pool.drop(victim.page)
            del victim.parent.children[victim.chunk]
            freed += 1
        return freed

    def has_evictable(self, pool: PagePool) -> bool:
        """True when some leaf holds only the tree's reference."""
        return bool(self._evictable_leaves(pool))

    def clear(self, pool: PagePool) -> int:
        """Drop every tree reference (crash recovery: the cached KV died
        with the device pool, so the whole tree is poisoned). Unlike
        ``evict`` this also drops interior nodes and pages that live
        slots still map — the *tree's* ref goes away; slot mappings keep
        their own refs. Returns the number of refs dropped."""
        dropped = 0
        for page in self.pages():
            pool.drop(page)
            dropped += 1
        self.root = _Node((), None, None)
        self._clock = 0
        return dropped

    # -- stats --------------------------------------------------------------

    def pages(self) -> list[int]:
        """Every page the tree holds."""
        out, stack = [], [self.root]
        while stack:
            node = stack.pop()
            for child in node.children.values():
                out.append(child.page)
                stack.append(child)
        return out

    @property
    def n_pages(self) -> int:
        """How many pages the tree holds."""
        return len(self.pages())
