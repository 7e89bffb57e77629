"""Host-side page allocator for the paged KV pool.

The device holds one global ``[num_pages + 1, page_size, ...]`` block pool
per cache leaf; this class owns the host bookkeeping: which physical pages
are free, which slot owns which pages, and the per-slot page tables the
decode step reads each dispatch. ``version`` counts the changes to the
tables, so the engine copies them to the device only when they changed.

Physical page 0 is a reserved **trap page**: it is never allocated, and
every unassigned page-table entry points at it. The decode step writes
the new token's K/V for *every* slot (idle ones included), so a slot
whose request finished keeps writing somewhere until it is re-admitted;
routing those writes into the trap page is what makes freeing and reusing
a finished request's pages safe. Trap contents are garbage by design and
are only ever reachable through masked (``>= kv_len``) positions.

Pages are **refcounted** so the radix prefix cache can share them: a
page's refcount is the number of slot table entries mapping it plus its
external (radix-tree) references. ``alloc`` / ``alloc_n`` hand out
private pages (refcount 1); ``map_shared`` maps live pages read-only into
another slot's table; ``retain`` / ``drop`` manage the tree's references;
``cow`` repoints one table entry at a fresh private page (the device copy
is the caller's). A page returns to the free list exactly when its
refcount reaches zero, so ``release`` also rolls back a partly built
mapping. Allocation is a LIFO free stack, so streams never depend on
allocator ordering noise. ``check()`` asserts the structural invariants,
and, given each resident slot's next write position, that no slot's
decode write lands in a page it maps shared.
"""

from __future__ import annotations

import numpy as np

TRAP_PAGE = 0


class PagePool:
    """Refcounted physical-page allocator behind the paged KV cache."""

    def __init__(self, num_pages: int, page_size: int, slots: int,
                 pages_per_slot: int):
        if num_pages < pages_per_slot:
            raise ValueError(
                f"num_pages={num_pages} cannot hold even one full-length "
                f"request ({pages_per_slot} pages of {page_size})")
        self.num_pages = num_pages          # usable (excludes the trap page)
        self.page_size = page_size
        self.pages_per_slot = pages_per_slot
        # physical ids are 1..num_pages; pop() hands out ascending ids first
        self._free = list(range(num_pages, 0, -1))
        self.owned: list[list[int]] = [[] for _ in range(slots)]
        # pages a slot maps but does not own alone (read-only prefix
        # pages): decode never writes them in place
        self.shared: list[set[int]] = [set() for _ in range(slots)]
        # refcnt[p] = (table entries mapping p) + ext[p]; index 0 = trap
        self.refcnt = [0] * (num_pages + 1)
        self._ext = [0] * (num_pages + 1)   # radix-tree references
        # device-facing tables; row = slot, entry = physical page (0 = trap)
        self.table = np.full((slots, pages_per_slot), TRAP_PAGE, np.int32)
        self.version = 0                    # bumped by every table change

    @property
    def num_free(self) -> int:
        """Pages on the free list."""
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        """Pages held by slots or by the tree."""
        return self.num_pages - len(self._free)

    def alloc(self, slot: int) -> bool:
        """Grow ``slot`` by one page; False when the pool is exhausted."""
        if not self._free:
            return False
        i = len(self.owned[slot])
        if i >= self.pages_per_slot:
            raise RuntimeError(f"slot {slot} already holds its max "
                               f"{self.pages_per_slot} pages")
        page = self._free.pop()
        self.refcnt[page] = 1
        self.owned[slot].append(page)
        self.table[slot, i] = page
        self.version += 1
        return True

    def alloc_n(self, slot: int, n: int) -> bool:
        """All-or-nothing: grow ``slot`` by ``n`` pages or change nothing."""
        if n > len(self._free) or len(self.owned[slot]) + n \
                > self.pages_per_slot:
            return False
        for _ in range(n):
            self.alloc(slot)
        return True

    def map_shared(self, slot: int, pages: list[int]) -> None:
        """Append live ``pages`` read-only to ``slot``'s table; they keep
        their other owners, and gain one mapping reference each."""
        if len(self.owned[slot]) + len(pages) > self.pages_per_slot:
            raise RuntimeError(f"slot {slot} cannot map {len(pages)} more "
                               f"pages (max {self.pages_per_slot})")
        for page in pages:
            assert page != TRAP_PAGE and self.refcnt[page] >= 1, \
                f"map_shared of dead page {page}"
            i = len(self.owned[slot])
            self.refcnt[page] += 1
            self.owned[slot].append(page)
            self.shared[slot].add(page)
            self.table[slot, i] = page
        self.version += 1

    def retain(self, page: int) -> None:
        """Add one external (radix-tree) reference to a live page."""
        assert page != TRAP_PAGE and self.refcnt[page] >= 1, \
            f"retain of dead page {page}"
        self._ext[page] += 1
        self.refcnt[page] += 1

    def drop(self, page: int) -> None:
        """Drop one external reference; frees the page at refcount 0."""
        assert self._ext[page] >= 1, f"drop of unretained page {page}"
        self._ext[page] -= 1
        self._unref(page)

    def _unref(self, page: int) -> None:
        self.refcnt[page] -= 1
        if self.refcnt[page] == 0:
            self._free.append(page)

    def cow(self, slot: int, idx: int) -> tuple[int, int]:
        """Copy-on-write: repoint ``slot``'s entry ``idx`` (a shared page)
        at a fresh private page. Returns ``(src, dst)`` for the device
        page copy. The caller makes sure a page is free."""
        old = self.owned[slot][idx]
        assert old in self.shared[slot], f"cow of private page {old}"
        assert self._free, "cow with no free page (the caller evicts first)"
        new = self._free.pop()
        self.refcnt[new] = 1
        self.owned[slot][idx] = new
        self.table[slot, idx] = new
        self.shared[slot].discard(old)
        self._unref(old)
        self.version += 1
        return old, new

    def release(self, slot: int) -> None:
        """Drop every mapping of ``slot``: pages whose refcount reaches
        zero return to the free list (shared prefix pages live on through
        their tree references). The table row reverts to the trap page."""
        if not self.owned[slot]:
            return
        self.version += 1
        while self.owned[slot]:
            self._unref(self.owned[slot].pop())
        self.shared[slot].clear()
        self.table[slot, :] = TRAP_PAGE

    def tree_pages(self) -> set:
        """Pages that hold an external (radix-tree) reference."""
        return {p for p in range(1, self.num_pages + 1) if self._ext[p]}

    def check(self, writes: dict | None = None) -> None:
        """Structural and refcount invariants; raises AssertionError.
        ``writes`` maps resident slots to their next decode write
        position: each must fall in a page the slot owns privately (or in
        none yet, which the engine grows before the step)."""
        all_owned = [p for pages in self.owned for p in pages]
        assert TRAP_PAGE not in all_owned, "trap page allocated"
        assert self.refcnt[TRAP_PAGE] == 0 and self._ext[TRAP_PAGE] == 0, \
            "trap page referenced"
        free = set(self._free)
        assert len(free) == len(self._free), "free-list duplicate"
        maps: dict = {}                 # page -> table mappings
        for slot, pages in enumerate(self.owned):
            assert len(pages) == len(set(pages)), \
                f"slot {slot} maps a page twice"
            assert self.shared[slot] <= set(pages), \
                f"slot {slot} shared set not within owned"
            for p in pages:
                maps[p] = maps.get(p, 0) + 1
            row = self.table[slot]
            assert list(row[:len(pages)]) == pages, "table/owned mismatch"
            assert (row[len(pages):] == TRAP_PAGE).all(), \
                "stale table entry past owned prefix"
        for p in range(1, self.num_pages + 1):
            assert self._ext[p] >= 0, f"negative ext count on page {p}"
            assert self.refcnt[p] == maps.get(p, 0) + self._ext[p], \
                f"refcnt mismatch on page {p}"
            assert (p in free) == (self.refcnt[p] == 0), \
                f"free/refcnt disagreement on page {p}"
        for p, n in maps.items():
            if n >= 2:
                # the slot that wrote a page keeps it private; every later
                # mapper holds it read-only
                private = sum(1 for slot, pages in enumerate(self.owned)
                              if p in pages and p not in self.shared[slot])
                assert private <= 1, \
                    f"page {p} mapped writable by {private} slots"
        for slot, pos in (writes or {}).items():
            idx = pos // self.page_size
            if idx < len(self.owned[slot]):
                assert self.owned[slot][idx] not in self.shared[slot], \
                    f"slot {slot} would write position {pos} into shared " \
                    f"page {self.owned[slot][idx]}"
