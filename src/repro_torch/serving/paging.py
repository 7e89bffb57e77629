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

Pages carry a reference count (1 while a slot owns them) so that the
prefix cache, which shares pages between slots, can come later without a
new allocator. Allocation is a LIFO free stack, so streams never depend
on allocator ordering noise. ``check()`` asserts the structural
invariants.
"""

from __future__ import annotations

import numpy as np

TRAP_PAGE = 0


class PagePool:
    """Physical-page allocator behind the paged KV cache."""

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
        self.refcnt = [0] * (num_pages + 1)  # index 0 = trap
        # device-facing tables; row = slot, entry = physical page (0 = trap)
        self.table = np.full((slots, pages_per_slot), TRAP_PAGE, np.int32)
        self.version = 0                    # bumped by every table change

    @property
    def num_free(self) -> int:
        """Pages on the free list."""
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        """Pages held by slots."""
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

    def release(self, slot: int) -> None:
        """Return every page of ``slot`` to the free list; its table row
        reverts to the trap page."""
        if not self.owned[slot]:
            return
        self.version += 1
        while self.owned[slot]:
            page = self.owned[slot].pop()
            self.refcnt[page] -= 1
            if self.refcnt[page] == 0:
                self._free.append(page)
        self.table[slot, :] = TRAP_PAGE

    def check(self) -> None:
        """Structural invariants; raises AssertionError."""
        all_owned = [p for pages in self.owned for p in pages]
        assert TRAP_PAGE not in all_owned, "trap page allocated"
        assert self.refcnt[TRAP_PAGE] == 0, "trap page referenced"
        assert len(all_owned) == len(set(all_owned)), "page owned twice"
        free = set(self._free)
        assert len(free) == len(self._free), "free-list duplicate"
        for slot, pages in enumerate(self.owned):
            row = self.table[slot]
            assert list(row[:len(pages)]) == pages, "table/owned mismatch"
            assert (row[len(pages):] == TRAP_PAGE).all(), \
                "stale table entry past owned prefix"
        for p in range(1, self.num_pages + 1):
            assert self.refcnt[p] == (p in all_owned), \
                f"refcnt mismatch on page {p}"
            assert (p in free) == (self.refcnt[p] == 0), \
                f"free/refcnt disagreement on page {p}"
