"""Cache-management layer of the serving API: one ``alloc / write / grow
/ evict`` surface over both KV-cache layouts.

``ContiguousCacheManager`` gives every slot its own stripe of a ``[L,
slots, S, Hkv, dh]`` cache (S = ``max_seq``, or the window for a
sliding-window config, whose stripe is a ring; a recurrent family's
leaves, such as the Griffin conv and RG-LRU states, hold the slot on the
axis its ``cache_spec`` names): admission always fits and growth never
runs out. ``PagedCacheManager`` owns the ``PagePool``
bookkeeping (trap page 0, per-slot page tables) and the trap-padded page
vectors prefill admission writes through. ``CacheConfig`` is the
declarative form (``paged=None`` picks the paged pool where the
architecture can page, else the contiguous cache) that ``Engine`` and
``LLMEngine`` resolve with their own cfg/slots/max_seq; ``num_pages``
below full subscription oversubscribes the pool (admission then waits for
pages, and decode growth preempts). ``restore`` / ``pages_of`` / ``read``
serve swap preemption.

The paged manager also keeps the radix prefix cache (``prefix_cache=True``,
the default, where ``registry.prefix_cache_ok``): ``admit_prompt`` maps
the longest cached page-aligned prefix of a prompt read-only into the
slot and reserves private pages for the rest, ``insert_prompt`` records a
slot's written full pages in the tree, and every allocation evicts
unpinned tree pages before it reports the pool dry, so the tree never
costs capacity.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.models import registry
from repro_torch.serving.paging import PagePool
from repro_torch.serving.radix import RadixCache


class CacheManager:
    """What the engine asks of a cache layout; the defaults are the
    contiguous layout's, where every slot always owns its rows."""

    paged = False
    prefix_cache = False

    def __init__(self, cfg, slots: int, max_seq: int, device):
        self.cfg, self.slots, self.max_seq = cfg, slots, max_seq
        self.device = device

    def alloc(self, slot: int, n_tokens: int) -> bool:
        """All-or-nothing hold for a prompt of ``n_tokens``."""
        return True

    def grow(self, slot: int) -> bool:
        """Back one more decode write of ``slot``."""
        return True

    def evict(self, slot: int) -> None:
        """Release the slot's residency."""

    def restore(self, slot: int, n_pages: int) -> bool:
        """Hold ``n_pages`` for a swapped-out request coming back."""
        return True

    def pages_of(self, slot: int):
        """The physical pages ``slot`` owns, or None for the contiguous
        layout."""
        return None

    def read(self, cache, pages):
        """Gather whole pages back into prefill layout (swap-out)."""
        raise NotImplementedError("contiguous slots are never swapped out")

    def infeasible(self, n_tokens: int) -> Optional[str]:
        """Why a request of ``n_tokens`` can never be admitted, or None."""
        return None

    def clear_tree(self) -> int:
        """Crash recovery: drop the prefix tree's references (its KV went
        with the pool). Returns the references dropped."""
        return 0

    def decode(self, params, cache, token, pos, page_table=None,
               write_mask=None):
        """One decode step over the cache, in place. ``write_mask``
        (paged only) sends the masked rows' K/V to the trap page."""
        return registry.decode_cached(params, self.cfg, cache, token, pos,
                                      page_table=page_table,
                                      write_mask=write_mask)

    def backed(self, slot: int, write_pos: int) -> bool:
        """Is ``write_pos`` already backed for ``slot``?"""
        return True

    @property
    def has_free(self) -> bool:
        """True while a decode write can still be backed."""
        return True

    def page_table(self) -> Optional[np.ndarray]:
        """The host page table the next dispatch sends to the device, or
        None for the contiguous layout."""
        return None

    @property
    def table_version(self) -> int:
        """Changes to ``page_table()`` so far."""
        return 0

    def prefill_pages(self, slot: int, n_tokens: int,
                      bucket_len: Optional[int]) -> Optional[np.ndarray]:
        """Physical destinations of a prompt's logical pages, or None for
        the contiguous layout."""
        return None

    def note_step(self, rows_by_slot: dict) -> None:
        """Record one dispatch's occupancy (``{slot: written rows}``)."""

    def stats(self) -> dict:
        """Layout statistics."""
        return {"paged": self.paged}


class ContiguousCacheManager(CacheManager):
    """Every slot permanently owns one stripe of the cache: ``max_seq``
    rows, or a ``window``-row ring for a sliding-window config."""

    def init(self) -> dict:
        """A fresh zeroed device cache."""
        return registry.init_cache(self.cfg, self.slots, self.max_seq,
                                   self.device)

    def write(self, cache, kv, *, slot=None, pages=None):
        """Write one request's prefill cache into its slot, in place."""
        return registry.write_cached(self.cfg, cache, kv, slot=slot)


class PagedCacheManager(CacheManager):
    """A global ``[num_pages + 1, page_size, ...]`` block pool (physical
    page 0 is the trap page) plus per-slot page tables. ``num_pages``
    defaults to full subscription, ``slots * max_seq / page_size``."""

    paged = True

    def __init__(self, cfg, slots: int, max_seq: int, device, *,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 prefix_cache: bool = True):
        if not registry.paged_ok(cfg):
            raise ValueError(f"family {cfg.family!r} (window={cfg.window}) "
                             "cannot serve from a paged pool")
        if max_seq % page_size:
            raise ValueError(f"page_size={page_size} must divide "
                             f"max_seq={max_seq}")
        super().__init__(cfg, slots, max_seq, device)
        self.page_size = page_size
        self.pages_per_slot = max_seq // page_size
        if num_pages is None:
            num_pages = slots * self.pages_per_slot   # full subscription
        self.num_pages = num_pages
        self.pool = PagePool(num_pages, page_size, slots,
                             self.pages_per_slot)
        self.prefix_cache = bool(prefix_cache) \
            and registry.prefix_cache_ok(cfg)
        self.tree = RadixCache(page_size) if self.prefix_cache else None
        self._peak = 0
        self._util_sum = 0.0
        self._frag_sum = 0.0
        self._steps = 0
        self._hit_tokens = 0
        self._query_tokens = 0
        self._cow_copies = 0
        self._tree_evictions = 0

    def init(self) -> dict:
        """A fresh device pool; +1 page for the trap page."""
        return registry.init_paged_cache(self.cfg, self.num_pages + 1,
                                         self.page_size, self.device)

    # -- residency ----------------------------------------------------------
    def _n_pages(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def _reserve(self, slot: int, n: int) -> bool:
        """``alloc_n`` that first evicts unpinned tree pages when the free
        list is short: the tree is a cache, so its unpinned leaves count
        as free."""
        if len(self.pool.owned[slot]) + n > self.pool.pages_per_slot:
            return False
        need = n - self.pool.num_free
        if need > 0:
            if self.tree is None:
                return False
            self._tree_evictions += self.tree.evict(need, self.pool)
            if self.pool.num_free < n:
                return False
        return self.pool.alloc_n(slot, n)

    def alloc(self, slot: int, n_tokens: int) -> bool:
        """All-or-nothing hold for a prompt of ``n_tokens``."""
        return self._reserve(slot, self._n_pages(n_tokens))

    def grow(self, slot: int) -> bool:
        """Back one more decode page; False when the pool is dry."""
        return self._reserve(slot, 1)

    def evict(self, slot: int) -> None:
        """Release the slot's pages."""
        self.pool.release(slot)

    def restore(self, slot: int, n_pages: int) -> bool:
        """All-or-nothing hold of ``n_pages`` fresh private pages for a
        swapped-out request."""
        return self._reserve(slot, n_pages)

    def pages_of(self, slot: int) -> np.ndarray:
        """The physical pages ``slot`` owns, in logical order."""
        return np.asarray(self.pool.owned[slot], np.int64)

    def infeasible(self, n_tokens: int) -> Optional[str]:
        """Why a request of ``n_tokens`` can never be admitted, or None."""
        limit = min(self.pool.pages_per_slot, self.num_pages)
        n = self._n_pages(n_tokens)
        if n > limit:
            return (f"prompt needs {n} pages of {self.page_size} but the "
                    f"pool can hold at most {limit} per request")
        return None

    def clear_tree(self) -> int:
        """Drop every tree reference; pages no slot maps go back to the
        free list. Returns the references dropped."""
        return 0 if self.tree is None else self.tree.clear(self.pool)

    # -- radix prefix cache -------------------------------------------------
    def admit_prompt(self, slot: int, tokens) -> Optional[dict]:
        """Radix-aware admission hold for a prompt: map the longest cached
        page-aligned prefix read-only into ``slot``, reserve private pages
        for the rest, and say what to prefill. None (nothing changed)
        when the pool cannot hold the request; else ``{"n_cached": k,
        "suffix_start": s, "cow": (src, dst) or None}``.

        A match of the whole prompt would put the next decode write in
        the last shared page, so that page is copied to a private one
        first (``cow``) and its tokens prefilled again (``suffix_start``
        backs up one page): the decode step never writes a shared page."""
        n = len(tokens)
        n_total = self._n_pages(n)
        if not self.prefix_cache:
            return {"n_cached": 0, "suffix_start": 0, "cow": None} \
                if self._reserve(slot, n_total) else None
        matched = self.tree.match(tokens)
        k = min(len(matched), n // self.page_size)
        if k == 0:
            if not self._reserve(slot, n_total):
                return None
            self._query_tokens += n
            return {"n_cached": 0, "suffix_start": 0, "cow": None}
        self.pool.map_shared(slot, matched[:k])
        if not self._reserve(slot, n_total - k):
            self.pool.release(slot)       # tree refs keep the pages alive
            return None
        cow = None
        suffix_start = k * self.page_size
        if suffix_start == n:             # the whole prompt is cached
            if not self.pool.num_free:
                if self.tree.evict(1, self.pool) < 1:
                    self.pool.release(slot)
                    return None
                self._tree_evictions += 1
            cow = self.pool.cow(slot, k - 1)
            self._cow_copies += 1
            suffix_start = (k - 1) * self.page_size
        self._hit_tokens += suffix_start
        self._query_tokens += n
        return {"n_cached": k, "suffix_start": suffix_start, "cow": cow}

    def insert_prompt(self, slot: int, tokens, coverage: int) -> None:
        """Record ``slot``'s written full pages in the tree. ``coverage``
        caps the positions that hold valid KV (a request's last emitted
        token never wrote its row)."""
        if not self.prefix_cache:
            return
        n_full = coverage // self.page_size
        if n_full > 0:
            self.tree.insert(tokens[:n_full * self.page_size],
                             self.pool.owned[slot][:n_full], self.pool)

    def prefix_page_vec(self, slot: int, suffix_start: int) -> np.ndarray:
        """The physical pages of the prefix before ``suffix_start``. (The
        JAX package pads them to ``pages_per_slot`` with the trap page to
        keep one compiled shape; eager PyTorch gathers only these.)"""
        return np.asarray(
            self.pool.owned[slot][:suffix_start // self.page_size], np.int64)

    def suffix_pages(self, slot: int, suffix_start: int, n_tokens: int,
                     bucket_len: Optional[int]) -> np.ndarray:
        """Physical destinations of the suffix's logical pages,
        trap-padded to the suffix bucket (cf. ``prefill_pages``)."""
        k0 = suffix_start // self.page_size
        n_real = self._n_pages(n_tokens) - k0
        plen = bucket_len if bucket_len is not None \
            else n_tokens - suffix_start
        pages = np.zeros((max(1, self._n_pages(plen)),), np.int64)
        pages[:n_real] = self.pool.owned[slot][k0:]
        return pages

    # -- device side --------------------------------------------------------
    def write(self, cache, kv, *, slot=None, pages=None):
        """Scatter one request's prefill cache into its pages, in place."""
        return registry.write_cached(self.cfg, cache, kv, pages=pages,
                                     page_size=self.page_size)

    def read(self, cache, pages):
        """Gather whole pages back into prefill layout (swap-out)."""
        return registry.read_pages(self.cfg, cache, pages, self.page_size)

    # -- dispatch-loop queries ----------------------------------------------
    def backed(self, slot: int, write_pos: int) -> bool:
        """Is ``write_pos`` already backed by a page of ``slot``?"""
        return write_pos // self.page_size < len(self.pool.owned[slot])

    @property
    def has_free(self) -> bool:
        """True while the pool has a free page or an evictable tree page."""
        if self.pool.num_free > 0:
            return True
        return self.tree is not None and self.tree.has_evictable(self.pool)

    def page_table(self) -> np.ndarray:
        """The host page table the next dispatch sends to the device."""
        return self.pool.table

    @property
    def table_version(self) -> int:
        """Changes to ``page_table()`` so far."""
        return self.pool.version

    def prefill_pages(self, slot: int, n_tokens: int,
                      bucket_len: Optional[int]) -> np.ndarray:
        """Physical destinations of a prompt's logical pages, trap-padded
        to the bucket."""
        n_real = self._n_pages(n_tokens)
        plen = bucket_len if bucket_len is not None else n_tokens
        pages = np.zeros((max(1, self._n_pages(plen)),), np.int64)
        pages[:n_real] = self.pool.owned[slot]
        return pages

    def note_step(self, rows_by_slot: dict) -> None:
        """Record one dispatch's pool occupancy and the unwritten share of
        the rows of privately held pages (shared prefix pages are full)."""
        in_use = self.pool.pages_in_use
        self._steps += 1
        self._peak = max(self._peak, in_use)
        self._util_sum += in_use / self.num_pages
        ps = self.page_size
        alloc_rows = used = 0
        for slot, rows in rows_by_slot.items():
            shared = self.pool.shared[slot]
            for idx, page in enumerate(self.pool.owned[slot]):
                if page not in shared:
                    alloc_rows += ps
                    used += max(0, min(rows - idx * ps, ps))
        if alloc_rows:
            self._frag_sum += 1.0 - min(used, alloc_rows) / alloc_rows

    def stats(self) -> dict:
        """Pool statistics, and the prefix cache's where it is on."""
        steps = max(self._steps, 1)
        out = {"paged": True, "page_size": self.page_size,
               "num_pages": self.num_pages,
               "peak_pages_in_use": self._peak,
               "page_util_mean": self._util_sum / steps,
               "page_frag_mean": self._frag_sum / steps,
               "prefix_cache": self.prefix_cache}
        if self.prefix_cache:
            out.update({
                "prefix_hit_tokens": self._hit_tokens,
                "prefix_query_tokens": self._query_tokens,
                "prefix_hit_rate":
                    self._hit_tokens / max(self._query_tokens, 1),
                "cow_copies": self._cow_copies,
                "tree_evictions": self._tree_evictions,
                "tree_pages": self.tree.n_pages})
        return out


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Declarative cache-manager choice, resolved against the engine's
    (cfg, slots, max_seq, device). ``paged=None`` picks the paged pool
    where the architecture can page (``registry.paged_ok``), else the
    contiguous cache; ``paged=True`` for one that cannot raises.
    ``num_pages=None`` fully subscribes. ``prefix_cache`` turns the radix
    prefix cache on for a paged manager whose architecture supports it
    (``registry.prefix_cache_ok``); elsewhere it is inert."""

    paged: Optional[bool] = None
    page_size: int = 16
    num_pages: Optional[int] = None
    prefix_cache: bool = True

    def build(self, cfg, slots: int, max_seq: int,
              device) -> CacheManager:
        """The manager this config describes."""
        paged = registry.paged_ok(cfg) if self.paged is None else self.paged
        if paged:
            return PagedCacheManager(cfg, slots, max_seq, device,
                                     page_size=self.page_size,
                                     num_pages=self.num_pages,
                                     prefix_cache=self.prefix_cache)
        return ContiguousCacheManager(cfg, slots, max_seq, device)


def make_cache_manager(spec, cfg, slots: int, max_seq: int,
                       device) -> CacheManager:
    """Resolve ``None`` (defaults), a ``CacheConfig``, or a ready
    instance."""
    if spec is None:
        spec = CacheConfig()
    if isinstance(spec, CacheConfig):
        return spec.build(cfg, slots, max_seq, device)
    return spec
