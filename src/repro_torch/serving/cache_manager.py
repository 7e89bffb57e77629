"""Cache-management layer of the serving API: one ``alloc / write / grow
/ evict`` surface over both KV-cache layouts.

``ContiguousCacheManager`` gives every slot its own stripe of a ``[L,
slots, S, Hkv, dh]`` cache (S = ``max_seq``, or the window for a
sliding-window config, whose stripe is a ring): admission always fits
and growth never runs out. ``PagedCacheManager`` owns the ``PagePool``
bookkeeping (trap page 0, per-slot page tables) and the trap-padded page
vectors prefill admission writes through. ``CacheConfig`` is the
declarative form (``paged=None`` picks the paged pool where the
architecture can page, else the contiguous cache) that ``Engine`` and
``LLMEngine`` resolve with their own cfg/slots/max_seq; ``num_pages``
below full subscription oversubscribes the pool (admission then waits for
pages, and decode growth preempts). ``restore`` / ``pages_of`` / ``read``
serve swap preemption. The radix prefix cache is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.models import registry
from repro_torch.serving.paging import PagePool


class CacheManager:
    """What the engine asks of a cache layout; the defaults are the
    contiguous layout's, where every slot always owns its rows."""

    paged = False

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

    def decode(self, params, cache, token, pos, page_table=None):
        """One decode step over the cache, in place."""
        return registry.decode_cached(params, self.cfg, cache, token, pos,
                                      page_table=page_table)

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

    def note_step(self) -> None:
        """Record one dispatch's occupancy."""

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
                 page_size: int = 16, num_pages: Optional[int] = None):
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
        self._peak = 0
        self._util_sum = 0.0
        self._steps = 0

    def init(self) -> dict:
        """A fresh device pool; +1 page for the trap page."""
        return registry.init_paged_cache(self.cfg, self.num_pages + 1,
                                         self.page_size, self.device)

    # -- residency ----------------------------------------------------------
    def _n_pages(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def alloc(self, slot: int, n_tokens: int) -> bool:
        """All-or-nothing hold for a prompt of ``n_tokens``."""
        return self.pool.alloc_n(slot, self._n_pages(n_tokens))

    def grow(self, slot: int) -> bool:
        """Back one more decode page; False when the pool is empty."""
        return self.pool.alloc_n(slot, 1)

    def evict(self, slot: int) -> None:
        """Release the slot's pages."""
        self.pool.release(slot)

    def restore(self, slot: int, n_pages: int) -> bool:
        """All-or-nothing hold of ``n_pages`` for a swapped-out request."""
        return self.pool.alloc_n(slot, n_pages)

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
        """True while the pool has a free page."""
        return self.pool.num_free > 0

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

    def note_step(self) -> None:
        """Record one dispatch's pool occupancy."""
        in_use = self.pool.pages_in_use
        self._steps += 1
        self._peak = max(self._peak, in_use)
        self._util_sum += in_use / self.num_pages

    def stats(self) -> dict:
        """Pool statistics."""
        return {"paged": True, "page_size": self.page_size,
                "num_pages": self.num_pages,
                "peak_pages_in_use": self._peak,
                "page_util_mean": self._util_sum / max(self._steps, 1)}


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Declarative cache-manager choice, resolved against the engine's
    (cfg, slots, max_seq, device). ``paged=None`` picks the paged pool
    where the architecture can page (``registry.paged_ok``), else the
    contiguous cache; ``paged=True`` for one that cannot raises.
    ``num_pages=None`` fully subscribes."""

    paged: Optional[bool] = None
    page_size: int = 16
    num_pages: Optional[int] = None

    def build(self, cfg, slots: int, max_seq: int,
              device) -> CacheManager:
        """The manager this config describes."""
        paged = registry.paged_ok(cfg) if self.paged is None else self.paged
        if paged:
            return PagedCacheManager(cfg, slots, max_seq, device,
                                     page_size=self.page_size,
                                     num_pages=self.num_pages)
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
