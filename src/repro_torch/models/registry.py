"""Architecture registry, dense part: one API over the model families the
port serves (so far the dense decoder of ``transformer.py``) and over
both KV-cache layouts, the contiguous per-slot cache and the paged pool
(with the radix prefix cache's suffix prefill and page copy).

``init_params`` is an entry point: it builds on ``cuda`` unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer

_FAMILY = {"dense": transformer}


def module_for(cfg: ModelConfig):
    """The family module serving ``cfg``."""
    try:
        return _FAMILY[cfg.family]
    except KeyError:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet") from None


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None) -> dict:
    """Random parameters for ``cfg`` from ``torch.Generator`` seeded with
    ``seed``, on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return module_for(cfg).init(cfg, gen, dev)


def pad_prefill_ok(cfg: ModelConfig) -> bool:
    """True when prefill is exact under right-padding, so the engine may
    bucket prompt lengths to powers of two."""
    return bool(getattr(module_for(cfg), "PAD_PREFILL", False))


def paged_ok(cfg: ModelConfig) -> bool:
    """True when the arch can serve from a paged KV pool (the family says
    so and there is no rolling window)."""
    return bool(getattr(module_for(cfg), "PAGED_OK", False)) \
        and not cfg.window


def prefix_cache_ok(cfg: ModelConfig) -> bool:
    """True when the arch can reuse radix-cached prefix pages: it serves
    paged and implements ``prefill_suffix``."""
    return paged_ok(cfg) and hasattr(module_for(cfg), "prefill_suffix")


def prefill_suffix(params, cfg: ModelConfig, tokens, prefix, *,
                   prefix_len: int, length=None):
    """Prefill only a prompt's suffix against gathered prefix rows (the
    radix-hit admission); see the family module."""
    return module_for(cfg).prefill_suffix(params, cfg, tokens, prefix,
                                          prefix_len=prefix_len,
                                          length=length)


def prefill(params, cfg: ModelConfig, prompt, *, length=None,
            cache_len=None):
    """Prompt logits and KV cache; see the family module."""
    return module_for(cfg).prefill(params, cfg, prompt, length=length,
                                   cache_len=cache_len)


def cache_spec(cfg: ModelConfig, batch: int, seq: int):
    """Leaf shapes and dtypes of the contiguous cache for ``cfg``."""
    return module_for(cfg).cache_spec(cfg, batch, seq)


def init_cache(cfg: ModelConfig, batch: int, seq: int, device) -> dict:
    """A zeroed contiguous cache for ``cfg``: ``batch`` slots of ``seq``
    rows (a ``window``-row ring for a sliding-window config)."""
    return module_for(cfg).init_cache(cfg, batch, seq, device)


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     device) -> dict:
    """A zeroed paged pool for ``cfg``."""
    return module_for(cfg).init_paged_cache(cfg, num_pages, page_size,
                                            device)


def decode_cached(params, cfg: ModelConfig, cache, token, pos, *,
                  page_table=None, write_mask=None):
    """One decode step against either cache layout: ``page_table=None``
    selects the contiguous per-slot cache, a ``[B, pages_per_slot]`` int32
    table the paged pool. ``write_mask`` (paged only) sends the K/V of the
    rows it masks to the trap page (the speculative verify)."""
    mod = module_for(cfg)
    if page_table is None:
        if write_mask is not None:
            raise ValueError("write_mask requires the paged cache layout "
                             "(the contiguous cache has no trap page)")
        return mod.decode_step(params, cfg, cache, token, pos)
    return mod.decode_step_paged(params, cfg, cache, page_table, token, pos,
                                 write_mask=write_mask)


def write_cached(cfg: ModelConfig, cache, new, *, slot=None, pages=None,
                 page_size=None):
    """Scatter one request's prefill cache into either layout: ``slot``
    for the contiguous cache or ``pages`` (and ``page_size``) for the
    paged pool; exactly one of the two."""
    if (slot is None) == (pages is None):
        raise ValueError("write_cached wants exactly one of slot= / pages=")
    if pages is not None:
        return write_pages(cfg, cache, new, pages, page_size)
    return write_slot(cfg, cache, new, slot)


def write_slot(cfg: ModelConfig, cache, new, slot: int):
    """Write one request's prefill cache (batch 1) into row ``slot`` of
    the contiguous cache, in place.

    ``new`` is ``{"k","v": [L, 1, S, Hkv, dh]}`` from ``prefill``; its
    rows go to ``[0, S)`` of the slot, and rows past S keep what they
    held (decode's ``kv_len`` never reaches them before overwriting).
    When S is more than the slot holds, the last rows are kept, as the
    JAX ``write_slot`` does; ``prefill`` has already laid a prompt longer
    than the window out as the ring."""
    for name, c in cache.items():
        rows = new[name][:, 0]                       # [L, S, Hkv, dh]
        if rows.shape[1] > c.shape[2]:
            rows = rows[:, rows.shape[1] - c.shape[2]:]
        c[:, slot, :rows.shape[1]] = rows.to(c.dtype)
    return cache


def read_pages(cfg: ModelConfig, pool, pages, page_size: int) -> dict:
    """Gather whole pages of the paged pool back into prefill layout,
    ``{"k","v": [L, 1, n * page_size, Hkv, dh]}``: the exact inverse of
    ``write_pages``. Swap preemption reads a victim's pages with this and
    later writes the same bytes back through ``write_pages``, so its
    logical cache is restored bit for bit."""
    out = {}
    for name, p in pool.items():
        g = p[:, pages]                              # [L, n, page, Hkv, dh]
        out[name] = g.reshape(g.shape[0], 1, -1, *g.shape[3:])
    return out


def write_pages(cfg: ModelConfig, pool, new, pages, page_size: int):
    """Scatter one request's prefill cache (batch 1) into whole pool pages,
    in place.

    ``new`` is ``{"k","v": [L, 1, S, Hkv, dh]}`` from ``prefill``; ``pages``
    is an ``[n]`` int64 tensor of physical destinations for the prompt's
    logical pages ``0..n-1``. The rows are zero-padded or cut to ``n *
    page_size``. Entries may repeat the trap page (bucket tail past the
    allocated prefix): duplicate destinations only ever carry masked pad
    rows.
    """
    n_pages = pages.shape[0]
    target = n_pages * page_size
    for name, p in pool.items():
        rows = new[name][:, 0]                       # [L, S, Hkv, dh]
        s = rows.shape[1]
        if s < target:
            rows = torch.nn.functional.pad(
                rows, (0, 0, 0, 0, 0, target - s))
        rows = rows[:, :target]
        p[:, pages] = rows.reshape(rows.shape[0], n_pages, page_size,
                                   *rows.shape[2:]).to(p.dtype)
    return pool


def copy_pages(cfg: ModelConfig, pool, src: int, dst: int):
    """Copy physical page ``src`` into ``dst`` on every leaf of the paged
    pool, in place (copy-on-write)."""
    for p in pool.values():
        p[:, dst].copy_(p[:, src])
    return pool
