"""Architecture registry, dense part: one API over the model families the
port serves (so far the dense decoder of ``transformer.py``).

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


def prefill(params, cfg: ModelConfig, prompt, *, length=None):
    """Prompt logits and KV cache; see the family module."""
    return module_for(cfg).prefill(params, cfg, prompt, length=length)


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     device) -> dict:
    """A zeroed paged pool for ``cfg``."""
    return module_for(cfg).init_paged_cache(cfg, num_pages, page_size,
                                            device)


def decode_cached(params, cfg: ModelConfig, cache, token, pos, *,
                  page_table=None):
    """One decode step over the cache. Only the paged layout is ported, so
    ``page_table`` (``[B, pages_per_slot]`` int32) is required."""
    if page_table is None:
        raise NotImplementedError("the contiguous cache is not ported yet; "
                                  "serve from the paged pool")
    return module_for(cfg).decode_step_paged(params, cfg, cache, page_table,
                                             token, pos)


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
