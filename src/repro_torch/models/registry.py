"""Architecture registry: one API over every model family of the JAX
package (the dense decoder of ``transformer.py``, the mixture of experts
of ``moe.py``, the Griffin hybrid of ``recurrentgemma.py``, the xLSTM of
``xlstm.py`` and the encoder-decoder of ``seamless.py``) and over both
KV-cache layouts, the contiguous per-slot cache and the paged pool (with
the radix prefix cache's suffix prefill and page copy). A family's flags
say what the serving engine may do with it: ``pad_prefill_ok``,
``paged_ok`` and ``prefix_cache_ok`` are all False for the MoE family,
whose capacity routing couples tokens and slots, for the hybrid and the
xLSTM, whose recurrent state absorbs every token and does not page, and
for the encoder-decoder, whose bidirectional encoder takes its frames at
exact length and whose cross cache is indexed by the source.

Each family's ``cache_spec`` gives the contiguous cache's leaves with their
logical axes (``batch``, ``kv_seq``, ...), and ``write_slot`` writes a
request's prefill cache along them: the dense K/V hold the slot on axis 1,
the Griffin and xLSTM recurrent states ``[periods, stack, slots, ...]`` on
axis 2.

``init_params`` is an entry point: it builds on ``cuda`` unless the
caller passes ``device="cpu"``. Serving casts the weights to the compute
dtype once, at load; training keeps fp32 masters
(``init_master_params``) and ``loss_fn`` casts them at every use, as the
JAX package does.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import _batch_np
from repro_torch.device import resolve_device
from repro_torch.models import (moe, recurrentgemma, seamless, transformer,
                                xlstm)

_FAMILY = {"dense": transformer, "moe": moe, "hybrid": recurrentgemma,
           "xlstm": xlstm, "encdec": seamless}


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


def param_axes(cfg: ModelConfig) -> dict:
    """The logical axes (``sharding/rules.py``'s names) of every leaf of
    ``init_params``' tree, in the same structure: the axes tree JAX's
    ``init`` returns, without the leading ``layers`` (and ``stack``) axes of
    its stacked leaves, since the port keeps one dict per layer."""
    return module_for(cfg).param_axes(cfg)


def init_master_params(cfg: ModelConfig, *, seed: int = 0,
                       device=None) -> dict:
    """``init_params``' draws with every leaf kept in fp32: the master
    weights training updates."""
    return init_params(dataclasses.replace(cfg, dtype="float32"), seed=seed,
                       device=device)


def loss_fn(params, cfg: ModelConfig, batch):
    """The next-token cross-entropy of ``batch`` (``tokens``, ``labels``,
    and ``frames`` for a frames frontend) under ``params``, computed in
    ``cfg``'s dtype; see the family's ``forward``."""
    return module_for(cfg).loss_fn(params, cfg, batch)


def make_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0):
    """A synthetic batch as numpy arrays (tests and examples): the data
    pipeline's batch of step 0 (``data.pipeline._batch_np``)."""
    return _batch_np(cfg, batch, seq, seed, 0)


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
    """(leaf shapes and dtypes, leaf logical axes) of the contiguous cache
    for ``cfg``."""
    return module_for(cfg).cache_spec(cfg, batch, seq)


def state_leaves(cfg: ModelConfig) -> tuple:
    """The contiguous cache's leaves that have no ``kv_seq`` axis: state
    that a decode step overwrites whole (the Griffin conv and RG-LRU
    states, all six xLSTM leaves), where K/V leaves get one new row a
    step."""
    _, axes = cache_spec(cfg, 1, 1)
    return tuple(name for name, ax in axes.items() if "kv_seq" not in ax)


def init_cache(cfg: ModelConfig, batch: int, seq: int, device) -> dict:
    """A fresh contiguous cache for ``cfg``: ``batch`` slots of ``seq``
    rows (a ``window``-row ring for a sliding-window config), zeroed but
    for the leaves the family's ``CACHE_FILL`` names (the xLSTM
    stabilisers)."""
    return module_for(cfg).init_cache(cfg, batch, seq, device)


def reset_cache(cfg: ModelConfig, cache: dict) -> dict:
    """Put every leaf of ``cache`` back to ``init_cache``'s values, in
    place."""
    fill = getattr(module_for(cfg), "CACHE_FILL", {})
    for name, t in cache.items():
        t.fill_(fill.get(name, 0.0))
    return cache


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     device) -> dict:
    """A zeroed paged pool for ``cfg``."""
    return module_for(cfg).init_paged_cache(cfg, num_pages, page_size,
                                            device)


def decode_step(params, cfg: ModelConfig, cache, token, pos):
    """One decode step over the contiguous cache (JAX's
    ``registry.decode_step``): ``decode_cached`` with no page table."""
    return module_for(cfg).decode_step(params, cfg, cache, token, pos)


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
    """Write one request's prefill cache (batch 1) into slot ``slot`` of
    the contiguous cache, in place, each leaf along the axes its family's
    ``cache_spec`` names (the JAX ``write_slot``).

    A leaf is written at ``slot`` of its ``batch`` axis. A leaf without a
    ``kv_seq`` axis (recurrent state) is written whole, so nothing of the
    slot's last occupant survives in it. Along ``kv_seq`` the S rows of
    ``new`` go to ``[0, S)``, and rows past S keep what they held: the
    self-attention K/V's ``kv_len`` never reaches them before decode
    overwrites them, but the encoder-decoder's cross K/V are read whole,
    so there the last occupant's rows past S take part (as in JAX). When
    S is more than the slot holds, the last rows are kept. ``prefill`` has
    already laid a prompt longer than the window out as the ring."""
    _, axes = cache_spec(cfg, 1, 1)
    for name, c in cache.items():
        ax, rows = axes[name], new[name]
        dst = c.narrow(ax.index("batch"), slot, 1)
        if "kv_seq" in ax:
            sa = ax.index("kv_seq")
            cap, s = c.shape[sa], rows.shape[sa]
            if s > cap:
                rows = rows.narrow(sa, s - cap, cap)
            dst = dst.narrow(sa, 0, rows.shape[sa])
        dst.copy_(rows)
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


# --------------------------------------------------------------------------
# input specs: (shape, dtype) and logical axes, the dry run's only "data"
# --------------------------------------------------------------------------

def batch_spec(cfg: ModelConfig, batch: int, seq: int):
    """(``{name: (shape, dtype)}``, ``{name: logical axes}``) of a training
    batch (``loss_fn``'s ``tokens``, ``labels`` and, for a frames frontend,
    ``frames``)."""
    tok = ((batch, seq), torch.int32)
    spec = {"tokens": tok, "labels": tok}
    axes = {"tokens": ("batch", None), "labels": ("batch", None)}
    if cfg.frontend == "frames":
        spec = {"frames": ((batch, seq, cfg.d_model), cfg.torch_dtype),
                **spec}
        axes = {"frames": ("batch", None, None), **axes}
    return spec, axes


def prompt_spec(cfg: ModelConfig, batch: int, seq: int):
    """((shape, dtype), logical axes) of a prefill prompt: token ids, or
    ``[batch, seq, d_model]`` frames for a frames frontend."""
    if cfg.frontend == "frames":
        return ((batch, seq, cfg.d_model), cfg.torch_dtype), \
            ("batch", None, None)
    return ((batch, seq), torch.int32), ("batch", None)
