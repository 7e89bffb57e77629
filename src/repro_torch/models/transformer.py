"""Dense decoder-only transformer (llama family): init, prefill, the
suffix prefill of a radix prefix hit, and the decode step over either
cache layout (the contiguous per-slot cache, a rolling ring for a
sliding-window config, or the paged pool). The port of the JAX
``models/transformer.py``.

Parameters are a plain dict. Where the JAX package stacks layer weights on
a leading axis for ``lax.scan``, the port keeps a list with one dict per
layer and loops in Python. Matrix weights, embeddings and biases are
stored in the compute dtype, cast once at load; the JAX package stores
them in fp32 and casts at every use, which gives the same bits. Norm
weights stay fp32, as the kernels read them in fp32.

The decode steps update the cache in place (JAX donates it to the same
effect) and make no host round trip: positions, the page table and the
lengths stay on the device.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L

# Right-padding a prompt to a bucketed length is exact: the cache is
# positional K/V and attention is causal, so pad positions never reach
# positions < length, and decode's kv_len mask hides them until they are
# overwritten. The serving engine buckets prefill on this flag.
PAD_PREFILL = True

# Paged-KV serving is exact: decode is per-slot independent.
PAGED_OK = True


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _trunc_normal(shape, scale, gen, device):
    """Truncated normal on [-2, 2] times ``scale`` (the JAX package's
    ``layers.dense_init``), drawn in fp32 from ``gen``."""
    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, \
        (1 + math.erf(2 / math.sqrt(2))) / 2
    u = torch.empty(shape, dtype=torch.float32, device=device)
    u.uniform_(2 * lo - 1, 2 * hi - 1, generator=gen)
    return u.erfinv_().mul_(math.sqrt(2) * scale).clamp_(
        -2 * scale, 2 * scale)


def cast_params(tree, cfg: ModelConfig, device):
    """Move a parameter tree to ``device``: norm weights (keys ending in
    ``norm``) in fp32, everything else in the compute dtype."""
    if isinstance(tree, list):
        return [cast_params(t, cfg, device) for t in tree]
    out = {}
    for k, v in tree.items():
        if isinstance(v, (dict, list)):
            out[k] = cast_params(v, cfg, device)
        else:
            dtype = torch.float32 if k.endswith("norm") else cfg.torch_dtype
            out[k] = v.to(device=device, dtype=dtype).contiguous()
    return out


def init(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    """Random parameters with the JAX init's distributions, from ``gen``
    (which must live on ``device``)."""
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def normal(shape, scale):
        return _trunc_normal(shape, scale, gen, device)

    def ones(n):
        return torch.ones(n, device=device)

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    layers = []
    for _ in range(cfg.n_layers):
        attn = {"wq": normal((d, hq, dh), d ** -0.5),
                "wk": normal((d, hkv, dh), d ** -0.5),
                "wv": normal((d, hkv, dh), d ** -0.5),
                "wo": normal((hq, dh, d), (hq * dh) ** -0.5)}
        if cfg.qkv_bias:
            attn.update(bq=zeros(hq, dh), bk=zeros(hkv, dh),
                        bv=zeros(hkv, dh))
        if cfg.qk_norm:
            attn.update(q_norm=ones(dh), k_norm=ones(dh))
        layers.append({
            "attn": attn,
            "mlp": {"w_gateup": normal((d, 2 * cfg.d_ff), d ** -0.5),
                    "w_down": normal((cfg.d_ff, d), cfg.d_ff ** -0.5)},
            "attn_norm": ones(d), "mlp_norm": ones(d)})
    return cast_params({
        "embed": normal((cfg.padded_vocab, d), 1.0),
        "layers": layers,
        "final_norm": ones(d),
        "lm_head": normal((d, cfg.padded_vocab), d ** -0.5),
    }, cfg, device)


# --------------------------------------------------------------------------
# serving: prefill + single-token decode over a KV cache
# --------------------------------------------------------------------------

def cache_spec(cfg: ModelConfig, batch: int, seq: int):
    """Shape and dtype of each leaf of the contiguous cache ``[L, batch,
    S, Hkv, dh]``: S is ``seq``, or ``min(seq, window)`` for a
    sliding-window config, whose cache is a ring laid out at
    ``pos % window``."""
    s = min(seq, cfg.window) if cfg.window else seq
    shape = (cfg.n_layers, batch, s, cfg.n_kv_heads, cfg.head_dim)
    return {"k": (shape, cfg.torch_dtype), "v": (shape, cfg.torch_dtype)}


def init_cache(cfg: ModelConfig, batch: int, seq: int, device) -> dict:
    """A zeroed contiguous cache ``{"k", "v": [L, batch, S, Hkv, dh]}``."""
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, (shape, dtype) in cache_spec(cfg, batch, seq).items()}


def paged_cache_spec(cfg: ModelConfig, num_pages: int, page_size: int):
    """Shape and dtype of each leaf of the paged pool: the contiguous
    cache's (batch, kv_seq) axes become one global (pages, page) pool."""
    if cfg.window:
        raise ValueError("rolling-window caches do not page")
    shape = (cfg.n_layers, num_pages, page_size, cfg.n_kv_heads,
             cfg.head_dim)
    return {"k": (shape, cfg.torch_dtype), "v": (shape, cfg.torch_dtype)}


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     device) -> dict:
    """A zeroed paged pool ``{"k", "v": [L, num_pages, page, Hkv, dh]}``."""
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, (shape, dtype)
            in paged_cache_spec(cfg, num_pages, page_size).items()}


def prefill(params, cfg: ModelConfig, tokens, *, length: int | None = None,
            cache_len: int | None = None):
    """Process a prompt batch ``tokens [B, S]``. Returns (logits ``[B,
    V_pad]`` at position ``length - 1`` -- the true length of a prompt
    right-padded to a bucket -- or at the last position, and the cache
    ``{"k", "v": [L, B, S', Hkv, dh]}``).

    For a sliding-window config and S > window, the cache keeps the last
    ``window`` positions, each at row ``pos % window`` (S' = window).
    ``cache_len`` zero-pads the cache to that many rows (capped at the
    window), ready for later decode steps."""
    b, s = tokens.shape
    hidden = L.embed_tokens(params["embed"], tokens).to(cfg.torch_dtype)
    residual = torch.zeros_like(hidden)
    ks, vs = [], []
    for p in params["layers"]:
        normed, residual = L.add_rms_norm(hidden, residual, p["attn_norm"],
                                          cfg.norm_eps)
        attn_out, (k, v) = L.attention_block(p["attn"], normed, cfg)
        normed, residual = L.add_rms_norm(attn_out, residual, p["mlp_norm"],
                                          cfg.norm_eps)
        hidden = L.mlp_block(p["mlp"], normed)
        ks.append(k)
        vs.append(v)
    ks, vs = torch.stack(ks), torch.stack(vs)
    w = cfg.window
    if w and s > w:
        # the ring: position s - w + j goes to row (s - w + j) % w
        order = torch.argsort(torch.arange(s - w, s, device=ks.device) % w)
        ks, vs = ks[:, :, s - w:][:, :, order], vs[:, :, s - w:][:, :, order]
    target = min(cache_len, w) if (cache_len and w) else cache_len
    if target and target > ks.shape[2]:
        pad = (0, 0, 0, 0, 0, target - ks.shape[2])
        ks = torch.nn.functional.pad(ks, pad)
        vs = torch.nn.functional.pad(vs, pad)
    last = s if length is None else int(length)
    normed, _ = L.add_rms_norm(hidden[:, last - 1:last],
                               residual[:, last - 1:last],
                               params["final_norm"], cfg.norm_eps)
    logits = L.unembed(normed[:, 0], params["lm_head"])
    return logits, {"k": ks, "v": vs}


def prefill_suffix(params, cfg: ModelConfig, tokens, prefix, *,
                   prefix_len: int, length: int | None = None):
    """Prefill only the suffix of a prompt whose first ``prefix_len``
    positions are already cached (a radix prefix hit).

    ``tokens [1, S]``: the suffix, right-padded to its bucket. ``prefix``:
    ``{"k", "v": [L, 1, P, Hkv, dh]}``, rows gathered from the paged pool
    (``registry.read_pages``), valid up to ``prefix_len``. ``length``: the
    true suffix length. Returns (logits ``[1, V_pad]`` at suffix position
    ``length - 1``, the suffix's cache ``{"k", "v": [L, 1, S, Hkv, dh]}``
    for the page scatter). Its norms and MLPs go through the kernels, as
    a full prefill's do."""
    if cfg.window:
        raise ValueError("rolling-window caches do not serve from the "
                         "paged pool, so they never suffix-prefill")
    b, s = tokens.shape
    hidden = L.embed_tokens(params["embed"], tokens).to(cfg.torch_dtype)
    residual = torch.zeros_like(hidden)
    positions = prefix_len + torch.arange(s, device=tokens.device) \
        .expand(b, s)
    cos, sin = L.rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    ks, vs = [], []
    for li, p in enumerate(params["layers"]):
        normed, residual = L.add_rms_norm(hidden, residual, p["attn_norm"],
                                          cfg.norm_eps)
        q, k, v = L.qkv_proj(p["attn"], normed, cfg)
        q = L.apply_rope(q, cos, sin)
        k = L.apply_rope(k, cos, sin)
        attn = L.prefix_attention(q, k, v, prefix["k"][li],
                                  prefix["v"][li], prefix_len)
        attn_out = L.out_proj(p["attn"], attn, normed.dtype)
        normed, residual = L.add_rms_norm(attn_out, residual, p["mlp_norm"],
                                          cfg.norm_eps)
        hidden = L.mlp_block(p["mlp"], normed)
        ks.append(k)
        vs.append(v)
    last = s if length is None else int(length)
    normed, _ = L.add_rms_norm(hidden[:, last - 1:last],
                               residual[:, last - 1:last],
                               params["final_norm"], cfg.norm_eps)
    logits = L.unembed(normed[:, 0], params["lm_head"])
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}


def decode_step(params, cfg: ModelConfig, cache, token, pos):
    """One decode step over the contiguous cache, in place.

    cache: ``{"k","v": [L, B, S, Hkv, dh]}``; token, pos: ``[B]`` int32.
    The new token's K/V goes to row ``pos % window`` (a sliding-window
    ring) or ``pos`` (dropped past S), and attention reads
    ``min(pos + 1, window)`` or ``pos + 1`` rows through the
    ``flash_decode`` kernel. Returns (logits ``[B, V_pad]``, cache)."""
    hidden = L.embed_tokens(params["embed"], token[:, None]) \
        .to(cfg.torch_dtype)                                    # [B,1,D]
    residual = torch.zeros_like(hidden)
    w = cfg.window
    slot = pos % w if w else pos
    kv_len = (torch.clamp(pos + 1, max=w) if w else pos + 1).to(torch.int32)
    cos, sin = L.rope_angles(pos[:, None], cfg.head_dim, cfg.rope_theta)
    for li, p in enumerate(params["layers"]):
        k_l, v_l = cache["k"][li], cache["v"][li]
        normed, residual = L.add_rms_norm(hidden, residual, p["attn_norm"],
                                          cfg.norm_eps)
        q, k_new, v_new = L.qkv_proj(p["attn"], normed, cfg)
        q = L.apply_rope(q, cos, sin)
        k_new = L.apply_rope(k_new, cos, sin)
        L.update_cache(k_l, v_l, k_new[:, 0], v_new[:, 0], slot)
        o = ops.flash_decode_attention(q[:, 0].contiguous(), k_l, v_l,
                                       kv_len=kv_len)
        attn_out = L.out_proj(p["attn"], o[:, None], o.dtype)
        normed, residual = L.add_rms_norm(attn_out, residual, p["mlp_norm"],
                                          cfg.norm_eps)
        hidden = L.mlp_block(p["mlp"], normed)
    normed, _ = L.add_rms_norm(hidden, residual, params["final_norm"],
                               cfg.norm_eps)
    return L.unembed(normed[:, 0], params["lm_head"]), cache


def decode_step_paged(params, cfg: ModelConfig, pool, page_table, token,
                      pos, *, write_mask=None):
    """One decode step over the paged pool, in place.

    pool: ``{"k","v": [L, num_pages, page, Hkv, dh]}``; page_table:
    ``[B, pages_per_slot]`` int32 on the pool's device (unallocated
    entries point at the trap page); token, pos: ``[B]`` int32. The new
    token's K/V goes to ``(page_table[b, pos // page], pos % page)`` and
    attention gathers through the same table. ``write_mask`` (``[B]``
    bool) sends the K/V of the rows it masks to the trap page instead: the
    speculative verify rejects draft positions through it, and the
    logits are unchanged (the caller drops a masked row's). Returns
    (logits ``[B, V_pad]``, pool).
    """
    b = token.shape[0]
    page = pool["k"].shape[2]
    n_pt = page_table.shape[1]
    hidden = L.embed_tokens(params["embed"], token[:, None]) \
        .to(cfg.torch_dtype)                                    # [B,1,D]
    pidx = torch.clamp(pos // page, 0, n_pt - 1).long()
    phys = page_table[torch.arange(b, device=token.device), pidx].long()
    if write_mask is not None:
        # rejected speculative positions write to the trap page
        phys = torch.where(write_mask, phys, torch.zeros_like(phys))
    off = (pos % page).long()
    cos, sin = L.rope_angles(pos[:, None], cfg.head_dim, cfg.rope_theta)
    residual = torch.zeros_like(hidden)
    kv_len = (pos + 1).to(torch.int32)
    for li, p in enumerate(params["layers"]):
        k_l, v_l = pool["k"][li], pool["v"][li]
        normed, residual = L.add_rms_norm(hidden, residual, p["attn_norm"],
                                          cfg.norm_eps)
        q, k_new, v_new = L.qkv_proj(p["attn"], normed, cfg)
        q = L.apply_rope(q, cos, sin)
        k_new = L.apply_rope(k_new, cos, sin)
        k_l[phys, off] = k_new[:, 0].to(k_l.dtype)
        v_l[phys, off] = v_new[:, 0].to(v_l.dtype)
        o = ops.paged_flash_decode_attention(q[:, 0].contiguous(), k_l, v_l,
                                             page_table, kv_len=kv_len)
        attn_out = L.out_proj(p["attn"], o[:, None], o.dtype)
        normed, residual = L.add_rms_norm(attn_out, residual, p["mlp_norm"],
                                          cfg.norm_eps)
        hidden = L.mlp_block(p["mlp"], normed)
    normed, _ = L.add_rms_norm(hidden, residual, params["final_norm"],
                               cfg.norm_eps)
    return L.unembed(normed[:, 0], params["lm_head"]), pool
