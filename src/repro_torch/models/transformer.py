"""Dense decoder-only transformer (llama family): init, the training
forward and loss, prefill, the suffix prefill of a radix prefix hit, and
the decode step over either cache layout (the contiguous per-slot cache,
a rolling ring for a sliding-window config, or the paged pool). The port
of the JAX ``models/transformer.py``.

Parameters are a plain dict. Where the JAX package stacks layer weights on
a leading axis for ``lax.scan``, the port keeps a list with one dict per
layer and loops in Python. Matrix weights, embeddings and biases are
stored in the compute dtype, cast once at load; the JAX package stores
them in fp32 and casts at every use, which gives the same bits. Norm
weights stay fp32, as the kernels read them in fp32.

Training (``forward``, ``loss_fn``) takes fp32 master weights or the
compute-dtype copies the train step casts from them, and casts at every
use as JAX does; each layer runs under ``layers.remat`` (JAX's
``jax.checkpoint`` with ``nothing_saveable``), so its activations are
recomputed in the backward pass, kernel launches included; the final
norm sits outside the recompute.

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
from repro_torch.sharding import spmd, tp

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


def cast_params(tree, cfg: ModelConfig, device, *, fp32=()):
    """Move a parameter tree to ``device``: norm weights (keys ending in
    ``norm``) and the leaves named in ``fp32`` in fp32, everything else in
    the compute dtype."""
    if isinstance(tree, list):
        return [cast_params(t, cfg, device, fp32=fp32) for t in tree]
    out = {}
    for k, v in tree.items():
        if isinstance(v, (dict, list)):
            out[k] = cast_params(v, cfg, device, fp32=fp32)
        else:
            keep = k.endswith("norm") or k in fp32
            dtype = torch.float32 if keep else cfg.torch_dtype
            out[k] = v.to(device=device, dtype=dtype).contiguous()
    return out


def attn_init(cfg: ModelConfig, normal) -> dict:
    """One layer's attention weights in fp32, drawn through ``normal(shape,
    scale)``, with the QKV bias and the qk-norm where the config has
    them."""
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    attn = {"wq": normal((d, hq, dh), d ** -0.5),
            "wk": normal((d, hkv, dh), d ** -0.5),
            "wv": normal((d, hkv, dh), d ** -0.5),
            "wo": normal((hq, dh, d), (hq * dh) ** -0.5)}
    dev = attn["wq"].device
    if cfg.qkv_bias:
        attn.update(bq=torch.zeros((hq, dh), device=dev),
                    bk=torch.zeros((hkv, dh), device=dev),
                    bv=torch.zeros((hkv, dh), device=dev))
    if cfg.qk_norm:
        attn.update(q_norm=torch.ones(dh, device=dev),
                    k_norm=torch.ones(dh, device=dev))
    return attn


def init_layers(cfg: ModelConfig, gen: torch.Generator, device, layer,
                cast) -> dict:
    """Random parameters from ``gen`` (which must live on ``device``):
    ``layer(normal)`` draws one layer's weights in fp32 through
    ``normal(shape, scale)``, and ``cast`` (a family's ``cast_params``)
    moves them to the compute dtype before the next layer is drawn, so the
    fp32 temporaries are one layer's: a 34B model fits in bf16 on a card
    that its fp32 copy would not fit. The embedding and the output head
    are drawn after the layers, in this order."""
    d = cfg.d_model

    def normal(shape, scale):
        return _trunc_normal(shape, scale, gen, device)

    layers = [cast(layer(normal), cfg, device) for _ in range(cfg.n_layers)]
    dt = cfg.torch_dtype
    return {"embed": normal((cfg.padded_vocab, d), 1.0).to(dt),
            "layers": layers,
            "final_norm": torch.ones(d, device=device),
            "lm_head": normal((d, cfg.padded_vocab), d ** -0.5).to(dt)}


def init(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    """Random parameters with the JAX init's distributions, from ``gen``
    (which must live on ``device``), drawn and cast one layer at a time
    (``init_layers``)."""
    d = cfg.d_model

    def layer(normal):
        return {"attn": attn_init(cfg, normal),
                "mlp": {"w_gateup": normal((d, 2 * cfg.d_ff), d ** -0.5),
                        "w_down": normal((cfg.d_ff, d), cfg.d_ff ** -0.5)},
                "attn_norm": torch.ones(d, device=device),
                "mlp_norm": torch.ones(d, device=device)}

    return init_layers(cfg, gen, device, layer, cast_params)


# the logical axes of each weight, JAX's ``init`` axes trees without the
# leading ``layers`` axis of its stacked layers (the port's are a list)
MLP_AXES = {"w_gateup": ("embed", "mlp"), "w_down": ("mlp", "embed")}


def attn_axes(cfg: ModelConfig) -> dict:
    """The logical axes of ``attn_init``'s leaves."""
    ax = {"wq": ("embed", "heads", "head_dim"),
          "wk": ("embed", "kv_heads", "head_dim"),
          "wv": ("embed", "kv_heads", "head_dim"),
          "wo": ("heads", "head_dim", "embed")}
    if cfg.qkv_bias:
        ax.update(bq=("heads", "head_dim"), bk=("kv_heads", "head_dim"),
                  bv=("kv_heads", "head_dim"))
    if cfg.qk_norm:
        ax.update(q_norm=("head_dim",), k_norm=("head_dim",))
    return ax


def model_axes(**blocks) -> dict:
    """The axes of the embedding, the final norm and the output head,
    with the family's ``blocks`` (lists of per-layer axes trees)."""
    return {"embed": ("embed_vocab", "mlp"), **blocks,
            "final_norm": ("embed",), "lm_head": ("embed", "vocab")}


def layer_axes(cfg: ModelConfig) -> dict:
    """The axes of one dense layer's leaves."""
    return {"attn": attn_axes(cfg), "mlp": dict(MLP_AXES),
            "attn_norm": ("embed",), "mlp_norm": ("embed",)}


def param_axes(cfg: ModelConfig) -> dict:
    """The logical axes of every leaf of ``init``'s tree (the axes tree
    JAX's ``init`` returns, per layer)."""
    return model_axes(layers=[layer_axes(cfg)
                              for _ in range(cfg.n_layers)])


def dense_ffn(p, x):
    """The dense layer's feed-forward sublayer: the SwiGLU MLP."""
    return L.mlp_block(p["mlp"], x)


# --------------------------------------------------------------------------
# training forward
# --------------------------------------------------------------------------

def _block_train(p, hidden, residual, cfg: ModelConfig, ffn):
    hidden, residual = spmd.shard_batch(hidden), spmd.shard_batch(residual)
    normed, residual = L.add_rms_norm(hidden, residual, p["attn_norm"],
                                      cfg.norm_eps)
    attn_out, _ = L.attention_block(p["attn"], normed, cfg)
    normed, residual = L.add_rms_norm(attn_out, residual, p["mlp_norm"],
                                      cfg.norm_eps)
    return ffn(p, normed), residual


def forward(params, cfg: ModelConfig, tokens, *, ffn=dense_ffn):
    """Teacher-forced logits ``[B, S, V_pad]`` in the compute dtype, each
    layer recomputed in the backward pass. ``ffn`` as for ``prefill``."""
    hidden = L.embed_tokens(params["embed"], tokens).to(cfg.torch_dtype)
    residual = torch.zeros_like(hidden)
    for p in params["layers"]:
        hidden, residual = L.remat(_block_train, p, hidden, residual, cfg,
                                   ffn)
    normed, _ = L.add_rms_norm(hidden, residual, params["final_norm"],
                               cfg.norm_eps)
    return L.unembed(normed, params["lm_head"])


def loss_fn(params, cfg: ModelConfig, batch):
    """Next-token cross-entropy; ``batch = {"tokens", "labels": [B,
    S]}``."""
    logits = forward(params, cfg, batch["tokens"])
    return L.ce_loss(logits, batch["labels"], cfg.vocab)


# --------------------------------------------------------------------------
# serving: prefill + single-token decode over a KV cache
# --------------------------------------------------------------------------

CACHE_AXES = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")


def cache_spec(cfg: ModelConfig, batch: int, seq: int):
    """(shape and dtype of each leaf, its logical axes) of the contiguous
    cache ``[L, batch, S, Hkv, dh]``: S is ``seq``, or ``min(seq,
    window)`` for a sliding-window config, whose cache is a ring laid out
    at ``pos % window``."""
    s = min(seq, cfg.window) if cfg.window else seq
    shape = (cfg.n_layers, batch, s, cfg.n_kv_heads, cfg.head_dim)
    return ({"k": (shape, cfg.torch_dtype), "v": (shape, cfg.torch_dtype)},
            {"k": CACHE_AXES, "v": CACHE_AXES})


def init_cache(cfg: ModelConfig, batch: int, seq: int, device) -> dict:
    """A zeroed contiguous cache ``{"k", "v": [L, batch, S, Hkv, dh]}``."""
    spec, _ = cache_spec(cfg, batch, seq)
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, (shape, dtype) in spec.items()}


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


def _last_position(hidden, residual, s: int, length):
    """``[B, 1, D]`` copies of the position ``length - 1`` (a prompt
    right-padded to a bucket) or of the last one, contiguous as the norm
    kernel takes them (a slice of a batch of prompts is not)."""
    last = s if length is None else int(length)
    return (hidden[:, last - 1:last].contiguous(),
            residual[:, last - 1:last].contiguous())


def prefill(params, cfg: ModelConfig, tokens, *, length: int | None = None,
            cache_len: int | None = None, ffn=dense_ffn):
    """Process a prompt batch ``tokens [B, S]``. Returns (logits ``[B,
    V_pad]`` at position ``length - 1`` -- the true length of a prompt
    right-padded to a bucket -- or at the last position, and the cache
    ``{"k", "v": [L, B, S', Hkv, dh]}``).

    For a sliding-window config and S > window, the cache keeps the last
    ``window`` positions, each at row ``pos % window`` (S' = window).
    ``cache_len`` zero-pads the cache to that many rows (capped at the
    window), ready for later decode steps. ``ffn(p_layer, normed)`` is
    the feed-forward sublayer (the MoE family passes its routed
    experts)."""
    b, s = tokens.shape
    hidden = L.embed_tokens(params["embed"], tokens).to(cfg.torch_dtype)
    residual = torch.zeros_like(hidden)
    ks, vs = [], []
    for p in params["layers"]:
        hidden, residual = spmd.shard_batch(hidden), spmd.shard_batch(residual)
        normed, residual = L.add_rms_norm(hidden, residual, p["attn_norm"],
                                          cfg.norm_eps)
        attn_out, (k, v) = L.attention_block(p["attn"], normed, cfg)
        normed, residual = L.add_rms_norm(attn_out, residual, p["mlp_norm"],
                                          cfg.norm_eps)
        hidden = ffn(p, normed)
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
    normed, _ = L.add_rms_norm(*_last_position(hidden, residual, s, length),
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
    normed, _ = L.add_rms_norm(*_last_position(hidden, residual, s, length),
                               params["final_norm"], cfg.norm_eps)
    logits = L.unembed(normed[:, 0], params["lm_head"])
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}


def decode_step(params, cfg: ModelConfig, cache, token, pos, *,
                ffn=dense_ffn):
    """One decode step over the contiguous cache, in place.

    cache: ``{"k","v": [L, B, S, Hkv, dh]}``; token, pos: ``[B]`` int32.
    The new token's K/V goes to row ``pos % window`` (a sliding-window
    ring) or ``pos`` (dropped past S), and attention reads
    ``min(pos + 1, window)`` or ``pos + 1`` rows through the
    ``flash_decode`` kernel. ``ffn`` as for ``prefill``. Returns (logits
    ``[B, V_pad]``, cache)."""
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
        hidden = ffn(p, normed)
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

    Under an active tensor-parallel plan (``sharding.tp``) that shards the
    slot batch over ``data``, each data shard embeds, attends and
    returns the logits of its own rows only, but the pool is whole on
    every data shard (radix-shared pages and swap-out reads need every
    row), so the new K/V rows are all-gathered across ``data`` before the
    pool write: the full table gives the write indices, this shard's rows
    of it the attention's pages. With no plan every ``tp`` call is the
    identity.
    """
    b = token.shape[0]
    page = pool["k"].shape[2]
    n_pt = page_table.shape[1]
    pidx = torch.clamp(pos // page, 0, n_pt - 1).long()
    phys = page_table[torch.arange(b, device=token.device), pidx].long()
    if write_mask is not None:
        # rejected speculative positions write to the trap page
        phys = torch.where(write_mask, phys, torch.zeros_like(phys))
    off = (pos % page).long()
    token_q, pos_q = tp.data_shard(token), tp.data_shard(pos)
    table_q = tp.data_shard(page_table)
    hidden = L.embed_tokens(params["embed"], token_q[:, None]) \
        .to(cfg.torch_dtype)                                    # [B,1,D]
    cos, sin = L.rope_angles(pos_q[:, None], cfg.head_dim, cfg.rope_theta)
    residual = torch.zeros_like(hidden)
    kv_len = (pos_q + 1).to(torch.int32)
    for li, p in enumerate(params["layers"]):
        k_l, v_l = pool["k"][li], pool["v"][li]
        normed, residual = L.add_rms_norm(hidden, residual, p["attn_norm"],
                                          cfg.norm_eps)
        q, k_new, v_new = L.qkv_proj(p["attn"], normed, cfg)
        q = L.apply_rope(q, cos, sin)
        k_new = L.apply_rope(k_new, cos, sin)
        k_l[phys, off] = tp.gather_data(k_new[:, 0]).to(k_l.dtype)
        v_l[phys, off] = tp.gather_data(v_new[:, 0]).to(v_l.dtype)
        o = ops.paged_flash_decode_attention(q[:, 0].contiguous(), k_l, v_l,
                                             table_q, kv_len=kv_len)
        attn_out = L.out_proj(p["attn"], o[:, None], o.dtype)
        normed, residual = L.add_rms_norm(attn_out, residual, p["mlp_norm"],
                                          cfg.norm_eps)
        hidden = L.mlp_block(p["mlp"], normed)
    normed, _ = L.add_rms_norm(hidden, residual, params["final_norm"],
                               cfg.norm_eps)
    return L.unembed(normed[:, 0], params["lm_head"]), pool
