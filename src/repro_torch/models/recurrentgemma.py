"""RecurrentGemma (Griffin): RG-LRU recurrent blocks and local MQA
attention in a 2:1 pattern [arXiv:2402.19427]. The port of the JAX
``models/recurrentgemma.py``: the training forward and loss, prefill and
the decode step.

Layer pattern: periods of (recurrent, recurrent, local attention); 26
layers are 8 periods and 2 recurrent tail layers. Parameters are
``{"embed", "periods": [{"rec": [block, block], "attn": layer}, ...],
"tail": [block, ...], "final_norm", "lm_head"}``, one dict a block where
JAX stacks them for ``lax.scan``.

RG-LRU: ``a_t = exp(-c softplus(lam) r_t)``, ``h_t = a_t h_{t-1} +
sqrt(1 - a_t^2) (i_t x_t)``. Prefill runs it as a log-depth doubling scan
over the affine maps ``(a, b)`` (JAX: ``lax.associative_scan``; the fp32
sums run in another order, so they agree to fp32 rounding); decode is the
O(1) update. The gates' weights ``w_a``, ``w_x`` and ``lam`` stay fp32, as
JAX keeps every parameter in fp32 and multiplies the fp32 branch by them
uncast; the other matrices are cast to the compute dtype once, at load.

Which kernels run: the norms are the plain ``layers.rms_norm`` and the
residual adds plain additions, as in JAX, so the family launches no
``fused_add_rmsnorm``; every layer's MLP launches ``silu_and_mul``, and
each attention layer's decode ``flash_decode`` (head_dim 256, 10 query
heads on one KV head at full width). The prefill attention is the plain
windowed ``layers.flash_attention``.

Training (``forward``) runs each period under ``layers.remat`` (JAX
checkpoints the period) and the tail blocks without it, as JAX does.

The cache mixes a ring of the last ``window`` K/V rows a slot with the
conv and RG-LRU states, which absorb every token: prefill runs at exact
length (``PAD_PREFILL``) and the cache never pages (``PAGED_OK``). The
decode step updates every leaf in place (the new states are ``copy_``'d
into theirs) with no host read, so the serving engine captures it as one
CUDA graph.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.sharding import spmd

F32 = torch.float32
C_RGLRU = 8.0

# The RG-LRU recurrence and the causal-conv state absorb every processed
# token, so right-padded bucketed prefill would corrupt both. The serving
# engine prefills Griffin prompts at exact length.
PAD_PREFILL = False

# The cache mixes rolling-window K/V with fixed-size recurrent and conv
# state leaves: the recurrent leaves do not page, and the windowed K/V is
# already bounded. Contiguous per-slot cache only.
PAGED_OK = False

# leaves kept in fp32 besides the norms: the RG-LRU gates
FP32_LEAVES = ("w_a", "w_x", "lam")


def _counts(cfg: ModelConfig) -> tuple[int, int]:
    """(periods, recurrent tail layers)."""
    n_periods = cfg.n_layers // 3
    return n_periods, cfg.n_layers - 3 * n_periods


def _lru(cfg: ModelConfig) -> int:
    return cfg.lru_width or cfg.d_model


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def cast_params(tree, cfg: ModelConfig, device):
    """Move a parameter tree to ``device``: the norms and the RG-LRU gates
    (``w_a``, ``w_x``, ``lam``) in fp32, everything else in the compute
    dtype."""
    return T.cast_params(tree, cfg, device, fp32=FP32_LEAVES)


def _rec_init(cfg: ModelConfig, normal, uniform, device) -> dict:
    """One recurrent block's weights in fp32, drawn in the JAX init's
    order; ``conv_w`` starts at zeros, as in JAX."""
    d, r = cfg.d_model, _lru(cfg)
    p = {"norm": torch.ones(d, device=device),
         "w_main": normal((d, r), d ** -0.5),
         "w_gate": normal((d, r), d ** -0.5),
         "conv_w": torch.zeros((cfg.conv_width, r), device=device),
         "w_a": normal((r, r), r ** -0.5),
         "w_x": normal((r, r), r ** -0.5)}
    lam = uniform((r,), 0.9, 0.999)
    # lam parametrised before the softplus, so that a stays in (0, 1)
    p["lam"] = torch.log(torch.exp(-torch.log(lam) / C_RGLRU) - 1.0)
    p["w_out"] = normal((r, d), r ** -0.5)
    p["mlp"] = {"w_gateup": normal((d, 2 * cfg.d_ff), d ** -0.5),
                "w_down": normal((cfg.d_ff, d), cfg.d_ff ** -0.5)}
    p["mlp_norm"] = torch.ones(d, device=device)
    return p


def _attn_init(cfg: ModelConfig, normal, device) -> dict:
    """One local-attention layer's weights in fp32."""
    d = cfg.d_model
    return {"attn": T.attn_init(cfg, normal),
            "mlp": {"w_gateup": normal((d, 2 * cfg.d_ff), d ** -0.5),
                    "w_down": normal((cfg.d_ff, d), cfg.d_ff ** -0.5)},
            "attn_norm": torch.ones(d, device=device),
            "mlp_norm": torch.ones(d, device=device)}


def init(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    """Random parameters with the JAX init's distributions, from ``gen``
    (which must live on ``device``). Each block is drawn in fp32 and cast
    before the next is drawn, so the fp32 temporaries are one block's."""
    d = cfg.d_model
    n_periods, n_tail = _counts(cfg)

    def normal(shape, scale):
        return T._trunc_normal(shape, scale, gen, device)

    def uniform(shape, lo, hi):
        u = torch.empty(shape, dtype=F32, device=device)
        return u.uniform_(lo, hi, generator=gen)

    def cast(tree):
        return cast_params(tree, cfg, device)

    periods = [{"rec": [cast(_rec_init(cfg, normal, uniform, device))
                        for _ in range(2)],
                "attn": cast(_attn_init(cfg, normal, device))}
               for _ in range(n_periods)]
    tail = [cast(_rec_init(cfg, normal, uniform, device))
            for _ in range(n_tail)]
    dt = cfg.torch_dtype
    return {"embed": normal((cfg.padded_vocab, d), 1.0).to(dt),
            "periods": periods, "tail": tail,
            "final_norm": torch.ones(d, device=device),
            "lm_head": normal((d, cfg.padded_vocab), d ** -0.5).to(dt)}


def _rec_axes() -> dict:
    return {"norm": ("embed",), "w_main": ("embed", "lru"),
            "w_gate": ("embed", "lru"), "conv_w": ("conv", "lru"),
            "w_a": ("lru", None), "w_x": ("lru", None), "lam": ("lru",),
            "w_out": ("lru", "embed"), "mlp": dict(T.MLP_AXES),
            "mlp_norm": ("embed",)}


def param_axes(cfg: ModelConfig) -> dict:
    """The logical axes of every leaf of ``init``'s tree (JAX's ``init``
    axes, per period and per block)."""
    n_periods, n_tail = _counts(cfg)
    return T.model_axes(
        periods=[{"rec": [_rec_axes() for _ in range(2)],
                  "attn": T.layer_axes(cfg)} for _ in range(n_periods)],
        tail=[_rec_axes() for _ in range(n_tail)])


# --------------------------------------------------------------------------
# RG-LRU block
# --------------------------------------------------------------------------

def _causal_conv(x, w, state=None):
    """Depthwise causal conv. x: ``[B, S, R]``; w: ``[width, R]``; state:
    ``[B, width - 1, R]`` (the previous inputs) or None (zeros). Returns
    (out ``[B, S, R]``, the new state: the last ``width - 1`` inputs).
    On DTensors it runs on each rank's batch and channels."""
    if spmd.distributed(x, w):
        s, r = x.shape[1], x.shape[2]
        c = w.shape[0] - 1
        return spmd.per_head(
            lambda _, x, w, st: _causal_conv(x, w, st), 0, (x, w, state),
            ("b.h", ".h", "b.h"),
            out_roles=((x.shape, "b.h"), ((x.shape[0], c, r), "b.h")))
    width = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    out = sum(xp[:, i:i + s] * w[i].to(x.dtype) for i in range(width))
    return out, xp[:, -(width - 1):]


def _scan(a, b):
    """``h_t = a_t h_{t-1} + b_t`` from ``h_{-1} = 0`` along axis 1, as a
    doubling scan over the affine maps: at distance ``d`` each position
    composes the map ``d`` places back, ``b_t += a_t b_{t-d}`` and ``a_t
    *= a_{t-d}`` (Hillis-Steele; log2(S) rounds of whole-tensor
    products). It is the ``rglru`` kernel region; on DTensors it runs on
    each rank's batch and channels."""
    if spmd.distributed(a, b):
        return spmd.per_head(lambda _, a, b: _scan(a, b), 0, (a, b),
                             ("b.h", "b.h"), out_roles=((b.shape, "b.h"),))
    with spmd.region("rglru"):
        return _doubling_scan(a, b)


def _doubling_scan(a, b):
    s, d = a.shape[1], 1
    while d < s:
        b = torch.cat([b[:, :d], b[:, d:] + a[:, d:] * b[:, :-d]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru(p, xi, h0=None):
    """RG-LRU over a segment. xi: ``[B, S, R]`` (the conv'd branch); h0:
    ``[B, R]`` fp32 or None. Returns (h ``[B, S, R]`` in xi's dtype, the
    last state ``[B, R]`` in fp32)."""
    xf = xi.to(F32)
    # on DTensors the gates are pinned batch- and channel-split
    r = torch.sigmoid(spmd.shard_batch(xf @ p["w_a"].to(F32), "model"))
    i = torch.sigmoid(spmd.shard_batch(xf @ p["w_x"].to(F32), "model"))
    log_a = -C_RGLRU * torch.nn.functional.softplus(p["lam"].to(F32)) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                   min=1e-12)) * (i * xf)
    if h0 is not None:
        # fold the carried state into step 0's offset
        gated[:, 0] = gated[:, 0] + a[:, 0] * h0
    h = _scan(a, gated)
    return h.to(xi.dtype), h[:, -1]


def rec_block(p, x, cfg: ModelConfig, state=None):
    """The Griffin recurrent residual block and its MLP sublayer. state:
    ``(conv [B, width - 1, R], h [B, R])`` or None. Returns (x, (the new
    conv state, the new h))."""
    conv_state, h0 = (None, None) if state is None else state
    x = spmd.shard_batch(x)
    normed = L.rms_norm(x, p["norm"], cfg.norm_eps)
    main = normed @ p["w_main"].to(x.dtype)
    gate = normed @ p["w_gate"].to(x.dtype)
    main, new_conv = _causal_conv(main, p["conv_w"], conv_state)
    h, h_last = rglru(p, main, h0)
    # jax.nn.gelu is the tanh approximation by default
    y = h * torch.nn.functional.gelu(gate, approximate="tanh")
    # the residual stream pinned batch-split at the mid-block add too, its
    # partial sum over ``model`` reduced there (on DTensors)
    x = spmd.shard_batch(x + y @ p["w_out"].to(x.dtype))
    normed = L.rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    return x + L.mlp_block(p["mlp"], normed), (new_conv, h_last)


def attn_layer(p, x, cfg: ModelConfig):
    """The local-attention layer over a whole segment (prefill). Returns
    (x, this layer's ``(k, v)`` after rope)."""
    x = spmd.shard_batch(x)
    normed = L.rms_norm(x, p["attn_norm"], cfg.norm_eps)
    attn_out, kv = L.attention_block(p["attn"], normed, cfg)
    x = spmd.shard_batch(x + attn_out)
    normed = L.rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    return x + L.mlp_block(p["mlp"], normed), kv


# --------------------------------------------------------------------------
# training forward
# --------------------------------------------------------------------------

def _period_fwd(pp, x, cfg: ModelConfig):
    for p in pp["rec"]:
        x, _ = rec_block(p, x, cfg)
    return attn_layer(pp["attn"], x, cfg)[0]


def forward(params, cfg: ModelConfig, tokens):
    """Teacher-forced logits ``[B, S, V_pad]``: the periods recomputed in
    the backward pass, then the tail blocks."""
    x = L.embed_tokens(params["embed"], tokens).to(cfg.torch_dtype)
    for pp in params["periods"]:
        x = L.remat(_period_fwd, pp, x, cfg)
    for p in params["tail"]:
        x, _ = rec_block(p, x, cfg)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(x, params["lm_head"])


def loss_fn(params, cfg: ModelConfig, batch):
    """Next-token cross-entropy of ``forward``."""
    logits = forward(params, cfg, batch["tokens"])
    return L.ce_loss(logits, batch["labels"], cfg.vocab)


# --------------------------------------------------------------------------
# serving: prefill + single-token decode over the mixed cache
# --------------------------------------------------------------------------

def cache_spec(cfg: ModelConfig, batch: int, seq: int):
    """(shape and dtype of each leaf, its logical axes), JAX's six leaves:
    the conv and h states of the periods' two recurrent blocks, the
    attention layers' K/V ring of ``min(seq, window)`` rows, and the tail
    blocks' conv and h states (one zero block when there is no tail). The
    h states are fp32."""
    n_periods, n_tail = _counts(cfg)
    r = _lru(cfg)
    w = min(seq, cfg.window or seq)
    c = cfg.conv_width - 1
    dt = cfg.torch_dtype
    kv = (n_periods, batch, w, cfg.n_kv_heads, cfg.head_dim)
    spec = {"conv": ((n_periods, 2, batch, c, r), dt),
            "h": ((n_periods, 2, batch, r), F32),
            "k": (kv, dt), "v": (kv, dt),
            "tconv": ((max(n_tail, 1), batch, c, r), dt),
            "th": ((max(n_tail, 1), batch, r), F32)}
    axes = {"conv": ("layers", "stack", "batch", "conv", "lru"),
            "h": ("layers", "stack", "batch", "lru"),
            "k": T.CACHE_AXES, "v": T.CACHE_AXES,
            "tconv": ("layers", "batch", "conv", "lru"),
            "th": ("layers", "batch", "lru")}
    return spec, axes


def init_cache(cfg: ModelConfig, batch: int, seq: int, device) -> dict:
    """A zeroed contiguous cache of ``batch`` slots (``cache_spec``)."""
    spec, _ = cache_spec(cfg, batch, seq)
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, (shape, dtype) in spec.items()}


def prefill(params, cfg: ModelConfig, tokens, *, length: int | None = None,
            cache_len: int | None = None):
    """Process a prompt batch ``tokens [B, S]`` at its exact length.
    Returns (logits ``[B, V_pad]`` at the last position, the cache with
    ``cache_spec``'s leaves). For S past the window the K/V ring keeps
    the last ``window`` positions, each at row ``pos % window``;
    ``cache_len`` zero-pads the ring to ``min(cache_len, window)`` rows.
    ``length`` (a right-padded prompt) is refused: the recurrence would
    absorb the padding."""
    if length is not None:
        raise ValueError("griffin prefill does not take padded prompts "
                         "(PAD_PREFILL is False)")
    b, s = tokens.shape
    x = L.embed_tokens(params["embed"], tokens).to(cfg.torch_dtype)
    w = min(s, cfg.window or s)
    convs, hs, ks, vs = [], [], [], []
    for pp in params["periods"]:
        states = []
        for p in pp["rec"]:
            x, st = rec_block(p, x, cfg)
            states.append(st)
        x, (k, v) = attn_layer(pp["attn"], x, cfg)
        if cfg.window and s > w:
            # the ring: position s - w + j goes to row (s - w + j) % w
            order = torch.argsort(torch.arange(s - w, s, device=x.device)
                                  % w)
            k, v = k[:, s - w:][:, order], v[:, s - w:][:, order]
        convs.append(torch.stack([st[0] for st in states]))
        hs.append(torch.stack([st[1] for st in states]))
        ks.append(k)
        vs.append(v)
    tconv, th = [], []
    for p in params["tail"]:
        x, (c, h) = rec_block(p, x, cfg)
        tconv.append(c)
        th.append(h)
    if not params["tail"]:
        r = _lru(cfg)
        tconv = [torch.zeros((b, cfg.conv_width - 1, r),
                             dtype=cfg.torch_dtype, device=x.device)]
        th = [torch.zeros((b, r), dtype=F32, device=x.device)]
    ks, vs = torch.stack(ks), torch.stack(vs)
    target = min(cache_len, cfg.window) if (cache_len and cfg.window) \
        else cache_len
    if target and target > ks.shape[2]:
        pad = (0, 0, 0, 0, 0, target - ks.shape[2])
        ks = torch.nn.functional.pad(ks, pad)
        vs = torch.nn.functional.pad(vs, pad)
    cache = {"conv": torch.stack(convs), "h": torch.stack(hs), "k": ks,
             "v": vs, "tconv": torch.stack(tconv), "th": torch.stack(th)}
    x = L.rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return L.unembed(x[:, 0], params["lm_head"]), cache


def _rec_step(p, x, cfg, conv, h):
    """One decode step of a recurrent block on its cache leaves ``conv``
    ``[B, width - 1, R]`` and ``h`` ``[B, R]``, updated in place."""
    x, (new_conv, new_h) = rec_block(p, x, cfg, (conv, h))
    conv.copy_(new_conv)
    h.copy_(new_h)
    return x


def decode_step(params, cfg: ModelConfig, cache, token, pos):
    """One decode step over the contiguous cache, in place: every leaf's
    new state is written into it, with no host read.

    token, pos: ``[B]`` int32. The attention layers' K/V go to row ``pos %
    window`` of the ring (a row past the cache is dropped) and attention
    reads ``min(pos + 1, window)`` rows through the ``flash_decode``
    kernel. Returns (logits ``[B, V_pad]``, cache)."""
    x = L.embed_tokens(params["embed"], token[:, None]).to(cfg.torch_dtype)
    w = cfg.window
    slot = pos % w if w else pos
    kv_len = (torch.clamp(pos + 1, max=w) if w else pos + 1) \
        .to(torch.int32)
    cos, sin = L.rope_angles(pos[:, None], cfg.head_dim, cfg.rope_theta)
    for pi, pp in enumerate(params["periods"]):
        for i, p in enumerate(pp["rec"]):
            x = _rec_step(p, x, cfg, cache["conv"][pi, i], cache["h"][pi, i])
        pa = pp["attn"]
        k_l, v_l = cache["k"][pi], cache["v"][pi]
        normed = L.rms_norm(x, pa["attn_norm"], cfg.norm_eps)
        q, k_new, v_new = L.qkv_proj(pa["attn"], normed, cfg)
        q = L.apply_rope(q, cos, sin)
        k_new = L.apply_rope(k_new, cos, sin)
        L.update_cache(k_l, v_l, k_new[:, 0], v_new[:, 0], slot)
        o = ops.flash_decode_attention(q[:, 0].contiguous(), k_l, v_l,
                                       kv_len=kv_len)
        x = x + L.out_proj(pa["attn"], o[:, None], o.dtype)
        normed = L.rms_norm(x, pa["mlp_norm"], cfg.norm_eps)
        x = x + L.mlp_block(pa["mlp"], normed)
    for ti, p in enumerate(params["tail"]):
        x = _rec_step(p, x, cfg, cache["tconv"][ti], cache["th"][ti])
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(x[:, 0], params["lm_head"]), cache

