"""xLSTM (mLSTM and sLSTM blocks), xlstm-1.3b [arXiv:2405.04517]. The port
of the JAX ``models/xlstm.py``: the training forward and loss, prefill and
the decode step.

Periods of 8 blocks, 7 mLSTM and 1 sLSTM (the 1.3B model's xLSTM[7:1]):
48 layers are 6 periods. Parameters are ``{"embed", "periods":
[{"mlstm": [block] * 7, "slstm": block}, ...], "final_norm",
"lm_head"}``, one dict a block where JAX stacks them for ``lax.scan``.

mLSTM: a matrix memory ``C [d_qk, d_v]`` a head with an exponential input
gate and the log-space stabiliser ``m``: ``m_t = max(log f_t + m_{t-1},
log i_t)``, ``C_t = f'_t C_{t-1} + i'_t k_t v_t^T`` and ``n_t`` alike with
``k_t`` (``i'``, ``f'`` the gates over ``e^{m_t}``), ``h_t = C_t^T q_t /
max(|n_t . q_t|, e^{-m_t})``. sLSTM: the same gating of a scalar memory a
unit, ``c_t = f' c_{t-1} + i' tanh(z_t)``, ``h_t = c_t / max(n_t,
1e-6)``; it has no recurrent weight on ``h``. So once ``m`` is known both
are affine in their state: after step t the state is the carried one
times ``exp(m_0 + sum log f - m_t)`` plus a sum over the steps s <= t
weighted by ``exp(log i_s + sum_{s<r<=t} log f_r - m_t)``, and ``m_t`` is
the running max of those exponents. Prefill runs both scans chunkwise in
that form: inside each 64-token chunk (JAX's ``CHUNK``) every step at
once, the state carried from chunk to chunk. JAX scans step by step; the
fp32 sums run in another order, so the two agree to fp32 rounding. Decode
is the O(1) step, which updates the cache leaves in place with no host
read, so the serving engine captures it as one CUDA graph. Training
(``forward``) runs every block through the chunkwise scans, at any length
(the in-place decode step never sees a tensor that needs a gradient), and
recomputes each chunk in the backward pass (``layers.remat``; JAX
checkpoints each chunk of its scans), so the chunk-boundary states are
what a block keeps.

Which kernels run: none. The JAX blocks call the plain ``rms_norm``,
``silu`` and ``sigmoid`` (the JAX module docstring says the pre-norms use
the fused kernel; its code does not), so this family launches none of
the port's kernels.

The gate weights differ by block under one name: mLSTM's ``w_i`` and
``w_f`` multiply an fp32 branch in fp32 (they stay fp32), sLSTM's are cast
to the compute dtype with its other matrices; ``cast_params`` decides by
block.

The cache is the recurrent state, the same size at any sequence length
(six leaves, none on a ``kv_seq`` axis): prefill runs at exact length
(``PAD_PREFILL``) and the cache never pages (``PAGED_OK``). A prompt of S
> 64 tokens that ``S // 64`` does not divide is refused: JAX's chunk
reshape fails on it (``TypeError``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.sharding import spmd

F32 = torch.float32
CHUNK = 64            # JAX's scan chunk, and the chunk of the port's scans
PERIOD = 8            # blocks a period: 7 mLSTM, then 1 sLSTM
MASKED = -1e30        # the stabiliser of an empty state, as JAX starts it

# Every processed token (pad or not) updates (C, n, m), so right-padded
# bucketed prefill would corrupt the carried state. The serving engine
# prefills xLSTM prompts at exact length.
PAD_PREFILL = False

# The cache is fixed-size recurrent state, not a growing positional K/V
# sequence: there is nothing to page. Contiguous per-slot cache only.
PAGED_OK = False

# the mLSTM leaves kept in fp32 besides the norms: its gate weights
MLSTM_FP32 = ("w_i", "w_f")
# the cache leaves of the mLSTM and of the sLSTM states, each (C or c, n,
# m), and the stabiliser leaves' start in a fresh cache (the others: 0)
M_LEAVES, S_LEAVES = ("mC", "mn", "mm"), ("sc", "sn", "sm")
CACHE_FILL = {"mm": MASKED, "sm": MASKED}


def _dims(cfg: ModelConfig) -> tuple[int, int, int]:
    """(d_inner, per-head width, per-head q/k width)."""
    d_inner = 2 * cfg.d_model
    dh = d_inner // cfg.n_heads
    return d_inner, dh, dh // 2


def _periods(cfg: ModelConfig) -> int:
    return cfg.n_layers // PERIOD


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _cast_period(period, cfg: ModelConfig, device) -> dict:
    """One period's blocks on ``device``, each kind cast as
    ``cast_params`` says."""
    return {"mlstm": [T.cast_params(b, cfg, device, fp32=MLSTM_FP32)
                      for b in period["mlstm"]],
            "slstm": T.cast_params(period["slstm"], cfg, device)}


def cast_params(tree, cfg: ModelConfig, device):
    """Move a parameter tree to ``device``: the norms and the mLSTM gate
    weights (``w_i``, ``w_f``) in fp32, everything else (the sLSTM's
    ``w_i`` and ``w_f`` too) in the compute dtype."""
    out = T.cast_params({k: v for k, v in tree.items() if k != "periods"},
                        cfg, device)
    out["periods"] = [_cast_period(p, cfg, device) for p in tree["periods"]]
    return out


def _mlstm_init(cfg: ModelConfig, normal, device) -> dict:
    """One mLSTM block's weights in fp32 (the JAX init's fan-in scales:
    ``shape[-2] ** -0.5``)."""
    d, h = cfg.d_model, cfg.n_heads
    d_inner, dh, dqk = _dims(cfg)
    return {"norm": torch.ones(d, device=device),
            "w_up": normal((d, d_inner), d ** -0.5),
            "w_gate": normal((d, d_inner), d ** -0.5),
            "w_q": normal((h, dh, dqk), dh ** -0.5),
            "w_k": normal((h, dh, dqk), dh ** -0.5),
            "w_v": normal((h, dh, dh), dh ** -0.5),
            "w_i": normal((h, dh), h ** -0.5),
            "w_f": normal((h, dh), h ** -0.5),
            "w_down": normal((d_inner, d), d_inner ** -0.5)}


def _slstm_init(cfg: ModelConfig, normal, device) -> dict:
    """One sLSTM block's weights in fp32."""
    d = cfg.d_model
    out = {"norm": torch.ones(d, device=device)}
    for name in ("w_z", "w_i", "w_f", "w_o", "w_down"):
        out[name] = normal((d, d), d ** -0.5)
    return out


def init(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    """Random parameters with the JAX init's distributions, from ``gen``
    (which must live on ``device``). Each block is drawn in fp32 and cast
    before the next is drawn, so the fp32 temporaries are one block's."""
    d = cfg.d_model

    def normal(shape, scale):
        return T._trunc_normal(shape, scale, gen, device)

    periods = [_cast_period({"mlstm": [_mlstm_init(cfg, normal, device)
                                       for _ in range(PERIOD - 1)],
                             "slstm": _slstm_init(cfg, normal, device)},
                            cfg, device)
               for _ in range(_periods(cfg))]
    dt = cfg.torch_dtype
    return {"embed": normal((cfg.padded_vocab, d), 1.0).to(dt),
            "periods": periods,
            "final_norm": torch.ones(d, device=device),
            "lm_head": normal((d, cfg.padded_vocab), d ** -0.5).to(dt)}


MLSTM_AXES = {"norm": ("embed",), "w_up": ("embed", "mlp"),
              "w_gate": ("embed", "mlp"),
              "w_q": ("heads", "head_dim", None),
              "w_k": ("heads", "head_dim", None),
              "w_v": ("heads", "head_dim", None),
              "w_i": ("heads", "head_dim"), "w_f": ("heads", "head_dim"),
              "w_down": ("mlp", "embed")}
SLSTM_AXES = {"norm": ("embed",), "w_z": ("embed", "mlp"),
              "w_i": ("embed", "mlp"), "w_f": ("embed", "mlp"),
              "w_o": ("embed", "mlp"), "w_down": ("mlp", "embed")}


def param_axes(cfg: ModelConfig) -> dict:
    """The logical axes of every leaf of ``init``'s tree (JAX's ``init``
    axes, per period and per block)."""
    return T.model_axes(periods=[
        {"mlstm": [dict(MLSTM_AXES) for _ in range(PERIOD - 1)],
         "slstm": dict(SLSTM_AXES)} for _ in range(_periods(cfg))])


# --------------------------------------------------------------------------
# the chunkwise form of the scans
# --------------------------------------------------------------------------

def _segsum(x):
    """``x [..., c]`` -> ``[..., c, c]``: entry ``[t, s]`` is ``sum_{s < r
    <= t} x_r`` for s <= t (0 on the diagonal) and -inf above it. Each
    entry is summed from its own terms (a masked cumsum), not as a
    difference of running sums."""
    c = x.shape[-1]
    ones = torch.ones((c, c), dtype=torch.bool, device=x.device)
    rows = x[..., :, None].expand(*x.shape, c)          # [.., r, s] = x_r
    seg = torch.cumsum(rows.masked_fill(~torch.tril(ones, -1), 0.0), -2)
    return seg.masked_fill(~torch.tril(ones), float("-inf"))


def _weights(state_m, log_i, log_f):
    """The chunk's gate weights from the stabiliser carried in, ``state_m
    [...]``, and the chunk's ``log_i``, ``log_f [..., c]``: (``D [..., c,
    c]``, the weight of step s's input in the state after step t; ``g
    [..., c]``, the weight of the carried state after step t; ``m [...,
    c]``, the stabiliser after step t)."""
    a = log_i[..., None, :] + _segsum(log_f)
    decay = state_m[..., None] + torch.cumsum(log_f, -1)
    m = torch.maximum(decay, a.amax(-1))
    return torch.exp(a - m[..., None]), torch.exp(decay - m), m


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------

def _mlstm_qkvif(p, x, cfg: ModelConfig):
    """x: ``[B, S, D]`` -> per-head q, k, v ``[B, S, H, *]`` in x's dtype,
    the log-gates ``[B, S, H]`` in fp32, and the output gate's input z."""
    _, dh, dqk = _dims(cfg)
    b, s, _ = x.shape
    u = x @ p["w_up"].to(x.dtype)
    z = x @ p["w_gate"].to(x.dtype)
    uh = spmd.unflatten(u, -1, (cfg.n_heads, dh))
    q = torch.einsum("bshe,heq->bshq", uh, p["w_q"].to(x.dtype))
    k = torch.einsum("bshe,heq->bshq", uh, p["w_k"].to(x.dtype)) \
        * (dqk ** -0.5)
    v = torch.einsum("bshe,hev->bshv", uh, p["w_v"].to(x.dtype))
    uf = uh.to(F32)
    log_i = torch.einsum("bshe,he->bsh", uf, p["w_i"].to(F32))
    log_f = -F.softplus(-torch.einsum("bshe,he->bsh", uf,
                                      p["w_f"].to(F32)))
    return q, k, v, log_i, log_f, z


def _mlstm_step_(C, n, m, q, k, v, log_i, log_f):
    """One mLSTM step on the state ``C [B, H, K, V]``, ``n [B, H, K]``,
    ``m [B, H]``, updated in place; q, k ``[B, H, K]``, v ``[B, H, V]``,
    the log-gates ``[B, H]``, all fp32. Returns h ``[B, H, V]``."""
    if spmd.distributed(C, q):
        return spmd.per_head(
            lambda _, *t: _mlstm_step_(*t), 0,
            (C, n, m, q, k, v, log_i, log_f),
            ("bh..", "bh.", "bh", "bh.", "bh.", "bh.", "bh", "bh"),
            out_roles=((v.shape, "bh."),))
    m_new = torch.maximum(log_f + m, log_i)
    i_ = torch.exp(log_i - m_new)
    f_ = torch.exp(log_f + m - m_new)
    C.mul_(f_[..., None, None]).addcmul_(k[..., :, None],
                                         (i_[..., None] * v)[..., None, :])
    n.mul_(f_[..., None]).add_(i_[..., None] * k)
    m.copy_(m_new)
    h_num = (q[..., None, :] @ C)[..., 0, :]
    h_den = torch.abs((n * q).sum(-1))
    return h_num / torch.maximum(h_den, torch.exp(-m_new))[..., None]


def _mlstm_chunk(state, q, k, v, log_i, log_f):
    """The mLSTM over one chunk at once, from ``state`` (C, n, m); q, k
    ``[B, H, c, K]``, v ``[B, H, c, V]``, the log-gates ``[B, H, c]``, all
    fp32. Returns (the state after the chunk, h ``[B, H, c, V]``)."""
    with spmd.region("mlstm"):      # the recompute in backward too
        return _mlstm_chunk_math(state, q, k, v, log_i, log_f)


def _mlstm_chunk_math(state, q, k, v, log_i, log_f):
    C0, n0, m0 = state
    D, g, m = _weights(m0, log_i, log_f)
    s = (q @ k.transpose(-1, -2)) * D                   # [B, H, c, c]
    num = g[..., None] * (q @ C0) + s @ v
    # n after each step, then its dot with q, in JAX's order
    n_t = g[..., None] * n0[..., None, :] + D @ k       # [B, H, c, K]
    den = (n_t * q).sum(-1)
    h = num / torch.maximum(den.abs(), torch.exp(-m))[..., None]
    kw = k * D[..., -1, :, None]                        # the last step's
    C = g[..., -1, None, None] * C0 + kw.transpose(-1, -2) @ v
    n = g[..., -1, None] * n0 + kw.sum(-2)
    return (C, n, m[..., -1]), h


def _mlstm_scan(state, q, k, v, log_i, log_f):
    """The mLSTM over a ``[B, S, H, *]`` segment, chunk by chunk; returns
    (the last state, h ``[B, S, H, V]`` in fp32). It is JAX's ``mlstm``
    kernel region; on DTensors it runs on each rank's batch and heads."""
    if spmd.distributed(q, *state):
        C, n, m = state
        C, n, m, h = spmd.per_head(
            lambda _, C, n, m, *t: _flat_scan(_mlstm_scan, (C, n, m), *t),
            3, (C, n, m, q, k, v, log_i, log_f),
            ("bh..", "bh.", "bh", "b.h.", "b.h.", "b.h.", "b.h", "b.h"),
            out_roles=((C.shape, "bh.."), (n.shape, "bh."), (m.shape, "bh"),
                       ((*v.shape,), "b.h.")))
        return (C, n, m), h
    with spmd.region("mlstm"):
        return _mlstm_chunks(state, q, k, v, log_i, log_f)


def _flat_scan(scan, state, *inputs):
    """``scan``'s (state, h) as one flat tuple."""
    state, h = scan(state, *inputs)
    return (*state, h)


def _mlstm_chunks(state, q, k, v, log_i, log_f):
    q, k, v = (t.to(F32).transpose(1, 2) for t in (q, k, v))
    log_i, log_f = log_i.transpose(1, 2), log_f.transpose(1, 2)
    hs = []
    for c0 in range(0, q.shape[2], CHUNK):
        part = slice(c0, c0 + CHUNK)
        state, h = L.remat(_mlstm_chunk, state, q[:, :, part],
                           k[:, :, part], v[:, :, part], log_i[..., part],
                           log_f[..., part])
        hs.append(h)
    return state, torch.cat(hs, 2).transpose(1, 2)


def mlstm_empty(cfg: ModelConfig, batch: int, device):
    """The empty mLSTM state (C, n, m) of ``batch`` rows, as JAX starts
    it."""
    _, dh, dqk = _dims(cfg)
    h = cfg.n_heads
    return (torch.zeros((batch, h, dqk, dh), dtype=F32, device=device),
            torch.zeros((batch, h, dqk), dtype=F32, device=device),
            torch.full((batch, h), MASKED, dtype=F32, device=device))


def _mlstm_out(p, x, h, z):
    """The block's output: h (``[B, S, H, V]`` fp32) gated by silu(z),
    projected down, added to the residual x."""
    h = spmd.flatten(h, -2).to(x.dtype) * F.silu(z)
    # on DTensors h is pinned batch- and width-split before the product
    return x + spmd.shard_batch(h, "model") @ p["w_down"].to(x.dtype)


def _mlstm_decode(p, x, cfg: ModelConfig, state):
    """One step (``x [B, 1, D]``) of the mLSTM block, updating ``state``
    (C, n, m; the cache leaves at decode) in place."""
    x = spmd.shard_batch(x)
    normed = L.rms_norm(x, p["norm"], cfg.norm_eps)
    q, k, v, log_i, log_f, z = _mlstm_qkvif(p, normed, cfg)
    h = _mlstm_step_(*state, q[:, 0].to(F32), k[:, 0].to(F32),
                     v[:, 0].to(F32), log_i[:, 0], log_f[:, 0])
    return _mlstm_out(p, x, h[:, None], z)


def _mlstm_seq(p, x, cfg: ModelConfig, state):
    """The mLSTM block over ``x [B, S, D]`` by the chunkwise scan."""
    x = spmd.shard_batch(x)
    normed = L.rms_norm(x, p["norm"], cfg.norm_eps)
    q, k, v, log_i, log_f, z = _mlstm_qkvif(p, normed, cfg)
    state, h = _mlstm_scan(state, q, k, v, log_i, log_f)
    return _mlstm_out(p, x, h, z), state


def mlstm_block(p, x, cfg: ModelConfig, state=None):
    """The mLSTM residual block over ``x [B, S, D]`` from ``state`` (C, n,
    m; None: empty). Returns (y, the new state); ``state`` is not
    changed."""
    if state is None:
        state = mlstm_empty(cfg, x.shape[0], x.device)
    if x.shape[1] == 1:
        state = tuple(t.clone() for t in state)
        return _mlstm_decode(p, x, cfg, state), state
    return _mlstm_seq(p, x, cfg, state)


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------

def _slstm_gates(p, x, cfg: ModelConfig):
    """(z, i, f in fp32, o in x's dtype) of the normed input."""
    normed = L.rms_norm(x, p["norm"], cfg.norm_eps)
    z = (normed @ p["w_z"].to(x.dtype)).to(F32)
    i = (normed @ p["w_i"].to(x.dtype)).to(F32)
    f = (normed @ p["w_f"].to(x.dtype)).to(F32)
    o = normed @ p["w_o"].to(x.dtype)
    return z, i, f, o


def _slstm_step_(c, n, m, z, i, f):
    """One sLSTM step on the state ``c``, ``n``, ``m [B, D]``, updated in
    place; z, i, f ``[B, D]`` fp32. Returns h ``[B, D]``."""
    if spmd.distributed(c, z):
        return spmd.per_head(lambda _, *t: _slstm_step_(*t), 0,
                             (c, n, m, z, i, f), ("bh",) * 6,
                             out_roles=((c.shape, "bh"),))
    log_f = -F.softplus(-f)
    m_new = torch.maximum(log_f + m, i)
    iw = torch.exp(i - m_new)
    fw = torch.exp(log_f + m - m_new)
    c.mul_(fw).add_(iw * torch.tanh(z))
    n.mul_(fw).add_(iw)
    m.copy_(m_new)
    return c / torch.clamp(n, min=1e-6)


def _slstm_chunk(state, z, i, log_f):
    """The sLSTM over one chunk at once; z, i, log_f ``[B, D, c]`` fp32.
    Returns (the state after the chunk, h ``[B, D, c]``)."""
    with spmd.region("slstm"):      # the recompute in backward too
        return _slstm_chunk_math(state, z, i, log_f)


def _slstm_chunk_math(state, z, i, log_f):
    c0, n0, m0 = state
    D, g, m = _weights(m0, i, log_f)
    c = g * c0[..., None] + (D @ torch.tanh(z)[..., None])[..., 0]
    n = g * n0[..., None] + D.sum(-1)
    h = c / torch.clamp(n, min=1e-6)
    return (c[..., -1], n[..., -1], m[..., -1]), h


def _slstm_scan(state, z, i, f):
    """The sLSTM over ``[B, S, D]`` gates, chunk by chunk; returns (the
    last state, h ``[B, S, D]`` fp32). It is JAX's ``slstm`` kernel
    region; on DTensors it runs on each rank's batch and channels."""
    if spmd.distributed(z, *state):
        c, n, m = state
        c, n, m, h = spmd.per_head(
            lambda _, c, n, m, *t: _flat_scan(_slstm_scan, (c, n, m), *t),
            3, (c, n, m, z, i, f), ("bh", "bh", "bh", "b.h", "b.h", "b.h"),
            out_roles=((c.shape, "bh"), (n.shape, "bh"), (m.shape, "bh"),
                       (z.shape, "b.h")))
        return (c, n, m), h
    with spmd.region("slstm"):
        return _slstm_chunks(state, z, i, f)


def _slstm_chunks(state, z, i, f):
    z, i = z.transpose(1, 2), i.transpose(1, 2)
    log_f = (-F.softplus(-f)).transpose(1, 2)
    hs = []
    for c0 in range(0, z.shape[2], CHUNK):
        part = slice(c0, c0 + CHUNK)
        state, h = L.remat(_slstm_chunk, state, z[..., part],
                           i[..., part], log_f[..., part])
        hs.append(h)
    return state, torch.cat(hs, 2).transpose(1, 2)


def slstm_empty(cfg: ModelConfig, batch: int, device):
    """The empty sLSTM state (c, n, m) of ``batch`` rows."""
    d = cfg.d_model
    return (torch.zeros((batch, d), dtype=F32, device=device),
            torch.zeros((batch, d), dtype=F32, device=device),
            torch.full((batch, d), MASKED, dtype=F32, device=device))


def _slstm_out(p, x, h, o):
    h = h.to(x.dtype) * torch.sigmoid(o)
    return x + h @ p["w_down"].to(x.dtype)


def _slstm_decode(p, x, cfg: ModelConfig, state):
    """One step (``x [B, 1, D]``) of the sLSTM block, updating ``state``
    (c, n, m; the cache leaves at decode) in place."""
    x = spmd.shard_batch(x)
    z, i, f, o = _slstm_gates(p, x, cfg)
    h = _slstm_step_(*state, z[:, 0], i[:, 0], f[:, 0])
    return _slstm_out(p, x, h[:, None], o)


def _slstm_seq(p, x, cfg: ModelConfig, state):
    """The sLSTM block over ``x [B, S, D]`` by the chunkwise scan."""
    x = spmd.shard_batch(x)
    z, i, f, o = _slstm_gates(p, x, cfg)
    state, h = _slstm_scan(state, z, i, f)
    return _slstm_out(p, x, h, o), state


def slstm_block(p, x, cfg: ModelConfig, state=None):
    """The sLSTM residual block over ``x [B, S, D]`` from ``state`` (c, n,
    m; None: empty). Returns (y, the new state); ``state`` is not
    changed."""
    if state is None:
        state = slstm_empty(cfg, x.shape[0], x.device)
    if x.shape[1] == 1:
        state = tuple(t.clone() for t in state)
        return _slstm_decode(p, x, cfg, state), state
    return _slstm_seq(p, x, cfg, state)


# --------------------------------------------------------------------------
# training forward
# --------------------------------------------------------------------------

def forward(params, cfg: ModelConfig, tokens):
    """Teacher-forced logits ``[B, S, V_pad]``: every block from the empty
    state by the chunkwise scans, each chunk recomputed in the backward
    pass."""
    x = L.embed_tokens(params["embed"], tokens).to(cfg.torch_dtype)
    b, dev = x.shape[0], x.device
    for pp in params["periods"]:
        for p in pp["mlstm"]:
            x, _ = _mlstm_seq(p, x, cfg, mlstm_empty(cfg, b, dev))
        x, _ = _slstm_seq(pp["slstm"], x, cfg, slstm_empty(cfg, b, dev))
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(x, params["lm_head"])


def loss_fn(params, cfg: ModelConfig, batch):
    """Next-token cross-entropy of ``forward``."""
    logits = forward(params, cfg, batch["tokens"])
    return L.ce_loss(logits, batch["labels"], cfg.vocab)


# --------------------------------------------------------------------------
# serving: prefill + single-token decode over the recurrent state
# --------------------------------------------------------------------------

def cache_spec(cfg: ModelConfig, batch: int, seq: int):
    """(shape and dtype of each leaf, its logical axes), JAX's six fp32
    leaves: the mLSTM ``C``, ``n``, ``m`` stacked ``[periods, 7, batch,
    ...]`` and the sLSTM ``c``, ``n``, ``m`` ``[periods, batch, D]``, the
    same at any ``seq``."""
    _, dh, dqk = _dims(cfg)
    p, s, h, d = _periods(cfg), PERIOD - 1, cfg.n_heads, cfg.d_model
    spec = {"mC": ((p, s, batch, h, dqk, dh), F32),
            "mn": ((p, s, batch, h, dqk), F32),
            "mm": ((p, s, batch, h), F32),
            "sc": ((p, batch, d), F32),
            "sn": ((p, batch, d), F32),
            "sm": ((p, batch, d), F32)}
    axes = {"mC": ("layers", "stack", "batch", "heads", None, "lru"),
            "mn": ("layers", "stack", "batch", "heads", None),
            "mm": ("layers", "stack", "batch", "heads"),
            "sc": ("layers", "batch", "mlp"),
            "sn": ("layers", "batch", "mlp"),
            "sm": ("layers", "batch", "mlp")}
    return spec, axes


def init_cache(cfg: ModelConfig, batch: int, seq: int, device) -> dict:
    """A fresh cache of ``batch`` slots: zeros, the stabilisers at
    ``MASKED`` (``CACHE_FILL``), as JAX's."""
    spec, _ = cache_spec(cfg, batch, seq)
    return {name: torch.full(shape, CACHE_FILL.get(name, 0.0), dtype=dtype,
                             device=device)
            for name, (shape, dtype) in spec.items()}


def check_prompt_length(s: int) -> None:
    """Refuse a prompt length that JAX's chunked scan cannot reshape: it
    cuts S tokens into ``max(1, S // 64)`` chunks of ``S // n`` rows."""
    n = max(1, s // CHUNK)
    if s % n:
        raise ValueError(
            f"xlstm prefill of {s} tokens: the JAX scan cuts a prompt into "
            f"max(1, S // {CHUNK}) = {n} chunks of equal length, which "
            f"{s} tokens do not make")


def prefill(params, cfg: ModelConfig, tokens, *, length: int | None = None,
            cache_len: int | None = None):
    """Run a prompt batch ``tokens [B, S]`` through the recurrence at its
    exact length. Returns (logits ``[B, V_pad]`` at the last position, the
    cache of ``cache_spec``'s leaves). ``cache_len`` does not matter (the
    state is O(1) in S); ``length`` (a right-padded prompt) is refused,
    as is a length JAX's scan cannot chunk (``check_prompt_length``),
    before any work."""
    if length is not None:
        raise ValueError("xlstm prefill does not take padded prompts "
                         "(PAD_PREFILL is False)")
    check_prompt_length(tokens.shape[1])
    x = L.embed_tokens(params["embed"], tokens).to(cfg.torch_dtype)
    leaves = {name: [] for name in M_LEAVES + S_LEAVES}
    for pp in params["periods"]:
        states = []
        for p in pp["mlstm"]:
            x, st = mlstm_block(p, x, cfg)
            states.append(st)
        x, s_state = slstm_block(pp["slstm"], x, cfg)
        for j, name in enumerate(M_LEAVES):
            leaves[name].append(torch.stack([st[j] for st in states]))
        for name, t in zip(S_LEAVES, s_state):
            leaves[name].append(t)
    cache = {name: torch.stack(ts) for name, ts in leaves.items()}
    x = L.rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return L.unembed(x[:, 0], params["lm_head"]), cache


def decode_step(params, cfg: ModelConfig, cache, token, pos):
    """One decode step over the contiguous cache, in place: every block's
    state leaves are updated where they lie, with no host read. token:
    ``[B]`` int32; ``pos`` is not read (the state has no positions).
    Returns (logits ``[B, V_pad]``, cache)."""
    x = L.embed_tokens(params["embed"], token[:, None]).to(cfg.torch_dtype)
    for pi, pp in enumerate(params["periods"]):
        for j, p in enumerate(pp["mlstm"]):
            x = _mlstm_decode(p, x, cfg,
                              [cache[name][pi, j] for name in M_LEAVES])
        x = _slstm_decode(pp["slstm"], x, cfg,
                          [cache[name][pi] for name in S_LEAVES])
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(x[:, 0], params["lm_head"]), cache
