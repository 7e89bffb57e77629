"""Mixture-of-Experts transformer (granite-moe-3b-a800m, olmoe-1b-7b): the
port of the JAX ``models/moe.py``.

The dense skeleton (``transformer.prefill`` and ``transformer.decode_step``,
the cache updated in place) with ``moe_block`` as each layer's
feed-forward sublayer: GShard grouped capacity dispatch. Tokens are split
into groups of ``min(GROUP, tokens)``; within a group a top-k router
builds a dispatch one-hot ``[G, E, C]`` and every expert runs its SwiGLU
(paper Kernel 3, the ``silu_and_mul`` kernel) on its ``C`` capacity rows,
empty or not, as the JAX package computes it. A routed slot past its
expert's capacity is dropped. Dispatch, combine and the expert products
are plain einsums and batched matrix products, so every expert's weights
are read at every step.

Training runs the same block under the dense ``forward``: the router's
top-k values carry the gradient, capacity drops as at serving.

The router is computed in fp32 and its weight is kept in fp32 (JAX stores
every parameter in fp32 and computes the router in fp32), so the choice
of experts does not depend on the compute dtype; the expert weights are
cast to the compute dtype once, at load.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.sharding import spmd

F32 = torch.float32

GROUP = 256  # tokens per dispatch group

# Attention is causal, but right-padded bucketed prefill is NOT exact here:
# pad tokens compete with real tokens for expert capacity inside the
# router's grouped dispatch, so padding can change real-token outputs. The
# serving engine prefills MoE prompts at exact length.
PAD_PREFILL = False

# Paged-KV serving is NOT exact here though the cache is positional K/V:
# capacity routing couples decode across slots, so a preemption (which
# changes which requests occupy the other slots) would change the
# surviving requests' tokens. The engine keeps the contiguous cache.
PAGED_OK = False

cache_spec = T.cache_spec
init_cache = T.init_cache


def capacity(cfg: ModelConfig, group: int) -> int:
    """Rows of each expert in a group of ``group`` tokens: the capacity
    factor's share, rounded up to a multiple of 8 and at least top-k."""
    c = int(group * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(cfg.top_k, -(-c // 8) * 8)


def check_tokens(tokens: int) -> None:
    """Raise unless ``tokens`` split into whole groups: JAX reshapes ``b *
    s`` tokens into groups of ``min(GROUP, b * s)`` and so fails for a
    count above ``GROUP`` that is not a multiple of it. The port refuses
    the same counts, before any launch, and does not pad (padding would
    change which tokens get capacity)."""
    if tokens > GROUP and tokens % GROUP:
        raise ValueError(
            f"{tokens} tokens do not split into dispatch groups of "
            f"GROUP={GROUP} (the JAX reshape takes at most {GROUP} tokens "
            "or a multiple of it)")


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def cast_params(tree, cfg: ModelConfig, device):
    """Move a parameter tree to ``device``: the norms and the router in
    fp32, everything else in the compute dtype."""
    return T.cast_params(tree, cfg, device, fp32=("router",))


def init(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    """Random parameters with the JAX init's distributions, from ``gen``
    (which must live on ``device``), drawn and cast one layer at a time
    (``transformer.init_layers``)."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.expert_ff

    def layer(normal):
        return {"attn": T.attn_init(cfg, normal),
                "router": normal((d, e), d ** -0.5),
                "w_gateup": normal((e, d, 2 * f), d ** -0.5),
                "w_down": normal((e, f, d), f ** -0.5),
                "attn_norm": torch.ones(d, device=device),
                "mlp_norm": torch.ones(d, device=device)}

    return T.init_layers(cfg, gen, device, layer, cast_params)


def param_axes(cfg: ModelConfig) -> dict:
    """The logical axes of every leaf of ``init``'s tree (JAX's ``init``
    axes, per layer)."""
    layer = {"attn": T.attn_axes(cfg), "router": ("embed", "experts"),
             "w_gateup": ("experts", "embed", "expert_mlp"),
             "w_down": ("experts", "expert_mlp", "embed"),
             "attn_norm": ("embed",), "mlp_norm": ("embed",)}
    return T.model_axes(layers=[layer for _ in range(cfg.n_layers)])


# --------------------------------------------------------------------------
# MoE block
# --------------------------------------------------------------------------

def route(probs, k: int):
    """The top ``k`` of ``probs [..., E]`` as (values, indices), largest
    first. ``lax.top_k`` returns the lower index first among equal values;
    ``torch.topk`` promises no order among them, so a tie at the k-th
    place could pick another expert. A stable descending sort keeps the
    lower index first, as JAX does."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_block(p, x, cfg: ModelConfig, first: int = 0):
    """x: ``[B, S, D]`` -> ``[B, S, D]`` through the top-k routed experts.

    The one-hots are comparisons with ``torch.arange``: a slot whose
    position is at or past the capacity gets a zero row (dropped), as
    ``jax.nn.one_hot`` gives, and no value is read on the host, so the
    block runs inside a captured decode step.

    On DTensors the experts run expert-parallel (``spmd.experts``): each
    rank routes its tokens over every expert and runs its own experts;
    ``first`` is then the index of this rank's first expert, and the
    output a partial sum over the expert shards."""
    if spmd.distributed(x):
        return spmd.experts(lambda p, x, first: moe_block(p, x, cfg, first),
                            p, x, group=min(GROUP, x.shape[0] * x.shape[1]))
    return _moe(p, x, cfg, first)


def _moe(p, x, cfg: ModelConfig, first: int):
    b, s, d = x.shape
    tokens = b * s
    check_tokens(tokens)
    g = min(GROUP, tokens)
    n = tokens // g
    cap = capacity(cfg, g)
    e, k = cfg.n_experts, cfg.top_k
    xt = x.reshape(n, g, d)

    logits = xt.to(F32) @ p["router"].to(F32)                  # [N,G,E]
    probs = torch.softmax(logits, dim=-1)
    topv, topi = route(probs, k)                               # [N,G,K]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)

    # position of each routed slot within its expert (slot-major cumsum)
    onehot = (topi[..., None]
              == torch.arange(e, device=x.device)).to(F32)     # [N,G,K,E]
    flat = onehot.reshape(n, g * k, e)
    pos = torch.cumsum(flat, dim=1) - flat                     # [N,G*K,E]
    pos = (pos * flat).sum(-1).reshape(n, g, k)                # [N,G,K]
    pos_oh = (pos[..., None]
              == torch.arange(cap, device=x.device)).to(F32)   # [N,G,K,C]
    # dispatch [N,G,E,C] and the weighted combine
    dispatch = torch.einsum("ngke,ngkc->ngec", onehot, pos_oh)
    combine = torch.einsum("ngke,ngkc,ngk->ngec", onehot, pos_oh, topv)
    local = p["w_gateup"].shape[0]             # this rank's experts
    if local < e:
        dispatch = dispatch[:, :, first:first + local]
        combine = combine[:, :, first:first + local]
        e = local

    dt = x.dtype
    expert_in = torch.einsum("ngec,ngd->encd", dispatch.to(dt), xt)
    expert_in = expert_in.reshape(e, n * cap, d)
    h = torch.bmm(expert_in, p["w_gateup"].to(dt))            # [E,N*C,2F]
    h = ops.silu_and_mul(h)
    out_e = torch.bmm(h, p["w_down"].to(dt))                   # [E,N*C,D]
    out_e = out_e.reshape(e, n, cap, d)
    out = torch.einsum("ngec,encd->ngd", combine.to(dt), out_e)
    return out.reshape(b, s, d)


# --------------------------------------------------------------------------
# training and serving: the dense skeleton with moe_block as the
# feed-forward sublayer
# --------------------------------------------------------------------------

def forward(params, cfg: ModelConfig, tokens):
    """``transformer.forward`` with the routed experts (each layer
    recomputed in the backward pass); ``B * S`` tokens that do not split
    into dispatch groups raise (``check_tokens``)."""
    check_tokens(tokens.numel())
    return T.forward(params, cfg, tokens,
                     ffn=lambda p, x: moe_block(p, x, cfg))


def loss_fn(params, cfg: ModelConfig, batch):
    """Next-token cross-entropy of ``forward``."""
    logits = forward(params, cfg, batch["tokens"])
    return L.ce_loss(logits, batch["labels"], cfg.vocab)


def prefill(params, cfg: ModelConfig, tokens, *, length: int | None = None,
            cache_len: int | None = None):
    """``transformer.prefill`` with the routed experts; a batch of ``B *
    S`` tokens that does not split into dispatch groups raises before
    any launch (``check_tokens``)."""
    check_tokens(tokens.numel())
    return T.prefill(params, cfg, tokens, length=length, cache_len=cache_len,
                     ffn=lambda p, x: moe_block(p, x, cfg))


def decode_step(params, cfg: ModelConfig, cache, token, pos):
    """``transformer.decode_step`` with the routed experts: one token a
    slot over the contiguous cache, in place. Every slot's row, idle or
    not, competes for expert capacity, as in the JAX engine."""
    return T.decode_step(params, cfg, cache, token, pos,
                         ffn=lambda p, x: moe_block(p, x, cfg))
