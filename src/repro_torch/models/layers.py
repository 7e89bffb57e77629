"""Dense decoder layers (the dense part of the JAX ``models/layers.py``).

Every layer calls the kernels through ``repro_torch.kernels.ops``, never a
kernel module directly. Projections are plain matrix products. The
prefill attention (causal, windowed where the config has a window) runs
the port's prefill-attention kernel in bf16 without grad; its other calls
(training, the encoder-decoder's non-causal ones, fp32 models), the
suffix prefill's two-segment attention, the rotary embedding and the
decode-cache write are plain PyTorch, the attention and rope in fp32, as
the JAX package computes them in jnp outside any Pallas kernel.

Training adds the cross-entropy (``ce_loss``), the attention's gradient
(``_FlashAttention``: JAX's recomputing custom VJP, in plain PyTorch as
JAX's is jnp) and ``remat``, the per-layer recompute the family
``forward`` functions wrap each layer in.

Shapes keep the JAX package's layout: activations ``[B, S, D]``, heads
``[B, S, H, dh]``, projection weights with an explicit head axis
(``wq [D, Hq, dh]``, ``wo [Hq, dh, D]``).
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.prefill_attention import (CHUNK, MASKED,
                                                   chunk_mask, kv_chunk,
                                                   walk)
from repro_torch.sharding import spmd, tp

F32 = torch.float32


def _requires_grad(args) -> bool:
    """True when a tensor in ``args`` (nested dicts, lists and tuples)
    requires grad."""
    for a in args:
        if isinstance(a, torch.Tensor):
            if a.requires_grad:
                return True
        elif isinstance(a, dict):
            if _requires_grad(a.values()):
                return True
        elif isinstance(a, (list, tuple)) and _requires_grad(a):
            return True
    return False


def remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass
    instead of kept (JAX: ``jax.checkpoint`` with ``nothing_saveable``):
    ``torch.utils.checkpoint`` when grad mode is on and an argument
    requires grad, else a plain call, so serving (the xLSTM's chunked
    prefill, the encoder) runs exactly what it ran before."""
    if torch.is_grad_enabled() and _requires_grad(args):
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def rms_norm(x, w, eps=1e-6):
    """RMSNorm in fp32, cast back to x's dtype."""
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.to(F32)).to(x.dtype)


def add_rms_norm(x, residual, w, eps=1e-6):
    """Fused residual add + RMSNorm (the fused_add_rmsnorm kernel)."""
    return ops.fused_add_rmsnorm(x, residual, w, eps)


def rope_angles(positions, head_dim: int, theta=10000.0):
    """The rotary embedding's ``(cos, sin)`` for ``positions [..., seq]``,
    each ``[..., seq, 1, head_dim // 2]`` in fp32: computed once and
    applied to q and k of every layer."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=F32,
                                    device=positions.device) / half)
    angles = positions[..., :, None].to(F32) * freqs       # [.., S, half]
    return torch.cos(angles)[..., :, None, :], \
        torch.sin(angles)[..., :, None, :]


def apply_rope(x, cos, sin):
    """Rotate ``x [..., seq, heads, head_dim]`` by ``rope_angles``'
    ``(cos, sin)``; products in fp32, cast back to x's dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x, positions, theta=10000.0):
    """Rotary embedding. x: ``[..., seq, heads, head_dim]``, positions:
    ``[..., seq]``; angles and products in fp32."""
    return apply_rope(x, *rope_angles(positions, x.shape[-1], theta))


def embed_tokens(embedding, tokens):
    """Rows of the ``[V_pad, D]`` embedding for integer ``tokens`` (on
    DTensors, on each rank's shards: ``spmd.take_rows``)."""
    if spmd.distributed(embedding):
        return spmd.take_rows(embedding, tokens)
    return embedding[tokens]


def unembed(x, lm_head):
    """Logits over the padded vocab: ``[..., D] @ [D, V_pad]``. Under an
    active tensor-parallel plan that shards the vocab, the local product
    covers a contiguous vocab slice, all-gathered back to full order.
    On DTensors ``x`` is pinned batch-split first (``spmd.shard_batch``)."""
    return tp.gather_vocab(spmd.shard_batch(x) @ lm_head.to(x.dtype))


def ce_loss(logits, labels, vocab: int):
    """Mean next-token cross-entropy over the labels in ``[0, vocab)``, in
    fp32 (JAX ``layers.ce_loss``): the label's logit is picked by an
    ``arange == label`` select, and labels outside ``[0, vocab)`` (the
    padded vocab's columns, negative ids) count for nothing."""
    logits = logits.to(F32)
    logz = torch.logsumexp(logits, dim=-1)
    sel = torch.arange(logits.shape[-1], device=logits.device) \
        == labels[..., None]
    gold = torch.where(sel, logits, 0.0).sum(-1)
    mask = (labels >= 0) & (labels < vocab)
    nll = torch.where(mask, logz - gold, 0.0)
    return nll.sum() / torch.clamp(mask.sum(), min=1)


def _heads_matmul(x, w):
    """``x [B, S, D] @ w [D, H, dh] -> [B, S, H, dh]``."""
    d, h, dh = w.shape
    return spmd.unflatten(x @ spmd.flatten(w, 1).to(x.dtype), -1, (h, dh))


def qkv_proj(p, x, cfg: ModelConfig):
    """x: ``[B, S, D]`` -> q ``[B, S, Hq, dh]``, k/v ``[B, S, Hkv, dh]``,
    with the QKV bias and the qk-norm where the config has them."""
    q = _heads_matmul(x, p["wq"])
    k = _heads_matmul(x, p["wk"])
    v = _heads_matmul(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def out_proj(p, o, dtype):
    """o: ``[B, S, Hq, dh]`` -> ``[B, S, D]`` through ``wo [Hq, dh, D]``.
    Under an active tensor-parallel plan that shards heads, ``o`` holds
    this rank's heads; they are all-gathered (concatenated, no partial
    sums) before the replicated ``wo`` product."""
    o = tp.gather_heads(o)
    return spmd.flatten(o, -2) @ spmd.flatten(p["wo"], 0).to(dtype)


def _heads_first(t, hkv: int):
    """``[B, S, Hq, dh]`` -> fp32 ``[B, Hkv, G, S, dh]`` (GQA groups)."""
    b, s, hq, dh = t.shape
    return t.to(F32).reshape(b, s, hkv, hq // hkv, dh).permute(0, 2, 3, 1, 4)


def _flash_backward(q, k, v, out, lse, dout, causal, window, chunk):
    """JAX's ``_flash_backward``: per KV chunk the probabilities are
    recomputed from ``lse`` (``p = exp(s - lse)``), ``delta = sum(dout *
    out)`` and ``ds = p (dp - delta)``; nothing of one chunk outlives its
    step but its rows of dK and dV. Returns (dq, dk, dv) in the inputs'
    dtypes."""
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    chunk = min(chunk, skv)
    scale = dh ** -0.5
    qf = _heads_first(q, hkv) * scale
    dof = _heads_first(dout, hkv)
    delta = (dof * _heads_first(out, hkv)).sum(-1)         # [B,Hkv,G,Sq]
    q_pos = torch.arange(sq, device=q.device)
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for c0 in range(0, skv, chunk):
        ks, vs = kv_chunk(k, c0, chunk), kv_chunk(v, c0, chunk)
        s = chunk_mask(torch.einsum("bhgqd,bkhd->bhgqk", qf, ks), q_pos, c0,
                       chunk, causal, window)
        p = torch.exp(s - lse[..., None])                  # recomputed
        dp = torch.einsum("bhgqd,bkhd->bhgqk", dof, vs)
        ds = p * (dp - delta[..., None])
        dq = dq + torch.einsum("bhgqk,bkhd->bhgqd", ds, ks)
        dks.append(torch.einsum("bhgqk,bhgqd->bkhd", ds, qf))
        dvs.append(torch.einsum("bhgqk,bhgqd->bkhd", p, dof))
    dq = (dq * scale).permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dh)
    dk = torch.cat(dks, 1)[:, :skv]                       # the pad rows go
    dv = torch.cat(dvs, 1)[:, :skv]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """``flash_attention`` with JAX's recomputing backward (its
    ``jax.custom_vjp``): the forward saves only ``(q, k, v, out, lse)``,
    never a chunk's probabilities."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk):
        out, lse = walk(q, k, v, causal, window, chunk, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        with spmd.region("flash"):
            grads = _flash_backward(q, k, v, out, lse, dout, *ctx.args)
        return (*grads, None, None, None)


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    chunk: int = CHUNK):
    """Self-attention: causal, optionally over a sliding window of
    ``window`` positions (query i sees keys i - window < j <= i), or with
    ``causal=False`` over every key (the encoder's, and cross-attention).
    q: ``[B, Sq, Hq, dh]``, k/v: ``[B, Skv, Hkv, dh]`` (GQA by head
    grouping).

    A causal call in bf16 without grad (every prefill on the serving path)
    goes to ``ops.prefill_attention``: the Hopper kernel on the card, the
    walk on the CPU. The other calls run the walk itself
    (``kernels/prefill_attention.py::walk``): KV in ``chunk``-row steps
    with an fp32 online softmax, as the JAX ``_flash_fwd_scan`` does, so
    the scores of one step (``[B, Hkv, G, Sq, chunk]``) are the largest
    temporary. As in JAX, K/V are zero-padded to a multiple of ``min(chunk,
    Skv)`` rows: a causal mask hides the pad rows, a non-causal call masks
    nothing, so they take softmax weight (score 0, value 0) there, which
    is why non-causal calls stay on the walk. An fp32 call stays on it
    too: the kernel computes in bf16.

    With grad mode on and an input that requires grad, the call goes
    through ``_FlashAttention``, whose backward recomputes each chunk's
    probabilities from the saved log-sum-exp (JAX's custom VJP).

    It is JAX's ``flash`` kernel region (``spmd.region``); on DTensors it
    runs on each rank's shards of batch and heads."""
    if spmd.distributed(q, k, v):
        return spmd.per_head(
            lambda _, q, k, v: flash_attention(q, k, v, causal=causal,
                                               window=window, chunk=chunk),
            0, (q, k, v), ("b.h.", "b.k.", "b.k."),
            out_roles=((q.shape, "b.h."),))
    with spmd.region("flash"):
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return _FlashAttention.apply(q, k, v, causal, window, chunk)
        if causal and q.dtype == torch.bfloat16:
            return ops.prefill_attention(q, k, v, window=window)
        return walk(q, k, v, causal, window, chunk)[0]


def attention_block(p, x, cfg: ModelConfig, *, positions=None):
    """Full-sequence (prefill) self-attention sublayer, windowed where the
    config has a window. Returns the sublayer output and this layer's
    ``(k, v)`` after rope."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = qkv_proj(p, x, cfg)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = flash_attention(q, k, v, window=cfg.window)
    return out_proj(p, o, x.dtype), (k, v)


def prefix_attention(q, k_new, v_new, k_prefix, v_prefix, prefix_len: int):
    """Suffix-prefill attention over a two-segment KV in fp32: cached
    prefix rows, then the suffix's own keys and values.

    q, k_new, v_new: ``[B, S, H*, dh]``, the suffix (right-padded to its
    bucket); k_prefix, v_prefix: ``[B, P, Hkv, dh]``, prefix rows gathered
    from the paged pool, of which only the first ``prefix_len`` are valid
    (the rest is trap-page garbage, masked). Causality is over absolute
    positions: suffix query i sits at ``prefix_len + i`` and sees the
    valid prefix and the suffix keys ``<= i``."""
    b, s, hq, dh = q.shape
    hkv = k_new.shape[2]
    g = hq // hkv
    p_rows = k_prefix.shape[1]
    k = torch.cat([k_prefix, k_new], 1).to(F32)
    v = torch.cat([v_prefix, v_new], 1).to(F32)
    qf = q.to(F32).reshape(b, s, hkv, g, dh) * dh ** -0.5
    sc = torch.einsum("bqhgd,bkhd->bhgqk", qf, k)
    kpos = torch.arange(p_rows + s, device=q.device)
    qpos = prefix_len + torch.arange(s, device=q.device)
    valid = (kpos < prefix_len) | (kpos >= p_rows)
    pos_of_k = torch.where(kpos < p_rows, kpos, prefix_len + (kpos - p_rows))
    mask = valid[None, :] & (pos_of_k[None, :] <= qpos[:, None])
    sc = torch.where(mask, sc, MASKED)
    o = torch.einsum("bhgqk,bkhd->bhgqd", torch.softmax(sc, -1), v)
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, hq, dh).to(q.dtype)


def update_cache(cache_k, cache_v, k_new, v_new, pos) -> None:
    """Write one token's K/V at row ``pos[b]`` of request ``b``, in place.

    cache_k/v: ``[B, S, Hkv, dh]``; k_new/v_new: ``[B, Hkv, dh]``; pos:
    ``[B]``. A row at or past S is dropped, as the JAX scatter drops an
    out-of-range write (an idle slot's position keeps advancing past the
    cache): the write goes to row S - 1 with that row's own value, so no
    index leaves the cache and nothing waits on the host.

    On DTensors each rank writes its own shard: its batch rows, and of a
    sequence shard only the rows it holds (a position outside it is
    dropped as one past S is)."""
    if spmd.distributed(cache_k, cache_v, k_new, v_new):
        def local(info, ck, cv, kn, vn, p):
            p = p - info.seq_offset
            update_cache(ck, cv, kn, vn,
                         torch.where(p < 0, ck.shape[1], p))
        spmd.per_head(local, 0, (cache_k, cache_v, k_new, v_new, pos),
                       ("bsk.", "bsk.", "bk.", "bk.", "b"), seq_split=True)
        return
    b, s = cache_k.shape[:2]
    idx = torch.arange(b, device=pos.device)
    keep = (pos < s)[:, None, None]
    row = torch.clamp(pos, max=s - 1).long()
    for cache, new in ((cache_k, k_new), (cache_v, v_new)):
        cache[idx, row] = torch.where(keep, new.to(cache.dtype),
                                      cache[idx, row])


def mlp_block(p, x):
    """SwiGLU: fused gate/up product -> silu_and_mul kernel -> down
    product. Under an active tensor-parallel plan that shards the MLP,
    ``w_gateup`` holds this rank's permuted gate/up columns
    (``sharding.tp.gateup_permutation``), and the local ``silu_and_mul``
    outputs are all-gathered before the replicated down product."""
    h = x @ p["w_gateup"].to(x.dtype)
    h = ops.silu_and_mul(h)
    h = tp.gather_mlp(h)
    return h @ p["w_down"].to(x.dtype)
