"""Plain PyTorch versions of every kernel contract of the JAX package.

Each function computes what its namesake in the JAX package's
``kernels/ref.py`` computes, in the same precision: fp32 arithmetic, cast
back to the input dtype. The CUDA kernels of this package are held against
these on the card, and the wrappers use them for tensors on the CPU.

  merge_attn_states_lse:
      V_out = (e^{S_a} V_a + e^{S_b} V_b) / (e^{S_a} + e^{S_b})
      S_out = log(e^{S_a} + e^{S_b})
  fused_add_rmsnorm:
      r' = x + r ;  y = r' / sqrt(mean(r'^2) + eps) * w
  silu_and_mul:
      out = SiLU(gate) * up,  SiLU(z) = z / (1 + e^{-z})
  flash_decode_attention / paged_flash_decode_attention / flash_decode_lse:
      one-token GQA attention over a contiguous or a paged KV cache

``fused_add_rmsnorm_vjp`` and ``silu_and_mul_vjp`` are the gradients of
the two oracles the training path differentiates (JAX differentiates its
jnp references): the backward of ``ops``' autograd Functions.
"""

from __future__ import annotations

import torch

F32 = torch.float32


def merge_attn_states_lse(v_a, s_a, v_b, s_b):
    """Merge two partial attention states with log-sum-exp weights.

    ``v_*`` are ``[..., head_dim]``, ``s_*`` are ``[...]``; ``-inf`` marks
    an empty partition and is handled exactly. Returns ``(v_out, s_out)``
    in the input dtypes.
    """
    sa, sb = s_a.to(F32), s_b.to(F32)
    va, vb = v_a.to(F32), v_b.to(F32)
    m = torch.maximum(sa, sb)
    # both sides empty: weights become 0 and s_out stays -inf
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    wa = torch.exp(sa - m_safe)
    wb = torch.exp(sb - m_safe)
    denom = wa + wb
    inv = torch.where(denom > 0, 1.0 / denom, torch.zeros_like(denom))
    v_out = (wa * inv)[..., None] * va + (wb * inv)[..., None] * vb
    s_out = m + torch.log(denom)
    return v_out.to(v_a.dtype), s_out.to(s_a.dtype)


def fused_add_rmsnorm(x, residual, weight, eps: float = 1e-6):
    """Residual add + RMSNorm. Returns ``(y, x + residual)`` in x's dtype."""
    r = x.to(F32) + residual.to(F32)
    var = torch.mean(r * r, dim=-1, keepdim=True)
    y = r * torch.rsqrt(var + eps) * weight.to(F32)
    return y.to(x.dtype), r.to(x.dtype)


def fused_add_rmsnorm_vjp(x, residual, weight, dy, dr, eps: float = 1e-6):
    """The gradient of ``fused_add_rmsnorm`` at ``(x, residual, weight)``
    for the cotangents ``dy`` of y and ``dr`` of ``r'``, from the fp32
    statistics: with ``inv = rsqrt(mean(r'^2) + eps)`` and ``g = dy w``,
    ``d r' = inv g - r' inv^3 mean(g r') + dr``, ``dw = sum over rows of
    dy r' inv``. Returns ``(dx, dresidual, dweight)`` in the inputs'
    dtypes."""
    r = x.to(F32) + residual.to(F32)
    d = r.shape[-1]
    inv = torch.rsqrt(torch.mean(r * r, dim=-1, keepdim=True) + eps)
    dyf = dy.to(F32)
    g = dyf * weight.to(F32)
    dr_all = inv * g - r * inv ** 3 * (g * r).sum(-1, keepdim=True) / d \
        + dr.to(F32)
    dw = (dyf * r * inv).reshape(-1, d).sum(0)
    return dr_all.to(x.dtype), dr_all.to(residual.dtype), dw.to(weight.dtype)


def silu_and_mul(x):
    """SwiGLU gate: ``silu(x[..., :d]) * x[..., d:]``, d = last dim / 2."""
    d = x.shape[-1] // 2
    gate = x[..., :d].to(F32)
    up = x[..., d:].to(F32)
    return (gate * torch.sigmoid(gate) * up).to(x.dtype)


def silu_and_mul_vjp(x, dout):
    """The gradient of ``silu_and_mul`` at ``x`` for the cotangent
    ``dout``, in fp32: ``d gate = dout up s (1 + gate (1 - s))`` with ``s
    = sigmoid(gate)``, ``d up = dout gate s``. Returns ``dx`` in x's
    dtype."""
    d = x.shape[-1] // 2
    gate = x[..., :d].to(F32)
    up = x[..., d:].to(F32)
    s = torch.sigmoid(gate)
    do = dout.to(F32)
    return torch.cat([do * up * s * (1 + gate * (1 - s)), do * gate * s],
                     dim=-1).to(x.dtype)


def _scores(q, k, kv_len, sm_scale):
    """fp32 ``[b, hkv, group, s]`` scores, positions >= kv_len at -inf."""
    b, hq, dh = q.shape
    _, s, hkv, _ = k.shape
    qf = q.reshape(b, hkv, hq // hkv, dh).to(F32)
    scores = torch.einsum("bhgd,bshd->bhgs", qf, k.to(F32)) * sm_scale
    if kv_len is not None:
        pos = torch.arange(s, device=q.device)
        mask = pos[None, :] < kv_len.to(q.device)[:, None]       # [b, s]
        scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    return scores


def flash_decode_attention(q, k, v, *, kv_len=None, sm_scale=None):
    """Single-token GQA decode attention.

    q: ``[batch, q_heads, head_dim]``; k, v: ``[batch, seq, kv_heads,
    head_dim]``; kv_len: optional ``[batch]`` valid lengths. Returns
    ``[batch, q_heads, head_dim]`` in q's dtype. As in the JAX oracle, the
    probabilities are rounded to v's dtype before the value product.
    """
    b, hq, dh = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / (dh ** 0.5)
    probs = torch.softmax(_scores(q, k, kv_len, sm_scale), dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", probs.to(v.dtype).to(F32),
                       v.to(F32))
    return out.reshape(b, hq, dh).to(q.dtype)


def _gather_pages(pages, page_table):
    b, n_pt = page_table.shape
    _, page, hkv, dh = pages.shape
    return pages[page_table.long()].reshape(b, n_pt * page, hkv, dh)


def paged_flash_decode_attention(q, k_pages, v_pages, page_table, *,
                                 kv_len=None, sm_scale=None):
    """Paged decode attention: gather the logical cache through the page
    table (``[batch, pages_per_seq]`` indices into the ``[num_pages,
    page_size, kv_heads, head_dim]`` pools), then contiguous decode
    attention. Rows at or past ``kv_len`` are masked exactly."""
    return flash_decode_attention(q, _gather_pages(k_pages, page_table),
                                  _gather_pages(v_pages, page_table),
                                  kv_len=kv_len, sm_scale=sm_scale)


def flash_decode_lse(q, k, *, kv_len=None, sm_scale=None):
    """Log-sum-exp of the decode-attention softmax: ``[batch, q_heads]``
    fp32, the ``S`` half of the partial state ``merge_attn_states_lse``
    consumes."""
    b, hq, dh = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / (dh ** 0.5)
    lse = torch.logsumexp(_scores(q, k, kv_len, sm_scale), dim=-1)
    return lse.reshape(b, hq)
