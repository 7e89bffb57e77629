"""Causal, optionally windowed, GQA attention over a whole prompt (the
prefill's self-attention): the Hopper kernel, its plain version and the
wrapper.

The kernel is ``csrc/prefill_attention.cu``. It replaces no TPU kernel:
the JAX package computes this attention in jnp (``repro/models/layers.py``
``flash_attention``, its ``_flash_fwd_scan``), and ``walk`` here is that
computation in plain PyTorch: an online softmax over ``chunk``-row KV
steps in fp32. The kernel was added because that walk, some 25 launches a
chunk over the full S x S scores, was most of a serving admission's device
time on the H100. It is bound by operations (``work``: 4 d flops a visible
query-key pair); the kernel's source says how its design meets that.

``models/layers.py::flash_attention`` sends the kernel its causal calls in
bf16 without grad; the others stay on ``walk``: with grad the backward
needs the walk's log-sum-exp, a non-causal call (the encoder, the
cross-attention) gives JAX's zero pad rows softmax weight, and an fp32
model computes its attention in fp32.

A CPU tensor takes ``walk``; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

F32 = torch.float32
MASKED = -1e30        # finite -inf of the JAX flash attention
CHUNK = 512           # the walk's KV rows a step (JAX's default block)
HEAD_DIMS = (32, 64, 80, 128, 256)   # the kernel's instantiations


def kv_chunk(t, c0: int, chunk: int):
    """Rows ``[c0, c0 + chunk)`` of ``t [B, Skv, Hkv, dh]`` in fp32,
    zero-padded to ``chunk`` rows, as JAX pads K/V to a multiple of the
    chunk."""
    part = t[:, c0:c0 + chunk].to(F32)
    if part.shape[1] < chunk:
        part = torch.nn.functional.pad(part,
                                       (0, 0, 0, 0, 0, chunk - part.shape[1]))
    return part


def chunk_mask(s, q_pos, c0: int, chunk: int, causal: bool, window):
    """``s [..., Sq, chunk]`` with the keys a causal (windowed) query at
    ``q_pos`` may not see at ``MASKED``; a non-causal call masks
    nothing."""
    if not causal:
        return s
    k_pos = c0 + torch.arange(chunk, device=s.device)
    mask = k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    return torch.where(mask, s, MASKED)


def walk(q, k, v, causal: bool, window, chunk: int = CHUNK,
         with_lse: bool = False):
    """The online-softmax walk over KV chunks (JAX ``_flash_fwd_scan``).
    Returns (out ``[B, Sq, Hq, dh]`` in q's dtype, the log-sum-exp ``[B,
    Hkv, G, Sq]`` in fp32 or None)."""
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    chunk = min(chunk, skv)
    qf = (q.to(F32) * dh ** -0.5).reshape(b, sq, hkv, g, dh) \
        .permute(0, 2, 3, 1, 4)                           # [B,Hkv,G,Sq,D]
    q_pos = torch.arange(sq, device=q.device)
    m = torch.full((b, hkv, g, sq), MASKED, dtype=F32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, sq, dh), dtype=F32, device=q.device)
    for c0 in range(0, skv, chunk):
        ks, vs = kv_chunk(k, c0, chunk), kv_chunk(v, c0, chunk)
        s = chunk_mask(torch.einsum("bhgqd,bkhd->bhgqk", qf, ks), q_pos, c0,
                       chunk, causal, window)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd",
                                                    p, vs)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dh).to(q.dtype)
    lse = m + torch.log(torch.clamp(l, min=1e-30)) if with_lse else None
    return out, lse


def visible_pairs(seq: int, window=None) -> int:
    """(query, key) pairs a causal query row set of ``seq`` rows sees:
    ``seq (seq + 1) / 2``, or with a window ``w`` each row at most ``w``."""
    w = seq if window is None else min(window, seq)
    return w * (w + 1) // 2 + (seq - w) * w


def work(*, batch: int, seq: int, q_heads: int, kv_heads: int,
         head_dim: int, window=None, itemsize: int = 2) -> tuple[int, int]:
    """(flops, bytes) a call needs: two products of ``2 dh`` flops a
    visible pair and head; q, k, v read once and out written once."""
    flops = 4 * head_dim * q_heads * batch * visible_pairs(seq, window)
    rows = batch * seq * head_dim * itemsize
    return flops, rows * (2 * q_heads + 2 * kv_heads)


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      window=None) -> torch.Tensor:
    """Causal self-attention over whole prompts, optionally over a sliding
    window (query i sees keys i - window < j <= i).

    q: ``[batch, seq, q_heads, head_dim]``; k, v: ``[batch, seq, kv_heads,
    head_dim]`` (GQA by head grouping). Returns ``[batch, seq, q_heads,
    head_dim]`` in q's dtype: ``walk``'s on the CPU, the kernel's on the
    card (bf16 only)."""
    if q.device.type == "cpu":
        return walk(q, k, v, True, window)[0]
    if q.device.type == "cuda":
        return _launch(q, k, v, window)
    raise ValueError(f"prefill_attention runs on cpu or cuda, not "
                     f"{q.device}")


prefill_attention.launches = 0


def _check(q, k, v, window) -> None:
    """Raise ValueError for what the kernel does not take."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"q {tuple(q.shape)} and k, v {tuple(k.shape)} / "
                         f"{tuple(v.shape)} are not [batch, seq, heads, "
                         "head_dim] of one prompt batch")
    hq, hkv, dh = q.shape[2], k.shape[2], q.shape[3]
    if hkv < 1 or hq % hkv:
        raise ValueError(f"q_heads {hq} is not a multiple of kv_heads {hkv}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {dh} is not one of the kernel's widths "
                         f"{HEAD_DIMS}")
    if not q.dtype == k.dtype == v.dtype == torch.bfloat16:
        raise ValueError(f"the kernel takes bfloat16, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError("q, k and v must share one device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(st % 8 for st in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name} needs a contiguous head_dim, strides "
                             "that are multiples of 8 elements and a "
                             "16-byte aligned start")
    if window is not None and window < 1:
        raise ValueError(f"window {window} < 1")


def _launch(q, k, v, window):
    _check(q, k, v, window)
    b, s, hq, dh = q.shape
    out = torch.empty((b, s, hq, dh), dtype=q.dtype, device=q.device)
    if b == 0 or s == 0:
        return out
    lib = _build.library()
    code = lib.repro_prefill_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, hq,
        k.shape[2], dh, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        window or 0, dh ** -0.5, _build.stream_ptr(q.device))
    _build.check(lib, code, "prefill_attention")
    prefill_attention.launches += 1
    return out
