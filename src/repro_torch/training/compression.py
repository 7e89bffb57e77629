"""Gradient compression (the JAX ``training/compression.py``): int8 block
quantization with per-block fp32 scales, applied as a quantize-dequantize
stage on the gradients with error feedback, so that the quantization bias
does not build up across steps. On one card nothing goes over a wire; the
stage keeps the numbers the compressed all-reduce of a multi-pod run would
give. ``torch.round`` rounds half to even as ``jnp.round`` does, so the
payloads and scales equal JAX's bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.training import tree as T

BLOCK = 256
F32 = torch.float32


def quantize(x: torch.Tensor):
    """x -> (int8 payload ``[blocks, BLOCK]``, fp32 scales ``[blocks,
    1]``, the element count). The flat view is zero-padded to whole
    blocks."""
    flat = x.to(F32).reshape(-1)
    n = flat.shape[0]
    flat = torch.nn.functional.pad(flat, (0, (-n) % BLOCK)).reshape(-1, BLOCK)
    scale = flat.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.round(flat / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return q, scale, n


def dequantize(q, scale, n: int, shape):
    """The fp32 values of a ``quantize`` payload, in ``shape``."""
    return (q.to(F32) * scale).reshape(-1)[:n].reshape(shape)


def stacks(tree) -> list:
    """``tree``'s leaf indices grouped into the leaves JAX quantizes: JAX
    stacks the port's lists of layers, periods and blocks on leading axes,
    so the leaves whose paths differ only in the index of a list of
    subtrees are one JAX leaf, in flattening (row-major) order. Blocks of
    ``BLOCK`` run across a stack's members as they do across JAX's stacked
    leaf."""
    groups: dict = {}
    for i, (path, _) in enumerate(T.named_leaves(tree)):
        parts = path.split(T.SEP)
        key = T.SEP.join([p for p in parts[:-1] if not p.isdigit()]
                         + parts[-1:])
        groups.setdefault(key, []).append(i)
    return list(groups.values())


def compress_grads(grads, error=None):
    """Quantize-dequantize every leaf of ``grads`` with error feedback, a
    stack (``stacks``) at a time. Returns (the gradients after the wire,
    in their dtypes; the new error ``e_t = g_t + e_{t-1} - Q(g_t +
    e_{t-1})``, fp32)."""
    gs = T.leaves(grads)
    es = T.leaves(error) if error is not None \
        else [torch.zeros_like(g, dtype=F32) for g in gs]
    outs, errs = [None] * len(gs), [None] * len(gs)
    for idx in stacks(grads):
        target = torch.cat([(gs[i].to(F32) + es[i]).reshape(-1)
                            for i in idx])
        deq = dequantize(*quantize(target), target.shape)
        sizes = [gs[i].numel() for i in idx]
        for i, d, e in zip(idx, deq.split(sizes),
                           (target - deq).split(sizes)):
            outs[i] = d.reshape(gs[i].shape).to(gs[i].dtype)
            errs[i] = e.reshape(gs[i].shape)
    return T.rebuild(grads, outs), T.rebuild(grads, errs)


def wire_bytes(grads) -> int:
    """Bytes of the compressed format: an int8 a value and an fp32 scale a
    block of each stack."""
    sizes = [g.numel() for g in T.leaves(grads)]
    stack = [sum(sizes[i] for i in idx) for idx in stacks(grads)]
    return sum(n + 4 * -(-n // BLOCK) for n in stack)
