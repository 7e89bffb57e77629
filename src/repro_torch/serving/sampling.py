"""Sampling layer of the serving API: ``SamplingParams`` and the draw
inside the decode step (the port of the JAX ``serving/sampling.py``).

``SamplingParams`` is the per-request knob set: ``temperature == 0`` is
greedy argmax and ``temperature > 0`` a categorical draw over the
(optionally top-k, then top-p truncated) softmax.

``sample_tokens`` is the draw over a ``[B, V]`` batch of logits with
per-slot parameter tensors, in plain PyTorch. It runs inside the engine's
decode step (a CUDA graph replay on the card), so it makes no host round
trip: no ``.item()``, no boolean indexing, no data-dependent shapes.

Reproducibility: the noise for a request's token *t* is a pure function
of ``(seed, t, vocab index)``, computed on the device in integer tensor
ops, with no ``torch.Generator`` whose state a graph replay would freeze
or a restart reset. It is the JAX package's noise bit for bit: threefry2x32
(``threefry_bits``) keyed by ``fold_in(PRNGKey(seed), t)``, the bits JAX's
default partitionable threefry draws for ``jax.random.bits(key, (V,))``,
turned into Gumbel noise as ``jax.random.gumbel`` does (the float ``log``
may round differently in the last bit). Streams are therefore equal
across engine restarts, cache layouts, and swap or recompute preemption.
When ``seed`` is None the engine uses the request id.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

F32 = torch.float32
MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = torch.finfo(F32).tiny


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration.

    temperature: 0.0 => greedy argmax (the default); > 0 scales logits
        before the categorical draw.
    top_k: keep only the k highest-logit tokens (0 => disabled).
    top_p: keep the smallest prefix of the sorted distribution whose
        cumulative probability reaches p (1.0 => disabled), after top_k.
    seed: per-request seed (None => the request id).
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError(f"temperature={self.temperature} must be >= 0")
        if self.top_k < 0:
            raise ValueError(f"top_k={self.top_k} must be >= 0 (0 disables)")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p={self.top_p} must be in (0, 1]")

    @property
    def greedy(self) -> bool:
        """True for greedy argmax decoding."""
        return self.temperature == 0.0

    def resolve_seed(self, rid: int) -> int:
        """The effective per-request seed (the request id when unset)."""
        return int(self.seed) if self.seed is not None else int(rid)


GREEDY = SamplingParams()


# -- the noise: threefry2x32 in int64 tensor ops -----------------------------

def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds), as JAX computes it, on int64
    tensors holding uint32 values (broadcast together). Returns the two
    output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1, x2


def threefry_bits(seed, index, n: int):
    """``[B, n]`` uint32 values (in int64) of ``jax.random.bits(
    fold_in(PRNGKey(seed[b]), index[b]), (n,))`` under the partitionable
    threefry. ``seed`` holds each seed as a uint32 (``seed & 0xFFFFFFFF``
    of an int32 seed), ``index`` the stream index; both ``[B]``."""
    seed = seed.to(torch.int64) & MASK32
    zero = torch.zeros_like(seed)
    # PRNGKey(seed) is (0, seed); fold_in hashes the count pair (0, index)
    k1, k2 = threefry2x32(zero, seed, zero, index.to(torch.int64) & MASK32)
    counts = torch.arange(n, dtype=torch.int64, device=seed.device)
    b1, b2 = threefry2x32(k1[:, None], k2[:, None], 0, counts[None, :])
    return b1 ^ b2


def gumbel_noise(seed, index, n: int):
    """``[B, n]`` fp32 Gumbel noise for token ``index[b]`` of the request
    seeded ``seed[b]``: ``jax.random.gumbel`` of the same key, the float
    made from the top 23 bits as ``jax.random.uniform`` makes it."""
    bits = threefry_bits(seed, index, n)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(F32) - 1.0
    u = torch.clamp_min(floats * (1.0 - _TINY) + _TINY, _TINY)
    return -torch.log(-torch.log(u))


# -- the draw ----------------------------------------------------------------

def sample_tokens(logits, seed, index, temperature, top_k, top_p):
    """One token per row of ``logits [B, V]`` (the real vocab), as int32.

    ``seed`` ([B] int64), ``index`` ([B], the stream index of this draw),
    ``temperature`` / ``top_p`` ([B] fp32) and ``top_k`` ([B] int32) are
    per-slot tensors on the logits' device. Rows with ``temperature <= 0``
    take the plain argmax (the first maximum), the greedy step's token.
    Other rows keep the top-k logits (``top_k == 0`` keeps all), then the
    tokens whose cumulative probability *before* them is ``< top_p`` (the
    top token always survives), and draw by Gumbel-argmax over the scaled
    logits. Ties in the sort go to the lowest index, as ``jnp.argsort``
    of the negated logits orders them."""
    b, vocab = logits.shape
    greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits.to(F32) / torch.clamp_min(temperature, 1e-6)[:, None]
    order = torch.sort(scaled, dim=-1, descending=True, stable=True).indices
    ar = torch.arange(vocab, device=logits.device).expand(b, vocab)
    ranks = torch.empty_like(order).scatter_(1, order, ar)
    k_eff = torch.where(top_k > 0, top_k, vocab).to(torch.int64)
    keep_k = ranks < k_eff[:, None]
    probs = torch.softmax(scaled.masked_fill(~keep_k, float("-inf")), dim=-1)
    sorted_probs = torch.gather(probs, 1, order)
    before = torch.cumsum(sorted_probs, dim=-1) - sorted_probs
    keep_p = torch.gather(before < top_p[:, None], 1, ranks)
    final = scaled.masked_fill(~(keep_k & keep_p), float("-inf"))
    noise = gumbel_noise(seed, index, vocab)
    sampled = torch.argmax(final + noise, dim=-1).to(torch.int32)
    return torch.where(temperature <= 0.0, greedy_tok, sampled)
