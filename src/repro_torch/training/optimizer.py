"""AdamW with fp32 master weights and fp32 moments (the JAX
``training/optimizer.py``), over the port's parameter trees.

The formulas are JAX's as written: ``m = b1 m + (1 - b1) g``, ``v = b2 v +
(1 - b2) g^2``, ``p = p - lr (m_hat / (sqrt(v_hat) + eps) + wd p)``, with
the decay inside the learning-rate product (``torch.optim.AdamW`` orders
it otherwise). ``update`` works in place on the parameters and the
moments, as the JAX step donates them, with ``torch._foreach_*`` ops; the
step counter and the schedule live on the CPU in fp32, as scalars, so a
step reads nothing back from the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.training import tree as T

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor      # int32 scalar on the CPU
    m: Any
    v: Any


def init(params) -> OptState:
    """Zero fp32 moments shaped like ``params`` (which must be fp32
    masters), step 0."""
    for name, p in T.named_leaves(params):
        if p.dtype != F32:
            raise ValueError(f"parameter {name} is {p.dtype}: AdamW keeps "
                             "fp32 master weights")
    zeros = T.map_tree(torch.zeros_like, params)
    return OptState(torch.zeros((), dtype=torch.int32), zeros,
                    T.map_tree(torch.zeros_like, params))


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_frac``, in fp32:
    the learning rate at ``step`` as a CPU scalar."""
    step = torch.as_tensor(step, dtype=F32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 \
        * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def global_norm(grads) -> torch.Tensor:
    """The fp32 L2 norm over every leaf of ``grads``: the square root of
    the sum of each leaf's sum of squares, as JAX computes it. (PyTorch's
    fp32 vector norm on the CPU loses ~1e-4 of its value over a 136 M
    element leaf, qwen2-0.5b's embedding; a plain sum does not.)"""
    sums = [torch.sum(torch.square(g.to(F32))) for g in T.leaves(grads)]
    return torch.sqrt(torch.stack(sums).sum())


def clip_by_global_norm(grads, max_norm: float):
    """(fp32 ``grads`` scaled so that their global norm is at most
    ``max_norm``, the norm before scaling)."""
    gs = [g.to(F32) for g in T.leaves(grads)]
    gn = global_norm(gs)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return T.rebuild(grads, torch._foreach_mul(gs, scale)), gn


def update(cfg: AdamWConfig, params, grads, state: OptState):
    """One AdamW step, in place. Returns (params, the new state, {"lr",
    "grad_norm"})."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = float(1 - torch.tensor(cfg.b1, dtype=F32) ** step.to(F32))
    b2c = float(1 - torch.tensor(cfg.b2, dtype=F32) ** step.to(F32))
    ps, gs = T.leaves(params), T.leaves(grads)
    ms, vs = T.leaves(state.m), T.leaves(state.v)
    torch._foreach_mul_(ms, cfg.b1)
    torch._foreach_add_(ms, gs, alpha=1 - cfg.b1)
    torch._foreach_mul_(vs, cfg.b2)
    torch._foreach_addcmul_(vs, gs, gs, value=1 - cfg.b2)
    den = torch._foreach_div(vs, b2c)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, cfg.eps)
    upd = torch._foreach_div(ms, b1c)
    torch._foreach_div_(upd, den)
    torch._foreach_add_(upd, ps, alpha=cfg.weight_decay)
    torch._foreach_add_(ps, upd, alpha=-float(lr))
    return params, OptState(step, state.m, state.v), \
        {"lr": lr, "grad_norm": gnorm}
