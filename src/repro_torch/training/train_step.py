"""The training step (the JAX ``training/train_step.py``): gradients
accumulated over microbatches in fp32, optional gradient compression with
error feedback, then the AdamW update.

Microbatches run as a Python loop (JAX: ``lax.scan``), one backward pass
each, so live activations are one microbatch deep; each layer's
activations are recomputed in its backward pass (the family ``forward``
functions wrap every layer in ``layers.remat``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import registry
from repro_torch.sharding import spmd
from repro_torch.training import compression, optimizer as opt
from repro_torch.training import tree as T

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """``batch_axes``: the mesh axes that carry the batch dimension (e.g.
    ``("pod", "data")``) of a step over DTensors (``launch/dryrun.py``):
    microbatch i is then each batch shard's i-th share of its own rows, so
    every microbatch stays split over those axes and the split moves no
    data (JAX constrains its ``[M, B/M]`` split to them to the same end);
    the compute copy of the weights is gathered along them once a step.
    Empty, the batch is cut into ``microbatches`` runs of rows as one
    tensor (one card).

    ``cast_params``: the dtype that every fp32 parameter of two or more
    dimensions is cast to once a step, before the microbatches (the
    compute copy; gradients come back in it and accumulate in fp32), or
    None to differentiate the fp32 masters themselves."""
    microbatches: int = 1
    compress_grads: bool = False
    adamw: opt.AdamWConfig = dataclasses.field(default_factory=opt.AdamWConfig)
    batch_axes: tuple = ()
    cast_params: str | None = "bfloat16"


def init_state(cfg: ModelConfig, tcfg: TrainConfig, params):
    """The optimizer state of the fp32 ``params``, and the error-feedback
    buffers when the gradients are compressed."""
    state = {"opt": opt.init(params)}
    if tcfg.compress_grads:
        state["err_fb"] = T.map_tree(
            lambda p: torch.zeros_like(p, dtype=F32), params)
    return state


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """Returns ``train_step(params, state, batch) -> (params, state,
    metrics)``. The step updates ``params`` and ``state`` in place (JAX
    donates them) and returns them; ``metrics`` holds ``loss``, ``lr`` and
    ``grad_norm`` as scalar tensors (the loss and the norm on the
    parameters' device, the rate on the CPU)."""
    cast = getattr(torch, tcfg.cast_params) if tcfg.cast_params else None

    def compute_copy(p):
        if cast is not None and p.dtype == F32 and p.ndim >= 2:
            p = p.to(cast)
        # over a mesh, the compute copy is gathered along the batch axes
        # once a step (the FSDP gather); its gradients stay partial sums
        # over the microbatches, reduce-scattered once after them
        return spmd.gather_over(p, tcfg.batch_axes).detach() \
            .requires_grad_()

    def grads_of(params, batch):
        leaves = [compute_copy(p) for p in T.leaves(params)]
        tree = T.rebuild(params, leaves)
        m = tcfg.microbatches
        if m > 1 and tcfg.batch_axes:
            parts = {k: spmd.split_rows(v, m) for k, v in batch.items()}
            micro = [{k: v[i] for k, v in parts.items()} for i in range(m)]
        elif m > 1:
            micro = [{k: v.chunk(m)[i] for k, v in batch.items()}
                     for i in range(m)]
        else:
            micro = [batch]
        gsum = lsum = None
        for mb in micro:
            loss = registry.loss_fn(tree, cfg, mb)
            g = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
            g = [x.to(F32) for x in g]
            if gsum is None:
                gsum, lsum = g, loss.detach()
            else:
                spmd.accumulate(gsum, g)
                lsum = lsum + loss.detach()
        if tcfg.batch_axes:
            # the partial sums over the batch shards, reduce-scattered to
            # the masters' placements
            gsum = [spmd.like(g, p) for g, p in zip(gsum, T.leaves(params))]
        if m > 1:
            torch._foreach_div_(gsum, m)
            lsum = lsum / m
        return lsum, T.rebuild(params, gsum)

    def train_step(params, state, batch):
        loss, grads = grads_of(params, batch)
        new_state = dict(state)
        if tcfg.compress_grads:
            grads, new_state["err_fb"] = compression.compress_grads(
                grads, state["err_fb"])
        params, new_state["opt"], metrics = opt.update(
            tcfg.adamw, params, grads, state["opt"])
        metrics["loss"] = loss
        return params, new_state, metrics

    return train_step
