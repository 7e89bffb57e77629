"""Tensor-parallel serving plan over a ``(data, model)`` ``DeviceMesh``
(the JAX ``sharding/tp.py`` on ``torch.distributed``).

The design is SPMD: every rank runs the same engine, host loop included,
with its own shard of the weights and of the paged KV pool, and the
engine enters the plan (``active``) around each program the JAX engine
wraps in ``shard_map`` (the decode step, prefill admission, the suffix
prefill, swap-restore, the copy-on-write page copy). The unchanged model
code in ``repro_torch.models`` sees the plan through ``current`` and
routes through the gather hooks below. Every hook is the identity when
no plan is active, so a single-rank engine runs exactly what it ran
without this module, captured graphs included.

* ``Plan`` / ``make_plan``: which logical axes shard, resolved through
  the divisibility-gated rules of :mod:`repro_torch.sharding.rules`
  (``heads`` / ``kv_heads`` / ``mlp`` / ``vocab`` over ``model``, the
  slot batch over ``data``). Head counts that do not divide fall back to
  replicated heads, the MLP and vocab axes still sharded.
* ``shard_params`` / ``param_specs`` / ``put_cache`` / ``kv_spec``: this
  rank's slice of the dense-family weights and of the paged pool. The
  fused gate/up columns are permuted once, at load, so each model shard
  holds its own ``(gate_m, up_m)`` pair and ``silu_and_mul`` splits
  locally.
* ``gather_heads`` / ``gather_mlp`` / ``gather_vocab`` / ``gather_data``
  / ``data_shard``: the collective hooks. Every exchange is an
  all-gather on the mesh's ``model`` or ``data`` subgroup
  (``all_gather_into_tensor``), never a reduction: partial results are
  concatenated, not summed. A hook under an active plan raises when the
  process group is gone; nothing falls back to the unsharded path.

Unlike XLA, PyTorch's matrix products are not bitwise stable under
slicing: a product's bits may depend on the number of rows it is given
(a one-row product takes another path than a batch). Column slices (the
head, MLP and vocab shards) are what this plan cuts, and rows only along
``data``. What holds is measured, not assumed: ``launch/sharded_check.py``
holds the sharded engine's tokens and counters to the single-rank
engine's and reports the largest logit difference.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.sharding.rules import _resolve, axis_sizes


@dataclasses.dataclass(frozen=True)
class Plan:
    """Resolved sharding plan for one engine instance.

    ``heads`` / ``mlp`` / ``vocab`` say whether that logical axis shards
    over ``model``; ``batch`` whether the slot axis shards over ``data``.
    All False is fully replicated execution. ``mesh`` is the
    ``DeviceMesh`` (or, for rule arithmetic alone, a shape-only mesh)."""

    mesh: Any
    data: int
    model: int
    heads: bool
    mlp: bool
    vocab: bool
    batch: bool

    def describe(self) -> dict:
        """Stats-friendly summary (``Engine.stats()["mesh"]``)."""
        return {"data": self.data, "model": self.model,
                "heads_tp": self.heads, "mlp_tp": self.mlp,
                "vocab_tp": self.vocab, "batch_dp": self.batch}

    def rank(self, axis: str) -> int:
        """This process's coordinate along mesh axis ``axis``."""
        return self.mesh.get_local_rank(axis)

    def group(self, axis: str):
        """The process group of this process's ``axis`` subgroup."""
        return self.mesh.get_group(axis)


def make_plan(cfg, mesh, slots: int) -> Plan:
    """Resolve ``cfg``'s logical axes against ``mesh`` via the rules.

    Heads shard only when *both* ``n_heads`` and ``n_kv_heads`` divide
    the model axis: the GQA query groups are kv-major, so a contiguous
    query-head shard lines up with its kv-head shard. MLP and vocab
    resolve independently (the replicated-heads fallback). The slot batch
    shards over ``data`` when it divides; weights and the KV pool stay
    replicated over ``data`` (serving has no gradient reduce, so FSDP's
    ``embed`` -> ``data`` rule is not applied here)."""
    if cfg.family != "dense":
        raise ValueError(
            f"mesh serving supports the dense family only (got "
            f"{cfg.family!r}: per-slot-coupled or stateful decode)")
    sizes = axis_sizes(mesh)
    if "model" not in sizes or "data" not in sizes:
        raise ValueError(f"mesh must carry ('data', 'model') axes, got "
                         f"{tuple(sizes)}")
    data, model = sizes["data"], sizes["model"]
    heads = (_resolve("heads", cfg.n_heads, mesh) == "model"
             and _resolve("kv_heads", cfg.n_kv_heads, mesh) == "model")
    mlp = _resolve("mlp", cfg.d_ff, mesh) == "model"
    vocab = _resolve("vocab", cfg.padded_vocab, mesh) == "model"
    batch = data > 1 and slots % data == 0
    return Plan(mesh=mesh, data=data, model=model, heads=heads,
                mlp=mlp, vocab=vocab, batch=batch)


# ---------------------------------------------------------------------------
# this rank's slices
# ---------------------------------------------------------------------------

def param_specs(params: dict, plan: Plan) -> dict:
    """The spec tree of the port's dense weight layout (one dict a layer,
    no stacked layer axis). Sharded projections produce local partials
    that are all-gathered *before* the replicated consumer (``wo``,
    ``w_down``), so those stay replicated, and so does the embedding
    (the token gather must be rank-local)."""
    h = "model" if plan.heads else None
    layers = []
    for p in params["layers"]:
        attn = {"wq": (None, h, None), "wk": (None, h, None),
                "wv": (None, h, None), "wo": (None, None, None)}
        for name in ("bq", "bk", "bv"):
            if name in p["attn"]:
                attn[name] = (h, None)
        for name in ("q_norm", "k_norm"):
            if name in p["attn"]:
                attn[name] = (None,)
        layers.append({
            "attn": attn,
            "mlp": {"w_gateup": (None, "model" if plan.mlp else None),
                    "w_down": (None, None)},
            "attn_norm": (None,), "mlp_norm": (None,)})
    return {"embed": (None, None), "layers": layers,
            "final_norm": (None,),
            "lm_head": (None, "model" if plan.vocab else None)}


def kv_spec(plan: Plan) -> tuple:
    """Spec of any KV tensor whose axis 3 is ``kv_heads``: the paged pool
    ``[L, pages, page, Hkv, dh]``, gathered page reads and the swap
    payload ``[L, 1, S, Hkv, dh]`` all share it."""
    return (None, None, None, "model" if plan.heads else None, None)


def kv_specs(plan: Plan) -> dict:
    """``{"k", "v"}`` spec tree matching the paged pool."""
    s = kv_spec(plan)
    return {"k": s, "v": s}


def _local(t: torch.Tensor, spec: tuple, plan: Plan) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (whole where no
    dimension names ``model``)."""
    for dim, name in enumerate(spec):
        if name == "model":
            n = t.shape[dim] // plan.model
            t = t.narrow(dim, plan.rank("model") * n, n)
    return t.contiguous()


def _take(tree, specs, plan: Plan):
    if isinstance(tree, dict):
        return {k: _take(v, specs[k], plan) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_take(v, s, plan) for v, s in zip(tree, specs)]
    return _local(tree, specs, plan)


def gateup_permutation(d_ff: int, model: int) -> np.ndarray:
    """Column permutation putting ``(gate_m, up_m)`` on model shard m.

    ``w_gateup [D, 2F]`` fuses gate columns ``[0, F)`` and up columns
    ``[F, 2F)``; plain column sharding would hand shard 0 gate columns
    only. The permuted order is pure column movement, so gathering the
    per-shard ``silu_and_mul`` outputs restores the original column
    order (``gather_mlp``)."""
    fl = d_ff // model
    return np.concatenate([
        np.r_[m * fl:(m + 1) * fl, d_ff + m * fl:d_ff + (m + 1) * fl]
        for m in range(model)])


def shard_params(params: dict, cfg, plan: Plan) -> dict:
    """This rank's slice of the dense weight tree per ``param_specs``,
    the fused gate/up columns permuted first when the MLP axis shards."""
    if plan.mlp:
        perm = torch.from_numpy(gateup_permutation(cfg.d_ff, plan.model))
        layers = []
        for p in params["layers"]:
            wg = p["mlp"]["w_gateup"]
            wg = wg.index_select(-1, perm.to(wg.device))
            layers.append(dict(p, mlp=dict(p["mlp"], w_gateup=wg)))
        params = dict(params, layers=layers)
    return _take(params, param_specs(params, plan), plan)


def put_cache(cache: dict, plan: Plan) -> dict:
    """This rank's slice of a freshly built paged pool (its KV heads)."""
    return _take(cache, kv_specs(plan), plan)


def replicate(x: torch.Tensor, plan: Plan) -> torch.Tensor:
    """A carry buffer replicated over the mesh. Under SPMD every rank
    already holds the whole carry, so this is ``x`` itself (JAX places it
    with a replicated sharding)."""
    return x


# ---------------------------------------------------------------------------
# the plan in effect + collective hooks
# ---------------------------------------------------------------------------

_ACTIVE: contextvars.ContextVar[Optional[Plan]] = contextvars.ContextVar(
    "repro_torch_tp_plan", default=None)


@contextlib.contextmanager
def active(plan: Optional[Plan]):
    """Make ``plan`` visible to the model code run inside the block (the
    JAX engine enters it inside each ``shard_map`` body). ``None`` leaves
    whatever is in effect."""
    if plan is None:
        yield
        return
    token = _ACTIVE.set(plan)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def current() -> Optional[Plan]:
    """The plan in effect, or None (single-rank paths)."""
    return _ACTIVE.get()


def _all_gather(x: torch.Tensor, axis: int, plan: Plan,
                mesh_axis: str) -> torch.Tensor:
    """Tiled all-gather of ``x`` along tensor ``axis`` over the
    ``mesh_axis`` subgroup: the ranks' blocks concatenated in rank
    order."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError(
            "a tensor-parallel plan is active but no process group is "
            "initialized (launch.mesh.init_world)")
    group = plan.group(mesh_axis)
    n = dist.get_world_size(group)
    src = x.movedim(axis, 0).contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, axis).contiguous()


def gather_heads(o: torch.Tensor) -> torch.Tensor:
    """All-gather attention outputs ``[B, S, H_local, dh]`` over
    ``model`` before the replicated ``wo`` product. Identity when heads
    are replicated or no plan is active."""
    p = _ACTIVE.get()
    if p is None or not p.heads:
        return o
    return _all_gather(o, 2, p, "model")


def gather_mlp(h: torch.Tensor) -> torch.Tensor:
    """All-gather ``silu_and_mul`` outputs ``[..., F_local]`` over
    ``model`` before the replicated down projection; the gate/up column
    permutation makes the concatenation the original column order."""
    p = _ACTIVE.get()
    if p is None or not p.mlp:
        return h
    return _all_gather(h, h.ndim - 1, p, "model")


def gather_vocab(logits: torch.Tensor) -> torch.Tensor:
    """All-gather vocab-sharded logits ``[..., V_local]`` over ``model``:
    the argmax, the draw and the ``[:, :vocab]`` slice need the full
    padded vocabulary in its original order."""
    p = _ACTIVE.get()
    if p is None or not p.vocab:
        return logits
    return _all_gather(logits, logits.ndim - 1, p, "model")


def data_shard(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """This data shard's rows of the slot axis. Identity when the batch
    is replicated over ``data`` (a slot count that does not divide,
    data 1, prefill's batch of one, or no plan)."""
    p = _ACTIVE.get()
    if p is None or not p.batch or x.shape[axis] % p.data != 0:
        return x
    shard = x.shape[axis] // p.data
    return x.narrow(axis, p.rank("data") * shard, shard)


def gather_data(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """All-gather ``data``-sharded per-slot values back to the full slot
    axis (the new K/V rows for the pool write, which every data shard
    holds whole, and the per-slot token). Identity when the batch is
    replicated over ``data``."""
    p = _ACTIVE.get()
    if p is None or not p.batch:
        return x
    return _all_gather(x, axis, p, "data")
