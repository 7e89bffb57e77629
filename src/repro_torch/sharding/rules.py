"""Logical-axis sharding rules (the JAX ``sharding/rules.py``).

Every parameter and activation is annotated with a tuple of *logical* axis
names; this module maps logical axes to physical mesh axes. The same
rules serve the single-host ``(data, model)`` mesh, the multi-pod
``(pod, data, model)`` mesh, or one rank (every rule resolves to None).

Physical strategy:
  * FSDP/ZeRO-3: parameter "embed"-like axes shard over ``data`` (and
    ``pod`` composes with ``data`` for batch / FSDP at multi-pod scale).
  * TP: head / mlp / vocab / expert axes shard over ``model``.
  * SP (decode): the KV-cache sequence axis shards over ``model``.

A rule is skipped (the axis replicated) when the dim is not divisible by
the mesh axis size, e.g. qwen2's 14 heads on a 16-way model axis; the
MLP and vocab axes still shard.

A spec is a tuple with one entry per tensor dimension: a mesh-axis name,
a tuple of names (``pod`` composed with ``data``), or None (replicated),
the entries of JAX's ``PartitionSpec``. A sharding is the list of
``torch.distributed.tensor`` placements, one per mesh dimension. The mesh
is a ``DeviceMesh`` or any object with ``axis_names`` and a
``devices.shape`` (a shape-only stand-in for rule arithmetic).
"""

from __future__ import annotations

import math

# logical axis -> preferred physical mesh axes, tried in order.
RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod+data", "data"),
    "embed": ("data",),          # FSDP
    "vocab": ("model",),
    "embed_vocab": (),           # embedding table vocab axis: replicated so
                                 # the token gather stays rank-local
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "experts": ("model",),       # EP
    "expert_mlp": (),
    "kv_seq": ("model",),        # SP decode (split-KV + merge kernel)
    "seq": (),
    "layers": (),
    "head_dim": (),
    "lru": ("model",),
    "conv": (),
    "stack": (),
}


def axis_sizes(mesh) -> dict[str, int]:
    """{mesh axis name: size} of a ``DeviceMesh`` or a shape-only mesh."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _resolve(logical: str | None, dim: int, mesh):
    if logical is None:
        return None
    sizes = axis_sizes(mesh)
    for cand in RULES.get(logical, ()):
        if cand == "pod+data":
            names = tuple(n for n in ("pod", "data") if n in sizes)
            if not names:
                continue
            total = math.prod(sizes[n] for n in names)
            if dim % total == 0:
                return names if len(names) > 1 else names[0]
        elif cand in sizes and dim % sizes[cand] == 0:
            return cand
    return None


def spec_for(logical_axes: tuple, shape: tuple, mesh) -> tuple:
    """The spec (one entry per dimension) of a tensor with the given
    logical axes and shape."""
    if len(logical_axes) != len(shape):
        raise ValueError(f"{len(logical_axes)} logical axes "
                         f"{logical_axes} for shape {shape}")
    used: set[str] = set()
    out = []
    for logical, dim in zip(logical_axes, shape):
        r = _resolve(logical, dim, mesh)
        flat = r if isinstance(r, tuple) else ((r,) if r else ())
        if any(a in used for a in flat):
            r = None                      # a mesh axis can appear only once
        used.update(flat)
        out.append(r)
    return tuple(out)


def sharding_for(logical_axes: tuple, shape: tuple, mesh) -> list:
    """The ``torch.distributed.tensor`` placements, one per mesh
    dimension, of a tensor under its resolved spec: ``Shard(i)`` where
    tensor dimension i is split over that mesh axis, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    spec = spec_for(logical_axes, shape, mesh)
    placements = []
    for name in axis_sizes(mesh):
        dims = [i for i, r in enumerate(spec)
                if r == name or (isinstance(r, tuple) and name in r)]
        placements.append(Shard(dims[0]) if dims else Replicate())
    return placements


def tree_shardings(params, axes_tree, mesh):
    """The placements of every leaf of ``params`` (nested dicts and
    lists of tensors, or anything with a ``shape``) from a logical-axes
    tree of the same structure, whose leaves are tuples of axis names."""
    if isinstance(params, dict):
        return {k: tree_shardings(v, axes_tree[k], mesh)
                for k, v in params.items()}
    if isinstance(params, list):
        return [tree_shardings(p, a, mesh)
                for p, a in zip(params, axes_tree)]
    return sharding_for(axes_tree, tuple(params.shape), mesh)


def batch_spec(mesh, *trailing) -> tuple:
    """The spec of ``[batch, ...]`` activations: batch over pod+data."""
    names = tuple(n for n in ("pod", "data") if n in axis_sizes(mesh))
    lead = names if len(names) > 1 else (names[0] if names else None)
    return (lead, *trailing)
