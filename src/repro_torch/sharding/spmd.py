"""The port's models on DTensors: the sharded step the dry run traces.

``launch/dryrun.py`` runs the real step functions with the parameters,
the cache and the batch as ``torch.distributed.tensor`` DTensors placed by
``sharding/rules.py`` (the counterpart of ``jax.jit(in_shardings=)``):
DTensor's sharding propagation places every plain PyTorch op, as GSPMD
places every HLO op. Two kinds of code do not go through that
propagation; they run on each rank's local shards instead, through the
helpers here:

* the hand-written kernels (``kernels/ops.py``). A CUDA kernel reads its
  operands' memory, so it runs on the local shard, its inputs first
  redistributed to placements under which the local call computes the
  right shard;
* the regions the JAX package marks as one fused kernel (``flash`` in
  ``layers.flash_attention``, the ``mlstm`` and ``slstm`` scans, the
  ``rglru`` scan) and the decode cache write. Each is independent per
  batch row and per head (or recurrent channel), so on the local shards
  of batch and heads it needs no collective, where DTensor has no
  sharding strategy for much of its indexing and reshaping.

On plain tensors (one card: the serving and training paths) every helper
calls straight through, so nothing here changes what the models compute.

Each region also tells an active roofline counter (``roofline/counter.py``,
found on torch's dispatch-mode stack) where it starts and ends: a kernel
is charged its registered cost at the local shapes and its plain
version's ops are not counted; a JAX kernel region keeps its FLOPs and is
charged JAX's analytic traffic instead of its ops' bytes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Optional, Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack


def distributed(*tensors) -> bool:
    """True when any of ``tensors`` is a DTensor."""
    return any(isinstance(t, DTensor) for t in tensors)


# --------------------------------------------------------------------------
# the roofline counter's regions
# --------------------------------------------------------------------------

def _counter():
    """The innermost active roofline counter, or None."""
    if not torch._C._len_torch_dispatch_stack():
        return None
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if hasattr(mode, "region"):
            return mode
    return None


@contextlib.contextmanager
def region(name: str):
    """A JAX kernel region (``flash``, ``mlstm``, ``slstm``, ``rglru``): an
    active counter keeps its FLOPs and charges JAX's analytic traffic for
    it, not its ops' bytes."""
    c = _counter()
    if c is None:
        yield
        return
    with c.region(name, "analytic"):
        yield


@contextlib.contextmanager
def kernel(name: str, variant, **shape_info):
    """One call of the hand-written kernel ``name`` (its registered space's
    name) with genome ``variant`` at ``shape_info`` (its cost function's
    keywords): an active counter charges the registered cost and none of
    the plain version's ops. Yields True when the counter traces shapes
    alone (under fake tensors): the caller may then return empty outputs
    of the kernel's shapes instead of running the plain version, whose
    values nothing reads."""
    c = _counter()
    if c is None:
        yield False
        return

    def cost():
        from repro_torch.kernels import registry
        return registry.get_space(name).cost(variant, **shape_info)

    with c.region(name, "kernel", cost):
        yield torch._C._get_dispatch_mode(
            torch._C._TorchDispatchModeKey.FAKE) is not None


# --------------------------------------------------------------------------
# local calls
# --------------------------------------------------------------------------

def _redistribute(t: DTensor, placements) -> DTensor:
    """``t`` redistributed to ``placements`` one mesh dimension at a time
    (DTensor's planner searches every order of a change to several
    dimensions at once, which takes seconds from partial sums on two)."""
    target = tuple(placements)
    for m in range(len(target)):
        if t.placements[m] != target[m]:
            step = list(t.placements)
            step[m] = target[m]
            t = t.redistribute(t.device_mesh, tuple(step))
    return t


def like(t, ref):
    """``t`` in ``ref``'s placements (a plain tensor as it is)."""
    if not isinstance(t, DTensor):
        return t
    return _redistribute(t, ref.placements)


def accumulate(sums: list, terms: list) -> None:
    """``sums[i] += terms[i]`` in place (``torch._foreach_add_``). On
    DTensors each term is first put in its sum's placements (the same
    ones, for a microbatch's gradients: nothing moves) and the local
    shards are added, so partial sums stay partial whatever DTensor's
    strategy for the foreach op (torch 2.11's all-reduces each term)."""
    if not distributed(*sums):
        torch._foreach_add_(sums, terms)
        return
    terms = [like(t, s) for s, t in zip(sums, terms)]
    with torch.no_grad():
        torch._foreach_add_([s.to_local() for s in sums],
                            [t.to_local() for t in terms])


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _wrap(local: torch.Tensor, mesh, placements, shape) -> DTensor:
    # a DTensor's global strides are given as contiguous, so its local
    # shard must be (the view a caller takes of it copies otherwise too)
    return DTensor.from_local(local.contiguous(), mesh, tuple(placements),
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def shard_batch(x, last: str | None = None):
    """JAX's ``layers.shard_batch`` on a DTensor: the leading (batch)
    dimension split over ``("pod", "data")`` (or ``data`` alone where the
    pair does not divide it), every other dimension whole (the last one
    split over the mesh axis ``last`` where given and it divides) and
    partial sums reduced; its gradient is pinned the same way. The model
    pins its activations so at block boundaries, as JAX's do, so that FSDP
    gathers the weights and the activations stay batch-split. A plain
    tensor is returned as it is."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    axes = [n for n in ("pod", "data") if n in names]
    if x.shape[0] % math.prod(mesh[n].size() for n in axes):
        axes = ["data"] if "data" in names \
            and x.shape[0] % mesh["data"].size() == 0 else []
    split_last = last in names and x.shape[-1] % mesh[last].size() == 0
    pl = tuple(Replicate() if mesh[n].size() == 1 else
               Shard(0) if n in axes else
               Shard(x.ndim - 1) if split_last and n == last else Replicate()
               for n in names)
    if torch.is_grad_enabled() and x.requires_grad:
        return _Pin.apply(x, pl)
    return _redistribute(x, pl)


class _Pin(torch.autograd.Function):
    """A redistribution whose gradient is redistributed the same way (as
    JAX's ``with_sharding_constraint`` constrains the cotangent too)."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return _redistribute(x, placements)

    @staticmethod
    def backward(ctx, g):
        return _redistribute(g, ctx.placements), None


def take_rows(table: DTensor, ids) -> DTensor:
    """``table[ids]`` (an embedding lookup) on each rank's shards: the
    table whole along its rows and split along its width as it is, the
    ids as they are (gathered where they and the table's width share a
    mesh dimension). No collective; the table's gradient is a partial sum
    over the mesh dimensions that split the ids."""
    mesh = table.device_mesh
    ids = ids if isinstance(ids, DTensor) else DTensor.from_local(
        ids, mesh, [Replicate()] * mesh.ndim, run_check=False)
    t_pl = [Shard(1) if isinstance(p, Shard) and p.dim % 2 == 1
            else Replicate() for p in table.placements]
    i_pl = [Replicate() if isinstance(t, Shard) or isinstance(p, Partial)
            else p for t, p in zip(t_pl, ids.placements)]
    table, ids = _redistribute(table, t_pl), _redistribute(ids, i_pl)
    grad = [Partial() if isinstance(p, Shard) else t
            for t, p in zip(t_pl, i_pl)]
    out = table.to_local(grad_placements=grad)[ids.to_local()]
    out_pl = [Shard(ids.ndim) if isinstance(t, Shard) else p
              for t, p in zip(t_pl, i_pl)]
    return _wrap(out, mesh, out_pl, (*ids.shape, table.shape[1]))


def rowwise(fn: Callable, rows: Sequence, *rest):
    """``fn(*rows, *rest)`` for a kernel that works on each row of the last
    dimension alone (the fused add + RMSNorm): the ``rows`` tensors take
    the first one's placements with the last dimension whole and partial
    sums reduced, ``rest`` (the weight) is replicated, and each tensor
    ``fn`` returns is one of the ``rows``' shape and placements."""
    x0 = rows[0]
    last = x0.ndim - 1
    pl = [Replicate() if isinstance(p, Partial)
          or (isinstance(p, Shard) and p.dim % x0.ndim == last) else p
          for p in x0.placements]
    rows = [_redistribute(r, pl) for r in rows]
    rest = [_redistribute(r, [Replicate()] * r.device_mesh.ndim).to_local()
            if isinstance(r, DTensor) else r for r in rest]
    out = fn(*[r.to_local() for r in rows], *rest)
    wrap = lambda t: _wrap(t, x0.device_mesh, pl, x0.shape)
    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def halves(fn: Callable, x: DTensor):
    """``fn(x)`` for a kernel that maps ``[..., 2d]`` to ``[..., d]`` row by
    row (the SwiGLU gate): partial sums are reduced, every shard is kept.
    A shard of the last dimension computes its own half-width output, as
    the tensor-parallel plan's permuted gate/up columns give each model
    shard its own (gate, up) pair (``sharding.tp.gateup_permutation``)."""
    pl = [Replicate() if isinstance(p, Partial) else p for p in x.placements]
    x = _redistribute(x, pl)
    out = fn(x.to_local())
    return _wrap(out, x.device_mesh, pl, (*x.shape[:-1], x.shape[-1] // 2))


def experts(fn: Callable, p: dict, x: DTensor, *, group: int):
    """``fn(local p, local x, first)`` for a mixture-of-experts block run
    expert-parallel: the experts' weights (``w_gateup``, ``w_down``) keep
    their expert shards and are gathered along every other dimension, the
    router is whole, and each rank routes its own tokens over every
    expert and runs its own experts (``first`` is the index of its first
    one). The tokens are gathered where a batch shard would cut one of the
    block's dispatch groups of ``group`` tokens (capacity is shared within
    a group). The output is a partial sum over the expert shards, in
    ``x``'s placements elsewhere."""
    mesh = x.device_mesh
    w = p["w_gateup"]
    e_axis = [m for m, q in enumerate(w.placements)
              if isinstance(q, Shard) and q.dim == 0]
    keep = lambda t: [Shard(0) if m in e_axis else Replicate()
                      for m in range(mesh.ndim)]
    local_p = {"router": _redistribute(p["router"], [Replicate()]
                                       * mesh.ndim).to_local(),
               "w_gateup": _redistribute(w, keep(w)).to_local(),
               "w_down": _redistribute(p["w_down"], keep(w)).to_local()}
    first = 0
    for m in e_axis:
        first += mesh.get_coordinate()[m] * (w.shape[0] // mesh.size(m))
    # tokens: the last dimension whole, partial sums reduced; batch shards
    # that cut a dispatch group, and any shard on the expert axes, gathered
    seq = x.shape[1]
    pl = []
    rows = x.shape[0]
    for m, q in enumerate(x.placements):
        if isinstance(q, Shard) and q.dim == 0 and m not in e_axis:
            if (rows // mesh.size(m)) * seq % group == 0:
                rows //= mesh.size(m)
                pl.append(q)
                continue
        pl.append(Replicate())
    xl = _redistribute(x, pl).to_local()
    out = fn(local_p, xl, first)
    out_pl = [Partial() if m in e_axis else q for m, q in enumerate(pl)]
    y = DTensor.from_local(out, mesh, tuple(out_pl), run_check=False,
                           shape=x.shape, stride=_contiguous_stride(x.shape))
    # back to x's batch shards where they were gathered (a local slice)
    back = [Shard(0) if isinstance(q, Shard) and q.dim == 0
            and isinstance(out_pl[m], Replicate) else out_pl[m]
            for m, q in enumerate(x.placements)]
    return _redistribute(y, back)


def gather_over(t, axes: Sequence[str]):
    """``t`` whole along the mesh axes ``axes`` (its shards there
    all-gathered, partial sums reduced), as it was along the others; a
    plain tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    names = t.device_mesh.mesh_dim_names
    return _redistribute(t, [Replicate() if n in axes else p
                             for n, p in zip(names, t.placements)])


def split_rows(x: DTensor, m: int) -> list:
    """``m`` microbatches of ``x [B, ...]`` that stay split as ``x`` is:
    microbatch i holds each shard's i-th share of its own rows, so nothing
    moves. Each shard's rows must divide by ``m``."""
    if not isinstance(x, DTensor):
        raise TypeError("split_rows splits a DTensor batch; a plain tensor "
                        "is cut with chunk")
    local = x.to_local()
    if local.shape[0] % m:
        raise ValueError(f"{local.shape[0]} rows a batch shard do not make "
                         f"{m} microbatches")
    shape = (x.shape[0] // m, *x.shape[1:])
    return [_wrap(part, x.device_mesh, x.placements, shape)
            for part in local.chunk(m)]


@dataclasses.dataclass(frozen=True)
class Local:
    """What a local attention call knows of its shard: the first global row
    of its sequence shard and the process group of the mesh dimension that
    splits the sequence (None when the sequence is whole)."""
    seq_offset: int = 0
    seq_group: Optional[object] = None


def unflatten(t, dim: int, sizes: tuple):
    """``t.unflatten(dim, sizes)``; a DTensor whose dimension ``dim`` is
    split over a mesh dimension that does not divide ``sizes[0]`` is
    gathered there first (DTensor refuses the uneven view)."""
    if isinstance(t, DTensor):
        dim %= t.ndim
        pl = [Replicate() if isinstance(p, Shard) and p.dim % t.ndim == dim
              and sizes[0] % t.device_mesh.size(m) else p
              for m, p in enumerate(t.placements)]
        t = _redistribute(t, pl)
    return t.unflatten(dim, sizes)


class _Flatten(torch.autograd.Function):
    """``t.flatten(dim, dim + 1)`` whose gradient goes back through
    ``unflatten``."""

    @staticmethod
    def forward(ctx, t, dim):
        ctx.dim = dim % t.ndim
        ctx.sizes = tuple(t.shape[ctx.dim:ctx.dim + 2])
        return t.flatten(ctx.dim, ctx.dim + 1)

    @staticmethod
    def backward(ctx, g):
        return unflatten(g, ctx.dim, ctx.sizes), None


def flatten(t, dim: int):
    """``t.flatten(dim, dim + 1)``; on a DTensor that requires grad its
    gradient is unflattened through ``unflatten``."""
    if isinstance(t, DTensor) and torch.is_grad_enabled() and t.requires_grad:
        return _Flatten.apply(t, dim)
    d = dim % t.ndim
    return t.flatten(d, d + 1)


def _shard_offsets(shape, mesh, placements):
    """(local shape, global offset) of this rank's shard: ``torch.chunk``'s
    split, mesh dimension by mesh dimension."""
    coord = mesh.get_coordinate()
    shape, off = list(shape), [0] * len(shape)
    for m, p in enumerate(placements):
        if not isinstance(p, Shard):
            continue
        if type(p) is not Shard:
            raise NotImplementedError(f"no local offset for {p}")
        d, n = p.dim % len(shape), mesh.size(m)
        chunk = -(-shape[d] // n)
        start = coord[m] * chunk
        off[d] += start
        shape[d] = max(0, min(chunk, shape[d] - start))
    return shape, off


def per_head(fn: Callable, lead: int, tensors: Sequence, roles: Sequence,
             *, seq_split: bool = False, out_roles: Sequence = ()):
    """``fn(Local, *local tensors)`` for code that is independent per batch
    row and per head (or channel): attention, the recurrent scans.

    ``roles[i]`` names each dimension of ``tensors[i]`` (``"bshd"``-like,
    from ``b``, ``h``, ``k``, ``s`` and ``.``). Tensor ``lead`` (the cache,
    which a decode step writes in place, or the query) keeps its
    placements where a mesh dimension shards one of these roles, and the
    others are redistributed to shard the same role on that mesh
    dimension: batch with batch, query heads with key/value heads (GQA
    groups stay whole on a shard). Where the query heads shard but the
    key/value heads cannot (fewer of them than the mesh dimension), each
    shard slices the key/value heads its query heads read, or, when its
    query heads cut a group, the heads are gathered. A sequence shard is
    kept only with ``seq_split`` (split-KV decode): ``fn`` gets its offset
    and group in ``Local``. Partial sums are reduced first. Returns
    ``fn``'s tensors as DTensors of the global shapes given with
    ``out_roles`` (``(shape, roles)`` pairs), in order; None when ``fn``
    returns None (an in-place write)."""
    mesh = next(t.device_mesh for t in tensors if isinstance(t, DTensor))
    # a plain tensor among DTensors is the same on every rank
    ts = [DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
          if isinstance(t, torch.Tensor) and not isinstance(t, DTensor)
          else t for t in tensors]
    lead_roles = roles[lead]
    axis_role = []
    for p in ts[lead].placements:
        r = lead_roles[p.dim % len(lead_roles)] if isinstance(p, Shard) \
            else "."
        axis_role.append(r if r in "bhk" or (r == "s" and seq_split)
                         else ".")

    def dims_of(i, role):
        return [d for d, r in enumerate(roles[i]) if r == role]

    def placements(i, kv_whole=None):
        out = []
        for m, r in enumerate(axis_role):
            want = {"h": "hk", "k": "kh"}.get(r, r)
            dims = [d for c in want for d in dims_of(i, c)]
            if r != "." and dims and not (
                    r == "h" and "k" in roles[i] and m in (kv_whole or ())):
                out.append(Shard(dims[0]))
            else:
                out.append(Replicate())
        return out

    # query heads sharded over a mesh dimension the key/value heads do not
    # divide: slice them locally, or gather the query heads
    q_idx = [i for i, r in enumerate(roles) if "h" in r]
    kv_idx = [i for i, r in enumerate(roles) if "k" in r]
    kv_whole, slice_kv = set(), None
    for m, r in enumerate(axis_role):
        if r != "h" or not kv_idx:
            continue
        hkv = ts[kv_idx[0]].shape[dims_of(kv_idx[0], "k")[0]]
        if hkv % mesh.size(m) == 0:
            continue
        kv_whole.add(m)
    if kv_whole:
        q0 = q_idx[0]
        hd = dims_of(q0, "h")[0]
        hq = ts[q0].shape[hd]
        hkv = ts[kv_idx[0]].shape[dims_of(kv_idx[0], "k")[0]]
        g = hq // hkv
        shape, off = _shard_offsets(ts[q0].shape, mesh, placements(q0))
        h0, n = off[hd], shape[hd]
        if n % g == 0 and h0 % g == 0:
            slice_kv = (h0 // g, n // g)
        elif h0 // g == (h0 + n - 1) // g:
            slice_kv = (h0 // g, 1)
        else:
            for m in kv_whole:
                axis_role[m] = "."
            kv_whole = set()

    local = []
    for i, t in enumerate(ts):
        if not isinstance(t, DTensor):
            local.append(t)
            continue
        x = _redistribute(t, placements(i, kv_whole)).to_local()
        if slice_kv is not None and "k" in roles[i] and kv_whole:
            x = x.narrow(dims_of(i, "k")[0], *slice_kv)
        local.append(x)

    info = Local()
    if "s" in axis_role:
        m = axis_role.index("s")
        sd = dims_of(lead, "s")[0]
        _, off = _shard_offsets(ts[lead].shape, mesh, ts[lead].placements)
        info = Local(seq_offset=off[sd], seq_group=mesh.get_group(m))
    out = fn(info, *local)
    if out is None:
        return None
    outs = out if isinstance(out, tuple) else (out,)
    wrapped = []
    for o, (shape, r) in zip(outs, out_roles):
        pl = []
        for m, role in enumerate(axis_role):
            dims = [d for d, c in enumerate(r) if c == role
                    or (role, c) in (("h", "k"), ("k", "h"))]
            pl.append(Shard(dims[0]) if role != "." and dims
                      and not (role == "s") else Replicate())
        wrapped.append(_wrap(o, mesh, pl, shape))
    return tuple(wrapped) if isinstance(out, tuple) else wrapped[0]
