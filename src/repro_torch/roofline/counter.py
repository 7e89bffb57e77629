"""What rank 0 of a sharded step does, counted op by op: the counterpart of
the JAX package's ``roofline/hlo_parser.py``.

JAX lowers the step with XLA and parses the optimized per-device HLO
text: dot FLOPs, per-element arithmetic, the operand and output bytes at
every fusion boundary, and the payload of every collective. The port
has no compiler in the way, so ``Counter`` is a ``TorchDispatchMode``
that sees each op rank 0 runs as it runs, on the local shards of a
DTensor step under fake tensors (``launch/dryrun.py``):

* FLOPs: ``2 * out * contract`` for ``mm``, ``bmm``, ``addmm``,
  ``baddbmm`` and convolution; per output element for arithmetic, with
  JAX's weights (1 for add, compare, select, ...; 8 for exp, log, tanh,
  the logistic; 4 for the square roots; 10 for pow);
* device-memory bytes: the operands plus the output of each op. In eager
  PyTorch an op is a kernel, so its boundary is the round trip through
  device memory, as the fusion boundary is in XLA. Views move nothing, a
  copy reads its source and writes its destination, a gather reads and
  writes the rows it takes, and an indexed write moves only the touched
  rows (JAX's rule for scatter and dynamic-update-slice);
* collectives: the output payload of each all-gather, all-reduce,
  reduce-scatter, all-to-all and broadcast, with JAX's ring factors (an
  all-reduce 2x), by kind and by the mesh axis whose group it runs on,
  and by the site that issued it (``Totals.sites``: the ``sharding`` or
  ``kernels`` function that redistributed explicitly, else the DTensor
  op whose redistribution it is, at the innermost line of the port's
  model or training code on the stack, or in the backward node autograd
  is running);
* peak live bytes: every storage alive at once, the step's arguments and
  its temporaries (JAX's ``temp + args + out - alias``).

Regions (``sharding/spmd.py``): inside a hand-written kernel's region the
plain version's ops are not counted, nor its temporaries; the kernel is
charged its registered cost at the call's local shapes (device-memory
bytes, and its instructions as FLOPs). Inside a JAX kernel region
(``flash``, ``mlstm``, ``slstm``, ``rglru``) FLOPs count and bytes do
not: ``roofline/analysis.py::kernel_traffic`` adds the region's analytic
traffic instead, as JAX does.

Two traps of counting under DTensor. A dispatch mode sees a DTensor op at
its global shape before DTensor splits it: ``Counter`` declines every op
with a DTensor argument and counts the local op that follows. And
DTensor's sharding propagation runs an op once more on global-shape fake
tensors to learn its output's shape (``ShardingPropagator.
_propagate_tensor_meta_non_cached``): those runs are not rank 0's work,
and ``Counter`` skips every op issued from inside it. That method is
private to DTensor: a torch without it makes ``Counter`` refuse to start
rather than count those runs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# collective kind -> wire factor per output byte (ring algorithms), JAX's
COLL_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
               "all-to-all": 1.0, "broadcast": 1.0}
_C10D = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
         "all_gather_into_tensor": "all-gather",
         "all_gather_into_tensor_out": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter",
         "all_to_all_single": "all-to-all", "broadcast": "broadcast",
         "broadcast_": "broadcast"}

# FLOPs per output element (JAX's _ARITH_1FLOP and _ARITH_XFLOP, by aten
# name; silu and gelu as XLA decomposes them)
_ONE = ("add sub rsub mul div maximum minimum abs neg eq ne lt le gt ge "
        "where logical_and logical_or logical_xor logical_not bitwise_and "
        "bitwise_or bitwise_xor bitwise_not clamp clamp_min clamp_max "
        "floor ceil round sign reciprocal remainder fmod").split()
_X = {"exp": 8, "exp2": 8, "log": 8, "log2": 8, "tanh": 8, "rsqrt": 4,
      "sqrt": 4, "pow": 10, "sigmoid": 8, "sin": 8, "cos": 8, "expm1": 8,
      "log1p": 8, "erf": 8, "erfinv": 8, "atan2": 10, "silu": 9,
      "softplus": 17, "gelu": 14}
ELEM_FLOPS = {**{k: 1 for k in _ONE}, **_X}
# reductions: one FLOP per output element (JAX's reduce rule)
REDUCE = set("sum mean amax amin max min prod any all argmax argmin var "
             "std norm linalg_vector_norm logsumexp".split())
# per input element: max, subtract, exp, sum, divide (XLA's softmax)
SOFTMAX = {"_softmax": 10, "_log_softmax": 10, "cumsum": 1, "cumprod": 1,
           "sort": 0, "topk": 0}

# ops that make a view or move nothing
VIEWS = set(("view _unsafe_view _reshape_alias expand permute transpose t "
             "unsqueeze squeeze select slice narrow as_strided alias detach "
             "unbind split split_with_sizes chunk diagonal unfold "
             "view_as_real view_as_complex lift_fresh lift_fresh_copy "
             "empty empty_like empty_strided new_empty new_empty_strided "
             "_local_scalar_dense sym_size sym_stride sym_numel "
             "sym_storage_offset is_same_size _has_compatible_shallow_copy"
             "_type device wait_tensor set_ _to_copy_meta "
             "resolve_conj resolve_neg _conj _neg_view").split())
# indexed writes: only the touched rows move (JAX: 2 x (operands - the
# largest, the updated buffer))
SCATTER = set("index_put index_put_ _index_put_impl _index_put_impl_ "
              "scatter scatter_ scatter_add scatter_add_ index_copy "
              "index_copy_ index_add index_add_ slice_scatter "
              "select_scatter masked_scatter".split())
# gathers: the rows taken are read and written, plus the indices
GATHER = set("index gather embedding index_select take".split())
MATMUL = set("mm bmm addmm baddbmm addbmm convolution".split())
# ops that only write their output
WRITES = set("fill zero zeros ones full arange zeros_like ones_like "
             "full_like scalar_tensor".split())


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(items) -> list:
    """The tensors among ``items`` and inside its lists and tuples (an
    op's arguments are at most one level deep)."""
    out = []
    for a in items:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(b for b in a if isinstance(b, torch.Tensor))
    return out


def _name(func) -> str:
    return func.__name__.split(".")[0]


_PROPAGATE = "_propagate_tensor_meta_non_cached"
_PORT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_OWN = os.path.join(_PORT, "roofline")
_HELPERS = (os.path.join(_PORT, "sharding"), os.path.join(_PORT, "kernels"))


def _site() -> tuple:
    """(where, helper): where an op was issued, as the backward node that
    autograd's engine is running, or as ``file:line`` of the innermost
    frame of the port's model or training code on the stack; and the
    outermost ``sharding`` or ``kernels`` function between them, if any."""
    helper, f = None, sys._getframe(1)
    node = torch._C._current_autograd_node()
    while f is not None:
        fn = f.f_code.co_filename
        if fn.startswith(_PORT) and not fn.startswith(_OWN):
            if not fn.startswith(_HELPERS):
                where = f"{os.path.relpath(fn, _PORT)}:{f.f_lineno}"
                break
            helper = f"{os.path.basename(fn)[:-3]}." \
                f"{f.f_code.co_name}"
        f = f.f_back
    else:
        where = None
    if node is not None:
        where = f"backward of {node.name()}"
    return where, helper


def matmul_flops(name: str, args, out) -> float:
    """``2 * out * contract`` of a matrix product or convolution."""
    if name in ("mm", "bmm"):
        a = args[0]
        return 2.0 * out.numel() * a.shape[-1]
    if name in ("addmm", "baddbmm", "addbmm"):
        a = args[1]
        return 2.0 * out.numel() * a.shape[-1]
    # convolution(input, weight, ...): contract over the kernel window and
    # the input channels of a group
    w = args[1]
    return 2.0 * out.numel() * (w.numel() // w.shape[0])


@dataclasses.dataclass
class Totals:
    """A counter's results: FLOPs (and of them the matrix products'),
    device-memory bytes, collective wire bytes by (kind, axis) and by
    (kind, axis, site), each kernel's (calls, bytes, FLOPs), and the peak
    live bytes."""
    flops: float
    matmul_flops: float
    bytes: float
    coll: dict
    kernels: dict
    peak: float
    sites: dict = dataclasses.field(default_factory=dict)

    @property
    def coll_bytes(self) -> float:
        """Collective wire bytes over every kind and axis."""
        return sum(self.coll.values())

    @staticmethod
    def combine(terms) -> "Totals":
        """``sum(c * t for c, t in terms)``, field by field (the peak too)."""
        zero = (0.0, 0.0, 0.0)
        names = {k for _, t in terms for k in t.kernels}

        def add(field):
            keys = {k for _, t in terms for k in getattr(t, field)}
            return {k: sum(c * getattr(t, field).get(k, 0.0)
                           for c, t in terms) for k in keys}
        return Totals(
            sum(c * t.flops for c, t in terms),
            sum(c * t.matmul_flops for c, t in terms),
            sum(c * t.bytes for c, t in terms),
            add("coll"),
            {k: tuple(sum(c * t.kernels.get(k, zero)[i] for c, t in terms)
                      for i in range(3)) for k in names},
            sum(c * t.peak for c, t in terms),
            add("sites"))


def trip_counts(traced: dict, n: int, m: int) -> Totals:
    """What ``n`` repetitions of one section (a model's layers) and ``m``
    of another (a step's microbatches) count, from traces at 1 and 2 of
    each (``traced[(i, j)]``; a section traced only at its full count is
    taken as is): counts are linear in each count and in their product,
    as JAX's trip-count rule multiplies a loop's body by its trips."""
    ks = sorted({k for k, _ in traced})
    ms = sorted({j for _, j in traced})
    a = (n - 1) if ks == [1, 2] else 0
    b = (m - 1) if ms == [1, 2] else 0
    k1, k2 = ks[0], ks[-1]
    m1, m2 = ms[0], ms[-1]
    weights = (((k1, m1), 1 - a - b + a * b), ((k2, m1), a - a * b),
               ((k1, m2), b - a * b), ((k2, m2), a * b))
    terms: dict = {}
    for key, w in weights:
        terms[key] = terms.get(key, 0) + w
    return Totals.combine([(w, traced[key]) for key, w in terms.items()
                           if w])


class Counter(TorchDispatchMode):
    """Count rank 0's FLOPs, device-memory bytes, collectives and live
    memory while it is active (``with Counter(mesh): step(...)``).

    ``mesh`` (a ``DeviceMesh``) names the axis of each collective by its
    group; a collective on another group is put under ``"other"``.
    ``hold(tree)`` makes already existing tensors (the step's arguments)
    count as live."""

    def __init__(self, mesh=None):
        super().__init__()
        self.flops = 0.0
        self.matmul_flops = 0.0
        self.bytes = 0.0
        self.coll: dict = defaultdict(float)    # (kind, axis) -> bytes
        self.sites: dict = defaultdict(float)   # (kind, axis, site) -> bytes
        self.kernels: dict = defaultdict(lambda: [0.0, 0.0, 0.0])
        self.live = 0
        self.peak = 0
        self._axes = {}         # group name -> (mesh axis, ranks)
        if mesh is not None:
            for name in mesh.mesh_dim_names:
                self._axes[mesh.get_group(name).group_name] = \
                    (name, mesh[name].size())
        self._store: dict = {}      # storage key -> [nbytes, refs, live]
        self._seen: set = set()     # ids of the tensors tracked
        self._regions: list = []    # (name, kind, storages it made)
        self._shadow = 0
        self._prop = None
        self._dt = None             # the last DTensor op declined

    # -- the step's arguments ---------------------------------------------
    def hold(self, tree) -> None:
        """Count the storages of every tensor in ``tree`` (DTensors by
        their local shard) as live from now on."""
        from torch.distributed.tensor import DTensor
        leaves, _ = tree_flatten(tree)
        for t in leaves:
            if isinstance(t, DTensor):
                t = t._local_tensor      # lives as long as the DTensor
            if isinstance(t, torch.Tensor):
                self._track(t)
        self.peak = max(self.peak, self.live)

    @property
    def coll_bytes(self) -> float:
        """Collective wire bytes over every kind and axis."""
        return sum(self.coll.values())

    def totals(self) -> "Totals":
        """What was counted, as a ``Totals``."""
        return Totals(self.flops, self.matmul_flops, self.bytes,
                      dict(self.coll),
                      {k: tuple(v) for k, v in self.kernels.items()},
                      self.peak, dict(self.sites))

    # -- regions --------------------------------------------------------------
    @contextlib.contextmanager
    def region(self, name: str, kind: str, cost=None):
        """A kernel (``kind="kernel"``; ``cost()`` its registered cost) or a
        JAX kernel region (``"analytic"``). Inside a kernel, nothing nested
        counts."""
        if self._regions and self._regions[-1][1] == "kernel":
            yield
            return
        if kind == "kernel":
            c = cost()
            k = self.kernels[name]
            k[0] += 1
            k[1] += c.total("dram_bytes")
            k[2] += c.total("alu_ops") + c.total("sfu_ops")
            self.bytes += c.total("dram_bytes")
            self.flops += c.total("alu_ops") + c.total("sfu_ops")
        made: list = []
        self._regions.append((name, kind, made))
        try:
            yield
        finally:
            self._regions.pop()
            if kind == "kernel":
                # what the kernel's call made and still holds is its
                # output; the plain version's temporaries are gone
                for key in made:
                    rec = self._store.get(key)
                    if rec is not None and not rec[2]:
                        rec[2] = True
                        self.live += rec[0]
                self.peak = max(self.peak, self.live)

    # -- storages ------------------------------------------------------------
    def _release(self, tid: int, key) -> None:
        self._seen.discard(tid)
        rec = self._store.get(key)
        if rec is None:
            return
        rec[1] -= 1
        if rec[1] <= 0:
            if rec[2]:
                self.live -= rec[0]
            del self._store[key]

    def _track(self, t: torch.Tensor) -> None:
        tid = id(t)
        if tid in self._seen:
            return
        st = t.untyped_storage()
        key = st._cdata
        self._seen.add(tid)
        rec = self._store.get(key)
        if rec is None:
            in_kernel = bool(self._regions) \
                and self._regions[-1][1] == "kernel"
            rec = self._store[key] = [st.nbytes(), 0, not in_kernel]
            if in_kernel:
                self._regions[-1][2].append(key)
            else:
                self.live += rec[0]
        rec[1] += 1
        weakref.finalize(t, self._release, tid, key)

    # -- the sharding propagator's global-shape runs --------------------------
    def __enter__(self):
        from torch.distributed.tensor import DTensor
        prop = DTensor._op_dispatcher.sharding_propagator
        if not callable(getattr(prop, _PROPAGATE, None)):
            raise RuntimeError(
                f"this torch's ShardingPropagator has no {_PROPAGATE}: the "
                "counter cannot tell its global-shape runs from rank 0's")
        orig = getattr(prop, _PROPAGATE)    # an outer counter's shadow, or not

        def shadow(*args, **kwargs):
            self._shadow += 1
            try:
                return orig(*args, **kwargs)
            finally:
                self._shadow -= 1

        self._prop = (prop, prop.__dict__.get(_PROPAGATE))
        setattr(prop, _PROPAGATE, shadow)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            prop, before = self._prop
            if before is None:
                delattr(prop, _PROPAGATE)
            else:
                setattr(prop, _PROPAGATE, before)
            self._prop = None

    # -- the ops -----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            if not self._shadow:
                self._dt = _name(func)
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._shadow:
            return out
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        for t in outs:
            self._track(t)
        self.peak = max(self.peak, self.live)
        if self._regions and self._regions[-1][1] == "kernel":
            return
        name = _name(func)
        ns = func.namespace
        ins = _tensors((*args, *kwargs.values()))
        if ns in ("_c10d_functional", "_c10d_functional_autograd",
                  "c10d_functional"):
            kind = _C10D.get(name)
            if kind is None:
                return
            group = next((a for a in (*args, *kwargs.values())
                          if isinstance(a, str) and a in self._axes),
                         None)
            axis, ranks = self._axes.get(group, ("other", 2))
            if ranks == 1:                  # nothing leaves the card
                return
            payload = sum(map(_nbytes, outs))
            self.coll[(kind, axis)] += payload * COLL_FACTOR[kind]
            # a collective no helper issued is the redistribution of the
            # DTensor op being dispatched (the port redistributes
            # explicitly only through sharding/ and kernels/)
            where, helper = _site()
            self.sites[(kind, axis, f"{helper or self._dt} at {where}")] += \
                payload * COLL_FACTOR[kind]
            self.bytes += payload
            return
        analytic = bool(self._regions)     # inside flash/mlstm/slstm/rglru
        base = name.rstrip("_") if name.endswith("_") \
            and not name.startswith("_") else name
        flops = 0.0
        if base in MATMUL:
            flops = matmul_flops(base, args, outs[0])
            self.matmul_flops += flops
            if base in ("addmm", "baddbmm", "addbmm"):
                flops += outs[0].numel()
        elif base in ELEM_FLOPS:
            n = outs[0].numel() if outs else (ins[0].numel() if ins else 0)
            flops = ELEM_FLOPS[base] * n
        elif base in REDUCE:
            flops = sum(t.numel() for t in outs)
        elif base in SOFTMAX:
            flops = SOFTMAX[base] * (ins[0].numel() if ins else 0)
        elif name.startswith("_foreach_"):
            op = name[len("_foreach_"):].rstrip("_")
            lists = [a for a in args if isinstance(a, (list, tuple))]
            n = sum(t.numel() for t in lists[0]) if lists else 0
            flops = ELEM_FLOPS.get(op, 2 if op.startswith("addc") else 1) * n
        self.flops += flops
        if analytic or base in VIEWS or name in VIEWS:
            return
        if base in SCATTER:
            sizes = [_nbytes(t) for t in ins]
            moved = 2 * (sum(sizes) - max(sizes)) if sizes else 0
        elif base in GATHER:
            moved = 2 * sum(map(_nbytes, outs)) + sum(
                _nbytes(t) for t in ins[1:]
                if not t.is_floating_point())
        elif base == "copy":
            moved = _nbytes(ins[1]) + _nbytes(ins[0]) if len(ins) > 1 \
                else 2 * _nbytes(ins[0])
        elif base in WRITES:
            moved = sum(map(_nbytes, outs))
        else:
            moved = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        self.bytes += moved
