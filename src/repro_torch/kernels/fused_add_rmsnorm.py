"""Fused residual add + RMSNorm (paper Kernel 2): the Hopper kernel, its
genome, its plain per-genome version and its registered search space.

The kernel is ``csrc/fused_add_rmsnorm.cu``; it replaces the TPU kernel
``repro/kernels/fused_add_rmsnorm.py::fused_add_rmsnorm`` (the one-pass
body ``_one_pass_kernel`` and the two-pass ``_pass1_kernel`` +
``_pass2_kernel``). It is bound by bytes, and at decode by its chain of
dependent steps. The shipped genome is the one-pass form: a row's x, r
and w are loaded in one round trip, ``r'`` stays in fp32 registers, and
the sum of squares takes warp shuffles and at most one barrier of the
row's own warps. ``two_pass`` writes ``r'`` and a per-row sum of squares,
then a second launch re-reads the rounded ``r'``; ``use_rsqrt`` picks
``rsqrtf`` over ``1 / sqrtf``; ``accum_fp32=False`` rounds the add to the
input dtype first.

Two knobs set the launch (``launch_shape``). ``row_threads`` is the most
threads on one row: a row gets the fewest whole warps that hold it at the
vectors a thread then needs (a power of two, at most ``NV_MAX``), so 32 is
one warp a row and a shuffle-only reduction. ``block_rows`` is the rows a
block takes (1-16, the port's range for JAX's tile height): the block
holds as many row groups as those rows and its thread limit allow, and a
group with more rows than one queues the next row's loads before it
reduces the current one. The baseline, like the shipped genome, takes one
row a block (the textbook launch). The weight is read in its own dtype,
fp32 or the input's, so the wrapper launches nothing but the kernel it
counts.

A CPU tensor takes ``plain``, the genome's arithmetic in PyTorch; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.registry import (KernelSpace, Knob, TestCase,
                                          register_kernel_space)

F32 = torch.float32
NV_MAX = 4            # 16-byte vectors a one-pass thread holds at most
NV_MAX_SCALAR = 16    # single elements, when the row takes no vectors


@dataclasses.dataclass(frozen=True)
class RmsNormVariant:
    """Genome of fused_add_rmsnorm (the space the agents search)."""
    name: str = "baseline"
    block_rows: int = 1
    two_pass: bool = True
    use_rsqrt: bool = False
    accum_fp32: bool = True
    row_threads: int = 1024

    def describe(self) -> str:
        """One line: name and knob values."""
        return (f"{self.name}: rows={self.block_rows} "
                f"threads={self.row_threads} two_pass={self.two_pass} "
                f"rsqrt={self.use_rsqrt} fp32={self.accum_fp32}")


# the paper's baseline: an extra round trip of r' through device memory
BASELINE = RmsNormVariant()
OPTIMIZED = RmsNormVariant(
    name="astra_opt", block_rows=1, two_pass=False, use_rsqrt=True)


def plain(variant: RmsNormVariant, x, residual, weight, eps: float = 1e-6):
    """The genome's arithmetic in plain PyTorch. Returns ``(y, r')`` in
    x's dtype. The two-pass form normalises the rounded ``r'``, as its
    second launch re-reads it."""
    if variant.accum_fp32:
        r = x.to(F32) + residual.to(F32)
    else:
        r = (x + residual).to(F32)
    r_out = r.to(x.dtype)
    if variant.two_pass:
        var = torch.sum(r * r, dim=-1, keepdim=True) / x.shape[-1]
        r = r_out.to(F32)
    else:
        var = torch.mean(r * r, dim=-1, keepdim=True)
    if variant.use_rsqrt:
        scale = torch.rsqrt(var + eps)
    else:
        scale = 1.0 / torch.sqrt(var + eps)
    y = r * scale * weight.to(F32)
    return y.to(x.dtype), r_out


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def block_limit(vec: int, nv: int, w_itemsize: int) -> int:
    """Threads a one-pass block may have: a thread's row data, ``nv``
    vectors of fp32 ``r'`` and raw weights (and two address registers
    more for each single element), above 32 registers holds the block to
    512 threads, else 1,024 (``csrc``: ``max_threads``)."""
    words = nv * (vec + _cdiv(vec * w_itemsize, 4) + (2 if vec == 1 else 0))
    return 512 if words > 32 else 1024


def launch_shape(variant: RmsNormVariant, rows: int, d: int, vec: int,
                 w_itemsize: int) -> tuple[int, int, int, int]:
    """(threads a row, row groups a block, rows a block, vectors a thread;
    0 for the two-pass loops). A row takes at most ``row_threads`` threads
    in whole warps; one pass, a thread holds ``nv`` (a power of two)
    vectors and the row the fewest warps that hold it so."""
    n_vec = _cdiv(d, vec)
    tpr = min(variant.row_threads, 32 * _cdiv(n_vec, 32))
    nv, limit = 0, 1024
    if not variant.two_pass:
        nv = 1 << (_cdiv(n_vec, tpr) - 1).bit_length()
        tpr = 32 * _cdiv(_cdiv(n_vec, nv), 32)
        limit = block_limit(vec, nv, w_itemsize)
    per_block = max(1, min(variant.block_rows, rows))
    groups = max(1, min(per_block, limit // tpr))
    return tpr, groups, per_block, nv


def why_not(variant: RmsNormVariant, rows: int, d: int, vec: int,
            w_itemsize: int) -> str | None:
    """Why the genome cannot launch on ``[rows, d]``, or None."""
    tpr, _, _, nv = launch_shape(variant, rows, d, vec, w_itemsize)
    if variant.two_pass:
        return None
    most = NV_MAX if vec > 1 else NV_MAX_SCALAR
    if nv > most:
        return (f"row_threads {variant.row_threads} leaves {nv} vectors a "
                f"thread on a row of {d}; registers hold {most}")
    limit = block_limit(vec, nv, w_itemsize)
    if tpr > limit:
        return (f"{tpr} threads a row; {nv} vectors a thread hold a block "
                f"to {limit}")
    return None


def launch_key(variant: RmsNormVariant, *, rows: int, d: int, dtype):
    """What the wrapper launches for this genome on the suite's ``[rows,
    d]`` (weight in ``dtype``): the launch shape and the template flags."""
    from repro_torch.core import costmodel as cm

    vec = cm.vector_elems(d, dtype.itemsize)
    return (launch_shape(variant, rows, d, vec, dtype.itemsize),
            variant.two_pass, variant.use_rsqrt,
            variant.accum_fp32 or dtype == F32)


def fused_add_rmsnorm(x: torch.Tensor, residual: torch.Tensor,
                      weight: torch.Tensor, eps: float = 1e-6,
                      variant: RmsNormVariant = OPTIMIZED):
    """Returns ``(y, x + residual)`` for ``x``, ``residual`` of shape
    ``[..., d]`` and ``weight`` of shape ``[d]``, fp32 or x's dtype."""
    if x.device.type == "cpu":
        return plain(variant, x, residual, weight, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_add_rmsnorm runs on cpu or cuda, not "
                         f"{x.device}")
    d = x.shape[-1]
    if residual.shape != x.shape or residual.dtype != x.dtype:
        raise ValueError(f"residual {tuple(residual.shape)} {residual.dtype}"
                         f" does not match x {tuple(x.shape)} {x.dtype}")
    if weight.shape != (d,):
        raise ValueError(f"weight shape {tuple(weight.shape)} != ({d},)")
    if weight.dtype not in (F32, x.dtype):
        raise ValueError(f"weight dtype {weight.dtype}: the kernel reads "
                         f"float32 or x's {x.dtype}")
    if not (x.is_contiguous() and residual.is_contiguous()
            and weight.is_contiguous()):
        raise ValueError("fused_add_rmsnorm needs contiguous x, residual "
                         "and weight")
    if not (residual.device == weight.device == x.device):
        raise ValueError("x, residual and weight must share one device")
    y = torch.empty_like(x)
    r_out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return y, r_out
    vec = _build.vector_width(d, x, residual, y, r_out, weight)
    why = why_not(variant, rows, d, vec, weight.element_size())
    if why:
        raise ValueError(f"fused_add_rmsnorm genome {variant.describe()}: "
                         f"{why}")
    tpr, groups, per_block, nv = launch_shape(variant, rows, d, vec,
                                              weight.element_size())
    sumsq = torch.empty(rows, dtype=F32, device=x.device) \
        if variant.two_pass else None
    lib = _build.library()
    code = lib.repro_fused_add_rmsnorm(
        x.data_ptr(), residual.data_ptr(), weight.data_ptr(), y.data_ptr(),
        r_out.data_ptr(), None if sumsq is None else sumsq.data_ptr(), rows,
        d, float(eps), _build.dtype_code(x), _build.dtype_code(weight), vec,
        nv, tpr, groups, per_block, int(variant.two_pass),
        int(variant.use_rsqrt),
        # fp32 inputs add in fp32 either way: one instantiation
        int(variant.accum_fp32 or x.dtype == F32),
        _build.stream_ptr(x.device))
    _build.check(lib, code, "fused_add_rmsnorm")
    fused_add_rmsnorm.launches += 2 if variant.two_pass else 1
    return y, r_out


fused_add_rmsnorm.launches = 0


def cost(variant: RmsNormVariant, *, rows: int, d: int, dtype):
    """Analytic H100 cost of this genome on ``[rows, d]`` inputs (weight
    in ``dtype``, as the suite makes it)."""
    from repro_torch.core import costmodel as cm

    item = dtype.itemsize
    vec = cm.vector_elems(d, item)
    why = why_not(variant, rows, d, vec, item)
    if why:
        raise cm.Infeasible(why)
    tpr, groups, per_block, nv = launch_shape(variant, rows, d, vec, item)
    blocks = math.ceil(rows / per_block)
    threads = tpr * groups
    per_group = math.ceil(per_block / groups)   # rows a group walks
    n_el = rows * d
    narrow = item < 4
    add_alu, _ = cm.ops("add", "cast", "cast", n=n_el) if narrow \
        else cm.ops("add", n=n_el)
    sq_alu, _ = cm.ops("fma", n=n_el)
    scale_alu, _ = cm.ops("mul", "mul", *(("cast",) if narrow else ()),
                          n=n_el)
    # the per-row scalar runs once per row on every thread of its group
    norm = ("rsqrt",) if variant.use_rsqrt else ("sqrt", "div")
    row_alu, row_sfu = cm.ops(*norm, "add", n=rows * tpr)
    red_alu, _ = cm.ops("add", n=rows * tpr * 10)    # two shuffle trees
    waste = cm.sector_waste(rows, d * item, 4)
    if not variant.two_pass:
        staged = vec > 1 and per_group > 1
        c = cm.Cost(
            dram_bytes=4 * n_el * item + d * item,
            alu_ops=add_alu + sq_alu + scale_alu + row_alu + red_alu,
            sfu_ops=row_sfu, blocks=blocks, threads=threads,
            regs=65536 // block_limit(vec, nv, item),
            smem_bytes=groups * 256 + (groups * 2 * nv * tpr * 16
                                       if staged else 0),
            waste_bytes=waste,
            # a queued row's loads overlap the row before it
            round_trips=1 if staged else per_group)
        c.validate()
        return c
    p1 = cm.Cost(dram_bytes=3 * n_el * item + 4 * rows,
                 alu_ops=add_alu + sq_alu + red_alu, blocks=blocks,
                 threads=threads, smem_bytes=0, waste_bytes=waste / 4 * 3,
                 round_trips=per_group)
    p2 = cm.Cost(dram_bytes=2 * n_el * item + 4 * rows + d * item,
                 alu_ops=scale_alu + row_alu, sfu_ops=row_sfu, blocks=blocks,
                 threads=threads, waste_bytes=waste / 2,
                 round_trips=2 * per_group)   # the sum, then the row
    total = cm.combine([p1, p2])
    total.validate()
    return total


reference = ref.fused_add_rmsnorm


SUITE_SHAPES = ({"batch": 256, "hidden": 4096},
                {"batch": 1024, "hidden": 4096},
                {"batch": 128, "hidden": 11008},
                {"batch": 512, "hidden": 14336},
                {"batch": 33, "hidden": 5120})


def make_inputs(shape: dict, *, dtype=F32, seed: int = 0,
                device="cpu") -> TestCase:
    """x, r normal and w = 1 + 0.1 normal, drawn in fp32 with numpy and
    cast to ``dtype``."""
    b, h = shape["batch"], shape["hidden"]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h), dtype=np.float32)
    r = rng.standard_normal((b, h), dtype=np.float32)
    w = 1.0 + 0.1 * rng.standard_normal(h, dtype=np.float32)

    def put(a):
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    return TestCase(f"[{b},{h}]", (put(x), put(r), put(w)),
                    {"rows": b, "d": h, "dtype": dtype})


def _run(variant, x, res, w):
    return fused_add_rmsnorm(x, res, w, variant=variant)


@register_kernel_space
def _space() -> KernelSpace:
    return KernelSpace(
        name="fused_add_rmsnorm",
        baseline=BASELINE,
        default=OPTIMIZED,
        run=_run,
        oracle=reference,
        cost=cost,
        knobs=(
            Knob("two_pass", "bool", attacks=("memory", "overhead"),
                 target=False,
                 note="False = one pass, r' kept in registers between "
                      "the warp-shuffle reduction and the normalisation"),
            Knob("block_rows", "pow2", 1, 16, attacks=("overhead",),
                 note="rows a block takes; a row group with more than one "
                      "queues the next row's loads across the reduction"),
            Knob("use_rsqrt", "bool", attacks=("compute",), target=True,
                 note="rsqrt intrinsic instead of sqrt+div"),
            Knob("row_threads", "pow2", 32, 1024, attacks=("memory",),
                 note="most threads on one row; 32 is one warp a row and a "
                      "shuffle-only reduction"),
        ),
        suite_shapes=SUITE_SHAPES,
        make_inputs=make_inputs,
        launch_key=launch_key,
    )
