"""Fused residual add + RMSNorm (paper Kernel 2): the Hopper kernel, its
genome, its plain per-genome version and its registered search space.

The kernel is ``csrc/fused_add_rmsnorm.cu``; it replaces the TPU kernel
``repro/kernels/fused_add_rmsnorm.py::fused_add_rmsnorm`` (the one-pass
body ``_one_pass_kernel`` and the two-pass ``_pass1_kernel`` +
``_pass2_kernel``). It is bound by bytes. The shipped genome is the
one-pass form: ``r'`` stays in fp32 in shared memory between the
reduction and the normalisation. ``two_pass`` writes ``r'`` and a per-row
sum of squares, then a second launch re-reads the rounded ``r'``;
``use_rsqrt`` picks ``rsqrtf`` over ``1 / sqrtf``; ``accum_fp32=False``
rounds the add to the input dtype first. ``block_rows`` caps the rows
one block takes: the wrapper gives each row its own block while the grid
fits the card in one wave (2,112 rows of 896 in bf16; more rows a block
read slower at 256 rows), and stacks rows only past that. At every suite
shape that leaves at most 4 rows a block, below the knob's lowest value,
8, so ``block_rows`` changes nothing there; ``launch_key`` tells the
evaluator so.

A CPU tensor takes ``plain``, the genome's arithmetic in PyTorch; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.device import resident_blocks
from repro_torch.kernels import _build, ref
from repro_torch.kernels.registry import (KernelSpace, Knob, TestCase,
                                          register_kernel_space)

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class RmsNormVariant:
    """Genome of fused_add_rmsnorm (the space the agents search)."""
    name: str = "baseline"
    block_rows: int = 16
    two_pass: bool = True
    use_rsqrt: bool = False
    accum_fp32: bool = True

    def describe(self) -> str:
        """One line: name and knob values."""
        return (f"{self.name}: rows={self.block_rows} two_pass={self.two_pass} "
                f"rsqrt={self.use_rsqrt} fp32={self.accum_fp32}")


# the paper's baseline: an extra round trip of r' through device memory
BASELINE = RmsNormVariant()
OPTIMIZED = RmsNormVariant(
    name="astra_opt", block_rows=16, two_pass=False, use_rsqrt=True)


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


def launch_shape(block_rows: int, rows: int, d: int,
                 vec: int) -> tuple[int, int, int]:
    """(threads per row, rows a block works on at once, rows per block).

    A row gets one 16-byte vector per thread in whole warps, up to 1,024
    threads; a block stacks as many rows as fit in 1,024 threads; it takes
    one row while one-row blocks fit the card in one wave, else as few
    rows as keep the grid to that wave, at most ``block_rows``."""
    n_vec = -(-d // vec)
    tpr = min(1024, -(-n_vec // 32) * 32)
    per_block = max(1, min(block_rows, -(-rows // resident_blocks(tpr))))
    groups = max(1, min(per_block, 1024 // tpr))
    return tpr, groups, per_block


def launch_key(variant: RmsNormVariant, *, rows: int, d: int, dtype):
    """What the wrapper launches for this genome on ``[rows, d]``: the
    launch shape and the template flags."""
    from repro_torch.core import costmodel as cm

    vec = cm.vector_elems(d, dtype.itemsize)
    return (launch_shape(variant.block_rows, rows, d, vec), variant.two_pass,
            variant.use_rsqrt, variant.accum_fp32)


def fused_add_rmsnorm(x: torch.Tensor, residual: torch.Tensor,
                      weight: torch.Tensor, eps: float = 1e-6,
                      variant: RmsNormVariant = OPTIMIZED):
    """Returns ``(y, x + residual)`` for ``x``, ``residual`` of shape
    ``[..., d]`` and ``weight`` of shape ``[d]``."""
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
    if not (x.is_contiguous() and residual.is_contiguous()):
        raise ValueError("fused_add_rmsnorm needs contiguous x and residual")
    if not (residual.device == weight.device == x.device):
        raise ValueError("x, residual and weight must share one device")
    w = weight.to(F32).contiguous()
    y = torch.empty_like(x)
    r_out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return y, r_out
    vec = _build.vector_width(d, x, residual, y, r_out)
    tpr, groups, per_block = launch_shape(variant.block_rows, rows, d, vec)
    sumsq = torch.empty(rows, dtype=F32, device=x.device) \
        if variant.two_pass else None
    lib = _build.library()
    code = lib.repro_fused_add_rmsnorm(
        x.data_ptr(), residual.data_ptr(), w.data_ptr(), y.data_ptr(),
        r_out.data_ptr(), None if sumsq is None else sumsq.data_ptr(), rows,
        d, float(eps), _build.dtype_code(x), vec, tpr, groups, per_block,
        int(variant.two_pass), int(variant.use_rsqrt),
        int(variant.accum_fp32), _build.stream_ptr(x.device))
    _build.check(lib, code, "fused_add_rmsnorm")
    fused_add_rmsnorm.launches += 2 if variant.two_pass else 1
    return y, r_out


fused_add_rmsnorm.launches = 0


def cost(variant: RmsNormVariant, *, rows: int, d: int, dtype):
    """Analytic H100 cost of this genome on ``[rows, d]`` inputs."""
    from repro_torch.core import costmodel as cm

    item = dtype.itemsize
    vec = cm.vector_elems(d, item)
    tpr, groups, per_block = launch_shape(variant.block_rows, rows, d, vec)
    blocks = math.ceil(rows / per_block)
    threads = tpr * groups
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
    red_alu, _ = cm.ops("add", n=rows * tpr * 6)     # shuffles + partials
    waste = cm.sector_waste(rows, d * item, 4)
    if not variant.two_pass:
        c = cm.Cost(
            dram_bytes=4 * n_el * item + 4 * d,
            alu_ops=add_alu + sq_alu + scale_alu + row_alu + red_alu,
            sfu_ops=row_sfu, blocks=blocks, threads=threads,
            smem_bytes=(groups * d + 32) * 4, waste_bytes=waste)
        c.validate()
        return c
    p1 = cm.Cost(dram_bytes=3 * n_el * item + 4 * rows,
                 alu_ops=add_alu + sq_alu + red_alu, blocks=blocks,
                 threads=threads, smem_bytes=32 * 4, waste_bytes=waste / 4 * 3)
    p2 = cm.Cost(dram_bytes=2 * n_el * item + 4 * rows + 4 * d,
                 alu_ops=scale_alu + row_alu, sfu_ops=row_sfu, blocks=blocks,
                 threads=threads, waste_bytes=waste / 2)
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
                 note="False = one pass, r' kept in shared memory between "
                      "the warp-shuffle reduction and the normalisation"),
            Knob("block_rows", "pow2", 8, 1024, attacks=("overhead",)),
            Knob("use_rsqrt", "bool", attacks=("compute",), target=True,
                 note="rsqrt intrinsic instead of sqrt+div"),
        ),
        suite_shapes=SUITE_SHAPES,
        make_inputs=make_inputs,
        launch_key=launch_key,
    )
