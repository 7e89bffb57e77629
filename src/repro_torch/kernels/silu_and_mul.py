"""SwiGLU gate ``silu(x[..., :d]) * x[..., d:]`` (paper Kernel 3): the
Hopper kernel, its genome, its plain per-genome version and its registered
search space.

The kernel is ``csrc/silu_and_mul.cu``; it replaces the TPU kernel
``repro/kernels/silu_and_mul.py::silu_and_mul`` (body ``_kernel``). It is
bound by bytes. The shipped genome reads gate and up in place from the
one input buffer in fp32 with ``expf`` and a divide. ``fused_split=False``
copies gate and up out first (two more launches of PyTorch's copy kernel
and a round trip of x, as the JAX package slices outside its
``pallas_call``); ``compute_fp32=False`` rounds every operation to the
input dtype; ``use_reciprocal`` multiplies by ``__frcp_rn``;
``fast_exp`` takes ``exp2f``.

Two knobs set the launch (``launch_shape``): ``block_cols`` is the threads
of a block, ``block_rows`` the rows of a thread's step (1-16, the port's
range for JAX's tile height): a thread sends out the gate and up loads of its
16-byte column of all those rows before any arithmetic. Beside the column
blocks the grid holds as many step blocks as the card's thread limits hold
at once, each walking steps a grid apart; the launcher takes that count
from ``launch_shape``. The baseline takes one row a step and 256 threads a
block: the textbook elementwise launch.

A CPU tensor takes ``plain``, the genome's arithmetic in PyTorch; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.device import (MAX_BLOCKS_PER_SM, MAX_THREADS_PER_SM,
                                SMS)
from repro_torch.kernels import _build, ref
from repro_torch.kernels.registry import (KernelSpace, Knob, TestCase,
                                          register_kernel_space)

F32 = torch.float32
LOG2E = 1.4426950408889634
STEP_ROWS = (1, 2, 4, 8, 16)      # the kernel's instantiations


@dataclasses.dataclass(frozen=True)
class SiluMulVariant:
    """Genome of silu_and_mul (the space the agents search)."""
    name: str = "baseline"
    block_rows: int = 1
    block_cols: int = 256
    compute_fp32: bool = True
    use_reciprocal: bool = False
    fast_exp: bool = False
    fused_split: bool = False

    def describe(self) -> str:
        """One line: name and knob values."""
        return (f"{self.name}: tile=({self.block_rows},{self.block_cols}) "
                f"fp32={self.compute_fp32} rcp={self.use_reciprocal} "
                f"exp2={self.fast_exp} fused_split={self.fused_split}")


# the paper's baseline: library math and materialised gate/up copies
BASELINE = SiluMulVariant()
OPTIMIZED = SiluMulVariant(
    name="astra_opt", block_rows=1, block_cols=128,
    compute_fp32=True, use_reciprocal=False, fast_exp=False, fused_split=True,
)


def plain(variant: SiluMulVariant, x):
    """The genome's arithmetic in plain PyTorch: in fp32, or every
    operation in x's dtype; ``exp`` or ``exp2``; a divide or a reciprocal
    and a multiply."""
    d = x.shape[-1] // 2
    ct = F32 if variant.compute_fp32 else x.dtype
    g, u = x[..., :d].to(ct), x[..., d:].to(ct)
    e = torch.exp2(-g * LOG2E) if variant.fast_exp else torch.exp(-g)
    den = 1.0 + e
    if variant.use_reciprocal:
        out = g * torch.reciprocal(den) * u
    else:
        out = g / den * u
    return out.to(x.dtype)


def block_limit(vec: int, block_rows: int) -> int:
    """Threads a block may have: a step's raw 16-byte loads take 8
    registers a row, held to 64 a thread at 1,024 threads, 128 at 512 and
    255 at 256 (``csrc``: ``max_threads``)."""
    if vec == 1 or block_rows <= 4:
        return 1024
    return 512 if block_rows == 8 else 256


def launch_shape(variant: SiluMulVariant, rows: int, d: int,
                 vec: int) -> tuple[int, int, int, int]:
    """(threads a block, rows a step, column blocks, step blocks): a thread
    a 16-byte column, and beside the column blocks as many step blocks as
    the card's thread and block limits hold at once, at most one a step.
    Where a thread's registers hold fewer blocks on an SM, the rest run as
    a second wave; the launch is correct for any count."""
    threads, br = variant.block_cols, variant.block_rows
    col_blocks = -(-(d // vec) // threads)      # vec divides d
    per_sm = max(1, min(MAX_BLOCKS_PER_SM, MAX_THREADS_PER_SM // threads))
    return (threads, br, col_blocks,
            max(1, min(-(-rows // br), SMS * per_sm // col_blocks)))


def why_not(variant: SiluMulVariant, vec: int) -> str | None:
    """Why the genome cannot launch, or None."""
    if variant.block_rows not in STEP_ROWS:
        return f"block_rows {variant.block_rows} is not one of {STEP_ROWS}"
    limit = block_limit(vec, variant.block_rows)
    if not 32 <= variant.block_cols <= limit or variant.block_cols % 32:
        return (f"block_cols {variant.block_cols} is the threads of a block: "
                f"whole warps, at most {limit} at {variant.block_rows} rows "
                f"a step")
    return None


def launch_key(variant: SiluMulVariant, *, rows: int, d: int, dtype):
    """What the wrapper launches for this genome on ``[rows, 2d]``: the
    launch shape, the split copies or not, and the template flags."""
    from repro_torch.core import costmodel as cm

    vec = cm.vector_elems(d, dtype.itemsize)
    return (launch_shape(variant, rows, d, vec), variant.fused_split,
            variant.compute_fp32, variant.use_reciprocal, variant.fast_exp)


def silu_and_mul(x: torch.Tensor,
                 variant: SiluMulVariant = OPTIMIZED) -> torch.Tensor:
    """``[..., 2d] -> [..., d]``."""
    if x.device.type == "cpu":
        return plain(variant, x)
    if x.device.type != "cuda":
        raise ValueError(f"silu_and_mul runs on cpu or cuda, not {x.device}")
    if x.shape[-1] % 2:
        raise ValueError(f"last dim {x.shape[-1]} is not 2 * d")
    if not x.is_contiguous():
        raise ValueError("silu_and_mul needs a contiguous input")
    d = x.shape[-1] // 2
    out = torch.empty(*x.shape[:-1], d, dtype=x.dtype, device=x.device)
    rows = out.numel() // d if d else 0
    if rows == 0:
        return out
    x2 = x.reshape(rows, 2 * d)
    if variant.fused_split:
        gate, up, stride = x2, x2[:, d:], 2 * d
    else:
        gate, up, stride = x2[:, :d].contiguous(), x2[:, d:].contiguous(), d
    vec = _build.vector_width(d, gate, up, out)
    why = why_not(variant, vec)
    if why:
        raise ValueError(f"silu_and_mul genome {variant.describe()}: {why}")
    threads, br, _, step_blocks = launch_shape(variant, rows, d, vec)
    lib = _build.library()
    code = lib.repro_silu_and_mul(
        gate.data_ptr(), up.data_ptr(), out.data_ptr(), rows, d, stride,
        _build.dtype_code(x), vec, threads, br, step_blocks,
        int(variant.compute_fp32), int(variant.use_reciprocal),
        int(variant.fast_exp), _build.stream_ptr(x.device))
    _build.check(lib, code, "silu_and_mul")
    silu_and_mul.launches += 1
    return out


silu_and_mul.launches = 0


def cost(variant: SiluMulVariant, *, rows: int, d: int, dtype):
    """Analytic H100 cost of this genome on a ``[rows, 2d]`` input."""
    from repro_torch.core import costmodel as cm

    item = dtype.itemsize
    vec = cm.vector_elems(d, item)
    why = why_not(variant, vec)
    if why:
        raise cm.Infeasible(why)
    threads, br, col_blocks, step_blocks = launch_shape(variant, rows, d, vec)
    n_el = rows * d
    names = ["mul", "add"]                          # x up, 1 + e
    names += ["exp_fast", "mul"] if variant.fast_exp else ["exp"]
    names += ["rcp", "mul"] if variant.use_reciprocal else ["div"]
    if not variant.compute_fp32:
        names += ["cast", "cast"] * len(names)      # a rounding per op
    elif item < 4:
        names += ["cast"] * 3
    alu, sfu = cm.ops(*names, n=n_el)
    main = cm.Cost(
        dram_bytes=3 * n_el * item, alu_ops=alu, sfu_ops=sfu,
        blocks=col_blocks * step_blocks, threads=threads,
        regs=65536 // block_limit(vec, br),
        waste_bytes=cm.sector_waste(rows, d * item, 3),
        # a thread's steps follow one another, each a load and a store
        round_trips=math.ceil(-(-rows // br) / step_blocks))
    if variant.fused_split:
        main.validate()
        return main
    # two copies of half of x: read and write rows * d each
    copy = cm.Cost(dram_bytes=2 * n_el * item,
                   blocks=math.ceil(n_el * item / (16 * 256)), threads=256)
    total = cm.combine([copy, copy, main])
    total.validate()
    return total


reference = ref.silu_and_mul


# paper Table 4 shapes, [batch, hidden] (LLaMA-7B/13B/70B dims), plus a
# ragged one
SUITE_SHAPES = ({"batch": 16, "hidden": 4096}, {"batch": 32, "hidden": 5120},
                {"batch": 64, "hidden": 8192}, {"batch": 16, "hidden": 12288},
                {"batch": 17, "hidden": 11008})


def make_inputs(shape: dict, *, dtype=F32, seed: int = 0,
                device="cpu") -> TestCase:
    """x normal x 2, drawn in fp32 with numpy and cast to ``dtype``."""
    b, h = shape["batch"], shape["hidden"]
    x = np.random.default_rng(seed).standard_normal((b, 2 * h),
                                                    dtype=np.float32) * 2.0
    return TestCase(f"[{b},{h}]",
                    (torch.from_numpy(x).to(device=device, dtype=dtype),),
                    {"rows": b, "d": h, "dtype": dtype})


def _run(variant, x):
    return silu_and_mul(x, variant)


@register_kernel_space
def _space() -> KernelSpace:
    return KernelSpace(
        name="silu_and_mul",
        baseline=BASELINE,
        default=OPTIMIZED,
        run=_run,
        oracle=reference,
        cost=cost,
        knobs=(
            Knob("fused_split", "bool", attacks=("memory", "overhead"),
                 target=True,
                 note="index gate/up in place; kills the two copies "
                      "(a round trip of x and two launches)"),
            Knob("block_rows", "pow2", 1, 16, attacks=("overhead",),
                 note="rows of a thread's step, their loads all in flight "
                      "before any arithmetic"),
            Knob("block_cols", "pow2", 32, 1024, attacks=("overhead",),
                 note="threads a block, one 16-byte column each"),
            Knob("use_reciprocal", "bool", attacks=("compute",), target=True,
                 note="__frcp_rn and a multiply instead of a divide"),
            Knob("fast_exp", "bool", attacks=("compute",), target=True,
                 note="exp2f of a scaled argument instead of expf"),
        ),
        suite_shapes=SUITE_SHAPES,
        make_inputs=make_inputs,
        launch_key=launch_key,
    )
