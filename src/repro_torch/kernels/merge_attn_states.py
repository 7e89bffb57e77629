"""Paper Kernel 1, ``merge_attn_states_lse``: the Hopper kernel, its genome,
its plain per-genome version and its registered search space.

    V_out = (e^{S_a} V_a + e^{S_b} V_b) / (e^{S_a} + e^{S_b})
    S_out = log(e^{S_a} + e^{S_b})

The kernel is ``csrc/merge_attn_states.cu``; it replaces the TPU kernel
``repro/kernels/merge_attn_states.py::merge_attn_states_lse`` (bodies
``_kernel`` and ``_s_out_kernel``). It is bound by bytes: three ``[rows,
d]`` arrays cross device memory once, plus 12 bytes of scores per row.
One warp takes a row with 16-byte vector loads; ``block_rows`` warps make
a block. The genome's flags pick a template instantiation: ``hoist``
(weights once per row, not per element: the paper's loop-invariant
hoisting, Fig. 2), ``use_reciprocal`` (``__frcp_rn`` and two multiplies,
not two divides) and ``fuse_s_out`` (``S_out`` in the same launch, not a
second one). A ``block_rows`` above 32 would need more than 1,024 threads
a block: ``cost`` raises ``Infeasible`` and the wrapper refuses it.

A CPU tensor takes ``plain``, the genome's arithmetic in PyTorch; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.device import MAX_THREADS
from repro_torch.kernels import _build, ref
from repro_torch.kernels.registry import (KernelSpace, Knob, TestCase,
                                          register_kernel_space)

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class MergeVariant:
    """Genome of merge_attn_states_lse (the space the agents search)."""
    name: str = "baseline"
    block_rows: int = 16
    hoist: bool = False
    use_reciprocal: bool = False
    fuse_s_out: bool = True

    def describe(self) -> str:
        """One line: name and knob values."""
        return (f"{self.name}: rows={self.block_rows} hoist={self.hoist} "
                f"rcp={self.use_reciprocal} fuse_s={self.fuse_s_out}")


# the paper's baseline: per-element weight recompute, two divides
BASELINE = MergeVariant()
OPTIMIZED = MergeVariant(
    name="astra_opt", block_rows=32, hoist=True, use_reciprocal=True)


def _weights(sa, sb, use_reciprocal: bool):
    """LSE mixing weights (0 where both sides are empty), m and the sum."""
    m = torch.maximum(sa, sb)
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    wa = torch.exp(sa - m_safe)
    wb = torch.exp(sb - m_safe)
    denom = wa + wb
    live = denom > 0
    if use_reciprocal:
        inv = torch.where(live, torch.reciprocal(denom), 0.0)
        return wa * inv, wb * inv, m, denom
    return (torch.where(live, wa / denom, 0.0),
            torch.where(live, wb / denom, 0.0), m, denom)


def plain(variant: MergeVariant, v_a, s_a, v_b, s_b):
    """The genome's arithmetic in plain PyTorch: weights per row
    (``hoist``) or on the broadcast ``[rows, d]`` tile, a reciprocal and
    two multiplies or two divides. Returns ``(v_out, s_out)`` in the
    inputs' dtypes."""
    d = v_a.shape[-1]
    va = v_a.reshape(-1, d).to(F32)
    vb = v_b.reshape(-1, d).to(F32)
    sa = s_a.reshape(-1, 1).to(F32)
    sb = s_b.reshape(-1, 1).to(F32)
    if not variant.hoist:
        sa, sb = sa.expand(-1, d), sb.expand(-1, d)
    a, b, m, denom = _weights(sa, sb, variant.use_reciprocal)
    v_out = a * va + b * vb
    s_out = (m + torch.log(denom))[:, 0]
    return (v_out.reshape(v_a.shape).to(v_a.dtype),
            s_out.reshape(s_a.shape).to(s_a.dtype))


def merge_attn_states_lse(v_a: torch.Tensor, s_a: torch.Tensor,
                          v_b: torch.Tensor, s_b: torch.Tensor,
                          variant: MergeVariant = OPTIMIZED):
    """Merge two partial attention states: ``v: [..., d]`` fp32 or bf16,
    ``s: [...]`` (any leading shape, e.g. ``[seq, heads]``). Returns
    ``(v_out, s_out)`` in v's and s's dtypes."""
    if v_a.device.type == "cpu":
        return plain(variant, v_a, s_a, v_b, s_b)
    if v_a.device.type != "cuda":
        raise ValueError(f"merge_attn_states_lse runs on cpu or cuda, not "
                         f"{v_a.device}")
    if v_b.shape != v_a.shape or v_b.dtype != v_a.dtype:
        raise ValueError(f"v_b {tuple(v_b.shape)} {v_b.dtype} does not "
                         f"match v_a {tuple(v_a.shape)} {v_a.dtype}")
    if s_a.shape != v_a.shape[:-1] or s_b.shape != s_a.shape:
        raise ValueError(f"scores {tuple(s_a.shape)} / {tuple(s_b.shape)} "
                         f"do not fit v {tuple(v_a.shape)}")
    if any(t.device != v_a.device for t in (s_a, v_b, s_b)):
        raise ValueError("all inputs must share one device")
    if not 1 <= 32 * variant.block_rows <= MAX_THREADS:
        raise ValueError(f"block_rows {variant.block_rows} needs "
                         f"{32 * variant.block_rows} threads a block; the "
                         f"card launches at most {MAX_THREADS}")
    d = v_a.shape[-1]
    va = v_a.reshape(-1, d).contiguous()
    vb = v_b.reshape(-1, d).contiguous()
    # scores may arrive as strided views of a [seq, heads] array
    sa = s_a.reshape(-1).to(F32).contiguous()
    sb = s_b.reshape(-1).to(F32).contiguous()
    rows = va.shape[0]
    vo = torch.empty_like(va)
    so = torch.empty(rows, dtype=F32, device=va.device)
    if rows and d:
        vec = _build.vector_width(d, va, vb, vo)
        lib = _build.library()
        code = lib.repro_merge_attn_states(
            va.data_ptr(), sa.data_ptr(), vb.data_ptr(), sb.data_ptr(),
            vo.data_ptr(), so.data_ptr(), rows, d, _build.dtype_code(va), vec,
            variant.block_rows, int(variant.hoist),
            int(variant.use_reciprocal), int(variant.fuse_s_out),
            _build.stream_ptr(va.device))
        _build.check(lib, code, "merge_attn_states_lse")
        merge_attn_states_lse.launches += 1 if variant.fuse_s_out else 2
    return vo.reshape(v_a.shape), so.reshape(s_a.shape).to(s_a.dtype)


merge_attn_states_lse.launches = 0


def cost(variant: MergeVariant, *, rows: int, d: int, dtype):
    """Analytic H100 cost of this genome on ``v: [rows, d]``, ``s: [rows]``."""
    from repro_torch.core import costmodel as cm

    item = dtype.itemsize
    vec = cm.vector_elems(d, item)
    # lane slots of per-element work: a warp's 32 lanes stride a row
    lanes = rows * math.ceil(d / vec / 32) * 32 * vec
    weights = ("max", "cmp", "exp", "exp", "add") + (
        ("rcp", "mul", "mul") if variant.use_reciprocal else ("div", "div"))
    score = ("max", "cmp", "exp", "exp", "add", "log", "add")
    # hoisted work runs once per row on all 32 lanes of its warp
    w_alu, w_sfu = cm.ops(*weights, n=32 * rows if variant.hoist else lanes)
    mad_alu, _ = cm.ops("mul", "fma", n=lanes)
    cast_alu = 3 * lanes if item < 4 else 0
    s_alu, s_sfu = cm.ops(*score, n=32 * rows)
    fuse = variant.fuse_s_out
    main = cm.Cost(
        dram_bytes=3 * rows * d * item + (3 if fuse else 2) * rows * 4,
        alu_ops=w_alu + mad_alu + cast_alu + (s_alu if fuse else 0),
        sfu_ops=w_sfu + (s_sfu if fuse else 0),
        blocks=math.ceil(rows / variant.block_rows),
        threads=32 * variant.block_rows,
        waste_bytes=cm.sector_waste(rows, d * item, 3))
    total = main
    if not fuse:
        alu, sfu = cm.ops(*score, n=rows)
        total = cm.combine([main, cm.Cost(
            dram_bytes=3 * rows * 4, alu_ops=alu, sfu_ops=sfu,
            blocks=math.ceil(rows / 256), threads=256)])
    total.validate()
    return total


reference = ref.merge_attn_states_lse


SUITE_SHAPES = ({"seq": 512, "heads": 32, "head_dim": 256},
                {"seq": 512, "heads": 40, "head_dim": 128},
                {"seq": 768, "heads": 32, "head_dim": 256},
                {"seq": 512, "heads": 64, "head_dim": 128},
                {"seq": 100, "heads": 7, "head_dim": 128})


def make_inputs(shape: dict, *, dtype=F32, seed: int = 0,
                device="cpu") -> TestCase:
    """Values drawn in fp32 with numpy: v normal, scores normal x 8 with 5%
    of ``s_b`` at -inf (empty partitions). Scores stay fp32 for every
    dtype."""
    s, h, d = shape["seq"], shape["heads"], shape["head_dim"]
    rng = np.random.default_rng(seed)
    va = rng.standard_normal((s, h, d), dtype=np.float32)
    vb = rng.standard_normal((s, h, d), dtype=np.float32)
    sa = rng.standard_normal((s, h), dtype=np.float32) * 8.0
    sb = rng.standard_normal((s, h), dtype=np.float32) * 8.0
    sb[rng.random((s, h)) < 0.05] = -np.inf

    def put(a, dt):
        return torch.from_numpy(a).to(device=device, dtype=dt)

    return TestCase(f"[{s},{h},{d}]",
                    (put(va, dtype), put(sa, F32), put(vb, dtype),
                     put(sb, F32)),
                    {"rows": s * h, "d": d, "dtype": dtype})


def _run(variant, va, sa, vb, sb):
    return merge_attn_states_lse(va, sa, vb, sb, variant)


@register_kernel_space
def _space() -> KernelSpace:
    return KernelSpace(
        name="merge_attn_states_lse",
        baseline=BASELINE,
        default=OPTIMIZED,
        run=_run,
        oracle=reference,
        cost=cost,
        knobs=(
            Knob("block_rows", "pow2", 8, 2048, attacks=("overhead",)),
            Knob("hoist", "bool", attacks=("compute",), target=True,
                 note="hoist LSE weights out of the element loop "
                      "(loop-invariant hoisting, paper Fig. 2)"),
            Knob("use_reciprocal", "bool", attacks=("compute",), target=True),
            Knob("fuse_s_out", "bool", attacks=("memory", "overhead"),
                 target=True,
                 note="compute S_out in the same launch"),
        ),
        suite_shapes=SUITE_SHAPES,
        make_inputs=make_inputs,
    )
