"""Analytic H100 cost model: the profiling agent's screen and its signals.

The counterpart of ``repro/core/costmodel.py``, rebuilt for Hopper. On the
CPU it is the profiling agent's whole measurement (``backend="analytic"``);
on the card the agent times every genome with CUDA events and still reads
this model for the signals the planner uses (which term dominates, how
close a block is to the SM's limits) and to screen genomes that cannot
launch before anything is launched.

What it charges, per kernel launch:

* device memory: the bytes the launch must move, plus the 32-byte sectors
  it fetches but does not use, over 3.35 TB/s when enough SMs have a block
  to keep that much in flight, else over ``SM_BW`` per busy SM;
* compute: fp32 instructions on the CUDA cores (one per lane per clock:
  67 TFLOP/s counts an FMA as two) plus special-function instructions
  (``ex2``, ``lg2``, ``rcp``, ``rsqrt``: 16 per clock per SM);
* overhead: a launch floor per kernel, a small cost per extra wave of
  blocks over the 132 SMs, and a device-memory round trip for each
  dependent load a block's threads wait on in turn (one, for a kernel
  whose loads all go out together).

A block that needs more than 1,024 threads, more than 227 KB of shared
memory or more than the SM's 65,536 registers cannot launch: ``validate``
raises ``Infeasible`` and the evaluator screens the genome before any
launch.

Constants are the H100 SXM data sheet's, but two, measured by chip_smoke.py
on an H100 80GB HBM3 at 700 W: ``LAUNCH_S`` is the library's empty kernel
in a CUDA graph (0.99 us), and ``ROUND_TRIP_S`` what the shipped
``fused_add_rmsnorm`` at 8 x 896 bf16 (1.70 us; one round trip: its x, r
and w go out together) takes above that floor and this model's memory
term (0.073 us: 8 blocks, one a row).
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.device import (MAX_BLOCKS_PER_SM, MAX_THREADS,
                                MAX_THREADS_PER_SM, SMEM_PER_BLOCK,
                                SMEM_PER_SM, SMS)

# --- H100 SXM ---------------------------------------------------------------
CLOCK_HZ = 1.98e9                  # boost clock
HBM_BW = 3.35e12                   # bytes/s
SM_BW = 4 * HBM_BW / SMS           # bytes/s one busy SM keeps in flight
PEAK_FP32_FLOPS = 67e12            # CUDA cores, an FMA counted as 2
ALU_RATE = PEAK_FP32_FLOPS / 2     # fp32 instructions/s
SFU_RATE = 16 * SMS * CLOCK_HZ     # special-function instructions/s
REGS_PER_SM = 65_536
REGS = 32                          # per thread, what ptxas reports (20-52)
SECTOR = 32                        # bytes per device-memory sector
LAUNCH_S = 0.99e-6                 # per launch (measured, see above)
ROUND_TRIP_S = 0.637e-6            # per dependent round trip (measured)
WAVE_S = 0.1e-6                    # per wave of blocks after the first

# (fp32 instructions, special-function instructions) of one operation as
# the CUDA math library emits it without fast math
OP = {
    "add": (1, 0), "mul": (1, 0), "fma": (1, 0), "max": (1, 0),
    "cmp": (1, 0), "cast": (1, 0),
    "exp": (6, 1),        # expf: range reduction + ex2
    "exp_fast": (2, 1),   # exp2f of a scaled argument
    "div": (8, 1),        # IEEE divide: rcp + Newton steps + fix-up
    "rcp": (4, 1),        # __frcp_rn
    "sqrt": (6, 1),       # IEEE sqrtf
    "rsqrt": (1, 1),      # rsqrtf
    "log": (10, 1),       # logf: lg2 + polynomial correction
}


def ops(*names: str, n: float = 1.0) -> tuple[float, float]:
    """(fp32, special-function) instruction counts of ``n`` x ``names``."""
    alu = sum(OP[k][0] for k in names)
    sfu = sum(OP[k][1] for k in names)
    return n * alu, n * sfu


class Infeasible(Exception):
    """The genome's launch shape cannot run on the card."""


@dataclasses.dataclass(frozen=True)
class Cost:
    """Analytic cost of one call of a kernel on one input shape: one
    launch, or (``parts``) the sum of several launches."""
    dram_bytes: float = 0.0         # bytes the launch must move
    alu_ops: float = 0.0            # fp32 instructions (lane-level)
    sfu_ops: float = 0.0            # special-function instructions
    blocks: int = 1
    threads: int = 32               # per block
    smem_bytes: int = 0             # per block
    regs: int = REGS                # per thread
    n_calls: int = 1
    waste_bytes: float = 0.0        # sectors fetched but not used
    round_trips: int = 1            # dependent loads a thread waits on
    parts: tuple = ()               # the launches of a multi-launch call

    # --- launch limits ---
    def validate(self) -> None:
        """Raise ``Infeasible`` if a launch of this call cannot run."""
        for c in self.parts or (self,):
            if c.threads > MAX_THREADS:
                raise Infeasible(f"{c.threads} threads per block > "
                                 f"{MAX_THREADS}")
            if c.smem_bytes > SMEM_PER_BLOCK:
                raise Infeasible(f"{c.smem_bytes / 1024:.0f} KB of shared "
                                 f"memory per block > 227 KB")
            if c.regs * c.threads > REGS_PER_SM:
                raise Infeasible(f"{c.regs * c.threads} registers per block "
                                 f"> {REGS_PER_SM}")

    @property
    def pressure(self) -> float:
        """How close a block comes to the SM's limits: the largest of its
        shared memory, registers and threads over their maxima (> 1 cannot
        launch)."""
        if self.parts:
            return max(c.pressure for c in self.parts)
        return max(self.smem_bytes / SMEM_PER_BLOCK,
                   self.regs * self.threads / REGS_PER_SM,
                   self.threads / MAX_THREADS)

    @property
    def blocks_per_sm(self) -> int:
        by_smem = SMEM_PER_SM // self.smem_bytes if self.smem_bytes \
            else MAX_BLOCKS_PER_SM
        return max(1, min(MAX_BLOCKS_PER_SM,
                          MAX_THREADS_PER_SM // max(self.threads, 1),
                          REGS_PER_SM // max(self.regs * self.threads, 1),
                          by_smem))

    @property
    def waves(self) -> int:
        if self.parts:
            return sum(c.waves for c in self.parts)
        return math.ceil(self.blocks / (SMS * self.blocks_per_sm))

    @property
    def _busy_sms(self) -> int:
        return max(1, min(self.blocks, SMS))

    # --- roofline terms ---
    @property
    def mem_s(self) -> float:
        if self.parts:
            return sum(c.mem_s for c in self.parts)
        bw = min(HBM_BW, self._busy_sms * SM_BW)
        return (self.dram_bytes + self.waste_bytes) / bw

    @property
    def compute_s(self) -> float:
        if self.parts:
            return sum(c.compute_s for c in self.parts)
        share = self._busy_sms / SMS
        return (self.alu_ops / ALU_RATE + self.sfu_ops / SFU_RATE) / share

    @property
    def overhead_s(self) -> float:
        if self.parts:
            return sum(c.overhead_s for c in self.parts)
        return (self.n_calls * LAUNCH_S + (self.waves - 1) * WAVE_S
                + self.round_trips * ROUND_TRIP_S)

    @property
    def latency_s(self) -> float:
        if self.parts:
            return sum(c.latency_s for c in self.parts)
        return max(self.mem_s, self.compute_s) + self.overhead_s

    def dominant(self) -> str:
        """The largest of the memory, compute and overhead terms."""
        terms = {"memory": self.mem_s, "compute": self.compute_s,
                 "overhead": self.overhead_s}
        return max(terms, key=terms.get)

    def summary(self) -> dict:
        """The terms in microseconds plus the launch-shape facts."""
        return {
            "latency_us": self.latency_s * 1e6,
            "mem_us": self.mem_s * 1e6,
            "compute_us": self.compute_s * 1e6,
            "overhead_us": self.overhead_s * 1e6,
            "dominant": self.dominant(),
            "dram_mb": self.total("dram_bytes") / 2**20,
            "waste_frac": self.total("waste_bytes")
            / max(self.total("dram_bytes"), 1.0),
            "smem_kb": max(c.smem_bytes for c in self.parts or (self,))
            / 1024,
            "pressure": self.pressure,
            "waves": self.waves,
        }

    def total(self, field: str) -> float:
        """``field`` summed over the launches of the call."""
        return sum(getattr(c, field) for c in self.parts or (self,))


def combine(costs: list[Cost]) -> Cost:
    """One call made of several launches (a multi-pass genome)."""
    flat = tuple(p for c in costs for p in (c.parts or (c,)))
    return Cost(dram_bytes=sum(c.dram_bytes for c in flat),
                alu_ops=sum(c.alu_ops for c in flat),
                sfu_ops=sum(c.sfu_ops for c in flat),
                n_calls=sum(c.n_calls for c in flat),
                waste_bytes=sum(c.waste_bytes for c in flat),
                parts=flat)


def sector_waste(rows: int, row_bytes: float, n_arrays: int = 1) -> float:
    """Bytes fetched but unused when each of ``rows`` rows of ``row_bytes``
    starts a fresh 32-byte sector (rows that are not a multiple of it)."""
    if row_bytes % SECTOR == 0:
        return 0.0
    padded = math.ceil(row_bytes / SECTOR) * SECTOR
    return n_arrays * rows * (padded - row_bytes)


def vector_elems(d: int, itemsize: int) -> int:
    """Elements per 16-byte vector access along a row of ``d`` elements, or
    1 when ``d`` is not a multiple of it (the wrappers' rule)."""
    vec = 16 // itemsize
    return vec if d % vec == 0 else 1
