"""The four Astra agents (paper §3.2), on the card or on the CPU.

The counterpart of ``repro/core/agents.py``. Each agent is a small class
with its own state and its own view of the problem. Tests live on one
device, chosen by the testing agent: the card unless ``device="cpu"`` is
asked for.

* ``TestingAgent`` draws the suite with numpy from a seed and validates a
  genome with ``space.run`` on the suite's device: the Hopper kernel on
  the card, the genome's plain PyTorch version on the CPU (the stand-in
  for Pallas ``interpret=True``).
* ``ProfilingAgent`` has two backends. ``"cuda"`` times every test with
  CUDA events on the card: 20 warm-ups, then the median of ``reps``
  single launches, each after a 64 MB read that evicts the 50 MB L2,
  outside the timed window, all queued behind one spin kernel so that
  the host's speed never shows in a device time. ``"analytic"`` evaluates the H100 cost model plus a
  deterministic pseudo-noise that shrinks like 1/sqrt(reps). Either way
  the planner's signals come from the cost model. The default follows the
  suite: CUDA tensors are timed, CPU tensors are modelled.

The agents launch onto the card's one stream, so nothing else may run on
the card while ``time_launches`` times. Every timing holds the one
process-wide ``DEVICE_LOCK``, so two timings never overlap, and the
evaluator runs a suite on the card one genome at a time (its thread pool
serves CPU suites only), so no validation or oracle lands inside one.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core import costmodel
from repro_torch.core.variants import KernelSpace, TestCase, make_inputs
from repro_torch.device import resolve_device

DEVICE_LOCK = threading.Lock()    # held by every timing on the card
WARMUPS = 20
FLUSH_BYTES = 64 * 2**20      # > the H100's 50 MB L2
HOST_S_PER_REP = 30e-6        # host time to queue a rep's flush and events
SPIN_MARGIN = 4               # the spin outlasts 4x the host's queueing time
NOISE_BASE = 0.04             # the analytic backend's noise at reps=1


def _tolerance(dtype) -> tuple[float, float]:
    """(rtol, atol) per dtype: paper §3.1's epsilon."""
    if dtype == torch.bfloat16:
        return 3e-2, 3e-2
    return 1e-5, 1e-4


def _pseudo_noise(tag: str, scale: float) -> float:
    """Deterministic 'measurement noise' in [-scale, +scale]."""
    h = int.from_bytes(hashlib.sha256(tag.encode()).digest()[:8], "big")
    return (h / 2**64 * 2.0 - 1.0) * scale


@dataclasses.dataclass
class Profile:
    """What the ProfilingAgent hands the PlanningAgent."""
    per_shape: list[dict]
    geomean_latency_us: float
    dominant: str
    signals: dict                   # term fractions + structural hints
    noise_scale: float


@dataclasses.dataclass(frozen=True)
class Suggestion:
    """One move the planner proposes: set ``knob`` to ``value``."""
    knob: str
    value: Any
    rationale: str


def on_card(tests: Sequence[TestCase]) -> bool:
    """Whether any test's inputs lie on a CUDA device."""
    return any(isinstance(a, torch.Tensor) and a.device.type == "cuda"
               for t in tests for a in t.args)


class TestingAgent:
    """Builds the test suite T and validates candidates against the oracle.

    The suite draws representative shapes (paper §4: dims of the
    LLaMA-family configs) in every dtype of ``dtypes``, with adversarial
    values (wide-range scores, -inf empties, ragged rows). Correct = every
    output within epsilon of the oracle over T.
    """

    def __init__(self, *, dtypes=(torch.float32, torch.bfloat16),
                 seed: int = 0, device=None):
        self.dtypes = tuple(dtypes)
        self.seed = seed
        self.device = resolve_device(device)

    def generate_tests(self, space: KernelSpace) -> list[TestCase]:
        """One case per (suite shape, dtype), each from its own seed."""
        tests = []
        for i, shape in enumerate(space.suite_shapes):
            for j, dt in enumerate(self.dtypes):
                tests.append(make_inputs(space.name, shape, dtype=dt,
                                         seed=self.seed + 31 * i + j,
                                         device=self.device))
        return tests

    def validate(self, space: KernelSpace, variant,
                 tests: Sequence[TestCase], *,
                 oracle=None,
                 timeout_s: float | None = None) -> tuple[bool, float]:
        """Check ``variant`` against the oracle over ``tests``.

        The bound is ``err <= atol + rtol * |want|``; non-finite oracle
        entries (the -inf of an empty partition) must match exactly. The
        returned ``max_err`` is tolerance-normalized (<= 1.0 passes).
        Validation stops at the first failing case. ``oracle`` optionally
        gives precomputed outputs aligned with ``tests``.

        ``timeout_s`` is a cooperative deadline, checked between cases:
        past it, ``reliability.EvalTimeout`` is raised. It cannot stop a
        launch that never returns; the worker pool's kill does that.
        """
        deadline = None if timeout_s is None \
            else time.monotonic() + timeout_s
        worst = 0.0
        for i, t in enumerate(tests):
            if deadline is not None and time.monotonic() > deadline:
                from repro_torch.reliability import EvalTimeout
                raise EvalTimeout(
                    f"validation of {space.name} exceeded {timeout_s}s "
                    f"({i}/{len(tests)} cases done)")
            rtol, atol = _tolerance(t.shape_info["dtype"])
            got = space.run(variant, *t.args)
            want = space.oracle(*t.args) if oracle is None else oracle[i]
            flat_g = got if isinstance(got, tuple) else (got,)
            flat_w = want if isinstance(want, tuple) else (want,)
            for g, w in zip(flat_g, flat_w):
                g, w = torch.as_tensor(g).float(), torch.as_tensor(w).float()
                err = (g - w).abs()
                norm = torch.where(torch.isfinite(w),
                                   err / (atol + rtol * w.abs()),
                                   torch.where(g == w, 0.0, 2.0))
                ok = bool((norm <= 1.0).all())
                worst = max(worst, float(torch.nan_to_num(
                    norm, nan=float("inf")).max()) if norm.numel() else 0.0)
                if not ok:
                    return False, worst
        return True, worst


TestingAgent.__test__ = False       # keep pytest from collecting it


_FLUSH: dict = {}                   # device -> the 64 MB flush buffer


def _flush_buffer(dev) -> torch.Tensor:
    """A 64 MB buffer whose lines are clean in L2: reading it evicts what
    a timed launch left there, and the dirty lines that launch wrote are
    written back during the read, outside the timed window. (A write-based
    flush would leave 50 MB of dirty lines for the timed launch itself to
    write back.)"""
    buf = _FLUSH.get(dev)
    if buf is None:
        buf = torch.ones(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
        torch.empty_like(buf).zero_()   # evicts buf's dirty lines
        buf.sum()                       # ... and leaves buf clean in L2
        _FLUSH[dev] = buf
    return buf


def time_launches(fn, reps: int, *, device=None) -> list[float]:
    """Device times in us of ``reps`` single calls of ``fn``, after
    ``WARMUPS`` calls. Before each timed call a 64 MB read evicts the
    inputs from L2. Ahead of all of them one spin kernel keeps the card
    busy for longer than the host takes to queue every rep (sized from the
    warm-ups' host time), so no host time falls between a start and an end
    event. Holds ``DEVICE_LOCK`` throughout; nothing else may launch on
    the card meanwhile."""
    dev = resolve_device(device)
    with DEVICE_LOCK:
        flush = _flush_buffer(dev)
        t0 = time.perf_counter()
        for _ in range(WARMUPS):
            fn()
        host_s = (time.perf_counter() - t0) / WARMUPS + HOST_S_PER_REP
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
        torch.cuda._sleep(int(SPIN_MARGIN * reps * host_s
                              * costmodel.CLOCK_HZ))
        for start, end in zip(starts, ends):
            flush.sum()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize(dev)
        return [s.elapsed_time(e) * 1e3 for s, e in zip(starts, ends)]


class ProfilingAgent:
    """Measures a genome's performance over the suite.

    ``reps`` is the measurement fidelity: timed launches per test on the
    card, or a noise of ``NOISE_BASE / sqrt(reps)`` on the analytic model.
    The multi-agent loop uses the paper's 20 warm-ups + 100 reps; the
    single-agent baseline profiles with reps=1.
    """

    def __init__(self, *, reps: int = 100, backend: str | None = None):
        if backend not in (None, "cuda", "analytic"):
            raise ValueError(f"unknown profiling backend {backend!r}")
        if backend == "cuda":
            resolve_device("cuda")          # raises without a GPU
        self.reps = reps
        self.backend = backend
        self.noise = NOISE_BASE / max(reps, 1) ** 0.5

    def profile(self, space: KernelSpace, variant,
                tests: Sequence[TestCase]) -> Profile:
        """The genome's Profile over ``tests``: modelled, or timed when
        the backend (by default: the suite's device) is the card."""
        backend = self.backend or ("cuda" if on_card(tests) else "analytic")
        if backend == "cuda" and not on_card(tests):
            raise ValueError("the cuda profiling backend needs a suite on "
                             "the card")
        rows, costs = [], []
        for t in tests:
            try:
                c = space.cost(variant, **t.shape_info)
            except costmodel.Infeasible as e:
                # the genome cannot launch: a penalized latency, no launch
                rows.append({"name": t.name, "infeasible": str(e),
                             "latency_us": 1e9})
                costs.append(None)
                continue
            s = c.summary()
            s["name"] = t.name
            s["model_us"] = s["latency_us"]
            rows.append(s)
            costs.append(c)
        infeasible = any(c is None for c in costs)
        noise = self.noise
        if backend == "cuda" and not infeasible:
            spreads = []
            for t, row in zip(tests, rows):
                times = np.asarray(time_launches(
                    lambda t=t: space.run(variant, *t.args), self.reps,
                    device=t.args[0].device))
                med = float(np.median(times))
                q75, q25 = np.percentile(times, [75, 25])
                row["latency_us"] = med
                spreads.append((q75 - q25) / med if med > 0 else 0.0)
            noise = max(spreads, default=0.0)
        elif backend == "analytic":
            for row, c in zip(rows, costs):
                if c is not None:
                    row["latency_us"] = c.latency_s * 1e6 * (
                        1.0 + _pseudo_noise(
                            f"{space.name}/{variant}/{row['name']}",
                            self.noise))
        agg = {"memory": 0.0, "compute": 0.0, "overhead": 0.0}
        waste, pressure = 0.0, 0.0
        for c in costs:
            if c is None:
                continue
            agg["memory"] += c.mem_s
            agg["compute"] += c.compute_s
            agg["overhead"] += c.overhead_s
            waste += c.summary()["waste_frac"]
            pressure = max(pressure, c.pressure)
        lats = [r["latency_us"] for r in rows]
        total = sum(agg.values()) or 1.0
        geo = float(np.exp(np.mean(np.log(np.maximum(lats, 1e-9)))))
        return Profile(
            per_shape=rows,
            geomean_latency_us=geo,
            dominant=max(agg, key=agg.get),
            signals={
                "mem_frac": agg["memory"] / total,
                "compute_frac": agg["compute"] / total,
                "overhead_frac": agg["overhead"] / total,
                "waste_frac": waste / max(len(tests), 1),
                "smem_frac": pressure,
                "infeasible": infeasible,
            },
            noise_scale=noise,
        )


class PlanningAgent:
    """Proposes targeted modifications from correctness and performance
    signals, through a pluggable backend (the deterministic policy of
    ``policy.py`` by default)."""

    def __init__(self, backend=None):
        from repro_torch.core.policy import PolicyBackend
        self.backend = backend or PolicyBackend()

    def suggest(self, space: KernelSpace, variant, passed: bool,
                profile: Profile, history: list) -> Suggestion:
        """Algorithm 1's one move."""
        return self.backend.plan(space, variant, passed, profile, history)

    def suggest_many(self, space: KernelSpace, variant, passed: bool,
                     profile: Profile, history: list,
                     k: int = 4) -> list[Suggestion]:
        """Up to ``k`` distinct proposals, best first (for beam search)."""
        return self.backend.plan_many(space, variant, passed, profile,
                                      history, k=k)


class CodingAgent:
    """Applies a suggestion to the previous genome, clamping the move to
    the knob's legal values (bounds, powers of two)."""

    def apply(self, space: KernelSpace, variant, sug: Suggestion):
        """The genome with ``sug`` applied."""
        knob = next(k for k in space.knobs if k.name == sug.knob)
        value = sug.value
        if knob.kind == "pow2":
            value = int(value)
            value = max(knob.lo, min(knob.hi, 1 << (value - 1).bit_length()))
        elif knob.kind == "bool":
            value = bool(value)
        return space.mutate(variant, knob, value)
