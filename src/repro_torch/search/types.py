"""Core datatypes of the search subsystem (the counterpart of
``repro/search/types.py``).

A genome is one point in a kernel's optimization space (the frozen variant
dataclass the coding agent edits). An evaluation result is what the
agents learn about a genome: the correctness verdict, the max error and
the profiling agent's ``Profile``.

Genomes are content-addressed: ``genome_digest`` hashes the knob values
and ignores the cosmetic ``name`` field (which records the last move, not
the genome), so two paths to the same knob settings share one evaluation.
Where a space says what a genome launches on each test (its
``launch_key``), ``launch_digest`` hashes that instead, so genomes whose
knobs differ but launch the same code share one evaluation too.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Sequence


def genome_key(variant) -> tuple:
    """Identity of a genome: (knob, value) pairs, ``name`` excluded."""
    return tuple((f.name, getattr(variant, f.name))
                 for f in dataclasses.fields(variant) if f.name != "name")


def genome_digest(variant) -> str:
    """Stable content hash of a genome (16 hex chars)."""
    payload = repr((type(variant).__name__,) + genome_key(variant))
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def launch_digest(variant, tests: Sequence, launch_key) -> str:
    """Stable hash (16 hex chars) of what ``variant`` launches on each of
    ``tests``: ``launch_key(variant, **shape_info)`` per test."""
    payload = repr((type(variant).__name__,) + tuple(
        launch_key(variant, **t.shape_info) for t in tests))
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def suite_digest(tests: Sequence, *, salt: str = "") -> str:
    """Stable content hash of a test suite T, keyed on each case's name
    (which encodes its shape) and dtype. What the cases do not show (the
    data seed, the profiling fidelity, the device) goes into ``salt``;
    ``SearchContext`` does that."""
    payload = repr([(t.name, str(t.shape_info.get("dtype")))
                    for t in tests]) + salt
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class EvalResult:
    """What the testing and profiling agents learned about one genome."""
    passed: bool
    max_err: float
    profile: Any                    # agents.Profile
    validated: bool = True          # False: correctness assumed, not run
    cached: bool = False            # True: served from the evaluation cache
    # True: the evaluator rejected the genome from its profile alone (it
    # cannot launch, or is clearly dominated); validation never ran, so
    # ``passed`` is a screening verdict, not a correctness verdict
    screened: bool = False
    # how the evaluation ended: "ok" (the pipeline ran to a verdict),
    # "screened" (rejected from the profile alone) or "crashed" (the genome
    # was quarantined after it repeatedly crashed or hung its isolation
    # worker; ``passed`` is False and ``error`` says why). A crashed
    # verdict is final: the cache serves it and the genome never runs again
    finish_reason: str = "ok"
    error: str | None = None        # infra detail of a crashed genome
    # suite index of the test that failed validation (-1: none failed);
    # the evaluator's smoke ordering counts these, and a resumed search
    # rebuilds those counts from it
    failed_test: int = -1
    # True: replayed from a search journal on resume; its failure count is
    # applied once, at its first delivery. Never persisted
    replayed: bool = False

    @property
    def failed_infra(self) -> bool:
        """True when the verdict is an infrastructure failure (a worker
        crash or timeout quarantine), not a correctness check."""
        return self.finish_reason == "crashed"
