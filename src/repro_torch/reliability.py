"""Deterministic fault injection (the counterpart of
``repro/reliability.py``).

One step-indexed, fire-once fault list makes chaos runs reproducible: the
same ``Fault`` list against the same work injects the same faults at the
same points every time. ``SearchChaosInjector`` drives the search worker
pool (``search/workers.py``); ``FaultSchedule`` is the schedule a serving
chaos harness consumes.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import Counter
from typing import Iterable, Optional, Sequence


class EvalTimeout(Exception):
    """A candidate evaluation exceeded its deadline. Raised by the
    cooperative budget in ``TestingAgent.validate(timeout_s=...)`` and
    recorded by the worker pool when it shoots an over-deadline worker."""


@dataclasses.dataclass
class Fault:
    """One scheduled fault. ``kind`` is interpreted by the consumer (the
    serving chaos harness understands ``device_fault`` /
    ``pool_exhaustion`` / ``corrupt_readback`` / ``stall`` / ``abort``;
    the training injector uses ``raise``; the search chaos injector uses
    ``kill_worker`` / ``hang_eval`` / ``corrupt_result``); the remaining
    fields are kind-specific knobs and ignored by kinds that don't use
    them."""

    kind: str
    step: int = -1                  # fires when the consumer reaches it
    slot: Optional[int] = None      # device_fault / corrupt_readback
    rid: Optional[int] = None       # abort
    pages: int = 0                  # pool_exhaustion: pages to seize
    steps: int = 1                  # pool_exhaustion: hold duration
    seconds: float = 0.0            # stall / hang_eval: sleep length
    # search chaos: match by genome digest instead of step index —
    # deterministic regardless of dispatch interleaving under workers>1
    digest: Optional[str] = None
    times: int = 1                  # search chaos: fire on the first N
    #                                 attempts (drives quarantine paths)


class FaultSchedule:
    """Step-indexed fault list where each fault fires exactly once.

    ``due(step)`` returns (and permanently marks fired) every not-yet-
    fired fault scheduled for exactly ``step``. Step numbers that the
    consumer never reaches simply leave their faults unfired — visible
    via ``exhausted`` so harnesses can assert their plan fully ran.
    """

    def __init__(self, faults: Iterable[Fault]):
        self.faults = list(faults)
        self._fired = [False] * len(self.faults)

    def due(self, step: int,
            kinds: Optional[Sequence[str]] = None) -> list[Fault]:
        out = []
        for i, f in enumerate(self.faults):
            if self._fired[i] or f.step != step:
                continue
            if kinds is not None and f.kind not in kinds:
                continue
            self._fired[i] = True
            out.append(f)
        return out

    @property
    def fired(self) -> int:
        return sum(self._fired)

    @property
    def exhausted(self) -> bool:
        return all(self._fired)


class SearchChaosInjector:
    """Deterministic fault plan for the search worker pool.

    Each ``Fault`` targets one evaluation *attempt* and names what happens
    to it: ``kill_worker`` (the child hard-exits mid-task), ``hang_eval``
    (the child sleeps ``seconds`` — set it past the pool deadline to drill
    the join-timeout kill), or ``corrupt_result`` (the child flips bytes in
    its result payload, which the parent's checksum must catch).

    Matching is by ``digest`` when set (the evaluation's key digest: the
    genome digest, or the launch digest where the space has a
    ``launch_key``) — deterministic under any
    dispatch interleaving, so it is the form chaos tests use with
    ``workers > 1`` — else by ``step`` against the pool's global dispatch
    counter (deterministic only with one worker). ``times=N`` arms the
    fault for the genome's first N attempts: N below the quarantine
    threshold proves retry-then-recover, N at the threshold proves
    quarantine. Every armed attempt fires at most once, so retries beyond
    the plan run clean.
    """

    KINDS = frozenset({"kill_worker", "hang_eval", "corrupt_result"})

    def __init__(self, faults: Iterable[Fault]):
        self.faults: list[Fault] = []
        for f in faults:
            if f.kind not in self.KINDS:
                raise ValueError(f"unknown search-chaos kind {f.kind!r}")
            if f.digest is None and f.step < 0:
                raise ValueError(
                    "search-chaos fault needs a digest or a step index")
            for _ in range(max(1, f.times)):
                self.faults.append(f)
        self._fired = [False] * len(self.faults)
        self._lock = threading.Lock()
        self.injected: Counter = Counter()

    def directive_for(self, digest: str,
                      dispatch_index: int) -> Optional[Fault]:
        """The fault (if any) armed for this attempt; marks it fired."""
        with self._lock:
            for i, f in enumerate(self.faults):
                if self._fired[i]:
                    continue
                if f.digest is not None:
                    if not digest.startswith(f.digest):
                        continue
                elif f.step != dispatch_index:
                    continue
                self._fired[i] = True
                self.injected[f.kind] += 1
                return f
        return None

    @property
    def fired(self) -> int:
        with self._lock:
            return sum(self._fired)

    @property
    def exhausted(self) -> bool:
        with self._lock:
            return all(self._fired)
