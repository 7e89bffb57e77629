"""Fault tolerance (the JAX ``training/fault_tolerance.py``): restart on
failure, the straggler watchdog, heartbeats and failure injection for
drills.

The control plane is file-based: the directory of committed checkpoints
is the only source of truth, and a relaunched run rebuilds (parameters,
optimizer state, data cursor) from the newest commit.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

from repro_torch.reliability import Fault, FaultSchedule


class FailureInjector:
    """Raises at a chosen step, once: a thin wrapper over the shared
    ``reliability.FaultSchedule``."""

    def __init__(self, fail_at_step: int | None = None):
        self.fail_at_step = fail_at_step
        faults = ([] if fail_at_step is None
                  else [Fault(kind="raise", step=fail_at_step)])
        self._schedule = FaultSchedule(faults)

    @property
    def fired(self) -> bool:
        return self._schedule.fired > 0

    def maybe_fail(self, step: int):
        if self._schedule.due(step):
            raise RuntimeError(f"injected failure at step {step}")


@dataclasses.dataclass
class StragglerWatchdog:
    """Flags steps slower than ``threshold`` times the running median; a
    run may checkpoint and restart once ``consecutive_limit`` steps in a
    row were slow (``should_restart``)."""
    threshold: float = 3.0
    consecutive_limit: int = 5
    history: list = dataclasses.field(default_factory=list)
    consecutive: int = 0
    flagged_steps: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, seconds: float) -> bool:
        self.history.append(seconds)
        window = sorted(self.history[-64:])
        median = window[len(window) // 2]
        slow = len(self.history) > 4 and seconds > self.threshold * median
        if slow:
            self.flagged_steps.append(step)
            self.consecutive += 1
        else:
            self.consecutive = 0
        return slow

    @property
    def should_restart(self) -> bool:
        return self.consecutive >= self.consecutive_limit


class Heartbeat:
    """Liveness file a supervisor would watch."""

    def __init__(self, path: str):
        self.path = path

    def beat(self, step: int):
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": step, "t": time.time()}, f)
        os.replace(tmp, self.path)

    def last(self):
        try:
            with open(self.path) as f:
                return json.load(f)
        except FileNotFoundError:
            return None


def run_with_restarts(make_fn, *, max_restarts: int = 3, on_restart=None):
    """Run ``make_fn()`` (a whole training run that may raise); on a
    failure call it again, up to ``max_restarts`` times: it resumes from
    the newest committed checkpoint. Returns the run's result."""
    attempt = 0
    while True:
        try:
            return make_fn()
        except Exception as e:  # noqa: BLE001 -- any worker death
            attempt += 1
            if attempt > max_restarts:
                raise
            if on_restart is not None:
                on_restart(attempt, e)
