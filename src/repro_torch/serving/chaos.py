"""Deterministic chaos injection for the serving engine (the port of the
JAX ``serving/chaos.py``).

``ChaosInjector`` wires a step-indexed ``reliability.FaultSchedule`` into
the engine's decode loop and injects the failures the request lifecycle
claims to survive:

    device_fault      raise ``InjectedDeviceFault`` before the step's
                      replay is queued: quarantine of the named slot's
                      request and crash recovery of the rest (their
                      streams stay equal to an undisturbed run's)
    pool_exhaustion   ``PagePool.seize_free`` a hold of pages for a window
                      of steps: preemption under outside pressure; the
                      hold ends by itself, or early through ``relent`` if
                      it alone blocks progress
    corrupt_readback  overwrite one slot's token in a step's host copy of
                      the emit, after its event has synchronized (never
                      the device buffer the captured step writes):
                      quarantine of that request alone
    stall             sleep inside ``step()``: deadline expiry
    abort             ``engine.abort(rid)`` at a chosen step

Everything is keyed on the engine's step counter, never on the wall
clock (a stall's sleep aside), so a chaos run against a fixed request mix
is reproducible.
"""

from __future__ import annotations

import time
from typing import Iterable

import numpy as np

from repro_torch.reliability import Fault, FaultSchedule

KINDS = frozenset({"device_fault", "pool_exhaustion", "corrupt_readback",
                   "stall", "abort"})

# the token corrupt_readback plants: outside any vocab and not the -1 of
# an idle slot, so the engine's readback check must catch it
CORRUPT_TOKEN = np.iinfo(np.int32).max


class InjectedDeviceFault(RuntimeError):
    """Stands in for a failure of the decode step before its replay was
    queued. ``slot`` names the slot whose request recovery quarantines;
    None lets the engine's preemption policy choose."""

    def __init__(self, message: str, slot=None):
        super().__init__(message)
        self.slot = slot


class ChaosInjector:
    """Deterministic step-indexed fault injector for the serving engine."""

    def __init__(self, faults: Iterable[Fault]):
        faults = list(faults)
        for f in faults:
            if f.kind not in KINDS:
                raise ValueError(f"unknown chaos fault kind {f.kind!r}; "
                                 f"have {sorted(KINDS)}")
        self.schedule = FaultSchedule(faults)
        self._seized: list[tuple[int, list[int]]] = []  # (release_at, pages)
        self.injected = {k: 0 for k in sorted(KINDS)}
        self.relents = 0

    # -- engine hooks -------------------------------------------------------

    def on_step(self, engine, step: int) -> None:
        """Host-side faults, applied at the top of ``Engine.step()``."""
        for rel, pages in list(self._seized):
            if step >= rel:
                engine.cm.pool.release_seized(pages)
                self._seized.remove((rel, pages))
        for f in self.schedule.due(step, kinds=("pool_exhaustion", "stall",
                                                "abort")):
            if f.kind == "pool_exhaustion" and engine.cm.paged:
                pages = engine.cm.pool.seize_free(f.pages)
                if pages:
                    self.injected["pool_exhaustion"] += 1
                    self._seized.append((step + max(1, f.steps), pages))
            elif f.kind == "stall":
                self.injected["stall"] += 1
                time.sleep(f.seconds)
            elif f.kind == "abort":
                self.injected["abort"] += 1
                engine.abort(f.rid)

    def pre_dispatch(self, engine, step: int) -> None:
        """Raise before the step's replay is queued: the carry, the pool
        and the draft cache still hold the state from before the step,
        and the engine's recovery takes it from there."""
        for f in self.schedule.due(step, kinds=("device_fault",)):
            self.injected["device_fault"] += 1
            raise InjectedDeviceFault(
                f"injected device fault at step {step}", slot=f.slot)

    def filter_emit(self, step: int, emit):
        """Overwrite one slot's token in step ``step``'s host readback
        ``(tokens, done)``, in place (a spec step's row of ``k + 1``
        tokens whole). Returns ``emit``."""
        tok, _ = emit
        for f in self.schedule.due(step, kinds=("corrupt_readback",)):
            self.injected["corrupt_readback"] += 1
            tok[f.slot if f.slot is not None else 0] = CORRUPT_TOKEN
        return emit

    def relent(self, engine) -> bool:
        """The engine is idle and cannot admit: a live page hold may be
        all that blocks progress, so end every hold early (chaos must
        cause preemption, not a deadlock). True when anything was
        released."""
        if not self._seized:
            return False
        for _, pages in self._seized:
            engine.cm.pool.release_seized(pages)
        self._seized.clear()
        self.relents += 1
        return True

    # -- reporting ----------------------------------------------------------

    @property
    def exhausted(self) -> bool:
        """Did every scheduled fault fire?"""
        return self.schedule.exhausted

    def stats(self) -> dict:
        """Faults injected by kind, and the holds ended early."""
        return {"chaos_injected": dict(self.injected),
                "chaos_relents": self.relents}
