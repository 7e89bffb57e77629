"""Scheduling layer of the serving API: the admission-order protocol and
its first-come-first-served policy, and the preemption policies (who loses
their pages when the pool runs dry, and what happens to their KV).

The engine consults a ``Scheduler`` for *which waiting request to admit
next*; everything else (slot residency, the decode step) stays in the
engine. The protocol:

    push(req)      new submission
    requeue(req)   a preempted request comes back with precedence
    peek()         the next request to admit (None when empty); admission
                   is head-of-line: if the cache cannot hold ``peek()``
                   yet, the engine waits rather than skipping it
    pop()          commit the admission of ``peek()``
    remove(req)    pull one waiting request out of line (by identity)
    waiting()      snapshot list of waiting requests
    __len__        waiting-request count
    stats()        {"scheduler", "sched_admitted", "sched_reorders"}

``sched_reorders`` counts pops that were not the oldest waiting request:
0 under FCFS by construction.
"""

from __future__ import annotations

from collections import deque
from typing import Protocol, runtime_checkable


@runtime_checkable
class Scheduler(Protocol):
    """Admission-order policy surface consumed by the engine."""

    name: str

    def push(self, req) -> None: ...
    def requeue(self, req) -> None: ...
    def peek(self): ...
    def pop(self): ...
    def remove(self, req) -> bool: ...
    def waiting(self) -> list: ...
    def __len__(self) -> int: ...
    def stats(self) -> dict: ...


class FCFSScheduler:
    """First-come-first-served: submissions append, requeued requests go
    back to the front, admission pops the head."""

    name = "fcfs"

    def __init__(self):
        self._q: deque = deque()
        self.admitted = 0
        self.reorders = 0

    def push(self, req) -> None:
        """Append a new submission."""
        self._q.append(req)

    def requeue(self, req) -> None:
        """Put a preempted request back at the head."""
        self._q.appendleft(req)

    def peek(self):
        """The head of line, or None."""
        return self._q[0] if self._q else None

    def pop(self):
        """Admit the head of line."""
        req = self._q[0]
        self.admitted += 1
        if req.arrival != min(r.arrival for r in self._q):
            self.reorders += 1
        return self._q.popleft()

    def remove(self, req) -> bool:
        """Pull ``req`` out of line by identity; True when found."""
        for i, r in enumerate(self._q):
            if r is req:
                del self._q[i]
                return True
        return False

    def waiting(self) -> list:
        """Snapshot of the waiting requests."""
        return list(self._q)

    def __len__(self) -> int:
        return len(self._q)

    def stats(self) -> dict:
        """Scheduler counters."""
        return {"scheduler": self.name, "sched_admitted": self.admitted,
                "sched_reorders": self.reorders}


# ---------------------------------------------------------------------------
# preemption policy
# ---------------------------------------------------------------------------

@runtime_checkable
class PreemptionPolicy(Protocol):
    """Who loses their pages when the pool runs dry, and what eviction
    does with their KV. ``mode`` is read by the engine: "swap" copies the
    victim's pages and device state to the host for a byte-exact restore;
    "recompute" drops them and re-prefills the prompt and the generated
    prefix on re-admission."""

    mode: str

    def select_victim(self, occupants) -> int: ...


class _YoungestVictim:
    """FCFS-fair eviction: the most recently submitted occupant loses.
    ``occupants`` is a list of ``(slot_index, request)`` pairs."""

    def select_victim(self, occupants) -> int:
        """The slot of the youngest occupant."""
        return max(occupants, key=lambda t: t[1].arrival)[0]


class SwapPreemption(_YoungestVictim):
    """Youngest victim; its pages and device state go to the host and come
    back byte for byte on re-admission, so its stream is unchanged."""

    mode = "swap"


class RecomputePreemption(_YoungestVictim):
    """Youngest victim; its pages are dropped and re-admission re-prefills
    prompt + generated prefix (cheaper in host memory; greedy-stable
    only: a near-tied argmax can flip)."""

    mode = "recompute"


PREEMPTION_POLICIES = {"swap": SwapPreemption,
                       "recompute": RecomputePreemption}


def make_preemption(policy) -> PreemptionPolicy:
    """Resolve a policy name (None: swap) or pass an instance through."""
    if policy is None:
        return SwapPreemption()
    if isinstance(policy, str):
        try:
            return PREEMPTION_POLICIES[policy]()
        except KeyError:
            raise ValueError(f"unknown preemption policy {policy!r}; "
                             f"have {sorted(PREEMPTION_POLICIES)}") from None
    return policy
