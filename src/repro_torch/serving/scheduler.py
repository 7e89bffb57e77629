"""Scheduling layer of the serving API: the admission-order protocol and
its policies (first come first served, priority, shortest job first), and
the preemption policies (who loses their pages when the pool runs dry,
and what happens to their KV).

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
0 under FCFS by construction. ``PriorityScheduler`` and ``SJFScheduler``
sort the waiting requests (higher ``Request.priority`` first / shortest
estimated job first); requeued requests keep precedence, most recent
requeue first, as the FCFS deque gives them.
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


class _BaseScheduler:
    """Counters, ``waiting`` and ``remove`` over the waiting set ``_q``."""

    name = "base"

    def __init__(self):
        self.admitted = 0
        self.reorders = 0

    def _note_pop(self, req, waiting) -> None:
        self.admitted += 1
        if req.arrival != min(r.arrival for r in waiting):
            self.reorders += 1

    def waiting(self) -> list:
        """Snapshot of the waiting requests."""
        return list(self._q)

    def remove(self, req) -> bool:
        """Pull ``req`` out of line by identity (``Request`` equality
        would compare numpy prompts); True when found. Not an
        admission."""
        for i, r in enumerate(self._q):
            if r is req:
                del self._q[i]
                req._requeue_seq = None
                return True
        return False

    def __len__(self) -> int:
        return len(self._q)

    def stats(self) -> dict:
        """Scheduler counters."""
        return {"scheduler": self.name, "sched_admitted": self.admitted,
                "sched_reorders": self.reorders}


class FCFSScheduler(_BaseScheduler):
    """First-come-first-served: submissions append, requeued requests go
    back to the front, admission pops the head."""

    name = "fcfs"

    def __init__(self):
        super().__init__()
        self._q: deque = deque()

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
        self._note_pop(self._q[0], self._q)
        return self._q.popleft()


class _SortedScheduler(_BaseScheduler):
    """Admits the least waiting request by ``_key``, ties by arrival.
    Requeued requests sort before everything else, the most recent
    requeue first."""

    def __init__(self):
        super().__init__()
        self._q: list = []
        self._requeues = 0

    def _key(self, req) -> tuple:
        raise NotImplementedError

    def _full_key(self, req) -> tuple:
        seq = getattr(req, "_requeue_seq", None)
        if seq is not None:
            return (0, -seq)
        return (1,) + self._key(req) + (req.arrival,)

    def push(self, req) -> None:
        """Add a new submission."""
        self._q.append(req)

    def requeue(self, req) -> None:
        """Add a preempted request back, ahead of every submission."""
        self._requeues += 1
        req._requeue_seq = self._requeues
        self._q.append(req)

    def peek(self):
        """The next request to admit, or None."""
        return min(self._q, key=self._full_key) if self._q else None

    def pop(self):
        """Admit ``peek()``, removing it by identity."""
        req = self.peek()
        self._note_pop(req, self._q)
        self.remove(req)
        return req


class PriorityScheduler(_SortedScheduler):
    """Highest ``Request.priority`` first; FCFS within a priority level."""

    name = "priority"

    def _key(self, req) -> tuple:
        return (-req.priority,)


class SJFScheduler(_SortedScheduler):
    """Shortest estimated job first: prompt length + requested new tokens;
    FCFS on ties."""

    name = "sjf"

    def _key(self, req) -> tuple:
        return (len(req.prompt) + req.max_new_tokens,)


SCHEDULERS = {"fcfs": FCFSScheduler, "priority": PriorityScheduler,
              "sjf": SJFScheduler}


def make_scheduler(policy) -> Scheduler:
    """Resolve a policy name (None: FCFS) or pass an instance through."""
    if policy is None:
        return FCFSScheduler()
    if isinstance(policy, str):
        try:
            return SCHEDULERS[policy]()
        except KeyError:
            raise ValueError(f"unknown scheduler {policy!r}; "
                             f"have {sorted(SCHEDULERS)}") from None
    return policy


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
