"""Spans of the serving engine on the host clock.

A ``Tracer`` records nothing until ``start()`` and hands its spans over
at ``stop()``; they stay in memory in between. Each span has a name, its
start and end (``time.perf_counter()`` seconds, the clock
``torch.profiler`` events are tied to through an anchor read beside a
``record_function``), an id, the id of the span that encloses it (None
for a root), the request it belongs to (``rid``, or None) and a few
attributes.

An instrumented site tests ``tracer.on`` and does nothing else while it
is off: no clock read, no allocation, no call. Nested spans are opened
and closed in stack order; ``add`` records a span whose ends are already
known (a request's wait in the queue, which spans several steps).

On a CUDA device, a span opened with ``timed=True`` also records a pair
of CUDA events around the work it enqueues. Its device time,
``attrs["device_s"]``, is read by ``settle()`` only once the pair has
completed, which the caller does after a synchronisation it makes
anyway, so tracing adds none. A pair still in flight at ``stop()``
leaves its span without ``device_s``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch


@dataclasses.dataclass
class Span:
    name: str
    t0: float
    t1: Optional[float] = None
    id: int = 0
    parent: Optional[int] = None
    rid: Optional[int] = None
    attrs: dict = dataclasses.field(default_factory=dict)


class Tracer:
    """The engine's span recorder (``Engine.tracer``)."""

    def __init__(self, device=None):
        self.on = False
        self._cuda = device is not None and torch.device(device).type == \
            "cuda"
        self._device = device
        self._reset()

    def _reset(self) -> None:
        self.spans: list = []
        self._stack: list = []
        self._starts: dict = {}         # span id -> its start event
        self._pairs: list = []          # (span, start, end) in flight
        self._waits: dict = {}          # rid -> when it was requeued

    def start(self) -> None:
        """Drop what was recorded and record from now on."""
        self._reset()
        self.on = True

    def stop(self) -> list:
        """Stop recording; returns the spans in the order they opened.
        Spans still open end now."""
        self.on = False
        if self._stack:
            self.close(self._stack[0])
        self.settle()
        spans = self.spans
        self._reset()
        return spans

    def open(self, name: str, rid: Optional[int] = None,
             timed: bool = False, **attrs) -> Span:
        parent = self._stack[-1].id if self._stack else None
        sp = Span(name, time.perf_counter(), id=len(self.spans),
                  parent=parent, rid=rid, attrs=attrs)
        if timed and self._cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self._device))
            self._starts[sp.id] = ev
        self.spans.append(sp)
        self._stack.append(sp)
        return sp

    def close(self, span: Span, **attrs) -> None:
        """End ``span`` and any span still open inside it."""
        if span.t1 is not None:
            return
        t1 = time.perf_counter()
        while self._stack:
            sp = self._stack.pop()
            sp.t1 = t1
            start = self._starts.pop(sp.id, None)
            if start is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record(torch.cuda.current_stream(self._device))
                self._pairs.append((sp, start, end))
            if sp is span:
                break
        span.attrs.update(attrs)

    def add(self, name: str, t0: float, t1: float,
            rid: Optional[int] = None, **attrs) -> Span:
        """A root span whose ends are known."""
        sp = Span(name, t0, t1, id=len(self.spans), rid=rid, attrs=attrs)
        self.spans.append(sp)
        return sp

    def settle(self) -> None:
        """Read the device time of every event pair that has completed."""
        if not self._pairs:
            return
        left = []
        for sp, start, end in self._pairs:
            if end.query():
                sp.attrs["device_s"] = start.elapsed_time(end) / 1e3
            else:
                left.append((sp, start, end))
        self._pairs = left

    def requeued(self, rid: int) -> None:
        """``rid`` went back to the queue now (a preemption)."""
        self._waits[rid] = time.perf_counter()

    def waited_since(self, rid: int, t_submit: float,
                     preempted: bool) -> Optional[float]:
        """When ``rid``'s present wait in the queue began: its requeue
        seen while recording, else its submission if it was never
        preempted; None when the wait began unseen."""
        t = self._waits.pop(rid, None)
        if t is not None:
            return t
        return None if preempted else t_submit


def summarize(spans) -> dict:
    """{name: {"count", "total_s", "mean_s", "self_s"}} over ``spans``,
    plus ``device_s`` (the mean) where spans of the name carry one. Self
    time is a span's own less that of the spans directly inside it."""
    child_s: dict = {}
    for sp in spans:
        if sp.parent is not None:
            child_s[sp.parent] = child_s.get(sp.parent, 0.0) + sp.t1 - sp.t0
    out: dict = {}
    for sp in spans:
        row = out.setdefault(sp.name, {"count": 0, "total_s": 0.0,
                                       "self_s": 0.0, "device": []})
        d = sp.t1 - sp.t0
        row["count"] += 1
        row["total_s"] += d
        row["self_s"] += d - child_s.get(sp.id, 0.0)
        if "device_s" in sp.attrs:
            row["device"].append(sp.attrs["device_s"])
    for row in out.values():
        row["mean_s"] = row["total_s"] / row["count"]
        dev = row.pop("device")
        if dev:
            row["device_s"] = sum(dev) / len(dev)
    return out


def table(summary: dict) -> str:
    """``summarize``'s rows as text, the longest total first, in ms."""
    head = f"{'span':<24}{'count':>8}{'total':>12}{'mean':>10}{'self':>12}" \
        f"{'device':>10}"
    lines = [head]
    for name, r in sorted(summary.items(), key=lambda kv: -kv[1]["total_s"]):
        dev = f"{r['device_s'] * 1e3:10.3f}" if "device_s" in r else \
            f"{'':>10}"
        lines.append(f"{name:<24}{r['count']:>8}{r['total_s'] * 1e3:12.3f}"
                     f"{r['mean_s'] * 1e3:10.3f}{r['self_s'] * 1e3:12.3f}"
                     f"{dev}")
    return "\n".join(lines)
