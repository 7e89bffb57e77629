"""The reduction of a ``torch.profiler`` trace to what the per-layer
readers and the result's ``device`` and ``breakdown`` take.

Device intervals are the profiler's device-side events (kernels, copies,
sets; not the profiler's own annotations), clipped to the traced window.
Busy time is the length of their union (``serve --profile`` summed the
events' durations, which counts overlapping work twice). Idle gaps are
the holes in that union, each named by the harness's host span that held
its middle.
"""

from __future__ import annotations

import dataclasses
import re

WINDOW = "bench.traced"        # the record_function around the traced part


@dataclasses.dataclass
class Trace:
    """A traced window: device events ``(name, start_s, end_s)`` on the
    host clock, the window ``[t0, t1)`` on it too."""
    t0: float
    t1: float
    device: list

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy(self) -> list:
        """The union of the device intervals, sorted, as ``[a, b)``."""
        out: list = []
        for _, a, b in sorted(self.device, key=lambda e: e[1]):
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def gaps(self) -> list:
        """Idle intervals ``(a, b)`` of the window."""
        edges, last = [], self.t0
        for a, b in self.busy():
            if a > last:
                edges.append((last, a))
            last = b
        if self.t1 > last:
            edges.append((last, self.t1))
        return edges

    def time_of(self, patterns) -> float:
        """Device seconds of the events whose name matches any of
        ``patterns`` (regular expressions), clipped to the window."""
        rx = re.compile("|".join(f"(?:{p})" for p in patterns))
        return sum(max(0.0, min(b, self.t1) - max(a, self.t0))
                   for name, a, b in self.device if rx.search(name))


def short_name(name: str) -> str:
    """A kernel's function name without its namespace, template and
    arguments, or the first 60 characters of anything else."""
    name = name.replace("(anonymous namespace)", "")
    m = re.search(r"(\w+)\s*(?:<|\()", name.removeprefix("void "))
    return m.group(1) if m else name[:60]


def from_profiler(prof, anchor_host: float) -> Trace:
    """Reduce ``prof`` (stopped) to a ``Trace`` on the host clock, from
    the profiler's raw events (building its ``FunctionEvent`` tree takes
    twenty times longer). ``anchor_host`` is the ``perf_counter`` reading
    taken as the ``WINDOW`` span opened, which ties the profiler's clock
    to the host's."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    win, dev = None, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                dev.append((e.name(), e.start_ns(), e.end_ns()))
        elif e.name() == WINDOW:
            win = (e.start_ns(), e.end_ns())
    if win is None:
        raise RuntimeError("the profiler recorded no traced window")
    off = anchor_host - win[0] / 1e9
    return Trace(anchor_host, win[1] / 1e9 + off,
                 [(n, a / 1e9 + off, b / 1e9 + off) for n, a, b in dev])


def breakdown(tr: Trace, label_at, top: int = 10) -> dict:
    """The device operations that took most time, by short name, and the
    longest idle gaps, each named by ``label_at(t)``: the host span at the
    gap's middle. Seconds as measured."""
    ops: dict = {}
    for name, a, b in tr.device:
        a, b = max(a, tr.t0), min(b, tr.t1)
        if b > a:
            key = short_name(name)
            ops[key] = ops.get(key, 0.0) + (b - a)
    gaps = sorted(tr.gaps(), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": sorted(([k, v] for k, v in ops.items()),
                                 key=lambda kv: -kv[1])[:top],
            "idle_gaps": [[label_at((a + b) / 2), b - a] for a, b in gaps]}
