"""The optimization log (the counterpart of ``repro/core/oplog.py``):
Algorithm 1's ``Log`` of (round, code, correctness, performance) tuples,
plus JSON/pretty output."""

from __future__ import annotations

import dataclasses
import json
from typing import Any


@dataclasses.dataclass
class LogEntry:
    round: int
    code: Any                       # the variant (genome) — our "code"
    correct: bool
    perf: Any                       # Profile
    rationale: str = ""
    max_err: float = 0.0

    def row(self) -> dict:
        return {
            "round": self.round,
            "variant": self.code.describe(),
            "correct": bool(self.correct),
            "latency_us": round(self.perf.geomean_latency_us, 3),
            "dominant": self.perf.dominant,
            "rationale": self.rationale,
            "max_err": float(self.max_err),
        }


class Log:
    """List of LogEntry with selection + serialization helpers."""

    def __init__(self) -> None:
        self.entries: list[LogEntry] = []
        # search metadata: strategy name, cache hit counts, kernel, ...
        self.meta: dict = {}

    def append(self, entry: LogEntry) -> None:
        self.entries.append(entry)

    def best(self) -> LogEntry:
        """Best CORRECT entry by measured geomean latency (final selection)."""
        ok = [e for e in self.entries if e.correct]
        return min(ok, key=lambda e: e.perf.geomean_latency_us)

    def baseline(self) -> LogEntry:
        return self.entries[0]

    def speedup(self) -> float:
        """Geomean speedup of the selected variant over the round-0 baseline."""
        return (self.baseline().perf.geomean_latency_us
                / self.best().perf.geomean_latency_us)

    def table(self) -> str:
        lines = [f"{'rnd':>3} {'ok':>3} {'lat(us)':>10} {'dom':>9}  variant / rationale"]
        for e in self.entries:
            lines.append(
                f"{e.round:>3} {'✓' if e.correct else '✗':>3} "
                f"{e.perf.geomean_latency_us:>10.2f} {e.perf.dominant:>9}  "
                f"{e.code.describe()}"
                + (f"\n{'':>29}  ← {e.rationale}" if e.rationale else ""))
        return "\n".join(lines)

    def to_json(self) -> str:
        payload = {"meta": self.meta, "entries": [e.row() for e in self.entries]}
        return json.dumps(payload, indent=2, default=str)
