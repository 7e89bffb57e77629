"""Window accounting on the harness's own host-clock stamps.

A request record carries its due time (open loops; the submission for
closed ones), its submission and the time each of its output tokens
landed on the host, all ``time.perf_counter()`` seconds. The measured
window is ``[t_open, t_close)``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass
class Rec:
    """One request as the harness saw it."""
    rid: int
    prompt_len: int
    max_new: int
    due: float
    client: int = -1
    submitted: float = math.nan
    tokens: list = dataclasses.field(default_factory=list)  # landing times
    done: Optional[float] = None
    reason: Optional[str] = None
    req: object = dataclasses.field(default=None, repr=False)


def percentile(values, p: float) -> Optional[float]:
    """The nearest-rank ``p``-th percentile (``p`` in (0, 100]): the
    smallest value with at least ``p`` percent of the values at or below
    it. None for no values."""
    xs = sorted(values)
    if not xs:
        return None
    return xs[max(0, math.ceil(p / 100 * len(xs)) - 1)]


def tokens_in(recs, t0: float, t1: float) -> int:
    """Output tokens that landed in ``[t0, t1)``."""
    return sum(t0 <= t < t1 for r in recs for t in r.tokens)


def ttfts(recs, t0: float, t1: float, end: float) -> list:
    """Due-to-first-token seconds of every request due in ``[t0, t1)``. A
    request with no token by ``end`` (failed, refused, or still waiting)
    counts as waiting until ``end``."""
    return [(r.tokens[0] if r.tokens and r.reason in (None, "done")
             else end) - r.due for r in recs if t0 <= r.due < t1]


def itls(recs, t0: float, t1: float) -> list:
    """Gaps between consecutive output tokens of a request whose later
    token landed in ``[t0, t1)``, over all requests."""
    return [b - a for r in recs for a, b in zip(r.tokens, r.tokens[1:])
            if t0 <= b < t1]
