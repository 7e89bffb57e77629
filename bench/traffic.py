"""The one traffic generator: every mix is a data file of parameters that
this module reads (``bench/mixes/<traffic>.json``).

A mix gives lognormal prompt and output lengths (median, sigma, clipped to
[min, max]) and either a closed loop of ``clients`` or an open loop at
``rate_per_s``.

Every seed gets the same work, in the same local arrangement: one block
of ``BLOCK`` requests holds the lognormal's quantiles at the midpoints of
``BLOCK`` equal slices of probability (prompt and output lengths paired
by two fixed shuffles) and, for open loops, the exponential's quantiles
at the same midpoints as the gaps before them (a third fixed shuffle):
the arrivals of a Poisson process at the mix's rate, stratified and in
one fixed order, not drawn. The stream repeats that block. The shuffles
are fixed, not the seed's: with the seed choosing them, two seeds put
different bursts of long prompts into the window, and the tails of one
seed's runs agreed within 0.3% where those of six seeds spread by 18%
(``danube-longdoc-open``, PERF.md). The seed chooses where in the block
the stream starts, and the token ids, uniform over the vocabulary, drawn
per request from the seed and the request's index.

A closed loop starts in its steady state, the same for every seed: client
``c``'s first request has the lengths of the block's ``c mod BLOCK``-th
request (the seed's start applies only after this first wave) and has
already produced a share ``u_c`` of its output, ``u`` a fixed shuffle of
the midpoints of ``clients`` slices of ``[0, 1)``, so its prompt is
longer by that many tokens and its output shorter. The fill that
precedes the window then prefills the same lengths under every seed.
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import Optional

import numpy as np

_PHI = NormalDist()
BLOCK = 16          # requests in one block of the stream


def _u64(seed: int) -> int:
    return int(seed) % 2**64


def stratified(block: int) -> np.ndarray:
    """Midpoints of ``block`` equal slices of [0, 1)."""
    return (np.arange(block) + 0.5) / block


def lognormal_lengths(spec: dict, block: int) -> np.ndarray:
    """One block of lengths: the lognormal quantiles at ``stratified``,
    rounded and clipped to ``[min, max]``."""
    q = np.array([_PHI.inv_cdf(u) for u in stratified(block)])
    x = spec["median"] * np.exp(spec["sigma"] * q)
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class Item:
    """One request as the traffic makes it."""
    index: int
    prompt_len: int
    max_new: int
    client: int = -1           # closed loops: the client that sends it
    due: float = 0.0           # open loops: seconds after the start


class Traffic:
    """The requests of one mix under one seed."""

    def __init__(self, mix: dict, seed: int, vocab: int, max_seq: int):
        self.mix, self.vocab, self.max_seq = mix, vocab, max_seq
        if mix["loop"] not in ("closed", "open"):
            raise ValueError(f"loop must be closed or open: {mix['loop']}")
        self.closed = mix["loop"] == "closed"
        self.seed = _u64(seed)
        b = BLOCK
        arr = np.random.default_rng([0, 1])
        self._p = arr.permutation(lognormal_lengths(mix["prompt"], b))
        self._o = arr.permutation(lognormal_lengths(mix["output"], b))
        self._ages = arr.permutation(stratified(int(mix.get("clients", 1))))
        self._gaps = np.zeros(b)
        if not self.closed:
            self._gaps = arr.permutation(
                -np.log1p(-stratified(b)) / float(mix["rate_per_s"]))
        self.offset = int(np.random.default_rng([self.seed, 1])
                          .integers(b))

    def lengths(self, i: int,
                offset: Optional[int] = None) -> tuple[int, int]:
        """(prompt, output) lengths of request ``i``, the block started at
        ``offset`` (the seed's start by default)."""
        k = (i + (self.offset if offset is None else offset)) % BLOCK
        return int(self._p[k]), int(self._o[k])

    def due(self, i: int) -> float:
        """Open loops: request ``i``'s due time, seconds from the start
        (the gap before it included)."""
        whole, part = divmod(i + self.offset + 1, BLOCK)
        return float(whole * self._gaps.sum() + self._gaps[:part].sum()
                     - self._gaps[:self.offset].sum())

    def item(self, i: int, client: int = -1,
             offset: Optional[int] = None) -> Item:
        p, o = self.lengths(i, offset)
        p = min(p, self.max_seq - 2)
        return Item(i, p, max(2, min(o, self.max_seq - 1 - p)), client,
                    self.due(i) if not self.closed else 0.0)

    def first_wave(self) -> list[Item]:
        """The closed loop's first request of each client, aged; its
        lengths do not depend on the seed."""
        out = []
        for c in range(int(self.mix["clients"])):
            it = self.item(c, c, offset=0)
            done = max(0, min(int(self._ages[c] * it.max_new),
                              it.max_new - 2,
                              self.max_seq - 2 - it.prompt_len))
            out.append(dataclasses.replace(
                it, prompt_len=it.prompt_len + done,
                max_new=it.max_new - done))
        return out

    def prompt(self, it: Item) -> np.ndarray:
        """Token ids of request ``it``: uniform over the vocabulary."""
        rng = np.random.default_rng([self.seed, 4, it.index])
        return rng.integers(0, self.vocab, it.prompt_len, dtype=np.int64)

    def warm_lengths(self) -> list[int]:
        """Prompt lengths that touch every prefill shape the mix uses: the
        powers of two in its range and both ends (aged prompts
        included)."""
        lo = int(self.mix["prompt"]["min"])
        hi = min(int(self.mix["prompt"]["max"]), self.max_seq - 2)
        if self.closed:
            hi = max(hi, *(it.prompt_len for it in self.first_wave()))
        pw = [2 ** k for k in range(int(math.log2(lo)),
                                    int(math.log2(hi)) + 1)]
        return sorted({lo, hi, *[x for x in pw if lo <= x <= hi]})
