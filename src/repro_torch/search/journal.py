"""Write-ahead search journal (the counterpart of
``repro/search/journal.py``): kill -9 a search, resume it.

A long agentic search is a process to assume will be killed (OOM,
preemption, a candidate that takes the parent down). The journal makes
its progress durable as an append-only JSONL file, one flushed
``write()`` per record:

  header   {"type": "header", version, kernel, strategy, strategy_config,
            rounds, tests_digest, salt}
           Names the exact search. A file whose header differs journals a
           different search (changed config or code): it is discarded
           with a warning, never replayed.
  round    {"type": "round", "round": r, "candidates": [digests]}
           The write-ahead part: a round's candidates are journaled before
           any of them is evaluated.
  eval     {"type": "eval", "key": [kernel, genome, suite], ...verdict}
           One evaluation outcome (``cache.encode_result``'s fields):
           what a replay needs to skip the work.
  finish   {"type": "finish", "entries": n}
           The search ran to its end; a resume is pure replay.

Resume keeps no strategy state. Strategies are deterministic given their
evaluations, so a resumed search runs the strategy from round 0 with the
journaled outcomes seeded into the cache as ``replayed`` entries: the
journaled prefix costs dict hits, live evaluation takes over at the first
genome the journal lacks, and the ``replayed`` flag applies each entry's
smoke-failure count once at delivery, so the evaluator's state rebuilds
too. Only fresh (non-cached) deliveries are journaled, so a resumed run
appends only what the journal lacked. Replayed outcomes are exact, CUDA-
event profiles included; on the card the evaluations after the kill are
timed anew, so only on the analytic profile is the whole Log
bit-identical to an uninterrupted run.

A ``kill -9`` mid-append leaves a torn last line: ``open()`` keeps the
valid prefix and truncates the tail before appending. Round records are
also a self-check: a resumed strategy proposing other candidates for a
journaled round means nondeterminism upstream (or an edited file) and
raises ``JournalMismatch``.
"""

from __future__ import annotations

import json
import os
import warnings

from repro_torch.search.cache import _jsonable, encode_result

_VERSION = 1


def _verdict(rec: dict) -> bool:
    """Whether an outcome record settles its genome (validated, screened
    or crashed), rather than leaving it to be validated."""
    return bool(rec["validated"] or rec["screened"]
                or rec["finish_reason"] == "crashed")


class JournalMismatch(RuntimeError):
    """A resumed search diverged from its journal (round candidates
    changed) — the journal no longer describes this search."""


class SearchJournal:
    """Append-only JSONL journal for one (kernel, strategy) search.

    Lifecycle: construct with a path, ``open(...)`` with the search's
    identity (returns True when prior progress was loaded), seed the
    cache from ``replay``, run the strategy with ``record_*`` wired in,
    ``finish()`` + ``close()``.
    """

    def __init__(self, path: str):
        self.path = path
        self.replay: dict[tuple, dict] = {}     # key -> verdict record
        self.rounds: dict[int, list[str]] = {}  # round -> candidate digests
        self.finished = False
        self._header: dict | None = None
        self._f = None

    # -- open / load ---------------------------------------------------------

    def open(self, *, kernel: str, strategy: str, strategy_config: dict,
             rounds: int, tests_digest: str, salt: str) -> bool:
        """Load any prior progress for exactly this search, then switch to
        append mode. Returns True when journaled evaluations were loaded
        (the caller should seed its cache from ``replay``)."""
        header = {"type": "header", "version": _VERSION, "kernel": kernel,
                  "strategy": strategy, "strategy_config": strategy_config,
                  "rounds": rounds, "tests_digest": tests_digest,
                  "salt": salt}
        keep = self._load(header)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        if not keep:
            self.replay, self.rounds, self.finished = {}, {}, False
            self._f = open(self.path, "w")
            self._write(header)
        self._header = header
        if self._f is None:
            self._f = open(self.path, "a")
        return bool(self.replay)

    def _load(self, header: dict) -> bool:
        """Parse the existing file. Returns False when there is nothing
        (or nothing *compatible*) to resume — the caller rewrites."""
        if not os.path.exists(self.path):
            return False
        with open(self.path, "rb") as f:
            raw = f.read()
        offset = 0
        records = []
        lines = raw.split(b"\n")
        for i, bline in enumerate(lines):
            if i == len(lines) - 1 and bline == b"":
                break
            try:
                records.append(json.loads(bline.decode("utf-8")))
            except (UnicodeDecodeError, ValueError):
                warnings.warn(
                    f"search journal {self.path}: discarding torn/corrupt "
                    f"tail at byte {offset} ({len(raw) - offset} bytes)")
                break
            offset += len(bline) + 1
        if offset < len(raw):
            with open(self.path, "r+b") as f:
                f.truncate(offset)
        if not records or records[0].get("type") != "header":
            return False
        if records[0] != header:
            warnings.warn(
                f"search journal {self.path}: header mismatch (different "
                "search config or code version) — starting fresh")
            return False
        for rec in records[1:]:
            t = rec.get("type")
            if t == "eval":
                self.replay[tuple(rec["key"])] = rec
            elif t == "round":
                self.rounds[int(rec["round"])] = list(rec["candidates"])
            elif t == "finish":
                self.finished = True
        return True

    # -- append --------------------------------------------------------------

    def _write(self, rec: dict) -> None:
        self._f.write(json.dumps(rec, default=_jsonable) + "\n")
        self._f.flush()

    def record_round(self, round_: int, candidates: list[str]) -> None:
        """Journal a round's candidate set before evaluating it. On a
        resumed search this doubles as the determinism self-check."""
        prior = self.rounds.get(round_)
        if prior is not None:
            if prior != list(candidates):
                raise JournalMismatch(
                    f"round {round_} replayed different candidates than "
                    f"journaled ({self.path}): the search is not "
                    "deterministic or the journal is stale")
            return
        self.rounds[round_] = list(candidates)
        self._write({"type": "round", "round": round_,
                     "candidates": list(candidates)})

    def record_eval(self, key: tuple, result) -> None:
        """Journal one evaluation outcome: once per key, and once more when
        a verdict upgrades an unvalidated outcome (genomes that launch the
        same code share a key, so the baseline's key is often validated
        later; a replay must not have to run it again)."""
        prior = self.replay.get(tuple(key))
        if prior is not None and (_verdict(prior) or not _verdict(
                encode_result(result))):
            return
        rec = dict(type="eval", key=list(key), **encode_result(result))
        self.replay[tuple(key)] = rec
        self._write(rec)

    def finish(self, log) -> None:
        """Record that the search ran to its end."""
        if not self.finished:
            self.finished = True
            self._write({"type": "finish", "entries": len(log.entries)})

    def close(self) -> None:
        """Close the file (the records are already flushed)."""
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
