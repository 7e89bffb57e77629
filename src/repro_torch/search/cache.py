"""Content-addressed evaluation cache, thread-safe and optionally
persistent (the counterpart of ``repro/search/cache.py``).

Each evaluation is keyed by ``(kernel, genome digest, suite digest)``, so
a repeated genome (every revert is one) is a dict hit: validation and
profiling each run at most once per unique genome per suite, an invariant
``max_evals_per_genome`` exposes. A space that says what a genome launches
(``KernelSpace.launch_key``) is keyed by that instead of the knobs, so a
move that launches the same code (a tile size the wrapper clamps away) is
a hit, not a fresh timing of the same launch. The tiered evaluator
computes an entry under its per-key lock, so racing threads asking for
one genome get one computation.

Entries may be unvalidated (a baseline is correct by construction, so
strategies profile it without validating it); a later request that needs
a verdict upgrades the entry and keeps its profile.

With ``persist_path`` every entry is also appended to a JSON-lines file,
keyed by the same digests plus a code-version salt (a hash of the port's
kernel modules, CUDA sources, cost model and agents) and the name of the
device that measured it: latencies measured on one card do not hold for
another, and an edited kernel invalidates the file. Screened entries are
not persisted; quarantined ones (``finish_reason="crashed"``) are, so a
genome that repeatedly killed its worker never runs again, not even in a
later process. A torn trailing line (a writer killed mid-append) is
skipped with a warning and cut off at the next append.
"""

from __future__ import annotations

import dataclasses
import glob
import hashlib
import json
import os
import threading
import warnings
from collections import Counter

import torch

from repro_torch.search.types import (EvalResult, genome_digest,
                                      launch_digest, suite_digest)

_SALT_LOCK = threading.Lock()
_SALT: str | None = None
_PERSIST_FORMAT = "torch-v1"


def salt_files() -> list[str]:
    """The sources an evaluation's outcome depends on: the kernel modules,
    their CUDA sources, the cost model and the agents."""
    from repro_torch.core import costmodel
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        costmodel.__file__)))
    kernels = os.path.join(root, "kernels")
    files = sorted(glob.glob(os.path.join(kernels, "*.py")))
    files += sorted(glob.glob(os.path.join(kernels, "csrc", "*.cu")))
    files += sorted(glob.glob(os.path.join(kernels, "csrc", "*.cuh")))
    files += [os.path.join(root, "core", "costmodel.py"),
              os.path.join(root, "core", "agents.py")]
    return files


def source_digest(files) -> str:
    """Hash of the names and contents of ``files`` (12 hex chars)."""
    h = hashlib.sha256(_PERSIST_FORMAT.encode())
    for f in files:
        h.update(os.path.basename(f).encode())
        with open(f, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:12]


def code_version_salt() -> str:
    """``source_digest(salt_files())``, computed once per process."""
    global _SALT
    with _SALT_LOCK:
        if _SALT is None:
            _SALT = source_digest(salt_files())
        return _SALT


def device_name() -> str:
    """The card that measures this process's evaluations, or "cpu"."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0)
    return "cpu"


def _jsonable(obj):
    """JSON fallback for numpy scalars inside Profile rows."""
    try:
        return float(obj)
    except (TypeError, ValueError):
        return str(obj)


def encode_result(result: EvalResult) -> dict:
    """JSON-able payload of one evaluation outcome, shared by the
    persistent cache and the search journal (``cached`` and ``replayed``
    are delivery flags, not outcomes, and are not stored)."""
    return {
        "passed": bool(result.passed),
        "max_err": float(result.max_err),
        "validated": bool(result.validated),
        "screened": bool(result.screened),
        "finish_reason": result.finish_reason,
        "error": result.error,
        "failed_test": int(result.failed_test),
        "profile": dataclasses.asdict(result.profile),
    }


def decode_result(rec: dict, *, replayed: bool = False) -> EvalResult:
    """Inverse of ``encode_result``."""
    from repro_torch.core.agents import Profile
    return EvalResult(
        bool(rec["passed"]), float(rec["max_err"]),
        Profile(**rec["profile"]),
        validated=bool(rec["validated"]),
        screened=bool(rec.get("screened", False)),
        finish_reason=rec.get("finish_reason", "ok"),
        error=rec.get("error"),
        failed_test=int(rec.get("failed_test", -1)),
        replayed=replayed)


class EvalCache:
    """Memoizes (validate, profile) per unique (kernel, genome, suite)."""

    def __init__(self, *, persist_path: str | None = None) -> None:
        self._store: dict[tuple, EvalResult] = {}
        self._lock = threading.Lock()
        self._persist_lock = threading.Lock()
        self._key_locks: dict[tuple, threading.Lock] = {}
        self.hits = 0
        self.misses = 0
        self.preloaded = 0              # entries restored from persist_path
        self._validate_runs: Counter = Counter()
        self._profile_runs: Counter = Counter()
        self.persist_path = persist_path
        self.device = device_name()
        # byte offset to cut the file back to before the next append (set
        # when the loader finds a torn trailing line)
        self._truncate_at: int | None = None
        if persist_path:
            self._load_persistent()

    def key(self, kernel: str, variant, tests=None, *,
            tests_digest: str | None = None, launch_key=None) -> tuple:
        """(kernel, genome digest, suite digest); with ``launch_key`` the
        genome is digested by what it launches on each of ``tests``."""
        sd = tests_digest if tests_digest is not None else suite_digest(tests)
        gd = genome_digest(variant) if launch_key is None \
            else launch_digest(variant, tests, launch_key)
        return (kernel, gd, sd)

    # -- concurrency primitives (shared with the tiered evaluator) ----------

    def key_lock(self, key: tuple) -> threading.Lock:
        """Per-key lock: whoever holds it owns computing that entry."""
        with self._lock:
            return self._key_locks.setdefault(key, threading.Lock())

    def get(self, key: tuple) -> EvalResult | None:
        """The stored entry, or None."""
        with self._lock:
            return self._store.get(key)

    def try_hit(self, key: tuple, *,
                validate: bool = True) -> EvalResult | None:
        """The hit condition: a validated, screened or crashed entry
        always hits, an unvalidated one only when no verdict is needed.
        Counts the hit and returns the entry marked ``cached``, else
        None."""
        entry = self.get(key)
        if entry is not None and (entry.validated or entry.screened
                                  or entry.failed_infra or not validate):
            self.count_hit()
            return dataclasses.replace(entry, cached=True)
        return None

    def put(self, key: tuple, result: EvalResult, *,
            persist: bool = True) -> None:
        """Store (and, unless screened or ``persist`` is False, persist)
        one outcome."""
        with self._lock:
            self._store[key] = result
        if self.persist_path and persist and not result.screened:
            with self._persist_lock:
                self._append_persistent(key, result)

    def count_hit(self) -> None:
        with self._lock:
            self.hits += 1

    def count_miss(self) -> None:
        with self._lock:
            self.misses += 1

    def note_validate_run(self, key: tuple) -> None:
        with self._lock:
            self._validate_runs[key] += 1

    def note_profile_run(self, key: tuple) -> None:
        with self._lock:
            self._profile_runs[key] += 1

    def clear_replayed(self, key: tuple) -> None:
        """Drop a journal replay's mark after its one delivery, so a later
        hit on the entry does not count its failure again."""
        with self._lock:
            entry = self._store.get(key)
            if entry is not None and entry.replayed:
                self._store[key] = dataclasses.replace(entry, replayed=False)

    # -- persistence ---------------------------------------------------------

    def _append_persistent(self, key: tuple, result: EvalResult) -> None:
        # the caller holds _persist_lock; one write() per entry keeps lines
        # whole when several processes append to one file
        rec = dict(salt=code_version_salt(), device=self.device,
                   key=list(key), **encode_result(result))
        os.makedirs(os.path.dirname(self.persist_path) or ".", exist_ok=True)
        if self._truncate_at is not None:
            with open(self.persist_path, "r+") as f:
                f.truncate(self._truncate_at)
            self._truncate_at = None
        with open(self.persist_path, "a") as f:
            f.write(json.dumps(rec, default=_jsonable) + "\n")

    def _load_persistent(self) -> None:
        if not os.path.exists(self.persist_path):
            return
        salt = code_version_salt()
        with open(self.persist_path, "rb") as f:
            lines = f.read().split(b"\n")
        offset = 0
        for i, bline in enumerate(lines):
            is_last = i == len(lines) - 1
            if is_last and bline == b"":
                break                   # clean end of file
            try:
                rec = json.loads(bline.decode("utf-8", errors="replace"))
                result = decode_result(rec)
                key = tuple(rec["key"])
            except (KeyError, TypeError, ValueError):
                if is_last:
                    warnings.warn(
                        f"evalcache {self.persist_path}: torn trailing line "
                        f"({len(bline)} bytes) skipped; the file is cut "
                        "back at the next append")
                    self._truncate_at = offset
                    break
                warnings.warn(f"evalcache {self.persist_path}: skipping "
                              f"corrupt line {i + 1}")
                offset += len(bline) + 1
                continue
            offset += len(bline) + 1
            if rec.get("salt") != salt or rec.get("device") != self.device:
                continue                # other code, or another card
            if key not in self._store:
                self.preloaded += 1
            self._store[key] = result   # later lines win (upgrades)

    # -- introspection ------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)

    def items(self) -> list[tuple[tuple, EvalResult]]:
        """A snapshot of the (key, outcome) entries."""
        with self._lock:
            return list(self._store.items())

    def max_evals_per_genome(self) -> int:
        """Most validation or profiling runs of any one genome (the
        memoization invariant says at most 1)."""
        with self._lock:
            counts = list(self._validate_runs.values()) \
                + list(self._profile_runs.values())
        return max(counts, default=0)

    def stats(self) -> dict:
        """Entries, hits, misses, hit rate, preloaded, max evals/genome."""
        with self._lock:
            entries, hits, misses = len(self._store), self.hits, self.misses
            preloaded = self.preloaded
        total = hits + misses
        return {
            "entries": entries,
            "hits": hits,
            "misses": misses,
            "hit_rate": hits / total if total else 0.0,
            "preloaded": preloaded,
            "max_evals_per_genome": self.max_evals_per_genome(),
        }
