"""Tiered candidate-evaluation engine (the counterpart of
``repro/search/evaluator.py``, thread path).

Validation is what a search spends most of its time on, so each genome
goes through three tiers and pays for the expensive one only if it
survives the cheap ones:

  tier 0  screen       The profile rejects genomes that can never win: a
                       launch shape the card cannot run (the cost model
                       raises before anything launches) and genomes whose
                       latency is ``dominate_factor`` x the best validated
                       one. Screened genomes are recorded as ``screened``,
                       never as validated.
  tier 1  smoke test   One case first: the one that failed most often
                       so far, the cheapest on ties.
  tier 2  full suite   The remaining cases, in suite order.

The oracle depends only on the suite, never on the genome, so it is
computed once per (kernel, suite) through the registry memo.

``evaluate_many`` evaluates a batch on a thread pool. Results do not depend
on completion order: screening thresholds and smoke order are frozen at
batch start, per-key locks in the ``EvalCache`` evaluate each unique
genome once, and the best-latency bookkeeping is replayed in input order.
A suite on the card is evaluated one genome at a time: every launch goes
to one stream, so another thread's validation or oracle would land
between a timing's events.

``TieredEvaluator(screen=False, smoke=False, share_oracle=False)`` is the
sequential reference: the same verdicts, metered by the same counters.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

from repro_torch.core.agents import on_card
from repro_torch.search.types import EvalResult, suite_digest

_UNSET = object()                   # "no frozen snapshot": live bookkeeping


@dataclasses.dataclass
class EvalStats:
    """Work counters of one evaluator."""
    oracle_computations: int = 0    # oracle(*args) evaluations (per test)
    validation_test_runs: int = 0   # (genome, test) validation runs
    validations_full: int = 0       # genomes that went past the smoke test
    validations_smoke_failed: int = 0   # genomes rejected by smoke alone
    screened_infeasible: int = 0    # genomes that cannot launch
    screened_dominated: int = 0     # genomes rejected as clearly dominated
    profile_runs: int = 0           # profiles computed

    def as_dict(self) -> dict:
        """The counters as a dict."""
        return dataclasses.asdict(self)


class TieredEvaluator:
    """Screen -> smoke -> full-suite evaluation over a shared thread-safe
    ``EvalCache``. One instance may serve many searches and threads; its
    counters aggregate over all of them."""

    def __init__(self, *, screen: bool = True, smoke: bool = True,
                 share_oracle: bool = True, dominate_factor: float = 3.0):
        if dominate_factor <= 1.0:
            raise ValueError("dominate_factor must be > 1")
        self.screen = screen
        self.smoke = smoke
        self.share_oracle = share_oracle
        self.dominate_factor = dominate_factor
        self.stats = EvalStats()
        self._lock = threading.Lock()
        # per (kernel, suite digest): best validated latency and failure
        # counts per test index (the smoke test's discriminative power)
        self._best_lat: dict[tuple, float] = {}
        self._fail_counts: dict[tuple, Counter] = {}

    def evaluate(self, space, variant, tests, *, testing, profiling, cache,
                 validate: bool = True, tests_digest: str | None = None,
                 _frozen=_UNSET) -> EvalResult:
        """Tiered, cached evaluation of one genome (thread-safe)."""
        sd = tests_digest if tests_digest is not None else suite_digest(tests)
        k = cache.key(space.name, variant, tests, tests_digest=sd,
                      launch_key=space.launch_key)
        with cache.key_lock(k):
            result = cache.try_hit(k, validate=validate)
            if result is None:
                cache.count_miss()
                entry = cache.get(k)
                if entry is not None:       # upgrade: reuse stored profile
                    profile = entry.profile
                else:
                    profile = profiling.profile(space, variant, tests)
                    cache.note_profile_run(k)
                    with self._lock:
                        self.stats.profile_runs += 1
                if validate:
                    result = self._cascade(space, variant, tests, profile,
                                           testing, sd, k, cache,
                                           frozen=_frozen)
                else:
                    result = EvalResult(True, 0.0, profile, validated=False)
                cache.put(k, result)
        if _frozen is _UNSET:
            self._note_delivery((space.name, sd), result)
        return result

    def evaluate_many(self, space, variants, tests, *, testing, profiling,
                      cache, validate: bool = True,
                      tests_digest: str | None = None,
                      workers: int = 1) -> list[EvalResult]:
        """Evaluate a batch of genomes, concurrently when ``workers > 1``
        and the suite is on the CPU; results align with ``variants`` and do
        not depend on thread completion order."""
        if not variants:
            return []
        sd = tests_digest if tests_digest is not None else suite_digest(tests)
        skey = (space.name, sd)
        with self._lock:
            frozen = (self._best_lat.get(skey),
                      dict(self._fail_counts.get(skey, ())))

        def one(variant):
            return self.evaluate(space, variant, tests, testing=testing,
                                 profiling=profiling, cache=cache,
                                 validate=validate, tests_digest=sd,
                                 _frozen=frozen)

        if workers > 1 and len(variants) > 1 and not on_card(tests):
            with ThreadPoolExecutor(
                    max_workers=min(workers, len(variants))) as pool:
                results = list(pool.map(one, variants))
        else:
            results = [one(v) for v in variants]
        for result in results:                  # deterministic order
            self._note_delivery(skey, result)
        return results

    # -- the cascade ---------------------------------------------------------

    def _cascade(self, space, variant, tests, profile, testing, sd, key,
                 cache, *, frozen) -> EvalResult:
        skey = (space.name, sd)
        if self.screen:
            if profile.signals.get("infeasible"):
                with self._lock:
                    self.stats.screened_infeasible += 1
                return EvalResult(False, 0.0, profile, validated=False,
                                  screened=True)
            if frozen is _UNSET:
                with self._lock:
                    best = self._best_lat.get(skey)
            else:
                best = frozen[0]
            if best is not None and \
                    profile.geomean_latency_us > self.dominate_factor * best:
                with self._lock:
                    self.stats.screened_dominated += 1
                return EvalResult(False, 0.0, profile, validated=False,
                                  screened=True)

        oracle = self._oracle(space, tests, sd)
        order = self._order(skey, profile, len(tests), frozen)
        cache.note_validate_run(key)
        worst, passed, ran, failed_test = 0.0, True, 0, -1
        for i in order:
            ok, err = testing.validate(space, variant, [tests[i]],
                                       oracle=[oracle[i]])
            worst = max(worst, err)
            ran += 1
            with self._lock:
                self.stats.validation_test_runs += 1
            if not ok:
                passed, failed_test = False, i
                break
        with self._lock:
            if not passed and ran == 1 and self.smoke and len(tests) > 1:
                self.stats.validations_smoke_failed += 1
            else:
                self.stats.validations_full += 1
        return EvalResult(passed, worst, profile, failed_test=failed_test)

    def _oracle(self, space, tests, sd):
        """Oracle outputs aligned with ``tests``: memoized per (kernel,
        suite) when sharing is on, recomputed per genome when off."""
        if self.share_oracle:
            from repro_torch.kernels.registry import oracle_outputs
            outs, computed = oracle_outputs(space, tests, digest=sd)
            if computed:
                with self._lock:
                    self.stats.oracle_computations += len(tests)
            return outs
        outs = tuple(space.oracle(*t.args) for t in tests)
        with self._lock:
            self.stats.oracle_computations += len(tests)
        return outs

    def _order(self, skey, profile, n, frozen) -> list[int]:
        """Validation order: the smoke test first (most failures so far,
        then cheapest by the candidate's own per-test latency), the rest in
        suite order."""
        if not self.smoke or n <= 1:
            return list(range(n))
        if frozen is _UNSET:
            with self._lock:
                fails = dict(self._fail_counts.get(skey, ()))
        else:
            fails = frozen[1]
        rows = profile.per_shape
        lat = [rows[i].get("latency_us", float("inf")) if i < len(rows)
               else float("inf") for i in range(n)]
        smoke = min(range(n), key=lambda i: (-fails.get(i, 0), lat[i], i))
        return [smoke] + [i for i in range(n) if i != smoke]

    def _note_delivery(self, skey, result: EvalResult) -> None:
        """Per-delivery bookkeeping in deterministic order: the smoke
        test's failure count (computed results only, not cache hits) and
        the best-latency watermark."""
        if result.failed_test >= 0 and not result.cached:
            with self._lock:
                self._fail_counts.setdefault(
                    skey, Counter())[result.failed_test] += 1
        if result.validated and result.passed:
            lat = result.profile.geomean_latency_us
            with self._lock:
                cur = self._best_lat.get(skey)
                if cur is None or lat < cur:
                    self._best_lat[skey] = lat

    def stats_dict(self) -> dict:
        """A snapshot of the counters."""
        with self._lock:
            return self.stats.as_dict()
