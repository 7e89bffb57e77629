"""Tiered candidate-evaluation engine (the counterpart of
``repro/search/evaluator.py``).

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

``evaluate_many(..., isolation="process", pool=...)`` runs the profile and
the validation in sandboxed spawn-mode workers (``workers.EvalWorkerPool``):
a candidate that hangs, faults or corrupts what it reports costs a worker,
never the search. A genome that faults repeatedly is quarantined: recorded
in the cache as ``finish_reason="crashed"`` (``passed=False``) with the
H100 cost model's analytic profile, computed in this process without
launching anything, and never run again. The batch's frozen thresholds go
to the workers, so a well-behaved genome's result is bit-identical to the
thread path's. Infra faults never raise; the verdict carries them.

``TieredEvaluator(screen=False, smoke=False, share_oracle=False)`` is the
sequential reference: the same verdicts, metered by the same counters.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

from repro_torch.core.agents import ProfilingAgent, on_card
from repro_torch.search.types import EvalResult, suite_digest

_UNSET = object()                   # "no frozen snapshot": live bookkeeping
# the counters a worker's evaluation moves, added to the parent's on return
_STAGE_COUNTERS = ("oracle_computations", "validation_test_runs",
                   "validations_full", "validations_smoke_failed",
                   "screened_infeasible", "screened_dominated",
                   "profile_runs")


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
    # process isolation's infra counters (0 on the thread path)
    worker_crashes: int = 0         # a worker died mid-task, or raised
    eval_timeouts: int = 0          # a task's deadline expired (worker shot)
    corrupt_results: int = 0        # result checksum mismatches
    retries: int = 0                # re-dispatches after infra faults
    recoveries: int = 0             # tasks that succeeded after a fault
    quarantined: int = 0            # genomes written off as crashed
    workers_recycled: int = 0       # planned worker restarts (task budget)

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
            self._note_delivery((space.name, sd), result, key=k, cache=cache)
        return result

    def evaluate_many(self, space, variants, tests, *, testing, profiling,
                      cache, validate: bool = True,
                      tests_digest: str | None = None,
                      workers: int = 1, isolation: str = "thread",
                      pool=None) -> list[EvalResult]:
        """Evaluate a batch of genomes, concurrently when ``workers > 1``
        (on the thread path, when the suite is on the CPU); results align
        with ``variants`` and do not depend on completion order.

        ``isolation="process"`` sends each genome to ``pool`` (an
        ``EvalWorkerPool``, which keeps one task at a time on the card);
        infra faults never raise, they end as ``finish_reason="crashed"``.
        """
        if isolation not in ("thread", "process"):
            raise ValueError(f"unknown isolation mode {isolation!r}")
        if isolation == "process" and pool is None:
            raise ValueError("isolation='process' requires an EvalWorkerPool")
        if not variants:
            return []
        sd = tests_digest if tests_digest is not None else suite_digest(tests)
        skey = (space.name, sd)
        with self._lock:
            frozen = (self._best_lat.get(skey),
                      dict(self._fail_counts.get(skey, ())))

        if isolation == "process":
            def one(variant):
                return self._evaluate_process(
                    space, variant, tests, testing=testing,
                    profiling=profiling, cache=cache, validate=validate,
                    sd=sd, frozen=frozen, pool=pool)
        else:
            def one(variant):
                return self.evaluate(space, variant, tests, testing=testing,
                                     profiling=profiling, cache=cache,
                                     validate=validate, tests_digest=sd,
                                     _frozen=frozen)

        keys = [cache.key(space.name, v, tests, tests_digest=sd,
                          launch_key=space.launch_key) for v in variants]
        if workers > 1 and len(variants) > 1 and (
                isolation == "process" or not on_card(tests)):
            # the first genome of each key computes it, as in a serial
            # run: genomes that launch the same code but differ in name
            # would otherwise race to profile the entry
            lead = {}
            for i, k in enumerate(keys):
                lead.setdefault(k, i)
            firsts = sorted(lead.values())
            with ThreadPoolExecutor(
                    max_workers=min(workers, len(firsts))) as tpool:
                computed = dict(zip(firsts, tpool.map(
                    one, [variants[i] for i in firsts])))
            results = [computed[i] if i in computed else one(v)
                       for i, v in enumerate(variants)]
        else:
            results = [one(v) for v in variants]
        for k, result in zip(keys, results):    # deterministic order
            self._note_delivery(skey, result, key=k, cache=cache)
        return results

    # -- process isolation ---------------------------------------------------

    def _evaluate_process(self, space, variant, tests, *, testing, profiling,
                          cache, validate, sd, frozen, pool) -> EvalResult:
        """One genome through the worker pool, with ``evaluate``'s cache
        semantics. Repeated faults become a quarantine verdict."""
        k = cache.key(space.name, variant, tests, tests_digest=sd,
                      launch_key=space.launch_key)
        with cache.key_lock(k):
            result = cache.try_hit(k, validate=validate)
            if result is None:
                cache.count_miss()
                prior = cache.get(k)
                task = {
                    "kernel": space.name,
                    "suite_shapes": space.suite_shapes,
                    "variant": variant,
                    "testing": testing,
                    "profiling": profiling,
                    "validate": validate,
                    "tests_digest": sd,
                    # an unvalidated entry's profile, which an upgrade
                    # keeps (as ``evaluate`` does) rather than re-measures
                    "prior": prior,
                    "frozen": None if frozen is _UNSET else frozen,
                    "config": {"screen": self.screen, "smoke": self.smoke,
                               "share_oracle": self.share_oracle,
                               "dominate_factor": self.dominate_factor},
                }
                outcome = pool.submit(task, digest=k[1])
                if outcome.ok:
                    result, deltas = outcome.result, outcome.stats
                    with self._lock:
                        for name in _STAGE_COUNTERS:
                            setattr(self.stats, name,
                                    getattr(self.stats, name)
                                    + int(deltas.get(name, 0)))
                    if prior is None and not result.screened:
                        cache.note_profile_run(k)
                    if result.validated:
                        cache.note_validate_run(k)
                    cache.put(k, result)
                else:
                    # quarantined: the genome repeatedly killed its worker.
                    # Its row takes the cost model's analytic profile,
                    # whatever the profiling backend: timing it here would
                    # launch it in this process
                    profile = prior.profile if prior is not None \
                        else ProfilingAgent(
                            reps=getattr(profiling, "reps", 100),
                            backend="analytic").profile(space, variant,
                                                        tests)
                    result = EvalResult(False, 0.0, profile, validated=False,
                                        finish_reason="crashed",
                                        error=outcome.error)
                    with self._lock:
                        self.stats.quarantined += 1
                    cache.put(k, result)     # persists: never run again
        if frozen is _UNSET:
            self._note_delivery((space.name, sd), result, key=k, cache=cache)
        return result

    # -- the cascade ---------------------------------------------------------

    def _cascade(self, space, variant, tests, profile, testing, sd, key,
                 cache, *, frozen) -> EvalResult:
        skey = (space.name, sd)
        if self.screen:
            if profile.signals.get("infeasible"):
                with self._lock:
                    self.stats.screened_infeasible += 1
                return EvalResult(False, 0.0, profile, validated=False,
                                  screened=True, finish_reason="screened")
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
                                  screened=True, finish_reason="screened")

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

    def _note_delivery(self, skey, result: EvalResult, *, key=None,
                       cache=None) -> None:
        """Per-delivery bookkeeping in deterministic order: the smoke
        test's failure count (computed or journal-replayed results, not
        cache hits) and the best-latency watermark. A replayed entry
        counts once: its mark is cleared at its first delivery."""
        if result.failed_test >= 0 and (not result.cached or result.replayed):
            with self._lock:
                self._fail_counts.setdefault(
                    skey, Counter())[result.failed_test] += 1
        if result.replayed and cache is not None and key is not None:
            cache.clear_replayed(key)
        if result.validated and result.passed:
            lat = result.profile.geomean_latency_us
            with self._lock:
                cur = self._best_lat.get(skey)
                if cur is None or lat < cur:
                    self._best_lat[skey] = lat

    def bump(self, name: str, n: int = 1) -> None:
        """Add ``n`` to one counter: how an ``EvalWorkerPool`` reports its
        infra events to the evaluator that owns it."""
        with self._lock:
            setattr(self.stats, name, getattr(self.stats, name) + n)

    def stats_dict(self) -> dict:
        """A snapshot of the counters."""
        with self._lock:
            return self.stats.as_dict()
