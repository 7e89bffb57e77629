"""The search orchestrator (the counterpart of
``repro/search/orchestrator.py``): wires the four agents, a strategy and
the tiered evaluator into one ``optimize()`` entry point.

``strategy`` selects ``"greedy"`` (the default: Algorithm 1), ``"beam"``,
``"population"`` or any ``SearchStrategy`` instance; ``workers`` bounds
how many candidates the evaluator runs at once on the CPU (on the card it
runs one at a time). Cache hits, wall-clock and the evaluator's stage
counters go into ``Log.meta``.

The suite lives on ``device``: the card unless ``device="cpu"`` is asked
for, where the plain per-genome versions run and the profiling agent
models the H100.

Robustness (README, "Robust search"):

  * ``isolation="process"`` evaluates candidates in sandboxed spawn-mode
    workers (``workers.EvalWorkerPool``, made at the first search with
    ``pool_config`` and closed by ``close()``): a hung or faulting
    candidate costs a worker, never the search, and a repeat offender is
    quarantined. On the card the pool keeps one task on the device at a
    time.
  * ``search(..., journal=SearchJournal(path))`` makes a search
    resumable: journaled outcomes are seeded into the cache as replayed
    entries and the (deterministic) strategy runs through them.
  * ``optimize_all(keep_going=True)`` turns one kernel's infra failure
    into a ``SearchFailure`` record instead of stopping the rest.
"""

from __future__ import annotations

import time
import traceback

from repro_torch.core.agents import (CodingAgent, PlanningAgent,
                                     ProfilingAgent, TestingAgent)
from repro_torch.core.oplog import Log
from repro_torch.kernels.registry import KernelSpace, get_space, suite_tests
from repro_torch.search.cache import EvalCache, decode_result
from repro_torch.search.evaluator import TieredEvaluator
from repro_torch.search.strategies import SearchContext, resolve_strategy

PAPER_KERNELS = ("merge_attn_states_lse", "fused_add_rmsnorm",
                 "silu_and_mul")


class SearchFailure(RuntimeError):
    """One kernel's search died of an infrastructure error. Carries the
    kernel name, so a keep-going caller can mark it failed and go on."""

    def __init__(self, kernel: str, cause: BaseException):
        super().__init__(f"search for {kernel!r} failed: {cause!r}")
        self.kernel = kernel
        self.cause = cause
        self.detail = "".join(traceback.format_exception_only(
            type(cause), cause)).strip()


class SearchOrchestrator:
    """Owns the agent roster, the (shareable) evaluation cache and the
    tiered evaluator; runs any strategy over any registered space."""

    def __init__(self, *, testing: TestingAgent | None = None,
                 profiling: ProfilingAgent | None = None,
                 planning: PlanningAgent | None = None,
                 coding: CodingAgent | None = None,
                 cache: EvalCache | None = None,
                 evaluator: TieredEvaluator | None = None,
                 workers: int = 4,
                 isolation: str = "thread",
                 pool=None,
                 pool_config: dict | None = None,
                 device=None):
        if isolation not in ("thread", "process"):
            raise ValueError(f"unknown isolation mode {isolation!r}")
        self.testing = testing if testing is not None \
            else TestingAgent(device=device)
        self.profiling = profiling if profiling is not None \
            else ProfilingAgent(reps=100)
        self.planning = planning if planning is not None else PlanningAgent()
        self.coding = coding if coding is not None else CodingAgent()
        # not `cache or ...`: an empty EvalCache is falsy
        self.cache = cache if cache is not None else EvalCache()
        self.evaluator = evaluator if evaluator is not None \
            else TieredEvaluator()
        self.workers = max(1, workers)
        self.isolation = isolation
        self._pool = pool               # the caller's to close when passed
        self._owns_pool = pool is None
        self._pool_config = dict(pool_config or {})

    def _ensure_pool(self):
        """The worker pool, made at the first process-isolated search on
        the testing agent's device (a child takes seconds to start)."""
        if self._pool is None:
            from repro_torch.search.workers import EvalWorkerPool
            cfg = dict(self._pool_config)
            cfg.setdefault("workers", self.workers)
            cfg.setdefault("device", self.testing.device)
            self._pool = EvalWorkerPool(on_stat=self.evaluator.bump, **cfg)
        return self._pool

    def close(self) -> None:
        """Release the worker pool (nothing to do for thread isolation or
        a caller's pool)."""
        if self._owns_pool and self._pool is not None:
            self._pool.close()
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def search(self, kernel: str | KernelSpace, *, strategy="greedy",
               rounds: int = 5, verbose: bool = False,
               journal=None) -> Log:
        """One search of ``kernel``; returns its Log. With ``journal`` (a
        ``SearchJournal``) the search is journaled, and resumed from what
        the journal already holds."""
        space = get_space(kernel) if isinstance(kernel, str) else kernel
        strat = resolve_strategy(strategy)
        tests = suite_tests(space, self.testing)
        pool = self._ensure_pool() if self.isolation == "process" else None
        ctx = SearchContext(space=space, testing=self.testing,
                            profiling=self.profiling, planning=self.planning,
                            coding=self.coding, tests=tests,
                            cache=self.cache, rounds=rounds, verbose=verbose,
                            evaluator=self.evaluator, workers=self.workers,
                            isolation=self.isolation, pool=pool,
                            journal=journal)
        resumed, replayed = False, 0
        if journal is not None:
            from repro_torch.search.cache import code_version_salt
            config = {k: v for k, v in vars(strat).items()
                      if isinstance(v, (bool, int, float, str))}
            resumed = journal.open(
                kernel=space.name, strategy=strat.name,
                strategy_config=config, rounds=rounds,
                tests_digest=ctx.tests_digest, salt=code_version_salt())
            # journaled outcomes become replayed cache entries; entries the
            # cache already holds (a persistent cache's) take precedence, so
            # this run and an uninterrupted one see the same state
            for key, rec in journal.replay.items():
                if self.cache.get(key) is None:
                    self.cache.put(key, decode_result(rec, replayed=True),
                                   persist=False)
                    replayed += 1
        before = self.cache.stats()
        ebefore = self.evaluator.stats_dict()
        t0 = time.perf_counter()
        try:
            log = strat.run(ctx)
            if journal is not None:
                journal.finish(log)
        finally:
            if journal is not None:
                journal.close()
        wall = time.perf_counter() - t0
        after = self.cache.stats()
        eafter = self.evaluator.stats_dict()
        log.meta.update(
            kernel=space.name,
            strategy=strat.name,
            rounds=rounds,
            wall_s=wall,
            device=str(self.testing.device),
            cache={
                "hits": after["hits"] - before["hits"],
                "misses": after["misses"] - before["misses"],
                "entries": after["entries"],
                "preloaded": after["preloaded"],
                "max_evals_per_genome": after["max_evals_per_genome"],
            },
            stages={k: eafter[k] - ebefore[k] for k in eafter},
            isolation=self.isolation,
        )
        if journal is not None:
            log.meta.update(journal={"path": journal.path,
                                     "resumed": resumed,
                                     "replayed": replayed})
        if verbose:
            c, s = log.meta["cache"], log.meta["stages"]
            print(f"[{space.name}] {strat.name}: {len(log.entries)} log "
                  f"entries in {wall:.2f}s, cache hits={c['hits']} "
                  f"misses={c['misses']}, screened="
                  f"{s['screened_infeasible'] + s['screened_dominated']} "
                  f"smoke_fails={s['validations_smoke_failed']} "
                  f"oracle_computations={s['oracle_computations']}")
        return log


def optimize(kernel: str | KernelSpace, *, rounds: int = 5,
             strategy="greedy",
             testing: TestingAgent | None = None,
             profiling: ProfilingAgent | None = None,
             planning: PlanningAgent | None = None,
             coding: CodingAgent | None = None,
             cache: EvalCache | None = None,
             evaluator: TieredEvaluator | None = None,
             workers: int = 4,
             isolation: str = "thread",
             pool_config: dict | None = None,
             journal=None,
             device=None,
             verbose: bool = False) -> Log:
    """Run one search on one kernel; with the default
    ``strategy="greedy"`` it is the paper's Algorithm 1."""
    orch = SearchOrchestrator(testing=testing, profiling=profiling,
                              planning=planning, coding=coding, cache=cache,
                              evaluator=evaluator, workers=workers,
                              isolation=isolation, pool_config=pool_config,
                              device=device)
    with orch:
        return orch.search(kernel, strategy=strategy, rounds=rounds,
                           verbose=verbose, journal=journal)


def optimize_all(*, rounds: int = 5, strategy="greedy",
                 verbose: bool = False,
                 kernels: tuple[str, ...] = PAPER_KERNELS,
                 testing: TestingAgent | None = None,
                 profiling: ProfilingAgent | None = None,
                 cache: EvalCache | None = None,
                 workers: int = 4,
                 isolation: str = "thread",
                 pool_config: dict | None = None,
                 journals: dict | None = None,
                 keep_going: bool = False,
                 device=None) -> dict[str, Log]:
    """Optimize the paper's kernels; returns {kernel: Log}. One
    orchestrator (one cache, one evaluator, one worker pool) serves every
    search.

    ``keep_going=True``: a kernel whose search dies of an infrastructure
    error maps to a ``SearchFailure`` instead of a Log, and the remaining
    kernels still run. ``journals`` maps kernel name -> ``SearchJournal``.
    """
    results: dict[str, Log] = {}
    with SearchOrchestrator(testing=testing, profiling=profiling,
                            cache=cache, workers=workers,
                            isolation=isolation, pool_config=pool_config,
                            device=device) as orch:
        for k in kernels:
            try:
                results[k] = orch.search(k, strategy=strategy, rounds=rounds,
                                         verbose=verbose,
                                         journal=(journals or {}).get(k))
            except Exception as exc:    # noqa: BLE001 — keep-going boundary
                if not keep_going:
                    raise
                results[k] = SearchFailure(k, exc)
    return results


def reintegrate(results: dict[str, Log]) -> None:
    """Post-processing (paper §3.2): install each kernel's best correct
    genome process-wide, so ``ops`` launches it from now on."""
    from repro_torch.kernels import ops
    ops.set_variants(**{name: log.best().code
                        for name, log in results.items()})
