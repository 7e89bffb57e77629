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
models the H100. Candidates are evaluated in this process
(``isolation="thread"``); sandboxed worker processes and the resumable
search journal of the JAX package are not ported yet (ROADMAP queue A).
"""

from __future__ import annotations

import time

from repro_torch.core.agents import (CodingAgent, PlanningAgent,
                                     ProfilingAgent, TestingAgent)
from repro_torch.core.oplog import Log
from repro_torch.kernels.registry import KernelSpace, get_space, suite_tests
from repro_torch.search.cache import EvalCache
from repro_torch.search.evaluator import TieredEvaluator
from repro_torch.search.strategies import SearchContext, resolve_strategy

PAPER_KERNELS = ("merge_attn_states_lse", "fused_add_rmsnorm",
                 "silu_and_mul")
_NOT_PORTED = ("process isolation and the search journal are not ported "
               "yet (ROADMAP queue A item 1: search/workers.py, "
               "search/journal.py)")


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
                 device=None):
        if isolation == "process":
            raise NotImplementedError(_NOT_PORTED)
        if isolation != "thread":
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

    def search(self, kernel: str | KernelSpace, *, strategy="greedy",
               rounds: int = 5, verbose: bool = False,
               journal=None) -> Log:
        """One search of ``kernel``; returns its Log."""
        if journal is not None:
            raise NotImplementedError(_NOT_PORTED)
        space = get_space(kernel) if isinstance(kernel, str) else kernel
        strat = resolve_strategy(strategy)
        tests = suite_tests(space, self.testing)
        ctx = SearchContext(space=space, testing=self.testing,
                            profiling=self.profiling, planning=self.planning,
                            coding=self.coding, tests=tests,
                            cache=self.cache, rounds=rounds, verbose=verbose,
                            evaluator=self.evaluator, workers=self.workers)
        before = self.cache.stats()
        ebefore = self.evaluator.stats_dict()
        t0 = time.perf_counter()
        log = strat.run(ctx)
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
        )
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
             journal=None,
             device=None,
             verbose: bool = False) -> Log:
    """Run one search on one kernel; with the default
    ``strategy="greedy"`` it is the paper's Algorithm 1."""
    orch = SearchOrchestrator(testing=testing, profiling=profiling,
                              planning=planning, coding=coding, cache=cache,
                              evaluator=evaluator, workers=workers,
                              isolation=isolation, device=device)
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
                 device=None) -> dict[str, Log]:
    """Optimize the paper's kernels; returns {kernel: Log}. One
    orchestrator (one cache, one evaluator) serves every search."""
    orch = SearchOrchestrator(testing=testing, profiling=profiling,
                              cache=cache, workers=workers,
                              isolation=isolation, device=device)
    return {k: orch.search(k, strategy=strategy, rounds=rounds,
                           verbose=verbose) for k in kernels}


def reintegrate(results: dict[str, Log]) -> None:
    """Post-processing (paper §3.2): install each kernel's best correct
    genome process-wide, so ``ops`` launches it from now on."""
    from repro_torch.kernels import ops
    ops.set_variants(**{name: log.best().code
                        for name, log in results.items()})
