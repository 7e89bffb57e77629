"""Search strategies over a kernel's knob genome (the counterpart of
``repro/search/strategies.py``).

``SearchStrategy`` is the pluggable policy for *which* candidates to try;
the four agents (testing / profiling / planning / coding) and the
evaluation cache are shared infrastructure handed in via ``SearchContext``.

  * ``GreedyChain``  — the paper's Algorithm 1, verbatim: one suggestion,
    one variant, one evaluation per round. The default; preserves the
    historical ``optimize()`` behavior exactly.
  * ``BeamSearch``   — keeps the top-``width`` correct candidates as a
    frontier; the planning agent proposes several moves per frontier
    member per round and the cache guarantees no genome is evaluated
    twice. Strictly explores a superset of the greedy chain (the chain's
    move is always proposal #1 from its own lineage).
  * ``Population``   — random-restart + mutation over the knob genome:
    seeded random initial population, elitist selection on cached
    evaluations, random single-knob mutations per generation.

Every strategy returns the same ``Log`` the sequential loop produced, so
``log.best()`` / ``log.speedup()`` / reintegration work unchanged.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Any

from repro_torch.core.agents import Suggestion
from repro_torch.core.oplog import Log, LogEntry
from repro_torch.search.cache import EvalCache
from repro_torch.search.types import EvalResult, genome_digest, suite_digest


@dataclasses.dataclass
class SearchContext:
    """Everything a strategy needs: the space, the four agents, the suite
    T, the shared evaluation cache (plus the tiered evaluator and its
    worker budget), and the round budget."""
    space: Any
    testing: Any
    profiling: Any
    planning: Any
    coding: Any
    tests: list
    cache: EvalCache
    rounds: int = 5
    verbose: bool = False
    tests_digest: str = ""
    evaluator: Any = None           # TieredEvaluator
    workers: int = 1                # evaluate_many concurrency
    isolation: str = "thread"       # "process": sandboxed eval workers
    pool: Any = None                # workers.EvalWorkerPool (process mode)
    journal: Any = None             # journal.SearchJournal; None = off

    def __post_init__(self) -> None:
        if not self.tests_digest:
            # identical shapes can still carry other data (seed), another
            # fidelity (reps), another backend or another device: salt the
            # suite digest so evaluations never leak across rosters
            salt = repr((type(self.testing).__qualname__,
                         getattr(self.testing, "seed", None),
                         str(getattr(self.testing, "device", None)),
                         getattr(self.profiling, "reps", None),
                         getattr(self.profiling, "backend", None)))
            self.tests_digest = suite_digest(self.tests, salt=salt)

    def evaluate(self, variant, *, validate: bool = True) -> EvalResult:
        """One genome through the evaluator."""
        if self.isolation == "process":
            # the batch API owns the process path
            return self.evaluate_many([variant], validate=validate)[0]
        result = self.evaluator.evaluate(
            self.space, variant, self.tests,
            testing=self.testing, profiling=self.profiling,
            cache=self.cache, validate=validate,
            tests_digest=self.tests_digest)
        self._journal_results([variant], [result])
        return result

    def evaluate_many(self, variants, *,
                      validate: bool = True) -> list[EvalResult]:
        """Evaluate a batch of genomes, concurrently (and still
        deterministically) when ``workers > 1``. Results align with
        ``variants``; duplicates collapse in the cache."""
        results = self.evaluator.evaluate_many(
            self.space, variants, self.tests,
            testing=self.testing, profiling=self.profiling, cache=self.cache,
            validate=validate, tests_digest=self.tests_digest,
            workers=self.workers, isolation=self.isolation, pool=self.pool)
        self._journal_results(variants, results)
        return results

    def note_round(self, round_: int, variants) -> None:
        """Write-ahead: journal a round's candidates before evaluating them
        (on resume, the determinism self-check)."""
        if self.journal is not None:
            self.journal.record_round(
                round_, [genome_digest(v) for v in variants])

    def _journal_results(self, variants, results) -> None:
        # fresh outcomes only: cache hits (journal replays among them) are
        # already durable
        if self.journal is None:
            return
        for variant, result in zip(variants, results):
            if not result.cached:
                self.journal.record_eval(
                    self.cache.key(self.space.name, variant, self.tests,
                                   tests_digest=self.tests_digest,
                                   launch_key=self.space.launch_key),
                    result)

    def history_entry(self, variant, result: EvalResult,
                      suggestion=None) -> dict:
        """The planning agents consume history as a list of these dicts."""
        return {"variant": variant, "passed": result.passed,
                "profile": result.profile, "suggestion": suggestion}


class SearchStrategy:
    """Interface: consume a SearchContext, produce an optimization Log."""

    name = "abstract"

    def run(self, ctx: SearchContext) -> Log:
        raise NotImplementedError


class GreedyChain(SearchStrategy):
    """Algorithm 1 (paper §3.2) — the strictly sequential greedy chain."""

    name = "greedy"

    def run(self, ctx: SearchContext) -> Log:
        space = ctx.space
        s_prev = space.baseline
        ctx.note_round(0, [s_prev])
        base = ctx.evaluate(s_prev, validate=False)
        log = Log()
        log.append(LogEntry(0, s_prev, True, base.profile,
                            rationale="baseline"))
        pass_prev, perf_prev = True, base.profile
        history = [ctx.history_entry(s_prev, base)]

        for r in range(1, ctx.rounds + 1):
            sugg = ctx.planning.suggest(space, s_prev, pass_prev, perf_prev,
                                        history)
            s_new = ctx.coding.apply(space, s_prev, sugg)
            ctx.note_round(r, [s_new])
            res = ctx.evaluate(s_new)
            log.append(LogEntry(r, s_new, res.passed, res.profile,
                                rationale=sugg.rationale,
                                max_err=res.max_err))
            history.append(ctx.history_entry(s_new, res, sugg))
            s_prev, pass_prev, perf_prev = s_new, res.passed, res.profile
            if ctx.verbose:
                print(f"[{space.name}] round {r}: {sugg.rationale}")
                print(f"    -> {s_new.describe()}  "
                      f"{'OK' if res.passed else 'FAIL'} "
                      f"{res.profile.geomean_latency_us:.2f}us"
                      + (" (cached)" if res.cached else ""))
        return log


class BeamSearch(SearchStrategy):
    """Top-k frontier search: each round expands every frontier candidate
    with up to ``width`` planner proposals, evaluates the novel genomes
    through the cache, and keeps the ``width`` best (correct-first, then
    by latency)."""

    name = "beam"

    def __init__(self, width: int = 4):
        if width < 1:
            raise ValueError("beam width must be >= 1")
        self.width = width

    def run(self, ctx: SearchContext) -> Log:
        space = ctx.space
        ctx.note_round(0, [space.baseline])
        base = ctx.evaluate(space.baseline, validate=False)
        log = Log()
        log.append(LogEntry(0, space.baseline, True, base.profile,
                            rationale="baseline"))
        seen = {genome_digest(space.baseline)}
        base_hist = [ctx.history_entry(space.baseline, base)]
        # frontier: (variant, result, lineage history for the planner)
        frontier = [(space.baseline, base, base_hist)]

        for r in range(1, ctx.rounds + 1):
            # Phase 1: expand every frontier member into its novel children
            # (planning/coding only — no evaluation yet).
            batch = []                  # (child, suggestion, parent history)
            for var, res, hist in frontier:
                suggs = ctx.planning.suggest_many(
                    space, var, res.passed, res.profile, hist, k=self.width)
                for sugg in suggs:
                    child = ctx.coding.apply(space, var, sugg)
                    dg = genome_digest(child)
                    if dg in seen:
                        continue        # genome already explored this search
                    seen.add(dg)
                    batch.append((child, sugg, hist))
            # Phase 2: evaluate the round's novel genomes as one concurrent
            # batch; results come back in proposal order, so the Log is
            # identical to the old one-at-a-time loop.
            ctx.note_round(r, [c for c, _, _ in batch])
            results = ctx.evaluate_many([c for c, _, _ in batch])
            children = []
            for (child, sugg, hist), cres in zip(batch, results):
                log.append(LogEntry(r, child, cres.passed, cres.profile,
                                    rationale=f"beam: {sugg.rationale}",
                                    max_err=cres.max_err))
                children.append(
                    (child, cres,
                     hist + [ctx.history_entry(child, cres, sugg)]))
            if not children:
                break                   # move space exhausted
            pool = frontier + children
            pool.sort(key=lambda t: (not t[1].passed,
                                     t[1].profile.geomean_latency_us))
            frontier = pool[:self.width]
            if ctx.verbose:
                lead = frontier[0]
                print(f"[{space.name}] beam round {r}: "
                      f"{len(children)} new genomes, frontier lead "
                      f"{lead[1].profile.geomean_latency_us:.2f}us "
                      f"({lead[0].describe()})")
        return log


class Population(SearchStrategy):
    """Random-restart + mutation over the knob genome.

    Seeded and fully deterministic: a random initial population around the
    baseline, elitist survivor selection on cached evaluations, single-knob
    mutations plus a fresh random restart each generation.
    """

    name = "population"

    def __init__(self, size: int = 8, survivors: int = 3, seed: int = 0):
        if size < 2:
            raise ValueError("population size must be >= 2")
        self.size = size
        self.survivors = max(1, min(survivors, size))
        self.seed = seed

    # -- genome samplers ----------------------------------------------------

    def _random_value(self, knob, rng: random.Random):
        if knob.kind == "bool":
            return rng.random() < 0.5
        lo_e = (knob.lo - 1).bit_length()
        hi_e = (knob.hi - 1).bit_length()
        return min(knob.hi, max(knob.lo, 1 << rng.randint(lo_e, hi_e)))

    def _mutate(self, ctx: SearchContext, genome, rng: random.Random):
        knob = rng.choice(ctx.space.knobs)
        sugg = Suggestion(knob.name, self._random_value(knob, rng),
                          f"population: mutate {knob.name}")
        # the coding agent clamps the move to the knob's legal range
        return ctx.coding.apply(ctx.space, genome, sugg)

    def _restart(self, ctx: SearchContext, rng: random.Random):
        genome = ctx.space.baseline
        for _ in range(rng.randint(1, len(ctx.space.knobs))):
            genome = self._mutate(ctx, genome, rng)
        return genome

    # -- the generational loop ----------------------------------------------

    def run(self, ctx: SearchContext) -> Log:
        space = ctx.space
        rng = random.Random(self.seed)
        ctx.note_round(0, [space.baseline])
        base = ctx.evaluate(space.baseline, validate=False)
        log = Log()
        log.append(LogEntry(0, space.baseline, True, base.profile,
                            rationale="baseline"))
        seen = {genome_digest(space.baseline)}
        scored = [(space.baseline, base)]

        population = [self._restart(ctx, rng)
                      for _ in range(self.size - 1)]
        for gen in range(1, ctx.rounds + 1):
            novel = []
            for genome in population:
                dg = genome_digest(genome)
                if dg in seen:
                    continue
                seen.add(dg)
                novel.append(genome)
            # one concurrent batch per generation; results in genome order
            ctx.note_round(gen, novel)
            for genome, res in zip(novel, ctx.evaluate_many(novel)):
                log.append(LogEntry(gen, genome, res.passed, res.profile,
                                    rationale=f"population gen {gen}",
                                    max_err=res.max_err))
                scored.append((genome, res))
            elite = sorted(
                scored, key=lambda t: (not t[1].passed,
                                       t[1].profile.geomean_latency_us)
            )[:self.survivors]
            if ctx.verbose:
                print(f"[{space.name}] population gen {gen}: "
                      f"{len(scored)} genomes scored, best "
                      f"{elite[0][1].profile.geomean_latency_us:.2f}us")
            # next generation: mutated elites + one fresh random restart
            population = [self._mutate(ctx, g, rng) for g, _ in elite]
            while len(population) < self.size - 1:
                population.append(
                    self._mutate(ctx, rng.choice(elite)[0], rng))
            population.append(self._restart(ctx, rng))
        return log


_STRATEGIES: dict[str, type] = {
    GreedyChain.name: GreedyChain,
    BeamSearch.name: BeamSearch,
    Population.name: Population,
}


def resolve_strategy(strategy) -> SearchStrategy:
    """Accepts a strategy name, class, or instance; returns an instance."""
    if isinstance(strategy, SearchStrategy):
        return strategy
    if isinstance(strategy, type) and issubclass(strategy, SearchStrategy):
        return strategy()
    if isinstance(strategy, str):
        try:
            return _STRATEGIES[strategy]()
        except KeyError:
            raise KeyError(f"unknown search strategy {strategy!r}; "
                           f"available: {sorted(_STRATEGIES)}") from None
    raise TypeError(f"cannot resolve a SearchStrategy from {strategy!r}")
