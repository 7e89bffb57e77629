"""Crash-isolated, resumable search of the PyTorch port, on the CPU (the
counterparts of ``tests/test_search_chaos.py``).

* Process isolation gives the thread path's results and Logs bit for bit
  (reduced fp32 ``fused_add_rmsnorm`` suites, ``device="cpu"``, the
  analytic profile), and on a toy space the JAX thread path's rows.
* A chaos run (a worker kill, a hang past the deadline, a corrupted
  result, a genome that kills its worker twice) ends in bounded time,
  quarantines only the doomed genome and keeps the undisturbed best. The
  deadline never counts a worker's start-up: workers report ready first.
* ``kill -9`` and resume give a bit-identical Log: after seeded random
  truncations of the journal, and after a real SIGKILL of a subprocess
  (this file run as a script).
* Journal guards, the cache's torn tail, ``optimize_all(keep_going=True)``
  and the journal's records against the JAX journal's.

Run as a script, this file is the subprocess of the kill -9 test: one
journaled search, optionally SIGKILLing itself after the N-th eval record.
"""

import pytest
torch = pytest.importorskip("torch")

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
import warnings  # noqa: E402

from repro_torch.core.agents import (Profile, ProfilingAgent,  # noqa: E402
                                     TestingAgent)
from repro_torch.core.oplog import Log  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.registry import (KernelSpace, Knob,  # noqa: E402
                                          TestCase, get_space)
from repro_torch.reliability import (EvalTimeout, Fault,  # noqa: E402
                                     SearchChaosInjector)
from repro_torch.search import (EvalCache, EvalResult,  # noqa: E402
                                EvalWorkerPool, JournalMismatch,
                                SearchFailure, SearchJournal,
                                SearchOrchestrator, TieredEvaluator,
                                genome_key, optimize_all,
                                suite_digest)
from repro_torch.search.cache import _jsonable  # noqa: E402

SMALL = ({"batch": 16, "hidden": 512}, {"batch": 8, "hidden": 512})
TINY = ({"batch": 16, "hidden": 512},)
THIS = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(THIS))


def small_space(shapes=SMALL):
    return dataclasses.replace(get_space("fused_add_rmsnorm"),
                               suite_shapes=shapes)


def roster():
    return dict(testing=TestingAgent(dtypes=(torch.float32,), seed=0,
                                     device="cpu"),
                profiling=ProfilingAgent(reps=100))


def fingerprint(log):
    """Exact (unrounded) per-entry payload."""
    return [{"round": e.round, "variant": e.code.describe(),
             "correct": bool(e.correct), "rationale": e.rationale,
             "max_err": float(e.max_err),
             "profile": dataclasses.asdict(e.perf)} for e in log.entries]


def result_fields(r):
    return (r.passed, r.max_err, r.validated, r.screened, r.finish_reason,
            r.failed_test, dataclasses.asdict(r.profile))


@pytest.fixture(scope="module")
def cpu_pool():
    """Two workers for the well-behaved tests (each costs a start-up)."""
    with EvalWorkerPool(workers=2, deadline_s=120.0, device="cpu") as pool:
        yield pool


# -- process isolation ------------------------------------------------------

def test_process_isolation_bit_identical(cpu_pool):
    """Sandboxed evaluation returns exactly what the thread path returns,
    and the evaluator's search state rebuilds identically."""
    space = small_space()
    ags = roster()
    tests = ags["testing"].generate_tests(space)
    sd = suite_digest(tests)
    base = space.baseline
    variants = [base, dataclasses.replace(base, row_threads=512),
                dataclasses.replace(base, use_rsqrt=True)]
    ev_t = TieredEvaluator()
    res_t = ev_t.evaluate_many(space, variants, tests, cache=EvalCache(),
                               tests_digest=sd, **ags)
    ev_p = TieredEvaluator()
    res_p = ev_p.evaluate_many(space, variants, tests, cache=EvalCache(),
                               tests_digest=sd, isolation="process",
                               pool=cpu_pool, **ags)
    assert [result_fields(r) for r in res_t] \
        == [result_fields(r) for r in res_p]
    assert ev_t._best_lat == ev_p._best_lat
    assert ev_t._fail_counts == ev_p._fail_counts
    stats = ev_p.stats
    assert (stats.worker_crashes, stats.eval_timeouts, stats.retries,
            stats.quarantined) == (0, 0, 0, 0)


@pytest.mark.parametrize("strategy,rounds", [("greedy", 3), ("beam", 2)])
def test_process_isolation_gives_the_thread_log(cpu_pool, strategy, rounds):
    """Whole searches: the process path's Log and stage counters are the
    thread path's (an upgraded baseline keeps its stored profile; genomes
    that launch the same code share the first one's evaluation)."""
    space = small_space()
    thread = SearchOrchestrator(cache=EvalCache(), workers=2,
                                **roster()).search(space, strategy=strategy,
                                                   rounds=rounds)
    proc = SearchOrchestrator(cache=EvalCache(), workers=2,
                              isolation="process", pool=cpu_pool,
                              **roster()).search(space, strategy=strategy,
                                                 rounds=rounds)
    assert fingerprint(proc) == fingerprint(thread)
    assert proc.meta["isolation"] == "process"
    # each worker computes the suite's oracle once for itself, the thread
    # path once per process: every other counter agrees
    mine, ref = proc.meta["stages"], thread.meta["stages"]
    assert mine.pop("oracle_computations") >= ref.pop("oracle_computations")
    assert mine == ref


# a toy space both packages can search (the JAX one lives in
# tests/test_torch_search.py::toy_space); its pieces are module-level so
# that a worker can unpickle them

@dataclasses.dataclass(frozen=True)
class ToyVariant:
    name: str = "baseline"
    block: int = 16
    fused: bool = False
    fast: bool = False
    risky: bool = False


TOY = "toy_process"
TOY_KNOBS = (("fused", "bool", 8, 1024, ("memory", "overhead"), True),
             ("block", "pow2", 8, 256, ("overhead",), None),
             ("fast", "bool", 8, 1024, ("compute",), True),
             ("risky", "bool", 8, 1024, ("compute",), True))
TOY_TESTS = [TestCase(f"t{i}", (torch.arange(4, dtype=torch.float32) + i,),
                      {"dtype": torch.float32}) for i in range(3)]


def _toy_run(v, x):
    return x * (1.5 if v.risky and v.block >= 32 else 1.0)


def _toy_oracle(x):
    return x


def toy_space():
    return KernelSpace(
        name=TOY, baseline=ToyVariant(), run=_toy_run, oracle=_toy_oracle,
        cost=None, suite_shapes=({"toy": 3},),
        knobs=tuple(Knob(n, kind, lo, hi, attacks=a, target=t)
                    for n, kind, lo, hi, a, t in TOY_KNOBS))


class ToyTester(TestingAgent):
    """Hands out the toy's three cases. Unpickled in a worker, it
    registers the toy space there (the worker looks kernels up by name);
    this process never registers it."""

    def generate_tests(self, space):
        return list(TOY_TESTS)

    def __setstate__(self, state):
        self.__dict__.update(state)
        if TOY not in registry._REGISTRY:
            registry.register_kernel_space(toy_space())


class ToyProfiler:
    """The stub profiler of the JAX parity toy (``test_torch_search``)."""
    reps = 100

    def profile(self, space, variant, tests):
        v = variant
        lat = (20.0 - 7.0 * v.fused - 2.0 * v.fast - 1.5 * v.risky
               + 0.5 * abs(math.log2(v.block) - 5))
        dominant = "memory" if not v.fused else ("compute" if not v.fast
                                                 else "overhead")
        rows = [{"name": t.name, "latency_us": lat * (1 + 0.1 * i)}
                for i, t in enumerate(tests)]
        return Profile(rows, lat, dominant,
                       {"mem_frac": 0.4, "compute_frac": 0.3,
                        "overhead_frac": 0.3,
                        "smem_frac": 0.1 if v.block < 64 else 0.5,
                        "infeasible": v.block > 128}, 0.01)


@pytest.mark.parametrize("strategy", ["greedy", "beam", "population"])
def test_process_isolation_gives_the_jax_rows(cpu_pool, strategy):
    """The toy space through the port's workers gives the JAX thread
    path's rows and stage counters (as test_strategies_give_the_jax_logs
    holds the port's thread path to them)."""
    pytest.importorskip("jax")
    import test_torch_search as parity
    from repro.search import BeamSearch as JBeam
    from repro.search import Population as JPopulation
    from repro_torch.search import BeamSearch, Population
    make = {"greedy": lambda pkg: "greedy",
            "beam": lambda pkg: (BeamSearch, JBeam)[pkg](width=4),
            "population": lambda pkg: (Population, JPopulation)[pkg](
                size=4, seed=3)}[strategy]
    orch = SearchOrchestrator(testing=ToyTester(dtypes=(torch.float32,),
                                                device="cpu"),
                              profiling=ToyProfiler(), cache=EvalCache(),
                              isolation="process", pool=cpu_pool)
    log = orch.search(toy_space(), strategy=make(0), rounds=4)
    mine = [(e.round, genome_key(e.code), bool(e.correct),
             e.perf.geomean_latency_us, e.perf.dominant)
            for e in log.entries]
    ref, ref_stages = parity.run_toy(1, make(1))
    assert mine == ref
    # each worker computes the oracle for itself (see the test above)
    stages = {k: n for k, n in log.meta["stages"].items()
              if k != "oracle_computations"}
    assert stages == {k: ref_stages.get(k, 0) for k in stages}
    assert TOY not in registry._REGISTRY


def test_evaluate_many_rejects_bad_isolation():
    ev = TieredEvaluator()
    with pytest.raises(ValueError):
        ev.evaluate_many(small_space(), [small_space().baseline], [],
                         cache=EvalCache(), isolation="carrier-pigeon",
                         **roster())
    with pytest.raises(ValueError):
        ev.evaluate_many(small_space(), [small_space().baseline], [],
                         cache=EvalCache(), isolation="process", pool=None,
                         **roster())
    with pytest.raises(ValueError):
        SearchOrchestrator(device="cpu", isolation="carrier-pigeon")


def test_validate_timeout_budget():
    """The cooperative deadline raises EvalTimeout between cases."""
    space = small_space()
    testing = roster()["testing"]
    tests = testing.generate_tests(space)
    with pytest.raises(EvalTimeout):
        testing.validate(space, space.baseline, tests, timeout_s=0.0)
    ok, _ = testing.validate(space, space.baseline, tests[:1],
                             timeout_s=600.0)
    assert ok


def test_quarantine_is_final_and_persistent(tmp_path):
    """A genome that kills its worker twice is quarantined with a crashed
    verdict and the analytic profile, persisted, and never run again, not
    even by a later process that loads the cache file."""
    space = small_space(TINY)
    ags = roster()
    tests = ags["testing"].generate_tests(space)
    sd = suite_digest(tests)
    victim = dataclasses.replace(space.baseline, use_rsqrt=True)
    path = str(tmp_path / "cache.jsonl")
    ev = TieredEvaluator()
    cache = EvalCache(persist_path=path)
    # faults match the evaluation's key: here the launch digest
    k = cache.key(space.name, victim, tests, tests_digest=sd,
                  launch_key=space.launch_key)
    chaos = SearchChaosInjector([Fault("kill_worker", digest=k[1], times=2)])
    with EvalWorkerPool(workers=1, deadline_s=60.0, quarantine_after=2,
                        chaos=chaos, on_stat=ev.bump, device="cpu") as pool:
        ok_res, bad_res = ev.evaluate_many(
            space, [space.baseline, victim], tests, cache=cache,
            tests_digest=sd, isolation="process", pool=pool, **ags)
    assert ok_res.passed and ok_res.finish_reason == "ok"
    assert bad_res.finish_reason == "crashed" and bad_res.failed_infra
    assert not bad_res.passed and not bad_res.validated
    assert "worker died" in bad_res.error
    assert ev.stats.quarantined == 1 and ev.stats.worker_crashes == 2
    assert chaos.exhausted
    # the quarantine row's profile is the cost model's, made here
    want = ProfilingAgent(reps=100, backend="analytic").profile(
        space, victim, tests)
    assert bad_res.profile == want
    # a later process preloads the crashed verdict and never runs it: no
    # pool exists here, so a miss would run the thread path and count one
    cache2 = EvalCache(persist_path=path)
    assert cache2.preloaded == 2
    res2 = TieredEvaluator().evaluate(space, victim, tests, cache=cache2,
                                      tests_digest=sd, **ags)
    assert res2.cached and res2.failed_infra and "worker died" in res2.error
    assert cache2.stats()["hits"] == 1 and cache2.stats()["misses"] == 0


def test_a_worker_that_raised_is_replaced():
    """An evaluation that raises in the worker is a strike for the genome
    and retires the worker: the next task runs in a fresh process."""
    ev = TieredEvaluator()
    space = small_space(TINY)
    ags = roster()
    with EvalWorkerPool(workers=1, deadline_s=60.0, quarantine_after=2,
                        on_stat=ev.bump, device="cpu") as pool:
        bad = dict(kernel="no_such_kernel", suite_shapes=TINY,
                   variant=space.baseline, validate=True, tests_digest="x",
                   prior=None, frozen=None, config=dict(
                       screen=True, smoke=True, share_oracle=True,
                       dominate_factor=3.0), **ags)
        out = pool.submit(bad, digest="bad")
        assert not out.ok and "no_such_kernel" in out.error
        assert out.attempts == 2 and ev.stats.worker_crashes == 2
        good = dict(bad, kernel=space.name)
        assert pool.submit(good, digest="good").ok
    erred = {s["pid"] for s in pool.spans if s["status"] == "error"}
    assert len(erred) == 2
    assert pool.spans[-1]["status"] == "ok"
    assert pool.spans[-1]["pid"] not in erred


# -- the chaos acceptance run -----------------------------------------------

def test_search_chaos_acceptance():
    """A worker kill, a hang past the deadline and a corrupted result,
    each on one genome, and a victim that kills its worker twice, injected
    into a beam search: bounded wall time, only the victim quarantined,
    the undisturbed best kept, every other row bit-identical. The deadline
    starts at dispatch, after the worker reported ready, so a slow start
    under load cannot trip it."""
    space = small_space(TINY)
    undisturbed = SearchOrchestrator(cache=EvalCache(), workers=2,
                                     **roster()).search(space,
                                                        strategy="beam",
                                                        rounds=2)
    ref_rows = fingerprint(undisturbed)
    best = undisturbed.best().code
    last = max(e.round for e in undisturbed.entries)
    tests = roster()["testing"].generate_tests(space)

    def key(g):
        return EvalCache().key(space.name, g, tests,
                               launch_key=space.launch_key)[1]
    # the victim: a last-round genome that is not the best and shares its
    # evaluation with no other row, so killing it perturbs nothing else
    keys = [key(e.code) for e in undisturbed.entries]
    targets = [e.code for e, k in zip(undisturbed.entries, keys)
               if e.round == last and k != key(best) and keys.count(k) == 1]
    assert targets, "beam search too small to pick a quarantine victim"
    victim = targets[-1]
    others = [g for g in dict.fromkeys(keys) if g != key(victim)]
    assert len(others) >= 3
    chaos = SearchChaosInjector([
        Fault("kill_worker", digest=others[0]),
        Fault("hang_eval", digest=others[1], seconds=60.0),
        Fault("corrupt_result", digest=others[2]),
        Fault("kill_worker", digest=key(victim), times=2),
    ])
    orch = SearchOrchestrator(
        cache=EvalCache(), workers=2, isolation="process",
        pool_config={"deadline_s": 10.0, "quarantine_after": 2,
                     "chaos": chaos}, **roster())
    t0 = time.monotonic()
    with orch:
        log = orch.search(space, strategy="beam", rounds=2)
    wall = time.monotonic() - t0
    # evaluations, one 10 s deadline, five worker start-ups: never the
    # 60 s hang
    assert wall < 120.0, f"chaos search took {wall:.0f}s"
    stats = log.meta["stages"]
    assert stats["quarantined"] == 1, "quarantined more than the victim"
    assert stats["recoveries"] == 3
    assert (stats["worker_crashes"], stats["eval_timeouts"],
            stats["corrupt_results"]) == (3, 1, 1)
    assert chaos.exhausted
    assert log.best().code == best, "chaos changed the best genome"
    rows = fingerprint(log)
    assert len(rows) == len(ref_rows)
    for got, want in zip(rows, ref_rows):
        if want["variant"] == victim.describe() and want["round"] == last:
            assert got["correct"] is False
            assert got["profile"] == want["profile"]  # analytic, here
        else:
            assert got == want


# -- journal resume ---------------------------------------------------------

def _journaled_search(journal, *, strategy, rounds, workers=1):
    orch = SearchOrchestrator(cache=EvalCache(), workers=workers, **roster())
    return orch.search(small_space(), strategy=strategy, rounds=rounds,
                       journal=journal)


@pytest.mark.parametrize("strategy,rounds,workers",
                         [("greedy", 3, 1), ("beam", 2, 2)])
def test_resume_from_random_truncation(tmp_path, strategy, rounds, workers):
    """Kill the search at any journal position (seeded random cuts and a
    torn last write), resume, and the Log is bit-identical."""
    path = tmp_path / f"{strategy}.jsonl"
    ref = fingerprint(_journaled_search(SearchJournal(str(path)),
                                        strategy=strategy, rounds=rounds,
                                        workers=workers))
    full = path.read_bytes().split(b"\n")
    rng = random.Random(1234)
    cuts = sorted(rng.sample(range(1, len(full) - 1), k=3))
    for cut in cuts:
        path.write_bytes(b"\n".join(full[:cut]) + b"\n"
                         + b'{"type": "eval", "key": ["torn')
        with pytest.warns(UserWarning, match="torn/corrupt tail"):
            log = _journaled_search(SearchJournal(str(path)),
                                    strategy=strategy, rounds=rounds,
                                    workers=workers)
        assert fingerprint(log) == ref, f"divergence at cut {cut}"
    # a finished journal resumes as pure replay: no new evaluation
    path.write_bytes(b"\n".join(full))
    log = _journaled_search(SearchJournal(str(path)), strategy=strategy,
                            rounds=rounds, workers=workers)
    assert fingerprint(log) == ref
    assert log.meta["journal"]["resumed"]
    assert log.meta["cache"]["misses"] == 0


def _run_search_process(journal, out, *extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return subprocess.run(
        [sys.executable, THIS, "--journal", str(journal), "--out", str(out),
         *extra], env=env, cwd=REPO, capture_output=True, text=True,
        timeout=300)


@pytest.mark.parametrize("strategy,rounds,workers,kill_after",
                         [("greedy", 2, 1, 2), ("beam", 2, 2, 3)])
def test_kill9_resume_bit_identical(tmp_path, strategy, rounds, workers,
                                    kill_after):
    """A real SIGKILL of the search process right after the N-th eval
    record, a rerun on the same journal, and the Log of an uninterrupted
    run."""
    args = ("--strategy", strategy, "--rounds", str(rounds),
            "--workers", str(workers))
    proc = _run_search_process(tmp_path / "ref.jsonl", tmp_path / "ref.json",
                               *args)
    assert proc.returncode == 0, proc.stderr
    ref = json.loads((tmp_path / "ref.json").read_text())
    assert not ref["resumed"]
    journal = tmp_path / "killed.jsonl"
    proc = _run_search_process(journal, tmp_path / "dead.json", *args,
                               "--kill-after-evals", str(kill_after))
    assert proc.returncode == -signal.SIGKILL, \
        f"the search process survived its own kill -9: rc={proc.returncode} " \
        f"{proc.stderr}"
    assert not (tmp_path / "dead.json").exists()
    assert journal.exists() and journal.stat().st_size > 0
    proc = _run_search_process(journal, tmp_path / "resumed.json", *args)
    assert proc.returncode == 0, proc.stderr
    resumed = json.loads((tmp_path / "resumed.json").read_text())
    assert resumed["resumed"] and resumed["replayed"] >= kill_after - 1
    assert resumed["rows"] == ref["rows"]


def test_journal_header_and_round_guards(tmp_path):
    path = str(tmp_path / "j.jsonl")
    header = dict(kernel="k", strategy="greedy", strategy_config={},
                  rounds=2, tests_digest="d", salt="s")
    j = SearchJournal(path)
    assert j.open(**header) is False
    j.record_round(1, ["aaaa"])
    j.close()
    # the same search resumes; other candidates for a round are caught
    j2 = SearchJournal(path)
    j2.open(**header)
    j2.record_round(1, ["aaaa"])
    with pytest.raises(JournalMismatch):
        j2.record_round(1, ["bbbb"])
    j2.close()
    # a changed config is another search: discarded, never replayed
    j3 = SearchJournal(path)
    with pytest.warns(UserWarning, match="header mismatch"):
        resumed = j3.open(**dict(header, rounds=5))
    assert resumed is False and j3.rounds == {}
    j3.close()


def _toy_result(lat=1.0):
    return EvalResult(True, 0.0, Profile([], lat, "memory", {}, 0.0))


def test_cache_truncated_tail_skips_warns_and_repairs(tmp_path):
    path = str(tmp_path / "cache.jsonl")
    c1 = EvalCache(persist_path=path)
    c1.put(("k", "g1", "s"), _toy_result(1.0))
    c1.put(("k", "g2", "s"), _toy_result(2.0))
    with open(path, "ab") as f:             # the kill -9 artifact
        f.write(b'{"salt": "xyz", "key": ["k", "g3"')
    with pytest.warns(UserWarning, match="torn trailing line"):
        c2 = EvalCache(persist_path=path)
    assert c2.preloaded == 2
    # the next append cuts the torn tail: every line parses, and a third
    # load is clean
    c2.put(("k", "g3", "s"), _toy_result(3.0))
    with open(path, "rb") as f:
        for line in f:
            json.loads(line)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        c3 = EvalCache(persist_path=path)
    assert c3.preloaded == 3
    # a replayed entry is kept in memory only
    c3.put(("k", "g4", "s"), dataclasses.replace(_toy_result(4.0),
                                                 replayed=True),
           persist=False)
    assert EvalCache(persist_path=path).preloaded == 3


def test_optimize_all_keep_going(monkeypatch):
    """One kernel's infra failure becomes a SearchFailure; the other
    kernels still run."""
    from repro_torch.search import orchestrator as orch_mod
    real = orch_mod.get_space

    def fake_get_space(kernel):
        if kernel == "boom":
            raise RuntimeError("kernel module exploded")
        return dataclasses.replace(
            real(kernel), suite_shapes=({"batch": 16, "hidden": 1024},))

    monkeypatch.setattr(orch_mod, "get_space", fake_get_space)
    results = optimize_all(kernels=("boom", "silu_and_mul"), rounds=1,
                           workers=1, keep_going=True, device="cpu")
    assert isinstance(results["boom"], SearchFailure)
    assert results["boom"].kernel == "boom"
    assert "exploded" in results["boom"].detail
    assert isinstance(results["silu_and_mul"], Log)
    assert results["silu_and_mul"].best().correct
    with pytest.raises(RuntimeError):
        optimize_all(kernels=("boom",), rounds=1, workers=1, device="cpu")


def test_journal_parity_with_jax(tmp_path):
    """The port's journal of a greedy toy search has the JAX journal's
    record types, header keys and eval fields, and the same candidate
    digests per round. The toy's genome is one class in both packages, so
    ``genome_digest`` agrees; a real kernel's genome is another class in
    each package (the port's launch knobs), so its digests differ."""
    pytest.importorskip("jax")
    import test_torch_search as parity
    from repro import search as jsearch
    records = []
    for pkg in (0, 1):
        space, tester = parity.toy_space(pkg)
        orch = (SearchOrchestrator, jsearch.SearchOrchestrator)[pkg](
            testing=tester, profiling=parity.make_stub(pkg),
            cache=(EvalCache, jsearch.EvalCache)[pkg]())
        path = tmp_path / f"{pkg}.jsonl"
        orch.search(space, rounds=4,
                    journal=(SearchJournal, jsearch.SearchJournal)[pkg](
                        str(path)))
        records.append([json.loads(line) for line in
                        path.read_text().splitlines()])
    mine, ref = records
    assert [r["type"] for r in mine] == [r["type"] for r in ref]
    assert set(mine[0]) == set(ref[0])
    assert [r["candidates"] for r in mine if r["type"] == "round"] \
        == [r["candidates"] for r in ref if r["type"] == "round"]
    for a, b in zip(mine, ref):
        assert set(a) == set(b)
        if a["type"] == "eval":
            assert a["key"][1] == b["key"][1]
            assert (a["passed"], a["validated"], a["finish_reason"],
                    a["failed_test"]) == (b["passed"], b["validated"],
                                          b["finish_reason"],
                                          b["failed_test"])


# -- the killed search process (this file run as a script) ----------------

def _killable_search() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--journal", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--strategy", default="greedy")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--kill-after-evals", type=int, default=0)
    args = ap.parse_args()
    journal = SearchJournal(args.journal)
    if args.kill_after_evals:
        record = journal.record_eval
        written = [0]

        def record_and_maybe_die(key, result):
            record(key, result)
            written[0] += 1
            if written[0] >= args.kill_after_evals:
                os.kill(os.getpid(), signal.SIGKILL)
        journal.record_eval = record_and_maybe_die
    log = _journaled_search(journal, strategy=args.strategy,
                            rounds=args.rounds, workers=args.workers)
    with open(args.out, "w") as f:
        json.dump({"rows": fingerprint(log),
                   "resumed": log.meta["journal"]["resumed"],
                   "replayed": log.meta["journal"]["replayed"]},
                  f, default=_jsonable)


if __name__ == "__main__":
    _killable_search()
