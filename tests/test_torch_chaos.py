"""The request lifecycle, the chaos harness and crash recovery of the
PyTorch port against the JAX package, on the CPU at the reduced
qwen2-0.5b config (the counterparts of ``tests/test_chaos.py``).

* Every fault kind (abort, device fault with and without a slot, page
  pool exhaustion, corrupt readback, stall) through the JAX ``Engine``
  and the port's ``Engine(device="cpu")`` on the same fp32 weights (JAX
  ``PRNGKey(0)``, through ``convert.params_from_jax``): streams,
  ``finish_reason``, ``error``, ``steps``, ``readbacks``, ``preemptions``
  and the lifecycle counters (``aborted``, ``rejected``, ``failed``,
  ``deadline_expired``, ``recoveries``, the chaos stats) equal JAX's; the
  survivors' streams equal the undisturbed run's and aborted ones are its
  prefixes; the pool check holds after every step of the port.
* Abort of a queued, a resident and a swapped-out request; deadlines of
  queued and resident requests; admission's rejections; the watchdog; the
  facade's ``_fail_leftovers`` (``generate`` and ``stream`` finish what
  the engine left as ``failed``, as JAX does, instead of raising).
* Recovery in place: every tensor the captured step reads or writes keeps
  its ``data_ptr()`` across a recovery.
* ``PagePool.seize_free`` / ``release_seized`` against JAX's pool under a
  seeded churn.
* The ``chaos_mix`` golden (bf16, weights drawn inside
  ``jax.threefry_partitionable(False)``) under the bf16 rule, and
  ``chip_smoke.py``'s chaos counts at its settings.
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import reliability as jreliability  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.serving.api import LLMEngine as JaxLLMEngine  # noqa: E402
from repro.serving.cache_manager import (  # noqa: E402
    CacheConfig as JaxCacheConfig)
from repro.serving.chaos import ChaosInjector as JaxChaos  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.paging import PagePool as JaxPagePool  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.reliability import Fault  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    CacheConfig, ChaosInjector, Engine, InjectedDeviceFault, LLMEngine,
    PagePool, Request)

REPO = Path(__file__).resolve().parents[1]
ARCH = "qwen2-0.5b"
BF16 = dict(rtol=3e-2, atol=3e-2)
COUNTERS = ("steps", "readbacks", "preemptions", "aborted", "rejected",
            "failed", "deadline_expired", "recoveries", "chaos_injected",
            "chaos_relents")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tests run many tiny CPU ops, which the
    thread pool only slows, and more so beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fp32():
    """(jax cfg, port cfg, jax params, port params on the CPU), fp32."""
    jcfg = dataclasses.replace(jconfigs.smoke(ARCH), dtype="float32")
    cfg = dataclasses.replace(configs.smoke(ARCH), dtype="float32")
    params, _ = jregistry.init(jcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, params), cfg,
                                      "cpu")
    return jcfg, cfg, params, tparams


def _prompts(vocab, n, length, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (length,), dtype=np.int32)
            for _ in range(n)]


def _jax_faults(faults):
    return [jreliability.Fault(**dataclasses.asdict(f)) for f in faults]


# the scenarios of tests/test_chaos.py: (prompts (n, length, seed),
# max_new, slots, cache settings, the fault plan)
SCENARIOS = {
    "abort": dict(prompts=(4, 12, 0), plan=[
        Fault("abort", step=2, rid=0),      # resident
        Fault("abort", step=1, rid=3)]),    # still queued
    "corrupt_readback": dict(prompts=(4, 12, 0), plan=[
        Fault("corrupt_readback", step=3, slot=1)]),
    "device_fault": dict(prompts=(4, 20, 3), plan=[
        Fault("device_fault", step=4, slot=0)]),
    "device_fault_no_slot": dict(prompts=(2, 12, 0), plan=[
        Fault("device_fault", step=3)]),
    "pool_exhaustion": dict(prompts=(4, 24, 5), max_new=16, num_pages=6,
                            plan=[Fault("pool_exhaustion", step=2, pages=3,
                                        steps=6)]),
    # every kind at once on an oversubscribed pool with the tree on, a
    # request swapped out by the page hold, a corrupt readback after the
    # recovery
    "mix": dict(prompts=(6, 20, 7), max_new=24, slots=3, num_pages=8,
                plan=[Fault("abort", step=1, rid=5),
                      Fault("pool_exhaustion", step=2, pages=2, steps=12),
                      Fault("device_fault", step=16, slot=2),
                      Fault("corrupt_readback", step=20, slot=0),
                      Fault("abort", step=22, rid=4)]),
}


def _settings(name):
    s = SCENARIOS[name]
    return dict(max_new=s.get("max_new", 8), slots=s.get("slots", 2),
                num_pages=s.get("num_pages"), plan=s["plan"])


def _run_port(fp32, prompts, *, max_new, slots, num_pages, plan,
              max_seq=64, preemption="swap"):
    """(requests, stats, engine, pool checks) of the port's engine, the
    pool checked after every step."""
    _, cfg, _, tparams = fp32
    eng = Engine(tparams, cfg, slots=slots, max_seq=max_seq, device="cpu",
                 preemption=preemption,
                 chaos=ChaosInjector(plan) if plan else None,
                 cache_manager=CacheConfig(page_size=16,
                                           num_pages=num_pages))
    reqs = [Request(rid=rid, prompt=p.copy(), max_new_tokens=max_new)
            for rid, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    checks = 0
    while eng.has_work() and eng.step():
        eng.check_pool()
        checks += 1
    eng.run()
    eng.check_pool()
    return reqs, eng.stats(), eng, checks


def _run_jax(fp32, prompts, *, max_new, slots, num_pages, plan,
             max_seq=64, preemption="swap"):
    jcfg, _, params, _ = fp32
    eng = JaxEngine(params, jcfg, slots=slots, max_seq=max_seq,
                    preemption=preemption,
                    chaos=JaxChaos(_jax_faults(plan)) if plan else None,
                    cache_manager=JaxCacheConfig(page_size=16,
                                                 num_pages=num_pages))
    reqs = [JaxRequest(rid=rid, prompt=p.copy(), max_new_tokens=max_new)
            for rid, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return reqs, eng.stats(), eng


def _outcome(reqs):
    return [(r.rid, r.finish_reason, r.error, list(r.out_tokens))
            for r in reqs]


@pytest.fixture(scope="module")
def runs(fp32):
    """Each scenario through both engines, with and without its plan."""
    out = {}

    def run(name):
        if name not in out:
            s = _settings(name)
            n, length, seed = SCENARIOS[name]["prompts"]
            prompts = _prompts(fp32[1].vocab, n, length, seed)
            calm = {**s, "plan": None}
            out[name] = dict(port=_run_port(fp32, prompts, **s),
                             jax=_run_jax(fp32, prompts, **s),
                             calm=_run_port(fp32, prompts, **calm))
        return out[name]
    return run


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_chaos_matches_jax(name, runs):
    r = runs(name)
    reqs, st, eng, checks = r["port"]
    jreqs, jst, jeng = r["jax"]
    calm = {q.rid: list(q.out_tokens) for q in r["calm"][0]}
    assert _outcome(reqs) == _outcome(jreqs)
    for key in COUNTERS:
        assert st[key] == jst[key], key
    assert eng.chaos.exhausted and jeng.chaos.exhausted
    # a step that recovered, or ended a page hold, dispatched nothing
    assert st["readbacks"] == st["steps"] == \
        checks - st["recoveries"] - st["chaos_relents"]
    for q in reqs:
        if q.finish_reason == "done":
            assert q.out_tokens == calm[q.rid], q.rid
        elif q.finish_reason in ("aborted", "failed"):
            assert q.out_tokens == calm[q.rid][:len(q.out_tokens)]
    # nothing held at the end but the tree's pages
    pool = eng.cm.pool
    assert all(not pages for pages in pool.owned) and not pool.seized
    assert pool.pages_in_use == len(pool.tree_pages())


def test_each_fault_kind_has_its_outcome(runs):
    def reasons(name):
        return [q.finish_reason for q in runs(name)["port"][0]]

    assert reasons("abort") == ["aborted", "done", "done", "aborted"]
    assert runs("abort")["port"][0][3].out_tokens == []
    failed = [q for q in runs("corrupt_readback")["port"][0]
              if q.finish_reason == "failed"]
    assert len(failed) == 1 and "corrupt readback" in failed[0].error
    st = runs("device_fault")["port"][1]
    assert st["recoveries"] == 1 and st["failed"] == 1
    # the youngest-victim policy quarantines the later arrival
    assert reasons("device_fault_no_slot") == ["done", "failed"]
    st = runs("pool_exhaustion")["port"][1]
    assert set(reasons("pool_exhaustion")) == {"done"}
    assert st["chaos_injected"]["pool_exhaustion"] == 1
    st = runs("mix")["port"][1]
    assert (st["aborted"], st["failed"], st["recoveries"]) == (2, 2, 1)
    assert st["preemptions"] >= 1


def test_recovery_resets_the_step_state_in_place(fp32):
    """A recovery zeroes the pool, the carry, the emit buffer and the
    device table in place: every tensor keeps its data_ptr(), and the
    recovered engine serves a second wave equal to the first."""
    _, cfg, _, tparams = fp32
    prompts = _prompts(cfg.vocab, 4, 20, 3)
    eng = Engine(tparams, cfg, slots=2, max_seq=64, device="cpu",
                 chaos=[Fault("device_fault", step=4, slot=0)])
    tensors = {"token": eng._token, "pos": eng._pos, "active": eng._active,
               "emitted": eng._emitted, "max_new": eng._max_new,
               "emit": eng._emit, "table": eng._table, "seed": eng._seed,
               "temp": eng._temp, "topk": eng._topk, "topp": eng._topp,
               **{f"cache_{k}": v for k, v in eng.cache.items()}}
    ptrs = {k: v.data_ptr() for k, v in tensors.items()}
    calm = Engine(tparams, cfg, slots=2, max_seq=64, device="cpu")
    for e in (eng, calm):
        for rid, p in enumerate(prompts):
            e.submit(Request(rid=rid, prompt=p.copy(), max_new_tokens=8))
    calm.run()
    want = {r.rid: r.out_tokens for r in calm.finished}
    seen = []
    while eng.has_work() and eng.step():
        seen.append(eng.recoveries)
        assert {k: v.data_ptr() for k, v in tensors.items()} == ptrs
    assert 0 in seen and 1 in seen
    assert all(eng.cache[k].data_ptr() == ptrs[f"cache_{k}"]
               for k in eng.cache)
    for r in eng.finished:
        if r.finish_reason == "done":
            assert r.out_tokens == want[r.rid]
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=100 + rid, prompt=p.copy(),
                           max_new_tokens=8))
    eng.run()
    second = {r.rid - 100: r.out_tokens for r in eng.finished
              if r.rid >= 100}
    assert second == want
    assert {k: v.data_ptr() for k, v in tensors.items()} == ptrs


def test_an_error_of_the_step_itself_is_not_recovered(fp32, monkeypatch):
    """Only errors raised before the step is queued are recovered; one
    from the step body (on the card, a sticky CUDA error of a replay)
    ends the run."""
    _, cfg, _, tparams = fp32
    eng = Engine(tparams, cfg, slots=2, max_seq=64, device="cpu")
    eng.submit(Request(rid=0, prompt=_prompts(cfg.vocab, 1, 12, 0)[0]))

    def broken():
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(eng, "_step_body", broken)
    with pytest.raises(RuntimeError, match="illegal memory"):
        eng.run()
    assert eng.recoveries == 0


def test_abort_of_a_swapped_out_request_matches_jax(fp32):
    """Step both engines until a preemption victim waits swapped out,
    abort it, and run on: equal outcomes and counters, its pages gone."""
    jcfg, cfg, params, tparams = fp32
    prompts = _prompts(cfg.vocab, 3, 22, 9)
    eng = Engine(tparams, cfg, slots=3, max_seq=64, device="cpu",
                 cache_manager=CacheConfig(page_size=16, num_pages=4,
                                           prefix_cache=False))
    jeng = JaxEngine(params, jcfg, slots=3, max_seq=64,
                     cache_manager=JaxCacheConfig(page_size=16,
                                                  num_pages=4,
                                                  prefix_cache=False))
    outcomes, victims = [], []
    for e, R in ((eng, Request), (jeng, JaxRequest)):
        reqs = [R(rid=rid, prompt=p.copy(), max_new_tokens=25)
                for rid, p in enumerate(prompts)]
        for r in reqs:
            e.submit(r)
        while not any(r.swap_state is not None for r in reqs):
            assert e.step()
        victim = next(r for r in reqs if r.swap_state is not None)
        assert e.abort(victim.rid) and victim.swap_state is None
        e.run()
        victims.append(victim.rid)
        outcomes.append(_outcome(reqs))
        assert e.stats()["aborted"] == 1
    assert victims[0] == victims[1] and outcomes[0] == outcomes[1]
    assert eng.cm.pool.pages_in_use == 0
    assert not eng.abort(99)


def test_deadlines_match_jax(fp32):
    """A queued request whose deadline has passed, then a resident one."""
    jcfg, cfg, params, tparams = fp32
    prompts = _prompts(cfg.vocab, 3, 12, 0)
    outcomes = []
    for e, R in ((Engine(tparams, cfg, slots=2, max_seq=64, device="cpu"),
                  Request),
                 (JaxEngine(params, jcfg, slots=2, max_seq=64),
                  JaxRequest)):
        rs = [R(rid=i, prompt=p, max_new_tokens=8)
              for i, p in enumerate(prompts)]
        rs[2].deadline_s = 0.0          # expires before its admission
        for r in rs:
            e.submit(r)
        e.step()                        # rs[0], rs[1] resident
        assert rs[2].finish_reason == "deadline" and rs[2].out_tokens == []
        rs[0].deadline_s = 1e-9         # now a resident one
        e._has_deadlines = True
        e.run()
        assert e.stats()["deadline_expired"] == 2
        outcomes.append(_outcome(rs))
    assert outcomes[0] == outcomes[1]
    assert [o[1] for o in outcomes[0]] == ["deadline", "done", "deadline"]


def test_stall_and_deadline_match_jax(fp32):
    jcfg, cfg, params, tparams = fp32
    prompts = _prompts(cfg.vocab, 3, 12, 0)
    plan = [Fault("stall", step=1, seconds=0.05)]
    outcomes = []
    for e, R in ((Engine(tparams, cfg, slots=2, max_seq=64, device="cpu",
                         chaos=plan), Request),
                 (JaxEngine(params, jcfg, slots=2, max_seq=64,
                            chaos=JaxChaos(_jax_faults(plan))),
                  JaxRequest)):
        rs = [R(rid=i, prompt=p, max_new_tokens=6,
                deadline_s=0.02 if i == 1 else None)
              for i, p in enumerate(prompts)]
        for r in rs:
            e.submit(r)
        e.run()
        st = e.stats()
        assert st["chaos_injected"]["stall"] == 1
        assert st["deadline_expired"] == 1
        outcomes.append(_outcome(rs))
    assert [o[1] for o in outcomes[0]] == ["done", "deadline", "done"]
    # the stall runs on the wall clock: where the deadline cut the stream
    # is the host's timing, the rest is not
    assert [o for o in outcomes[0] if o[0] != 1] == \
        [o for o in outcomes[1] if o[0] != 1]


def test_admission_rejections_match_jax(fp32):
    jcfg, cfg, params, tparams = fp32
    rng = np.random.default_rng(0)
    bad = [np.zeros((0,), np.int32),
           rng.random((8,)).astype(np.float32),
           np.array([0, cfg.vocab + 5], np.int32),
           np.array([-3, 4], np.int32),
           rng.integers(0, cfg.vocab, (200,), dtype=np.int32)]
    eng = Engine(tparams, cfg, slots=2, max_seq=64, device="cpu")
    jeng = JaxEngine(params, jcfg, slots=2, max_seq=64)
    for e, R in ((eng, Request), (jeng, JaxRequest)):
        for rid, p in enumerate(bad):
            e.submit(R(rid=rid, prompt=p))
    assert [(r.finish_reason, r.error) for r in eng.finished] == \
        [(r.finish_reason, r.error) for r in jeng.finished]
    assert eng.stats()["rejected"] == len(bad)
    assert "1-d" in Engine(tparams, cfg, slots=1, max_seq=64,
                           device="cpu")._admission_error(
        Request(rid=0, prompt=np.zeros((2, 3), np.int32)))


def test_watchdog_rejects_a_wedged_head(fp32):
    """A request that can never fit, pushed past admission's check, is
    rejected by the idle engine's watchdog instead of deadlocking the
    queue; equal to JAX."""
    jcfg, cfg, params, tparams = fp32
    rng = np.random.default_rng(1)
    wedge_p = rng.integers(0, cfg.vocab, (200,), dtype=np.int32)
    ok_p = rng.integers(0, cfg.vocab, (10,), dtype=np.int32)
    outcomes = []
    for e, R in ((Engine(tparams, cfg, slots=2, max_seq=64, device="cpu"),
                  Request),
                 (JaxEngine(params, jcfg, slots=2, max_seq=64),
                  JaxRequest)):
        wedge = R(rid=0, prompt=wedge_p, arrival=0)
        ok = R(rid=1, prompt=ok_p, max_new_tokens=4, arrival=1)
        e.scheduler.push(wedge)          # past admission's check
        e.scheduler.push(ok)
        e.run()
        assert e.stats()["rejected"] == 1
        outcomes.append(_outcome([wedge, ok]))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][0][1] == "rejected" and outcomes[0][1][1] == "done"


def test_generate_and_stream_fail_leftovers_as_jax_does(fp32):
    """``max_steps`` cut short: the facade finishes what is left as
    ``failed`` with JAX's ``finish_reason`` and ``error`` (the port's
    facade used to raise), and stays usable."""
    jcfg, cfg, params, tparams = fp32
    prompts = _prompts(cfg.vocab, 3, 10, 0)
    llm = LLMEngine(tparams, cfg, slots=2, max_seq=64, device="cpu")
    jllm = JaxLLMEngine(params, jcfg, slots=2, max_seq=64)
    outs = llm.generate(prompts, max_new_tokens=8, max_steps=2)
    jouts = jllm.generate(prompts, max_new_tokens=8, max_steps=2)

    def rows(os_):
        return [(o.rid, o.finish_reason, o.error, o.tokens) for o in os_]

    assert rows(outs) == rows(jouts)
    assert any(o.finish_reason == "failed" for o in outs)
    events = list(llm.stream(prompts, max_new_tokens=8, max_steps=2))
    jevents = list(jllm.stream(prompts, max_new_tokens=8, max_steps=2))
    assert [(e.rid, e.token, e.index, e.done, e.finish_reason)
            for e in events] == [(e.rid, e.token, e.index, e.done,
                                  e.finish_reason) for e in jevents]
    terminal = {e.rid: e for e in events if e.done}
    assert len(terminal) == 3
    llm.engine.check_pool()
    assert all(o.finish_reason == "done"
               for o in llm.generate(prompts, max_new_tokens=4))


def test_facade_abort_and_deadlines_match_jax(fp32):
    jcfg, cfg, params, tparams = fp32
    prompts = _prompts(cfg.vocab, 3, 10, 3)
    runs = []
    for llm in (LLMEngine(tparams, cfg, slots=2, max_seq=64, device="cpu"),
                JaxLLMEngine(params, jcfg, slots=2, max_seq=64)):
        it = llm.stream(prompts, max_new_tokens=8,
                        deadlines=[None, None, 0.0])
        first = next(it)
        assert llm.abort(first.rid) and not llm.abort(first.rid)
        events = [first] + list(it)
        runs.append([(e.rid, e.token, e.index, e.done, e.finish_reason)
                     for e in events])
        assert llm.stats()["aborted"] == 1
        assert llm.stats()["deadline_expired"] == 1
    assert runs[0] == runs[1]
    with pytest.raises(ValueError, match="deadlines"):
        LLMEngine(tparams, cfg, slots=2, max_seq=64, device="cpu").generate(
            prompts, deadlines=[1.0])


def test_chaos_injector_checks_its_plan():
    with pytest.raises(ValueError, match="unknown chaos fault kind"):
        ChaosInjector([Fault("meteor", step=1)])
    exc = InjectedDeviceFault("boom", slot=2)
    assert isinstance(exc, RuntimeError) and exc.slot == 2


def test_seize_and_release_match_jax_under_churn():
    """Seeded churn of seizes, releases of holds, allocations, shared
    mappings and slot releases on both pools: equal state after every
    operation, and ``check()`` holds throughout."""
    rng = np.random.default_rng(11)
    pools = (PagePool(12, 16, 3, 6), JaxPagePool(12, 16, 3, 6))
    seized: list = []
    for _ in range(400):
        op, slot = int(rng.integers(0, 5)), int(rng.integers(0, 3))
        n = int(rng.integers(1, 4))
        if op == 0:
            got = [p.seize_free(n) for p in pools]
            assert got[0] == got[1]
            seized.extend(got[0])
        elif op == 1 and seized:
            k = int(rng.integers(1, len(seized) + 1))
            drop, seized[:] = seized[:k], seized[k:]
            for p in pools:
                p.release_seized(drop)
        elif op == 2:
            assert pools[0].alloc_n(slot, n % 3) == \
                pools[1].alloc_n(slot, n % 3)
        elif op == 3:
            cands = [p for pages in pools[0].owned for p in pages]
            take = [p for p in dict.fromkeys(cands)
                    if p not in pools[0].owned[slot]][:2]
            if take and len(pools[0].owned[slot]) + len(take) \
                    <= pools[0].pages_per_slot:
                for p in pools:
                    p.map_shared(slot, take)
        else:
            for p in pools:
                p.release(slot)
        for p in pools:
            p.check()
        t, j = pools
        assert t._free == j._free and t.refcnt == j.refcnt
        assert t.owned == j.owned and t.stats() == j.stats()
        assert t.seized == set(seized)
        assert not t.tree_pages()


# -- chip_smoke's chaos counts and the chaos_mix golden -----------------------

def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_chaos_counts(fp32):
    """The lifecycle counts chip_smoke holds its full-width chaos serve to
    depend on the prompts' lengths, the pages, slots, max_seq, max_new
    and the plan only: the port at the reduced width and the same
    settings gives them (and so did the JAX engine when they were set;
    ``test_chaos_matches_jax`` holds the port's chaos runs to JAX's)."""
    _, cfg, _, tparams = fp32
    smoke = _load("chip_smoke_for_chaos_tests", REPO / "chip_smoke.py")
    s = smoke.SERVE_OVER
    llm = LLMEngine(tparams, cfg, chaos=smoke.chaos_plan(), device="cpu",
                    slots=s["slots"], max_seq=s["max_seq"],
                    page_size=s["page_size"], num_pages=s["num_pages"],
                    preemption=s["preemption"])
    outs = llm.generate(smoke.chaos_prompts(cfg, s),
                        max_new_tokens=s["max_new"])
    st = llm.stats()
    assert llm.engine.chaos.exhausted and st["suffix_prefills"] == 0
    for key, want in smoke.CHAOS_COUNTS.items():
        assert st[key] == want, key
    assert [o.finish_reason for o in outs][-2:] == ["rejected", "rejected"]
    assert all(len(o.tokens) == s["max_new"] for o in outs
               if o.finish_reason == "done")


def test_chaos_mix_golden_holds_under_the_bf16_rule():
    jcfg, cfg = jconfigs.smoke(ARCH), configs.smoke(ARCH)
    with jax.threefry_partitionable(False):
        params, _ = jregistry.init(jcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, params), cfg,
                                      "cpu")
    bench = _load("serve_bench_for_chaos_tests",
                  REPO / "benchmarks" / "serve_bench.py")
    gold = json.loads((REPO / "benchmarks" / "golden"
                       / "serve_qwen2-0.5b_chaos_mix.json").read_text())
    reqs = bench.build_requests(jcfg, "chaos_mix", seed=gold["seed"])
    plan = [Fault(**dataclasses.asdict(f)) for f in bench._chaos_plan()]
    chaos = ChaosInjector(plan)
    llm = LLMEngine(tparams, cfg, slots=gold["slots"],
                    max_seq=gold["max_seq"], device="cpu", chaos=chaos,
                    **gold["engine_kw"])
    outs = llm.generate([r.prompt for r in reqs],
                        max_new_tokens=gold["max_new"])
    st = llm.stats()
    assert chaos.exhausted and st["readbacks"] == st["steps"]
    assert (st["aborted"], st["rejected"], st["recoveries"]) == (2, 2, 1)
    assert sorted(gold["streams"], key=int) == [str(o.rid) for o in outs]
    for req, out in zip(reqs, outs):
        want = gold["streams"][str(out.rid)]
        assert len(out.tokens) == len(want), out.rid
        diff = [i for i, (a, b) in enumerate(zip(want, out.tokens))
                if a != b]
        if not diff:
            continue
        # the first divergence must sit on a near-tie of the JAX logits
        i = diff[0]
        seq = np.concatenate([req.prompt, np.asarray(want[:i], np.int32)])
        logits, _ = jtransformer.prefill(params, jcfg,
                                         jnp.asarray(seq[None]))
        lg = np.asarray(logits[0], np.float32)
        a, b = lg[want[i]], lg[out.tokens[i]]
        assert abs(a - b) <= BF16["atol"] + BF16["rtol"] * abs(a), \
            (out.rid, i, a, b)
