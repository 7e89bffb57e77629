"""The agent loop of the PyTorch port against the JAX package, on the CPU.

* Registry parity: the port registers the JAX package's three paper
  kernels and the paged decode attention (``paged_flash_decode``) with the
  same knobs, genomes and suite shapes, and the contiguous decode
  attention (``flash_decode``) with JAX's knobs but a ``chunk`` range the
  card's shared memory can hold.
* Policy parity: both packages' planners make the same moves from the
  same genomes, verdicts, profile signals and histories.
* Strategy parity: one toy space, built in each package from one
  description and profiled by one stub, gives equal Logs and equal stage
  counters under the greedy, beam and population strategies.
* The evaluator and cache (the assertions of ``tests/test_evaluator.py``)
  and Algorithm 1 on the analytic H100 backend, ``device="cpu"``, where the
  plain per-genome versions run and the CUDA library is never touched.
* Without a GPU the entry points raise unless ``device="cpu"`` is asked.
"""

import dataclasses
import math
import shutil
import threading
import time

import numpy as np
import pytest
torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import agents as jagents  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.kernels import registry as jregistry  # noqa: E402
from repro import search as jsearch  # noqa: E402
from repro_torch.core import (  # noqa: E402
    CodingAgent, PlanningAgent, ProfilingAgent, TestingAgent, costmodel,
    optimize, optimize_single_agent, reintegrate)
from repro_torch.core import agents, policy  # noqa: E402
from repro_torch.kernels import _build, ops, registry  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    flash_decode, fused_add_rmsnorm, merge_attn_states, silu_and_mul)
from repro_torch.kernels.registry import (  # noqa: E402
    KernelSpace, Knob, TestCase, clear_suite_memos, get_space,
    oracle_outputs, suite_tests)
from repro_torch.search import (  # noqa: E402
    BeamSearch, EvalCache, EvalWorkerPool, Population, SearchOrchestrator,
    TieredEvaluator, genome_key)
from repro_torch.search import cache as cache_mod  # noqa: E402
from repro_torch.search import evaluator as evaluator_mod  # noqa: E402

PAPER = ("fused_add_rmsnorm", "merge_attn_states_lse", "silu_and_mul")

# reduced suites (as tests/test_search.py::REDUCED_SUITES): the adversarial
# structure at a bounded cost
REDUCED_SUITES = {
    "silu_and_mul": ({"batch": 16, "hidden": 4096},
                     {"batch": 17, "hidden": 11008}),
    "fused_add_rmsnorm": ({"batch": 256, "hidden": 4096},
                          {"batch": 33, "hidden": 5120}),
    "merge_attn_states_lse": ({"seq": 100, "heads": 7, "head_dim": 128},
                              {"seq": 128, "heads": 8, "head_dim": 256}),
}


def reduced(kernel):
    return dataclasses.replace(get_space(kernel),
                               suite_shapes=REDUCED_SUITES[kernel])


def cpu_tester(**kw):
    return TestingAgent(device="cpu", **kw)


# --------------------------------------------------------------- registry

def knob_tuple(space):
    return [(k.name, k.kind, k.lo, k.hi, k.attacks, k.target)
            for k in space.knobs]


# the port's launch knobs: (lo, hi) where the JAX package has the knob with
# its TPU range, or where it has none (rmsnorm's threads a row)
PORT_LAUNCH_KNOBS = {
    "fused_add_rmsnorm": {"block_rows": (1, 16), "row_threads": (32, 1024)},
    "silu_and_mul": {"block_rows": (1, 16), "block_cols": (32, 1024)},
}


def jax_knobs(kernel):
    """The port's space with the JAX package's knob definitions and its
    baseline's values of them (what the two planners are held to one
    another on)."""
    jspace = jregistry.get_space(kernel)
    ref = {k.name: k for k in jspace.knobs}
    space = get_space(kernel)
    return dataclasses.replace(
        space,
        baseline=dataclasses.replace(space.baseline, **{
            n: getattr(jspace.baseline, n) for n in ref}),
        knobs=tuple(Knob(**{f.name: getattr(ref[k.name], f.name)
                            for f in dataclasses.fields(Knob)})
                    for k in space.knobs if k.name in ref))


@pytest.mark.parametrize("kernel", PAPER + ("paged_flash_decode",))
def test_registry_matches_the_jax_space(kernel):
    """The JAX package's knobs, flags, genomes and suite; the launch knobs
    of rmsnorm and silu take the port's ranges (a block's rows and
    threads on the card) and their values in the port's genomes."""
    assert registry.registered_kernels() == tuple(sorted(
        ("flash_decode", "paged_flash_decode") + PAPER))
    mine, ref = get_space(kernel), jregistry.get_space(kernel)
    launch = PORT_LAUNCH_KNOBS.get(kernel, {})
    theirs = {k[0]: k for k in knob_tuple(ref)}
    for k in knob_tuple(mine):
        if k[0] in launch:
            assert (k[1], k[2], k[3]) == ("pow2",) + launch[k[0]]
        else:
            assert k == theirs.pop(k[0])
    assert set(theirs) <= set(launch)
    for genome in ("baseline", "shipped"):
        a = dataclasses.asdict(getattr(mine, genome))
        b = dataclasses.asdict(getattr(ref, genome))
        for name, (lo, hi) in launch.items():
            assert lo <= a.pop(name) <= hi
            b.pop(name, None)
        assert a == b
    if launch:      # the textbook launch: one row a block, or a step, where
        # JAX's baseline takes a 16-row tile
        assert mine.baseline.block_rows == 1
        assert ref.baseline.block_rows == 16
    assert mine.suite_shapes == ref.suite_shapes
    assert type(mine.baseline).__name__ == type(ref.baseline).__name__


def test_flash_decode_space_is_jax_but_the_chunk_range():
    """The same knobs, flags and suite; ``chunk`` runs 16..256 (two K and
    V tiles in 227 KB of shared memory) where JAX's ran 128..4096 (a TPU
    core's VMEM), and both shipped genomes take chunk 64."""
    mine, ref = get_space("flash_decode"), jregistry.get_space("flash_decode")
    ours, theirs = knob_tuple(mine), knob_tuple(ref)
    assert [k[0] for k in ours] == [k[0] for k in theirs]
    for a, b in zip(ours, theirs):
        if a[0] == "chunk":
            assert (a[2], a[3], b[2], b[3]) == (16, 256, 128, 4096)
        else:
            assert a == b
    for genome in ("baseline", "shipped"):
        a = dataclasses.asdict(getattr(mine, genome))
        b = dataclasses.asdict(getattr(ref, genome))
        assert a.pop("chunk") == 64 and b.pop("chunk") in (512, 1024)
        assert a == b
    assert mine.suite_shapes == ref.suite_shapes
    assert type(mine.baseline).__name__ == type(ref.baseline).__name__


def test_flash_decode_cost_screens_tiles_that_do_not_fit():
    """Three slots of K and V tiles: chunk 64 fits every suite shape; 128
    does not fit fp32 at head_dim 128, and 256 fits only bf16 at
    head_dim 64 among them; the h2o-danube decode shape (head_dim 80,
    bf16) takes up to 128."""
    big = dataclasses.replace(flash_decode.OPTIMIZED, chunk=256)
    for shape in flash_decode.SUITE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            flash_decode.cost(flash_decode.OPTIMIZED, dtype=dtype, **shape)
            if shape["head_dim"] == 64 and dtype == torch.bfloat16:
                flash_decode.cost(big, dtype=dtype, **shape)
                continue
            with pytest.raises(costmodel.Infeasible):
                flash_decode.cost(big, dtype=dtype, **shape)
    wide = dict(flash_decode.SUITE_SHAPES[0], dtype=torch.float32)
    with pytest.raises(costmodel.Infeasible):
        flash_decode.cost(dataclasses.replace(flash_decode.BASELINE,
                                              chunk=128), **wide)
    h2o = dict(batch=8, q_heads=32, kv_heads=8, head_dim=80, seq=4096,
               dtype=torch.bfloat16)
    c = flash_decode.cost(dataclasses.replace(flash_decode.OPTIMIZED,
                                              chunk=128), **h2o)
    assert c.smem_bytes <= costmodel.SMEM_PER_BLOCK
    with pytest.raises(costmodel.Infeasible):
        flash_decode.cost(dataclasses.replace(flash_decode.OPTIMIZED,
                                              chunk=256), **h2o)
    # the byte bound of the h2o decode shape, all rows valid: 25.0 us,
    # plus the fp32 partials of its splits, written once and read once
    base = flash_decode.cost(flash_decode.BASELINE, **h2o)
    plan = flash_decode.launch_plan(flash_decode.BASELINE, **h2o)
    part = 2 * 8 * 32 * plan["splits"] * (80 + 2) * 4
    assert plan["splits"] > 1 and base.blocks == 64 * plan["splits"]
    assert base.mem_s * 1e6 == pytest.approx(25.04 + part / 3.35e6,
                                             abs=0.05)
    # mask_oob moves only the chunks below kv_len (33 of 64 here)
    half = flash_decode.cost(flash_decode.OPTIMIZED, mean_kv_len=2048, **h2o)
    assert half.total("dram_bytes") - part < \
        0.52 * (base.total("dram_bytes") - part)


def test_flash_decode_infeasible_move_is_screened_never_validated():
    space = dataclasses.replace(
        get_space("flash_decode"),
        suite_shapes=({"batch": 2, "q_heads": 8, "kv_heads": 8,
                       "head_dim": 128, "seq": 300},))
    tests = suite_tests(space, cpu_tester(dtypes=(torch.float32,)))
    ev = TieredEvaluator()
    res = ev.evaluate(space, dataclasses.replace(space.baseline, chunk=256),
                      tests, testing=RefusingTester(device="cpu"),
                      profiling=ProfilingAgent(), cache=EvalCache())
    assert res.screened and not res.validated
    assert ev.stats.screened_infeasible == 1


def test_flash_decode_launch_key_follows_every_knob():
    """At the suite shapes every knob move launches other code; past the
    cache's rows a larger chunk launches the same."""
    space = get_space("flash_decode")
    base = space.baseline
    for shape in flash_decode.SUITE_SHAPES:
        info = dict(shape, dtype=torch.bfloat16, mean_kv_len=100.0)
        keys = {space.launch_key(base, **info)}
        for knob in space.knobs:
            value = 2 * base.chunk if knob.kind == "pow2" \
                else not getattr(base, knob.name)
            keys.add(space.launch_key(space.mutate(base, knob, value),
                                      **info))
        assert len(keys) == 1 + len(space.knobs)
    short = dict(flash_decode.SUITE_SHAPES[0], seq=50, dtype=torch.float32)
    assert space.launch_key(base, **short) == space.launch_key(
        dataclasses.replace(base, chunk=256), **short)


def test_flash_decode_search_on_the_analytic_backend():
    """Algorithm 1 on a reduced flash_decode suite: the planner moves the
    flags toward their targets and the best genome is correct."""
    space = dataclasses.replace(
        get_space("flash_decode"),
        suite_shapes=({"batch": 2, "q_heads": 8, "kv_heads": 2,
                       "head_dim": 80, "seq": 200},
                      {"batch": 3, "q_heads": 7, "kv_heads": 1,
                       "head_dim": 64, "seq": 150}))
    log = optimize(space, rounds=3, device="cpu")
    assert len(log.entries) == 4 and log.best().correct
    assert log.speedup() >= 1.0
    assert all(e.correct for e in log.entries)


def test_paged_space_is_the_jax_space():
    """JAX's genome (page_size, mask_oob, use_reciprocal), its baseline and
    shipped genomes, knobs and ranges (page_size pow2 8..256), and suite;
    ``ops`` ships ``PAGED_OPTIMIZED``."""
    mine = get_space("paged_flash_decode")
    ref = jregistry.get_space("paged_flash_decode")
    assert mine.shipped == flash_decode.PAGED_OPTIMIZED
    assert mine.baseline == flash_decode.PAGED_BASELINE
    assert dataclasses.asdict(mine.shipped) == dict(
        name="astra_opt", page_size=64, use_reciprocal=True, mask_oob=True)
    assert ops.get_variant("paged_flash_decode") == mine.shipped


def test_paged_launch_key_and_cost_follow_the_genome():
    """Every knob move launches other code at the suite shapes; a page past
    the cache's rows launches the same; the cost counts the split form."""
    space = get_space("paged_flash_decode")
    base = space.baseline
    for shape in flash_decode.PAGED_SUITE_SHAPES:
        info = dict(shape, dtype=torch.bfloat16, mean_kv_len=100.0)
        keys = {space.launch_key(base, **info)}
        for knob in space.knobs:
            value = 2 * base.page_size if knob.kind == "pow2" \
                else not getattr(base, knob.name)
            keys.add(space.launch_key(space.mutate(base, knob, value),
                                      **info))
        assert len(keys) == 1 + len(space.knobs)
        c = space.cost(space.shipped, **info)
        plan = flash_decode.paged_launch_plan(
            batch=shape["batch"], q_heads=shape["q_heads"],
            kv_heads=shape["kv_heads"], head_dim=shape["head_dim"],
            page=64, n_pt=-(-shape["seq"] // 64), dtype=torch.bfloat16)
        assert c.blocks == shape["batch"] * shape["kv_heads"] * \
            plan["splits"] and c.threads == flash_decode.THREADS
        # the launch floor: these calls move well under a microsecond
        assert c.dominant() == "overhead"
    short = dict(flash_decode.PAGED_SUITE_SHAPES[0], seq=50,
                 dtype=torch.float32)
    assert space.launch_key(dataclasses.replace(base, page_size=64),
                            **short) == space.launch_key(
        dataclasses.replace(base, page_size=256), **short)
    # mask_oob moves only the rows below kv_len
    info = dict(flash_decode.PAGED_SUITE_SHAPES[1], dtype=torch.bfloat16)
    full = space.cost(base, mean_kv_len=400.0, **info)
    masked = space.cost(dataclasses.replace(base, mask_oob=True),
                        mean_kv_len=100.0, **info)
    assert masked.total("dram_bytes") < 0.5 * full.total("dram_bytes")


def test_paged_search_on_the_analytic_backend():
    """One round of the agent loop on ``paged_flash_decode`` on the CPU:
    the suite is paged through the shuffled table, both genomes validate
    against the contiguous oracle, and the Log has two correct entries."""
    space = dataclasses.replace(
        get_space("paged_flash_decode"),
        suite_shapes=({"batch": 2, "q_heads": 8, "kv_heads": 2,
                       "head_dim": 64, "seq": 100},))
    log = optimize(space, rounds=1, device="cpu")
    assert len(log.entries) == 2 and all(e.correct for e in log.entries)
    assert log.entries[0].code == space.baseline
    assert log.best().correct and log.speedup() >= 1.0


@pytest.mark.parametrize("kernel", PAPER)
def test_make_inputs_draws_from_numpy_on_the_asked_device(kernel):
    space = get_space(kernel)
    a = registry.make_inputs(kernel, space.suite_shapes[-1],
                             dtype=torch.bfloat16, seed=3, device="cpu")
    b = registry.make_inputs(kernel, space.suite_shapes[-1],
                             dtype=torch.bfloat16, seed=3, device="cpu")
    for x, y in zip(a.args, b.args):
        assert x.device.type == "cpu" and torch.equal(x, y)
    assert a.shape_info["dtype"] == torch.bfloat16
    if kernel == "merge_attn_states_lse":
        va, sa, vb, sb = a.args
        assert va.dtype == vb.dtype == torch.bfloat16
        assert sa.dtype == sb.dtype == torch.float32    # scores stay fp32
        assert torch.isneginf(sb).any() and not torch.isneginf(sa).any()


# ----------------------------------------------------------------- policy

def _profiles(lat, dominant, pressure, infeasible=False, noise=0.004):
    signals = {"mem_frac": 0.5, "compute_frac": 0.3, "overhead_frac": 0.2,
               "infeasible": infeasible}
    mine = agents.Profile([], lat, dominant,
                          dict(signals, smem_frac=pressure), noise)
    ref = jagents.Profile([], lat, dominant,
                          dict(signals, vmem_frac=pressure), noise)
    return mine, ref


def _at_targets(space):
    g = space.baseline
    for k in space.knobs:
        if k.kind == "bool" and k.target is not None:
            g = space.mutate(g, k, k.target)
    return g


def _first_bool(space):
    return next(k for k in space.knobs if k.kind == "bool")


POLICY_CASES = ("compute_low_pressure", "memory_mid_pressure",
                "overhead_infeasible", "regressed", "failed", "exhausted")


def _policy_case(case, space, pkg):
    """(genome, passed, profile, history) in package ``pkg`` (0 port,
    1 JAX), from one description."""
    Sug = (agents.Suggestion, jagents.Suggestion)[pkg]
    base = space.baseline
    if case == "compute_low_pressure":
        p = _profiles(10.0, "compute", 0.1)[pkg]
        return base, True, p, [dict(variant=base, passed=True, profile=p,
                                    suggestion=None)]
    if case == "memory_mid_pressure":
        p = _profiles(10.0, "memory", 0.5)[pkg]
        return base, True, p, [dict(variant=base, passed=True, profile=p,
                                    suggestion=None)]
    if case == "overhead_infeasible":
        p = _profiles(1e9, "overhead", 1.5, infeasible=True)[pkg]
        return base, True, p, [dict(variant=base, passed=True, profile=p,
                                    suggestion=None)]
    knob = _first_bool(space)
    child = space.mutate(base, knob, not getattr(base, knob.name))
    p0 = _profiles(10.0, "memory", 0.5)[pkg]
    if case == "regressed":
        p1 = _profiles(12.0, "memory", 0.5)[pkg]
        passed = True
    elif case == "failed":
        p1 = _profiles(9.0, "compute", 0.5)[pkg]
        passed = False
    else:                                           # exhausted
        opt = _at_targets(space)
        p = _profiles(5.0, "overhead", 0.5)[pkg]
        return opt, True, p, [dict(variant=opt, passed=True, profile=p,
                                   suggestion=None)]
    sug = Sug(knob.name, getattr(child, knob.name), "move")
    hist = [dict(variant=base, passed=True, profile=p0, suggestion=None),
            dict(variant=child, passed=passed, profile=p1, suggestion=sug)]
    return child, passed, p1, hist


@pytest.mark.parametrize("case", POLICY_CASES)
@pytest.mark.parametrize("kernel", PAPER)
def test_policy_makes_the_jax_moves(kernel, case):
    """On the JAX package's knob definitions (the port's launch knobs
    take other ranges, and rmsnorm one more knob: test_registry_...)."""
    spaces = (jax_knobs(kernel), jregistry.get_space(kernel))
    moves = []
    for pkg, backend in ((0, policy.PolicyBackend()),
                         (1, jpolicy.PolicyBackend())):
        genome, passed, prof, hist = _policy_case(case, spaces[pkg], pkg)
        one = backend.plan(spaces[pkg], genome, passed, prof, hist)
        many = backend.plan_many(spaces[pkg], genome, passed, prof, hist,
                                 k=4)
        moves.append(((one.knob, one.value),
                      [(s.knob, s.value) for s in many]))
    assert moves[0] == moves[1]


# ------------------------------------------------------- strategy parity

@dataclasses.dataclass(frozen=True)
class ToyVariant:
    name: str = "baseline"
    block: int = 16
    fused: bool = False
    fast: bool = False
    risky: bool = False


TOY_KNOBS = (("fused", "bool", 8, 1024, ("memory", "overhead"), True),
             ("block", "pow2", 8, 256, ("overhead",), None),
             ("fast", "bool", 8, 1024, ("compute",), True),
             ("risky", "bool", 8, 1024, ("compute",), True))


def toy_latency(v) -> float:
    return (20.0 - 7.0 * v.fused - 2.0 * v.fast - 1.5 * v.risky
            + 0.5 * abs(math.log2(v.block) - 5))


def toy_dominant(v) -> str:
    return "memory" if not v.fused else ("compute" if not v.fast
                                         else "overhead")


def toy_wrong(v) -> bool:
    """The genomes whose output is wrong: risky with big blocks."""
    return v.risky and v.block >= 32


def make_stub(pkg):
    Profile = (agents.Profile, jagents.Profile)[pkg]
    key = ("smem_frac", "vmem_frac")[pkg]

    class StubProfiler:
        reps = 100

        def profile(self, space, variant, tests):
            lat = toy_latency(variant)
            rows = [{"name": t.name, "latency_us": lat * (1 + 0.1 * i)}
                    for i, t in enumerate(tests)]
            return Profile(rows, lat, toy_dominant(variant),
                           {"mem_frac": 0.4, "compute_frac": 0.3,
                            "overhead_frac": 0.3,
                            key: 0.1 if variant.block < 64 else 0.5,
                            "infeasible": variant.block > 128},
                           0.01)
    return StubProfiler()


def toy_space(pkg, name="toy_parity"):
    """The toy space and a testing agent that hands out its three cases,
    in package ``pkg`` (0 port, 1 JAX)."""
    if pkg == 0:
        mk_space, mk_knob, mk_case = KernelSpace, Knob, TestCase
        data = [torch.arange(4, dtype=torch.float32) + i for i in range(3)]

        def run(v, x):
            return x * (1.5 if toy_wrong(v) else 1.0)
        tester_cls, kw = TestingAgent, dict(dtypes=(torch.float32,),
                                            device="cpu")
        dtype = torch.float32
    else:
        mk_space, mk_knob, mk_case = (jregistry.KernelSpace, jregistry.Knob,
                                      jregistry.TestCase)
        data = [jnp.arange(4, dtype=jnp.float32) + i for i in range(3)]

        def run(v, x, interpret=True):
            return x * (1.5 if toy_wrong(v) else 1.0)
        tester_cls, kw = jagents.TestingAgent, dict(dtypes=(jnp.float32,))
        dtype = jnp.float32
    tests = [mk_case(f"t{i}", (x,), {"dtype": dtype})
             for i, x in enumerate(data)]
    knobs = tuple(mk_knob(n, kind, lo, hi, attacks=a, target=t)
                  for n, kind, lo, hi, a, t in TOY_KNOBS)
    space = mk_space(name=name, baseline=ToyVariant(), run=run,
                     oracle=lambda x: x, cost=None, knobs=knobs,
                     suite_shapes=({"toy": 3},))

    class ToyTester(tester_cls):
        def generate_tests(self, space):
            return list(tests)
    return space, ToyTester(**kw)


def run_toy(pkg, strategy, rounds=4):
    (clear_suite_memos, jregistry.clear_suite_memos)[pkg]()
    space, tester = toy_space(pkg)
    orch_cls = (SearchOrchestrator, jsearch.SearchOrchestrator)[pkg]
    cache_cls = (EvalCache, jsearch.EvalCache)[pkg]
    orch = orch_cls(testing=tester, profiling=make_stub(pkg),
                    cache=cache_cls())
    log = orch.search(space, strategy=strategy, rounds=rounds)
    rows = [(e.round, genome_key(e.code), bool(e.correct),
             e.perf.geomean_latency_us, e.perf.dominant)
            for e in log.entries]
    return rows, log.meta["stages"]


@pytest.mark.parametrize("strategy", ["greedy", "beam", "population"])
def test_strategies_give_the_jax_logs(strategy):
    def make(pkg):
        if strategy == "beam":
            return (BeamSearch, jsearch.BeamSearch)[pkg](width=4)
        if strategy == "population":
            return (Population, jsearch.Population)[pkg](size=4, seed=3)
        return "greedy"

    mine, mine_stages = run_toy(0, make(0))
    ref, ref_stages = run_toy(1, make(1))
    assert mine == ref
    assert mine_stages == {k: ref_stages[k] for k in mine_stages}
    assert len(mine) > 1
    if strategy != "greedy":
        # the toy's wrong genomes were reached, validated and rejected
        assert any(not ok for _, _, ok, _, _ in mine)


# -------------------------------------------------- evaluator and cache

def _cost_for(latency_us: float) -> costmodel.Cost:
    """A Cost whose latency is ~``latency_us`` (memory bound)."""
    return costmodel.Cost(
        dram_bytes=(latency_us * 1e-6 - costmodel.LAUNCH_S)
        * costmodel.HBM_BW, blocks=costmodel.SMS)


def eval_space(name, *, cost=None, n_tests=2, wrong=False):
    """A feasible-by-default toy space whose kernel matches its oracle."""
    val = torch.arange(8, dtype=torch.float32)
    space = KernelSpace(
        name=name, baseline=ToyVariant(),
        run=lambda variant, *a: val + (1.0 if wrong else 0.0),
        oracle=lambda *a: val,
        cost=cost or (lambda variant, **kw: _cost_for(10.0 * variant.block
                                                      / 16)),
        knobs=(), suite_shapes=())
    return space, [TestCase(f"t{i}", (), {"dtype": torch.float32})
                   for i in range(n_tests)]


class RefusingTester(TestingAgent):
    """A testing agent that must never be asked to validate."""

    def validate(self, *a, **kw):
        raise AssertionError("a screened genome reached validation")


class CountingTester(TestingAgent):
    def __init__(self, **kw):
        super().__init__(device="cpu", **kw)
        self.calls = 0
        self._count_lock = threading.Lock()

    def validate(self, *a, **kw):
        with self._count_lock:
            self.calls += 1
        return super().validate(*a, **kw)


def test_infeasible_genome_is_screened_never_validated():
    def cost(variant, **kw):
        return merge_attn_states.cost(
            dataclasses.replace(merge_attn_states.BASELINE, block_rows=64),
            rows=64, d=128, dtype=torch.float32)
    space, tests = eval_space("toy_infeasible", cost=cost)
    ev, cache = TieredEvaluator(), EvalCache()
    kw = dict(testing=RefusingTester(device="cpu"),
              profiling=ProfilingAgent(), cache=cache)
    res = ev.evaluate(space, space.baseline, tests, **kw)
    assert res.screened and not res.validated and not res.passed
    assert res.profile.signals["infeasible"]
    assert ev.stats.screened_infeasible == 1
    assert ev.stats.validation_test_runs == 0
    again = ev.evaluate(space, space.baseline, tests, **kw)
    assert again.cached and again.screened and not again.validated


def test_dominated_genome_is_screened_after_a_validated_best():
    space, tests = eval_space("toy_dominated")
    ev, cache = TieredEvaluator(dominate_factor=3.0), EvalCache()
    kw = dict(testing=cpu_tester(), profiling=ProfilingAgent(),
              cache=cache)
    good = ev.evaluate(space, ToyVariant(block=16), tests, **kw)   # ~10us
    assert good.validated and good.passed
    bad = ev.evaluate(space, ToyVariant(name="bad", block=256), tests, **kw)
    assert bad.screened and not bad.validated
    assert ev.stats.screened_dominated == 1
    # 2x worse is not "clearly dominated" at factor 3: it still validates
    meh = ev.evaluate(space, ToyVariant(name="meh", block=32), tests, **kw)
    assert meh.validated and not meh.screened


def test_smoke_stage_charges_one_test_for_a_broken_genome():
    space, tests = eval_space("toy_broken", n_tests=4, wrong=True)
    ev, cache = TieredEvaluator(), EvalCache()
    res = ev.evaluate(space, space.baseline, tests, testing=cpu_tester(),
                      profiling=ProfilingAgent(), cache=cache)
    assert res.validated and not res.passed and not res.screened
    assert ev.stats.validation_test_runs == 1       # smoke only, not 4
    assert ev.stats.validations_smoke_failed == 1
    assert ev.stats.validations_full == 0


def test_oracle_outputs_memoized_per_suite():
    space, tests = eval_space("toy_oracle_memo", n_tests=3)
    outs, computed = oracle_outputs(space, tests, digest="d1")
    assert computed and len(outs) == 3
    outs2, computed2 = oracle_outputs(space, tests, digest="d1")
    assert not computed2 and outs2 is outs
    _, computed3 = oracle_outputs(space, tests, digest="d2")
    assert computed3


def test_suite_tests_memoized_per_kernel_agent_and_device():
    clear_suite_memos()
    space = reduced("silu_and_mul")
    t1 = suite_tests(space, cpu_tester(dtypes=(torch.float32,)))
    t2 = suite_tests(space, cpu_tester(dtypes=(torch.float32,)))
    assert t1[0] is t2[0]
    t3 = suite_tests(space, cpu_tester(dtypes=(torch.float32,), seed=7))
    assert t3[0] is not t1[0]
    assert [t.name for t in t1] == ["[16,4096]", "[17,11008]"]


def test_evaluation_is_race_free():
    """8 racing threads asking the evaluator for one genome: one profile,
    one validation of each test, 7 cache hits."""
    space, tests = eval_space("toy_race")

    class SlowTester(CountingTester):
        def validate(self, *a, **kw):
            time.sleep(0.05)                # hold the key lock long enough
            return super().validate(*a, **kw)

    tester, profiler, cache = SlowTester(), ProfilingAgent(), EvalCache()
    ev = TieredEvaluator()
    barrier = threading.Barrier(8)
    results = [None] * 8

    def worker(i):
        barrier.wait(timeout=10)
        results[i] = ev.evaluate(space, space.baseline, tests,
                                 testing=tester, profiling=profiler,
                                 cache=cache)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=20)
    assert not any(t.is_alive() for t in threads)
    assert tester.calls == len(tests)
    assert cache.max_evals_per_genome() == 1
    assert ev.stats.profile_runs == 1
    assert cache.stats()["hits"] == 7 and cache.stats()["misses"] == 1
    assert all(r.passed for r in results)


def test_evaluate_many_is_parallel_deterministic_and_dedups():
    space, tests = eval_space("toy_many")
    # equal genomes under other names: the first of each computes the
    # entry, as in the serial run (its name seeds the analytic noise)
    variants = [ToyVariant(name=f"v{i}", block=k)
                for i, k in enumerate((16, 32, 16, 64, 32))]
    serial = TieredEvaluator().evaluate_many(
        space, variants, tests, testing=cpu_tester(),
        profiling=ProfilingAgent(), cache=EvalCache(), workers=1)
    cache = EvalCache()
    parallel = TieredEvaluator().evaluate_many(
        space, variants, tests, testing=CountingTester(),
        profiling=ProfilingAgent(), cache=cache, workers=4)
    for s, p in zip(serial, parallel):
        assert (s.passed, s.validated, s.screened) == \
            (p.passed, p.validated, p.screened)
        assert s.profile.geomean_latency_us == p.profile.geomean_latency_us
    assert cache.max_evals_per_genome() == 1
    assert len(cache) == 3 and cache.stats()["hits"] == 2


@pytest.mark.parametrize("module", [fused_add_rmsnorm, silu_and_mul],
                         ids=lambda m: m.__name__.split(".")[-1])
def test_block_rows_launches_nothing_new_at_the_suite_shapes(module):
    """No launch knob is inert: each legal value of each of them (rows and
    threads of a block) launches other code than every other value at
    some suite shape, in some dtype; a bool flag changes the launch too."""
    space = get_space(module.__name__.split(".")[-1])
    infos = [module.make_inputs(shape, dtype=dtype).shape_info
             for shape in module.SUITE_SHAPES
             for dtype in (torch.float32, torch.bfloat16)]
    knobs = [k for k in space.knobs if k.kind == "pow2"]
    assert {k.name for k in knobs} == set(
        PORT_LAUNCH_KNOBS[space.name])
    for knob in knobs:
        values = [1 << b for b in range(knob.lo.bit_length() - 1,
                                        knob.hi.bit_length())]
        keys = [tuple(space.launch_key(dataclasses.replace(
                    space.shipped, **{knob.name: v}), **info)
                      for info in infos) for v in values]
        assert len(set(keys)) == len(values), knob.name
        feasible = []
        for v in values:
            g = dataclasses.replace(space.shipped, **{knob.name: v})
            n = 0
            for info in infos:
                try:
                    space.cost(g, **info)
                    n += 1
                except costmodel.Infeasible:
                    pass
            feasible.append(n)
        assert max(feasible) == len(infos)   # some value runs everywhere
    flag = next(k for k in space.knobs if k.kind == "bool")
    moved = dataclasses.replace(
        space.shipped, **{flag.name: not getattr(space.shipped, flag.name)})
    assert space.launch_key(moved, **infos[0]) != \
        space.launch_key(space.shipped, **infos[0])


def test_a_move_that_launches_the_same_code_is_a_cache_hit():
    """accum_fp32 launches the same kernel for fp32 inputs (the add is in
    fp32 either way), so moving it on an fp32 suite is a cache hit."""
    space = reduced("fused_add_rmsnorm")
    tests = suite_tests(space, cpu_tester(dtypes=(torch.float32,)))
    ev, cache = TieredEvaluator(), EvalCache()
    kw = dict(testing=cpu_tester(), profiling=ProfilingAgent(), cache=cache)
    first = ev.evaluate(space, fused_add_rmsnorm.OPTIMIZED, tests, **kw)
    same = ev.evaluate(space, dataclasses.replace(
        fused_add_rmsnorm.OPTIMIZED, name="moved", accum_fp32=False), tests,
        **kw)
    assert not first.cached and same.cached
    assert same.profile.geomean_latency_us == \
        first.profile.geomean_latency_us
    other = ev.evaluate(space, fused_add_rmsnorm.BASELINE, tests, **kw)
    assert not other.cached
    assert ev.stats.profile_runs == 2 and cache.max_evals_per_genome() == 1


SERVE_WIDTHS = (896, 2560, 4864, 6912)


def _shapes(module):
    """(rows, d) of the suite and of the serve paths (decode, prefill)."""
    return [(s["batch"], s["hidden"]) for s in module.SUITE_SHAPES] + [
        (rows, d) for rows in (8, 4096) for d in SERVE_WIDTHS]


def test_rmsnorm_launch_shape_holds_the_row_in_the_block():
    """Every value of the launch knobs at every suite and serve shape: a
    row gets whole warps, at most ``row_threads`` of them, holding all its
    vectors at a power-of-two count a thread; a block stays within its
    thread limit and 16 row groups; the cost screens exactly the genomes
    the wrapper refuses."""
    from repro_torch.kernels.fused_add_rmsnorm import (NV_MAX, block_limit,
                                                       launch_shape, why_not)
    n = 0
    for rt in (32, 64, 128, 256, 512, 1024):
        for br in (1, 2, 4, 8, 16):
            for two in (False, True):
                g = dataclasses.replace(fused_add_rmsnorm.OPTIMIZED,
                                        row_threads=rt, block_rows=br,
                                        two_pass=two)
                for rows, d in _shapes(fused_add_rmsnorm):
                    for dtype in (torch.float32, torch.bfloat16):
                        item = dtype.itemsize
                        vec = costmodel.vector_elems(d, item)
                        tpr, groups, per_block, nv = launch_shape(
                            g, rows, d, vec, item)
                        assert tpr % 32 == 0 and tpr <= rt
                        assert 1 <= groups <= min(16, per_block)
                        assert per_block == min(br, rows)
                        why = why_not(g, rows, d, vec, item)
                        try:
                            fused_add_rmsnorm.cost(g, rows=rows, d=d,
                                                   dtype=dtype)
                            assert why is None
                        except costmodel.Infeasible:
                            assert why is not None
                        if two or why:
                            continue
                        n += 1
                        assert nv & (nv - 1) == 0 and nv <= NV_MAX
                        assert nv * tpr * vec >= d > nv * (tpr - 32) * vec
                        assert tpr * groups <= block_limit(vec, nv, item)
    assert n > 300


def test_silu_launch_shape_is_one_wave_of_steps():
    """A block of ``block_cols`` threads, a step of ``block_rows`` rows,
    the column blocks that cover a row and at most one wave of blocks (or
    one step block); a step of 16 rows holds a block to 256 threads."""
    from repro_torch.kernels.silu_and_mul import (block_limit, launch_shape,
                                                  why_not)
    for br in (1, 2, 4, 8, 16):
        for bc in (32, 64, 128, 256, 512, 1024):
            g = dataclasses.replace(silu_and_mul.OPTIMIZED, block_rows=br,
                                    block_cols=bc)
            for rows, d in _shapes(silu_and_mul):
                threads, step, cols, steps = launch_shape(g, rows, d, 8)
                assert (threads, step) == (bc, br)
                assert (cols - 1) * bc < d // 8 <= cols * bc
                assert 1 <= steps <= -(-rows // br)
                assert steps == 1 or cols * steps <= \
                    costmodel.SMS * 2048 // bc
            assert (why_not(g, 8) is None) == (bc <= block_limit(8, br))
    assert block_limit(8, 16) == 256 and block_limit(1, 16) == 1024


def test_a_suite_on_the_card_is_evaluated_one_genome_at_a_time(
        monkeypatch):
    """Work launched from another thread would land inside a timing's
    events on the card's one stream, so evaluate_many keeps a card suite
    on the calling thread whatever ``workers`` says."""
    space, tests = eval_space("toy_on_card")
    variants = [ToyVariant(name=f"v{k}", block=k) for k in (16, 32, 64)]

    class ThreadRecorder(CountingTester):
        def __init__(self):
            super().__init__()
            self.threads = set()

        def validate(self, *a, **kw):
            self.threads.add(threading.get_ident())
            return super().validate(*a, **kw)

    on_cpu = ThreadRecorder()
    TieredEvaluator().evaluate_many(
        space, variants, tests, testing=on_cpu, profiling=ProfilingAgent(),
        cache=EvalCache(), workers=4)
    assert on_cpu.threads - {threading.get_ident()}   # the pool ran them
    monkeypatch.setattr(evaluator_mod, "on_card", lambda tests: True)
    on_card = ThreadRecorder()
    results = TieredEvaluator().evaluate_many(
        space, variants, tests, testing=on_card, profiling=ProfilingAgent(),
        cache=EvalCache(), workers=4)
    assert on_card.threads == {threading.get_ident()}
    assert on_card.calls == len(variants) * len(tests)
    assert all(r.passed for r in results)


def test_persistent_cache_round_trips_across_processes(tmp_path):
    path = str(tmp_path / "evalcache.jsonl")
    testing = cpu_tester(dtypes=(torch.float32,))
    space = reduced("silu_and_mul")
    log1 = SearchOrchestrator(testing=testing,
                              cache=EvalCache(persist_path=path)).search(
        space, rounds=3)
    assert log1.meta["cache"]["misses"] > 0
    cache2 = EvalCache(persist_path=path)       # a second process
    assert cache2.preloaded == log1.meta["cache"]["entries"]
    log2 = SearchOrchestrator(testing=testing, cache=cache2).search(
        space, rounds=3)
    assert log2.meta["cache"]["misses"] == 0
    assert log2.meta["stages"]["validation_test_runs"] == 0
    b1, b2 = log1.best(), log2.best()
    assert b1.code.describe() == b2.code.describe()
    assert b1.perf.geomean_latency_us == b2.perf.geomean_latency_us


def test_persistent_cache_skips_stale_salt_other_cards_and_torn_lines(
        tmp_path):
    path = str(tmp_path / "evalcache.jsonl")
    space, tests = eval_space("toy_persist")
    cache = EvalCache(persist_path=path)
    TieredEvaluator().evaluate(space, space.baseline, tests,
                               testing=cpu_tester(),
                               profiling=ProfilingAgent(), cache=cache)
    with open(path) as f:
        line = f.read().strip()
    salt = cache_mod.code_version_salt()
    assert salt in line and f'"device": "{cache.device}"' in line
    with open(path, "a") as f:
        f.write(line.replace(salt, "deadbeef0000") + "\n")
        f.write(line.replace(f'"device": "{cache.device}"',
                             '"device": "another card"') + "\n")
        f.write('{"torn": \n')
    with pytest.warns(UserWarning):
        reloaded = EvalCache(persist_path=path)
    assert reloaded.preloaded == 1


def test_salt_covers_the_cuda_sources_and_changes_with_them(tmp_path):
    files = cache_mod.salt_files()
    names = {p.split("/")[-1] for p in files}
    assert {"merge_attn_states.cu", "silu_and_mul.cu",
            "fused_add_rmsnorm.cu", "common.cuh", "costmodel.py",
            "agents.py", "merge_attn_states.py"} <= names
    copies = []
    for p in files:
        dst = tmp_path / f"{len(copies)}_{p.split('/')[-1]}"
        shutil.copy(p, dst)
        copies.append(str(dst))
    before = cache_mod.source_digest(copies)
    cu = next(c for c in copies if c.endswith("merge_attn_states.cu"))
    with open(cu, "a") as f:
        f.write("// edited\n")
    assert cache_mod.source_digest(copies) != before


# ------------------------------------------------ Algorithm 1 on the CPU

@pytest.fixture(scope="module")
def cpu_logs():
    """Two greedy runs of each paper kernel on reduced suites, fp32 and
    bf16, analytic backend."""
    runs = []
    for _ in range(2):
        orch = SearchOrchestrator(device="cpu")
        runs.append({k: orch.search(reduced(k), rounds=5) for k in PAPER})
    return runs


@pytest.mark.parametrize("kernel", PAPER)
def test_algorithm1_on_the_analytic_backend(cpu_logs, kernel):
    log, again = cpu_logs[0][kernel], cpu_logs[1][kernel]
    assert [e.round for e in log.entries] == list(range(6))
    rows = [(e.code.describe(), e.correct, e.perf.geomean_latency_us,
             e.max_err, e.rationale) for e in log.entries]
    assert rows == [(e.code.describe(), e.correct,
                     e.perf.geomean_latency_us, e.max_err, e.rationale)
                    for e in again.entries]
    assert log.best().correct
    assert log.speedup() >= 1.0
    assert log.meta["device"] == "cpu"
    assert log.meta["cache"]["max_evals_per_genome"] <= 1
    for e in log.entries[1:]:
        assert e.correct and 0 <= e.max_err <= 1.0
    assert "astra" not in log.table()       # a table of its own moves


def test_reintegration_installs_the_best_genomes(cpu_logs, monkeypatch):
    monkeypatch.setattr(ops, "_OVERRIDES", {})
    reintegrate(cpu_logs[0])
    for k, log in cpu_logs[0].items():
        assert ops.get_variant(k) == log.best().code
    v, s = torch.randn(3, 2, 64), torch.randn(3, 2)
    got = ops.merge_attn_states_lse(v, s, v, s)
    want = merge_attn_states.plain(cpu_logs[0]["merge_attn_states_lse"]
                                   .best().code, v, s, v, s)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_cpu_search_never_touches_the_kernel_library(monkeypatch):
    def refuse():
        raise AssertionError("the CUDA library was loaded for a CPU search")

    monkeypatch.setattr(_build, "library", refuse)
    before = ops.launch_counts()
    log = optimize(reduced("fused_add_rmsnorm"), rounds=2, device="cpu",
                   testing=cpu_tester(dtypes=(torch.float32,)))
    assert log.best().correct
    sa = optimize_single_agent("silu_and_mul", rounds=3, device="cpu")
    assert len(sa.entries) == 4 and sa.final_variant.name.endswith(
        "_single_agent")
    assert ops.launch_counts() == before


def test_single_agent_rejects_a_genome_that_cannot_launch_unrun(
        monkeypatch):
    """From a genome of 16 rows a step, the single agent's checklist
    doubles silu's threads a block to 512, which a block cannot hold: that
    round fails without validation (on the card the wrapper would raise),
    as the loop's evaluator screens it, and the agent ships its last
    accepted genome."""
    validated = []
    real = TestingAgent.validate

    def spy(self, space, variant, tests, **kw):
        validated.append(variant)
        return real(self, space, variant, tests, **kw)

    monkeypatch.setattr(TestingAgent, "validate", spy)
    space = get_space("silu_and_mul")
    space = dataclasses.replace(space, baseline=dataclasses.replace(
        space.baseline, block_rows=16))
    log = optimize_single_agent(space, rounds=5, device="cpu")
    last = log.entries[-1]
    assert "block_cols=512" in last.rationale and not last.correct
    assert all(v.block_cols <= 256 for v in validated)
    assert log.final_variant.block_cols == 256


def test_entry_points_need_a_gpu_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        SearchOrchestrator()
    with pytest.raises(RuntimeError):
        TestingAgent()
    with pytest.raises(RuntimeError):
        ProfilingAgent(backend="cuda")
    with pytest.raises(RuntimeError):
        optimize_single_agent("silu_and_mul")
    with pytest.raises(RuntimeError):
        registry.make_inputs("silu_and_mul", {"batch": 2, "hidden": 8})
    SearchOrchestrator(device="cpu")
    ProfilingAgent(backend="analytic")
    with pytest.raises(RuntimeError):
        SearchOrchestrator(isolation="process")
    with pytest.raises(RuntimeError):
        EvalWorkerPool()
    SearchOrchestrator(device="cpu", isolation="process")


# ------------------------------------------------------ the H100 model

def test_cost_model_is_calibrated_on_the_decode_rmsnorm():
    """The shipped rmsnorm at 8 x 896 bf16 took 1.70 us on the H100 in a
    graph (one block of 128 threads a row, one round trip), the empty
    kernel 0.99 us: the launch floor, one round trip and the bytes."""
    c = fused_add_rmsnorm.cost(fused_add_rmsnorm.OPTIMIZED, rows=8, d=896,
                               dtype=torch.bfloat16)
    assert c.latency_s * 1e6 == pytest.approx(1.70, abs=0.01)
    assert costmodel.LAUNCH_S == pytest.approx(0.99e-6)
    assert c.round_trips == 1 and c.overhead_s == pytest.approx(
        costmodel.LAUNCH_S + costmodel.ROUND_TRIP_S)
    assert fused_add_rmsnorm.launch_shape(
        fused_add_rmsnorm.OPTIMIZED, 8, 896, 8, 2) == (128, 1, 1, 1)
    assert c.blocks == 8 and c.threads == 128


def test_cost_model_screens_what_cannot_launch_and_has_no_tpu_terms():
    for rows in (32, 16, 8):
        merge_attn_states.cost(dataclasses.replace(
            merge_attn_states.OPTIMIZED, block_rows=rows), rows=700,
            d=128, dtype=torch.bfloat16)
    with pytest.raises(costmodel.Infeasible):
        merge_attn_states.cost(dataclasses.replace(
            merge_attn_states.OPTIMIZED, block_rows=64), rows=700, d=128,
            dtype=torch.bfloat16)
    names = set(vars(costmodel))
    assert not names & {"VMEM_BYTES", "DMA_GRANULE", "PEAK_MXU_BF16",
                        "STEP_OVERHEAD_S", "ICI_BW"}
    assert costmodel.SMS == 132 and costmodel.HBM_BW == 3.35e12
    # hoisting cuts the special-function work of the merge: once per row
    # on a warp instead of once per element
    base = merge_attn_states.cost(merge_attn_states.BASELINE, rows=24576,
                                  d=256, dtype=torch.bfloat16)
    opt = merge_attn_states.cost(merge_attn_states.OPTIMIZED, rows=24576,
                                 d=256, dtype=torch.bfloat16)
    assert base.sfu_ops > 4 * opt.sfu_ops
    assert base.dominant() == "compute" and opt.dominant() == "memory"


def test_profiling_noise_scales_with_reps():
    space = reduced("silu_and_mul")
    tests = cpu_tester(dtypes=(torch.float32,)).generate_tests(space)
    sloppy = ProfilingAgent(reps=1).profile(space, space.baseline, tests)
    careful = ProfilingAgent(reps=100).profile(space, space.baseline, tests)
    assert sloppy.noise_scale == pytest.approx(careful.noise_scale * 10)
    assert set(careful.signals) == {"mem_frac", "compute_frac",
                                    "overhead_frac", "waste_frac",
                                    "smem_frac", "infeasible"}


def test_log_and_planner_surface(cpu_logs):
    log = cpu_logs[0]["silu_and_mul"]
    assert '"entries"' in log.to_json()
    assert isinstance(PlanningAgent().backend, policy.PolicyBackend)
    with pytest.raises(NotImplementedError):
        policy.LLMBackend()
    space = get_space("silu_and_mul")
    moved = CodingAgent().apply(space, space.baseline,
                                agents.Suggestion("block_rows", 3, "x"))
    assert moved.block_rows == 4            # clamped to a power of two
    moved = CodingAgent().apply(space, space.baseline,
                                agents.Suggestion("block_rows", 100, "x"))
    assert moved.block_rows == 16           # ... and to the knob's range
    assert np.isfinite(log.best().perf.geomean_latency_us)
