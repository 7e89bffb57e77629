"""Sampling, streaming and scheduling of the PyTorch port against the JAX
package, on the CPU at the reduced qwen2-0.5b config (the counterparts of
``tests/test_sampling.py``).

* ``SamplingParams`` validation; the port's noise is JAX's: the threefry
  bits of ``fold_in(PRNGKey(seed), t)`` bit for bit, the Gumbel noise to
  fp32 rounding; the draw equals JAX's ``sample_tokens`` on the same
  logits and the same noise over temperature / top-k / top-p grids with
  tied logits, and on the noise each side draws itself.
* Seeded streams (fp32, JAX ``PRNGKey(0)`` weights): equal to the JAX
  engine's, and a pure function of ``(seed, t)``: across restarts, the
  paged and contiguous managers, and swap and recompute preemption. The
  greedy rows of a mixed batch equal a greedy-only run; the step flips
  to the draw once; ``readbacks == steps`` with sampling on.
* Priority, SJF and FCFS admission (pop by identity, FCFS never
  reorders), ``sched_reorders`` equal to the JAX engine's; ``generate``
  and ``stream`` agree, terminal sentinel included; successive waves.
* The ``priority_mix`` golden (bf16, JAX ``PRNGKey(0)`` weights under the
  non-partitionable threefry): a port stream may leave the golden one only
  where the JAX top-2 logit margin is within the bf16 tolerance.

Tolerances: the noise rtol 1e-6 / atol 1e-6; bf16 3e-2 / 3e-2 (the JAX
package's ``core/agents.py``). Tokens, counters and streams: exact.
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
from repro.models import registry as jregistry  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.serving import sampling as jsampling  # noqa: E402
from repro.serving.cache_manager import (  # noqa: E402
    CacheConfig as JaxCacheConfig)
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.sampling import (  # noqa: E402
    SamplingParams as JaxSamplingParams)
from repro_torch import configs  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    CacheConfig, Engine, LLMEngine, PriorityScheduler, Request,
    SamplingParams, make_scheduler, sample_tokens)
from repro_torch.serving import sampling  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ARCH = "qwen2-0.5b"
BF16 = dict(rtol=3e-2, atol=3e-2)
LENS = [3, 5, 7, 9, 11, 4]
SP = dict(temperature=0.8, top_k=20, top_p=0.95, seed=7)


@pytest.fixture(scope="module")
def fp32():
    """(jax cfg, port cfg, jax params, port params on the CPU), fp32."""
    jcfg = dataclasses.replace(jconfigs.smoke(ARCH), dtype="float32")
    cfg = dataclasses.replace(configs.smoke(ARCH), dtype="float32")
    params, _ = jregistry.init(jcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, params), cfg,
                                      "cpu")
    return jcfg, cfg, params, tparams


def _requests(vocab, lens, *, max_new=4, sampling=None, prios=None,
              cls=Request, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid=rid, prompt=rng.integers(0, vocab, (n,), dtype=np.int32),
                max_new_tokens=max_new,
                sampling=sampling[rid] if isinstance(sampling, list)
                else sampling, priority=prios[rid] if prios else 0)
            for rid, n in enumerate(lens)]


def _streams(eng, vocab, lens, **kw):
    for r in _requests(vocab, lens, **kw):
        eng.submit(r)
    while eng.has_work() and eng.step():
        if eng.cm.paged:
            eng.check_pool()
    eng.run()
    return {r.rid: list(r.out_tokens) for r in eng.finished}


def _port(fp32, **kw):
    _, cfg, _, tparams = fp32
    return Engine(tparams, cfg, slots=3, max_seq=64, device="cpu", **kw)


# -- SamplingParams and the draw ---------------------------------------------

def test_sampling_params_validation():
    assert SamplingParams().greedy and sampling.GREEDY.greedy
    assert not SamplingParams(temperature=0.7).greedy
    assert SamplingParams(seed=None).resolve_seed(5) == 5
    assert SamplingParams(seed=9).resolve_seed(5) == 9
    for bad in (dict(temperature=-0.1), dict(top_k=-1), dict(top_p=0.0),
                dict(top_p=1.5)):
        with pytest.raises(ValueError):
            SamplingParams(**bad)


SEEDS = [0, 7, -3, 123456789, 2**31 - 1]
INDICES = [0, 5, 1, 100000, 3]


def _keys(seeds, indices):
    return [jax.random.fold_in(jax.random.PRNGKey(s), t)
            for s, t in zip(seeds, indices)]


def test_noise_is_the_jax_noise():
    """The bits equal ``jax.random.bits`` of the same key (the default
    partitionable threefry); the Gumbel noise equals ``jax.random.gumbel``
    up to the rounding of ``log``."""
    seed = torch.tensor([s & 0xFFFFFFFF for s in SEEDS])
    index = torch.tensor(INDICES, dtype=torch.int32)
    bits = sampling.threefry_bits(seed, index, 1000).numpy()
    want = np.stack([np.asarray(jax.random.bits(k, (1000,)))
                     for k in _keys(SEEDS, INDICES)])
    np.testing.assert_array_equal(bits, want.astype(np.int64))
    noise = sampling.gumbel_noise(seed, index, 1000).numpy()
    want = np.stack([np.asarray(jax.random.gumbel(k, (1000,)))
                     for k in _keys(SEEDS, INDICES)])
    np.testing.assert_allclose(noise, want, rtol=1e-6, atol=1e-6)


def _grid_rows(vocab=64):
    """One row per (temperature, top_k, top_p) of the grid; the logits
    are rounded to one decimal so that rows have ties."""
    grid = [(t, k, p) for t in (0.0, 0.5, 1.0, 2.0) for k in (0, 1, 5)
            for p in (1.0, 0.9, 1e-9)]
    rng = np.random.default_rng(0)
    logits = np.round(rng.standard_normal((len(grid), vocab)) * 2, 1)
    temp, topk, topp = (np.array(c) for c in zip(*grid))
    return (logits.astype(np.float32), temp.astype(np.float32),
            topk.astype(np.int32), topp.astype(np.float32))


def test_draw_matches_jax_on_the_same_logits_and_noise(monkeypatch):
    logits, temp, topk, topp = _grid_rows()
    b, vocab = logits.shape
    seeds = list(range(100, 100 + b))
    idx = list(range(b))
    got = sample_tokens(torch.from_numpy(logits),
                        torch.tensor(seeds), torch.tensor(idx),
                        torch.from_numpy(temp), torch.from_numpy(topk),
                        torch.from_numpy(topp)).numpy()
    noise = sampling.gumbel_noise(torch.tensor(seeds), torch.tensor(idx),
                                  vocab).numpy()
    for row in range(b):
        # JAX draws row by row with the port's noise of that row
        monkeypatch.setattr(jax.random, "gumbel",
                            lambda key, shape, n=noise[row]: jnp.asarray(n))
        want = jsampling.sample_tokens(
            jnp.asarray(logits[row:row + 1]),
            jnp.stack([jax.random.PRNGKey(seeds[row])]),
            jnp.asarray([idx[row]], jnp.int32), jnp.asarray(temp[row:row + 1]),
            jnp.asarray(topk[row:row + 1]), jnp.asarray(topp[row:row + 1]))
        assert got[row] == int(want[0]), (row, temp[row], topk[row],
                                          topp[row])
    # rows that reduce to the argmax (greedy, top_k 1, a tiny top_p) take
    # the first maximum, as jnp.argmax does
    first_max = logits.argmax(-1)
    reduce = (temp == 0) | (topk == 1) | (topp < 1e-6)
    np.testing.assert_array_equal(got[reduce], first_max[reduce])


def test_top_p_keeps_the_tokens_before_the_mass_reaches_p():
    """Four equal logits have probabilities of exactly 1/4: at top_p 0.5
    the first two sorted tokens are kept (the mass before them is 0 and
    1/4) and the third, whose mass before it is exactly 0.5, is not."""
    n = 64
    logits = np.full((n, 32), -30.0, np.float32)
    logits[:, :4] = 1.0
    args = (np.arange(n), np.zeros(n, np.int32), np.ones(n, np.float32),
            np.full(n, 4, np.int32), np.full(n, 0.5, np.float32))
    got = sample_tokens(torch.from_numpy(logits),
                        *map(torch.from_numpy, args)).numpy()
    want = jsampling.sample_tokens(
        jnp.asarray(logits), jnp.stack([jax.random.PRNGKey(int(s))
                                        for s in args[0]]),
        *map(jnp.asarray, args[1:]))
    np.testing.assert_array_equal(got, np.asarray(want))
    assert set(got.tolist()) == {0, 1}


def test_draw_matches_jax_on_its_own_noise():
    """Without shared noise: each side draws its own (seed, t) noise."""
    logits, temp, topk, topp = _grid_rows(vocab=512)
    b = len(temp)
    seeds, idx = np.arange(b) * 7 + 1, np.arange(b) + 3
    got = sample_tokens(torch.from_numpy(logits), torch.from_numpy(seeds),
                        torch.from_numpy(idx.astype(np.int32)),
                        torch.from_numpy(temp), torch.from_numpy(topk),
                        torch.from_numpy(topp)).numpy()
    want = jsampling.sample_tokens(
        jnp.asarray(logits), jnp.stack([jax.random.PRNGKey(int(s))
                                        for s in seeds]),
        jnp.asarray(idx, jnp.int32), jnp.asarray(temp), jnp.asarray(topk),
        jnp.asarray(topp))
    np.testing.assert_array_equal(got, np.asarray(want))


# -- seeded streams ----------------------------------------------------------

def test_seeded_streams_equal_jax_and_are_pure(fp32):
    """The JAX engine's streams; the same after a restart and on the
    contiguous manager; another seed diverges; greedy differs."""
    jcfg, cfg, params, _ = fp32
    jeng = JaxEngine(params, jcfg, slots=3, max_seq=64,
                     sampling=JaxSamplingParams(**SP))
    for r in _requests(jcfg.vocab, LENS, cls=JaxRequest):
        jeng.submit(r)
    jax_streams = {r.rid: list(r.out_tokens) for r in jeng.run()}
    sp = SamplingParams(**SP)
    a = _streams(_port(fp32, sampling=sp), cfg.vocab, LENS)
    assert a == jax_streams
    assert a == _streams(_port(fp32, sampling=sp), cfg.vocab, LENS)
    contig = _port(fp32, sampling=sp,
                   cache_manager=CacheConfig(paged=False))
    assert not contig.cm.paged
    assert a == _streams(contig, cfg.vocab, LENS)
    other = SamplingParams(**{**SP, "seed": 8})
    assert a != _streams(_port(fp32, sampling=other), cfg.vocab, LENS)
    assert a != _streams(_port(fp32), cfg.vocab, LENS)


@pytest.mark.parametrize("preemption", ["swap", "recompute"])
def test_seeded_streams_survive_preemption(fp32, preemption):
    """An oversubscribed pool (6 pages of 16) preempts sampled requests;
    their streams equal the never-preempted contiguous ones."""
    _, cfg, _, _ = fp32
    lens, sp = [30, 25, 28, 21, 26], SamplingParams(**SP)
    eng = _port(fp32, sampling=sp, preemption=preemption,
                cache_manager=CacheConfig(page_size=16, num_pages=6))
    preempted = _streams(eng, cfg.vocab, lens, max_new=20)
    st = eng.stats()
    assert st["preemptions"] >= 1 and st["preempt_mode"] == preemption
    plain = _streams(_port(fp32, sampling=sp,
                           cache_manager=CacheConfig(paged=False)),
                     cfg.vocab, lens, max_new=20)
    assert preempted == plain


def test_greedy_rows_of_a_mixed_batch_equal_a_greedy_run(fp32):
    _, cfg, _, _ = fp32
    mixed = [SamplingParams(**{**SP, "seed": rid}) if rid % 2 else None
             for rid in range(len(LENS))]
    eng = _port(fp32)
    got = _streams(eng, cfg.vocab, LENS, max_new=8, sampling=mixed)
    greedy = _streams(_port(fp32), cfg.vocab, LENS, max_new=8)
    assert eng.stats()["sampling_step"]
    for rid in range(0, len(LENS), 2):
        assert got[rid] == greedy[rid]
    assert any(got[rid] != greedy[rid] for rid in range(1, len(LENS), 2))


def test_the_step_flips_to_the_draw_once(fp32):
    """A greedy engine runs the argmax step until the first sampled
    admission, then the draw for good (one more capture on the card)."""
    _, cfg, _, _ = fp32
    eng = _port(fp32)
    kinds = []
    body = eng._step_body

    def spy():
        kinds.append(eng._variant_key()[0])
        body()
    eng._step_body = spy
    reqs = _requests(cfg.vocab, [5, 6, 7], max_new=6)
    reqs[1].sampling = SamplingParams(**SP)
    eng.submit(reqs[0])
    assert eng.step() and eng.step()
    for r in reqs[1:]:
        eng.submit(r)
    eng.run()
    flips = sum(a != b for a, b in zip(kinds, kinds[1:]))
    assert kinds[0] is True and kinds[-1] is False and flips == 1
    assert all(len(r.out_tokens) == 6 for r in eng.finished)


def test_sampling_keeps_one_overlapped_readback_a_step(fp32):
    _, cfg, _, _ = fp32
    eng = _port(fp32, sampling=SamplingParams(**SP))
    applies = []
    apply = eng._apply
    eng._apply = lambda pending: (applies.append(1), apply(pending))
    for r in _requests(cfg.vocab, [5, 6], max_new=6):
        eng.submit(r)
    overlapped = 0
    while eng.has_work() and eng.step():
        overlapped += eng._pending is not None
    eng.flush()
    st = eng.stats()
    assert len(applies) == st["readbacks"] == st["steps"] == overlapped
    assert all(len(r.out_tokens) == 6 for r in eng.finished)


# -- schedulers --------------------------------------------------------------

def test_priority_scheduler_orders_admission(fp32):
    _, cfg, _, tparams = fp32
    eng = Engine(tparams, cfg, slots=1, max_seq=64, device="cpu",
                 scheduler="priority")
    _streams(eng, cfg.vocab, [4, 4, 4], max_new=2, prios=[0, 2, 1])
    assert [r.rid for r in eng.finished] == [1, 2, 0]
    st = eng.stats()
    assert st["scheduler"] == "priority"
    assert st["sched_reorders"] == 2 and st["sched_admitted"] == 3


def test_sjf_scheduler_orders_by_job_size(fp32):
    _, cfg, _, tparams = fp32
    eng = Engine(tparams, cfg, slots=1, max_seq=64, device="cpu",
                 scheduler="sjf")
    _streams(eng, cfg.vocab, [12, 4, 8], max_new=2)
    assert [r.rid for r in eng.finished] == [1, 2, 0]
    assert eng.stats()["scheduler"] == "sjf"


def test_sorted_scheduler_pops_by_identity():
    sched = PriorityScheduler()
    a = Request(rid=0, prompt=np.array([1, 2, 3], np.int32), arrival=0)
    b = Request(rid=0, prompt=np.array([4, 5, 6], np.int32), arrival=1)
    sched.push(a)
    sched.push(b)
    assert sched.pop() is a and sched.pop() is b and len(sched) == 0
    sched.push(a)
    sched.requeue(b)                 # a preempted request goes first
    assert sched.peek() is b and sched.remove(b) and sched.pop() is a


def test_fcfs_never_reorders(fp32):
    _, cfg, _, tparams = fp32
    eng = Engine(tparams, cfg, slots=2, max_seq=64, device="cpu")
    _streams(eng, cfg.vocab, [4, 6, 5, 7], max_new=2)
    st = eng.stats()
    assert st["scheduler"] == "fcfs" and st["sched_reorders"] == 0
    with pytest.raises(ValueError):
        make_scheduler("lifo")


def test_sched_reorders_equal_jax(fp32):
    jcfg, cfg, params, tparams = fp32
    lens, prios = [5, 9, 4, 7, 6, 8, 3], [0, 2, 1, 2, 0, 1, 2]
    jeng = JaxEngine(params, jcfg, slots=2, max_seq=64, scheduler="priority",
                     cache_manager=JaxCacheConfig(prefix_cache=False))
    for r in _requests(jcfg.vocab, lens, max_new=3, prios=prios,
                       cls=JaxRequest):
        jeng.submit(r)
    jstreams = {r.rid: list(r.out_tokens) for r in jeng.run()}
    eng = Engine(tparams, cfg, slots=2, max_seq=64, device="cpu",
                 scheduler="priority")
    assert _streams(eng, cfg.vocab, lens, max_new=3, prios=prios) \
        == jstreams
    js, st = jeng.stats(), eng.stats()
    assert st["sched_reorders"] == js["sched_reorders"] > 0
    assert [r.rid for r in eng.finished] == [r.rid for r in jeng.finished]


# -- LLMEngine ---------------------------------------------------------------

def test_generate_and_stream_agree(fp32):
    _, cfg, _, tparams = fp32
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, (n,), dtype=np.int32)
               for n in [4, 7, 5]] + [np.arange(70) % cfg.vocab]
    sp = SamplingParams(**SP)
    outs = LLMEngine(tparams, cfg, slots=2, max_seq=64,
                     device="cpu").generate(prompts, sp, max_new_tokens=4)
    assert [o.rid for o in outs] == [0, 1, 2, 3]
    assert [o.finish_reason for o in outs] == ["done"] * 3 + ["rejected"]
    assert all(len(o.tokens) == 4 and o.ttft_s >= 0 for o in outs[:3])
    llm = LLMEngine(tparams, cfg, slots=2, max_seq=64, device="cpu")
    events = list(llm.stream(prompts, sp, max_new_tokens=4))
    by_rid: dict = {}
    for ev in events:
        if ev.token >= 0:
            assert ev.index == len(by_rid.setdefault(ev.rid, []))
            by_rid[ev.rid].append(ev.token)
    assert by_rid == {o.rid: o.tokens for o in outs[:3]}
    last = {}
    for o in outs:
        fin = [ev for ev in events if ev.rid == o.rid and ev.done]
        assert len(fin) == 1 and fin[0].finish_reason == o.finish_reason
        last[o.rid] = fin[0]
    assert all(last[r].index == 3 and last[r].token >= 0 for r in range(3))
    # the rejected request closes with the sentinel
    assert (last[3].token, last[3].index) == (-1, 0)
    st = llm.stats()
    assert st["readbacks"] == st["steps"] and llm.engine.finished == []
    with pytest.raises(ValueError):
        llm.generate(prompts, [sp])
    with pytest.raises(ValueError):
        llm.generate(prompts, priorities=[1])


def test_llm_engine_serves_successive_waves(fp32):
    _, cfg, _, tparams = fp32
    llm = LLMEngine(tparams, cfg, slots=2, max_seq=64, device="cpu")
    p = [np.random.default_rng(1).integers(0, cfg.vocab, (5,),
                                           dtype=np.int32)]
    first = llm.generate(p, max_new_tokens=3)
    second = llm.generate(p, max_new_tokens=3)
    assert first[0].rid == 0 and second[0].rid == 1
    assert first[0].tokens == second[0].tokens
    assert llm.engine.finished == []


# -- the priority_mix golden -------------------------------------------------

def test_priority_mix_golden_holds_under_the_bf16_rule():
    jcfg, cfg = jconfigs.smoke(ARCH), configs.smoke(ARCH)
    with jax.threefry_partitionable(False):
        params, _ = jregistry.init(jcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, params), cfg,
                                      "cpu")
    spec = importlib.util.spec_from_file_location(
        "serve_bench_for_sampling_tests",
        REPO / "benchmarks" / "serve_bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    gold = json.loads((REPO / "benchmarks" / "golden"
                       / "serve_qwen2-0.5b_priority_mix.json").read_text())
    reqs = bench.build_requests(jcfg, "priority_mix", seed=gold["seed"])
    assert gold["engine_kw"] == {"scheduler": "priority"}
    llm = LLMEngine(tparams, cfg, slots=gold["slots"],
                    max_seq=gold["max_seq"], device="cpu",
                    **gold["engine_kw"])
    outs = llm.generate([r.prompt for r in reqs],
                        max_new_tokens=gold["max_new"],
                        priorities=[r.priority for r in reqs])
    st = llm.stats()
    assert st["readbacks"] == st["steps"] and st["sched_reorders"] > 0
    assert sorted(gold["streams"], key=int) == [str(o.rid) for o in outs]
    for req, out in zip(reqs, outs):
        want = gold["streams"][str(out.rid)]
        assert out.finish_reason == "done" and len(out.tokens) == len(want)
        diff = [i for i, (a, b) in enumerate(zip(want, out.tokens))
                if a != b]
        if not diff:
            continue
        i = diff[0]
        seq = np.concatenate([req.prompt, np.asarray(want[:i], np.int32)])
        logits, _ = jtransformer.prefill(params, jcfg,
                                         jnp.asarray(seq[None]))
        lg = np.asarray(logits[0], np.float32)
        a, b = lg[want[i]], lg[out.tokens[i]]
        assert abs(a - b) <= BF16["atol"] + BF16["rtol"] * abs(a), \
            (out.rid, i, a, b)
