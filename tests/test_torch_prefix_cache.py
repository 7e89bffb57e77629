"""The radix prefix cache of the PyTorch port against the JAX package, on
the CPU at the reduced qwen2-0.5b config (the counterparts of
``tests/test_prefix_cache.py``).

* The JAX ``Engine`` and the port's ``Engine(device="cpu")`` on the same
  fp32 weights (JAX ``PRNGKey(0)``) and requests: greedy streams with the
  tree equal to those without it and to JAX's; seeded sampled streams
  likewise; a forced copy-on-write; preemption while pages are shared;
  tree eviction under pressure; the prefill-bucket collapse. The
  counters ``prefix_hit_tokens``, ``prefix_query_tokens``, ``cow_copies``,
  ``tree_evictions``, ``tree_pages``, ``steps`` and ``preemptions`` equal
  JAX's, and the pool check (with each slot's next write outside its
  shared pages) holds after every step.
* The gates: inert on the contiguous cache and on h2o-danube's window.
* ``prefix_attention`` and ``prefill_suffix`` against JAX's in fp32 (rtol
  1e-5 / atol 1e-4); ``copy_pages`` exactly.
* A hypothesis state machine drives the port's paged manager (its
  ``RadixCache`` and ``PagePool``) and JAX's with the same admissions,
  inserts, growth, releases, evictions and the chaos harness's page
  holds (``seize_free`` / ``release_seized``): equal results, tables,
  refcounts, trees and pool stats, and ``check()`` after every step.
* ``chip_smoke.py``'s shared-prefix constants equal the JAX engine's
  counts at its settings, and the ``shared_prefix`` golden (bf16,
  non-partitionable threefry weights) holds under the bf16 rule (3e-2 /
  3e-2).
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
from hypothesis import settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from hypothesis.stateful import (  # noqa: E402
    RuleBasedStateMachine, invariant, rule)

from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.serving.api import LLMEngine as JaxLLMEngine  # noqa: E402
from repro.serving.cache_manager import (  # noqa: E402
    CacheConfig as JaxCacheConfig)
from repro.serving.cache_manager import (  # noqa: E402
    PagedCacheManager as JaxPagedCacheManager)
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.sampling import (  # noqa: E402
    SamplingParams as JaxSamplingParams)
from repro_torch import configs  # noqa: E402
from repro_torch.launch.serve import shared_prefix_prompts  # noqa: E402
from repro_torch.models import convert, layers, registry  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    CacheConfig, Engine, LLMEngine, PagedCacheManager, Request,
    SamplingParams)

REPO = Path(__file__).resolve().parents[1]
ARCH = "qwen2-0.5b"
FP32 = dict(rtol=1e-5, atol=1e-4)
BF16 = dict(rtol=3e-2, atol=3e-2)
COUNTERS = ("steps", "readbacks", "preemptions", "prefix_hit_tokens",
            "prefix_query_tokens", "cow_copies", "tree_evictions",
            "tree_pages")


@pytest.fixture(scope="module")
def fp32():
    """(jax cfg, port cfg, jax params, port params on the CPU), fp32."""
    jcfg = dataclasses.replace(jconfigs.smoke(ARCH), dtype="float32")
    cfg = dataclasses.replace(configs.smoke(ARCH), dtype="float32")
    params, _ = jregistry.init(jcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, params), cfg,
                                      "cpu")
    return jcfg, cfg, params, tparams


def _shared_prompts(vocab, seed=0):
    """A staircase over one 48-token base: page-aligned extensions, one
    diverging tail, and one exact duplicate (the forced-CoW shape)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, vocab, (48,), dtype=np.int32)
    tail = rng.integers(0, vocab, (5,), dtype=np.int32)
    return [base[:32], base[:48], np.concatenate([base[:32], tail]),
            base[:48].copy()]


def _port(fp32, prompts, *, max_new=6, slots=3, max_seq=64, sampling=None,
          **cm):
    """(streams, stats, engine) of the port's engine, the pool checked
    after every step."""
    _, cfg, _, tparams = fp32
    eng = Engine(tparams, cfg, slots=slots, max_seq=max_seq, device="cpu",
                 cache_manager=CacheConfig(**cm))
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=p, max_new_tokens=max_new,
                           sampling=sampling[rid] if sampling else None))
    while eng.has_work() and eng.step():
        eng.check_pool()
    eng.run()
    eng.check_pool()
    return ({r.rid: list(r.out_tokens) for r in eng.finished}, eng.stats(),
            eng)


def _jax(fp32, prompts, *, max_new=6, slots=3, max_seq=64, sampling=None,
         **cm):
    jcfg, _, params, _ = fp32
    eng = JaxEngine(params, jcfg, slots=slots, max_seq=max_seq,
                    cache_manager=JaxCacheConfig(**cm))
    for rid, p in enumerate(prompts):
        sp = sampling[rid] if sampling else None
        eng.submit(JaxRequest(
            rid=rid, prompt=p, max_new_tokens=max_new,
            sampling=None if sp is None else JaxSamplingParams(
                **dataclasses.asdict(sp))))
    eng.run()
    return {r.rid: list(r.out_tokens) for r in eng.finished}, eng.stats()


def _held_to_jax(fp32, prompts, **kw):
    """The port with the tree == the port without it == JAX with it, and
    the counters equal JAX's. Returns the port's (streams, stats, eng)."""
    hit, hs, eng = _port(fp32, prompts, **kw)
    cold, _, _ = _port(fp32, prompts, **{**kw, "prefix_cache": False})
    jstreams, js = _jax(fp32, prompts, **kw)
    assert hit == cold == jstreams
    for key in COUNTERS:
        assert hs[key] == js[key], key
    return hit, hs, eng


def test_greedy_streams_bit_identical(fp32):
    _, cfg, _, _ = fp32
    _, s, eng = _held_to_jax(fp32, _shared_prompts(cfg.vocab))
    assert s["prefix_cache"] and s["prefix_hit_tokens"] > 0
    assert s["suffix_prefills"] == sum(r.prefix_hit_tokens > 0
                                       for r in eng.finished)


def test_seeded_sampling_streams_bit_identical(fp32):
    _, cfg, _, _ = fp32
    prompts = _shared_prompts(cfg.vocab)
    sampling = [SamplingParams(temperature=0.8, top_k=20, top_p=0.95,
                               seed=11 * rid + 3)
                for rid in range(len(prompts))]
    hit, s, _ = _held_to_jax(fp32, prompts, sampling=sampling)
    assert s["prefix_hit_tokens"] > 0 and s["sampling_step"]
    assert all(len(v) == 6 for v in hit.values())


def test_forced_cow_divergence(fp32):
    _, cfg, _, _ = fp32
    rng = np.random.default_rng(1)
    base = rng.integers(0, cfg.vocab, (32,), dtype=np.int32)
    tail = rng.integers(0, cfg.vocab, (7,), dtype=np.int32)
    prompts = [base, base.copy(), np.concatenate([base[:16], tail])]
    hit, s, _ = _held_to_jax(fp32, prompts, max_new=8)
    assert s["cow_copies"] >= 1
    assert hit[0] == hit[1] and hit[2] != hit[0]


def test_preemption_while_shared(fp32):
    _, cfg, _, _ = fp32
    rng = np.random.default_rng(2)
    base = rng.integers(0, cfg.vocab, (32,), dtype=np.int32)
    t1 = rng.integers(0, cfg.vocab, (3,), dtype=np.int32)
    prompts = [base, base.copy(), np.concatenate([base, t1])]
    _, s, eng = _held_to_jax(fp32, prompts, max_new=20, page_size=16,
                             num_pages=5)
    assert s["preemptions"] >= 1
    assert all(not pages for pages in eng.cm.pool.owned)
    assert eng.cm.pool.pages_in_use == len(eng.cm.pool.tree_pages())
    eng.cm.clear_tree()
    assert eng.cm.pool.pages_in_use == 0


def test_tree_eviction_under_pressure(fp32):
    _, cfg, _, _ = fp32
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, (24,), dtype=np.int32)
               for _ in range(4)]
    out, s, _ = _held_to_jax(fp32, prompts, max_new=4, slots=2,
                             page_size=16, num_pages=4)
    assert sorted(out) == [0, 1, 2, 3]
    assert s["tree_evictions"] >= 1


def test_prefill_bucket_collapse(fp32):
    _, cfg, _, _ = fp32
    base = np.random.default_rng(4).integers(0, cfg.vocab, (48,),
                                             dtype=np.int32)
    prompts = [base[:16], base[:32], base[:48]]
    hit, s, _ = _port(fp32, prompts)
    cold, cs, _ = _port(fp32, prompts, prefix_cache=False)
    assert hit == cold
    assert s["prefix_hit_tokens"] == 16 + 32
    assert s["prefill_compiles"] < cs["prefill_compiles"]
    assert s["suffix_shapes"] == [16] and s["prefill_shapes"] == [16]


def test_prefix_cache_gating(fp32):
    _, cfg, _, tparams = fp32
    off = Engine(tparams, cfg, slots=2, max_seq=64, device="cpu",
                 cache_manager=CacheConfig(prefix_cache=False))
    assert not off.cm.prefix_cache and "prefix_hit_tokens" not in off.stats()
    contig = Engine(tparams, cfg, slots=2, max_seq=64, device="cpu",
                    cache_manager=CacheConfig(paged=False))
    assert not contig.cm.prefix_cache and not contig._prefix_cache
    assert LLMEngine(tparams, cfg, slots=2, max_seq=64,
                     device="cpu").engine.cm.prefix_cache
    h2o = dataclasses.replace(configs.smoke("h2o-danube-1.8b"),
                              dtype="float32")
    assert not registry.prefix_cache_ok(h2o)
    eng = Engine(registry.init_params(h2o, seed=0, device="cpu"), h2o,
                 slots=2, max_seq=128, device="cpu")
    assert not eng.cm.paged and not eng.cm.prefix_cache
    with pytest.raises(ValueError):
        registry.prefill_suffix(None, h2o, None, None, prefix_len=16)


def test_prefix_attention_and_prefill_suffix_match_jax(fp32):
    jcfg, cfg, params, tparams = fp32
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((1, 16, h, 16)).astype(np.float32)
               for h in (4, 2, 2))
    kp, vp = (rng.standard_normal((1, 64, 2, 16)).astype(np.float32)
              for _ in range(2))
    for plen in (16, 40, 64):
        want = jlayers.prefix_attention(*map(jnp.asarray, (q, k, v, kp, vp)),
                                        plen)
        got = layers.prefix_attention(*map(torch.from_numpy,
                                           (q, k, v, kp, vp)), plen)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)
    # the suffix of a 37-token prompt after a 32-token cached prefix, read
    # from a pool of 4 pages whose rows past the prefix are garbage
    tokens = rng.integers(0, cfg.vocab, (1, 37)).astype(np.int32)
    _, jkv = jtransformer.prefill(params, jcfg, jnp.asarray(tokens[:, :32]))
    prefix = {n: np.concatenate(
        [np.asarray(jkv[n]), rng.standard_normal(
            jkv[n].shape[:2] + (32,) + jkv[n].shape[3:]).astype(np.float32)],
        axis=2) for n in ("k", "v")}
    suffix = np.concatenate([tokens[:, 32:], np.zeros((1, 11), np.int32)], 1)
    jl, jsk = jtransformer.prefill_suffix(
        params, jcfg, jnp.asarray(suffix),
        {n: jnp.asarray(a) for n, a in prefix.items()}, prefix_len=32,
        length=5)
    tl, tsk = registry.prefill_suffix(
        tparams, cfg, torch.from_numpy(suffix).long(),
        {n: torch.from_numpy(a) for n, a in prefix.items()}, prefix_len=32,
        length=5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FP32)
    for n in ("k", "v"):
        np.testing.assert_allclose(tsk[n].numpy(), np.asarray(jsk[n]),
                                   **FP32)
    # and the whole prompt's prefill gives the same logits
    full, _ = registry.prefill(tparams, cfg, torch.from_numpy(tokens).long())
    np.testing.assert_allclose(tl.numpy(), full.numpy(), **FP32)


def test_copy_pages_matches_jax_exactly(fp32):
    jcfg, cfg, _, _ = fp32
    rng = np.random.default_rng(6)
    shape = (cfg.n_layers, 5, 16, cfg.n_kv_heads, cfg.head_dim)
    pool = {n: rng.standard_normal(shape).astype(np.float32)
            for n in ("k", "v")}
    want = jregistry.copy_pages(jcfg, {n: jnp.asarray(a)
                                       for n, a in pool.items()}, 3, 1, 16)
    got = registry.copy_pages(cfg, {n: torch.from_numpy(a.copy())
                                    for n, a in pool.items()}, 3, 1)
    for n in ("k", "v"):
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))
        np.testing.assert_array_equal(got[n][:, 1].numpy(), pool[n][:, 3])


# -- the radix tree and the page pool against JAX's ---------------------------

PAGE, SLOTS, MAX_SEQ, PAGES = 4, 3, 16, 8
# prompts over a two-token alphabet share prefixes often
PROMPTS = [np.array([(i >> b) & 1 for b in range(n)], np.int32)
           for i in range(6) for n in (4, 7, 8, 12)]


class RadixPoolMachine(RuleBasedStateMachine):
    def __init__(self):
        super().__init__()
        cfg = configs.smoke(ARCH)
        kw = dict(page_size=PAGE, num_pages=PAGES)
        self.j = JaxPagedCacheManager(jconfigs.smoke(ARCH), SLOTS, MAX_SEQ,
                                      **kw)
        self.t = PagedCacheManager(cfg, SLOTS, MAX_SEQ, "cpu", **kw)
        self.tokens = [None] * SLOTS
        self.holds = []                 # the chaos harness's page holds

    slots = st.integers(0, SLOTS - 1)

    @rule(slot=slots, which=st.integers(0, len(PROMPTS) - 1))
    def admit(self, slot, which):
        if self.tokens[slot] is not None:
            return
        toks = PROMPTS[which]
        got, want = self.t.admit_prompt(slot, toks), \
            self.j.admit_prompt(slot, toks)
        assert got == want
        if got is not None:
            self.tokens[slot] = toks

    @rule(slot=slots)
    def insert(self, slot):
        toks = self.tokens[slot]
        if toks is not None:
            self.t.insert_prompt(slot, toks, len(toks))
            self.j.insert_prompt(slot, toks, len(toks))

    @rule(slot=slots)
    def grow(self, slot):
        if self.tokens[slot] is not None and \
                len(self.t.pool.owned[slot]) < MAX_SEQ // PAGE:
            assert self.t.grow(slot) == self.j.grow(slot)

    @rule(slot=slots)
    def release(self, slot):
        self.t.evict(slot)
        self.j.evict(slot)
        self.tokens[slot] = None

    @rule(n=st.integers(1, 3))
    def tree_evict(self, n):
        assert self.t.tree.evict(n, self.t.pool) \
            == self.j.tree.evict(n, self.j.pool)

    @rule()
    def clear_tree(self):
        assert self.t.clear_tree() == self.j.clear_tree()

    @rule(n=st.integers(1, 3))
    def seize(self, n):
        got = self.t.pool.seize_free(n)
        assert got == self.j.pool.seize_free(n)
        self.holds.append(got)

    @rule(which=st.integers(0, 3))
    def release_seized(self, which):
        if self.holds:
            pages = self.holds.pop(which % len(self.holds))
            self.t.pool.release_seized(pages)
            self.j.pool.release_seized(pages)

    @invariant()
    def same_state(self):
        self.t.pool.check()
        self.j.pool.check()
        tp, jp = self.t.pool, self.j.pool
        np.testing.assert_array_equal(tp.table, jp.table)
        assert tp.refcnt == jp.refcnt and tp.owned == jp.owned
        assert tp.shared == jp.shared and tp._free == jp._free
        assert sorted(self.t.tree.pages()) == sorted(self.j.tree.pages())
        assert tp.seized == {p for h in self.holds for p in h}
        assert tp.tree_pages() == set(self.t.tree.pages())
        assert tp.stats() == jp.stats()
        assert self.t.has_free == self.j.has_free
        ts, js = self.t.stats(), self.j.stats()
        assert {k: ts[k] for k in ts} == {k: js[k] for k in ts}


RadixPoolMachine.TestCase.settings = settings(
    max_examples=25, stateful_step_count=30, deadline=None)
TestRadixPoolMachine = RadixPoolMachine.TestCase


# -- chip_smoke's shared-prefix constants and the golden ----------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_prefix_tests", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_shared_prefix_constants_equal_jax(fp32):
    """The counters chip_smoke holds its full-width shared-prefix serve to
    depend on prompts, pages, slots, max_seq and max_new only: the JAX
    engine at the reduced width and the same settings gives them."""
    jcfg, cfg, params, tparams = fp32
    smoke = _chip_smoke()
    s = smoke.SERVE_SHARED
    prompts = shared_prefix_prompts(jcfg, s["seed"])
    jllm = JaxLLMEngine(params, jcfg, slots=s["slots"], max_seq=s["max_seq"],
                        page_size=s["page_size"])
    jouts = jllm.generate(prompts, max_new_tokens=s["max_new"])
    js = jllm.stats()
    want = smoke.SHARED_COUNTS
    assert js["prefix_hit_tokens"] == want["prefix_hit_tokens"]
    assert js["cow_copies"] == want["cow_copies"]
    assert sum(o.prefix_hit_tokens > 0 for o in jouts) \
        == want["suffix_prefills"]
    llm = LLMEngine(tparams, cfg, slots=s["slots"], max_seq=s["max_seq"],
                    page_size=s["page_size"], device="cpu")
    outs = llm.generate(prompts, max_new_tokens=s["max_new"])
    st_ = llm.stats()
    assert [o.tokens for o in outs] == [o.tokens for o in jouts]
    assert [o.prefix_hit_tokens for o in outs] \
        == [o.prefix_hit_tokens for o in jouts]
    for key, value in want.items():
        assert st_[key] == value, key


def test_shared_prefix_golden_holds_under_the_bf16_rule():
    jcfg, cfg = jconfigs.smoke(ARCH), configs.smoke(ARCH)
    with jax.threefry_partitionable(False):
        params, _ = jregistry.init(jcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, params), cfg,
                                      "cpu")
    gold = json.loads((REPO / "benchmarks" / "golden"
                       / "serve_qwen2-0.5b_shared_prefix.json").read_text())
    prompts = shared_prefix_prompts(jcfg, gold["seed"])
    kw = {"max_seq": gold["max_seq"], **gold["engine_kw"]}
    llm = LLMEngine(tparams, cfg, slots=gold["slots"], device="cpu", **kw)
    outs = llm.generate(prompts, max_new_tokens=gold["max_new"])
    st_ = llm.stats()
    assert st_["readbacks"] == st_["steps"]
    assert st_["prefix_hit_tokens"] > 0 and st_["cow_copies"] == 1
    assert sorted(gold["streams"], key=int) == [str(o.rid) for o in outs]
    for prompt, out in zip(prompts, outs):
        want = gold["streams"][str(out.rid)]
        assert out.finish_reason == "done" and len(out.tokens) == len(want)
        diff = [i for i, (a, b) in enumerate(zip(want, out.tokens))
                if a != b]
        if not diff:
            continue
        i = diff[0]
        seq = np.concatenate([prompt, np.asarray(want[:i], np.int32)])
        logits, _ = jtransformer.prefill(params, jcfg,
                                         jnp.asarray(seq[None]))
        lg = np.asarray(logits[0], np.float32)
        a, b = lg[want[i]], lg[out.tokens[i]]
        assert abs(a - b) <= BF16["atol"] + BF16["rtol"] * abs(a), \
            (out.rid, i, a, b)
