"""The Griffin hybrid (recurrentgemma-2b) of the PyTorch port against the
JAX package, on the CPU at the reduced config (5 layers: one period of two
RG-LRU blocks and a local-attention layer, then two recurrent tail
blocks; window 32).

Weights: JAX ``PRNGKey(0)`` through ``convert.params_from_jax``, with every
``conv_w`` (zeros at init, on both sides) replaced by one seeded numpy
draw, ``default_rng(11)`` normal times 0.5, on both sides: with zero conv
weights the RG-LRU input is zero and its state stays 0, so a test on init
weights would not reach the recurrence.

* ``_causal_conv`` and ``rglru`` with and without a carried state;
  prefill logits and all six cache leaves at 20, 32 and 45 tokens (under,
  at and over the window), and 40 decode steps from that cache, in fp32
  (rtol 1e-5 / atol 1e-4; the port's doubling scan sums in another order
  than ``lax.associative_scan``).
* ``params_from_jax``'s layout and dtypes (the RG-LRU gates and the norms
  in fp32), the seeded init's, and the refusal of a padded prompt.
* The axis-driven ``write_slot``: each leaf lands on its batch axis, equal
  to JAX's ``write_slot``, and a slot reused by a second request carries
  nothing of the first.
* Serving: greedy streams, ``steps`` and finish reasons equal the JAX
  engine's on the requests of ``tests/test_serving.py``'s all-families
  smoke and on three mixes of ``benchmarks/serve_bench.py``, whose
  prompts cross the window; ``chaos_mix`` with recompute preemption (the
  recovery re-prefills the survivors into reused slots). A warm-up of the step
  (what a capture runs first) leaves every state leaf as it was; the
  engine refuses ``paged=True`` and leaves ``spec=`` inert.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import recurrentgemma as jrg  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.reliability import Fault as JaxFault  # noqa: E402
from repro.serving import CacheConfig as JaxCacheConfig  # noqa: E402
from repro.serving import ChaosInjector as JaxChaosInjector  # noqa: E402
from repro.serving import Engine as JaxEngine  # noqa: E402
from repro.serving import LLMEngine as JaxLLMEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import convert, recurrentgemma, registry  # noqa: E402
from repro_torch.reliability import Fault  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    CacheConfig, ChaosInjector, Engine, LLMEngine, Request, SpecConfig)

REPO = Path(__file__).resolve().parents[1]
ARCH = "recurrentgemma-2b"
FP32 = dict(rtol=1e-5, atol=1e-4)
LEAVES = ("conv", "h", "k", "v", "tconv", "th")
# the serve benchmark's mixes held here: prompts of 40-80 tokens (24
# new), of 64-240, and chaos_mix's recovery, all across the window of 32
MIXES = ("oversubscribed", "shared_prefix", "chaos_mix")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tests run many tiny CPU ops, which the
    thread pool only slows, and more so beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(dtype="float32"):
    return (dataclasses.replace(jconfigs.smoke(ARCH), dtype=dtype),
            dataclasses.replace(configs.smoke(ARCH), dtype=dtype))


def _nonzero_conv(params):
    """``params`` with every conv_w replaced by the seeded draw."""
    rng = np.random.default_rng(11)
    tree = jax.tree.map(np.asarray, params)
    for part in (tree["periods"]["rec"], tree["tail"]):
        part["conv_w"] = (0.5 * rng.standard_normal(
            part["conv_w"].shape)).astype(np.float32)
    return jax.tree.map(jnp.asarray, tree), tree


@pytest.fixture(scope="module")
def fp32():
    """(jax cfg, port cfg, jax params, port params on the CPU), fp32,
    PRNGKey(0) with non-zero conv weights."""
    jcfg, cfg = _cfgs()
    params, _ = jregistry.init(jcfg, jax.random.PRNGKey(0))
    params, tree = _nonzero_conv(params)
    return jcfg, cfg, params, convert.params_from_jax(tree, cfg, "cpu")


def _close(got, want, tol=FP32):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


def _block(params, i=0):
    """Recurrent block ``i`` of the first period (JAX and numpy)."""
    jp = jax.tree.map(lambda a: a[0, i], params["periods"]["rec"])
    return jp, {k: torch.from_numpy(np.array(v, np.float32))
                for k, v in jax.tree.map(np.asarray, jp).items()
                if not isinstance(v, dict)}


# -- the blocks ---------------------------------------------------------------

@pytest.mark.parametrize("carried", [False, True])
def test_causal_conv_matches_jax(carried, fp32):
    jcfg, cfg, params, _ = fp32
    jp, tp = _block(params)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, cfg.lru_width)).astype(np.float32)
    state = rng.standard_normal((2, 3, cfg.lru_width)).astype(np.float32) \
        if carried else None
    jo, js = jrg._causal_conv(jnp.asarray(x), jp["conv_w"],
                              None if state is None else jnp.asarray(state))
    to, ts = recurrentgemma._causal_conv(
        torch.from_numpy(x), tp["conv_w"],
        None if state is None else torch.from_numpy(state))
    _close(to, jo)
    _close(ts, js)


@pytest.mark.parametrize("carried", [False, True])
def test_rglru_matches_jax(carried, fp32):
    jcfg, cfg, params, _ = fp32
    jp, tp = _block(params, 1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 37, cfg.lru_width)).astype(np.float32)
    h0 = rng.standard_normal((2, cfg.lru_width)).astype(np.float32) \
        if carried else None
    jh, jlast = jrg.rglru(jp, jnp.asarray(x),
                          None if h0 is None else jnp.asarray(h0))
    th, tlast = recurrentgemma.rglru(
        tp, torch.from_numpy(x), None if h0 is None else torch.from_numpy(h0))
    _close(th, jh)
    _close(tlast, jlast)
    assert tlast.dtype == torch.float32
    assert float(np.abs(np.asarray(jlast)).max()) > 0.1   # the state moves


# -- prefill and decode -------------------------------------------------------

@pytest.fixture(scope="module")
def jax_decode(fp32):
    """JAX's decode step, jitted once: every length's cache has one
    shape (a 32-row ring)."""
    jcfg = fp32[0]
    return jax.jit(lambda p, c, t, q: jrg.decode_step(p, jcfg, c, t, q))


def _prefill_both(fp32, s, batch=2, cache_len=48):
    jcfg, cfg, params, tp = fp32
    toks = np.random.default_rng(3 + s).integers(
        0, cfg.vocab, (batch, s)).astype(np.int32)
    jl, jc = jrg.prefill(params, jcfg, jnp.asarray(toks),
                         cache_len=cache_len)
    tl, tc = registry.prefill(tp, cfg, torch.from_numpy(toks).long(),
                              cache_len=cache_len)
    return jl, jc, tl, tc


@pytest.mark.parametrize("s", [20, 32, 45])
def test_prefill_matches_jax(s, fp32):
    jl, jc, tl, tc = _prefill_both(fp32, s)
    _close(tl, jl)
    assert set(tc) == set(LEAVES)
    for name in LEAVES:
        assert tuple(tc[name].shape) == tuple(jc[name].shape), name
        _close(tc[name], jc[name])
    assert tc["h"].dtype == tc["th"].dtype == torch.float32
    assert tc["k"].shape[2] == 32            # the ring: min(48, window)


@pytest.mark.parametrize("s", [20, 32, 45])
def test_decode_steps_match_jax(s, fp32, jax_decode):
    jcfg, cfg, params, tp = fp32
    _, jc, _, tc = _prefill_both(fp32, s)
    rng = np.random.default_rng(4 + s)
    pos = np.full(2, s, np.int32)
    pos[1] -= 3            # ragged: slot 1 rewrites its last three rows
    for _ in range(40):    # the ring wraps at least once
        tok = rng.integers(0, cfg.vocab, 2).astype(np.int32)
        jl, jc = jax_decode(params, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc = registry.decode_cached(tp, cfg, tc, torch.from_numpy(tok),
                                        torch.from_numpy(pos))
        _close(tl, jl)
        for name in LEAVES:
            _close(tc[name], jc[name])
        pos = pos + 1


def test_prefill_refuses_a_padded_prompt(fp32):
    _, cfg, _, tp = fp32
    assert not registry.pad_prefill_ok(cfg)
    with pytest.raises(ValueError, match="padded"):
        registry.prefill(tp, cfg, torch.zeros((1, 8), dtype=torch.long),
                         length=5)


# -- parameters ---------------------------------------------------------------

def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _fp32_leaf(path) -> bool:
    name = path[-1]
    return name.endswith("norm") or name in ("w_a", "w_x", "lam")


def test_params_from_jax_layout_and_dtypes(fp32):
    jcfg, cfg, params, _ = fp32
    bcfg = dataclasses.replace(cfg, dtype="bfloat16")
    tree = jax.tree.map(np.asarray, params)
    tp = convert.params_from_jax(tree, bcfg, "cpu")
    assert len(tp["periods"]) == 1 and len(tp["tail"]) == 2
    assert [len(p["rec"]) for p in tp["periods"]] == [2]
    for path, t in _leaves(tp):
        want = torch.float32 if _fp32_leaf(path) else torch.bfloat16
        assert t.dtype == want, path
    rec = tp["periods"][0]["rec"][1]
    assert np.array_equal(rec["w_a"].numpy(),
                          tree["periods"]["rec"]["w_a"][0, 1])
    assert torch.equal(rec["w_main"], torch.from_numpy(
        np.array(tree["periods"]["rec"]["w_main"][0, 1])).to(torch.bfloat16))
    assert np.array_equal(tp["tail"][1]["lam"].numpy(),
                          tree["tail"]["lam"][1])
    attn = tp["periods"][0]["attn"]
    assert tuple(attn["attn"]["wq"].shape) == (64, 2, 32)
    assert np.array_equal(attn["mlp_norm"].numpy(),
                          tree["periods"]["attn"]["mlp_norm"][0])
    # the seeded init: the same layout, dtypes and shapes; conv_w zeros,
    # as JAX's, and a = exp(-8 softplus(lam)) in JAX's range
    own = dict(_leaves(registry.init_params(bcfg, seed=1, device="cpu")))
    conv = dict(_leaves(tp))
    assert set(own) == set(conv)
    for path, a in own.items():
        assert a.dtype == conv[path].dtype, path
        assert a.shape == conv[path].shape, path
    assert not own["tail", 0, "conv_w"].any()
    a = torch.exp(-8 * torch.nn.functional.softplus(own["tail", 0, "lam"]))
    assert bool(((a > 0.9 - 1e-5) & (a < 0.999 + 1e-5)).all())
    # the engine's cast keeps the gates fp32 too
    eng = Engine(tp, bcfg, slots=2, max_seq=64, device="cpu")
    assert eng.params["tail"][0]["w_x"].dtype == torch.float32


# -- the axis-driven cache write -------------------------------------------

def test_cache_spec_matches_jax():
    for jcfg, cfg in ((jconfigs.get(ARCH), configs.get(ARCH)),
                      _cfgs()):
        for seq in (16, 4096):
            jspec, jaxes = jrg.cache_spec(jcfg, 8, seq)
            spec, axes = registry.cache_spec(cfg, 8, seq)
            assert axes == jaxes
            assert {k: v[0] for k, v in spec.items()} == \
                {k: tuple(v.shape) for k, v in jspec.items()}
    assert registry.state_leaves(configs.smoke(ARCH)) == \
        ("conv", "h", "tconv", "th")
    assert registry.state_leaves(configs.smoke("qwen2-0.5b")) == ()


def test_write_slot_writes_every_leaf_on_its_batch_axis(fp32):
    """A slot reused by a second request carries nothing of the first:
    request A (45 tokens, past the window) is written into slot 1 and
    decoded, then request B (12 tokens) is written there. Every state leaf
    of slot 1 is B's, its first 12 K/V rows are B's, the other slots are
    untouched, and JAX's ``write_slot`` gives the same cache."""
    jcfg, cfg, params, tp = fp32
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 45))).long()
    b = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 12))).long()
    cache = registry.init_cache(cfg, 3, 64, "cpu")
    for leaf in cache.values():
        leaf.normal_(generator=torch.Generator().manual_seed(6))
    _, kva = registry.prefill(tp, cfg, a)
    registry.write_slot(cfg, cache, kva, 1)
    for t in range(4):
        registry.decode_cached(tp, cfg, cache,
                               torch.tensor([1, 2, 3], dtype=torch.int32),
                               torch.tensor([5, 45 + t, 9],
                                            dtype=torch.int32))
    before = {k: v.clone() for k, v in cache.items()}
    jcache = {k: jnp.asarray(v.numpy()) for k, v in cache.items()}
    _, kvb = registry.prefill(tp, cfg, b)
    registry.write_slot(cfg, cache, kvb, 1)
    jcache = jregistry.write_slot(
        jcfg, jcache, {k: jnp.asarray(v.numpy()) for k, v in kvb.items()},
        1, 64)
    _, axes = registry.cache_spec(cfg, 1, 1)
    for name, leaf in cache.items():
        _close(leaf, jcache[name], dict(rtol=0, atol=0))
        ba = axes[name].index("batch")
        mine = leaf.narrow(ba, 1, 1)
        if name in ("k", "v"):
            assert torch.equal(mine[:, :, :12], kvb[name])
            assert torch.equal(mine[:, :, 12:],
                               before[name].narrow(ba, 1, 1)[:, :, 12:])
        else:
            assert torch.equal(mine, kvb[name].to(leaf.dtype)), name
        for other in (0, 2):
            assert torch.equal(leaf.narrow(ba, other, 1),
                               before[name].narrow(ba, other, 1))


# -- serving ------------------------------------------------------------------

def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bench():
    return _load("serve_bench_for_hybrid_tests",
                 REPO / "benchmarks" / "serve_bench.py")


def test_engine_smoke_requests_equal_the_jax_engine(fp32):
    """``tests/test_serving.py::test_engine_smoke_all_families``' requests
    (prompts of 5, 8 and 6 tokens, 3 new, 2 slots)."""
    jcfg, cfg, params, tp = fp32
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, (n,), dtype=np.int32)
               for n in (5, 8, 6)]
    jeng = JaxEngine(params, jcfg, slots=2, max_seq=64)
    eng = Engine(tp, cfg, slots=2, max_seq=64, device="cpu")
    for e, req in ((jeng, JaxRequest), (eng, Request)):
        for rid, p in enumerate(prompts):
            e.submit(req(rid=rid, prompt=p, max_new_tokens=3))
    jdone = {r.rid: list(r.out_tokens) for r in jeng.run()}
    done = {r.rid: list(r.out_tokens) for r in eng.run()}
    assert done == jdone and sorted(done) == [0, 1, 2]
    assert eng.stats()["steps"] == jeng.stats()["steps"]


def _mix(bench, mix, cfg, jcfg):
    """(requests, engine kwargs, port extras, JAX extras) of one mix;
    chaos_mix with recompute preemption."""
    reqs = bench.build_requests(jcfg, mix)
    kw = dict(slots=bench.SLOTS, max_seq=bench.MAX_SEQ)
    kw.update(bench.MIX_ENGINE_KW.get(mix, {}))
    px, jx = {}, {}
    if mix == "chaos_mix":
        kw["preemption"] = "recompute"
        plan = bench._chaos_plan()
        px["chaos"] = ChaosInjector([Fault(**dataclasses.asdict(f))
                                     for f in plan])
        jx["chaos"] = JaxChaosInjector([JaxFault(**dataclasses.asdict(f))
                                        for f in plan])
    return reqs, kw, px, jx


def _generate(llm, reqs):
    return llm.generate([r.prompt for r in reqs],
                        max_new_tokens=[r.max_new_tokens for r in reqs],
                        priorities=[r.priority for r in reqs])


@pytest.mark.parametrize("mix", MIXES)
def test_streams_equal_the_jax_engine(mix, fp32, bench):
    jcfg, cfg, params, tp = fp32
    reqs, kw, px, jx = _mix(bench, mix, cfg, jcfg)
    assert max(len(r.prompt) for r in reqs) > cfg.window
    jllm = JaxLLMEngine(params, jcfg, **kw, **jx)
    jouts = _generate(jllm, reqs)
    llm = LLMEngine(tp, cfg, device="cpu", **kw, **px)
    outs = _generate(llm, reqs)
    js, st = jllm.stats(), llm.stats()
    assert [o.tokens for o in outs] == [o.tokens for o in jouts]
    assert [o.finish_reason for o in outs] == \
        [o.finish_reason for o in jouts]
    for key in ("steps", "readbacks", "prefill_compiles", "paged",
                "pad_prefill", "recoveries", "failed", "aborted",
                "rejected"):
        assert st[key] == js[key], key
    assert not st["paged"] and not st["pad_prefill"]
    if mix == "chaos_mix":
        assert st["recoveries"] == 1 and px["chaos"].exhausted
        # the survivors were re-prefilled into their reused slots
        assert st["prefills"] > sum(1 for r in reqs if len(r.prompt))


def test_a_warm_up_leaves_the_state_as_it_was(fp32):
    """A capture first runs warm-up passes of the step; mid-run (the
    draw's capture at the first sampled admission, or a genome change)
    they must not advance a resident slot's conv or RG-LRU state. Here
    the CPU engine runs them after every step and its streams stay those
    of a run without them."""
    _, cfg, _, tp = fp32
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (12, 40, 25, 7, 33)]
    gold = LLMEngine(tp, cfg, slots=3, max_seq=64, device="cpu").generate(
        prompts, max_new_tokens=12)
    llm = LLMEngine(tp, cfg, slots=3, max_seq=64, device="cpu")
    eng = llm.engine
    step = eng.step

    def warmed_step():
        ran = step()
        eng._warm_up()
        return ran
    eng.step = warmed_step
    outs = llm.generate(prompts, max_new_tokens=12)
    assert eng.stats()["capture_warmups"] > 0
    assert [o.tokens for o in outs] == [o.tokens for o in gold]


def test_the_engine_refuses_paged_and_leaves_spec_inert(fp32):
    jcfg, cfg, params, tp = fp32
    assert not registry.paged_ok(cfg) and not registry.prefix_cache_ok(cfg)
    with pytest.raises(ValueError, match="cannot serve from a paged pool"):
        Engine(tp, cfg, slots=2, max_seq=64, device="cpu",
               cache_manager=CacheConfig(paged=True))
    with pytest.raises(ValueError, match="cannot serve from a paged pool"):
        JaxEngine(params, jcfg, slots=2, max_seq=64,
                  cache_manager=JaxCacheConfig(paged=True))
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (8, 30, 11)]
    gold = [o.tokens for o in LLMEngine(
        tp, cfg, slots=3, max_seq=64, device="cpu").generate(
            prompts, max_new_tokens=6)]
    llm = LLMEngine(tp, cfg, slots=3, max_seq=64, device="cpu",
                    spec=SpecConfig(drafter="ngram", k=3))
    outs = llm.generate(prompts, max_new_tokens=6)
    st = llm.stats()
    assert not st["spec_on"] and st["draft_tokens"] == 0
    assert [o.tokens for o in outs] == gold
