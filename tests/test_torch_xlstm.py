"""The xLSTM (xlstm-1.3b) of the PyTorch port against the JAX package, on
the CPU at the reduced config (8 layers: one period of seven mLSTM blocks
and an sLSTM block; d_model 64, 2 heads).

Weights: JAX ``PRNGKey(0)`` through ``convert.params_from_jax``. The JAX
init draws the mLSTM gate weights ``w_i``, ``w_f`` (``[heads, dh]``) at
``heads ** -0.5`` (``dense_init`` takes ``shape[-2]`` as the fan-in),
so the log-gates spread wide, the stabiliser ``m`` runs high and the
output's division ``C^T q / max(|n . q|, e^-m)`` is ill-conditioned: at
``PRNGKey(0)`` one block amplifies the last-bit differences of XLA's and
PyTorch's projections past fp32's 1e-5 / 1e-4: one ulp of its input
moves JAX's own output 1.4e-3 (held by
``test_one_ulp_of_input_moves_the_jax_block``). The tests of logits
and cache leaves therefore replace those two leaves, on both sides, by
one seeded numpy draw at the fan-in of the axis they contract, ``dh **
-0.5`` (``default_rng(11)``, truncated at 2), as the hybrid's tests
redraw ``conv_w``; the rest of the tree is ``PRNGKey(0)``'s.

* ``mlstm_block`` and ``slstm_block`` with and without a carried state;
  prefill logits and all six cache leaves at 20, 64, 130 and 1,024
  tokens (one chunk, whole chunks, a ragged last chunk, sixteen chunks)
  and 40 decode steps from that cache, in fp32 (rtol 1e-5 / atol 1e-4;
  the port's chunkwise scans sum in another order than JAX's step-by-step
  scan).
* The lengths JAX's chunk reshape refuses (129, 131 tokens: ``TypeError``
  there) raise ``ValueError`` here, before any work; a padded prompt is
  refused.
* ``params_from_jax``'s layout and dtypes (the mLSTM gates fp32, the
  sLSTM's cast), the seeded init's.
* The cache: ``cache_spec`` equals JAX's (the same size at any length),
  ``write_slot`` writes every leaf whole on its batch axis (axis 2 of
  the stacked mLSTM states), so a reused slot carries nothing of its
  last occupant; a capture's warm-up leaves every leaf as it was.
* Serving: greedy streams, ``steps`` and finish reasons equal the JAX
  engine's on ``tests/test_serving.py``'s all-families requests (on the
  ``PRNGKey(0)`` weights as drawn) and on mixes of
  ``benchmarks/serve_bench.py`` whose lengths JAX's scan takes,
  ``chaos_mix`` with recompute preemption among them.
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
from repro.models import registry as jregistry  # noqa: E402
from repro.models import xlstm as jxl  # noqa: E402
from repro.reliability import Fault as JaxFault  # noqa: E402
from repro.serving import ChaosInjector as JaxChaosInjector  # noqa: E402
from repro.serving import Engine as JaxEngine  # noqa: E402
from repro.serving import LLMEngine as JaxLLMEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import convert, registry, xlstm  # noqa: E402
from repro_torch.reliability import Fault  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    CacheConfig, ChaosInjector, Engine, LLMEngine, Request)

REPO = Path(__file__).resolve().parents[1]
ARCH = "xlstm-1.3b"
FP32 = dict(rtol=1e-5, atol=1e-4)
LEAVES = ("mC", "mn", "mm", "sc", "sn", "sm")
# serve_bench mixes whose prompts JAX's scan takes (every length <= 127),
# one prefill shape, and chaos_mix (eight lengths and the recovery)
MIXES = ("uniform_short", "chaos_mix")


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


def _fan_in_gates(params):
    """``params`` with the mLSTM ``w_i``, ``w_f`` redrawn at ``dh **
    -0.5`` (one seeded numpy draw, truncated at 2)."""
    rng = np.random.default_rng(11)
    tree = jax.tree.map(np.asarray, params)
    m = tree["periods"]["mlstm"]
    dh = m["w_i"].shape[-1]
    for name in ("w_i", "w_f"):
        m[name] = (np.clip(rng.standard_normal(m[name].shape), -2, 2)
                   * dh ** -0.5).astype(np.float32)
    return jax.tree.map(jnp.asarray, tree), tree


@pytest.fixture(scope="module")
def key0():
    """(jax cfg, port cfg, jax params, port params on the CPU), fp32,
    PRNGKey(0) as drawn."""
    jcfg, cfg = _cfgs()
    params, _ = jregistry.init(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    return jcfg, cfg, params, convert.params_from_jax(tree, cfg, "cpu")


@pytest.fixture(scope="module")
def fp32(key0):
    """``key0`` with the mLSTM gates at their fan-in scale."""
    jcfg, cfg, params, _ = key0
    params, tree = _fan_in_gates(params)
    return jcfg, cfg, params, convert.params_from_jax(tree, cfg, "cpu")


def _close(got, want, tol=FP32):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


def _tensors(tree):
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in jax.tree.map(np.asarray, tree).items()}


# -- the blocks ---------------------------------------------------------------

@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("s,carried", [(1, True), (20, False), (20, True),
                                       (130, False), (130, True)])
def test_block_matches_jax(kind, s, carried, fp32):
    """Each block kind over a segment (one step, one chunk, a ragged
    second chunk) from the empty state or a carried one (the state JAX's
    block leaves after 37 other steps)."""
    jcfg, cfg, params, _ = fp32
    if kind == "mlstm":
        jp = jax.tree.map(lambda a: a[0, 2], params["periods"]["mlstm"])
        jblock, block = jxl.mlstm_block, xlstm.mlstm_block
    else:
        jp = jax.tree.map(lambda a: a[0], params["periods"]["slstm"])
        jblock, block = jxl.slstm_block, xlstm.slstm_block
    rng = np.random.default_rng(1 + s)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    jstate = state = None
    if carried:
        warm = rng.standard_normal((2, 37, cfg.d_model)).astype(np.float32)
        _, jstate = jblock(jp, jnp.asarray(warm), jcfg)
        state = tuple(torch.from_numpy(np.array(t)) for t in jstate)
    jy, jst = jblock(jp, jnp.asarray(x), jcfg, jstate)
    given = None if state is None else tuple(t.clone() for t in state)
    y, st = block(_tensors(jp), torch.from_numpy(x), cfg, given)
    _close(y, jy)
    for a, b in zip(st, jst):
        _close(a, b)
        assert a.dtype == torch.float32
    if state is not None:      # the block does not change the state given
        assert all(torch.equal(a, b) for a, b in zip(given, state))


# -- prefill and decode -------------------------------------------------------

@pytest.fixture(scope="module")
def jax_decode(fp32):
    """JAX's decode step, jitted once: the cache has one shape at every
    prompt length."""
    jcfg = fp32[0]
    return jax.jit(lambda p, c, t, q: jxl.decode_step(p, jcfg, c, t, q))


def _prefill_both(fp32, s, batch=2):
    jcfg, cfg, params, tp = fp32
    toks = np.random.default_rng(3 + s).integers(
        0, cfg.vocab, (batch, s)).astype(np.int32)
    jl, jc = jxl.prefill(params, jcfg, jnp.asarray(toks))
    tl, tc = registry.prefill(tp, cfg, torch.from_numpy(toks).long())
    return jl, jc, tl, tc


@pytest.mark.parametrize("s", [20, 64, 130, 1024])
def test_prefill_and_decode_match_jax(s, fp32, jax_decode):
    """Prefill logits and all six leaves, then 40 decode steps of logits
    and leaves from that cache."""
    jcfg, cfg, params, tp = fp32
    jl, jc, tl, tc = _prefill_both(fp32, s)
    _close(tl, jl)
    assert set(tc) == set(LEAVES)
    for name in LEAVES:
        assert tuple(tc[name].shape) == tuple(jc[name].shape), name
        assert tc[name].dtype == torch.float32
        _close(tc[name], jc[name])
    rng = np.random.default_rng(4 + s)
    pos = np.full(2, s, np.int32)
    for _ in range(40):
        tok = rng.integers(0, cfg.vocab, 2).astype(np.int32)
        jl, jc = jax_decode(params, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc = registry.decode_cached(tp, cfg, tc, torch.from_numpy(tok),
                                        torch.from_numpy(pos))
        _close(tl, jl)
        for name in LEAVES:
            _close(tc[name], jc[name])
        pos = pos + 1


@pytest.mark.parametrize("s", [129, 131])
def test_lengths_jax_cannot_chunk_raise(s, fp32):
    jcfg, cfg, params, tp = fp32
    toks = np.zeros((1, s), np.int32)
    with pytest.raises(TypeError):
        jxl.prefill(params, jcfg, jnp.asarray(toks))
    with pytest.raises(ValueError, match=f"{s} tokens"):
        registry.prefill(tp, cfg, torch.from_numpy(toks).long())


def test_prefill_refuses_a_padded_prompt(fp32):
    _, cfg, _, tp = fp32
    assert not registry.pad_prefill_ok(cfg)
    with pytest.raises(ValueError, match="padded"):
        registry.prefill(tp, cfg, torch.zeros((1, 8), dtype=torch.long),
                         length=5)


@pytest.mark.parametrize("gates", ["prngkey0", "fan_in"])
def test_one_ulp_of_input_moves_the_jax_block(gates, key0):
    """The finding behind the redrawn gates. At ``PRNGKey(0)`` (mLSTM
    gates at ``heads ** -0.5``) the fifth mLSTM block, on the input the
    first four give it, is so ill-conditioned that moving every input
    value by one ulp moves JAX's own output past the fp32 tolerance, so
    no implementation whose sums round otherwise can be held to it there.
    With the gates at their fan-in scale one ulp moves it ~1e-6."""
    jcfg, cfg, params, _ = key0
    if gates == "fan_in":
        params, _ = _fan_in_gates(params)
    w_i = np.asarray(params["periods"]["mlstm"]["w_i"])
    assert (w_i.std() > 0.4) == (gates == "prngkey0")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 20))
    x = jxl.L.embed_tokens(params["embed"], jnp.asarray(toks, jnp.int32))
    for j in range(4):
        jp = jax.tree.map(lambda a: a[0, j], params["periods"]["mlstm"])
        x, _ = jxl.mlstm_block(jp, x, jcfg)
    jp = jax.tree.map(lambda a: a[0, 4], params["periods"]["mlstm"])
    y, _ = jxl.mlstm_block(jp, x, jcfg)
    for direction in (np.inf, -np.inf):
        nudged = np.nextafter(np.asarray(x), np.float32(direction))
        y2, _ = jxl.mlstm_block(jp, jnp.asarray(nudged), jcfg)
        held = np.allclose(np.asarray(y2), np.asarray(y), **FP32)
        assert held == (gates == "fan_in")


# -- parameters and cache -----------------------------------------------------

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
    return path[-1].endswith("norm") or (
        "mlstm" in path and path[-1] in ("w_i", "w_f"))


def test_params_from_jax_layout_and_dtypes(key0):
    jcfg, cfg, params, _ = key0
    bcfg = dataclasses.replace(cfg, dtype="bfloat16")
    tree = jax.tree.map(np.asarray, params)
    tp = convert.params_from_jax(tree, bcfg, "cpu")
    assert len(tp["periods"]) == 1
    assert len(tp["periods"][0]["mlstm"]) == 7
    for path, t in _leaves(tp):
        want = torch.float32 if _fp32_leaf(path) else torch.bfloat16
        assert t.dtype == want, path
    blk = tp["periods"][0]["mlstm"][6]
    assert np.array_equal(blk["w_f"].numpy(),
                          tree["periods"]["mlstm"]["w_f"][0, 6])
    assert torch.equal(blk["w_v"], torch.from_numpy(np.array(
        tree["periods"]["mlstm"]["w_v"][0, 6])).to(torch.bfloat16))
    s = tp["periods"][0]["slstm"]
    assert s["w_i"].dtype == torch.bfloat16
    assert tuple(s["w_i"].shape) == (64, 64)
    # the seeded init: the same layout, dtypes and shapes
    own = dict(_leaves(registry.init_params(bcfg, seed=1, device="cpu")))
    conv = dict(_leaves(tp))
    assert set(own) == set(conv)
    for path, a in own.items():
        assert a.dtype == conv[path].dtype, path
        assert a.shape == conv[path].shape, path
    eng = Engine(tp, bcfg, slots=2, max_seq=64, device="cpu")
    assert eng.params["periods"][0]["mlstm"][0]["w_i"].dtype == torch.float32
    assert eng.params["periods"][0]["slstm"]["w_f"].dtype == torch.bfloat16


def test_cache_spec_matches_jax_and_is_constant_size():
    """``tests/test_models.py::test_xlstm_state_is_constant_size``, and
    the full-width shapes equal JAX's."""
    for jcfg, cfg in ((jconfigs.get(ARCH), configs.get(ARCH)), _cfgs()):
        for seq in (128, 524288):
            jspec, jaxes = jxl.cache_spec(jcfg, 8, seq)
            spec, axes = registry.cache_spec(cfg, 8, seq)
            assert axes == jaxes
            assert {k: v[0] for k, v in spec.items()} == \
                {k: tuple(v.shape) for k, v in jspec.items()}
        assert registry.cache_spec(cfg, 2, 128)[0] == \
            registry.cache_spec(cfg, 2, 524288)[0]
    assert registry.state_leaves(configs.smoke(ARCH)) == LEAVES
    full = registry.cache_spec(configs.get(ARCH), 1, 1)[0]
    assert sum(np.prod(s) * 4 for s, _ in full.values()) == 352_813_728
    cache = registry.init_cache(configs.smoke(ARCH), 2, 64, "cpu")
    jcache, _ = jxl.init_cache(jconfigs.smoke(ARCH), 2, 64)
    for name in LEAVES:
        _close(cache[name], jcache[name], dict(rtol=0, atol=0))


def test_write_slot_writes_every_leaf_on_its_batch_axis(fp32):
    """A slot reused by a second request carries nothing of the first:
    request A (100 tokens) is written into slot 1 and decoded, then
    request B (12 tokens) is written there. Every leaf of slot 1 is B's,
    the other slots are untouched, and JAX's ``write_slot`` gives the
    same cache."""
    jcfg, cfg, params, tp = fp32
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 100))).long()
    b = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 12))).long()
    cache = registry.init_cache(cfg, 3, 64, "cpu")
    for leaf in cache.values():
        leaf.normal_(generator=torch.Generator().manual_seed(6))
    _, sa = registry.prefill(tp, cfg, a)
    registry.write_slot(cfg, cache, sa, 1)
    for t in range(4):
        registry.decode_cached(tp, cfg, cache,
                               torch.tensor([1, 2, 3], dtype=torch.int32),
                               torch.tensor([5, 100 + t, 9],
                                            dtype=torch.int32))
    before = {k: v.clone() for k, v in cache.items()}
    jcache = {k: jnp.asarray(v.numpy()) for k, v in cache.items()}
    _, sb = registry.prefill(tp, cfg, b)
    registry.write_slot(cfg, cache, sb, 1)
    jcache = jregistry.write_slot(
        jcfg, jcache, {k: jnp.asarray(v.numpy()) for k, v in sb.items()},
        1, 64)
    _, axes = registry.cache_spec(cfg, 1, 1)
    assert axes["mC"].index("batch") == 2
    for name, leaf in cache.items():
        _close(leaf, jcache[name], dict(rtol=0, atol=0))
        ba = axes[name].index("batch")
        assert torch.equal(leaf.narrow(ba, 1, 1), sb[name]), name
        for other in (0, 2):
            assert torch.equal(leaf.narrow(ba, other, 1),
                               before[name].narrow(ba, other, 1))


def test_a_warm_up_leaves_the_state_as_it_was(fp32):
    """A capture first runs warm-up passes of the step, which must leave
    every recurrent leaf as it was; here the CPU engine runs them after
    every step and its streams stay those of a run without them."""
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


# -- serving ------------------------------------------------------------------

def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bench():
    return _load("serve_bench_for_xlstm_tests",
                 REPO / "benchmarks" / "serve_bench.py")


def test_engine_smoke_requests_equal_the_jax_engine(key0):
    """``tests/test_serving.py::test_engine_smoke_all_families``' requests
    (prompts of 5, 8 and 6 tokens, 3 new, 2 slots), on the weights as
    ``PRNGKey(0)`` draws them."""
    jcfg, cfg, params, tp = key0
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


def _mix(bench, mix, jcfg):
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


@pytest.mark.parametrize("mix", MIXES)
def test_streams_equal_the_jax_engine(mix, fp32, bench):
    jcfg, cfg, params, tp = fp32
    reqs, kw, px, jx = _mix(bench, mix, jcfg)
    assert max(len(r.prompt) for r in reqs) <= 127 or mix == "chaos_mix"
    jllm = JaxLLMEngine(params, jcfg, **kw, **jx)
    args = ([r.prompt for r in reqs],)
    gen = dict(max_new_tokens=[r.max_new_tokens for r in reqs],
               priorities=[r.priority for r in reqs])
    jouts = jllm.generate(*args, **gen)
    llm = LLMEngine(tp, cfg, device="cpu", **kw, **px)
    outs = llm.generate(*args, **gen)
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


def test_the_engine_refuses_paged(fp32):
    _, cfg, _, tp = fp32
    assert not registry.paged_ok(cfg) and not registry.prefix_cache_ok(cfg)
    with pytest.raises(ValueError, match="cannot serve from a paged pool"):
        Engine(tp, cfg, slots=2, max_seq=64, device="cpu",
               cache_manager=CacheConfig(paged=True))
