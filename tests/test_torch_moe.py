"""The mixture-of-experts family (olmoe-1b-7b, granite-moe-3b-a800m) of the
PyTorch port against the JAX package, on the CPU at the reduced configs.

* ``capacity`` equals JAX's; ``moe_block`` equals JAX's in fp32 (rtol
  1e-5 / atol 1e-4) and bf16 (3e-2, the JAX package's kernel tolerance)
  on a plain input, with a forced capacity drop and on an exact router
  tie (JAX's ``lax.top_k`` takes the lower index first); prefill and
  decode logits and caches equal JAX's in fp32 for both configs; both
  sides refuse a prompt that does not split into dispatch groups (300
  tokens) and take 256 and 512; ``params_from_jax`` keeps the router in
  fp32.
* Serving: greedy streams, ``steps`` and ``prefill_compiles`` equal the
  JAX engine's in fp32 (JAX ``PRNGKey(0)`` weights through
  ``convert.params_from_jax``) on the serve benchmark's mixes, and with
  more slots than the decode capacity (idle slots compete for it); the
  engine picks the contiguous cache, refuses ``paged=True``, ignores
  ``num_pages`` / ``page_size``, leaves ``spec=`` inert and lets a
  ``pool_exhaustion`` fault fire without effect; an MoE draft model is
  refused with JAX's error.
* The eight goldens ``benchmarks/golden/serve_olmoe-1b-7b_*.json`` (bf16,
  weights drawn with the non-partitionable threefry they were recorded
  under, the requests of ``benchmarks/serve_bench.py::build_requests`` and
  each file's ``engine_kw``): a port stream may leave the golden one only
  at a token where the JAX prefill's logits of the two tokens are within
  the bf16 tolerance.
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
from repro.models import moe as jmoe  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.serving import CacheConfig as JaxCacheConfig  # noqa: E402
from repro.serving import Engine as JaxEngine  # noqa: E402
from repro.serving import LLMEngine as JaxLLMEngine  # noqa: E402
from repro.serving import SpecConfig as JaxSpecConfig  # noqa: E402
from repro.serving.spec import make_drafter as jax_make_drafter  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import convert, moe, registry  # noqa: E402
from repro_torch.reliability import Fault  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    CacheConfig, ChaosInjector, Engine, LLMEngine, SpecConfig)
from repro_torch.serving.spec import make_drafter  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ARCH = "olmoe-1b-7b"
ARCHS = ("olmoe-1b-7b", "granite-moe-3b-a800m")
FP32 = dict(rtol=1e-5, atol=1e-4)
BF16 = dict(rtol=3e-2, atol=3e-2)
MIXES = ("uniform_short", "long_tail", "ragged_burst", "oversubscribed",
         "priority_mix", "shared_prefix", "chaos_mix", "spec_mix")
# the JAX engine's streams in fp32 are held on these
STREAM_MIXES = ("uniform_short", "long_tail", "priority_mix",
                "ragged_burst")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tests run many tiny CPU ops, which the
    thread pool only slows, and more so beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(jconfigs.smoke(arch), dtype=dtype),
            dataclasses.replace(configs.smoke(arch), dtype=dtype))


@pytest.fixture(scope="module")
def fp32():
    """{arch: (jax cfg, port cfg, jax params, port params on the CPU)},
    fp32, PRNGKey(0)."""
    out = {}
    for arch in ARCHS:
        jcfg, cfg = _cfgs(arch)
        params, _ = jregistry.init(jcfg, jax.random.PRNGKey(0))
        out[arch] = (jcfg, cfg, params, convert.params_from_jax(
            jax.tree.map(np.asarray, params), cfg, "cpu"))
    return out


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bench():
    return _load("serve_bench_for_moe_tests",
                 REPO / "benchmarks" / "serve_bench.py")


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


def _routing(p, x, cfg):
    """(slots routed past their expert's capacity, the probabilities) of
    ``moe_block(p, x, cfg)``, recomputed in numpy from the port's
    router: the test's own count of what the block drops."""
    b, s, d = x.shape
    g = min(moe.GROUP, b * s)
    xt = x.reshape(-1, g, d).astype(np.float32)
    logits = xt @ np.asarray(p["router"], np.float32)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    _, idx = moe.route(torch.from_numpy(probs), cfg.top_k)
    cap = moe.capacity(cfg, g)
    dropped = 0
    for grp in idx.numpy():
        seen = np.zeros(cfg.n_experts, int)
        for e in grp.reshape(-1):               # slot-major, as the cumsum
            dropped += seen[e] >= cap
            seen[e] += 1
    return dropped, probs


# -- the block ----------------------------------------------------------------

def test_capacity_equals_jax():
    for arch in ARCHS:
        for jcfg, cfg in ((jconfigs.get(arch), configs.get(arch)),
                          (jconfigs.smoke(arch), configs.smoke(arch))):
            for cf in (0.25, 1.0, 1.25, 2.0):
                jc = dataclasses.replace(jcfg, capacity_factor=cf)
                tc = dataclasses.replace(cfg, capacity_factor=cf)
                for g in (1, 2, 7, 8, 9, 16, 40, 100, 255, 256):
                    assert moe.capacity(tc, g) == jmoe.capacity(jc, g), \
                        (arch, cf, g)
    assert moe.capacity(configs.get(ARCH), 8) == 8      # decode, 8 slots
    assert moe.capacity(configs.get(ARCH), 256) == 40   # a 256-token prompt


def _block_case(case, jcfg, cfg, params):
    """(jax cfg, port cfg, jax layer, x [2, 24, D]) of one case."""
    p = jax.tree.map(lambda a: a[0], params["layers"])
    x = np.random.default_rng(3).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    if case == "drop":
        jcfg = dataclasses.replace(jcfg, capacity_factor=0.25)
        cfg = dataclasses.replace(cfg, capacity_factor=0.25)
    if case == "tie":
        # router = the first E coordinates: logits (0, 1, 1, 2) tie
        # experts 1 and 2 at top-k's second place on six tokens, where
        # torch.topk on the CPU picks expert 2 and JAX expert 1
        router = np.zeros((cfg.d_model, cfg.n_experts), np.float32)
        router[np.arange(cfg.n_experts), np.arange(cfg.n_experts)] = 1.0
        p = dict(p, router=jnp.asarray(router))
        x[0, :6, :4] = (0.0, 1.0, 1.0, 2.0)
    return jcfg, cfg, p, x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["plain", "drop", "tie"])
def test_moe_block_matches_jax(case, dtype, fp32):
    jcfg, cfg, params, _ = fp32[ARCH]
    jcfg, cfg, p, x = _block_case(case, jcfg, cfg, params)
    jcfg = dataclasses.replace(jcfg, dtype=dtype)
    cfg = dataclasses.replace(cfg, dtype=dtype)
    tp = moe.cast_params(jax.tree.map(
        lambda a: torch.from_numpy(np.array(a, np.float32)), p), cfg, "cpu")
    assert tp["router"].dtype == torch.float32
    xj = jnp.asarray(x).astype(jcfg.jnp_dtype)
    want = np.asarray(jmoe.moe_block(p, xj, jcfg).astype(jnp.float32))
    xt = torch.from_numpy(x).to(cfg.torch_dtype)
    got = moe.moe_block(tp, xt, cfg).float().numpy()
    _close(got, want, FP32 if dtype == "float32" else BF16)
    dropped, probs = _routing(tp, xt.float().numpy(), cfg)
    if case == "drop":
        assert dropped > 0
    if case == "tie":
        tied = probs.reshape(2, 24, -1)[0, :6]
        assert (tied[:, 1] == tied[:, 2]).all()
        _, idx = moe.route(torch.from_numpy(probs), cfg.top_k)
        assert (idx.reshape(2, 24, -1)[0, :6].numpy() == (3, 1)).all()
        _, jidx = jax.lax.top_k(jnp.asarray(probs), cfg.top_k)
        assert (np.asarray(jidx) == idx.numpy()).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, fp32):
    jcfg, cfg, params, tp = fp32[arch]
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab, (3, 20)).astype(np.int32)
    jl, jc = jmoe.prefill(params, jcfg, jnp.asarray(toks), cache_len=32)
    tl, tc = registry.prefill(tp, cfg, torch.from_numpy(toks).long(),
                              cache_len=32)
    _close(tl, jl, FP32)
    for k in ("k", "v"):
        _close(tc[k], jc[k], FP32)
    pos = np.array([20, 20, 20], np.int32)
    for step in range(3):
        tok = rng.integers(0, cfg.vocab, 3).astype(np.int32)
        jl, jc = jmoe.decode_step(params, jcfg, jc, jnp.asarray(tok),
                                  jnp.asarray(pos))
        tl, tc = registry.decode_cached(tp, cfg, tc, torch.from_numpy(tok),
                                        torch.from_numpy(pos))
        _close(tl, jl, FP32)
        for k in ("k", "v"):
            _close(tc[k], jc[k], FP32)
        pos = pos + 1


def test_group_limit_raises_on_both_sides(fp32, monkeypatch):
    """JAX reshapes the tokens into groups of min(256, b*s): 300 fails
    there (TypeError) and here (ValueError naming GROUP, before any
    kernel call); 256 and 512 pass on both sides."""
    jcfg, cfg, params, tp = fp32[ARCH]
    calls = []
    rms = ops.fused_add_rmsnorm
    monkeypatch.setattr(ops, "fused_add_rmsnorm",
                        lambda *a, **kw: calls.append(1) or rms(*a, **kw))
    rng = np.random.default_rng(5)
    for n in (256, 300, 512):
        toks = rng.integers(0, cfg.vocab, (1, n)).astype(np.int32)
        if n == 300:
            with pytest.raises(TypeError):
                jmoe.prefill(params, jcfg, jnp.asarray(toks))
            with pytest.raises(ValueError, match="GROUP=256"):
                registry.prefill(tp, cfg, torch.from_numpy(toks).long())
            assert not calls
            continue
        jl, _ = jmoe.prefill(params, jcfg, jnp.asarray(toks))
        tl, _ = registry.prefill(tp, cfg, torch.from_numpy(toks).long())
        _close(tl, jl, FP32)
        calls.clear()


def test_params_from_jax_keeps_the_router_fp32(fp32):
    jcfg, cfg, params, _ = fp32[ARCH]
    bcfg = dataclasses.replace(cfg, dtype="bfloat16")
    tree = jax.tree.map(np.asarray, params)
    tp = convert.params_from_jax(tree, bcfg, "cpu")
    assert len(tp["layers"]) == cfg.n_layers
    for i, layer in enumerate(tp["layers"]):
        assert layer["router"].dtype == torch.float32
        assert np.array_equal(layer["router"].numpy(),
                              tree["layers"]["router"][i])
        assert layer["attn_norm"].dtype == torch.float32
        for name in ("w_gateup", "w_down"):
            assert layer[name].dtype == torch.bfloat16
            assert torch.equal(layer[name], torch.from_numpy(
                np.array(tree["layers"][name][i])).to(torch.bfloat16))
        assert layer["attn"]["wq"].dtype == torch.bfloat16
    assert tp["layers"][0]["w_gateup"].shape == (
        cfg.n_experts, cfg.d_model, 2 * cfg.expert_ff)
    assert tp["layers"][0]["w_down"].shape == (
        cfg.n_experts, cfg.expert_ff, cfg.d_model)
    # the engine's cast and a seeded init keep it too
    eng = Engine(tp, bcfg, slots=2, max_seq=64, device="cpu")
    assert eng.params["layers"][0]["router"].dtype == torch.float32
    own = registry.init_params(bcfg, seed=1, device="cpu")
    assert own["layers"][1]["router"].dtype == torch.float32
    assert own["layers"][1]["w_down"].dtype == torch.bfloat16


# -- serving against the JAX engine -------------------------------------------

def _mix_kw(bench, mix, cfg, tp, jcfg, params):
    """(engine kwargs, port extras, JAX extras) of one benchmark mix."""
    kw = dict(slots=bench.SLOTS, max_seq=bench.MAX_SEQ)
    kw.update(bench.MIX_ENGINE_KW.get(mix, {}))
    px, jx = {}, {}
    if mix == "chaos_mix":
        px["chaos"] = ChaosInjector([Fault(**dataclasses.asdict(f))
                                     for f in bench._chaos_plan()])
    if mix == "spec_mix":
        px["spec"] = SpecConfig("draft_model", k=bench.SPEC_K,
                                draft_params=tp, draft_cfg=cfg)
        jx["spec"] = JaxSpecConfig("draft_model", k=bench.SPEC_K,
                                   draft_params=params, draft_cfg=jcfg)
    return kw, px, jx


def _generate(llm, reqs):
    return llm.generate([r.prompt for r in reqs],
                        max_new_tokens=[r.max_new_tokens for r in reqs],
                        priorities=[r.priority for r in reqs])


@pytest.mark.parametrize("mix", STREAM_MIXES)
def test_streams_equal_the_jax_engine(mix, fp32, bench):
    jcfg, cfg, params, tp = fp32[ARCH]
    reqs = bench.build_requests(jcfg, mix)
    kw, px, jx = _mix_kw(bench, mix, cfg, tp, jcfg, params)
    jllm = JaxLLMEngine(params, jcfg, **kw, **jx)
    jouts = _generate(jllm, reqs)
    llm = LLMEngine(tp, cfg, device="cpu", **kw, **px)
    outs = _generate(llm, reqs)
    js, st = jllm.stats(), llm.stats()
    assert [o.tokens for o in outs] == [o.tokens for o in jouts]
    assert [o.finish_reason for o in outs] == ["done"] * len(reqs)
    for key in ("steps", "readbacks", "prefill_compiles", "paged",
                "pad_prefill"):
        assert st[key] == js[key], key
    assert not st["paged"] and not st["pad_prefill"]
    # exact-length prefill: one compiled shape a distinct prompt length
    assert st["prefill_compiles"] == len({len(r.prompt) for r in reqs})


CHAOS_PLAN = [dict(kind="abort", step=3, rid=2),
              dict(kind="device_fault", step=5, slot=1),
              dict(kind="corrupt_readback", step=8, slot=4)]


@pytest.mark.parametrize("chaos", [False, True])
def test_idle_slots_compete_for_capacity_as_in_jax(chaos, fp32,
                                                   monkeypatch):
    """Twelve slots against a decode capacity of 8: finished slots keep
    feeding their last token at an advancing position, as the JAX
    engine's do, and their rows take capacity from the live ones. The
    streams, finish reasons and steps equal JAX's, and decode steps did
    drop slots; also under an abort, a device fault (the recovery resets
    every slot's carry) and a corrupt readback."""
    from repro.reliability import Fault as JaxFault
    from repro.serving import ChaosInjector as JaxChaosInjector
    jcfg, cfg, params, tp = fp32[ARCH]
    assert moe.capacity(cfg, 12) == 8
    lens = [5, 9, 3, 12, 7, 4, 10, 6, 8, 11, 5, 9, 6, 7]
    max_new = [3, 12, 5, 9, 2, 14, 6, 11, 4, 8, 10, 3, 7, 13]
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]
    drops = []
    block = moe.moe_block

    def counting(p, x, c):
        if x.shape[1] == 1:                      # a decode step
            drops.append(_routing(p, x.float().numpy(), c)[0])
        return block(p, x, c)
    monkeypatch.setattr(moe, "moe_block", counting)
    plan = CHAOS_PLAN if chaos else []
    llm = LLMEngine(tp, cfg, slots=12, max_seq=64, device="cpu",
                    chaos=[Fault(**f) for f in plan] or None)
    outs = llm.generate(prompts, max_new_tokens=max_new)
    jllm = JaxLLMEngine(params, jcfg, slots=12, max_seq=64,
                        chaos=JaxChaosInjector([JaxFault(**f) for f in plan])
                        if chaos else None)
    jouts = jllm.generate(prompts, max_new_tokens=max_new)
    assert [o.tokens for o in outs] == [o.tokens for o in jouts]
    assert [o.finish_reason for o in outs] \
        == [o.finish_reason for o in jouts]
    for key in ("steps", "recoveries", "failed", "aborted"):
        assert llm.stats()[key] == jllm.stats()[key], key
    assert llm.stats()["recoveries"] == int(chaos)
    assert sum(drops) > 0


# -- the engine's family flags ------------------------------------------------

def test_the_engine_serves_moe_contiguous_and_refuses_paged(fp32):
    jcfg, cfg, params, tp = fp32[ARCH]
    assert not registry.paged_ok(cfg) and not registry.pad_prefill_ok(cfg)
    assert not registry.prefix_cache_ok(cfg)
    assert registry.paged_ok(configs.smoke("qwen2-0.5b"))
    eng = Engine(tp, cfg, slots=2, max_seq=64, device="cpu")
    assert not eng.stats()["paged"] and not eng.cm.prefix_cache
    with pytest.raises(ValueError, match="cannot serve from a paged pool"):
        Engine(tp, cfg, slots=2, max_seq=64, device="cpu",
               cache_manager=CacheConfig(paged=True))
    with pytest.raises(ValueError, match="cannot serve from a paged pool"):
        JaxEngine(params, jcfg, slots=2, max_seq=64,
                  cache_manager=JaxCacheConfig(paged=True))


def test_num_pages_and_page_size_are_ignored_on_the_contiguous_cache(fp32):
    _, cfg, _, tp = fp32[ARCH]
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (40, 70, 55, 62)]
    runs = []
    for kw in ({}, dict(num_pages=12, page_size=16),
               dict(num_pages=3, page_size=24)):
        llm = LLMEngine(tp, cfg, slots=4, max_seq=128, device="cpu", **kw)
        outs = llm.generate(prompts, max_new_tokens=10)
        st = llm.stats()
        assert not st["paged"] and "num_pages" not in st
        assert st["preemptions"] == 0
        runs.append(([o.tokens for o in outs], st["steps"]))
    assert runs[0] == runs[1] == runs[2]


def test_spec_is_inert_and_an_moe_draft_is_refused(fp32):
    jcfg, cfg, params, tp = fp32[ARCH]
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab, 8).astype(np.int32)
               for _ in range(3)]
    gold = [o.tokens for o in LLMEngine(
        tp, cfg, slots=3, max_seq=64, device="cpu").generate(
            prompts, max_new_tokens=5)]
    for spec in (SpecConfig(drafter="ngram", k=3),
                 SpecConfig("draft_model", k=3, draft_params=tp,
                            draft_cfg=cfg)):
        llm = LLMEngine(tp, cfg, slots=3, max_seq=64, device="cpu",
                        spec=spec)
        outs = llm.generate(prompts, max_new_tokens=5)
        st = llm.stats()
        assert not st["spec_on"] and st["draft_tokens"] == 0
        assert st["accepted_tokens"] == 0
        assert st["accepted_per_step"] == 0.0
        assert [o.tokens for o in outs] == gold
    dense_j, dense = _cfgs("qwen2-0.5b")
    needle = "draft family 'moe' has no exact right-padded prefill"
    with pytest.raises(ValueError, match=needle):
        make_drafter(SpecConfig("draft_model", k=2, draft_params=tp,
                                draft_cfg=cfg), dense, 2, 64, "cpu")
    with pytest.raises(ValueError, match=needle):
        jax_make_drafter(JaxSpecConfig("draft_model", k=2,
                                       draft_params=params, draft_cfg=jcfg),
                         dense_j, 2, 64)


def test_pool_exhaustion_fires_without_effect(fp32):
    _, cfg, _, tp = fp32[ARCH]
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (20, 33, 27, 41, 25)]
    gold = LLMEngine(tp, cfg, slots=3, max_seq=64, device="cpu").generate(
        prompts, max_new_tokens=8)
    chaos = ChaosInjector([Fault("pool_exhaustion", step=2, pages=5,
                                 steps=4)])
    llm = LLMEngine(tp, cfg, slots=3, max_seq=64, device="cpu",
                    chaos=chaos)
    outs = llm.generate(prompts, max_new_tokens=8)
    assert chaos.exhausted
    assert llm.stats()["chaos_injected"].get("pool_exhaustion", 0) == 0
    assert [o.tokens for o in outs] == [o.tokens for o in gold]


# -- the eight olmoe goldens --------------------------------------------------

@pytest.fixture(scope="module")
def golden_setup():
    """(jax cfg, port cfg, jax params, port params on the CPU): bf16
    smoke olmoe on PRNGKey(0) weights, drawn under the non-partitionable
    threefry the goldens were recorded under."""
    jcfg, cfg = jconfigs.smoke(ARCH), configs.smoke(ARCH)
    assert jcfg.dtype == cfg.dtype == "bfloat16"
    with jax.threefry_partitionable(False):
        params, _ = jregistry.init(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, params), cfg,
                                 "cpu")
    return jcfg, cfg, params, tp


@pytest.mark.parametrize("mix", MIXES)
def test_golden_streams_hold_under_the_bf16_rule(mix, golden_setup, bench):
    jcfg, cfg, params, tp = golden_setup
    gold = json.loads((REPO / "benchmarks" / "golden"
                       / f"serve_{ARCH}_{mix}.json").read_text())
    assert gold["slots"] == bench.SLOTS and gold["seed"] == bench.SEED
    reqs = bench.build_requests(jcfg, mix, seed=gold["seed"])
    assert all(r.max_new_tokens == gold["max_new"] for r in reqs)
    kw, px, _ = _mix_kw(bench, mix, cfg, tp, jcfg, params)
    assert kw == {"slots": gold["slots"], "max_seq": gold["max_seq"],
                  **gold["engine_kw"]}
    llm = LLMEngine(tp, cfg, device="cpu", **kw, **px)
    outs = _generate(llm, reqs)
    st = llm.stats()
    assert st["readbacks"] == st["steps"] and not st["paged"]
    if mix == "chaos_mix":
        assert px["chaos"].exhausted
        assert (st["aborted"], st["rejected"], st["recoveries"]) == (2, 2, 1)
    if mix == "spec_mix":
        assert not st["spec_on"] and st["draft_tokens"] == 0
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
        logits, _ = jmoe.prefill(params, jcfg, jnp.asarray(seq[None]))
        lg = np.asarray(logits[0], np.float32)
        a, b = lg[want[i]], lg[out.tokens[i]]
        assert abs(a - b) <= BF16["atol"] + BF16["rtol"] * abs(a), \
            (out.rid, i, a, b)
