"""Swap and recompute preemption, the static decode carry, and the JAX
serving goldens, for the PyTorch port on the CPU at the reduced
qwen2-0.5b config.

* The three oversubscribed settings of ``tests/test_serving.py`` (swap,
  forced round trips, recompute) go through the JAX ``Engine`` and the
  port's ``Engine(device="cpu")``, both with the prefix cache off,
  on the same fp32 weights (JAX ``PRNGKey(0)``, through
  ``convert.params_from_jax``). Streams, ``steps``, ``readbacks``,
  ``preemptions`` and ``prefill_compiles`` are equal, ``PagePool.check()``
  holds after every step, and every page is released at the end.
* The static carry: every carry buffer keeps its ``data_ptr()`` across
  admissions, steps, swap-outs and restores; the device page table equals
  the host one at every dispatch and is copied only on steps where the
  host table changed. A capture's warm-up passes leave no trace on either
  cache layout: streams and every cache byte are those of a run without
  them.
* The goldens ``benchmarks/golden/serve_qwen2-0.5b_{uniform_short,
  long_tail,ragged_burst,oversubscribed}.json`` (bf16, JAX ``PRNGKey(0)``
  weights drawn with the non-partitionable threefry the goldens were
  recorded under, the requests of
  ``benchmarks/serve_bench.py::build_requests`` and each file's
  ``engine_kw``): a port stream may leave the golden one
  only at a step where the JAX top-2 logit margin is within the bf16
  tolerance (3e-2 / 3e-2, the JAX package's ``core/agents.py``).
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
from repro.serving import cache_manager as jcache_manager  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import convert, registry  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    CacheConfig, Engine, LLMEngine, Request)
from repro_torch.serving import engine as engine_mod  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ARCH = "qwen2-0.5b"
BF16 = dict(rtol=3e-2, atol=3e-2)
# tests/test_serving.py's oversubscribed settings: 3 slots, max_seq 64,
# pages of 16
SETTINGS = {
    "swap": dict(lens=[30, 25, 28, 21, 26], max_new=20, num_pages=6,
                 preemption="swap"),
    "round_trips": dict(lens=[20, 17, 23], max_new=30, num_pages=4,
                        preemption="swap"),
    "recompute": dict(lens=[22, 19, 26], max_new=25, num_pages=4,
                      preemption="recompute"),
}
GOLDEN_MIXES = ("uniform_short", "long_tail", "ragged_burst",
                "oversubscribed")


@pytest.fixture(scope="module")
def fp32():
    """(jax cfg, port cfg, jax params, numpy params), fp32, PRNGKey(0)."""
    jcfg = dataclasses.replace(jconfigs.smoke(ARCH), dtype="float32")
    cfg = dataclasses.replace(configs.smoke(ARCH), dtype="float32")
    params, _ = jregistry.init(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, params, jax.tree.map(np.asarray, params)


def _prompts(vocab, lens):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, (n,), dtype=np.int32) for n in lens]


@pytest.fixture(scope="module")
def jax_runs(fp32):
    """Each setting through the JAX engine, once: (streams, stats)."""
    jcfg, _, params, _ = fp32
    out = {}

    def run(name):
        if name not in out:
            s = SETTINGS[name]
            eng = JaxEngine(params, jcfg, slots=3, max_seq=64,
                            preemption=s["preemption"],
                            cache_manager=jcache_manager.CacheConfig(
                                page_size=16, num_pages=s["num_pages"],
                                prefix_cache=False))
            for rid, p in enumerate(_prompts(jcfg.vocab, s["lens"])):
                eng.submit(JaxRequest(rid=rid, prompt=p,
                                      max_new_tokens=s["max_new"]))
            done = eng.run()
            out[name] = ({r.rid: list(r.out_tokens) for r in done},
                         eng.stats())
        return out[name]
    return run


def _carry(eng):
    return {"token": eng._token, "pos": eng._pos, "active": eng._active,
            "emitted": eng._emitted, "max_new": eng._max_new,
            "emit": eng._emit, "table": eng._table, "seed": eng._seed,
            "temp": eng._temp, "topk": eng._topk, "topp": eng._topp,
            **{f"cache_{k}": v for k, v in eng.cache.items()}}


@pytest.fixture(scope="module")
def port_runs(fp32):
    """Each setting through the port's engine on the CPU, stepped by
    hand: per step, the pool check, the carry's data pointers, and at
    each dispatch whether the device table equals the host one and
    whether the host table changed since the last copy."""
    _, cfg, _, tree = fp32
    params = convert.params_from_jax(tree, cfg, "cpu")
    out = {}

    def run(name):
        if name not in out:
            s = SETTINGS[name]
            eng = Engine(params, cfg, slots=3, max_seq=64, device="cpu",
                         preemption=s["preemption"],
                         cache_manager=CacheConfig(page_size=16,
                                                   num_pages=s["num_pages"],
                                                   prefix_cache=False))
            ptrs0 = {k: v.data_ptr() for k, v in _carry(eng).items()}
            dispatches = []
            body = eng._step_body

            def spy():
                dispatches.append(dict(
                    table_equal=bool(torch.equal(
                        eng._table,
                        torch.from_numpy(eng.cm.page_table()))),
                    uploads=eng._table_uploads,
                    version=eng.cm.table_version))
                body()
            eng._step_body = spy
            for rid, p in enumerate(_prompts(cfg.vocab, s["lens"])):
                eng.submit(Request(rid=rid, prompt=p,
                                   max_new_tokens=s["max_new"]))
            checks, moved = [], []
            while eng.has_work() and eng.step():
                eng.cm.pool.check()
                checks.append(True)
                moved += [k for k, v in _carry(eng).items()
                          if v.data_ptr() != ptrs0[k]]
            eng._drain()
            eng.cm.pool.check()
            out[name] = dict(
                streams={r.rid: list(r.out_tokens) for r in eng.finished},
                stats=eng.stats(), eng=eng, checks=len(checks),
                moved=moved, dispatches=dispatches)
        return out[name]
    return run


@pytest.mark.parametrize("name", list(SETTINGS))
def test_preemption_matches_jax(name, jax_runs, port_runs):
    jstreams, js = jax_runs(name)
    run = port_runs(name)
    ts, eng = run["stats"], run["eng"]
    assert js["preemptions"] >= 1
    assert run["streams"] == jstreams
    for key in ("steps", "readbacks", "preemptions", "prefill_compiles"):
        assert ts[key] == js[key], key
    assert ts["readbacks"] == ts["steps"] == run["checks"]
    assert ts["preempt_mode"] == SETTINGS[name]["preemption"]
    assert all(r.done and r.finish_reason == "done" for r in eng.finished)
    assert sum(r.preemptions for r in eng.finished) == ts["preemptions"]
    # every page released, every table row back on the trap page
    assert all(not pages for pages in eng.cm.pool.owned)
    assert eng.cm.pool.pages_in_use == 0
    assert not eng.cm.pool.table.any()
    if SETTINGS[name]["preemption"] == "swap":
        assert ts["swapped_out_pages"] == ts["swapped_in_pages"] > 0
    else:
        assert ts["swapped_out_pages"] == ts["swapped_in_pages"] == 0


@pytest.mark.parametrize("name", list(SETTINGS))
def test_static_carry_keeps_its_buffers(name, port_runs):
    run = port_runs(name)
    assert run["stats"]["preemptions"] >= 1
    assert run["moved"] == []


@pytest.mark.parametrize("name", list(SETTINGS))
def test_page_table_is_copied_only_when_it_changed(name, port_runs):
    run = port_runs(name)
    seen = run["dispatches"]
    assert len(seen) == run["stats"]["steps"]
    assert all(d["table_equal"] for d in seen)
    uploads = [b["uploads"] - a["uploads"] for a, b in zip(seen, seen[1:])]
    changed = [b["version"] != a["version"] for a, b in zip(seen, seen[1:])]
    # a copy before dispatch k+1 exactly when the table changed after
    # dispatch k's copy
    assert uploads == [int(c) for c in changed]
    assert 0 < run["stats"]["table_uploads"] < run["stats"]["steps"]


def test_read_pages_matches_jax_and_inverts_write_pages(fp32):
    jcfg, cfg, _, _ = fp32
    rng = np.random.default_rng(3)
    shape = (cfg.n_layers, 7, 16, cfg.n_kv_heads, cfg.head_dim)
    pool = {k: rng.standard_normal(shape).astype(np.float32)
            for k in ("k", "v")}
    pages = np.array([5, 2, 6], np.int64)
    got = registry.read_pages(cfg, {k: torch.from_numpy(v)
                                    for k, v in pool.items()},
                              torch.from_numpy(pages), 16)
    want = jregistry.read_pages(jcfg, {k: jnp.asarray(v)
                                       for k, v in pool.items()},
                                jnp.asarray(pages.astype(np.int32)), 16)
    fresh = registry.init_paged_cache(cfg, 7, 16, "cpu")
    registry.write_pages(cfg, fresh, got, torch.from_numpy(pages), 16)
    for k in ("k", "v"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        np.testing.assert_array_equal(fresh[k][:, pages].numpy(),
                                      pool[k][:, pages])


@pytest.mark.parametrize("arch,paged", [(ARCH, True), (ARCH, False),
                                        ("h2o-danube-1.8b", False)])
def test_capture_warm_up_leaves_no_trace(arch, paged, monkeypatch):
    """A warm-up before every dispatch (what a capture runs, on the card
    only at construction and when the genomes change) changes no stream
    and no cache byte, with requests resident, idle and finished."""
    cfg = dataclasses.replace(configs.smoke(arch), dtype="float32")
    params = registry.init_params(cfg, seed=4, device="cpu")
    lens = [5, 40, 12, 70, 9] if cfg.window else [5, 30, 12, 17, 9]
    max_seq = 128 if cfg.window else 64
    runs = []
    for warm in (False, True):
        eng = Engine(params, cfg, slots=3, max_seq=max_seq, device="cpu",
                     cache_manager=CacheConfig(paged=paged))
        if warm:
            body = eng._step_body

            def warmed(eng=eng, body=body):
                eng._step_body = body
                eng._warm_up()
                body()
                eng._step_body = warmed
            eng._step_body = warmed
        for rid, p in enumerate(_prompts(cfg.vocab, lens)):
            eng.submit(Request(rid=rid, prompt=p, max_new_tokens=6 + rid))
        eng.run()
        runs.append(({r.rid: list(r.out_tokens) for r in eng.finished},
                     {k: v.clone() for k, v in eng.cache.items()},
                     eng.stats()))
    (s0, c0, st0), (s1, c1, st1) = runs
    assert st1["capture_warmups"] == engine_mod.WARMUP_STEPS * st1["steps"]
    assert s0 == s1 and st0["steps"] == st1["steps"]
    for k in c0:
        assert torch.equal(c0[k], c1[k]), k


# -- the JAX goldens ---------------------------------------------------------

def _serve_bench():
    spec = importlib.util.spec_from_file_location(
        "serve_bench_for_port_tests", REPO / "benchmarks" / "serve_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def golden_setup():
    """(jax cfg, port cfg, jax params, port params on the CPU,
    serve_bench module): bf16 smoke qwen2 on PRNGKey(0) weights."""
    jcfg = jconfigs.smoke(ARCH)
    cfg = configs.smoke(ARCH)
    assert jcfg.dtype == cfg.dtype == "bfloat16"
    # the goldens were recorded under JAX's earlier default threefry
    # (not partitionable); since JAX 0.5 PRNGKey(0) draws other weights
    with jax.threefry_partitionable(False):
        params, _ = jregistry.init(jcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, params), cfg,
                                      "cpu")
    return jcfg, cfg, params, tparams, _serve_bench()


@pytest.mark.parametrize("mix", GOLDEN_MIXES)
def test_golden_streams_hold_under_the_bf16_rule(mix, golden_setup):
    jcfg, cfg, jparams, tparams, bench = golden_setup
    gold = json.loads((REPO / "benchmarks" / "golden"
                       / f"serve_qwen2-0.5b_{mix}.json").read_text())
    reqs = bench.build_requests(jcfg, mix, seed=gold["seed"])
    assert all(r.max_new_tokens == gold["max_new"] for r in reqs)
    llm = LLMEngine(tparams, cfg, slots=gold["slots"],
                    max_seq=gold["max_seq"], device="cpu",
                    **gold["engine_kw"])
    outs = llm.generate([r.prompt for r in reqs],
                        max_new_tokens=gold["max_new"])
    st = llm.stats()
    assert st["readbacks"] == st["steps"]
    if mix == "oversubscribed":
        assert st["preemptions"] >= 1
        assert st["num_pages"] == gold["engine_kw"]["num_pages"]
    assert sorted(gold["streams"], key=int) == [str(o.rid) for o in outs]
    for req, out in zip(reqs, outs):
        want = gold["streams"][str(out.rid)]
        assert out.finish_reason == "done"
        assert len(out.tokens) == len(want)
        diff = [i for i, (a, b) in enumerate(zip(want, out.tokens))
                if a != b]
        if not diff:
            continue
        # the first divergence must sit on a near-tie of the JAX logits
        i = diff[0]
        seq = np.concatenate([req.prompt, np.asarray(want[:i], np.int32)])
        logits, _ = jtransformer.prefill(jparams, jcfg,
                                         jnp.asarray(seq[None]))
        lg = np.asarray(logits[0], np.float32)
        a, b = lg[want[i]], lg[out.tokens[i]]
        assert abs(a - b) <= BF16["atol"] + BF16["rtol"] * abs(a), \
            (out.rid, i, a, b)
