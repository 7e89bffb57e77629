"""Speculative decoding of the PyTorch port against the JAX package, on the
CPU at the reduced qwen2-0.5b config (the counterparts of
``tests/test_spec.py``).

* Both drafters' proposals equal JAX's on the same histories (the draft
  model's, and its cache, after the same prefills and passes), and a
  draft slot's copy restores byte for byte.
* ``write_mask``: the rows it masks write the trap page only, the others
  keep their logits and writes, and after spec steps with rejected drafts
  the pool's pages (the trap page aside) hold JAX's bytes.
* Spec serves on the same fp32 weights (JAX ``PRNGKey(0)``) through the
  JAX ``Engine`` and the port's ``Engine(device="cpu")``, both drafters,
  plain, under swap and recompute preemption and with the prefix cache:
  streams equal JAX's and the target-only run's, and ``steps``,
  ``readbacks``, ``draft_tokens``, ``accepted_tokens``,
  ``accepted_per_step``, ``accept_rate``, ``preemptions`` and the prefix
  counters equal JAX's; the pool check (every position a step may write)
  holds after every step.
* Abort mid-burst and crash recovery with the draft model (the draft
  rows restored byte for byte, every tensor of the step in place), equal
  to JAX's runs.
* Admission rejects sampled requests; spec is inert on the contiguous
  cache; ``SpecConfig`` and ``make_drafter`` refuse what JAX refuses.
* The ``spec_mix`` golden (bf16, weights drawn inside
  ``jax.threefry_partitionable(False)``) under the bf16 rule, and
  ``space.autotune``'s validity oracle.
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
from repro.serving.cache_manager import (  # noqa: E402
    CacheConfig as JaxCacheConfig)
from repro.serving.chaos import ChaosInjector as JaxChaos  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.engine import _Slot as JaxSlot  # noqa: E402
from repro.serving.spec import SpecConfig as JaxSpecConfig  # noqa: E402
from repro.serving.spec.drafter import (  # noqa: E402
    DraftModelDrafter as JaxDraftModelDrafter)
from repro.serving.spec.drafter import (  # noqa: E402
    NGramDrafter as JaxNGramDrafter)
from repro_torch import configs  # noqa: E402
from repro_torch.models import convert, registry  # noqa: E402
from repro_torch.reliability import Fault  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    CacheConfig, DraftModelDrafter, Engine, LLMEngine, NGramDrafter, Request,
    SamplingParams, SpecConfig)
from repro_torch.serving.engine import _Slot  # noqa: E402
from repro_torch.serving.spec import DRAFTERS, make_drafter  # noqa: E402
from repro_torch.serving.spec import space  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ARCH = "qwen2-0.5b"
FP32 = dict(rtol=1e-5, atol=1e-4)
BF16 = dict(rtol=3e-2, atol=3e-2)
SPEC_COUNTERS = ("steps", "readbacks", "draft_tokens", "accepted_tokens",
                 "accepted_per_step", "accept_rate", "preemptions",
                 "aborted", "failed", "recoveries")


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


def _specs(fp32, drafter, k=3):
    """(port, JAX) configs: n-gram lookup, or the target drafting for
    itself (every draft accepted: the verify commits whole rows)."""
    jcfg, cfg, params, tparams = fp32
    if drafter == "ngram":
        return SpecConfig("ngram", k=k), JaxSpecConfig("ngram", k=k)
    return (SpecConfig("draft_model", k=k, draft_params=tparams,
                       draft_cfg=cfg),
            JaxSpecConfig("draft_model", k=k, draft_params=params,
                          draft_cfg=jcfg))


def _shared_prompts(vocab):
    rng = np.random.default_rng(0)
    base = rng.integers(0, vocab, (48,), dtype=np.int32)
    tail = rng.integers(0, vocab, (5,), dtype=np.int32)
    return [base[:32], base[:48], np.concatenate([base[:32], tail]),
            base[:48].copy()]


# (prompts, max_new, slots, cache settings, preemption); a repeated
# pattern in the "plain" prompts gives the n-gram drafter hits
SETTINGS = {
    "plain": dict(max_new=10, slots=2, cm=dict(prefix_cache=False)),
    "swap": dict(max_new=16, slots=3, lens=[22, 19, 26],
                 cm=dict(num_pages=4, prefix_cache=False)),
    "recompute": dict(max_new=16, slots=3, lens=[22, 19, 26],
                      cm=dict(num_pages=4, prefix_cache=False),
                      preemption="recompute"),
    "prefix": dict(max_new=8, slots=3, shared=True, cm={}),
}
CASES = [("ngram", "plain"), ("draft_model", "plain"),
         ("draft_model", "swap"), ("draft_model", "recompute"),
         ("draft_model", "prefix")]


def _case_prompts(cfg, name):
    s = SETTINGS[name]
    if s.get("shared"):
        return _shared_prompts(cfg.vocab)
    if "lens" in s:
        rng = np.random.default_rng(0)
        return [rng.integers(0, cfg.vocab, (n,), dtype=np.int32)
                for n in s["lens"]]
    prompts = _prompts(cfg.vocab, 4, 12, 0)
    prompts[1] = np.tile(prompts[1][:4], 3)       # a pattern that recurs
    return prompts


def _port_run(fp32, prompts, spec, name, chaos=None):
    _, cfg, _, tparams = fp32
    s = SETTINGS[name]
    eng = Engine(tparams, cfg, slots=s["slots"], max_seq=64, device="cpu",
                 spec=spec, chaos=chaos,
                 preemption=s.get("preemption", "swap"),
                 cache_manager=CacheConfig(page_size=16, **s["cm"]))
    reqs = [Request(rid=rid, prompt=p.copy(), max_new_tokens=s["max_new"])
            for rid, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    while eng.has_work() and eng.step():
        eng.check_pool()
    eng.run()
    return reqs, eng.stats(), eng


def _jax_run(fp32, prompts, spec, name, chaos=None):
    jcfg, _, params, _ = fp32
    s = SETTINGS[name]
    eng = JaxEngine(params, jcfg, slots=s["slots"], max_seq=64, spec=spec,
                    chaos=chaos, preemption=s.get("preemption", "swap"),
                    cache_manager=JaxCacheConfig(page_size=16, **s["cm"]))
    reqs = [JaxRequest(rid=rid, prompt=p.copy(),
                       max_new_tokens=s["max_new"])
            for rid, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return reqs, eng.stats(), eng


def _outcome(reqs):
    return [(r.rid, r.finish_reason, list(r.out_tokens), r.accepted_tokens)
            for r in reqs]


@pytest.mark.parametrize("drafter,name", CASES)
def test_spec_matches_jax_and_target_only(drafter, name, fp32):
    _, cfg, _, _ = fp32
    prompts = _case_prompts(cfg, name)
    spec, jspec = _specs(fp32, drafter)
    reqs, st, eng = _port_run(fp32, prompts, spec, name)
    jreqs, jst, _ = _jax_run(fp32, prompts, jspec, name)
    plain, pst, _ = _port_run(fp32, prompts, None, name)
    assert _outcome(reqs) == _outcome(jreqs)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in plain]
    assert all(r.finish_reason == "done" for r in reqs)
    for key in SPEC_COUNTERS:
        assert st[key] == jst[key], key
    assert st["spec_on"] and st["readbacks"] == st["steps"]
    assert st["steps"] < pst["steps"] or drafter == "ngram"
    assert st["tokens"] == sum(len(r.out_tokens) for r in reqs)
    if name in ("swap", "recompute"):
        assert st["preemptions"] >= 1
    if name == "swap":
        assert st["swapped_out_pages"] == st["swapped_in_pages"] > 0
    if name == "prefix":
        for key in ("prefix_hit_tokens", "cow_copies", "tree_pages"):
            assert st[key] == jst[key], key
        assert st["prefix_hit_tokens"] > 0
    if drafter == "draft_model":
        # the target drafting for itself: every budgeted draft commits
        assert st["accepted_per_step"] > 2.0
    assert all(not pages for pages in eng.cm.pool.owned)


def test_ngram_proposals_equal_jax():
    rng = np.random.default_rng(1)
    hist = [rng.integers(0, 6, (n,), dtype=np.int32) for n in (9, 15, 4)]
    slots, jslots = [], []
    for rid, h in enumerate(hist):
        for S, R, out in ((_Slot, Request, slots), (JaxSlot, JaxRequest,
                                                    jslots)):
            req = R(rid=rid, prompt=h[:-2])
            req.out_tokens = [int(t) for t in h[-2:]]
            out.append(S(req=req, dactive=rid != 2))
    slots.append(_Slot())
    jslots.append(JaxSlot())
    for k, n in ((3, 2), (4, 3), (2, 1)):
        got = NGramDrafter(k, n).propose(slots, None, None)
        want = JaxNGramDrafter(k, n).propose(jslots, None, None)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32 and got.shape == (4, k)
    d = NGramDrafter(k=3, ngram=2)
    assert not d.stateful and not d.on_device
    np.testing.assert_array_equal(
        d._lookup(np.array([5, 6, 7, 8, 5, 6])), [7, 8, 5])
    assert (d._lookup(np.array([1, 2, 3])) == 0).all()


def test_draft_model_proposals_and_cache_equal_jax(fp32):
    jcfg, cfg, params, tparams = fp32
    d = DraftModelDrafter(tparams, cfg, 3, 3, 64, "cpu")
    jd = JaxDraftModelDrafter(params, jcfg, 3, 3, 64)
    assert d.stateful and d.on_device
    prompts = _prompts(cfg.vocab, 3, 0, 0)
    prompts = [p for p in _prompts(cfg.vocab, 3, 20, 4)]
    prompts[1] = prompts[1][:7]
    for slot, p in enumerate(prompts):
        d.prefill(slot, p)
        jd.prefill(slot, p)
    token = np.array([5, 9, 11], np.int32)
    pos = np.array([len(p) for p in prompts], np.int32)
    for _ in range(2):
        got = d.propose(None, torch.from_numpy(token),
                        torch.from_numpy(pos))
        want = jd.propose(None, jnp.asarray(token), jnp.asarray(pos))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        token, pos = got[:, -1].numpy().copy(), pos + 3
    for n in ("k", "v"):
        np.testing.assert_allclose(d.cache[n].numpy(),
                                   np.asarray(jd.cache[n]), **FP32)
    saved = d.snapshot_slot(1)
    before = {n: c.clone() for n, c in d.cache.items()}
    d.reset()
    assert all(not c.any() for c in d.cache.values())
    d.restore_slot(1, saved)
    for n, c in d.cache.items():
        assert torch.equal(c[:, 1], before[n][:, 1])


def test_write_mask_sends_masked_rows_to_the_trap_page(fp32):
    jcfg, cfg, params, tparams = fp32
    rng = np.random.default_rng(2)
    shape = (cfg.n_layers, 6, 16, cfg.n_kv_heads, cfg.head_dim)
    pool = {n: rng.standard_normal(shape).astype(np.float32)
            for n in ("k", "v")}
    table = np.array([[1, 2], [3, 4], [5, 0]], np.int32)
    token = np.array([3, 7, 9], np.int32)
    pos = np.array([17, 4, 9], np.int32)
    mask = np.array([True, False, True])
    tpool = {n: torch.from_numpy(a.copy()) for n, a in pool.items()}
    lg, _ = registry.decode_cached(
        tparams, cfg, tpool, torch.from_numpy(token), torch.from_numpy(pos),
        page_table=torch.from_numpy(table),
        write_mask=torch.from_numpy(mask))
    jlg, jpool = jregistry.decode_cached(
        params, jcfg, {n: jnp.asarray(a) for n, a in pool.items()},
        jnp.asarray(token), jnp.asarray(pos), page_table=jnp.asarray(table),
        write_mask=jnp.asarray(mask))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **FP32)
    unmasked, _ = registry.decode_cached(
        tparams, cfg, {n: torch.from_numpy(a.copy())
                       for n, a in pool.items()},
        torch.from_numpy(token), torch.from_numpy(pos),
        page_table=torch.from_numpy(table))
    # rows that write keep their logits (a masked row attends to the old
    # row at its position; the verify drops its logits)
    assert torch.equal(lg[mask], unmasked[mask])
    for n in ("k", "v"):
        got, want = tpool[n].numpy(), np.asarray(jpool[n])
        np.testing.assert_allclose(got[:, 1:], want[:, 1:], **FP32)
        # slot 1's row went to the trap page: its own page is untouched
        np.testing.assert_array_equal(got[:, 3], pool[n][:, 3])
        assert not np.array_equal(got[:, 0, 4], pool[n][:, 0, 4])
        assert not np.array_equal(got[:, 2, 1], pool[n][:, 2, 1])
    with pytest.raises(ValueError, match="trap page"):
        registry.decode_cached(tparams, cfg, None, None, None,
                               write_mask=torch.ones(2, dtype=torch.bool))


def test_pool_bytes_after_rejected_drafts_equal_jax(fp32):
    """After spec steps whose n-gram drafts were rejected, every page but
    the trap page holds what the JAX engine's pool holds."""
    _, cfg, _, _ = fp32
    prompts = _case_prompts(cfg, "plain")
    spec, jspec = _specs(fp32, "ngram")
    eng = Engine(fp32[3], cfg, slots=2, max_seq=64, device="cpu", spec=spec,
                 cache_manager=CacheConfig(page_size=16,
                                           prefix_cache=False))
    jeng = JaxEngine(fp32[2], fp32[0], slots=2, max_seq=64, spec=jspec,
                     cache_manager=JaxCacheConfig(page_size=16,
                                                  prefix_cache=False))
    for e, R in ((eng, Request), (jeng, JaxRequest)):
        for rid, p in enumerate(prompts):
            e.submit(R(rid=rid, prompt=p.copy(), max_new_tokens=10))
        for _ in range(5):
            e.step()
    st = eng.stats()
    assert st["draft_tokens"] > st["accepted_tokens"]   # some rejected
    np.testing.assert_array_equal(eng.cm.pool.table, jeng.cm.pool.table)
    for n in ("k", "v"):
        np.testing.assert_allclose(eng.cache[n][:, 1:].numpy(),
                                   np.asarray(jeng.cache[n])[:, 1:], **FP32)


def test_spec_abort_mid_burst_matches_jax(fp32):
    _, cfg, _, _ = fp32
    prompts = _prompts(cfg.vocab, 3, 12, 6)
    spec, jspec = _specs(fp32, "draft_model")
    plan = [Fault("abort", step=1, rid=1)]
    reqs, st, eng = _port_run(fp32, prompts, spec, "prefix", chaos=plan)
    jreqs, jst, _ = _jax_run(
        fp32, prompts, jspec, "prefix",
        chaos=JaxChaos([jreliability.Fault(**dataclasses.asdict(f))
                        for f in plan]))
    assert _outcome(reqs) == _outcome(jreqs)
    assert [r.finish_reason for r in reqs] == ["done", "aborted", "done"]
    for key in SPEC_COUNTERS:
        assert st[key] == jst[key], key
    assert 0 < len(reqs[1].out_tokens) < 8


def test_spec_recovery_restores_draft_rows_in_place(fp32):
    """A device fault mid-spec: the faulting slot's request fails, the
    survivors' pages and draft rows are swapped out and restored byte for
    byte, every tensor of the step stays where it was, and the streams
    and counters equal JAX's."""
    _, cfg, _, _ = fp32
    prompts = _prompts(cfg.vocab, 4, 18, 7)
    spec, jspec = _specs(fp32, "draft_model")
    plan = [Fault("device_fault", step=3, slot=0)]
    _, cfg, _, tparams = fp32
    eng = Engine(tparams, cfg, slots=2, max_seq=64, device="cpu", spec=spec,
                 chaos=plan)
    tensors = {"token": eng._token, "pos": eng._pos, "emit": eng._emit,
               "drafts": eng._drafts, "table": eng._table,
               **{f"cache_{k}": v for k, v in eng.cache.items()},
               **{f"draft_{k}": v for k, v in eng._drafter.cache.items()}}
    ptrs = {k: v.data_ptr() for k, v in tensors.items()}
    restore, roundtrips = eng._drafter.restore_slot, []

    def checked(slot, saved):
        restore(slot, saved)
        after = eng._drafter.snapshot_slot(slot)
        roundtrips.append(all(torch.equal(saved[n], after[n])
                              for n in saved))

    eng._drafter.restore_slot = checked
    reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=10)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    jeng = JaxEngine(fp32[2], fp32[0], slots=2, max_seq=64, spec=jspec,
                     chaos=JaxChaos([jreliability.Fault(
                         **dataclasses.asdict(f)) for f in plan]))
    jreqs = [JaxRequest(rid=i, prompt=p.copy(), max_new_tokens=10)
             for i, p in enumerate(prompts)]
    for r in jreqs:
        jeng.submit(r)
    jeng.run()
    assert _outcome(reqs) == _outcome(jreqs)
    assert sorted(r.finish_reason for r in reqs) == \
        ["done", "done", "done", "failed"]
    assert roundtrips and all(roundtrips)
    st, jst = eng.stats(), jeng.stats()
    for key in SPEC_COUNTERS:
        assert st[key] == jst[key], key
    assert st["recoveries"] == 1
    assert {k: v.data_ptr() for k, v in tensors.items()} == ptrs
    plain = _port_run(fp32, prompts, None, "plain")[0]
    for r, p in zip(reqs, plain):
        if r.finish_reason == "done":
            assert r.out_tokens == p.out_tokens[:10]


def test_spec_admission_and_inert_layouts(fp32):
    jcfg, cfg, params, tparams = fp32
    spec, jspec = _specs(fp32, "ngram")
    sampled = SamplingParams(temperature=0.8, seed=3)
    eng = Engine(tparams, cfg, slots=2, max_seq=64, device="cpu", spec=spec)
    jeng = JaxEngine(params, jcfg, slots=2, max_seq=64, spec=jspec)
    prompt = _prompts(cfg.vocab, 1, 8, 0)[0]
    from repro.serving.sampling import SamplingParams as JaxSamplingParams
    r = Request(rid=0, prompt=prompt, sampling=sampled)
    jr = JaxRequest(rid=0, prompt=prompt,
                    sampling=JaxSamplingParams(temperature=0.8, seed=3))
    eng.submit(r)
    jeng.submit(jr)
    assert (r.finish_reason, r.error) == (jr.finish_reason, jr.error)
    assert r.finish_reason == "rejected" and "greedy" in r.error
    # the contiguous cache cannot speculate: inert, zero counters
    prompts = _prompts(cfg.vocab, 3, 8, 8)
    outs = []
    for sp in (None, spec):
        llm = LLMEngine(tparams, cfg, slots=2, max_seq=64, paged=False,
                        device="cpu", spec=sp)
        outs.append([o.tokens for o in llm.generate(prompts,
                                                    max_new_tokens=5)])
    st = llm.stats()
    assert not st["spec_on"] and st["draft_tokens"] == 0
    assert st["accepted_per_step"] == 0.0 and outs[0] == outs[1]


def test_stream_reports_accepted_tokens(fp32):
    _, cfg, _, tparams = fp32
    spec, _ = _specs(fp32, "draft_model")
    prompts = _prompts(cfg.vocab, 2, 10, 9)
    llm = LLMEngine(tparams, cfg, slots=2, max_seq=64, device="cpu",
                    spec=spec)
    events = list(llm.stream(prompts, max_new_tokens=9))
    outs = llm.generate(prompts, max_new_tokens=9)
    for o in outs:
        mine = [e for e in events if e.rid == o.rid - 2]
        assert [e.token for e in mine] == o.tokens
        assert mine[-1].done and mine[-1].accepted_tokens == \
            o.accepted_tokens > 0


def test_spec_config_and_make_drafter_checks(fp32):
    _, cfg, _, tparams = fp32
    for bad, needle in ((dict(drafter="oracle"), "must be one of"),
                        (dict(k=0), "k=0"), (dict(ngram=0), "ngram=0"),
                        (dict(drafter="draft_model"), "draft_params")):
        with pytest.raises(ValueError, match=needle):
            SpecConfig(**bad)
    assert DRAFTERS == ("ngram", "draft_model")
    small = dataclasses.replace(cfg, vocab=cfg.vocab - 1)
    with pytest.raises(ValueError, match="cannot cover"):
        make_drafter(SpecConfig("draft_model", draft_params=tparams,
                                draft_cfg=small), cfg, 2, 64, "cpu")
    moe = dataclasses.replace(cfg, family="moe")
    with pytest.raises(NotImplementedError):
        make_drafter(SpecConfig("draft_model", draft_params=tparams,
                                draft_cfg=moe), cfg, 2, 64, "cpu")


def test_autotune_keeps_only_valid_variants(fp32):
    _, cfg, _, tparams = fp32
    prompts = _case_prompts(cfg, "plain")[:2]
    kw = dict(slots=2, max_seq=64, max_new=6, device="cpu")
    out = space.autotune(tparams, cfg, prompts, draft_params=tparams,
                         draft_cfg=cfg, ks=(2,), **kw)
    assert [(r["drafter"], r["k"]) for r in out["rows"]] == \
        [("ngram", 2), ("draft_model", 2)]
    assert all(r["valid"] for r in out["rows"]) and out["best"] is not None
    assert space.enumerate_variants(ks=(2,), with_draft_model=False) == \
        [space.SpecVariant("ngram", 2)]
    # a baseline the variant cannot reproduce is invalid
    wrong = ([[0] * 6 for _ in prompts], 1.0)
    row = space.evaluate(tparams, cfg, space.SpecVariant("ngram", 2),
                         prompts, baseline=wrong, **kw)
    assert not row["valid"]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_spec_mix_golden_holds_under_the_bf16_rule():
    jcfg, cfg = jconfigs.smoke(ARCH), configs.smoke(ARCH)
    with jax.threefry_partitionable(False):
        params, _ = jregistry.init(jcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, params), cfg,
                                      "cpu")
    bench = _load("serve_bench_for_spec_tests",
                  REPO / "benchmarks" / "serve_bench.py")
    gold = json.loads((REPO / "benchmarks" / "golden"
                       / "serve_qwen2-0.5b_spec_mix.json").read_text())
    reqs = bench.build_requests(jcfg, "spec_mix", seed=gold["seed"])
    spec = SpecConfig("draft_model", k=bench.SPEC_K, draft_params=tparams,
                      draft_cfg=cfg)
    llm = LLMEngine(tparams, cfg, slots=gold["slots"],
                    max_seq=gold["max_seq"], device="cpu", spec=spec,
                    **gold["engine_kw"])
    outs = llm.generate([r.prompt for r in reqs],
                        max_new_tokens=gold["max_new"])
    st = llm.stats()
    assert st["spec_on"] and st["readbacks"] == st["steps"]
    assert st["accepted_per_step"] > 2.0
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
