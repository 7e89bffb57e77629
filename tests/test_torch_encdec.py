"""The encoder-decoder (seamless-m4t-large-v2) of the PyTorch port against
the JAX package, on the CPU at the reduced config (2 encoder and 2
decoder layers, d_model 64, 2 heads), with JAX ``PRNGKey(0)`` weights
through ``convert.params_from_jax``, in fp32 (rtol 1e-5 / atol 1e-4;
streams, finish reasons and counters exact).

* ``encode`` at 40 frames and at 700 (past the 512-row chunk and not a
  multiple of it: the zero pad rows of JAX's non-causal flash attention
  take softmax weight, and the port's too); the prefill's BOS logits and
  its four cache leaves; 20 decode steps from that cache.
* Serving frame prompts: streams equal the JAX engine's on
  ``tests/test_serving.py``'s all-families requests and on a mix whose
  slots are reused, and a slot's stream depends on its last occupant's
  cross K/V rows past the new frames in both engines (decode attends
  every row of the cross cache); ``stream`` gives ``generate``'s
  tokens, ``prompt_len`` is the frame count.
* Admission: non-finite frames and frames past ``max_seq - 1`` are
  rejected with JAX's reasons; in crash recovery a frames survivor on the
  contiguous cache fails ("lost to device-fault recovery"), as in JAX.
* ``spec=`` is inert for frames, a frames draft model is refused; the
  configs: ``long_context_ok`` over every arch, and every JAX arch has a
  family module.
"""

import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.models import seamless as jsm  # noqa: E402
from repro.reliability import Fault as JaxFault  # noqa: E402
from repro.serving import ChaosInjector as JaxChaosInjector  # noqa: E402
from repro.serving import LLMEngine as JaxLLMEngine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import convert, registry, seamless  # noqa: E402
from repro_torch.reliability import Fault  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    CacheConfig, ChaosInjector, Engine, LLMEngine, SpecConfig)
from repro_torch.serving.spec import make_drafter  # noqa: E402

ARCH = "seamless-m4t-large-v2"
FP32 = dict(rtol=1e-5, atol=1e-4)
LEAVES = ("k", "v", "ck", "cv")


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
    """(jax cfg, port cfg, jax params, port params on the CPU), fp32,
    PRNGKey(0)."""
    jcfg = dataclasses.replace(jconfigs.smoke(ARCH), dtype="float32")
    cfg = dataclasses.replace(configs.smoke(ARCH), dtype="float32")
    params, _ = jregistry.init(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    return jcfg, cfg, params, convert.params_from_jax(tree, cfg, "cpu")


def _close(got, want, tol=FP32):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


def _frames(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, cfg.d_model)).astype(np.float32)
            for n in lens]


# -- the model ----------------------------------------------------------------

@pytest.mark.parametrize("s", [40, 700])
def test_encode_and_prefill_match_jax(s, fp32):
    """``encode``, then the prefill's BOS logits and cache leaves, then 20
    decode steps over that cache (its self cache has S_src rows, as the
    prefill builds it)."""
    jcfg, cfg, params, tp = fp32
    frames = np.stack(_frames(cfg, [s, s], seed=s))
    _close(seamless.encode(tp, cfg, torch.from_numpy(frames)),
           jsm.encode(params, jcfg, jnp.asarray(frames)))
    jl, jc = jsm.prefill(params, jcfg, jnp.asarray(frames))
    tl, tc = registry.prefill(tp, cfg, torch.from_numpy(frames))
    _close(tl, jl)
    assert set(tc) == set(LEAVES)
    for name in LEAVES:
        assert tuple(tc[name].shape) == tuple(jc[name].shape), name
        _close(tc[name], jc[name])
    jdec = jax.jit(lambda p, c, t, q: jsm.decode_step(p, jcfg, c, t, q))
    rng = np.random.default_rng(4 + s)
    pos = np.array([1, 1], np.int32)
    for _ in range(20):
        tok = rng.integers(0, cfg.vocab, 2).astype(np.int32)
        jl, jc = jdec(params, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc = registry.decode_cached(tp, cfg, tc, torch.from_numpy(tok),
                                        torch.from_numpy(pos))
        _close(tl, jl)
        for name in LEAVES:
            _close(tc[name], jc[name])
        pos = pos + 1


def test_the_encoder_weights_its_pad_rows(fp32):
    """At 700 frames the encoder's attention pads K/V to 1,024 rows and
    masks none: the port's non-causal ``flash_attention`` gives the zero
    rows weight, as JAX's does, and differs from attention over the 700
    rows alone."""
    from repro_torch.models import layers as L
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, 700, 2, 32)).astype(np.float32)) for _ in range(3))
    got = L.flash_attention(q, k, v, causal=False)
    want = jsm.L.flash_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                 False, None, 512, True)
    _close(got, want)
    exact = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k)
                          * 32 ** -0.5, -1)
    exact = torch.einsum("bhqk,bkhd->bqhd", exact, v)
    assert not torch.allclose(got, exact, **FP32)
    short = L.flash_attention(q[:, :512], k[:, :512], v[:, :512],
                              causal=False)
    exact = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q[:, :512],
                                       k[:, :512]) * 32 ** -0.5, -1)
    _close(short, torch.einsum("bhqk,bkhd->bqhd", exact, v[:, :512]))


def test_prefill_refuses_padded_frames(fp32):
    _, cfg, _, tp = fp32
    assert not registry.pad_prefill_ok(cfg) and not registry.paged_ok(cfg)
    with pytest.raises(ValueError, match="padded"):
        registry.prefill(tp, cfg, torch.zeros((1, 8, cfg.d_model)),
                         length=5)
    with pytest.raises(ValueError, match="cannot serve from a paged pool"):
        Engine(tp, cfg, slots=2, max_seq=64, device="cpu",
               cache_manager=CacheConfig(paged=True))


# -- serving ------------------------------------------------------------------

def _both(fp32, prompts, max_new, **kw):
    """(port outputs, JAX outputs, port stats, JAX stats) of one
    ``generate``; ``kw`` may hold ``chaos`` (a Fault-field dict list)."""
    jcfg, cfg, params, tp = fp32
    plan = kw.pop("chaos", None)
    px, jx = {}, {}
    if plan:
        px["chaos"] = ChaosInjector([Fault(**f) for f in plan])
        jx["chaos"] = JaxChaosInjector([JaxFault(**f) for f in plan])
    jllm = JaxLLMEngine(params, jcfg, **kw, **jx)
    jouts = jllm.generate(prompts, max_new_tokens=max_new)
    llm = LLMEngine(tp, cfg, device="cpu", **kw, **px)
    outs = llm.generate(prompts, max_new_tokens=max_new)
    return outs, jouts, llm.stats(), jllm.stats()


def _same(outs, jouts, st, js):
    assert [o.tokens for o in outs] == [o.tokens for o in jouts]
    assert [o.finish_reason for o in outs] == \
        [o.finish_reason for o in jouts]
    assert [o.error for o in outs] == [o.error for o in jouts]
    assert [o.prompt_len for o in outs] == [o.prompt_len for o in jouts]
    for key in ("steps", "readbacks", "prefill_compiles", "paged",
                "pad_prefill", "recoveries", "failed", "aborted",
                "rejected"):
        assert st[key] == js[key], key


@pytest.mark.parametrize("case", ["all_families", "reuse"])
def test_streams_equal_the_jax_engine(case, fp32):
    """``tests/test_serving.py``'s all-families requests (5, 8 and 6
    frames, 3 new, 2 slots), and ten requests of 6-60 frames on 3 slots
    (every slot reused, some by a shorter source)."""
    cfg = fp32[1]
    if case == "all_families":
        prompts, kw, new = _frames(cfg, (5, 8, 6)), dict(slots=2), 3
    else:
        rng = np.random.default_rng(2)
        lens = [int(n) for n in rng.integers(6, 61, 10)]
        prompts, kw, new = _frames(cfg, lens, seed=3), dict(slots=3), 10
    outs, jouts, st, js = _both(fp32, prompts, new, max_seq=64, **kw)
    _same(outs, jouts, st, js)
    assert all(o.finish_reason == "done" for o in outs)
    assert not st["paged"] and not st["pad_prefill"]


def test_a_slot_remembers_its_last_occupant(fp32):
    """Finding 2 of the reference, live against JAX: on one slot, 6
    frames decode other tokens after a 40-frame request than alone,
    since decode's cross-attention reads all ``max_seq`` rows of the cross
    cache and the prefill writes only the first 6. Both engines give the
    same streams each way."""
    cfg = fp32[1]
    six, forty = _frames(cfg, (6, 40), seed=4)
    alone = _both(fp32, [six], 8, slots=1, max_seq=64)
    after = _both(fp32, [forty, six], 8, slots=1, max_seq=64)
    for run in (alone, after):
        _same(*run)
    assert alone[0][0].tokens != after[0][1].tokens


def test_stream_gives_generate_tokens(fp32):
    _, cfg, _, tp = fp32
    prompts = _frames(cfg, (9, 30, 14), seed=5)
    gold = LLMEngine(tp, cfg, slots=2, max_seq=64, device="cpu").generate(
        prompts, max_new_tokens=6)
    got: dict = {}
    llm = LLMEngine(tp, cfg, slots=2, max_seq=64, device="cpu")
    for ev in llm.stream(prompts, max_new_tokens=6):
        if ev.token >= 0:
            got.setdefault(ev.rid, []).append(ev.token)
    assert [got[o.rid] for o in gold] == [o.tokens for o in gold]
    assert [o.prompt_len for o in gold] == [9, 30, 14]


def test_admission_rejects_what_jax_rejects(fp32):
    """Non-finite frames and frames past ``max_seq - 1``, beside good
    ones: the same reasons as JAX's, the good streams equal."""
    cfg = fp32[1]
    good = _frames(cfg, (7, 12), seed=6)
    bad = good[0].copy()
    bad[3, 5] = np.nan
    prompts = [good[0], bad, _frames(cfg, (64,), seed=7)[0], good[1]]
    outs, jouts, st, js = _both(fp32, prompts, 4, slots=2, max_seq=64)
    _same(outs, jouts, st, js)
    assert [o.finish_reason for o in outs] == \
        ["done", "rejected", "rejected", "done"]
    assert outs[1].error == "non-finite values in frame prompt"
    assert "cannot fit max_seq=64" in outs[2].error


def test_recovery_fails_frames_survivors(fp32):
    """A device fault on slot 1: its request fails, and the others
    resident then cannot be recomputed from frames (the contiguous cache
    keeps no copy), so they fail too, as in JAX; the queued ones finish."""
    cfg = fp32[1]
    prompts = _frames(cfg, (9, 14, 20, 11, 6), seed=8)
    plan = [dict(kind="device_fault", step=3, slot=1)]
    outs, jouts, st, js = _both(fp32, prompts, 6, slots=3, max_seq=64,
                                chaos=plan)
    _same(outs, jouts, st, js)
    reasons = [o.finish_reason for o in outs]
    assert reasons == ["failed", "failed", "failed", "done", "done"]
    assert st["recoveries"] == 1
    assert sum("lost to device-fault recovery" in (o.error or "")
               for o in outs) == 2


def test_spec_is_inert_and_a_frames_draft_is_refused(fp32):
    _, cfg, _, tp = fp32
    prompts = _frames(cfg, (8, 30, 11), seed=9)
    gold = [o.tokens for o in LLMEngine(
        tp, cfg, slots=2, max_seq=64, device="cpu").generate(
            prompts, max_new_tokens=6)]
    llm = LLMEngine(tp, cfg, slots=2, max_seq=64, device="cpu",
                    spec=SpecConfig(drafter="ngram", k=3))
    outs = llm.generate(prompts, max_new_tokens=6)
    st = llm.stats()
    assert not st["spec_on"] and st["draft_tokens"] == 0
    assert [o.tokens for o in outs] == gold
    # tests/test_spec.py::test_make_drafter_rejects_frames_and_vocab_mismatch
    dense = configs.smoke("qwen2-0.5b")
    with pytest.raises(ValueError, match="frames"):
        make_drafter(SpecConfig(drafter="draft_model", k=2,
                                draft_params=tp, draft_cfg=cfg),
                     dense, 2, 64, "cpu")


# -- configs ------------------------------------------------------------------

def test_every_jax_arch_has_a_config_and_a_family():
    """``tests/test_models.py::test_long_context_gating`` over the port's
    configs, every JAX config's dimensions, and a family module for
    each."""
    assert set(configs.CONFIGS) == set(jconfigs.ARCH_IDS)
    ok = {a for a in configs.CONFIGS
          if configs.long_context_ok(configs.get(a))}
    assert ok == {"h2o-danube-1.8b", "xlstm-1.3b", "recurrentgemma-2b"}
    for arch in jconfigs.ARCH_IDS:
        for jc, c in ((jconfigs.get(arch), configs.get(arch)),
                      (jconfigs.smoke(arch), configs.smoke(arch))):
            assert dataclasses.asdict(c) == dataclasses.asdict(jc), arch
            assert registry.module_for(c) is not None
            assert configs.long_context_ok(c) == jconfigs.long_context_ok(jc)
