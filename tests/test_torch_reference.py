"""The port's host-driven ``ReferenceEngine`` against the JAX package's, and
against the port's own ``Engine``, on the CPU at the reduced configs.

* On every family's smoke config (``FAMILY_ARCHS`` of
  ``tests/test_serving.py``) in fp32, on JAX ``PRNGKey(0)`` weights through
  ``convert.params_from_jax``, the port's ``ReferenceEngine`` gives the JAX
  ``ReferenceEngine``'s greedy streams token for token, slot reuse
  included. On the recurrent families that is JAX's leaf filter
  (``_write_slot``), whatever it writes.
* Where the JAX tests hold the JAX ``Engine`` equal to the JAX reference
  (``tests/test_serving.py``: the ragged mix on qwen2-0.5b and
  olmoe-1b-7b, the ``max_seq`` stop, the oversubscribed pool with swap
  preemption, the one-slot pool of repeated preemption, recompute
  preemption's stream lengths), the port's ``Engine`` equals the port's
  ``ReferenceEngine``, in the configs' own dtype (bf16) as JAX's tests
  run them.
* It raises JAX's ``ValueError`` for non-greedy sampling and for ``spec``.
"""

import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.reference import \
    ReferenceEngine as JaxReferenceEngine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.serving import (CacheConfig, Engine,  # noqa: E402
                                 ReferenceEngine, Request, SamplingParams,
                                 SpecConfig)

FAMILY_ARCHS = {
    "dense": "qwen2-0.5b",
    "moe": "olmoe-1b-7b",
    "xlstm": "xlstm-1.3b",
    "hybrid": "recurrentgemma-2b",
    "encdec": "seamless-m4t-large-v2",
}
# prompt lengths of the JAX comparison: ragged, more requests than slots
FAMILY_LENS = [5, 8, 6, 11, 4]

_CACHE = {}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: many tiny CPU ops, beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch, dtype=None):
    """(jax cfg, port cfg, jax params, port params on the CPU) of
    ``arch``'s smoke config in ``dtype`` (its own when None), JAX
    ``PRNGKey(0)`` weights."""
    key = (arch, dtype)
    if key not in _CACHE:
        jcfg, cfg = jconfigs.smoke(arch), configs.smoke(arch)
        if dtype is not None:
            jcfg = dataclasses.replace(jcfg, dtype=dtype)
            cfg = dataclasses.replace(cfg, dtype=dtype)
        jparams, _ = jregistry.init(jcfg, jax.random.PRNGKey(0))
        _CACHE[key] = (jcfg, cfg, jparams, convert.params_from_jax(
            jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    return _CACHE[key]


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.frontend == "frames":
        return [rng.standard_normal((n, cfg.d_model)).astype(np.float32)
                for n in lens]
    return [rng.integers(0, cfg.vocab, (n,), dtype=np.int32) for n in lens]


def _streams(make, request_cls, cfg, lens, *, max_new=5, slots=3,
             max_seq=64):
    eng = make(slots=slots, max_seq=max_seq)
    for rid, p in enumerate(_prompts(cfg, lens)):
        eng.submit(request_cls(rid=rid, prompt=p, max_new_tokens=max_new))
    done = eng.run()
    return {r.rid: list(map(int, r.out_tokens)) for r in done}, eng


def _port_ref(params, cfg):
    return lambda **kw: ReferenceEngine(params, cfg, device="cpu", **kw)


def _port_engine(params, cfg, **extra):
    return lambda **kw: Engine(params, cfg, device="cpu", **extra, **kw)


@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_reference_streams_match_jax_reference(family):
    jcfg, cfg, jparams, params = _setup(FAMILY_ARCHS[family], "float32")
    want, _ = _streams(lambda **kw: JaxReferenceEngine(jparams, jcfg, **kw),
                       JaxRequest, jcfg, FAMILY_LENS, max_new=4, slots=2)
    got, eng = _streams(_port_ref(params, cfg), Request, cfg, FAMILY_LENS,
                        max_new=4, slots=2)
    assert got == want
    assert sorted(got) == list(range(len(FAMILY_LENS)))
    assert not eng.queue and all(s.req is None for s in eng.slots)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "olmoe-1b-7b"])
def test_reference_equals_engine(arch):
    _, cfg, _, params = _setup(arch)
    lens = [3, 5, 7, 9, 11, 4, 6, 13] if cfg.family == "dense" \
        else [4, 6, 9, 5, 7]
    new, _ = _streams(_port_engine(params, cfg), Request, cfg, lens)
    ref, _ = _streams(_port_ref(params, cfg), Request, cfg, lens)
    assert new == ref
    assert len(new) == len(lens)


def test_max_seq_stop_matches_engine():
    _, cfg, _, params = _setup("qwen2-0.5b")
    kw = dict(max_new=1000, slots=2, max_seq=16)
    new, _ = _streams(_port_engine(params, cfg), Request, cfg, [4, 6], **kw)
    ref, _ = _streams(_port_ref(params, cfg), Request, cfg, [4, 6], **kw)
    assert new == ref
    assert all(len(v) > 1 for v in new.values())
    # the prefill's token, then one a step until the position reaches
    # max_seq - 1 = 15: 1 + (15 - n) tokens for a prompt of n
    assert {k: len(v) for k, v in ref.items()} == {0: 12, 1: 10}


@pytest.mark.parametrize("case", ["oversubscribed", "forced", "recompute"])
def test_preemption_mixes_match_reference(case):
    """The preemption mixes of ``tests/test_serving.py``: swap preemption
    on a 6-page pool and on a 4-page one (the same request evicted more
    than once) give the reference's streams; recompute preemption gives
    its stream lengths."""
    _, cfg, _, params = _setup("qwen2-0.5b")
    lens, num_pages, max_new, preemption = {
        "oversubscribed": ([30, 25, 28, 21, 26], 6, 20, "swap"),
        "forced": ([20, 17, 23], 4, 30, "swap"),
        "recompute": ([22, 19, 26], 4, 25, "recompute")}[case]
    kw = dict(max_new=max_new, slots=3, max_seq=64)
    new, eng = _streams(_port_engine(
        params, cfg, preemption=preemption,
        cache_manager=CacheConfig(page_size=16, num_pages=num_pages)),
        Request, cfg, lens, **kw)
    ref, _ = _streams(_port_ref(params, cfg), Request, cfg, lens, **kw)
    st = eng.stats()
    assert st["preemptions"] >= (2 if case == "forced" else 1)
    assert st["peak_pages_in_use"] <= num_pages
    if case == "recompute":
        assert sorted(new) == sorted(ref)
        assert all(len(new[k]) == len(ref[k]) for k in ref)
    else:
        assert new == ref
    if case == "forced":
        assert max(r.preemptions for r in eng.finished) >= 1
    eng.cm.pool.check()


def test_reference_refuses_sampling_and_spec():
    _, cfg, _, params = _setup("qwen2-0.5b")
    for kw in (dict(greedy=False),
               dict(sampling=SamplingParams(temperature=0.8)),
               dict(spec=SpecConfig(drafter="ngram", k=2))):
        with pytest.raises(ValueError, match="oracle"):
            ReferenceEngine(params, cfg, device="cpu", **kw)
    # a greedy SamplingParams is signature parity, accepted
    ReferenceEngine(params, cfg, device="cpu", sampling=SamplingParams())
