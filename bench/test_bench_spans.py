"""``bench/trace.py``'s anchor rule against the program's own spans: a
prefill's profiler events, put on the host clock by the anchor, lie
inside the serving engine's ``engine.prefill.launch`` span of that
request (``serving/tracing.py``), so a program span and a kernel can be
placed on one time line. On the CPU, at the reduced qwen2-0.5b config in
fp32."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from bench.trace import WINDOW, from_profiler
from repro_torch import configs
from repro_torch.models import registry
from repro_torch.serving import CacheConfig, Engine, Request
from repro_torch.serving import engine as engine_mod


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(configs.smoke("qwen2-0.5b"), dtype="float32")
    return cfg, registry.init_params(cfg, seed=0, device="cpu")


def _requests(vocab, lens, max_new):
    rng = np.random.default_rng(0)
    return [Request(rid=rid, prompt=rng.integers(0, vocab, (n,),
                                                 dtype=np.int32),
                    max_new_tokens=max_new) for rid, n in enumerate(lens)]


def test_prefill_profiler_events_fall_inside_the_launch_span(
        model, monkeypatch):
    """The profiler's events of each prefill, put on the host clock by
    ``bench/trace.py``'s anchor (a ``perf_counter`` read as the window's
    ``record_function`` opens), lie inside the program's
    ``engine.prefill.launch`` span of that request."""
    prefill = engine_mod.registry.prefill

    def marked(*a, **k):
        with torch.profiler.record_function("test.prefill"):
            return prefill(*a, **k)
    monkeypatch.setattr(engine_mod.registry, "prefill", marked)
    cfg, params = model
    eng = Engine(params, cfg, slots=3, max_seq=64, device="cpu",
                 cache_manager=CacheConfig(paged=False))
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    # a process's first record_function pays a one-time set-up of about a
    # millisecond inside its enter, after its start stamp: an anchor read
    # after that enter would be late by as much
    with torch.profiler.record_function("test.warm"):
        pass
    rf = torch.profiler.record_function(WINDOW)
    before = time.perf_counter()
    rf.__enter__()
    anchor = time.perf_counter()
    eng.tracer.start()
    for req in _requests(cfg.vocab, [30, 25, 28, 21], max_new=3):
        eng.submit(req)
    eng.run()
    spans = eng.tracer.stop()
    rf.__exit__(None, None, None)
    prof.stop()
    tr = from_profiler(prof, anchor)
    win = [e for e in prof.profiler.kineto_results.events()
           if e.name() == WINDOW][0]
    off = anchor - win.start_ns() / 1e9
    assert tr.t0 == anchor and tr.t1 == pytest.approx(
        win.end_ns() / 1e9 + off)
    marks = sorted((e.start_ns() / 1e9 + off, e.end_ns() / 1e9 + off)
                   for e in prof.profiler.kineto_results.events()
                   if e.name() == "test.prefill")
    launch = sorted((sp.t0, sp.t1) for sp in spans
                    if sp.name == "engine.prefill.launch")
    assert len(marks) == len(launch) == 4
    # the window's start stamp lies somewhere inside its enter
    tol = 2e-4 + (anchor - before)
    for (a, b), (t0, t1) in zip(marks, launch):
        assert t0 - tol <= a <= b <= t1 + tol, ((a, b), (t0, t1))
