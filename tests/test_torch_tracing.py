"""The serving engine's spans (``serving/tracing.py``) on the CPU, at the
reduced qwen2-0.5b config in fp32.

* Tracing changes nothing the engine computes or counts: token streams
  and every count of ``Engine.stats()`` are the same with the tracer on
  and off, on the paged pool (oversubscribed, swap) and on the ring.
* The spans' structure: one ``engine.step`` root for each ``step()``
  call, parent ids that resolve, children inside their parents, one
  ``engine.replay`` per dispatched step.
* A request's ``request.queue`` and ``engine.admit`` add up to its time
  to first token; drains before a dispatch are counted and spanned;
  a swap preemption names its victim.
* A tracer that is off records nothing and is never called.
* ``serve --profile`` prints the span table in place of the summed busy
  share, and every run reports ``drains_before_dispatch``.
"""

import argparse
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.serving import CacheConfig, Engine, Request  # noqa: E402
from repro_torch.serving import tracing  # noqa: E402

ARCH = "qwen2-0.5b"
LAYOUTS = {
    # 3 slots of 64 rows on 6 pages of 16: admissions wait for pages and
    # decode writes preempt (swap)
    "paged_swap": dict(cache_manager=CacheConfig(
        paged=True, page_size=16, num_pages=6, prefix_cache=True)),
    "ring": dict(cache_manager=CacheConfig(paged=False)),
}
LENS = [30, 25, 28, 21, 26, 12, 33]


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(configs.smoke(ARCH), dtype="float32")
    return cfg, registry.init_params(cfg, seed=0, device="cpu")


def _requests(vocab, lens=LENS, max_new=20):
    rng = np.random.default_rng(0)
    return [Request(rid=rid, prompt=rng.integers(0, vocab, (n,),
                                                 dtype=np.int32),
                    max_new_tokens=max_new) for rid, n in enumerate(lens)]


def _serve(model, layout, trace, lens=LENS, max_new=20, slots=3,
           device="cpu"):
    """Every request submitted at once, stepped to the end; returns (the
    engine, the spans, the step() calls made)."""
    cfg, params = model
    torch.manual_seed(0)
    eng = Engine(params, cfg, slots=slots, max_seq=64, device=device,
                 **LAYOUTS[layout])
    if trace:
        eng.tracer.start()
    for req in _requests(cfg.vocab, lens, max_new):
        eng.submit(req)
    calls = 0
    while eng.has_work():
        calls += 1
        if not eng.step():
            break
    eng.flush()
    return eng, eng.tracer.stop() if trace else eng.tracer.spans, calls


def _counts(stats):
    """The counts of ``stats()``: everything but times."""
    return {k: v for k, v in stats.items()
            if not k.endswith("_s") and k not in ("ttft", "capture_by_step")}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tracing_changes_no_stream_and_no_count(model, layout):
    on, spans, _ = _serve(model, layout, True)
    off, none, _ = _serve(model, layout, False)
    assert spans and none == []
    assert {r.rid: r.out_tokens for r in on.finished} == \
        {r.rid: r.out_tokens for r in off.finished}
    assert _counts(on.stats()) == _counts(off.stats())
    assert len(on.finished) == len(LENS)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_one_step_root_and_children_inside_parents(model, layout):
    eng, spans, calls = _serve(model, layout, True)
    by_id = {sp.id: sp for sp in spans}
    assert [sp.id for sp in spans] == list(range(len(spans)))
    roots = [sp for sp in spans if sp.name == "engine.step"]
    assert len(roots) == calls
    assert all(sp.parent is None for sp in roots)
    assert [sp.attrs["step"] for sp in roots] == sorted(
        sp.attrs["step"] for sp in roots)
    for sp in spans:
        assert sp.t0 <= sp.t1
        if sp.parent is not None:
            up = by_id[sp.parent]
            assert up.t0 <= sp.t0 and sp.t1 <= up.t1, (sp, up)
    # everything but the queue and the final flush lies inside a step
    loose = {sp.name for sp in spans if sp.parent is None} - {"engine.step"}
    assert loose <= {"request.queue", "engine.drain"}
    st = eng.stats()
    replays = [sp for sp in spans if sp.name == "engine.replay"]
    assert len(replays) == st["steps"] == st["readbacks"]
    assert all(by_id[sp.parent].name == "engine.dispatch" for sp in replays)
    waits = [sp for sp in spans if sp.name == "engine.readback_wait"]
    assert sorted(sp.attrs["step"] for sp in waits) == list(
        range(st["steps"]))
    admits = [sp for sp in spans if sp.name == "engine.admit"]
    assert admits and all(by_id[sp.parent].name == "engine.step"
                          for sp in admits)
    applies = [sp for sp in spans if sp.name == "engine.apply"]
    assert len(applies) == st["readbacks"]
    # no device events on the CPU
    assert not any("device_s" in sp.attrs for sp in spans)


def test_queue_and_admit_add_up_to_the_first_token(model):
    eng, spans, _ = _serve(model, "ring", True)
    queue = {sp.rid: sp for sp in spans if sp.name == "request.queue"}
    admit = {sp.rid: sp for sp in spans if sp.name == "engine.admit"}
    assert set(queue) == set(admit) == {r.rid for r in eng.finished}
    for req in eng.finished:
        q, a = queue[req.rid], admit[req.rid]
        assert q.t0 == req.t_submit and q.t1 == a.t0
        assert not q.attrs["requeue"]
        assert (q.t1 - q.t0) + (a.t1 - a.t0) == pytest.approx(
            req.t_first - req.t_submit, abs=1e-3)
        kids = [sp.name for sp in spans if sp.parent == a.id]
        assert kids == ["engine.prefill.launch", "engine.first_token"]
        assert all(sp.rid == req.rid for sp in spans if sp.parent == a.id)


def test_drains_before_dispatch_are_counted_and_spanned(model):
    """Seven requests on three slots: while requests wait and every slot
    is full, each step settles the readback before it dispatches."""
    eng, spans, _ = _serve(model, "ring", True)
    first = [sp for sp in spans if sp.name == "engine.drain"
             and sp.attrs["cause"] == "before_dispatch"]
    n = eng.stats()["drains_before_dispatch"]
    assert n == len(first) > 0
    by_id = {sp.id: sp for sp in spans}
    for sp in first:
        assert by_id[sp.parent].name == "engine.step"
        kids = [k.name for k in spans if k.parent == sp.id]
        assert kids == ["engine.readback_wait", "engine.apply"]
    # off, the counter counts the same
    off, _, _ = _serve(model, "ring", False)
    assert off.stats()["drains_before_dispatch"] == n


def test_swap_preemption_names_its_victim(model):
    eng, spans, _ = _serve(model, "paged_swap", True)
    st = eng.stats()
    pre = [sp for sp in spans if sp.name == "engine.preempt"]
    assert len(pre) == st["preemptions"] > 0
    victims = {r.rid for r in eng.finished if r.preemptions}
    assert {sp.rid for sp in pre} == victims
    by_id = {sp.id: sp for sp in spans}
    for sp in pre:
        out = [k for k in spans if k.parent == sp.id]
        assert [k.name for k in out] == ["engine.swap_out"]
        assert out[0].rid == sp.rid
        # inside the page backing of a step, after its drain
        assert by_id[sp.parent].name == "cache.ensure_pages"
    # a swap-in admission restores pages and runs no prefill
    prefilled = {by_id[sp.parent].id for sp in spans
                 if sp.name == "engine.prefill.launch"}
    swap_in = [sp for sp in spans if sp.name == "engine.admit"
               and sp.id not in prefilled]
    assert len(swap_in) == len(pre)
    assert {sp.rid for sp in swap_in} == victims
    requeued = [sp for sp in spans if sp.name == "request.queue"
                and sp.attrs["requeue"]]
    assert len(requeued) == len(pre)
    assert any(sp.attrs["cause"] == "pages" for sp in spans
               if sp.name == "engine.drain")


def test_a_tracer_that_is_off_is_never_called(model, monkeypatch):
    """Off, every site tests ``tracer.on`` and nothing else: no method of
    the tracer runs and no span is made."""
    def boom(*a, **k):
        raise AssertionError("the tracer was called while off")
    for name in ("open", "close", "add", "settle", "requeued",
                 "waited_since"):
        monkeypatch.setattr(tracing.Tracer, name, boom)
    monkeypatch.setattr(tracing, "Span", boom)
    for layout in LAYOUTS:
        eng, spans, _ = _serve(model, layout, False)
        assert spans == [] and not eng.tracer.on
        assert eng.stats()["preemptions"] > 0 or layout == "ring"


@pytest.mark.cuda
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_device_times_on_the_card(model, layout):
    """On the card with device events: the same streams and counts as
    with the tracer off, and every replay and prefill carries its device
    time, read after the syncs the engine makes (all settled by the last
    readback)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    on, spans, _ = _serve(model, layout, True, device="cuda")
    off, _, _ = _serve(model, layout, False, device="cuda")
    assert {r.rid: r.out_tokens for r in on.finished} == \
        {r.rid: r.out_tokens for r in off.finished}
    assert _counts(on.stats()) == _counts(off.stats())
    st = on.stats()
    assert st["graph_replays"] == st["readbacks"] == st["steps"] > 0
    timed = [sp for sp in spans
             if sp.name in ("engine.replay", "engine.prefill.launch")]
    assert len(timed) == st["steps"] + st["prefills"] + st[
        "suffix_prefills"]
    assert all(0 < sp.attrs["device_s"] < 5 for sp in timed)


def test_stop_ends_open_spans_and_start_forgets():
    tr = tracing.Tracer("cpu")
    tr.start()
    a = tr.open("a")
    b = tr.open("b", rid=3, x=1)
    tr.close(b, y=2)
    tr.open("c")
    spans = tr.stop()
    assert [sp.name for sp in spans] == ["a", "b", "c"]
    assert spans[1].parent == a.id and spans[2].parent == a.id
    assert spans[1].attrs == {"x": 1, "y": 2} and spans[1].rid == 3
    assert all(sp.t1 is not None for sp in spans)
    assert not tr.on and tr.stop() == []
    tr.start()
    tr.add("q", 1.0, 2.0, rid=5, requeue=False)
    assert [(sp.name, sp.id, sp.parent) for sp in tr.stop()] == [
        ("q", 0, None)]


def test_summary_self_time_excludes_children():
    S = tracing.Span
    spans = [S("step", 0.0, 10.0, id=0), S("wait", 1.0, 4.0, id=1, parent=0),
             S("apply", 4.0, 5.0, id=2, parent=0),
             S("step", 10.0, 14.0, id=3),
             S("replay", 11.0, 12.0, id=4, parent=3,
               attrs={"device_s": 2.5})]
    out = tracing.summarize(spans)
    assert out["step"] == {"count": 2, "total_s": 14.0, "self_s": 9.0,
                           "mean_s": 7.0}
    assert out["replay"]["device_s"] == 2.5
    lines = tracing.table(out).splitlines()
    assert lines[1].split()[:2] == ["step", "2"] and len(lines) == 5


def test_serve_profile_prints_the_span_table(capsys):
    from repro_torch.launch import serve
    args = argparse.Namespace(
        arch=ARCH, smoke=True, device="cpu", requests=4, slots=2,
        max_seq=64, page_size=16, num_pages=None, preemption="swap",
        min_prompt=3, max_prompt=30, max_new=4, crossing=0, seed=0,
        profile=True, rows=3, no_prefix_cache=False, scheduler="fcfs",
        temperature=0.0, top_k=0, top_p=1.0, sampling_seed=None,
        chaos=None, deadline=None, spec=None, spec_k=4)
    out = serve.run(args)
    assert "device_busy_share" not in out
    rows = out["spans"]
    assert rows["engine.replay"]["count"] == out["steps"]
    assert rows["engine.admit"]["count"] == out["requests"]
    assert rows["engine.step"]["count"] >= out["steps"]
    # four requests on two slots: steps with requests waiting settle the
    # readback first, each inside an ``engine.drain``
    assert 0 < out["drains_before_dispatch"] <= rows["engine.drain"]["count"]
    printed = capsys.readouterr().out
    assert "engine.step" in printed and "self" in printed
