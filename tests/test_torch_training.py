"""The training substrate of the PyTorch port (``training/``,
``data/pipeline.py``, ``launch/train.py``) against the JAX package, on the
CPU: AdamW's ``update`` and ``schedule`` within fp32 tolerance, the
compressed gradients' payloads and scales exactly, the pipeline's batches
bit for bit, ``make_train_step`` after two steps (microbatches 1 and 2,
compression off and on, ``cast_params=None``) on qwen2-0.5b's reduced
config in fp32 (JAX's ``PRNGKey(0)`` weights through
``convert.params_from_jax(..., master=True)``); then the port's
counterparts of every test of ``tests/test_training.py`` (checkpoint round
trip and GC, atomicity, async save, an injected failure and the restart,
giving up, the straggler watchdog, the cursor and sharding), and a
restarted run that ends with the parameters of an uninterrupted one.
Tolerance: ``core/agents.py::_tolerance`` fp32, rtol 1e-5 / atol 1e-4.
"""

import dataclasses
import os

import numpy as np
import pytest
torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.training import compression as jcomp  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_step as jts  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data.pipeline import Pipeline, _batch_np  # noqa: E402
from repro_torch.models import convert, registry  # noqa: E402
from repro_torch.training import compression  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import tree as T  # noqa: E402
from repro_torch.training.checkpoint import Checkpointer  # noqa: E402
from repro_torch.training.fault_tolerance import (  # noqa: E402
    FailureInjector, Heartbeat, StragglerWatchdog, run_with_restarts)
from repro_torch.training.train_step import (  # noqa: E402
    TrainConfig, init_state, make_train_step)

FP32 = dict(rtol=1e-5, atol=1e-4)
ARCH = "qwen2-0.5b"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: many tiny CPU ops, beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what="", tol=FP32):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), err_msg=what,
                               **tol)


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def test_schedule_matches_jax():
    for cfg in (opt.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100),
                opt.AdamWConfig(lr=3e-4, warmup_steps=0, total_steps=7,
                                min_lr_frac=0.25)):
        jcfg = jopt.AdamWConfig(**dataclasses.asdict(cfg))
        for step in (0, 1, 5, 10, 11, 37, 99, 100, 150):
            _close(opt.schedule(cfg, step), jopt.schedule(jcfg, step),
                   f"step {step}", tol=dict(rtol=1e-6, atol=0))


def test_adamw_update_matches_jax():
    """Three steps on a nested tree, the clip active (norms above 1):
    parameters, both moments, the rate and the norm."""
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 5), "b": {"c": (7,), "d": (2, 2, 4)}}
    params = jax.tree.map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    cfg = opt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    jcfg = jopt.AdamWConfig(**dataclasses.asdict(cfg))
    jp, jst = jax.tree.map(jnp.asarray, params), None
    jst = jopt.init(jp)
    tp = _t(params)
    tst = opt.init(tp)
    for i in range(3):
        g = jax.tree.map(lambda p: (3 * rng.standard_normal(p.shape))
                         .astype(np.float32), params)
        jp, jst, jm = jopt.update(jcfg, jp, jax.tree.map(jnp.asarray, g),
                                  jst)
        tp, tst, tm = opt.update(cfg, tp, _t(g), tst)
        assert int(tst.step) == int(jst.step) == i + 1
        _close(tm["lr"], jm["lr"], "lr", tol=dict(rtol=1e-6, atol=0))
        _close(tm["grad_norm"], jm["grad_norm"], "grad_norm")
        for name, want, got in (("p", jp, tp), ("m", jst.m, tst.m),
                                ("v", jst.v, tst.v)):
            for a, b in zip(jax.tree.leaves(want), T.leaves(got)):
                _close(b, a, f"{name} after step {i + 1}")


def test_global_norm_of_a_large_leaf_matches_jax():
    """A 4 M element leaf (qwen2-0.5b's embedding gradient has 136 M):
    the clip's norm within fp32 rounding of the float64 norm and of JAX's
    (PyTorch's fp32 vector norm on the CPU is 6.6e-4 off here)."""
    rng = np.random.default_rng(4)
    g = (rng.standard_normal(1 << 22) * 1e-4).astype(np.float32)
    g[::7] *= 50
    want = float(np.sqrt(np.sum(np.square(g.astype(np.float64)))))
    got = float(opt.global_norm([torch.from_numpy(g)]))
    _, jgn = jopt.clip_by_global_norm([jnp.asarray(g)], 1.0)
    assert abs(got - want) <= 1e-6 * want
    _close(got, jgn, "norm", tol=dict(rtol=1e-6, atol=0))


def test_compress_grads_payloads_and_scales_equal_jax():
    """Payloads and scales bit for bit (ragged and whole blocks, a zero
    block), the wire values and the error feedback over two steps, and the
    wire size."""
    rng = np.random.default_rng(1)
    shapes = [(1000,), (4, 256), (3, 5, 7), (300,)]
    grads = [(rng.standard_normal(s) * 10.0 ** rng.integers(-4, 2))
             .astype(np.float32) for s in shapes]
    grads[3][:256] = 0.0
    for g in grads:
        jq, js, jn = jcomp.quantize(jnp.asarray(g))
        q, s, n = compression.quantize(torch.from_numpy(g))
        assert n == jn and q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    jerr = err = None
    for step in range(2):
        step_g = [g * (1 + step) for g in grads]
        jout, jerr = jcomp.compress_grads([jnp.asarray(g) for g in step_g],
                                          jerr)
        out, err = compression.compress_grads(
            [torch.from_numpy(g) for g in step_g], err)
        for a, b in zip(jout + jerr, out + err):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert compression.wire_bytes([torch.from_numpy(g) for g in grads]) \
        == jcomp.wire_bytes([jnp.asarray(g) for g in grads])


def test_pipeline_batches_equal_jax():
    for arch in (ARCH, "seamless-m4t-large-v2"):
        cfg, jcfg = configs.smoke(arch), jconfigs.smoke(arch)
        for seed, step, shard, n in ((0, 0, 0, 1), (3, 17, 1, 2),
                                     (123, 4, 3, 4)):
            want = jpipeline._batch_np(jcfg, 8, 16, seed, step, shard, n)
            got = _batch_np(cfg, 8, 16, seed, step, shard, n)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
        pipe = Pipeline(cfg, 4, 16, seed=5, start_step=2)
        b = pipe.next()
        pipe.close()
        want = jpipeline._batch_np(jcfg, 4, 16, 5, 2)
        for k in want:
            np.testing.assert_array_equal(b[k].numpy(), want[k])


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "recurrentgemma-2b"])
def test_compress_grads_of_a_model_tree_equals_jax(arch):
    """On a gradient tree of a model's layout, quantization blocks run
    across the layers as across JAX's stacked leaves (the hybrid's
    recurrent blocks within its periods, and its tail, too): the wire
    values and the error feedback of two steps bit for bit, and the wire
    size."""
    jcfg = dataclasses.replace(jconfigs.smoke(arch), dtype="float32")
    cfg = dataclasses.replace(configs.smoke(arch), dtype="float32")
    shapes = jax.eval_shape(lambda k: jregistry.init(jcfg, k)[0],
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    grads = jax.tree.map(lambda a: (rng.standard_normal(a.shape)
                                    * 1e-3).astype(np.float32), shapes)

    def port(t):
        return convert.params_from_jax(jax.tree.map(np.asarray, t), cfg,
                                       "cpu", master=True)

    jerr = err = None
    for step in range(2):
        jg = jax.tree.map(lambda g: jnp.asarray(g * (1 + step)), grads)
        jout, jerr = jcomp.compress_grads(jg, jerr)
        out, err = compression.compress_grads(port(jg), err)
        for (name, a), b in zip(T.named_leaves(port(jout))
                                + T.named_leaves(port(jerr)),
                                T.leaves(out) + T.leaves(err)):
            np.testing.assert_array_equal(b.numpy(), a.numpy(), name)
    assert compression.wire_bytes(port(grads)) == jcomp.wire_bytes(grads)


@pytest.fixture(scope="module")
def qwen2():
    """(jax cfg, port cfg, JAX PRNGKey(0) weights as numpy, a batch of 2 x
    32), fp32."""
    jcfg = dataclasses.replace(jconfigs.smoke(ARCH), dtype="float32")
    cfg = dataclasses.replace(configs.smoke(ARCH), dtype="float32")
    params = jax.jit(lambda k: jregistry.init(jcfg, k)[0])(
        jax.random.PRNGKey(0))
    return jcfg, cfg, jax.tree.map(np.asarray, params), \
        registry.make_batch(cfg, 2, 32, seed=1)


LR = 1e-3      # a real rate: each element moves by about the rate a step
APART = 2e-4   # gradients that the two sides round apart by more than this


def _grads_of_moments(m, m_prev, b1=0.9):
    """The (clipped) gradients a step fed AdamW, from its first moments."""
    return [(a - b1 * b) / (1 - b1) for a, b in zip(m, m_prev)]


def _rounded_apart(a, b):
    """The elements of two gradients that differ by more than ``APART`` of
    their size: values within rounding of zero (a gradient that is zero in
    exact arithmetic, as a key bias's is, comes out as rounding noise)."""
    return (a - b).abs() > APART * torch.maximum(a.abs(), b.abs())


@pytest.mark.parametrize("microbatches,compress", [(1, False), (2, False),
                                                   (1, True), (2, True)])
def test_train_step_matches_jax(qwen2, microbatches, compress):
    """Two steps of ``make_train_step`` (``cast_params=None``, AdamW at a
    rate of 1e-3 from the first step): the loss, the norm and the rate of
    each step; then each parameter's move over the two steps within 1e-3
    of the rate of JAX's, and both moments within 1e-4 of each leaf's
    largest.

    Left out of the moves, and counted (at most 1% of the elements): an
    element whose gradient at a step the two sides round apart by more
    than 2e-4 of its size (``_rounded_apart``), since Adam's first steps
    scale each element to about +-1 whatever its size, so that a rounding
    error of the order of the value moves it by up to +-lr (ROADMAP C,
    reference behaviour 6); within 2e-4 a move agrees within about 3e-4
    lr. With compression, left out of the moves and the moments: an
    element that the quantization rounded the other way on the two sides
    (a value within rounding of half a quantum, whose error feedback
    changes sign: ``|e - e_jax| > max(|e|, |e_jax|)``)."""
    jcfg, cfg, tree, batch = qwen2
    adamw = dict(lr=LR, warmup_steps=0)
    jt = jts.TrainConfig(microbatches=microbatches, compress_grads=compress,
                         cast_params=None, adamw=jopt.AdamWConfig(**adamw))
    tcfg = TrainConfig(microbatches=microbatches, compress_grads=compress,
                       cast_params=None, adamw=opt.AdamWConfig(**adamw))
    jp = jax.tree.map(jnp.asarray, tree)
    jstate = jts.init_state(jcfg, jt, jp)
    jstep = jax.jit(jts.make_train_step(jcfg, jt))
    params = convert.params_from_jax(tree, cfg, "cpu", master=True)
    p0 = [p.clone() for p in T.leaves(params)]
    state = init_state(cfg, tcfg, params)
    step = make_train_step(cfg, tcfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def port(t):
        return T.leaves(convert.params_from_jax(
            jax.tree.map(np.asarray, t), cfg, "cpu", master=True))

    apart = [torch.zeros(p.shape, dtype=torch.bool) for p in p0]
    flipped = [torch.zeros(p.shape, dtype=torch.bool) for p in p0]
    m_prev = [[torch.zeros_like(p) for p in p0]] * 2
    for i in range(2):
        jp, jstate, jm = jstep(jp, jstate, jb)
        params, state, m = step(params, state, tb)
        for k in ("loss", "grad_norm", "lr"):
            _close(m[k], jm[k], f"{k} of step {i}")
        ms = [port(jstate["opt"].m), [t.clone() for t in T.leaves(
            state["opt"].m)]]
        gj, gp = (_grads_of_moments(a, b) for a, b in zip(ms, m_prev))
        for k, (a, b) in enumerate(zip(gj, gp)):
            apart[k] |= _rounded_apart(a, b)
        if compress:
            for k, (a, b) in enumerate(zip(port(jstate["err_fb"]),
                                           T.leaves(state["err_fb"]))):
                flipped[k] |= (a - b).abs() > torch.maximum(a.abs(), b.abs())
        m_prev = ms
    out = [a | f for a, f in zip(apart, flipped)]
    n = sum(int(x.sum()) for x in out)
    assert n <= 0.01 * sum(x.numel() for x in out), f"{n} left out"
    names = [name for name, _ in T.named_leaves(params)]
    for name, o, p, want, got in zip(names, out, p0, port(jp),
                                     T.leaves(params)):
        _close((got - p)[~o], (want - p)[~o], "move of " + name,
               tol=dict(rtol=0, atol=1e-3 * LR))
    for what, want, got in (("m", jstate["opt"].m, state["opt"].m),
                            ("v", jstate["opt"].v, state["opt"].v)):
        for name, f, w, g in zip(names, flipped, port(want), T.leaves(got)):
            k = ~f
            _close(g[k], w[k], f"{what} of {name}",
                   tol=dict(rtol=0, atol=1e-4 * float(w.abs().max())))


# ---------------------------------------------------------------------------
# the port's counterparts of tests/test_training.py
# ---------------------------------------------------------------------------

def test_adamw_converges_on_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.init(params)
    cfg = opt.AdamWConfig(lr=0.2, weight_decay=0.0, warmup_steps=0,
                          total_steps=200, min_lr_frac=1.0)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}
        params, state, _ = opt.update(cfg, params, grads, state)
    assert float(params["w"].abs().max()) < 1e-2


def test_grad_clip_and_schedule():
    g = {"w": torch.full((10,), 100.0)}
    clipped, gn = opt.clip_by_global_norm(g, 1.0)
    assert float(gn) == pytest.approx(100.0 * np.sqrt(10), rel=1e-5)
    assert float(torch.linalg.norm(clipped["w"])) == pytest.approx(1.0,
                                                                   1e-4)
    cfg = opt.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    assert float(opt.schedule(cfg, 5)) == pytest.approx(5e-4)
    assert float(opt.schedule(cfg, 10)) == pytest.approx(1e-3)
    assert float(opt.schedule(cfg, 100)) == pytest.approx(
        1e-3 * cfg.min_lr_frac, rel=1e-3)


def test_microbatching_matches_full_batch():
    """Gradient accumulation over M microbatches == one big batch (the
    bf16 compute copy, as the default ``cast_params`` makes it)."""
    cfg = configs.smoke(ARCH)
    batch = {k: torch.from_numpy(v)
             for k, v in registry.make_batch(cfg, 8, 16, seed=1).items()}
    outs = {}
    for m in (1, 4):
        params = registry.init_master_params(cfg, seed=0, device="cpu")
        tcfg = TrainConfig(microbatches=m)
        state = init_state(cfg, tcfg, params)
        new_p, _, metrics = make_train_step(cfg, tcfg)(params, state, batch)
        outs[m] = (metrics["loss"], new_p)
    _close(outs[4][0], outs[1][0], "loss", tol=dict(rtol=1e-5, atol=0))
    for a, b in zip(T.leaves(outs[1][1]), T.leaves(outs[4][1])):
        _close(b, a, tol=dict(rtol=1e-4, atol=1e-5))


def test_compressed_training_still_learns():
    cfg = configs.smoke(ARCH)
    params = registry.init_master_params(cfg, seed=0, device="cpu")
    tcfg = TrainConfig(compress_grads=True,
                       adamw=opt.AdamWConfig(lr=1e-3, warmup_steps=0,
                                             total_steps=30))
    state = init_state(cfg, tcfg, params)
    assert "err_fb" in state
    step = make_train_step(cfg, tcfg)
    batch = {k: torch.from_numpy(v)
             for k, v in registry.make_batch(cfg, 4, 16, seed=1).items()}
    losses = []
    for _ in range(12):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]     # memorizes the fixed batch


def test_checkpoint_roundtrip_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = {"a": torch.arange(5.0), "b": {"c": torch.ones((2, 3))},
            "l": [torch.full((2,), 7, dtype=torch.int32),
                  torch.tensor([1.5, -2.25], dtype=torch.bfloat16)]}
    for step in (1, 2, 3):
        ck.save(step, tree, extra={"pipeline": {"seed": 7, "step": step}},
                blocking=True)
    assert ck.committed_steps() == [2, 3]            # gc keeps last 2
    restored, extra, step = ck.restore(tree)
    assert step == 3 and extra["pipeline"]["step"] == 3
    for a, b in zip(T.leaves(tree), T.leaves(restored)):
        assert b.dtype == a.dtype and torch.equal(a, b)


def test_checkpoint_atomicity(tmp_path):
    """A .tmp directory (a crash during a save) is never restored."""
    ck = Checkpointer(str(tmp_path))
    tree = {"w": torch.ones(3)}
    ck.save(1, tree, blocking=True)
    os.makedirs(tmp_path / "step_00000002.tmp")      # crashed save
    assert ck.latest_step() == 1
    _, _, step = ck.restore(tree)
    assert step == 1


def test_async_save(tmp_path):
    """The snapshot is taken before ``save`` returns: an in-place change
    made while the file is written does not reach it."""
    ck = Checkpointer(str(tmp_path))
    w = torch.zeros(10)
    ck.save(5, {"w": w}, blocking=False)
    w.add_(1.0)
    ck.wait()
    assert ck.latest_step() == 5
    restored, _, _ = ck.restore({"w": w})
    assert torch.equal(restored["w"], torch.zeros(10))


def test_failure_injection_and_restart_resumes_exactly(tmp_path):
    from repro_torch.launch.train import run
    out = run(arch=ARCH, steps=14, batch=2, seq=16, ckpt_dir=str(tmp_path),
              fail_at=8, verbose=False, device="cpu")
    assert len(out["losses"]) >= 6                  # resumed and finished
    # deterministic pipeline -> the rerun of step 5..13 saw the same data
    out2 = run(arch=ARCH, steps=14, batch=2, seq=16,
               ckpt_dir=str(tmp_path) + "_clean", fail_at=None,
               verbose=False, device="cpu")
    np.testing.assert_allclose(out["losses"][-1], out2["losses"][-1],
                               rtol=1e-4)


def test_restart_from_a_checkpoint_ends_as_an_uninterrupted_run(tmp_path):
    """Checkpoints every 4 steps, a failure at step 6: the restart
    restores step 4 and its cursor, reruns steps 4 and 5 with the first
    attempt's losses, and ends with the parameters and optimizer state of
    a run that never failed, bit for bit."""
    from repro_torch.launch.train import run
    kw = dict(arch=ARCH, steps=8, batch=2, seq=16, microbatches=2,
              ckpt_every=4, verbose=False, device="cpu")
    history = []
    out = run(ckpt_dir=str(tmp_path / "a"), fail_at=6, history=history,
              **kw)
    clean = run(ckpt_dir=str(tmp_path / "b"), **kw)
    assert [h[0] for h in history] == [0, 1, 2, 3, 4, 5, 4, 5, 6, 7]
    assert out["steps"] == [4, 5, 6, 7]
    assert [h[1] for h in history[4:6]] == [h[1] for h in history[6:8]]
    assert out["losses"] == clean["losses"][4:]
    for a, b in zip(T.leaves((out["params"], out["state"])),
                    T.leaves((clean["params"], clean["state"]))):
        assert torch.equal(a, b)
    hb = Heartbeat(str(tmp_path / "a" / "heartbeat.json")).last()
    assert hb["step"] == 7


def test_run_with_restarts_gives_up():
    calls = []

    def always_fails():
        calls.append(1)
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError):
        run_with_restarts(always_fails, max_restarts=2)
    assert len(calls) == 3


def test_failure_injector_fires_once():
    inj = FailureInjector(3)
    inj.maybe_fail(2)
    with pytest.raises(RuntimeError, match="step 3"):
        inj.maybe_fail(3)
    assert inj.fired
    inj.maybe_fail(3)


def test_straggler_watchdog():
    w = StragglerWatchdog(threshold=3.0, consecutive_limit=2)
    for i in range(10):
        assert not w.observe(i, 0.1)
    assert w.observe(10, 1.0)
    assert not w.should_restart
    w.observe(11, 1.0)
    assert w.should_restart
    assert w.flagged_steps == [10, 11]


def test_pipeline_determinism_and_cursor():
    cfg = configs.smoke(ARCH)
    p1 = Pipeline(cfg, 4, 16, seed=3)
    batches = [p1.next() for _ in range(4)]
    state = p1.state_dict()
    assert state["step"] == 4
    p1.close()
    # restart mid-stream: batch 4 onward must match a fresh run's batch 4+
    p2 = Pipeline.restore(cfg, 4, 16, state)
    nxt = p2.next()
    p2.close()
    want = _batch_np(cfg, 4, 16, 3, 4)
    np.testing.assert_array_equal(nxt["tokens"].numpy(), want["tokens"])
    # and differs from batch 3
    assert not torch.equal(nxt["tokens"], batches[3]["tokens"])


def test_pipeline_sharding_partitions_stream():
    cfg = configs.smoke(ARCH)
    a = _batch_np(cfg, 8, 16, 0, 0, shard=0, n_shards=2)
    b = _batch_np(cfg, 8, 16, 0, 0, shard=1, n_shards=2)
    assert a["tokens"].shape == (4, 16)
    assert not np.array_equal(a["tokens"], b["tokens"])


def test_cuda_is_refused_without_a_card(tmp_path, monkeypatch):
    """No CPU fallback: asking for ``cuda`` where none is visible
    raises before any attempt."""
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.run(arch=ARCH, steps=2, batch=2, seq=16,
                  ckpt_dir=str(tmp_path), verbose=False)
