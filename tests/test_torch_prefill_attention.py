"""The prefill attention's dispatch and its wrapper, on the CPU.

``layers.flash_attention`` sends its causal calls in bf16 without grad to
``ops.prefill_attention`` (the Hopper kernel on the card) and keeps the
others on the fp32 walk: calls with grad (the backward needs the walk's
log-sum-exp), non-causal ones (JAX's zero pad rows take softmax weight
there) and fp32 ones. On a CPU tensor the wrapper is the walk itself and
launches nothing; on the card (``tests/test_torch_cuda.py``) it launches
the kernel or raises, and its checks raise before any launch. The bf16
walk is held to the JAX package's ``flash_attention`` here.
"""

import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import prefill_attention as pa  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

BF16 = torch.bfloat16


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(b, s, hq, hkv, dh, dtype=BF16, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(dtype) for shape in ((b, s, hq, dh), (b, s, hkv, dh),
                                     (b, s, hkv, dh))]


# (batch, seq, q heads, kv heads, head_dim, window): the serving families'
# head groups at small lengths, edges of the kernel's 64-row tiles, a batch
# of two prompts, windows shorter and longer than the prompt
SHAPES = [(1, 1, 4, 2, 32, None), (1, 63, 14, 2, 64, None),
          (1, 65, 14, 2, 64, None), (2, 100, 8, 1, 128, None),
          (1, 130, 4, 1, 80, 64), (1, 40, 10, 1, 256, 16),
          (1, 200, 4, 4, 64, 300)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [BF16, torch.float32], ids=str)
def test_on_the_cpu_the_wrapper_is_the_walk_and_launches_nothing(
        shape, dtype, monkeypatch):
    def refuse():
        raise AssertionError("the CUDA library was loaded for a CPU tensor")

    monkeypatch.setattr(_build, "library", refuse)
    b, s, hq, hkv, dh, window = shape
    q, k, v = _qkv(b, s, hq, hkv, dh, dtype)
    before = ops.launch_counts()
    got = ops.prefill_attention(q, k, v, window=window)
    assert ops.launch_counts() == before
    want, _ = pa.walk(q, k, v, True, window, pa.CHUNK)
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("shape", SHAPES[1:5], ids=str)
def test_the_bf16_prefill_attention_matches_jax(shape):
    """The no-grad causal bf16 call (the kernel's route) gives JAX's
    ``flash_attention`` at the bf16 tolerance."""
    b, s, hq, hkv, dh, window = shape
    q, k, v = _qkv(b, s, hq, hkv, dh, seed=3)
    with torch.no_grad():
        got = L.flash_attention(q, k, v, window=window)
    want = JL.flash_attention(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)),
        True, window)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=3e-2, atol=3e-2)


class _Spy:
    def __init__(self, monkeypatch):
        self.calls = []
        real = pa.prefill_attention

        def spy(q, k, v, *, window=None):
            self.calls.append((tuple(q.shape), window))
            return real(q, k, v, window=window)

        monkeypatch.setattr(pa, "prefill_attention", spy)


# (causal, grad mode, dtype, calls through ops)
ROUTES = [(True, False, BF16, 1), (True, True, BF16, 0),
          (False, False, BF16, 0), (True, False, torch.float32, 0),
          (False, True, torch.float32, 0)]


@pytest.mark.parametrize("causal,grad,dtype,through_ops", ROUTES, ids=str)
def test_flash_attention_sends_only_causal_no_grad_bf16_calls_to_ops(
        causal, grad, dtype, through_ops, monkeypatch):
    spy = _Spy(monkeypatch)
    q, k, v = _qkv(1, 70, 4, 2, 32, dtype, seed=1)
    for t in (q, k, v):
        t.requires_grad_(grad)
    got = L.flash_attention(q, k, v, causal=causal, window=32)
    assert spy.calls == [((1, 70, 4, 32), 32)] * through_ops
    want, _ = pa.walk(q.detach(), k.detach(), v.detach(), causal, 32)
    assert torch.equal(got.detach(), want)
    assert got.requires_grad == grad


def test_a_prefill_calls_ops_once_a_layer(monkeypatch):
    """Every dense layer's prefill attention goes through ops in bf16, on
    the same q shapes and the config's window."""
    from repro_torch import configs
    from repro_torch.models import registry
    cfg = dataclasses.replace(configs.smoke("h2o-danube-1.8b"),
                              dtype="bfloat16")
    params = registry.init_params(cfg, seed=0, device="cpu")
    spy = _Spy(monkeypatch)
    with torch.no_grad():
        registry.prefill(params, cfg, torch.arange(80)[None] % cfg.vocab)
    assert spy.calls == [((1, 80, cfg.n_heads, cfg.head_dim),
                          cfg.window)] * cfg.n_layers


def _bad_inputs():
    q, k, v = _qkv(1, 8, 4, 2, 32)
    t = torch
    return {
        "fp32": (q.float(), k.float(), v.float(), None),
        "head_dim 48": (*_qkv(1, 8, 4, 2, 48), None),
        "heads 3 of 2": (*_qkv(1, 8, 3, 2, 32)[:1], k, v, None),
        "k and v differ": (q, k, v[:, :, :1], None),
        "k shorter than q": (q, k[:, :4], v[:, :4], None),
        "strided head_dim": (q.transpose(1, 3).contiguous().transpose(1, 3),
                             k, v, None),
        "odd row stride": (t.empty((1, 8, 4, 36), dtype=BF16)[..., :32],
                           k, v, None),
        "misaligned start": (t.empty(1 * 8 * 4 * 32 + 1,
                                     dtype=BF16)[1:].view(1, 8, 4, 32),
                             k, v, None),
        "window 0": (q, k, v, 0),
        "3-d q": (q[0], k, v, None),
    }


@pytest.mark.parametrize("case", list(_bad_inputs()), ids=str)
def test_the_wrapper_checks_raise_before_any_launch(case, monkeypatch):
    def refuse():
        raise AssertionError("the library was loaded before the checks")

    monkeypatch.setattr(_build, "library", refuse)
    q, k, v, window = _bad_inputs()[case]
    before = pa.prefill_attention.launches
    with pytest.raises(ValueError):
        pa._launch(q, k, v, window)
    assert pa.prefill_attention.launches == before


def test_the_wrapper_refuses_other_devices():
    q, k, v = (torch.empty(s, device="meta", dtype=BF16)
               for s in ((1, 8, 4, 32), (1, 8, 2, 32), (1, 8, 2, 32)))
    with pytest.raises(ValueError):
        ops.prefill_attention(q, k, v)


@pytest.mark.parametrize("seq,window", [(1, None), (7, None), (7, 3),
                                        (7, 7), (7, 20), (300, 64)])
def test_work_counts_the_visible_pairs(seq, window):
    i = np.arange(seq)[:, None]
    j = np.arange(seq)[None, :]
    seen = (j <= i) & ((i - j < window) if window else True)
    assert pa.visible_pairs(seq, window) == int(seen.sum())
    flops, nbytes = pa.work(batch=2, seq=seq, q_heads=4, kv_heads=2,
                            head_dim=32, window=window)
    assert flops == 4 * 32 * 4 * 2 * int(seen.sum())
    assert nbytes == 2 * seq * 32 * 2 * (2 * 4 + 2 * 2)


def test_work_at_the_serving_shapes():
    """yi-34b's 2,048-row bucket and h2o-danube-1.8b's 4,096 bucket and
    7,168-row prompt (window 4,096): the flops a layer."""
    yi = pa.work(batch=1, seq=2048, q_heads=56, kv_heads=8, head_dim=128)
    danube = [pa.work(batch=1, seq=s, q_heads=32, kv_heads=8, head_dim=80,
                      window=4096)[0] for s in (4096, 7168)]
    assert round(yi[0] / 1e10, 1) == 6.0
    assert [round(f / 1e10, 1) for f in danube] == [8.6, 21.5]
