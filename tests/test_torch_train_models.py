"""The training forward of every family of the PyTorch port against the
JAX package, on the CPU in fp32 at the reduced configs: the loss and the
gradient of every parameter leaf of ``registry.loss_fn`` against
``jax.value_and_grad``, the flash-attention gradient against JAX's custom
VJP, and the gradients of the two kernels' autograd Functions against
``jax.vjp`` of the JAX oracles.

Weights: JAX's ``init`` at ``PRNGKey(0)``, through
``convert.params_from_jax(..., master=True)`` (every leaf fp32); the JAX
gradient tree goes through the same unstacking, so the two compare leaf
by leaf. Batches: ``registry.make_batch`` (numpy), fed to both sides.
recurrentgemma's ``conv_w`` is drawn non-zero on both sides (at init it is
zero and the recurrent branch would see no input), and the xLSTM's mLSTM
gates ``w_i``, ``w_f`` at ``dh ** -0.5`` (at JAX's scale one ulp of a
block's input moves JAX's own output past fp32's tolerance; ROADMAP C,
reference behaviour 4). h2o-danube-1.8b runs 96 tokens, past its window
of 64. Tolerance: ``core/agents.py::_tolerance`` fp32, rtol 1e-5 / atol
1e-4.
"""

import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import convert, registry  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.training import tree as T  # noqa: E402

FP32 = dict(rtol=1e-5, atol=1e-4)
# (arch, batch, seq)
FAMILIES = [("qwen2-0.5b", 2, 32), ("h2o-danube-1.8b", 2, 96),
            ("olmoe-1b-7b", 2, 32), ("recurrentgemma-2b", 2, 64),
            ("xlstm-1.3b", 2, 64), ("seamless-m4t-large-v2", 2, 32)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: many tiny CPU ops, beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _redraw(tree, arch):
    """The leaves the module docstring names, redrawn on the numpy tree
    (one seeded draw, truncated at 2)."""
    rng = np.random.default_rng(11)
    if arch == "recurrentgemma-2b":
        rec = [tree["periods"]["rec"], tree["tail"]]
        for r in rec:
            r["conv_w"] = (0.5 * rng.standard_normal(r["conv_w"].shape)
                           ).astype(np.float32)
    if arch == "xlstm-1.3b":
        m = tree["periods"]["mlstm"]
        dh = m["w_i"].shape[-1]
        for name in ("w_i", "w_f"):
            m[name] = (np.clip(rng.standard_normal(m[name].shape), -2, 2)
                       * dh ** -0.5).astype(np.float32)
    return tree


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, what, tol=FP32):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), err_msg=what,
                               **tol)


@pytest.mark.parametrize("arch,b,s", FAMILIES)
def test_loss_and_every_gradient_leaf_match_jax(arch, b, s):
    jcfg = dataclasses.replace(jconfigs.smoke(arch), dtype="float32")
    cfg = dataclasses.replace(configs.smoke(arch), dtype="float32")
    # jitted: the same bits as the eager init and far quicker to trace
    jparams = jax.jit(lambda key: jregistry.init(jcfg, key)[0])(
        jax.random.PRNGKey(0))
    tree = _redraw(jax.tree.map(np.asarray, jparams), arch)
    batch = registry.make_batch(cfg, b, s, seed=1)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, bt: jregistry.loss_fn(p, jcfg, bt)))(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()})
    want = convert.params_from_jax(jax.tree.map(np.asarray, jgrads), cfg,
                                   "cpu", master=True)

    params = convert.params_from_jax(tree, cfg, "cpu", master=True)
    leaves = [p.requires_grad_() for p in T.leaves(params)]
    loss = registry.loss_fn(params, cfg, _torch_batch(batch))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    _close(loss.detach(), jloss, "loss")
    named = T.named_leaves(want)
    assert len(named) == len(grads)
    for (name, w), g in zip(named, grads):
        _close(g, w, name)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

B, HQ, HKV, DH = 2, 4, 2, 32


# the parametrisation of tests/test_flash_attention.py
@pytest.mark.parametrize("causal,window,chunk,s", [
    (True, None, 16, 64), (True, 24, 16, 64), (False, None, 32, 96),
    (True, None, 64, 100),   # padded final chunk
    (False, None, 64, 100),  # the pad rows of a non-causal call
])
def test_flash_attention_gradients_match_jax(causal, window, chunk, s):
    rng = np.random.default_rng(0)
    q, k, v, dout = (rng.standard_normal(shape).astype(np.float32)
                     for shape in ((B, s, HQ, DH), (B, s, HKV, DH),
                                   (B, s, HKV, DH), (B, s, HQ, DH)))
    out, vjp = jax.vjp(lambda *a: JL.flash_attention(
        *a, causal, window, chunk, not causal), q, k, v)
    want = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = L.flash_attention(tq, tk, tv, causal=causal, window=window,
                            chunk=chunk)
    _close(got.detach(), out, "out")
    grads = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(dout))
    for name, g, w in zip("qkv", grads, want):
        _close(g, w, f"d{name}")


def test_flash_attention_saves_no_chunk_probabilities():
    """The forward saves (q, k, v, out, lse) and nothing of a chunk's
    scores: no saved tensor holds ``Sq x chunk`` entries a head."""
    s, chunk = 256, 32
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).requires_grad_() for shape in
        ((1, s, 2, 16), (1, s, 1, 16), (1, s, 1, 16)))
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = L.flash_attention(q, k, v, causal=True, chunk=chunk)
    assert sorted(saved) == sorted([(1, s, 2, 16), (1, s, 1, 16),
                                    (1, s, 1, 16), (1, s, 2, 16),
                                    (1, 1, 2, s)])
    # one chunk's probabilities: [B, Hkv, G, Sq, chunk] = 2 s chunk
    assert max(int(np.prod(x)) for x in saved) < 2 * s * chunk
    out.sum().backward()
    assert q.grad is not None and k.grad is not None


# ---------------------------------------------------------------------------
# the kernels' autograd Functions
# ---------------------------------------------------------------------------

def test_rmsnorm_function_gradient_matches_jax_vjp():
    rng = np.random.default_rng(2)
    x, r, dy, dr = (rng.standard_normal((3, 5, 64)).astype(np.float32)
                    for _ in range(4))
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    out, vjp = jax.vjp(lambda *a: jref.fused_add_rmsnorm(*a, 1e-6), x, r, w)
    want = vjp((jnp.asarray(dy), jnp.asarray(dr)))
    tx, tr, tw = (torch.from_numpy(a).requires_grad_() for a in (x, r, w))
    y, r_out = ops.fused_add_rmsnorm(tx, tr, tw, 1e-6)
    assert y.grad_fn is not None and "FusedAddRmsNorm" in type(
        y.grad_fn).__name__
    _close(y.detach(), out[0], "y")
    _close(r_out.detach(), out[1], "r'")
    grads = torch.autograd.grad((y, r_out), (tx, tr, tw),
                                (torch.from_numpy(dy), torch.from_numpy(dr)))
    for name, g, w_ in zip(("dx", "dresidual", "dweight"), grads, want):
        _close(g, w_, name)


def test_silu_function_gradient_matches_jax_vjp():
    rng = np.random.default_rng(3)
    x = (2 * rng.standard_normal((4, 7, 96))).astype(np.float32)
    dout = rng.standard_normal((4, 7, 48)).astype(np.float32)
    out, vjp = jax.vjp(jref.silu_and_mul, x)
    want, = vjp(jnp.asarray(dout))
    tx = torch.from_numpy(x).requires_grad_()
    got = ops.silu_and_mul(tx)
    assert "SiluAndMul" in type(got.grad_fn).__name__
    _close(got.detach(), out, "out")
    g, = torch.autograd.grad(got, tx, torch.from_numpy(dout))
    _close(g, want, "dx")


def test_without_grad_the_kernels_are_called_directly():
    """Serving (no input needs a gradient, or grad mode off) takes the
    wrappers as before: no autograd node."""
    x = torch.randn(4, 64)
    w = torch.ones(64, requires_grad=True)
    with torch.no_grad():
        y, _ = ops.fused_add_rmsnorm(x, x, w)
    h = ops.silu_and_mul(torch.randn(4, 128))
    assert y.grad_fn is None and h.grad_fn is None
