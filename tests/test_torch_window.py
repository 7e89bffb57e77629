"""The port's sliding-window serving path against the JAX package, on the
CPU at the reduced h2o-danube-1.8b config (window 64).

* The windowed prefill: logits, and the cache laid out as the ring at
  ``pos % window`` for a prompt longer than the window, equal JAX's
  ``transformer.prefill`` in fp32 and bf16.
* ``decode_step`` over the contiguous cache after the ring has wrapped:
  logits and the rows it writes equal JAX's.
* A token outside the receptive field cannot move the last logits (the
  port's counterpart of ``tests/test_models.py``'s
  ``test_sliding_window_limits_context``, one layer).
* The whole slice: the JAX ``LLMEngine`` and the port's, on the same
  prompts (4 slots, max_seq 192, prompts of 20, 60, 70 and 100 tokens,
  30 new tokens): greedy fp32 streams, ``steps``, ``readbacks`` and
  prefill buckets are equal.
* qwen2 (no window) on the contiguous cache, ``paged=False``: the streams
  equal JAX's contiguous engine and the port's paged one, with an idle
  slot's position run past the cache, whose writes are dropped as JAX's
  scatter drops them.

Tolerances: fp32 rtol 1e-5 / atol 1e-4, bf16 3e-2 / 3e-2 (the JAX
package's ``core/agents.py``).
"""

import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.serving.api import LLMEngine as JaxLLMEngine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import convert, layers, registry  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    CacheConfig, ContiguousCacheManager, LLMEngine, PagedCacheManager)

TOL = {"float32": dict(rtol=1e-5, atol=1e-4),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
ARCH = "h2o-danube-1.8b"

_CACHE = {}


def setup(dtype, arch=ARCH):
    """(jax cfg, port cfg, jax params, numpy params) with perturbed norm
    weights."""
    if (arch, dtype) not in _CACHE:
        jcfg = dataclasses.replace(jconfigs.smoke(arch), dtype=dtype)
        cfg = dataclasses.replace(configs.smoke(arch), dtype=dtype)
        params, _ = jregistry.init(jcfg, jax.random.PRNGKey(0))
        tree = jax.tree.map(np.asarray, params)
        rng = np.random.default_rng(0)
        lay = tree["layers"]
        for name in ("attn_norm", "mlp_norm"):
            lay[name] = (lay[name] + 0.2 * rng.standard_normal(
                lay[name].shape)).astype(np.float32)
        tree["final_norm"] = (tree["final_norm"] + 0.2 * rng.standard_normal(
            tree["final_norm"].shape)).astype(np.float32)
        _CACHE[arch, dtype] = (jcfg, cfg, jax.tree.map(jnp.asarray, tree),
                               tree)
    return _CACHE[arch, dtype]


def close(j, t, dtype):
    np.testing.assert_allclose(np.asarray(j, np.float32), t.float().numpy(),
                               **TOL[dtype])


def tokens(n, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (1, n)) \
        .astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [40, 100], ids=["inside", "past_window"])
def test_windowed_prefill_and_ring_match_jax(n, dtype):
    jcfg, cfg, jparams, tree = setup(dtype)
    assert cfg.window == 64
    params = convert.params_from_jax(tree, cfg, "cpu")
    toks = tokens(n, cfg.vocab, n)
    lj, cj = jax.jit(jtransformer.prefill, static_argnums=1,
                     static_argnames="cache_len")(jparams, jcfg,
                                                  jnp.asarray(toks),
                                                  cache_len=192)
    lt, ct = registry.prefill(params, cfg, torch.from_numpy(toks).long(),
                              cache_len=192)
    assert ct["k"].shape == (cfg.n_layers, 1, 64, cfg.n_kv_heads,
                             cfg.head_dim)
    close(lj, lt, dtype)
    for name in ("k", "v"):
        close(cj[name], ct[name], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_after_the_ring_wraps_matches_jax(dtype):
    """Slot 0 holds a 40-token prompt, slot 1 a 100-token one (its ring
    already wrapped); three decode steps write rows 40..42 and 36..38."""
    jcfg, cfg, jparams, tree = setup(dtype)
    params = convert.params_from_jax(tree, cfg, "cpu")
    jcache, _ = jregistry.init_cache(jcfg, 2, 192)
    tcache = registry.init_cache(cfg, 2, 192, "cpu")
    for slot, n in enumerate((40, 100)):
        toks = tokens(n, cfg.vocab, 7 + n)
        _, kj = jtransformer.prefill(jparams, jcfg, jnp.asarray(toks))
        jcache = jregistry.write_slot(jcfg, jcache, kj, slot, 192)
        _, kt = registry.prefill(params, cfg, torch.from_numpy(toks).long())
        registry.write_slot(cfg, tcache, kt, slot)
    step = jax.jit(jtransformer.decode_step, static_argnums=1)
    for t in range(3):
        pos = np.array([40 + t, 100 + t], np.int32)
        tok = np.array([3 + t, 11 + t], np.int32)
        lj, jcache = step(jparams, jcfg, jcache, jnp.asarray(tok),
                          jnp.asarray(pos))
        lt, tcache = registry.decode_cached(params, cfg, tcache,
                                            torch.from_numpy(tok),
                                            torch.from_numpy(pos))
        close(lj, lt, dtype)
    for name in ("k", "v"):
        close(jcache[name], tcache[name], dtype)


def test_sliding_window_limits_context():
    """One layer: a token more than a window before the last position
    cannot change its logits; a token inside the window does."""
    cfg = dataclasses.replace(configs.smoke(ARCH), n_layers=1)
    params = registry.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(tokens(80, cfg.vocab, 1)).long()
    far, near = toks.clone(), toks.clone()
    far[0, 2] = (far[0, 2] + 1) % cfg.vocab
    near[0, 70] = (near[0, 70] + 1) % cfg.vocab
    base = registry.prefill(params, cfg, toks)[0]
    torch.testing.assert_close(registry.prefill(params, cfg, far)[0], base,
                               rtol=1e-4, atol=1e-4)
    assert not torch.equal(registry.prefill(params, cfg, near)[0], base)


def test_update_cache_drops_writes_past_the_cache():
    """JAX's scatter drops a row index past the cache; the port's write
    leaves that request's cache as it was, and raises nothing."""
    rng = np.random.default_rng(2)
    ck, cv = rng.standard_normal((2, 2, 4, 1, 3)).astype(np.float32)
    kn, vn = rng.standard_normal((2, 2, 1, 3)).astype(np.float32)
    pos = np.array([1, 4], np.int32)
    jk, jv = jlayers.update_cache(jnp.asarray(ck), jnp.asarray(cv),
                                  jnp.asarray(kn), jnp.asarray(vn),
                                  jnp.asarray(pos))
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    layers.update_cache(tk, tv, torch.from_numpy(kn), torch.from_numpy(vn),
                        torch.from_numpy(pos))
    np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(tk[1].numpy(), ck[1])


def test_cache_config_picks_the_layout():
    h2o, qwen = configs.smoke(ARCH), configs.smoke("qwen2-0.5b")
    for cfg, paged, cls in ((h2o, None, ContiguousCacheManager),
                            (qwen, None, PagedCacheManager),
                            (qwen, False, ContiguousCacheManager)):
        cm = CacheConfig(paged=paged).build(cfg, 2, 128, "cpu")
        assert type(cm) is cls and cm.paged == (cls is PagedCacheManager)
    assert CacheConfig().build(h2o, 2, 128, "cpu").init()["k"].shape[2] == 64
    with pytest.raises(ValueError, match="page"):
        CacheConfig(paged=True).build(h2o, 2, 128, "cpu")


def _serve(arch, prompts, max_new, *, slots, max_seq, paged):
    jcfg, cfg, jparams, tree = setup("float32", arch)
    jllm = JaxLLMEngine(jparams, jcfg, slots=slots, max_seq=max_seq,
                        prefix_cache=False, paged=paged)
    jouts = jllm.generate(prompts, max_new_tokens=max_new)
    tllm = LLMEngine(convert.params_from_jax(tree, cfg, "cpu"), cfg,
                     slots=slots, max_seq=max_seq, paged=paged, device="cpu")
    touts = tllm.generate(prompts, max_new_tokens=max_new)
    return jllm.stats(), jouts, tllm, touts


def test_windowed_serving_fp32_streams_equal_jax():
    """Two prompts shorter than the window (bucketed to 32 and 64), two
    longer (prefilled at exact length); decoding wraps every ring."""
    cfg = configs.smoke(ARCH)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (20, 60, 70, 100)]
    js, jouts, tllm, touts = _serve(ARCH, prompts, 30, slots=4, max_seq=192,
                                    paged=None)
    ts = tllm.stats()
    assert not ts["paged"]
    assert [o.tokens for o in touts] == [o.tokens for o in jouts]
    assert all(o.finish_reason == "done" and len(o.tokens) == 30
               for o in touts)
    assert ts["steps"] == js["steps"] == 29
    assert ts["readbacks"] == js["readbacks"] == ts["steps"]
    assert ts["prefill_shapes"] == js["prefill_shapes"] == [32, 64, 70, 100]


def test_contiguous_qwen2_streams_equal_jax_and_the_paged_pool():
    cfg = configs.smoke("qwen2-0.5b")
    rng = np.random.default_rng(0)
    lens = [3, 17, 5, 40, 9, 64, 2, 33, 12, 7, 90, 21]
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]
    max_new = [int(m) for m in rng.integers(4, 40, len(lens))]
    js, jouts, tllm, touts = _serve("qwen2-0.5b", prompts, max_new, slots=4,
                                    max_seq=128, paged=False)
    assert not tllm.stats()["paged"]
    assert [o.tokens for o in touts] == [o.tokens for o in jouts]
    assert tllm.stats()["steps"] == js["steps"]
    # an idle slot ran past the cache: its writes were dropped
    assert int(tllm.engine._pos.max()) >= 128
    _, cfg32, _, tree = setup("float32", "qwen2-0.5b")
    paged = LLMEngine(convert.params_from_jax(tree, cfg32, "cpu"), cfg32,
                      slots=4, max_seq=128, device="cpu")
    assert [o.tokens for o in paged.generate(prompts, max_new_tokens=max_new)
            ] == [o.tokens for o in touts]
