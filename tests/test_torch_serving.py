"""The PyTorch port's model and serving slice against the JAX package, on
the CPU at the reduced qwen2-0.5b config.

* ``params_from_jax`` on JAX-made weights whose norm weights and QKV
  biases are perturbed away from their init (so those paths count): the
  ``prefill`` logits and KV, and the ``decode_step_paged`` logits and the
  pool rows it writes, match JAX in fp32 and in bf16.
* The page allocator makes the same tables as the JAX one.
* The whole slice: the JAX ``LLMEngine(prefix_cache=False)`` and the
  port's ``LLMEngine(device="cpu", prefix_cache=False)`` on the same
  prompts. At fp32 the
  greedy streams, ``steps``, ``readbacks`` and the prefill buckets are
  equal; at bf16 the streams are equal up to any step where the JAX
  top-2 logit margin is within the bf16 tolerance.

Tolerances: fp32 rtol 1e-5 / atol 1e-4, bf16 3e-2 / 3e-2 (the JAX
package's ``core/agents.py``).
"""

import argparse
import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.serving.api import LLMEngine as JaxLLMEngine  # noqa: E402
from repro.serving.paging import PagePool as JaxPagePool  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import convert, registry, transformer  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    LLMEngine, PagePool, SamplingParams)

TOL = {"float32": dict(rtol=1e-5, atol=1e-4),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
ARCH = "qwen2-0.5b"

_CACHE = {}


def setup(dtype):
    """(jax cfg, port cfg, jax params, numpy params) with perturbed norms
    and QKV biases."""
    if dtype not in _CACHE:
        jcfg = dataclasses.replace(jconfigs.smoke(ARCH), dtype=dtype)
        cfg = dataclasses.replace(configs.smoke(ARCH), dtype=dtype)
        params, _ = jregistry.init(jcfg, jax.random.PRNGKey(0))
        tree = jax.tree.map(np.asarray, params)
        rng = np.random.default_rng(0)
        lay = tree["layers"]
        for name in ("attn_norm", "mlp_norm"):
            lay[name] = (lay[name] + 0.2 * rng.standard_normal(
                lay[name].shape)).astype(np.float32)
        for name in ("bq", "bk", "bv"):
            a = lay["attn"][name]
            lay["attn"][name] = (0.2 * rng.standard_normal(a.shape)) \
                .astype(np.float32)
        tree["final_norm"] = (tree["final_norm"] + 0.2 * rng.standard_normal(
            tree["final_norm"].shape)).astype(np.float32)
        _CACHE[dtype] = (jcfg, cfg, jax.tree.map(jnp.asarray, tree), tree)
    return _CACHE[dtype]


def close(j, t, dtype):
    np.testing.assert_allclose(np.asarray(j, np.float32), t.float().numpy(),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_paged_decode_match_jax(dtype):
    jcfg, cfg, jparams, tree = setup(dtype)
    params = convert.params_from_jax(tree, cfg, "cpu")
    assert params["layers"][0]["attn_norm"].dtype == torch.float32
    assert params["layers"][0]["attn"]["wq"].dtype == cfg.torch_dtype
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab, (1, 16)).astype(np.int32)
    n = 11                      # true length of a right-padded prompt
    lj, cj = jax.jit(jtransformer.prefill, static_argnums=1,
                     static_argnames="length")(jparams, jcfg,
                                               jnp.asarray(tokens), length=n)
    lt, ct = transformer.prefill(params, cfg, torch.from_numpy(tokens),
                                 length=n)
    close(lj, lt, dtype)
    close(cj["k"], ct["k"], dtype)
    close(cj["v"], ct["v"], dtype)

    # write the prompt's 2 pages, then decode one token at position n
    page, n_phys = 8, 6
    pages = np.array([3, 1], np.int64)
    table = np.array([[3, 1, 4], [0, 0, 0]], np.int32)  # slot 1 idles
    token = np.array([7, 0], np.int32)
    pos = np.array([n, 0], np.int32)
    jpool, _ = jregistry.init_paged_cache(jcfg, n_phys, page)
    jpool = jregistry.write_pages(jcfg, jpool, cj, jnp.asarray(pages), page)
    tpool = registry.init_paged_cache(cfg, n_phys, page, "cpu")
    registry.write_pages(cfg, tpool, ct, torch.from_numpy(pages), page)
    dj, jpool = jax.jit(jtransformer.decode_step_paged, static_argnums=1)(
        jparams, jcfg, jpool, jnp.asarray(table), jnp.asarray(token),
        jnp.asarray(pos))
    dt, tpool = registry.decode_cached(
        params, cfg, tpool, torch.from_numpy(token), torch.from_numpy(pos),
        page_table=torch.from_numpy(table))
    close(dj[0], dt[0], dtype)
    for name in ("k", "v"):
        # the prompt pages and the new row at (page 1 of the table, n % 8)
        close(jpool[name][:, 3], tpool[name][:, 3], dtype)
        close(jpool[name][:, 1], tpool[name][:, 1], dtype)


def test_page_pool_matches_jax():
    """The same alloc/release churn gives the same page tables."""
    args = dict(num_pages=10, page_size=16, slots=3, pages_per_slot=4)
    jp, tp = JaxPagePool(**args), PagePool(**args)
    rng = np.random.default_rng(0)
    for _ in range(300):
        slot = int(rng.integers(3))
        op = rng.random()
        if op < 0.3:
            jp.release(slot)
            tp.release(slot)
        elif op < 0.6:
            k = int(rng.integers(1, 3))
            assert jp.alloc_n(slot, k) == tp.alloc_n(slot, k)
        elif len(tp.owned[slot]) < tp.pages_per_slot:
            assert jp.alloc(slot) == tp.alloc(slot)
        tp.check()
        np.testing.assert_array_equal(jp.table, tp.table)
        assert jp.num_free == tp.num_free


def _prompts(vocab):
    rng = np.random.default_rng(0)
    lens = [3, 17, 5, 40, 9, 64, 2, 33, 12, 7, 90, 21]
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in lens]
    max_new = [int(m) for m in rng.integers(4, 20, len(lens))]
    return prompts, max_new


def _serve_both(dtype):
    jcfg, cfg, jparams, tree = setup(dtype)
    prompts, max_new = _prompts(jcfg.vocab)
    jllm = JaxLLMEngine(jparams, jcfg, slots=4, max_seq=128,
                        prefix_cache=False)
    jouts = jllm.generate(prompts, max_new_tokens=max_new)
    tllm = LLMEngine(convert.params_from_jax(tree, cfg, "cpu"), cfg,
                     slots=4, max_seq=128, device="cpu", prefix_cache=False)
    touts = tllm.generate(prompts, max_new_tokens=max_new)
    return jcfg, jparams, prompts, jllm.stats(), jouts, tllm.stats(), touts


def test_serving_slice_fp32_streams_equal_jax():
    _, _, _, js, jouts, ts, touts = _serve_both("float32")
    assert [o.tokens for o in touts] == [o.tokens for o in jouts]
    assert all(o.finish_reason == "done" for o in touts)
    assert ts["steps"] == js["steps"]
    assert ts["readbacks"] == js["readbacks"] == ts["steps"]
    assert ts["prefill_compiles"] == js["prefill_compiles"]
    assert ts["prefill_shapes"] == js["prefill_shapes"]


def test_serving_slice_bf16_agrees_with_jax():
    jcfg, jparams, prompts, js, jouts, ts, touts = _serve_both("bfloat16")
    assert ts["readbacks"] == ts["steps"]
    for prompt, jo, to in zip(prompts, jouts, touts):
        assert len(to.tokens) == len(jo.tokens)
        diff = [i for i, (a, b) in enumerate(zip(jo.tokens, to.tokens))
                if a != b]
        if not diff:
            continue
        # the first divergence must sit on a near-tie of the JAX logits
        i = diff[0]
        seq = np.concatenate([prompt, np.asarray(jo.tokens[:i], np.int32)])
        logits, _ = jtransformer.prefill(jparams, jcfg,
                                         jnp.asarray(seq[None]))
        lg = np.asarray(logits[0], np.float32)
        a, b = lg[jo.tokens[i]], lg[to.tokens[i]]
        assert abs(a - b) <= TOL["bfloat16"]["atol"] \
            + TOL["bfloat16"]["rtol"] * abs(a), (i, a, b)


def test_engine_refuses_sampling_and_rejects_what_cannot_fit():
    """Sampling parameters that make no draw are refused where they are
    made; a valid sampled request is served like a greedy one."""
    _, cfg, _, tree = setup("float32")
    llm = LLMEngine(convert.params_from_jax(tree, cfg, "cpu"), cfg,
                    slots=2, max_seq=32, device="cpu")
    for bad in (dict(temperature=-0.7), dict(top_k=-1), dict(top_p=0.0)):
        with pytest.raises(ValueError):
            SamplingParams(**bad)
    sampled = llm.generate([np.arange(4)], SamplingParams(temperature=0.7),
                           max_new_tokens=3)
    assert sampled[0].finish_reason == "done"
    assert len(sampled[0].tokens) == 3
    outs = llm.generate([np.arange(40) % cfg.vocab, np.arange(5)],
                        max_new_tokens=3)
    assert outs[0].finish_reason == "rejected" and outs[0].tokens == []
    assert outs[1].finish_reason == "done" and len(outs[1].tokens) == 3


def test_entry_points_need_a_gpu_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg, _, tree = setup("float32")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMEngine(convert.params_from_jax(tree, cfg, "cpu"), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        registry.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.params_from_jax(tree, cfg)


def _serve_args(**kw):
    args = dict(arch=ARCH, smoke=True, device="cpu", requests=5, slots=2,
                max_seq=64, page_size=16, num_pages=None, preemption="swap",
                min_prompt=3, max_prompt=30, max_new=4, crossing=0, seed=0,
                profile=False, rows=0, no_prefix_cache=False,
                scheduler="fcfs", temperature=0.0, top_k=0, top_p=1.0,
                sampling_seed=None, chaos=None, deadline=None, spec=None,
                spec_k=4)
    return argparse.Namespace(**{**args, **kw})


def test_serve_command_runs_the_reduced_config_on_cpu():
    from repro_torch.launch import serve
    out = serve.run(_serve_args())
    assert out["all_done"] and out["requests"] == 5 and out["paged"]
    assert out["readbacks"] == out["steps"] > 0
    assert out["preemptions"] == 0 and out["pool_ok"]
    assert out["decode_captures"] == out["graph_replays"] == 0
    assert out["launches"] == {"fused_add_rmsnorm": 0, "silu_and_mul": 0,
                               "paged_flash_decode": 0,
                               "merge_attn_states_lse": 0,
                               "flash_decode": 0}


@pytest.mark.parametrize("preemption", ["swap", "recompute"])
def test_serve_command_oversubscribes_on_cpu(preemption):
    """Four pages of 16 for two slots of 64 rows: the serve command
    preempts, every request finishes with its tokens, and the pool holds
    its invariants and ends empty."""
    from repro_torch.launch import serve
    out = serve.run(_serve_args(num_pages=4, preemption=preemption,
                                min_prompt=20, max_prompt=30, max_new=24))
    assert out["all_done"] and out["num_pages"] == 4
    assert out["preemptions"] >= 1 and out["preemption"] == preemption
    assert out["pool_ok"] and out["pool_released"]
    assert out["readbacks"] == out["steps"]
    swapped = out["swapped_out_pages"]
    assert swapped == out["swapped_in_pages"]
    assert (swapped > 0) == (preemption == "swap")


def test_seeded_init_is_reproducible_and_shaped():
    cfg = configs.smoke(ARCH)
    a = registry.init_params(cfg, seed=3, device="cpu")
    b = registry.init_params(cfg, seed=3, device="cpu")
    assert torch.equal(a["embed"], b["embed"])
    assert a["embed"].shape == (cfg.padded_vocab, cfg.d_model)
    assert a["lm_head"].dtype == cfg.torch_dtype
    wq = a["layers"][0]["attn"]["wq"].float()
    assert wq.shape == (cfg.d_model, cfg.n_heads, cfg.head_dim)
    assert wq.abs().max() <= 2 * cfg.d_model ** -0.5 + 1e-6
    assert len(a["layers"]) == cfg.n_layers
