"""The dense qk-norm configs (qwen3-8b, yi-34b, chameleon-34b) of the
PyTorch port against the JAX package, on the CPU at their reduced configs
(2 layers, d_model 128, 4/2 heads of 32, vocab 512), and the seeded init
drawn one layer at a time.

* Each config's dimensions equal JAX's, full and reduced.
* Prefill logits and caches, and five paged decode steps, equal JAX's in
  fp32 (rtol 1e-5 / atol 1e-4; JAX ``PRNGKey(0)`` weights through
  ``convert.params_from_jax``).
* Greedy streams, ``steps``, ``readbacks``, ``preemptions`` and the prefix
  cache's hit tokens equal the JAX engine's on the serve benchmark's
  ``ragged_burst``, ``oversubscribed`` (preemption) and ``shared_prefix``
  (the radix tree) mixes, in fp32.
* ``registry.init_params`` draws and casts one layer at a time (so a 34B
  model fits a card in bf16); its weights equal, bit for bit, the
  all-at-once init it replaced (every layer drawn in fp32, then the whole
  tree cast; reproduced below) for qwen2-0.5b, qwen3-8b and olmoe-1b-7b
  in bf16 and fp32.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.serving import LLMEngine as JaxLLMEngine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import (  # noqa: E402
    convert, moe, registry, transformer)
from repro_torch.serving import LLMEngine  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ARCHS = ("qwen3-8b", "yi-34b", "chameleon-34b")
FP32 = dict(rtol=1e-5, atol=1e-4)
MIXES = ("ragged_burst", "oversubscribed", "shared_prefix")


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
    """{arch: (jax cfg, port cfg, jax params, port params on the CPU)},
    fp32, PRNGKey(0)."""
    out = {}
    for arch in ARCHS:
        jcfg = dataclasses.replace(jconfigs.smoke(arch), dtype="float32")
        cfg = dataclasses.replace(configs.smoke(arch), dtype="float32")
        params, _ = jregistry.init(jcfg, jax.random.PRNGKey(0))
        out[arch] = (jcfg, cfg, params, convert.params_from_jax(
            jax.tree.map(np.asarray, params), cfg, "cpu"))
    return out


@pytest.fixture(scope="module")
def bench():
    spec = importlib.util.spec_from_file_location(
        "serve_bench_for_dense_config_tests",
        REPO / "benchmarks" / "serve_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **FP32)


@pytest.mark.parametrize("arch", ARCHS + ("recurrentgemma-2b",))
def test_configs_equal_jax(arch):
    for jcfg, cfg in ((jconfigs.get(arch), configs.get(arch)),
                      (jconfigs.smoke(arch), configs.smoke(arch))):
        mine = dataclasses.asdict(cfg)
        theirs = {k: v for k, v in dataclasses.asdict(jcfg).items()
                  if k in mine}
        assert mine == theirs
        assert cfg.head_dim == jcfg.head_dim
        assert cfg.padded_vocab == jcfg.padded_vocab


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_paged_decode_match_jax(arch, fp32):
    jcfg, cfg, params, tp = fp32[arch]
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (1, 21)).astype(np.int32)
    jl, jc = jtransformer.prefill(params, jcfg, jnp.asarray(toks))
    tl, tc = registry.prefill(tp, cfg, torch.from_numpy(toks).long())
    _close(tl, jl)
    for name in ("k", "v"):
        _close(tc[name], jc[name])
    page, pages = 8, np.array([3, 1, 4, 2], np.int32)
    jpool = jregistry.write_pages(
        jcfg, jregistry.init_paged_cache(jcfg, 6, page)[0], jc,
        jnp.asarray(pages[:3]), page)
    tpool = registry.write_pages(
        cfg, registry.init_paged_cache(cfg, 6, page, "cpu"), tc,
        torch.from_numpy(pages[:3]).long(), page)
    table = pages[None]
    pos = np.array([21], np.int32)
    for _ in range(5):
        tok = rng.integers(0, cfg.vocab, 1).astype(np.int32)
        jl, jpool = jregistry.decode_step_paged(
            params, jcfg, jpool, jnp.asarray(table), jnp.asarray(tok),
            jnp.asarray(pos))
        tl, tpool = registry.decode_cached(
            tp, cfg, tpool, torch.from_numpy(tok), torch.from_numpy(pos),
            page_table=torch.from_numpy(table))
        _close(tl, jl)
        for name in ("k", "v"):
            _close(tpool[name], jpool[name])
        pos = pos + 1


@pytest.mark.parametrize("mix", MIXES)
@pytest.mark.parametrize("arch", ARCHS)
def test_streams_equal_the_jax_engine(arch, mix, fp32, bench):
    jcfg, cfg, params, tp = fp32[arch]
    reqs = bench.build_requests(jcfg, mix)
    kw = dict(slots=bench.SLOTS, max_seq=bench.MAX_SEQ)
    kw.update(bench.MIX_ENGINE_KW.get(mix, {}))

    def generate(llm):
        return llm.generate([r.prompt for r in reqs],
                            max_new_tokens=[r.max_new_tokens for r in reqs])
    jllm = JaxLLMEngine(params, jcfg, **kw)
    jouts = generate(jllm)
    llm = LLMEngine(tp, cfg, device="cpu", **kw)
    outs = generate(llm)
    js, st = jllm.stats(), llm.stats()
    assert [o.tokens for o in outs] == [o.tokens for o in jouts]
    assert [o.finish_reason for o in outs] == ["done"] * len(reqs)
    for key in ("steps", "readbacks", "paged", "preemptions",
                "prefix_hit_tokens", "cow_copies"):
        assert st[key] == js[key], key
    assert st["paged"]
    if mix == "oversubscribed":
        assert st["preemptions"] > 0
    if mix == "shared_prefix":
        assert st["prefix_hit_tokens"] > 0


# -- the seeded init, one layer at a time -------------------------------------

def _all_at_once(cfg, seed: int) -> dict:
    """The dense init before it drew one layer at a time: every layer in
    fp32, then the embedding and the head, then one cast of the tree."""
    gen = torch.Generator().manual_seed(seed)
    d = cfg.d_model

    def normal(shape, scale):
        return transformer._trunc_normal(shape, scale, gen, "cpu")

    layers = [{"attn": transformer.attn_init(cfg, normal),
               "mlp": {"w_gateup": normal((d, 2 * cfg.d_ff), d ** -0.5),
                       "w_down": normal((cfg.d_ff, d), cfg.d_ff ** -0.5)},
               "attn_norm": torch.ones(d), "mlp_norm": torch.ones(d)}
              for _ in range(cfg.n_layers)]
    return transformer.cast_params({
        "embed": normal((cfg.padded_vocab, d), 1.0), "layers": layers,
        "final_norm": torch.ones(d),
        "lm_head": normal((d, cfg.padded_vocab), d ** -0.5)}, cfg, "cpu")


def _moe_layer_by_layer(cfg, seed: int) -> dict:
    """The MoE init as it was written before ``init_layers`` took it
    over (it already drew and cast one layer at a time)."""
    gen = torch.Generator().manual_seed(seed)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.expert_ff

    def normal(shape, scale):
        return transformer._trunc_normal(shape, scale, gen, "cpu")

    layers = [moe.cast_params({
        "attn": transformer.attn_init(cfg, normal),
        "router": normal((d, e), d ** -0.5),
        "w_gateup": normal((e, d, 2 * f), d ** -0.5),
        "w_down": normal((e, f, d), f ** -0.5),
        "attn_norm": torch.ones(d), "mlp_norm": torch.ones(d)}, cfg, "cpu")
        for _ in range(cfg.n_layers)]
    dt = cfg.torch_dtype
    return {"embed": normal((cfg.padded_vocab, d), 1.0).to(dt),
            "layers": layers, "final_norm": torch.ones(d),
            "lm_head": normal((d, cfg.padded_vocab), d ** -0.5).to(dt)}


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen3-8b", "olmoe-1b-7b"])
def test_the_layer_by_layer_init_keeps_every_bit(arch, dtype):
    cfg = dataclasses.replace(configs.smoke(arch), dtype=dtype)
    want = (_moe_layer_by_layer if cfg.family == "moe"
            else _all_at_once)(cfg, 3)
    got = registry.init_params(cfg, seed=3, device="cpu")
    want, got = dict(_flat(want)), dict(_flat(got))
    assert set(got) == set(want)
    for path, t in got.items():
        assert t.dtype == want[path].dtype, path
        assert torch.equal(t, want[path]), path
