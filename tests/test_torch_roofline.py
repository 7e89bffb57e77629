"""The dry run's model accounting and roofline (``repro_torch.configs``,
``models/registry.param_axes``, ``sharding/rules.py`` on the production
H100 meshes, ``roofline/analysis.py``, ``roofline/counter.py``) against
the JAX package, on the CPU.

* ``activated_params`` of all ten configs, ``model_flops``, ``SHAPES`` and
  ``cells_for`` equal JAX's.
* ``registry.param_axes`` equals JAX's ``init`` axes tree layer by layer
  (JAX's leading ``layers`` and ``stack`` axes taken off its stacked
  leaves) for every smoke config, and the port's ``spec_for`` of every
  leaf at full width on the ``(32, 8)`` and ``(2, 32, 8)`` meshes equals
  JAX's ``rules.spec_for`` on a mesh of the same shape.
* The ``Roofline`` terms, dominance, useful ratio and MFU at the H100's
  rates (JAX's ``test_roofline_terms_and_dominance`` re-priced), the two
  links summed, and the counter's ring factors, per-axis attribution,
  collective sites, nesting and kernel regions on small fake DTensor
  steps (each test makes its own fake world and destroys it).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.roofline import analysis as janalysis  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.roofline import analysis  # noqa: E402
from repro_torch.roofline.counter import COLL_FACTOR, Counter  # noqa: E402
from repro_torch.sharding import rules, spmd  # noqa: E402

torch.set_num_threads(1)

PRODUCTION = {(32, 8): ("data", "model"), (2, 32, 8): ("pod", "data", "model")}


class _FakeMesh:
    """Shape-only mesh stand-in for rule arithmetic."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.zeros(shape)


def _jax_axes(cfg):
    """JAX ``registry.init``'s logical-axes tree of ``cfg``, traced only."""
    box = {}

    def init(key):
        params, box["axes"] = jregistry.init(cfg, key)
        return params

    jax.eval_shape(init, jax.random.PRNGKey(0))
    return box["axes"]


def _unstack(tree, n: int):
    """JAX's stacked axes tree as the port's: ``n`` leading axes off each
    leaf (the ``layers`` axis, and the ``stack`` axis below it)."""
    if isinstance(tree, dict):
        return {k: _unstack(v, n) for k, v in tree.items()}
    return tree[n:]


def _jax_as_port(cfg, axes) -> dict:
    """JAX's axes tree in the port's layout: one entry per layer (per
    period and block), leaves without the stacking axes."""
    out = {k: axes[k] for k in ("embed", "final_norm", "lm_head")}
    if cfg.family == "hybrid":
        n_p = cfg.n_layers // 3
        n_t = cfg.n_layers - 3 * n_p
        per = axes["periods"]
        out["periods"] = [{"rec": [_unstack(per["rec"], 2)
                                   for _ in range(2)],
                           "attn": _unstack(per["attn"], 1)}
                          for _ in range(n_p)]
        out["tail"] = [_unstack(axes["tail"], 1) for _ in range(n_t)]
    elif cfg.family == "xlstm":
        per = axes["periods"]
        out["periods"] = [{"mlstm": [_unstack(per["mlstm"], 2)
                                     for _ in range(7)],
                           "slstm": _unstack(per["slstm"], 1)}
                          for _ in range(cfg.n_layers // 8)]
    elif cfg.family == "encdec":
        out["enc_layers"] = [_unstack(axes["enc_layers"], 1)
                             for _ in range(cfg.enc_layers)]
        out["dec_layers"] = [_unstack(axes["dec_layers"], 1)
                             for _ in range(cfg.n_layers)]
        out["enc_norm"] = axes["enc_norm"]
    else:
        out["layers"] = [_unstack(axes["layers"], 1)
                         for _ in range(cfg.n_layers)]
    return out


def _leaves(params, axes, path=""):
    """[(path, tensor, axes)] of a port tree and its axes tree."""
    if isinstance(params, dict):
        return [x for k in params
                for x in _leaves(params[k], axes[k], f"{path}/{k}")]
    if isinstance(params, list):
        return [x for i, (p, a) in enumerate(zip(params, axes))
                for x in _leaves(p, a, f"{path}/{i}")]
    return [(path, params, axes)]


@pytest.mark.parametrize("arch", sorted(jconfigs.ARCH_IDS))
def test_activated_params_and_model_flops_equal_jax(arch):
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    assert cfg.activated_params == jcfg.activated_params
    for kind, tokens in (("train", 256 * 4096), ("prefill", 32 * 32768),
                         ("decode", 128)):
        assert analysis.model_flops(cfg, kind, tokens) == \
            janalysis.model_flops(jcfg, kind, tokens)
    assert [s.name for s in configs.cells_for(cfg)] == \
        [s.name for s in jbase.cells_for(jcfg)]


def test_shapes_equal_jax():
    assert set(configs.SHAPES) == set(jbase.SHAPES)
    for name, spec in configs.SHAPES.items():
        assert dataclasses.astuple(spec) == \
            dataclasses.astuple(jbase.SHAPES[name])
    assert base.TRAIN_4K.global_batch == 256
    assert base.LONG_500K.seq_len == 524288


@pytest.mark.parametrize("arch", sorted(jconfigs.ARCH_IDS))
def test_param_axes_equal_jax_init_layer_by_layer(arch):
    cfg = configs.smoke(arch)
    want = _jax_as_port(cfg, _jax_axes(jconfigs.smoke(arch)))
    params = registry.init_params(cfg, device="cpu")
    got = registry.param_axes(cfg)
    assert got == want
    for path, t, ax in _leaves(params, got):
        assert len(ax) == t.ndim, (path, ax, tuple(t.shape))


@pytest.mark.parametrize("arch", sorted(jconfigs.ARCH_IDS))
def test_spec_for_on_production_meshes_equals_jax(arch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = configs.get(arch)
    jaxes = _jax_as_port(cfg, _jax_axes(jconfigs.get(arch)))
    with FakeTensorMode():
        params = registry.init_params(cfg, device="cpu")
    leaves = _leaves(params, registry.param_axes(cfg))
    jleaves = _leaves(params, jaxes)
    for shape, names in PRODUCTION.items():
        mesh = _FakeMesh(shape, names)
        for (path, t, ax), (_, _, jax_ax) in zip(leaves, jleaves):
            got = rules.spec_for(ax, tuple(t.shape), mesh)
            assert got == tuple(jrules.spec_for(jax_ax, tuple(t.shape),
                                                mesh)), (path, shape)


def test_roofline_terms_and_dominance_at_h100_rates():
    r = analysis.Roofline(
        arch="x", shape="train_4k", mesh="32x8", chips=256,
        flops_per_chip=989e12 * 0.010,          # 10 ms of compute
        bytes_per_chip=3.35e12 * 0.002,         # 2 ms of HBM
        coll_bytes_per_chip=450e9 * 0.012 + 50e9 * 0.008,
        coll_breakdown={("all-gather", "model"): 450e9 * 0.012,
                        ("all-reduce", "data"): 50e9 * 0.008},
        model_flops_global=989e12 * 0.010 * 256 * 0.5,
        peak_memory_per_chip=8 * 2**30)
    assert r.compute_s == pytest.approx(0.010)
    assert r.memory_s == pytest.approx(0.002)
    # NVLink time plus network time: 12 + 8 ms
    assert r.collective_s == pytest.approx(0.020)
    assert r.dominant == "collective"
    assert r.step_time_s == pytest.approx(0.020)
    assert r.useful_ratio == pytest.approx(0.5)
    assert r.mfu == pytest.approx(0.010 * 0.5 / 0.020)
    row = r.row()
    assert row["coll_breakdown_mb"] == {
        "all-gather@model": pytest.approx(450e9 * 0.012 / 2**20),
        "all-reduce@data": pytest.approx(50e9 * 0.008 / 2**20)}
    assert row["hbm_gb_per_chip"] == 8
    # no TPU constant is left: the H100 data sheet's rates
    assert (analysis.PEAK_FLOPS_BF16, analysis.HBM_BW, analysis.NVLINK_BW,
            analysis.NET_BW) == (989e12, 3.35e12, 450e9, 50e9)
    assert analysis.LINK_BW["pod"] == analysis.LINK_BW["data"] == 50e9


def test_kernel_traffic_is_jax_for_the_attention():
    for arch in ("qwen3-8b", "seamless-m4t-large-v2", "olmoe-1b-7b"):
        for spec in configs.cells_for(configs.get(arch)):
            jspec = jbase.SHAPES[spec.name]
            assert analysis.kernel_traffic(configs.get(arch), spec, 256) == \
                pytest.approx(janalysis.kernel_traffic(
                    jconfigs.get(arch), jspec, 256))


def test_ring_factors_and_axes_of_collectives():
    """An all-gather's, an all-reduce's (2x) and a reduce-scatter's output
    payload, each under the mesh axis of its group; a collective over a
    one-rank axis moves nothing."""
    import torch.distributed._functional_collectives as funcol
    assert COLL_FACTOR == {"all-reduce": 2.0, "all-gather": 1.0,
                           "reduce-scatter": 1.0, "all-to-all": 1.0,
                           "broadcast": 1.0}
    with dryrun.fake_world(8):
        mesh = dryrun.make_mesh((1, 2, 4))
        c = Counter(mesh)
        x = torch.zeros(16, 8)                  # 512 B
        with c:
            funcol.all_gather_tensor(x, 0, mesh.get_group("model")).wait()
            funcol.all_reduce(x, "sum", mesh.get_group("data")).wait()
            funcol.reduce_scatter_tensor(x, "sum", 0,
                                         mesh.get_group("model")).wait()
            funcol.all_reduce(x, "sum", mesh.get_group("pod")).wait()
        assert dict(c.coll) == {("all-gather", "model"): 4 * 512.0,
                                ("all-reduce", "data"): 2 * 512.0,
                                ("reduce-scatter", "model"): 512 / 4}
        assert c.coll_bytes == 4 * 512 + 2 * 512 + 128


def test_counter_sees_local_shards_not_global_shapes():
    """A DTensor product is counted at rank 0's local shapes, once; the
    sharding propagation's global-shape run is not counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    with dryrun.fake_world(8):
        mesh = dryrun.make_mesh((2, 4))
        c = Counter(mesh)
        with FakeTensorMode():
            a = distribute_tensor(torch.empty(64, 32), mesh,
                                  [Shard(0), Replicate()])
            w = distribute_tensor(torch.empty(32, 128), mesh,
                                  [Replicate(), Shard(1)])
            with c:
                y = torch.nn.functional.silu(a @ w)
        assert y.to_local().shape == (32, 32)
        assert c.matmul_flops == 2 * 32 * 32 * 32
        # silu on the local [32, 32] (9 a element), nothing global
        assert c.flops == 2 * 32 * 32 * 32 + 9 * 32 * 32
        assert c.bytes == (32 * 32 + 32 * 32 + 32 * 32) * 4 \
            + 2 * 32 * 32 * 4
        assert not c.coll


def test_a_kernel_is_charged_its_registered_cost():
    """``ops.fused_add_rmsnorm`` on fake DTensors: the rows gathered to
    whole rows, the kernel charged its registered cost at the local
    shapes and none of its plain version's ops, its output live."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.kernels import ops
    from repro_torch.kernels.registry import get_space
    with dryrun.fake_world(4):
        mesh = dryrun.make_mesh((2, 2))
        c = Counter(mesh)
        with FakeTensorMode():
            x = distribute_tensor(torch.empty(64, 256, dtype=torch.bfloat16),
                                  mesh, [Shard(0), Shard(1)])
            r = distribute_tensor(torch.empty(64, 256, dtype=torch.bfloat16),
                                  mesh, [Shard(0), Replicate()])
            w = distribute_tensor(torch.ones(256), mesh,
                                  [Replicate(), Replicate()])
            c.hold((x, r, w))
            with c:
                y, res = ops.fused_add_rmsnorm(x, r, w)
            gather = Counter(mesh)
            with gather:
                x.redistribute(mesh, [Shard(0), Replicate()])
        assert y.shape == (64, 256) and y.to_local().shape == (32, 256)
        cost = get_space("fused_add_rmsnorm").cost(
            ops.get_variant("fused_add_rmsnorm"), rows=32, d=256,
            dtype=torch.bfloat16)
        calls, nbytes, flops = c.kernels["fused_add_rmsnorm"]
        assert (calls, nbytes) == (1, cost.total("dram_bytes"))
        assert flops == cost.total("alu_ops") + cost.total("sfu_ops")
        # x gathered whole along the model axis (an all-gather of its
        # [32, 256] rows and the copy that puts the pieces in order), and
        # nothing of the plain version counted
        assert dict(c.coll) == {("all-gather", "model"): 32 * 256 * 2.0}
        assert gather.bytes > 32 * 256 * 2
        assert c.bytes == nbytes + gather.bytes
        assert c.peak >= c.live > 0


def test_collective_sites_name_the_op_and_the_line():
    """Every collective byte is also filed under its site: the DTensor op
    whose redistribution issued it, at the line of the port's model code
    that ran the op (here ``layers.rms_norm`` on a row split over
    ``model``, whose mean over the split dimension needs a sum)."""
    import inspect
    import re
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.models import layers
    lines, first = inspect.getsourcelines(layers.rms_norm)
    with dryrun.fake_world(8):
        mesh = dryrun.make_mesh((2, 4))
        c = Counter(mesh)
        with FakeTensorMode():
            x = distribute_tensor(torch.empty(16, 64), mesh,
                                  [Shard(0), Shard(1)])
            w = distribute_tensor(torch.ones(64), mesh,
                                  [Replicate(), Shard(0)])
            with c:
                layers.rms_norm(x, w)
        assert c.coll_bytes > 0
        assert sum(c.sites.values()) == pytest.approx(c.coll_bytes)
        for kind, axis, label in c.sites:
            assert (kind, axis) in c.coll
            m = re.fullmatch(r"(\w+) at models/layers\.py:(\d+)", label)
            assert m, label
            assert first <= int(m.group(2)) < first + len(lines), label


def test_nested_counters_each_skip_the_propagation():
    """A counter inside another: each counts rank 0's local ops only, the
    outer one still skips the sharding propagation's global-shape runs
    after the inner one has left, and nothing of theirs stays on the
    propagator."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    name = "_propagate_tensor_meta_non_cached"
    prop = DTensor._op_dispatcher.sharding_propagator
    with dryrun.fake_world(8):
        mesh = dryrun.make_mesh((2, 4))
        outer, inner = Counter(mesh), Counter(mesh)
        with FakeTensorMode():
            a = distribute_tensor(torch.empty(64, 32), mesh,
                                  [Shard(0), Replicate()])
            w1 = distribute_tensor(torch.empty(32, 128), mesh,
                                   [Replicate(), Shard(1)])
            w2 = distribute_tensor(torch.empty(32, 256), mesh,
                                   [Replicate(), Shard(1)])
            with outer:
                with inner:
                    torch.nn.functional.silu(a @ w1)
                assert name in vars(prop)
                torch.nn.functional.silu(a @ w2)
        assert name not in vars(prop)
    one = 2 * 32 * 32 * 32 + 9 * 32 * 32            # local [32, 32]
    two = 2 * 32 * 32 * 64 + 9 * 32 * 64            # local [32, 64]
    assert inner.flops == one
    assert outer.flops == one + two


def _totals(k: int, m: int):
    """A section of 6 FLOPs a layer and a microbatch, 2 a layer, 3 a
    microbatch and 10 once; an all-reduce on ``model`` of 2 B a layer."""
    from repro_torch.roofline.counter import Totals
    flops = 10 + 2 * k + 3 * m + 6 * k * m
    return Totals(float(flops), float(k * m), 100.0 + 30 * k * m,
                  {("all-reduce", "model"): 2.0 * k,
                   ("all-gather", "data"): 8.0},
                  {"silu_and_mul": (1.0 * k * m, 5.0 * k * m, 2.0 * k)},
                  50 + 10 * k)


def test_trip_count_rule():
    from repro_torch.roofline.counter import trip_counts
    traced = {(k, m): _totals(k, m) for k in (1, 2) for m in (1, 2)}
    got = trip_counts(traced, 24, 8)
    want = _totals(24, 8)
    assert (got.flops, got.matmul_flops, got.bytes, got.peak) == \
        (want.flops, want.matmul_flops, want.bytes, want.peak)
    assert got.coll == want.coll and got.kernels == want.kernels
    # one count traced at its full value is taken as it is
    traced = {(24, m): _totals(24, m) for m in (1, 2)}
    assert trip_counts(traced, 24, 8).flops == want.flops
    assert trip_counts({(3, 1): _totals(3, 1)}, 3, 1).flops == \
        _totals(3, 1).flops


def test_spmd_helpers_are_the_identity_on_plain_tensors():
    x = torch.randn(4, 6, 8)
    assert spmd.shard_batch(x) is x
    assert spmd.gather_over(x, ("data",)) is x
    assert spmd.like(x, x) is x
    assert torch.equal(spmd.unflatten(x, -1, (2, 4)), x.unflatten(-1, (2, 4)))
    assert torch.equal(spmd.flatten(x, 1), x.flatten(1, 2))
    assert not spmd.distributed(x, None)
    with spmd.kernel("silu_and_mul", None, rows=1, d=1,
                     dtype=torch.float32) as shapes_only:
        assert shapes_only is False
