"""The dry run (``repro_torch.launch.dryrun``: the port's real step
functions on fake DTensors in a fake world) against the JAX package, on
the CPU.

* ``trace_cell`` on one smoke config of every family (dense, MoE, hybrid,
  xLSTM, encoder-decoder), for every kind ``cells_for`` lists, at small
  shapes on a fake ``(2, 2)`` world: every row is ``ok`` and moves bytes
  over the collectives (the ``(2, 2, 2)`` world is in
  ``test_torch_dryrun_pods.py``). Each test makes its own fake process
  group and destroys it, pass or fail, so nothing is left for the next
  test file in the same worker.
* One dense layer's FSDP all-gather (the train step's compute copy
  gathered along the batch axes) is counted at its hand count, the sum
  of the microbatches' gradients moves nothing, and the trip-count rule
  (one and two layers, one and two microbatches) gives the full trace's
  counts.
* World 1: qwen2-0.5b's smoke config through the port's ``trace_cell`` on
  a ``(1, 1)`` mesh and through JAX's own ``lower_cell`` on a ``(1, 1)``
  ``jax.make_mesh`` (Auto axes), at the same small ``ShapeSpec``, prefill
  and decode:
  ``model_flops_global`` exactly, and the matrix-product FLOPs within
  1e-6 (relative) once the decode attention's products are set beside
  each other: JAX's interpreted Pallas kernel lowers them to dots over
  every 128-row chunk of the cache, where the port charges the kernel its
  registered cost and counts no product for it; the test adds them, 4 b
  hq s dh a layer, to the port's count.
"""

import math
import os

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.roofline import hlo_parser  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.roofline.counter import Counter  # noqa: E402
from repro_torch.sharding import rules, spmd  # noqa: E402

torch.set_num_threads(1)

FAMILIES = ("qwen2-0.5b", "olmoe-1b-7b", "recurrentgemma-2b", "xlstm-1.3b",
            "seamless-m4t-large-v2")


def small(spec: ShapeSpec) -> ShapeSpec:
    """``spec`` at a smoke size: 4 rows of 32 tokens (train, prefill), 4
    slots of 64 rows (decode), 1 slot of 128 rows (``long_500k``)."""
    if spec.name == "long_500k":
        return ShapeSpec(spec.name, 128, 1, spec.kind)
    return ShapeSpec(spec.name, 64 if spec.kind == "decode" else 32, 4,
                     spec.kind)


def trace_family(arch: str, mesh_shape: tuple) -> list:
    """Every cell of ``arch``'s smoke config at ``small`` shapes on a fake
    world of ``mesh_shape``, one microbatch a train step."""
    cfg = configs.smoke(arch)
    rows = []
    for spec in configs.cells_for(cfg):
        with dryrun.fake_world(math.prod(mesh_shape)):
            mesh = dryrun.make_mesh(mesh_shape)
            roof, extra = dryrun.trace_cell(cfg, small(spec), mesh,
                                            microbatches=1)
        rows.append((spec.name, roof, extra))
    return rows


def check_rows(arch: str, rows: list, mesh_shape: tuple) -> None:
    cfg = configs.smoke(arch)
    assert [r[0] for r in rows] == [s.name for s in configs.cells_for(cfg)]
    for name, roof, extra in rows:
        row = roof.row()
        assert row["chips"] == math.prod(mesh_shape)
        assert roof.coll_bytes_per_chip > 0, (arch, name)
        assert roof.flops_per_chip > 0 and roof.bytes_per_chip > 0
        assert roof.peak_memory_per_chip > 0
        assert row["dominant"] in ("compute", "memory", "collective")
        assert row["step_ms"] == max(row["compute_ms"], row["memory_ms"],
                                     row["collective_ms"])
        if arch != "xlstm-1.3b":            # the xLSTM runs no kernel
            assert extra["kernels"], (arch, name)
        if name == "train_4k":
            assert extra["microbatches"] == 1


@pytest.mark.parametrize("arch", FAMILIES)
def test_trace_cell_on_a_2x2_world(arch):
    check_rows(arch, trace_family(arch, (2, 2)), (2, 2))


def test_fake_world_is_destroyed_when_a_trace_fails():
    import torch.distributed as dist
    with pytest.raises(ValueError):
        with dryrun.fake_world(4):
            dryrun.make_mesh((2, 2))
            raise ValueError("a failing cell")
    assert not dist.is_initialized()


def test_run_cell_rows(tmp_path):
    """A skipped cell carries JAX's reason; a failing one is a FAIL row
    with its error and trace, never an ``ok``."""
    row = dryrun.run_cell("qwen3-8b", "long_500k", "single", tmp_path,
                          verbose=False)
    assert row["status"] == "skipped"
    assert row["reason"] == ("pure full attention; long_500k needs "
                             "sub-quadratic mixer (DESIGN.md)")
    assert (tmp_path / "qwen3-8b_long_500k_single.json").exists()
    bad = dryrun.run_cell("qwen2-0.5b", "decode_32k", "0,2", None,
                          verbose=False)
    assert bad["status"] == "FAIL" and bad["error"] and bad["trace"]


def _axes_leaves(axes) -> list:
    """The leaves (tuples of axis names) of an axes tree, in the order
    ``training.tree.leaves`` walks the parameters."""
    if isinstance(axes, dict):
        return [a for v in axes.values() for a in _axes_leaves(v)]
    if isinstance(axes, list):
        return [a for v in axes for a in _axes_leaves(v)]
    return [axes]


def test_one_dense_layer_all_gather_is_its_hand_count():
    """The train step's compute copy of one qwen2-0.5b smoke layer,
    gathered along ``data`` on a fake ``(2, 2)`` world: the all-gather
    payload is the bf16 bytes of every leaf the rules split over
    ``data`` at its gathered (model-shard) size."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.training import tree as T
    cfg = configs.smoke("qwen2-0.5b")
    with dryrun.fake_world(4):
        mesh = dryrun.make_mesh((2, 2))
        c = Counter(mesh)
        with FakeTensorMode():
            masters = registry.init_master_params(cfg, device="cpu")
            layer = masters["layers"][0]
            axes = registry.param_axes(cfg)["layers"][0]
            placed = dryrun._place(layer, axes, mesh)
            want = 0
            for t, ax in zip(T.leaves(layer), _axes_leaves(axes)):
                spec = rules.spec_for(ax, tuple(t.shape), mesh)
                if "data" in spec:
                    item = 2 if t.ndim >= 2 else 4      # the bf16 copy
                    model = [d for d, r in enumerate(spec) if r == "model"]
                    numel = t.numel() // (2 if model else 1)
                    want += numel * item
            with c:
                for t in T.leaves(placed):
                    p = t.to(torch.bfloat16) if t.ndim >= 2 else t
                    spmd.gather_over(p, ("data",))
        assert want > 0
        assert dict(c.coll) == {("all-gather", "data"): float(want)}


def test_gradient_accumulation_moves_nothing():
    """``spmd.accumulate`` (the train step's sum over microbatches): on
    plain tensors ``torch._foreach_add_``; on DTensors of one placement,
    partial sums over the batch axis among them, the local shards are
    added in place and no collective runs."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    a, b = [torch.ones(4, 2), torch.zeros(3)], [torch.full((4, 2), 2.0),
                                                torch.ones(3)]
    spmd.accumulate(a, b)
    assert torch.equal(a[0], torch.full((4, 2), 3.0))
    assert torch.equal(a[1], torch.ones(3))
    with dryrun.fake_world(4):
        mesh = dryrun.make_mesh((2, 2))
        pls = ([Partial(), Shard(1)], [Partial(), Replicate()])
        sums = [DTensor.from_local(torch.ones(4, 2), mesh, pl)
                for pl in pls]
        terms = [DTensor.from_local(torch.full((4, 2), 2.0), mesh, pl)
                 for pl in pls]
        c = Counter(mesh)
        with c:
            spmd.accumulate(sums, terms)
        assert not c.coll
        for s_, pl in zip(sums, pls):
            assert tuple(s_.placements) == tuple(pl)
            assert torch.equal(s_.to_local(), torch.full((4, 2), 3.0))


@pytest.mark.parametrize("kind", ("train", "decode"))
def test_trip_count_rule_equals_the_full_trace(kind):
    """A three-layer qwen2 smoke config on a fake ``(2, 2)`` world: the
    FLOPs, bytes and collectives extrapolated from one and two layers
    (and, training, one and two microbatches of four) equal the trace of
    every layer; the peak is within 5%."""
    import dataclasses
    cfg = dataclasses.replace(configs.smoke("qwen2-0.5b"), n_layers=3)
    spec = ShapeSpec(kind, 32 if kind == "train" else 64, 8, kind)
    with dryrun.fake_world(4):
        mesh = dryrun.make_mesh((2, 2))
        rows = [dryrun.trace_cell(cfg, spec, mesh, microbatches=2,
                                  full_depth=full) for full in (False, True)]
    (short, extra), (full, _) = rows
    assert extra["traced_depth_units"] == [1, 2]
    assert extra.get("traced_microbatches", [1, 2]) == [1, 2]
    for field in ("flops_per_chip", "matmul_flops_per_chip",
                  "bytes_per_chip"):
        assert getattr(short, field) == pytest.approx(getattr(full, field),
                                                      rel=1e-9), field
    # the peak is a maximum over the step, linear in the counts only while
    # one phase of the step holds it: at this toy width the optimizer's
    # temporaries and the backward's take turns (within 5%); at full
    # width it is exact (qwen2-0.5b train_4k on (32, 8) and decode_32k on
    # (1, 1), 11.2387 and 49.2121 GiB both ways)
    assert short.peak_memory_per_chip == pytest.approx(
        full.peak_memory_per_chip, rel=0.05)
    assert set(short.coll_breakdown) == set(full.coll_breakdown)
    for key, v in full.coll_breakdown.items():
        assert short.coll_breakdown[key] == pytest.approx(v, rel=1e-9)


# --------------------------------------------------------------------------
# world 1 against JAX's own lower_cell
# --------------------------------------------------------------------------

def _jax_dryrun():
    """JAX's ``launch/dryrun.py`` without its module-level XLA flag (512
    forced host devices), which would reach every later subprocess of this
    worker: the backend is started first, so the flag cannot act here
    either, and the environment is put back."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jdryrun


class _DotFlops(hlo_parser.Module):
    """JAX's trip-count-aware HLO walk counting dot FLOPs alone."""

    def _op_cost(self, comp, op):
        flops = self._dot_flops(comp, op) if op.opcode == "dot" else 0.0
        return {"flops": flops, "traffic": 0.0, "coll": {}}


@pytest.mark.parametrize("kind", ("prefill", "decode"))
def test_world_1_matches_jax_lower_cell(kind):
    jdryrun = _jax_dryrun()
    arch = "qwen2-0.5b"
    cfg, jcfg = configs.smoke(arch), jconfigs.smoke(arch)
    spec = ShapeSpec(f"{kind}_small", 64, 4, kind)
    jspec = jbase.ShapeSpec(spec.name, spec.seq_len, spec.global_batch,
                            spec.kind)
    # Auto axes: JAX's model code constrains activations on its mesh
    auto = (jax.sharding.AxisType.Auto,) * 2
    jroof, compiled = jdryrun.lower_cell(
        jcfg, jspec, jax.make_mesh((1, 1), ("data", "model"),
                                   axis_types=auto))
    jdots = _DotFlops(compiled.as_text()).entry_cost()["flops"]
    with dryrun.fake_world(1):
        roof, extra = dryrun.trace_cell(cfg, spec, dryrun.make_mesh((1, 1)))
    assert roof.model_flops_global == jroof.model_flops_global
    assert roof.chips == 1 and not roof.coll_breakdown
    attention = 0.0
    if kind == "decode":
        assert extra["kernels"]["flash_decode"]["calls"] == cfg.n_layers
        attention = cfg.n_layers * 4 * spec.global_batch * spec.seq_len \
            * cfg.n_heads * cfg.head_dim
    assert roof.matmul_flops_per_chip + attention == \
        pytest.approx(jdots, rel=1e-6)
