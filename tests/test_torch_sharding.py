"""Tensor-parallel serving of the port (``repro_torch.sharding``,
``launch/mesh.py``, ``launch/sharded_check.py``, ``serve --tp``) against the
JAX package, on the CPU.

* The rules: ``_resolve`` and ``spec_for`` give JAX's entries leaf for leaf
  over every config's logical-axes tree (JAX ``registry.init`` under
  ``jax.eval_shape``, full width) on shape-only meshes ``(16, 16)``,
  ``(2, 16, 16)``, ``(2, 2)`` and ``(1, 4)``; ``sharding_for`` /
  ``tree_shardings`` place ``Shard(i)`` where the spec names a mesh axis;
  ``batch_spec`` equals JAX's.
* The plan: ``gateup_permutation`` equals JAX's; ``make_plan`` gives JAX's
  dicts (qwen3-8b smoke on ``(2, 2)`` all true, qwen2-0.5b smoke on
  ``(1, 4)`` heads false, MLP and vocab true, batch false) and its
  dense-only error; with no plan every hook is the identity, and a hook
  under a plan with no process group raises.
* ``sharded_check --device cpu`` on gloo ranks: all five scenarios pass on
  qwen3-8b ``(2, 2)`` and qwen2-0.5b ``(1, 4)`` in fp32, tokens and every
  counter equal to the single-rank engine's, ``preemptions > 0``,
  ``prefix_hit_tokens > 0``, ``recoveries == 1``, ``readbacks == steps``,
  every rank alike, and the logits equal (largest difference 0).
* ``serve --tp 2`` on 4 gloo ranks prints JAX's ``mesh:`` line and the
  single-rank serve's steps, readbacks, buckets, outcomes and launches.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro.sharding import tp as jtp  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.sharding import rules, tp  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model"),
          (2, 2): ("data", "model"), (1, 4): ("data", "model")}


class _FakeMesh:
    """Shape-only mesh stand-in for rule arithmetic (JAX's tests' own)."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.zeros(shape)
        self.shape = dict(zip(names, shape))


def _axes_and_shapes(arch):
    """(shapes tree, logical-axes tree) of JAX ``registry.init`` at full
    width, traced only."""
    box = {}
    cfg = jconfigs.get(arch)

    def init(key):
        params, axes = jregistry.init(cfg, key)
        box["axes"] = axes
        return params

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    return shapes, box["axes"]


def _run(args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m"] + args, cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"
    return proc.stdout


@pytest.mark.parametrize("arch", sorted(jconfigs.ARCH_IDS))
def test_rules_equal_jax_on_every_leaf(arch):
    shapes, axes = _axes_and_shapes(arch)
    flat, treedef = jax.tree.flatten(shapes)
    flat_axes = treedef.flatten_up_to(axes)
    for shape, names in MESHES.items():
        mesh = _FakeMesh(shape, names)
        for leaf, ax in zip(flat, flat_axes):
            want = tuple(jrules.spec_for(ax, leaf.shape, mesh))
            assert rules.spec_for(ax, leaf.shape, mesh) == want, \
                (arch, shape, ax, leaf.shape)
            for logical, dim in zip(ax, leaf.shape):
                assert rules._resolve(logical, dim, mesh) == \
                    jrules._resolve(logical, dim, mesh)
        placed = rules.tree_shardings(shapes, axes, mesh)
        for leaf, ax, pl in zip(flat, flat_axes,
                                treedef.flatten_up_to(placed)):
            spec = rules.spec_for(ax, leaf.shape, mesh)
            for name, p in zip(names, pl):
                dims = [i for i, r in enumerate(spec)
                        if r == name or (isinstance(r, tuple)
                                         and name in r)]
                assert (p.is_shard(dims[0]) if dims else p.is_replicate())
        assert rules.batch_spec(mesh, None) == \
            tuple(jrules.batch_spec(mesh, None))


def test_gateup_permutation_equals_jax():
    for d_ff, model in ((256, 2), (256, 4), (12288, 2), (12288, 4),
                        (4864, 4), (128, 1)):
        np.testing.assert_array_equal(tp.gateup_permutation(d_ff, model),
                                      jtp.gateup_permutation(d_ff, model))


def test_make_plan_equals_jax():
    cases = (("qwen3-8b", (2, 2), {"data": 2, "model": 2, "heads_tp": True,
                                   "mlp_tp": True, "vocab_tp": True,
                                   "batch_dp": True}),
             ("qwen2-0.5b", (1, 4), {"data": 1, "model": 4,
                                     "heads_tp": False, "mlp_tp": True,
                                     "vocab_tp": True, "batch_dp": False}))
    for arch, shape, want in cases:
        mesh = _FakeMesh(shape, ("data", "model"))
        got = tp.make_plan(configs.smoke(arch), mesh, slots=4).describe()
        assert got == want
        assert got == jtp.make_plan(jconfigs.smoke(arch), mesh,
                                    slots=4).describe()
    # every full-width config on both meshes and on one rank
    for arch in jconfigs.ARCH_IDS:
        if jconfigs.get(arch).family != "dense":
            with pytest.raises(ValueError, match="dense family only"):
                tp.make_plan(configs.get(arch), _FakeMesh((1, 1), (
                    "data", "model")), slots=8)
            continue
        for shape in ((2, 2), (1, 4), (1, 1), (8, 1)):
            mesh = _FakeMesh(shape, ("data", "model"))
            assert tp.make_plan(configs.get(arch), mesh, 8).describe() == \
                jtp.make_plan(jconfigs.get(arch), mesh, 8).describe()


def test_hooks_are_the_identity_without_a_plan_and_raise_without_a_group():
    x = torch.arange(24.0).reshape(2, 1, 3, 4)
    for hook in (tp.gather_heads, tp.gather_mlp, tp.gather_vocab,
                 tp.gather_data, tp.data_shard):
        assert hook(x) is x
    assert tp.current() is None
    plan = tp.make_plan(configs.smoke("qwen3-8b"),
                        _FakeMesh((2, 2), ("data", "model")), slots=4)
    with tp.active(plan):
        assert tp.current() is plan
        with pytest.raises(RuntimeError, match="no process group"):
            tp.gather_vocab(x)
    assert tp.current() is None


@pytest.mark.parametrize("arch,mesh", [("qwen3-8b", "2,2"),
                                       ("qwen2-0.5b", "1,4")])
def test_sharded_check_on_gloo(arch, mesh):
    report = json.loads(_run(["repro_torch.launch.sharded_check",
                              "--device", "cpu", "--arch", arch,
                              "--mesh", mesh, "--json"]))
    assert report["ok"], report
    assert report["dtype"] == "float32" and report["world"] == 4
    assert report["plan"] == tp.make_plan(
        configs.smoke(arch), _FakeMesh(tuple(map(int, mesh.split(","))),
                                       ("data", "model")), 4).describe()
    sc = report["scenarios"]
    assert set(sc) == {"greedy", "sampling", "preempt", "prefix", "chaos"}
    for name, r in sc.items():
        assert r["ok"] and r["streams_match"], (name, r["notes"])
        assert r["counters"]["readbacks"] == r["counters"]["steps"]
    assert sc["preempt"]["counters"]["preemptions"] > 0
    assert sc["prefix"]["counters"]["prefix_hit_tokens"] > 0
    assert sc["chaos"]["counters"]["recoveries"] == 1
    assert report["max_logit_diff"] == 0.0


def test_serve_tp_on_four_gloo_ranks():
    args = ["repro_torch.launch.serve", "--smoke", "--device", "cpu",
            "--arch", "qwen3-8b", "--requests", "6", "--slots", "4",
            "--max-new", "8", "--min-prompt", "4", "--max-prompt", "40"]
    lines = _run(args + ["--tp", "2", "--nproc", "4"]).strip().splitlines()
    sharded = json.loads(lines[-1])
    single = json.loads(_run(args).strip().splitlines()[-1])
    assert lines[-2] == (
        "mesh: data=2 x model=2 (heads_tp, mlp_tp, vocab_tp, batch_dp), "
        f"{sharded['readbacks']} readbacks in {sharded['steps']} steps")
    assert sharded["mesh"]["model"] == 2
    for key in ("steps", "readbacks", "prefill_buckets", "reasons", "hits",
                "launches", "prefills", "all_done", "prompt_lens"):
        assert sharded[key] == single[key], key
    assert sharded["all_done"] and sharded["steps"] == sharded["readbacks"]
