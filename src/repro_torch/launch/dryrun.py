"""Dry run: trace every (arch x shape) cell on the production H100 meshes
as rank 0 of a fake world, and price it with the roofline (the JAX
package's ``launch/dryrun.py``, redesigned for PyTorch).

JAX lowers and compiles the real step on 512 placeholder host devices and
reads XLA's per-device program. Here rank 0 of a 256- or 512-card world
runs the port's real step function on this host's CPU with nothing
allocated and nothing sent:

* a fake process group (``torch.testing._internal.distributed.fake_pg``)
  of the mesh's size gives a real ``DeviceMesh``
  (``launch/mesh.py::make_production_mesh``) whose collectives return at
  once;
* fake tensors (``FakeTensorMode``) carry shapes, dtypes and strides but
  no data;
* the parameters, the cache, the prompt and the batch are DTensors placed
  by ``sharding/rules.py::sharding_for`` from their logical axes
  (``registry.param_axes``, ``cache_spec``, ``prompt_spec``,
  ``batch_spec``): the counterpart of ``jax.jit(in_shardings=)``. DTensor's
  sharding propagation places the rest, as GSPMD does; the kernels and
  JAX's kernel regions run on the local shards (``sharding/spmd.py``).

``roofline/counter.py`` counts what rank 0 runs; ``roofline/analysis.py``
prices it at the H100's published rates. A train cell runs
``training.train_step.make_train_step`` (AdamW, gradients accumulated over
``MICROBATCHES`` split along the batch axes), a prefill cell
``registry.prefill``, a decode cell ``registry.decode_step`` on
``cache_spec``'s cache. A cell is traced at one and two of the model's
depth units (layers, or periods) and, for a train step, at one and two
microbatches;
the counts at its full depth and microbatch count follow by JAX's
trip-count rule (every layer and every microbatch runs the same ops),
and the row records what was traced.

Usage (any host: the trace allocates nothing):
    python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k \
        --mesh single
    python -m repro_torch.launch.dryrun --all --mesh both --jobs 8
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec, cells_for
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import registry
from repro_torch.roofline import analysis
from repro_torch.roofline.counter import Counter, trip_counts
from repro_torch.sharding import rules
from repro_torch.training import train_step as ts

MICROBATCHES = {"train_4k": 8}
OUT = os.path.join("build", "dryrun")


@contextlib.contextmanager
def fake_world(size: int):
    """The default process group as rank 0 of a fake world of ``size``
    ranks (no process, no traffic), destroyed on the way out whatever
    happens inside."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a default process group already exists")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_mesh(shape: tuple):
    """A CPU ``DeviceMesh`` of ``shape`` over the default group, its axes
    named as the production meshes' (``pod``, ``data``, ``model``, the
    last ones)."""
    from torch.distributed.device_mesh import init_device_mesh
    names = ("pod", "data", "model")[-len(shape):]
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=names)


def _place(tree, axes, mesh):
    """DTensors of ``tree``'s fake leaves, placed by the rules (whole
    along a one-card mesh axis, which splits nothing)."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    if isinstance(tree, dict):
        return {k: _place(v, axes[k], mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_place(v, a, mesh) for v, a in zip(tree, axes)]
    placements = [p if mesh.size(m) > 1 else Replicate() for m, p in
                  enumerate(rules.sharding_for(axes, tuple(tree.shape),
                                               mesh))]
    return distribute_tensor(tree, mesh, placements)


def _inputs(spec_tree, axes, mesh):
    """Fake zero DTensors of ``{name: (shape, dtype)}``, placed."""
    return {k: _place(torch.zeros(shape, dtype=dt), axes[k], mesh)
            for k, (shape, dt) in spec_tree.items()}


def batch_shards(mesh, batch: int) -> int:
    """Shards the rules split a batch of ``batch`` rows into."""
    from torch.distributed.tensor import Shard
    pl = rules.sharding_for(("batch",), (batch,), mesh)
    return math.prod(mesh.size(m) for m, p in enumerate(pl)
                     if isinstance(p, Shard))


def microbatches_for(spec: ShapeSpec, mesh, microbatches=None) -> int:
    """The train cell's microbatch count: ``MICROBATCHES`` (or the given
    count), at most the rows of one batch shard, since each microbatch
    keeps a share of every shard's rows (``TrainConfig.batch_axes``)."""
    m = microbatches or MICROBATCHES.get(spec.name, 1)
    rows = spec.global_batch // batch_shards(mesh, spec.global_batch)
    return max(1, min(m, rows))


def _trace(cfg: ModelConfig, spec: ShapeSpec, mesh, batch: int,
           microbatches: int = 1):
    """Run the cell's step once under a counter; its ``Totals``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    counter = Counter(mesh)
    with FakeTensorMode(allow_non_fake_inputs=True), implicit_replication():
        train = spec.kind == "train"
        params = (registry.init_master_params if train
                  else registry.init_params)(cfg, device="cpu")
        params = _place(params, registry.param_axes(cfg), mesh)
        if train:
            axes = tuple(n for n in ("pod", "data")
                         if n in mesh.mesh_dim_names)
            tcfg = ts.TrainConfig(microbatches=microbatches,
                                  batch_axes=axes)
            step = ts.make_train_step(cfg, tcfg)
            state = ts.init_state(cfg, tcfg, params)
            # the step counter is read on the host (AdamW's bias
            # corrections): a real scalar, which fake tensors carry as a
            # constant
            state["opt"] = state["opt"]._replace(
                step=torch.tensor(0, dtype=torch.int32))
            b_spec, b_axes = registry.batch_spec(cfg, batch, spec.seq_len)
            data = _inputs(b_spec, b_axes, mesh)
            counter.hold((params, state, data))
            with counter:
                step(params, state, data)
        elif spec.kind == "prefill":
            (shape, dt), ax = registry.prompt_spec(cfg, batch, spec.seq_len)
            prompt = _inputs({"p": (shape, dt)}, {"p": ax}, mesh)["p"]
            counter.hold((params, prompt))
            with torch.no_grad(), counter:
                registry.prefill(params, cfg, prompt)
        else:
            c_shapes, c_axes = registry.cache_spec(cfg, batch, spec.seq_len)
            cache = _inputs(c_shapes, c_axes, mesh)
            tok = _inputs({"t": ((batch,), torch.int32)},
                          {"t": ("batch",)}, mesh)["t"]
            counter.hold((params, cache, tok))
            with torch.no_grad(), counter:
                registry.decode_step(params, cfg, cache, tok, tok)
    return counter.totals()


def depth_units(cfg: ModelConfig):
    """(the repeating units of ``cfg``'s depth, ``cfg`` at ``k`` units):
    layers, or the hybrid's periods of three (its tail kept), the xLSTM's
    periods of eight, the encoder-decoder's (encoder, decoder) layer
    pairs. JAX scans over these."""
    rep = dataclasses.replace
    if cfg.family == "hybrid":
        tail = cfg.n_layers % 3
        return cfg.n_layers // 3, lambda k: rep(cfg, n_layers=3 * k + tail)
    if cfg.family == "xlstm":
        return cfg.n_layers // 8, lambda k: rep(cfg, n_layers=8 * k)
    if cfg.family == "encdec":
        if cfg.enc_layers != cfg.n_layers:
            return 1, lambda k: cfg
        return cfg.n_layers, lambda k: rep(cfg, n_layers=k, enc_layers=k)
    return cfg.n_layers, lambda k: rep(cfg, n_layers=k)


def trace_cell(cfg: ModelConfig, spec: ShapeSpec, mesh, *,
               microbatches: int | None = None, full_depth: bool = False):
    """Trace one (arch x shape) cell on ``mesh`` (any ``DeviceMesh`` over
    the default group, a ``(1, 1)`` one too) as its rank 0. Returns
    (``Roofline``, extra row fields).

    The model is traced at one and two of its depth units and a train
    step at one and two microbatches; the counts at the full depth and
    microbatch count follow by JAX's trip-count rule
    (``counter.trip_counts``), which the row records. ``full_depth``
    traces every layer instead (microbatches still at one and two)."""
    chips = mesh.size()
    b = spec.global_batch
    units, at = depth_units(cfg)
    ks = (units,) if full_depth or units <= 2 else (1, 2)
    m = microbatches_for(spec, mesh, microbatches) \
        if spec.kind == "train" else 1
    ms = (1, 2) if m > 1 else (1,)
    traced = {(k, j): _trace(at(k), spec, mesh, b * j // m, j)
              for k in ks for j in ms}
    totals = trip_counts(traced, units, m)
    extra = {"depth_units": units, "traced_depth_units": list(ks)}
    if spec.kind == "train":
        extra.update(microbatches=m, traced_microbatches=list(ms))
    tokens = b * spec.seq_len if spec.kind != "decode" else b
    roof = analysis.analyze(
        arch=cfg.name, shape=spec.name,
        mesh_name="x".join(str(s) for s in mesh.shape), chips=chips,
        totals=totals,
        model_flops_global=analysis.model_flops(cfg, spec.kind, tokens),
        kernel_traffic=analysis.kernel_traffic(cfg, spec, chips))
    extra["kernels"] = {k: {"calls": v[0], "bytes": v[1], "flops": v[2]}
                        for k, v in sorted(totals.kernels.items())}
    extra["coll_sites_mb"] = {
        f"{kind}@{axis} {site}": v / 2**20 for (kind, axis, site), v
        in sorted(totals.sites.items(), key=lambda kv: -kv[1])}
    return roof, extra


def _mesh_shape(mesh_name: str) -> tuple:
    if mesh_name in ("single", "multi"):
        from repro_torch.launch.mesh import PRODUCTION_SHAPE
        return PRODUCTION_SHAPE[mesh_name == "multi"]
    return tuple(int(n) for n in mesh_name.split(","))


def run_cell(arch: str, shape_name: str, mesh_name: str = "single",
             out_dir=None, verbose: bool = True) -> dict:
    """Trace one cell in a fake world of its mesh (``single`` (32, 8),
    ``multi`` (2, 32, 8), or a shape such as ``"1,1"``) and return its
    row; a cell that fails is a ``FAIL`` row with the error and its
    trace. With ``out_dir`` the row is also written there as JSON."""
    cfg = configs.get(arch)
    spec = SHAPES[shape_name]
    base = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    if spec.name == "long_500k" and not configs.long_context_ok(cfg):
        row = {**base, "status": "skipped",
               "reason": "pure full attention; long_500k needs "
                         "sub-quadratic mixer (DESIGN.md)"}
    else:
        shape = _mesh_shape(mesh_name)
        t0 = time.perf_counter()
        try:
            with fake_world(math.prod(shape)):
                mesh = make_production_mesh(
                    multi_pod=mesh_name == "multi", device_type="cpu") \
                    if mesh_name in ("single", "multi") else make_mesh(shape)
                roof, extra = trace_cell(cfg, spec, mesh)
            row = {**roof.row(), **extra, "mesh_name": mesh_name,
                   "trace_s": time.perf_counter() - t0, "status": "ok"}
            if verbose:
                print(f"[{arch} x {shape_name} x {row['mesh']}] OK "
                      f"({row['trace_s']:.1f} s)")
                print(f"  memory: {row['hbm_gb_per_chip']:.2f} GiB a card")
                print(f"  flops/chip={roof.flops_per_chip:.3e} "
                      f"bytes/chip={roof.bytes_per_chip:.3e} "
                      f"coll/chip={roof.coll_bytes_per_chip:.3e}")
                print(f"  roofline: compute={row['compute_ms']:.2f}ms "
                      f"memory={row['memory_ms']:.2f}ms "
                      f"collective={row['collective_ms']:.2f}ms "
                      f"dominant={row['dominant']}")
                for site, mb in list(row["coll_sites_mb"].items())[:8]:
                    print(f"  collective {mb:12.3f} MB  {site}")
        except Exception as e:  # noqa: BLE001 -- a failing cell is a row
            row = {**base, "status": "FAIL",
                   "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-2000:]}
            if verbose:
                print(f"[{arch} x {shape_name} x {mesh_name}] FAIL: "
                      f"{row['error'][:300]}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"{arch}_{shape_name}_{mesh_name.replace(',', 'x')}"
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(row, f, indent=2, default=str)
    return row


def _run_job(job) -> dict:
    torch.set_num_threads(1)
    return run_cell(*job)


def main(argv=None):
    """The command line: one cell, or ``--all``; returns the rows."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=list(configs.ARCH_IDS))
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single",
                    help="single (32x8), multi (2x32x8), both, or a mesh "
                         "shape such as 1,1")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in its own process")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        jobs = [(arch, spec.name, m, args.out)
                for arch in configs.ARCH_IDS
                for spec in cells_for(configs.get(arch)) for m in meshes]
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        jobs = [(args.arch, args.shape, m, args.out) for m in meshes]
    t0 = time.perf_counter()
    if args.jobs > 1:
        import multiprocessing as mp
        with mp.get_context("spawn").Pool(args.jobs) as pool:
            rows = pool.map(_run_job, jobs, chunksize=1)
    else:
        rows = [run_cell(*job) for job in jobs]
    n_ok = sum(r["status"] == "ok" for r in rows)
    n_skip = sum(r["status"] == "skipped" for r in rows)
    if args.all:
        analysis.save_rows(rows, os.path.join(args.out, "rows.json"))
    print(f"\n{n_ok} ok / {n_skip} skipped / "
          f"{len(rows) - n_ok - n_skip} failed of {len(rows)} cells "
          f"in {time.perf_counter() - t0:.1f} s")
    return rows


if __name__ == "__main__":
    main()
