"""Sharded serving against the single-rank engine (the port's sibling of
the JAX ``tools/sharded_check.py``).

Runs the same request waves through two engines: one single-rank
(``mesh=None``) and one tensor-parallel over a ``(data, model)``
``DeviceMesh`` of ``torch.distributed`` ranks, every rank running the
same engine on its shard. It compares the token streams and the
deterministic counters (steps, readbacks, preemptions, prefix hits,
copy-on-write copies, recoveries), checks that every rank of the mesh
ended with the same streams and counters, and reports the largest
difference between the two engines' logits (prefill and one paged decode
step of the first wave's prompts). Sharding changes no token only where
the sharded products give the single-rank bits; PyTorch's do not always
(``sharding/tp.py``), so the logit difference is measured and reported.

Scenarios:
    greedy     argmax decoding, continuous batching
    sampling   seeded temperature/top-k/top-p sampling
    preempt    oversubscribed paged pool forcing swap preemption
    prefix     radix prefix-cache hits across two request waves
    chaos      injected device fault + swap-restore recovery

On the CPU the mesh's ranks are gloo processes spawned here:
    PYTHONPATH=src python -m repro_torch.launch.sharded_check \\
        --device cpu --arch qwen3-8b --mesh 2,2 --json
    PYTHONPATH=src python -m repro_torch.launch.sharded_check \\
        --device cpu --arch qwen2-0.5b --mesh 1,4
On the card the world is ``torchrun``'s (NCCL, one card a rank), or this
process alone as a world of one (``--mesh 1,1``):
    PYTHONPATH=src torchrun --nproc-per-node 1 -m \\
        repro_torch.launch.sharded_check --mesh 1,1
It prints the report (``--json``: one JSON object) and exits 1 unless
every scenario passed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import (free_port, init_world, make_local_mesh,
                                     under_torchrun)
from repro_torch.models import registry
from repro_torch.reliability import Fault
from repro_torch.serving import ChaosInjector, LLMEngine, SamplingParams
from repro_torch.sharding import tp

SCENARIOS = ("greedy", "sampling", "preempt", "prefix", "chaos")

# deterministic counters that must agree between the two engines
COMPARE = ("steps", "readbacks", "prefill_compiles", "preemptions",
           "sched_reorders", "prefix_hit_tokens", "cow_copies",
           "recoveries", "aborted", "failed")


def _prompts(cfg, rng, n, lo=4, hi=16):
    return [rng.integers(0, cfg.vocab, (int(rng.integers(lo, hi + 1)),),
                         dtype=np.int32) for _ in range(n)]


def _streams(outs):
    return [(o.rid, o.finish_reason, list(map(int, o.tokens)))
            for o in outs]


def run_scenario(name: str, cfg, params, mesh, device):
    """One engine, one scenario; returns (streams, stats)."""
    kw = dict(slots=4, max_seq=128)
    chaos = None
    if name == "chaos":
        chaos = ChaosInjector([Fault(kind="device_fault", step=7, slot=1)])
    if name == "preempt":
        kw.update(max_seq=96, num_pages=10)
    llm = LLMEngine(params, cfg, mesh=mesh, chaos=chaos, device=device,
                    **kw)
    rng = np.random.default_rng(0)
    sp = None
    if name == "sampling":
        sp = SamplingParams(temperature=0.8, top_k=5, top_p=0.9)
    if name == "prefix":
        # wave 1 caches the base prompt's pages in the radix tree; wave 2
        # shares a 32-token (2-page) prefix and must hit it
        base = rng.integers(0, cfg.vocab, (48,), dtype=np.int32)
        streams = _streams(llm.generate([base], sp, max_new_tokens=8))
        tails = [rng.integers(0, cfg.vocab, (6,), dtype=np.int32)
                 for _ in range(3)]
        wave2 = [np.concatenate([base[:32], t]) for t in tails]
        streams += _streams(llm.generate(wave2, sp, max_new_tokens=8))
        return streams, llm.stats()
    if name == "preempt":
        prompts = _prompts(cfg, rng, 6, lo=24, hi=40)
        outs = llm.generate(prompts, sp, max_new_tokens=16)
    else:
        prompts = _prompts(cfg, rng, 6)
        outs = llm.generate(prompts, sp, max_new_tokens=8)
    return _streams(outs), llm.stats()


def logit_gap(cfg, params, mesh, device, page: int = 16) -> float:
    """The largest absolute difference between the single-rank and the
    sharded logits: each of the greedy scenario's prompts prefilled
    alone, then one paged decode step of all of them (the slot batch
    split over ``data`` where the plan shards it). Every rank must call
    it: the sharded passes run the plan's collectives."""
    prompts = _prompts(cfg, np.random.default_rng(0), 6)
    plan = tp.make_plan(cfg, mesh, len(prompts))
    full = registry.module_for(cfg).cast_params(params, cfg, device)
    local = tp.shard_params(full, cfg, plan)
    pps = 2                                         # pages a slot
    n_pages = 1 + pps * len(prompts)                # page 0 is the trap
    table = torch.arange(1, n_pages, dtype=torch.int32,
                         device=device).reshape(len(prompts), pps)
    pool = registry.init_paged_cache(cfg, n_pages, page, device)
    pool_l = tp.put_cache(registry.init_paged_cache(cfg, n_pages, page,
                                                    device), plan)
    gap, toks = 0.0, []
    for b, prompt in enumerate(prompts):
        t = torch.tensor(prompt[None], dtype=torch.long, device=device)
        lf, kv = registry.prefill(full, cfg, t)
        with tp.active(plan):
            ll, kv_l = registry.prefill(local, cfg, t)
        gap = max(gap, float((lf.float() - ll.float()).abs().max()))
        rows = table[b].long()
        registry.write_pages(cfg, pool, kv, rows, page)
        registry.write_pages(cfg, pool_l, kv_l, rows, page)
        toks.append(int(torch.argmax(lf[0, :cfg.vocab])))
    tok = torch.tensor(toks, dtype=torch.int32, device=device)
    pos = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                       device=device)
    lf, _ = registry.decode_cached(full, cfg, pool, tok, pos,
                                   page_table=table)
    with tp.active(plan):
        ll, _ = registry.decode_cached(local, cfg, pool_l, tok, pos,
                                       page_table=table)
        ll = tp.gather_data(ll)
    return max(gap, float((lf.float() - ll.float()).abs().max()))


def check(arch: str, mesh, scenarios=SCENARIOS, *, dtype="float32",
          device=None) -> dict:
    """Every scenario on the single-rank engine (rank 0 alone) and on the
    sharded one (every rank); rank 0's report (other ranks return
    None)."""
    import torch.distributed as dist
    dev = resolve_device(device)
    rank = dist.get_rank()
    cfg = dataclasses.replace(configs.smoke(arch), dtype=dtype)
    params = registry.init_params(cfg, seed=0, device=dev)
    report = {"arch": arch, "mesh": list(mesh.shape), "dtype": dtype,
              "world": dist.get_world_size(), "scenarios": {}, "ok": True}
    for name in scenarios:
        base = run_scenario(name, cfg, params, None, dev) \
            if rank == 0 else None
        sh_streams, sh_stats = run_scenario(name, cfg, params, mesh, dev)
        mine = (sh_streams, {k: sh_stats.get(k, 0) for k in COMPARE})
        ranks = [None] * dist.get_world_size()
        dist.all_gather_object(ranks, mine)
        if rank != 0:
            continue
        base_streams, base_stats = base
        report.setdefault("plan", sh_stats.get("mesh"))
        notes = []
        if base_streams != sh_streams:
            notes.append("token streams differ")
        for k in COMPARE:
            if base_stats.get(k, 0) != sh_stats.get(k, 0):
                notes.append(f"{k}: single={base_stats.get(k, 0)} "
                             f"sharded={sh_stats.get(k, 0)}")
        for label, s in (("single", base_stats), ("sharded", sh_stats)):
            if s["readbacks"] != s["steps"]:
                notes.append(f"{label}: {s['readbacks']} readbacks != "
                             f"{s['steps']} steps")
        apart = [r for r, other in enumerate(ranks) if other != mine]
        if apart:
            notes.append(f"ranks {apart} ended unlike rank 0")
        if name == "preempt" and base_stats.get("preemptions", 0) == 0:
            notes.append("scenario forced no preemption")
        if name == "prefix" and base_stats.get("prefix_hit_tokens", 0) == 0:
            notes.append("scenario produced no prefix-cache hit")
        if name == "chaos" and base_stats.get("recoveries", 0) != 1:
            notes.append(f"expected 1 recovery, got "
                         f"{base_stats.get('recoveries', 0)}")
        ok = not notes
        report["scenarios"][name] = {
            "ok": ok, "streams_match": base_streams == sh_streams,
            "steps": base_stats["steps"],
            "counters": {k: base_stats.get(k, 0) for k in COMPARE},
            "notes": notes}
        report["ok"] = report["ok"] and ok
    gap = logit_gap(cfg, params, mesh, dev)
    if rank != 0:
        return None
    report["max_logit_diff"] = gap
    return report


def _mesh_shape(text: str) -> tuple[int, int]:
    data, model = (int(x) for x in text.split(","))
    return data, model


def _run(args, out_path=None) -> dict | None:
    """This rank's part: the mesh over the joined world, then ``check``;
    rank 0 writes the report to ``out_path`` when given."""
    import torch.distributed as dist
    data, model = _mesh_shape(args.mesh)
    if dist.get_world_size() != data * model:
        raise ValueError(f"mesh {args.mesh} needs {data * model} ranks, "
                         f"the world has {dist.get_world_size()}")
    mesh = make_local_mesh(model, args.device)
    scenarios = tuple(args.scenarios.split(",")) if args.scenarios \
        else SCENARIOS
    report = check(args.arch, mesh, scenarios, dtype=args.dtype,
                   device=args.device)
    if report is not None and out_path is not None:
        with open(out_path, "w") as f:
            json.dump(report, f)
    return report


def _spawned(rank: int, args, port: int, out_path: str) -> None:
    """A gloo rank on the CPU, spawned by ``main``."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    init_world("cpu", rank=rank, world_size=args.world, port=port)
    try:
        _run(args, out_path)
    finally:
        dist.destroy_process_group()


def _print(report: dict, as_json: bool) -> None:
    if as_json:
        print(json.dumps(report, indent=2))
        return
    print(f"{report['arch']} on mesh {tuple(report['mesh'])} "
          f"plan={report.get('plan')} "
          f"max|logit diff|={report['max_logit_diff']:.3g}")
    for name, r in report["scenarios"].items():
        mark = "ok" if r["ok"] else "FAIL " + "; ".join(r["notes"])
        print(f"  {name:<10} streams_match={r['streams_match']} "
              f"steps={r['steps']} -> {mark}")
    print("streams and counters equal" if report["ok"] else "MISMATCH")


def main(argv=None) -> int:
    """Command-line entry point; returns the exit code."""
    ap = argparse.ArgumentParser(
        description="sharded-vs-single-rank serving check")
    ap.add_argument("--arch", default="qwen3-8b",
                    choices=sorted(configs.CONFIGS))
    ap.add_argument("--mesh", default="2,2",
                    help="data,model axis sizes (e.g. 2,2 or 1,4)")
    ap.add_argument("--device", default=None,
                    help="cuda (default; torchrun's world, or this "
                    "process alone) or cpu (gloo ranks spawned here)")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--scenarios", default=None,
                    help=f"comma list from {','.join(SCENARIOS)}")
    ap.add_argument("--json", action="store_true", dest="as_json")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    import torch.distributed as dist
    if under_torchrun() or dev.type == "cuda":
        # torchrun's world, or this process as a world of one
        init_world(dev, port=None if under_torchrun() else free_port())
        try:
            report = _run(args)
        finally:
            dist.destroy_process_group()
        if report is None:
            return 0                    # rank 0 reports
    else:
        data, model = _mesh_shape(args.mesh)
        args.world = data * model
        with tempfile.TemporaryDirectory() as tmp:
            out_path = os.path.join(tmp, "report.json")
            torch.multiprocessing.spawn(
                _spawned, args=(args, free_port(), out_path),
                nprocs=args.world)
            with open(out_path) as f:
                report = json.load(f)
    _print(report, args.as_json)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
