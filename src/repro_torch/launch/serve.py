"""Serving command of the port: ``LLMEngine.generate`` on seeded random
weights and seeded prompts, with an optional ``torch.profiler`` breakdown.

On the card (the default device):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --requests 16 --slots 8 --max-new 32 --profile
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch h2o-danube-1.8b --max-prompt 2048 --crossing 2
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
        --profile
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
        --profile
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-2b --max-prompt 3072 --crossing 2 --profile
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-34b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch chameleon-34b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b \
        --max-prompt 127 --lengths 1024 2048 3072 4096 --max-seq 8192
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch seamless-m4t-large-v2 --min-prompt 64 --max-prompt 512 \
        --lengths 700 1000 --max-seq 1024
On the CPU, at the reduced config:
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --arch seamless-m4t-large-v2

An architecture that can page (qwen2-0.5b) is served from the paged pool;
a sliding-window one (h2o-danube-1.8b) from the contiguous cache, a
window-row ring per slot, whose decode attention is the ``flash_decode``
kernel. A mixture of experts (olmoe-1b-7b, granite-moe-3b-a800m) is
served from the contiguous cache too, each prompt prefilled at its exact
length: capacity routing couples the tokens of a batch and the slots of
a step, so padding or paging would change its tokens. A prompt of more
than 256 tokens must be a multiple of 256 (the dispatch group). The
Griffin hybrid (recurrentgemma-2b) is served from the contiguous cache at
exact length too: its conv and RG-LRU states absorb every token, beside a
window-row K/V ring for its local attention. The dense qk-norm configs
(qwen3-8b, yi-34b, chameleon-34b) page like qwen2-0.5b; a 34B model in
bf16 takes about 69 GB of an 80 GB card. The xLSTM (xlstm-1.3b) is served
from the contiguous cache at exact length: its cache is the mLSTM and
sLSTM state, the same size at any ``--max-seq``; a prompt of more than
64 tokens must be a multiple of ``S // 64`` tokens (JAX's chunked scan).
The encoder-decoder (seamless-m4t-large-v2) takes frame prompts,
``standard_normal`` ``[length, d_model]`` embeddings drawn from
``--seed`` (its audio frontend is a stub), encodes them at exact length
and decodes from BOS; its contiguous cache holds the self and the cross
K/V. ``--lengths`` sets the lengths of the last prompts.
``--max-seq`` defaults to 512, or twice the window.
``--num-pages`` below full subscription (slots * max_seq / page_size)
oversubscribes the pool; ``--preemption swap|recompute`` says what
happens to the requests it evicts. The paged pool keeps the radix prefix
cache unless ``--no-prefix-cache``. ``--temperature`` / ``--top-k`` /
``--top-p`` / ``--sampling-seed`` sample every request (``--seed`` seeds
the weights and prompts; ``--sampling-seed`` the draws, default each
request's id). ``--scheduler fcfs|priority|sjf`` orders admission; the
requests carry priorities ``rid % 3``, so ``priority`` reorders them:
    PYTHONPATH=src python -m repro_torch.launch.serve --temperature 0.8 \
        --top-k 50 --scheduler priority
``--crossing N`` gives N prompts a length just under the window (decoding
carries them across it) and N a length past it (prefilled at exact
length and laid out as the ring).

``--chaos PLAN`` injects step-indexed faults (``kind@step[:k=v[;k=v]]``,
comma-separated: ``abort``, ``device_fault``, ``pool_exhaustion``,
``corrupt_readback``, ``stall``) into the measured serve, and
``--deadline S`` gives every request a wall-clock budget of S seconds;
``--spec ngram|draft_model`` decodes speculatively with ``--spec-k``
drafts a step (greedy requests only; ``draft_model`` drafts with a
half-depth sibling of the served model, drawn from ``--seed + 1``):
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --chaos "abort@2:rid=1,device_fault@5:slot=0" --deadline 30
    PYTHONPATH=src python -m repro_torch.launch.serve --spec ngram \
        --spec-k 4

``--tp M`` serves tensor-parallel (``sharding/tp.py``, dense family on
the paged pool): the world of N ranks becomes an ``(N / M, M)``
``(data, model)`` mesh and every rank runs the same engine on its shard.
The world is ``torchrun``'s (NCCL, one card a rank), or ``--nproc N``
gloo ranks spawned here on the CPU; rank 0 prints, with a ``mesh:`` line
before the JSON:
    PYTHONPATH=src torchrun --nproc-per-node 1 -m \
        repro_torch.launch.serve --arch qwen3-8b --tp 1
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke \
        --device cpu --tp 2 --nproc 4

It prints one JSON line of serving metrics (tok/s, mean TTFT, the mean
wall time of a decode step, steps, readbacks, the readbacks settled
before a step's dispatch (``drains_before_dispatch``), kernel launches,
preemptions and pages swapped, the decode step's captures and graph
replays, the scheduler's reorders, the prefix cache's hit tokens, suffix
prefills and copy-on-write copies, the request lifecycle's outcomes and
the faults injected, the spec counters, and on the card the peak memory
and the card's name and power limit). ``--profile`` adds, for the measured
run, the host's ``cudaLaunchKernel`` and ``cudaGraphLaunch``
calls, each of the port's kernels by name with its launches and device
time as the profiler saw them (kernels inside graph replays included
where the profiler reports them), the top operators by device time
and by host time, and the engine's spans (``serving/tracing.py``, with
device times on the card) as a table: count, total, mean and self time
of each span name.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import re
import subprocess
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch.mesh import (free_port, init_world, make_local_mesh,
                                     under_torchrun)
from repro_torch.models import registry
from repro_torch.reliability import Fault
from repro_torch.serving import LLMEngine, SamplingParams, SpecConfig
from repro_torch.serving import tracing

LIFECYCLE = ("aborted", "rejected", "failed", "deadline_expired",
             "recoveries")
SPEC_STATS = ("spec_on", "spec_drafter", "spec_k", "draft_tokens",
              "accepted_tokens", "accepted_per_step", "accept_rate")


# the port's CUDA kernels by the name of their __global__ function
KERNEL_SYMBOLS = {
    "one_pass_kernel": "fused_add_rmsnorm", "pass1_kernel":
    "fused_add_rmsnorm", "pass2_kernel": "fused_add_rmsnorm",
    "silu_and_mul_kernel": "silu_and_mul",
    "paged_decode_kernel": "paged_flash_decode",
    "flash_decode_kernel": "flash_decode",
    "merge_kernel": "merge_attn_states_lse",
    "merge_s_out_kernel": "merge_attn_states_lse"}


def prompts_for(cfg, n: int, lo: int, hi: int, seed: int, *,
                crossing: int = 0, lengths=()) -> list:
    """``n`` prompts of seeded lengths in ``[lo, hi]`` and seeded ids, or
    for a frames config (``cfg.frontend == "frames"``) seeded
    ``standard_normal`` frame embeddings ``[length, d_model]`` in fp32, as
    the JAX serve command draws them. ``crossing`` > 0 (a sliding-window
    config only) redraws the lengths of the first ``crossing`` prompts in
    ``[window - 26, window - 6]``, so that 32 new tokens carry them across
    the window, and of the next ``crossing`` in ``(window, 1.5 window]``,
    longer than the ring. ``lengths`` sets the lengths of the last
    ``len(lengths)`` prompts."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, size=n)
    if crossing:
        w = cfg.window
        if not w or 2 * crossing > n:
            raise ValueError(f"crossing={crossing} needs a sliding-window "
                             f"config and at least {2 * crossing} prompts")
        lens[:crossing] = rng.integers(w - 26, w - 5, size=crossing)
        lens[crossing:2 * crossing] = rng.integers(w + 1, w + w // 2 + 1,
                                                   size=crossing)
    if lengths:
        if len(lengths) > n:
            raise ValueError(f"{len(lengths)} lengths for {n} prompts")
        lens[n - len(lengths):] = lengths
    if cfg.frontend == "frames":
        return [rng.standard_normal((int(m), cfg.d_model))
                .astype(np.float32) for m in lens]
    return [rng.integers(0, cfg.vocab, size=int(m)).astype(np.int32)
            for m in lens]


# the shared-prefix workload of the JAX package's serve benchmark: r0-r11
# a page-aligned staircase over one 256-token base (64, 80, ..., 240), r12
# a copy of r5 (a whole-prompt match: copy-on-write), r13-r15 the base cut
# at a page boundary with a ragged tail of fresh tokens
SHARED_PREFIX_STAIRS = [64 + 16 * i for i in range(12)]
SHARED_PREFIX_TAILS = ((208, 5), (96, 9), (176, 3))


def shared_prefix_prompts(cfg, seed: int) -> list:
    """The 16 prompts of the shared-prefix workload, token ids from
    ``seed`` (the same ids as the JAX benchmark's for the same vocab)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, cfg.vocab, (256,), dtype=np.int32)
    prompts = [base[:n].copy() for n in SHARED_PREFIX_STAIRS]
    prompts.append(base[:144].copy())
    for cut, extra in SHARED_PREFIX_TAILS:
        tail = rng.integers(0, cfg.vocab, (extra,), dtype=np.int32)
        prompts.append(np.concatenate([base[:cut], tail]))
    return prompts


def default_max_seq(cfg) -> int:
    """512 rows a slot, or twice the window of a sliding-window config."""
    return 2 * cfg.window if cfg.window else 512


def kernel_times(events) -> dict:
    """{kernel: {"launches", "device_us"}} of the port's CUDA kernels among
    ``torch.profiler`` key averages, by the name of their function."""
    out: dict = {}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        found = re.search(r"::(\w+)[<(]", e.key)
        name = KERNEL_SYMBOLS.get(found.group(1)) if found else None
        if name is not None:
            row = out.setdefault(name, {"launches": 0, "device_us": 0.0})
            row["launches"] += e.count
            row["device_us"] += e.self_device_time_total
    return out


def parse_chaos(plan: str) -> list:
    """A fault plan from its compact form, ``kind@step[:k=v[;k=v]]``
    joined by commas, e.g. ``abort@2:rid=1,device_fault@5:slot=0,
    pool_exhaustion@8:pages=3;steps=4`` (the JAX serve command's
    syntax)."""
    faults = []
    for part in plan.split(","):
        head, _, kv = part.strip().partition(":")
        kind, _, step = head.partition("@")
        extra = {}
        for item in filter(None, kv.split(";")):
            k, _, v = item.partition("=")
            extra[k.strip()] = float(v) if k.strip() == "seconds" \
                else int(v)
        faults.append(Fault(kind=kind.strip(), step=int(step), **extra))
    return faults


def make_spec(drafter: str, k: int, cfg, seed: int, device) -> SpecConfig:
    """``--spec`` / ``--spec-k`` as a ``SpecConfig``. The draft model is a
    half-depth sibling of ``cfg`` with weights from ``seed + 1``: a
    stand-in with the cost and acceptance of a small drafter."""
    if drafter == "ngram":
        return SpecConfig(drafter="ngram", k=k)
    dcfg = dataclasses.replace(cfg, name=cfg.name + "-draft",
                               n_layers=max(1, cfg.n_layers // 2))
    return SpecConfig(drafter="draft_model", k=k, draft_cfg=dcfg,
                      draft_params=registry.init_params(
                          dcfg, seed=seed + 1, device=device))


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def warm_up_prompts(cfg, page_size: int) -> tuple[list, list]:
    """(prompts, sampling) of the warm-up wave: two short prompts, the
    second sampled, and a third that starts with the first one's first
    page (a prefix hit where the tree is on), so that the measured wave
    meets no first use of the draw or the suffix prefill."""
    warm = prompts_for(cfg, 2, page_size, 64, seed=99)
    warm.append(np.concatenate([warm[0][:page_size], warm[1]]))
    return warm, [None, SamplingParams(temperature=1.0), None]


def measure(params, cfg, prompts, *, max_new: int, slots: int,
            max_seq: int, page_size: int, device, num_pages=None,
            preemption: str = "swap", paged=None, prefix_cache: bool = True,
            scheduler: str = "fcfs", sampling=None, priorities=None,
            chaos=None, spec=None, deadlines=None, check_steps=False,
            profile_rows: int = 0, mesh=None) -> tuple[dict, list]:
    """Warm up on an engine of its own, then serve ``prompts`` once on a
    fresh engine (on the card its decode step is captured when it is
    built), with every kernel's launch count set to 0 just before.
    ``sampling`` is one ``SamplingParams`` or one per prompt (None:
    greedy); ``priorities`` one int per prompt; ``deadlines`` seconds (one
    for all or one per prompt); ``spec`` a ``SpecConfig`` (both engines);
    ``chaos`` a ``Fault`` list injected into the measured serve only.
    ``check_steps`` runs the pool check after every step of it. ``mesh``
    (a ``(data, model)`` ``DeviceMesh``) serves both engines
    tensor-parallel, every rank of the mesh calling this alike. Returns
    (metrics, the ``RequestOutput`` list). The pool check runs at the end
    with the tree's pages, then ``pool_released`` says whether every page
    in use was the tree's and clearing the tree emptied the pool.
    ``profile_rows > 0`` runs the measured wave under ``torch.profiler``
    and the engine's tracer, prints its top operators and its span table,
    and returns the table's rows as ``spans``."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    kw = dict(slots=slots, max_seq=max_seq, page_size=page_size, device=dev,
              num_pages=num_pages, preemption=preemption, paged=paged,
              prefix_cache=prefix_cache, scheduler=scheduler, spec=spec,
              mesh=mesh)
    LLMEngine(params, cfg, **kw).generate(
        *warm_up_prompts(cfg, page_size), max_new_tokens=4)
    llm = LLMEngine(params, cfg, chaos=list(chaos) if chaos else None, **kw)
    step_checks = 0
    if check_steps:
        step = llm.engine.step

        def checked_step():
            nonlocal step_checks
            ran = step()
            llm.engine.check_pool()
            step_checks += 1
            return ran
        llm.engine.step = checked_step
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    acts = [torch.profiler.ProfilerActivity.CPU] + \
        ([torch.profiler.ProfilerActivity.CUDA] if cuda else [])
    prof = torch.profiler.profile(activities=acts) if profile_rows \
        else contextlib.nullcontext()
    with prof:
        if profile_rows:
            llm.engine.tracer.start()
        t0 = time.perf_counter()
        outs = llm.generate(prompts, sampling, max_new_tokens=max_new,
                            priorities=priorities, deadlines=deadlines)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        spans = llm.engine.tracer.stop()
    st = llm.stats()
    out = {"arch": cfg.name, "d_model": cfg.d_model,
           "n_layers": cfg.n_layers, "dtype": cfg.dtype,
           "device": str(dev), "requests": len(outs),
           "prompt_lens": [len(p) for p in prompts], "max_new": max_new,
           "slots": slots, "max_seq": max_seq, "paged": st["paged"],
           "page_size": page_size, "num_pages": st.get("num_pages"),
           "wall_s": wall, "tok_s": st["tok_s"], "ttft_s": st["ttft"],
           "decode_step_s": st["decode_step_s"],
           "steps": st["steps"], "readbacks": st["readbacks"],
           "drains_before_dispatch": st["drains_before_dispatch"],
           "prefill_buckets": st["prefill_shapes"],
           "decode_captures": st["decode_captures"],
           "graph_replays": st["graph_replays"],
           "capture_s": st["capture_s"],
           "capture_warmups": st["capture_warmups"],
           "capture_by_step": st["capture_by_step"],
           "sampling_step": st["sampling_step"],
           "table_uploads": st["table_uploads"],
           "preemption": preemption, "preemptions": st["preemptions"],
           "swapped_out_pages": st["swapped_out_pages"],
           "swapped_in_pages": st["swapped_in_pages"],
           "scheduler": st["scheduler"],
           "sched_reorders": st["sched_reorders"],
           "prefills": st["prefills"],
           "suffix_prefills": st["suffix_prefills"],
           "step_checks": step_checks,
           "reasons": [o.finish_reason for o in outs],
           "ttfts": [o.ttft_s for o in outs],
           "hits": [o.prefix_hit_tokens for o in outs],
           "launches": ops.launch_counts(),
           "all_done": all(o.finish_reason == "done" for o in outs)}
    if mesh is not None:
        out["mesh"] = st["mesh"]
    for key in ("prefix_cache", "prefix_hit_tokens", "prefix_query_tokens",
                "cow_copies", "tree_evictions", "tree_pages") + LIFECYCLE:
        out[key] = st.get(key, 0)
    if spec is not None:
        out.update({key: st[key] for key in SPEC_STATS})
    if chaos:
        out.update(chaos_injected=st["chaos_injected"],
                   chaos_relents=st["chaos_relents"],
                   chaos_exhausted=llm.engine.chaos.exhausted)
    if st["paged"]:
        cm = llm.engine.cm
        try:
            llm.engine.check_pool()
            out["pool_ok"] = True
        except AssertionError as e:
            out["pool_ok"] = False
            out["pool_error"] = str(e)
        tree_only = cm.pool.pages_in_use == len(cm.pool.tree_pages())
        cm.clear_tree()
        out["pool_released"] = tree_only and cm.pool.pages_in_use == 0
    if cuda:
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        out["card"] = card()
    if profile_rows:
        ev = prof.key_averages()
        # device-side events only: an operator's row repeats the time of
        # the kernels it launched
        dev_us = sum(e.self_device_time_total for e in ev
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not e.is_user_annotation)
        out["device_kernel_s"] = dev_us / 1e6
        out["kernel_launches"] = sum(e.count for e in ev
                                     if e.key == "cudaLaunchKernel")
        out["graph_launches"] = sum(e.count for e in ev
                                    if e.key == "cudaGraphLaunch")
        # kernels the device ran, graph replays' included (copies, sets
        # and the profiler's own markers left out)
        out["device_kernels"] = sum(
            e.count for e in ev
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation
            and not e.key.startswith(("Memcpy", "Memset"))
            and e.key != "Command Buffer Full")
        out["port_kernels"] = kernel_times(ev)
        sort = "self_cuda_time_total" if cuda else "self_cpu_time_total"
        print(ev.table(sort_by=sort, row_limit=profile_rows))
        if cuda:
            print(ev.table(sort_by="self_cpu_time_total",
                           row_limit=profile_rows))
        out["spans"] = tracing.summarize(spans)
        print(tracing.table(out["spans"]))
    return out, outs


def run(args) -> dict:
    """Seeded weights and prompts for ``args``, then ``measure``."""
    dev = resolve_device(args.device)
    cfg = configs.smoke(args.arch) if args.smoke else configs.get(args.arch)
    params = registry.init_params(cfg, seed=args.seed, device=dev)
    prompts = prompts_for(cfg, args.requests, args.min_prompt,
                          args.max_prompt, args.seed, crossing=args.crossing,
                          lengths=getattr(args, "lengths", ()))
    max_seq = args.max_seq or default_max_seq(cfg)
    sp = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                        top_p=args.top_p, seed=args.sampling_seed)
    spec = make_spec(args.spec, args.spec_k, cfg, args.seed, dev) \
        if args.spec else None
    tp = getattr(args, "tp", None)
    mesh = make_local_mesh(tp, dev) if tp else None
    out, _ = measure(params, cfg, prompts, max_new=args.max_new,
                     slots=args.slots, max_seq=max_seq,
                     page_size=args.page_size, device=dev,
                     num_pages=args.num_pages, preemption=args.preemption,
                     prefix_cache=not args.no_prefix_cache,
                     scheduler=args.scheduler, sampling=sp,
                     priorities=[rid % 3 for rid in range(len(prompts))],
                     chaos=parse_chaos(args.chaos) if args.chaos else None,
                     spec=spec, deadlines=args.deadline,
                     profile_rows=args.rows if args.profile else 0,
                     mesh=mesh)
    return out


def mesh_line(out: dict) -> str:
    """The JAX serve command's line for a sharded run: the mesh, what
    shards, and the readbacks of the measured serve."""
    m = out["mesh"]
    sharded = [k for k in ("heads_tp", "mlp_tp", "vocab_tp", "batch_dp")
               if m[k]] or ["replicated"]
    return (f"mesh: data={m['data']} x model={m['model']} "
            f"({', '.join(sharded)}), {out['readbacks']} readbacks in "
            f"{out['steps']} steps")


def run_rank(rank: int | None, args, port: int | None) -> None:
    """One rank of a ``--tp`` serve: join the world (``torchrun``'s, or
    rank ``rank`` of ``--nproc`` on ``port``, or a world of one when
    ``rank`` is None), serve, and print on rank 0: the mesh line, then the
    JSON line."""
    import torch.distributed as dist
    if rank is not None:
        torch.set_num_threads(1)    # N ranks share this host's cores
    init_world(args.device, rank=rank or 0, world_size=args.nproc or 1,
               port=port)
    try:
        out = run(args)
        if dist.get_rank() == 0:
            print(mesh_line(out))
            print(json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    """Command-line entry point."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b",
                    choices=sorted(configs.CONFIGS))
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config instead of full width")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=None,
                    help="rows a slot (default 512, or twice the window)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=None,
                    help="pages of the pool (default: full subscription)")
    ap.add_argument("--preemption", default="swap",
                    choices=("swap", "recompute"),
                    help="what eviction does with a request's KV")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="serve the paged pool without the radix tree")
    ap.add_argument("--scheduler", default="fcfs",
                    choices=("fcfs", "priority", "sjf"),
                    help="admission order (requests carry priorities "
                    "rid %% 3)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy argmax (default); > 0 samples")
    ap.add_argument("--top-k", type=int, default=0,
                    help="keep the k highest logits (0 = all)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus mass (1.0 = all)")
    ap.add_argument("--sampling-seed", type=int, default=None,
                    help="seed of every request's draws (default: its "
                    "request id); --seed seeds weights and prompts")
    ap.add_argument("--min-prompt", type=int, default=16)
    ap.add_argument("--max-prompt", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--lengths", type=int, nargs="*", default=(),
                    help="the lengths of the last prompts")
    ap.add_argument("--crossing", type=int, default=0,
                    help="prompts just under and past the window, each")
    ap.add_argument("--chaos", default=None, metavar="PLAN",
                    help="step-indexed faults, e.g. 'abort@2:rid=1,"
                    "device_fault@5:slot=0,pool_exhaustion@8:pages=3;"
                    "steps=4'")
    ap.add_argument("--deadline", type=float, default=None,
                    help="every request's wall-clock budget, seconds "
                    "(finish_reason 'deadline' when it runs out)")
    ap.add_argument("--spec", default=None,
                    choices=("ngram", "draft_model"),
                    help="speculative decoding's drafter (greedy only)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="drafts a step (the verify scores k + 1)")
    ap.add_argument("--tp", type=int, default=None, metavar="M",
                    help="model-parallel size: serve sharded over the "
                    "world as a (N/M, M) (data, model) mesh")
    ap.add_argument("--nproc", type=int, default=None, metavar="N",
                    help="with --tp outside torchrun: spawn N gloo ranks "
                    "here (--device cpu)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--rows", type=int, default=25,
                    help="operators per profile table")
    args = ap.parse_args(argv)
    if args.tp is None:
        print(json.dumps(run(args)))
    elif under_torchrun() or not args.nproc:
        run_rank(None, args, None if under_torchrun() else free_port())
    else:
        if resolve_device(args.device).type != "cpu":
            raise ValueError("--nproc spawns gloo ranks: pass --device cpu "
                             "(on the card the world is torchrun's)")
        torch.multiprocessing.spawn(run_rank, args=(args, free_port()),
                                    nprocs=args.nproc)


if __name__ == "__main__":
    main()
