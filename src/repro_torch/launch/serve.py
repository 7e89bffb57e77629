"""Serving command of the port: ``LLMEngine.generate`` on seeded random
weights and seeded prompts, with an optional ``torch.profiler`` breakdown.

On the card (the default device):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --requests 16 --slots 8 --max-new 32 --profile
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch h2o-danube-1.8b --max-prompt 2048 --crossing 2
On the CPU, at the reduced config:
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

An architecture that can page (qwen2-0.5b) is served from the paged pool;
a sliding-window one (h2o-danube-1.8b) from the contiguous cache, a
window-row ring per slot, whose decode attention is the ``flash_decode``
kernel. ``--max-seq`` defaults to 512, or twice the window.
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

It prints one JSON line of serving metrics (tok/s, mean TTFT, the mean
wall time of a decode step, steps, readbacks, kernel launches,
preemptions and pages swapped, the decode step's captures and graph
replays, the scheduler's reorders, the prefix cache's hit tokens, suffix
prefills and copy-on-write copies, the request lifecycle's outcomes and
the faults injected, the spec counters, and on the card the peak memory
and the card's name and power limit). ``--profile`` adds, for the measured
run, the device's busy share of the wall time, the host's
``cudaLaunchKernel`` and ``cudaGraphLaunch``
calls, each of the port's kernels by name with its launches and device
time as the profiler saw them (kernels inside graph replays included
where the profiler reports them), and the top operators by device time
and by host time.
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
from repro_torch.models import registry
from repro_torch.reliability import Fault
from repro_torch.serving import LLMEngine, SamplingParams, SpecConfig

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
                crossing: int = 0) -> list:
    """``n`` prompts of seeded lengths in ``[lo, hi]`` and seeded ids.
    ``crossing`` > 0 (a sliding-window config only) redraws the lengths of
    the first ``crossing`` prompts in ``[window - 26, window - 6]``, so
    that 32 new tokens carry them across the window, and of the next
    ``crossing`` in ``(window, 1.5 window]``, longer than the ring."""
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
            profile_rows: int = 0) -> tuple[dict, list]:
    """Warm up on an engine of its own, then serve ``prompts`` once on a
    fresh engine (on the card its decode step is captured when it is
    built), with every kernel's launch count set to 0 just before.
    ``sampling`` is one ``SamplingParams`` or one per prompt (None:
    greedy); ``priorities`` one int per prompt; ``deadlines`` seconds (one
    for all or one per prompt); ``spec`` a ``SpecConfig`` (both engines);
    ``chaos`` a ``Fault`` list injected into the measured serve only.
    ``check_steps`` runs the pool check after every step of it. Returns
    (metrics, the ``RequestOutput`` list). The pool check runs at the end
    with the tree's pages, then ``pool_released`` says whether every page
    in use was the tree's and clearing the tree emptied the pool.
    ``profile_rows > 0`` runs the measured wave under ``torch.profiler``
    and prints its top operators."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    kw = dict(slots=slots, max_seq=max_seq, page_size=page_size, device=dev,
              num_pages=num_pages, preemption=preemption, paged=paged,
              prefix_cache=prefix_cache, scheduler=scheduler, spec=spec)
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
        t0 = time.perf_counter()
        outs = llm.generate(prompts, sampling, max_new_tokens=max_new,
                            priorities=priorities, deadlines=deadlines)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
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
        out["device_busy_share"] = dev_us / (wall * 1e6) if cuda else None
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
    return out, outs


def run(args) -> dict:
    """Seeded weights and prompts for ``args``, then ``measure``."""
    dev = resolve_device(args.device)
    cfg = configs.smoke(args.arch) if args.smoke else configs.get(args.arch)
    params = registry.init_params(cfg, seed=args.seed, device=dev)
    prompts = prompts_for(cfg, args.requests, args.min_prompt,
                          args.max_prompt, args.seed, crossing=args.crossing)
    max_seq = args.max_seq or default_max_seq(cfg)
    sp = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                        top_p=args.top_p, seed=args.sampling_seed)
    spec = make_spec(args.spec, args.spec_k, cfg, args.seed, dev) \
        if args.spec else None
    out, _ = measure(params, cfg, prompts, max_new=args.max_new,
                     slots=args.slots, max_seq=max_seq,
                     page_size=args.page_size, device=dev,
                     num_pages=args.num_pages, preemption=args.preemption,
                     prefix_cache=not args.no_prefix_cache,
                     scheduler=args.scheduler, sampling=sp,
                     priorities=[rid % 3 for rid in range(len(prompts))],
                     chaos=parse_chaos(args.chaos) if args.chaos else None,
                     spec=spec, deadlines=args.deadline,
                     profile_rows=args.rows if args.profile else 0)
    return out


def main(argv=None) -> None:
    """Command-line entry point."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--rows", type=int, default=25,
                    help="operators per profile table")
    print(json.dumps(run(ap.parse_args(argv))))


if __name__ == "__main__":
    main()
