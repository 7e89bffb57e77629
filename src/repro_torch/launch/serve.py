"""Serving command of the port: ``LLMEngine.generate`` on seeded random
weights and seeded prompts, with an optional ``torch.profiler`` breakdown.

On the card (the default device):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --requests 16 --slots 8 --max-new 32 --profile
On the CPU, at the reduced config:
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

It prints one JSON line of serving metrics (tok/s, mean TTFT, steps,
readbacks, kernel launches, and on the card the peak memory and the card's
name and power limit). ``--profile`` adds, for the measured run, the
device's busy share of the wall time and the top operators by device time
and by host time.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import registry
from repro_torch.serving import LLMEngine


def prompts_for(cfg, n: int, lo: int, hi: int, seed: int) -> list:
    """``n`` prompts of seeded lengths in ``[lo, hi]`` and seeded ids."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, size=n)
    return [rng.integers(0, cfg.vocab, size=int(m)).astype(np.int32)
            for m in lens]


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def measure(params, cfg, prompts, *, max_new: int, slots: int,
            max_seq: int, page_size: int, device,
            profile_rows: int = 0) -> tuple[dict, list]:
    """Warm up on an engine of its own, then serve ``prompts`` once on a
    fresh engine, with every kernel's launch count set to 0 just before.
    Returns (metrics, the ``RequestOutput`` list). ``profile_rows > 0``
    runs the measured wave under ``torch.profiler`` and prints its top
    operators."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    kw = dict(slots=slots, max_seq=max_seq, page_size=page_size, device=dev)
    LLMEngine(params, cfg, **kw).generate(
        prompts_for(cfg, 2, 16, 64, seed=99), max_new_tokens=4)
    llm = LLMEngine(params, cfg, **kw)
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
        outs = llm.generate(prompts, max_new_tokens=max_new)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    st = llm.stats()
    out = {"arch": cfg.name, "d_model": cfg.d_model,
           "n_layers": cfg.n_layers, "dtype": cfg.dtype,
           "device": str(dev), "requests": len(outs),
           "prompt_lens": [len(p) for p in prompts], "max_new": max_new,
           "slots": slots, "max_seq": max_seq, "page_size": page_size,
           "wall_s": wall, "tok_s": st["tok_s"], "ttft_s": st["ttft"],
           "steps": st["steps"], "readbacks": st["readbacks"],
           "prefill_buckets": st["prefill_shapes"],
           "launches": ops.launch_counts(),
           "all_done": all(o.finish_reason == "done" for o in outs)}
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
                          args.max_prompt, args.seed)
    out, _ = measure(params, cfg, prompts, max_new=args.max_new,
                     slots=args.slots, max_seq=args.max_seq,
                     page_size=args.page_size, device=dev,
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
    ap.add_argument("--max-seq", type=int, default=512)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--min-prompt", type=int, default=16)
    ap.add_argument("--max-prompt", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--rows", type=int, default=25,
                    help="operators per profile table")
    print(json.dumps(run(ap.parse_args(argv))))


if __name__ == "__main__":
    main()
