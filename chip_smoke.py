#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py [--parent DIR]

Phases, each of which fails the run (non-zero exit) on any error:

1. Environment and build: the card's name and power limit, the torch and
   CUDA versions, and the build of the CUDA kernel library from
   ``src/repro_torch/kernels/csrc`` (timed).
2. Each Hopper kernel against its plain PyTorch version on the card, at
   the shapes its path gives it, in bf16 and fp32, with the tolerance
   stated; each kernel's time beside its bound and beside the plain
   version's time, and, for the contiguous decode attention, beside one
   ``scaled_dot_product_attention`` call on the same inputs (the port
   never calls it). The shipped genomes, and the baseline genomes; the
   split-KV decode kernels' launch plans (splits, grid) first, and after
   the timings both decode kernels checked for every genome of their
   flags at kv_len 0, 1, the cache's rows and each split boundary +- 1,
   three times (eager, then replayed in CUDA graphs), at a bf16
   tolerance that must also flag each request's last 64 rows missing.
2b. Shapes: rmsnorm and silu (shipped genomes) at the qwen2 and
   h2o-danube decode and prefill widths and at their two largest suite
   shapes (L2 cold), each beside its bound and the launch floor (the
   library's empty kernel timed alike); the MLP half of a qwen2 decode
   layer (rmsnorm, the gate/up product, silu, the down product) 24 times
   in one CUDA graph; and each baseline genome over its suite, timed as
   Table 2 times it. With ``--parent DIR`` (a checkout of the parent
   commit) the parent's kernels are timed too, each run in its own
   process, in turns parent, change, change, parent.
3. Tune: the Astra agent loop (``optimize_all``, greedy, 5 rounds) on the
   paper's three kernels and both decode attentions (``flash_decode``,
   ``paged_flash_decode``), tested on the card in fp32 and bf16 at the
   JAX suite shapes and timed with CUDA events (L2 flushed before every
   timed launch). It prints each Log, paper Table 2 (baseline vs best,
   both re-timed and re-validated on the card at every suite shape; the
   geomean over the paper's three), the same rows for the two decode
   kernels, and Table 3 (the single-agent baseline timed the same way),
   then reintegrates the best genomes.
3b. Tuned at the shapes: the shipped and the reintegrated rmsnorm and silu
   at every shape of 2b, each held against its plain version at the
   tolerance stated and timed beside the parent's shipped kernel of 2b.
3c. The agent loop in sandboxed workers on the card. (a) Phase 3's search
   again, in two spawn-mode workers (``isolation="process"``, journaled,
   ``keep_going=True``): no kernel may fail, every best genome must
   re-validate on the card, every genome both phases evaluated must have
   the same verdict fields, and no worker may crash, time out, send a
   corrupt result or be quarantined; each best time and the phase's wall
   time are printed beside phase 3's, and the kernels' launches in the
   workers are the ``tune_process`` path. (b) A chaos drill: a beam search
   of ``fused_add_rmsnorm`` (one suite shape, bf16, validated on the card,
   analytic profile) with a worker kill, a hang past the deadline, a
   corrupted result and a victim that kills its worker twice, held to the
   undisturbed thread-path run: one quarantine, three recoveries, the
   same best genome, every other row equal, the wall time under a printed
   bound. (c) ``kill -9`` and resume: this script, started again under a
   hidden flag, runs a journaled greedy search of ``silu_and_mul`` timed
   with CUDA events and SIGKILLs itself after its third eval record; the
   search resumed here from the journal must finish with every journaled
   row replayed bit for bit and only the genomes the journal lacked
   validated and profiled.
4. Serve: ``LLMEngine`` at full width in bf16 with seeded random weights,
   16 greedy requests of 32 tokens each: qwen2-0.5b from the paged pool,
   once with the shipped genomes and once with the reintegrated ones;
   then h2o-danube-1.8b (sliding window 4096) from the contiguous ring
   with the reintegrated ones, four of its prompts crossing the window;
   then qwen2-0.5b again with the reintegrated genomes on an
   oversubscribed pool (48 pages of 16 against the 256 of full
   subscription, swap preemption). Every engine captures its decode step
   as a CUDA graph when it is built and replays it each step (its capture
   time, replays and the mean wall time of a decode step are printed).
   Every request must finish with 32 tokens, ``readbacks == steps ==
   graph_replays``, and each kernel's launch count must be what the path
   and the installed genome imply. The oversubscribed serve must preempt
   at least once, keep the page pool's invariants, release every page
   but the prefix tree's (and none after ``clear_tree``), and give the
   fully subscribed reintegrated serve's streams token for token.
4b. Requests: qwen2-0.5b again (reintegrated genomes). Every other
   request of phase 4's sampled (temperature 0.8, top-k 50, top-p 0.9,
   its own seed) on the paged pool, the contiguous cache (which launches
   ``flash_decode`` with the paged genome's flags and 64-row steps, so
   that both layouts do the same arithmetic whatever the tuner picked)
   and the oversubscribed pool: the sampled streams equal across the
   three, the greedy requests' streams equal phase 4's,
   two captures (the argmax step, then the draw's at the first sampled
   admission), each graph's pool printed. The 16 shared-prefix prompts
   (``launch.serve.shared_prefix_prompts``) with the radix tree and
   without: equal streams, ``prefix_hit_tokens``, ``cow_copies`` and the
   suffix prefills equal to ``SHARED_COUNTS``, and the ttft of each
   request that hit beside its ttft without the tree. Phase 4's requests
   with rid-derived priorities: reorders, and FCFS's streams. Each run
   checks what phase 4 checks, launch counts included (suffix prefills
   launch the norms and silu as whole prefills do).
4c. Lifecycle, chaos and speculative decoding: qwen2-0.5b again
   (reintegrated genomes). Phase 4's requests plus an empty prompt and
   one of max_seq tokens on the oversubscribed pool under a step-indexed
   chaos plan (``chaos_plan``: two aborts, a device fault on slot 1, a
   4-step hold of 5 pages, a corrupt readback on slot 2): the plan fires
   whole, ``aborted`` / ``rejected`` / ``failed`` / ``recoveries`` and the
   prefills equal ``CHAOS_COUNTS`` (the JAX engine's at these settings;
   ``tests/test_torch_chaos.py`` holds the port's CPU run to them), the
   pool check holds after every step
   and every page but the tree's is released at the end, survivors'
   streams equal phase 4's oversubscribed ones and the others are their
   prefixes. A deadline drill: a stall longer than one request's
   deadline, which finishes as ``deadline``. Then phase 4's requests
   decoded speculatively, with the n-gram drafter (k 4), with the model
   drafting for itself (k 3; its contiguous ``flash_decode`` takes the
   paged genome's twin) and with the self-draft on the oversubscribed
   pool: streams equal phase 4's, one captured spec step, ``readbacks ==
   steps == graph_replays``, and each run's spec numbers (capture time
   and graph pool, accepted tokens a step, draft tokens, acceptance, the
   step's wall time, tok_s) beside phase 4's. Each run checks what phase
   4 checks, launch counts included (a spec step runs the target k + 1
   times and, for the draft model, the draft k + 1 times; every
   admission's prefill runs the draft's prefill too).
5. Reference: on the reduced qwen2 and h2o-danube configs in fp32, the
   port's logits (the h2o ones past the window and after the ring wraps)
   and greedy streams on the card agree with its plain versions on the
   CPU.

``--time-serve SRC ARCH`` runs no phase: it serves phase 4's fully
subscribed workload of ARCH (qwen2-0.5b or h2o-danube-1.8b) with the
package under SRC (this tree's ``src``, or a checkout of the parent
commit), times every engine step on the host, and prints one JSON line:
tok_s, ttft, steps, and the mean wall time of a step that admits nothing
(its decode dispatch and the previous step's readback), so two commits'
engines compare in one call.

The line before the last holds the card's name and power limit; the line
before that one JSON object with one row per kernel; the last line is
``{"ok": true, "device": {...}}``. There is no CPU path: without a GPU
the script exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_S = 3.35e12          # H100 SXM device memory rate
PEAK_OPS_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-4),
       torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}
# the decode attentions in bf16, from their error on the card (their bf16
# rounding of p and of the output; PERF.md): at 3e-2 a step's rows could go
# missing unseen at the h2o shape, where a typical |out| is about 0.02
DECODE = ("flash_decode", "paged_flash_decode")
DECODE_TOL = {**TOL, torch.bfloat16: dict(rtol=1e-2, atol=4e-3)}
EDGE_ROUNDS = 3                # kv_len sweeps of the decode kernels a run
SERVE = dict(arch="qwen2-0.5b", slots=8, max_seq=512, page_size=16,
             requests=16, min_prompt=16, max_prompt=256, max_new=32, seed=0,
             crossing=0)
# two prompts just under the window (decoding crosses it), two past it
SERVE_H2O = dict(SERVE, arch="h2o-danube-1.8b", max_seq=8192,
                 max_prompt=2048, crossing=2)
# 48 pages of 16 rows against 8 slots x 512 rows (256 pages): swap
SERVE_OVER = dict(SERVE, num_pages=48, preemption="swap")
# phase 4's requests, every other one sampled with its own seed
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.9)
# the shared-prefix workload (launch.serve.shared_prefix_prompts) at the
# serve settings, with the tree and without it
SERVE_SHARED = dict(SERVE, requests=16)
# what its tree serves: they depend on the prompts, pages, slots, max_seq
# and max_new only, not on the width (tests/test_torch_prefix_cache.py
# holds them equal to the JAX engine's at the reduced width)
SHARED_COUNTS = {"prefix_hit_tokens": 2192, "cow_copies": 1,
                 "suffix_prefills": 15}
# the chaos serve's outcomes: they depend on the prompts' lengths, pages,
# slots, max_seq, max_new and the plan only: the JAX engine's at the
# reduced width (tests/test_torch_chaos.py holds the port's CPU run to them)
CHAOS_COUNTS = {"aborted": 2, "rejected": 2, "failed": 2, "recoveries": 1,
                "prefills": 16}
# the deadline drill: a stall at step 3 longer than request 1's deadline
DEADLINE_STALL_S, DEADLINE_S = 0.5, 0.2


def log(*args):
    print(*args, flush=True)


def device_ms(fn, reps: int = 50, rounds: int = 5) -> float:
    """Median device time of one call of ``fn``: ``reps`` calls captured
    in a CUDA graph, replayed ``rounds`` times between CUDA events (host
    launch overhead excluded; inputs stay in L2 between calls)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def randn(shape, dtype, seed, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    return torch.tensor(x, dtype=torch.float32).to("cuda", dtype)


def compare(got, want, tols=TOL):
    """(max abs error, max rel error, within tolerance, the least atol that
    would pass at the rtol) at the tolerance of ``want``'s dtype in
    ``tols``; non-finite entries (the merge's -inf scores) must match
    exactly and are left out of the errors."""
    tol = tols[want.dtype]
    got, want = got.float(), want.float()
    fin = torch.isfinite(want)
    same = bool((got[~fin] == want[~fin]).all())
    got, want = got[fin], want[fin]
    err = (got - want).abs()
    ok = same and bool((err <= tol["atol"] + tol["rtol"] * want.abs()).all())
    rel = float((err / want.abs().clamp(min=1e-6)).max())
    need = float((err - tol["rtol"] * want.abs()).max())
    return float(err.max()), rel, ok, need


def paged_inputs(b, hq, hkv, dh, page, n_pt, dtype, seed=0):
    """Pools, a shuffled page table whose tail past kv_len points at trap
    page 0, and ragged lengths including 1 and an exact page multiple."""
    rng = np.random.default_rng(seed)
    n_pages = b * n_pt + 1
    lens = rng.integers(1, n_pt * page + 1, size=b)
    lens[0], lens[1] = 1, 4 * page
    perm = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((b, n_pt), np.int32)
    for i in range(b):
        used = -(-int(lens[i]) // page)
        table[i, :used] = perm[i * n_pt:i * n_pt + used]
    return (randn((b, hq, dh), dtype, seed + 1),
            randn((n_pages, page, hkv, dh), dtype, seed + 2),
            randn((n_pages, page, hkv, dh), dtype, seed + 3),
            torch.tensor(table, device="cuda"),
            torch.tensor(lens, dtype=torch.int32, device="cuda"))


def flash_inputs(b, hq, hkv, dh, s, lens, dtype, seed=0):
    """q, a contiguous [b, s, hkv, dh] cache and int32 kv_len."""
    return (randn((b, hq, dh), dtype, seed + 1),
            randn((b, s, hkv, dh), dtype, seed + 2),
            randn((b, s, hkv, dh), dtype, seed + 3),
            torch.tensor(lens, dtype=torch.int32, device="cuda"))


def sdpa(q, k, v, kv_len):
    """The library yardstick: one scaled_dot_product_attention call on
    the decode inputs (views, and a mask made once)."""
    mask = (torch.arange(k.shape[1], device=k.device)[None, :]
            < kv_len[:, None])[:, None, None, :]
    q4, k4, v4 = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask, enable_gqa=True)[:, :, 0]


def merge_inputs(shape, dtype, seed=0):
    """The tune suite's merge inputs (5% of s_b at -inf), plus a row with
    one side empty and a row with both sides empty."""
    from repro_torch.kernels import merge_attn_states
    va, sa, vb, sb = merge_attn_states.make_inputs(
        shape, dtype=dtype, seed=seed, device="cuda").args
    sa[0, :2] = float("-inf")
    sa[1, 0] = sb[1, 0] = float("-inf")
    return va, sa, vb, sb


def kernel_cases():
    """(kernel, label, dtype, kernel call, plain call, bytes, ops,
    l2_cold, main, library call or None): ``main`` marks the kernel-table
    row (bf16, the shipped genome, the decode shape; for the merge, which
    the tune phase drives, the largest suite shape)."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import fused_add_rmsnorm as rms
    from repro_torch.kernels import merge_attn_states as merge
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import silu_and_mul as silu
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        es = torch.tensor([], dtype=dtype).element_size()
        for rows in (1, 8, 256):
            d = 896
            x, r = randn((rows, d), dtype, 1), randn((rows, d), dtype, 2)
            w = randn((d,), torch.float32, 3) * 0.1 + 1.0
            cases.append(("fused_add_rmsnorm", f"rows={rows} d={d}", dtype,
                          lambda x=x, r=r, w=w: ops.fused_add_rmsnorm(x, r, w),
                          lambda x=x, r=r, w=w: ref.fused_add_rmsnorm(x, r, w),
                          4 * rows * d * es + 4 * d, 6 * rows * d, False,
                          rows == 8, None))
            if rows == 8:
                g = rms.BASELINE
                cases.append((
                    "fused_add_rmsnorm", f"rows={rows} d={d} {g.describe()}",
                    dtype,
                    lambda x=x, r=r, w=w, g=g:
                        rms.fused_add_rmsnorm(x, r, w, 1e-6, g),
                    lambda x=x, r=r, w=w, g=g: rms.plain(g, x, r, w),
                    4 * rows * d * es + 4 * d, 6 * rows * d, False, False,
                    None))
        for rows in (1, 8, 256):
            d = 4864
            x = randn((rows, 2 * d), dtype, 4, scale=3.0)
            cases.append(("silu_and_mul", f"rows={rows} d={d}", dtype,
                          lambda x=x: ops.silu_and_mul(x),
                          lambda x=x: ref.silu_and_mul(x),
                          3 * rows * d * es, 6 * rows * d, False, rows == 8,
                          None))
            if rows == 8:
                g = silu.BASELINE
                cases.append((
                    "silu_and_mul", f"rows={rows} d={d} {g.describe()}",
                    dtype, lambda x=x, g=g: silu.silu_and_mul(x, g),
                    lambda x=x, g=g: silu.plain(g, x),
                    3 * rows * d * es, 6 * rows * d, False, False, None))
        for hq, hkv, dh in ((14, 2, 64), (32, 8, 128)):
            b, page, n_pt = 8, 16, SERVE["max_seq"] // 16
            q, k, v, table, lens = paged_inputs(b, hq, hkv, dh, page, n_pt,
                                                dtype)
            rows = int(lens.sum())
            n_tab = int(sum(-(-int(n) // page) for n in lens))
            nbytes = (2 * b * hq * dh * es + 2 * rows * hkv * dh * es
                      + 4 * n_tab + 4 * b)
            for g in (ops.get_variant("paged_flash_decode"),
                      fd.PAGED_BASELINE):
                cases.append((
                    "paged_flash_decode",
                    f"b={b} hq/hkv={hq}/{hkv} d={dh} page={page} "
                    f"kv_len={lens.tolist()} {g.describe()}", dtype,
                    lambda q=q, k=k, v=v, t=table, n=lens, g=g:
                        fd.paged_flash_decode_attention(q, k, v, t,
                                                        kv_len=n, variant=g),
                    lambda q=q, k=k, v=v, t=table, n=lens, g=g:
                        fd.paged_plain(g, q, k, v, t, n,
                                       q.shape[-1] ** -0.5),
                    nbytes, 4 * rows * hq * dh, False,
                    hq == 14 and g is not fd.PAGED_BASELINE, None))
        # the h2o-danube decode shape (a full 4096-row ring) and qwen2's
        # shape on a contiguous 512-row cache (ragged lengths)
        for b, hq, hkv, dh, s, lens in (
                (8, 32, 8, 80, 4096, [4096] * 8),
                (8, 14, 2, 64, 512, [1, 64, 511, 512, 200, 33, 300, 97])):
            q, k, v, n = flash_inputs(b, hq, hkv, dh, s, lens, dtype)
            rows = sum(lens)
            nbytes = 2 * b * hq * dh * es + 2 * rows * hkv * dh * es + 4 * b
            for g in (ops.get_variant("flash_decode"), fd.BASELINE):
                cases.append((
                    "flash_decode",
                    f"b={b} hq/hkv={hq}/{hkv} d={dh} s={s} "
                    f"kv_len={lens if len(set(lens)) > 1 else lens[0]} "
                    f"{g.describe()}", dtype,
                    lambda a=(q, k, v), n=n, g=g:
                        fd.flash_decode_attention(*a, kv_len=n, variant=g),
                    lambda a=(q, k, v), n=n, g=g:
                        fd.plain(g, *a, n, a[0].shape[-1] ** -0.5),
                    nbytes, 4 * rows * hq * dh, False,
                    hq == 32 and g is not fd.BASELINE,
                    sdpa(q, k, v, n) if g is not fd.BASELINE else None))
        for shape in ({"seq": 512, "heads": 32, "head_dim": 256},
                      {"seq": 768, "heads": 32, "head_dim": 256},
                      {"seq": 100, "heads": 7, "head_dim": 128}):
            if dtype == torch.float32 and shape["seq"] == 768:
                continue
            va, sa, vb, sb = merge_inputs(shape, dtype)
            n, d = shape["seq"] * shape["heads"], shape["head_dim"]
            for g in (merge.OPTIMIZED, merge.BASELINE):
                cases.append((
                    "merge_attn_states_lse",
                    f"[{shape['seq']},{shape['heads']},{d}] {g.describe()}",
                    dtype,
                    lambda a=(va, sa, vb, sb), g=g:
                        merge.merge_attn_states_lse(*a, g),
                    lambda a=(va, sa, vb, sb), g=g: merge.plain(g, *a),
                    3 * n * d * es + 12 * n, 3 * n * d, True,
                    n == 768 * 32 and g is merge.OPTIMIZED, None))
    return cases


SOURCES = {
    "fused_add_rmsnorm": ("src/repro_torch/kernels/csrc/fused_add_rmsnorm.cu",
                          "src/repro/kernels/fused_add_rmsnorm.py:102"),
    "silu_and_mul": ("src/repro_torch/kernels/csrc/silu_and_mul.cu",
                     "src/repro/kernels/silu_and_mul.py:102"),
    "paged_flash_decode": ("src/repro_torch/kernels/csrc/paged_decode.cu",
                           "src/repro/kernels/flash_decode.py:390"),
    "merge_attn_states_lse": (
        "src/repro_torch/kernels/csrc/merge_attn_states.cu",
        "src/repro/kernels/merge_attn_states.py:122"),
    "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode.py:150"),
}
REPS_COLD = 100
CHAIN_LAYERS = 24
CHAIN_LABEL = (f"qwen2 decode MLP half x {CHAIN_LAYERS} layers (rmsnorm, "
               "gate/up, silu, down; 8 rows bf16) in one graph")


def cold_ms(fn) -> float:
    """Median device time of one call with L2 flushed (a 64 MB read)
    before it: the profiling agent's method."""
    from repro_torch.core.agents import time_launches
    return float(np.median(time_launches(fn, REPS_COLD))) / 1e3

# The redesign's shapes for rmsnorm and silu (kernel, rows, d, dtype, weight
# dtype, L2 cold): qwen2 and h2o-danube decode and the h2o prefill at their
# widths, timed as 50 launches in a graph; the two largest suite shapes of
# each kernel in both dtypes, single launches after a 64 MB read (the
# profiling agent's method; the suite's weight in the test's dtype)
BF16, F32 = torch.bfloat16, torch.float32
SHAPES = (
    ("fused_add_rmsnorm", 8, 896, BF16, F32, False),
    ("fused_add_rmsnorm", 8, 2560, BF16, F32, False),
    ("fused_add_rmsnorm", 4096, 2560, BF16, F32, False),
    ("fused_add_rmsnorm", 1024, 4096, F32, F32, True),
    ("fused_add_rmsnorm", 1024, 4096, BF16, BF16, True),
    ("fused_add_rmsnorm", 512, 14336, F32, F32, True),
    ("fused_add_rmsnorm", 512, 14336, BF16, BF16, True),
    ("silu_and_mul", 8, 4864, BF16, None, False),
    ("silu_and_mul", 8, 6912, BF16, None, False),
    ("silu_and_mul", 4096, 6912, BF16, None, False),
    ("silu_and_mul", 64, 8192, F32, None, True),
    ("silu_and_mul", 64, 8192, BF16, None, True),
    ("silu_and_mul", 16, 12288, F32, None, True),
    ("silu_and_mul", 16, 12288, BF16, None, True),
)


def shape_label(kernel, rows, d, dtype, wdtype, cold) -> str:
    w = f" w {str(wdtype)[6:]}" if wdtype is not None else ""
    return (f"{kernel} [{rows}, {d}] {str(dtype)[6:]}{w}"
            f"{' L2 cold' if cold else ''}")


def shape_bytes(kernel, rows, d, dtype, wdtype) -> int:
    """Bytes the call must move: each input read once, each output written
    once (rmsnorm: x, r in, y, r' out, and w; silu: [rows, 2d] in, [rows,
    d] out)."""
    if kernel == "silu_and_mul":
        return 3 * rows * d * dtype.itemsize
    return 4 * rows * d * dtype.itemsize + d * wdtype.itemsize


def shape_args(kernel, rows, d, dtype, wdtype) -> tuple:
    """The inputs of a ``SHAPES`` row on the card, from fixed seeds."""
    if kernel == "silu_and_mul":
        return (randn((rows, 2 * d), dtype, 4, scale=3.0),)
    x, r = randn((rows, d), dtype, 1), randn((rows, d), dtype, 2)
    return x, r, (randn((d,), F32, 3) * 0.1 + 1.0).to(wdtype)


def shape_call(kernel, args, genome):
    """The wrapper's call on ``args`` with ``genome``: public wrapper calls
    only, so the parent commit's package runs it too."""
    from repro_torch.kernels import fused_add_rmsnorm as rms
    from repro_torch.kernels import silu_and_mul as silu
    if kernel == "silu_and_mul":
        return functools.partial(silu.silu_and_mul, *args, genome)
    return functools.partial(rms.fused_add_rmsnorm, *args, 1e-6, genome)


def suite_baseline_us(kernel) -> float:
    """The baseline genome's geomean over its suite (both dtypes), timed
    as Table 2 times it: single launches, L2 flushed, median of 100."""
    from repro_torch.core import ProfilingAgent, TestingAgent
    from repro_torch.kernels.registry import get_space, suite_tests
    space = get_space(kernel)
    tests = suite_tests(space, TestingAgent())
    return ProfilingAgent(backend="cuda").profile(
        space, space.baseline, tests).geomean_latency_us


def time_shapes() -> list:
    """Each of ``SHAPES`` through the shipped genomes, the decode chain,
    and each baseline over its suite, with the ``repro_torch`` on
    ``sys.path``: [{label, us}]."""
    from repro_torch.kernels import ops
    out = []
    for spec in SHAPES:
        timer = cold_ms if spec[5] else device_ms
        call = shape_call(spec[0], shape_args(*spec[:5]),
                          ops.get_variant(spec[0]))
        out.append({"label": shape_label(*spec), "us": timer(call) * 1e3})
    out.append({"label": CHAIN_LABEL, "us": device_ms(
        decode_chain(), reps=1, rounds=20) * 1e3})
    for kernel in ("fused_add_rmsnorm", "silu_and_mul"):
        out.append({"label": f"{kernel} baseline genome, Table 2 geomean "
                             "over its suite", "us": suite_baseline_us(kernel)})
    return out


def floor_us(cold: bool) -> float:
    """The library's empty kernel, timed as a row of ``SHAPES`` is."""
    from repro_torch.kernels import _build
    lib = _build.library()
    dev = torch.device("cuda")
    timer = cold_ms if cold else device_ms
    return timer(lambda: _build.check(lib, lib.repro_empty(
        _build.stream_ptr(dev)), "empty")) * 1e3


def _shapes_in(src: str) -> list:
    """``time_shapes`` in a fresh process on the package under ``src``."""
    import subprocess
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--time-shapes", src],
        capture_output=True, text=True, timeout=900)
    if proc.returncode:
        raise RuntimeError(f"time-shapes on {src} failed:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def phase_shapes(parent: str | None) -> dict:
    """``time_shapes``: the change's times beside each row's bound and the
    launch floor; with ``parent`` (a checkout of the parent commit) the
    parent's times too, in turns parent, change, change, parent, each in
    its own process. Returns the parent's times by label."""
    own = os.path.join(ROOT, "src")
    theirs = os.path.join(parent, "src") if parent else None
    order = [("parent", theirs), ("change", own), ("change", own),
             ("parent", theirs)] if parent else [("change", None)]
    runs = {"parent": [], "change": []}
    for who, src in order:
        runs[who].append(_shapes_in(src) if src else time_shapes())
    floors = {cold: floor_us(cold) for cold in (False, True)}
    log(f"  launch floor (the empty kernel): {floors[False]:.2f} us in a "
        f"graph, {floors[True]:.2f} us single after a 64 MB read")
    for i, row in enumerate(runs["change"][0]):
        spec = SHAPES[i] if i < len(SHAPES) else None
        mine = [r[i]["us"] for r in runs["change"]]
        text = (f"  {row['label']}: change "
                + " / ".join(f"{t:.2f}" for t in mine) + " us")
        if parent:
            text += ", parent " + " / ".join(
                f"{r[i]['us']:.2f}" for r in runs["parent"]) + " us"
        if spec is not None:
            kernel, rows, d, dtype, wdtype, cold = spec
            bound = shape_bytes(kernel, rows, d, dtype, wdtype) \
                / HBM_BYTES_S * 1e6
            text += (f"; bound {bound:.3f} us (bytes), {bound / min(mine):.1%}"
                     f" of it; floor {floors[cold]:.2f} us")
        log(text)
    return {r["label"]: [p[i]["us"] for p in runs["parent"]]
            for i, r in enumerate(runs["change"][0])}


def phase_tuned_shapes(parent: dict) -> bool:
    """The shipped and the reintegrated rmsnorm and silu at every shape of
    ``SHAPES``: each held against its plain version at ``TOL``, then timed
    as the shapes phase times it, beside the parent's shipped kernel
    there (``parent``: its times by label)."""
    from repro_torch.kernels import fused_add_rmsnorm as rms
    from repro_torch.kernels import ops
    from repro_torch.kernels import silu_and_mul as silu
    from repro_torch.kernels.registry import get_space
    ok = True
    for spec in SHAPES:
        kernel, cold = spec[0], spec[5]
        args = shape_args(*spec[:5])
        timer = cold_ms if cold else device_ms
        text = []
        for who, g in (("shipped", get_space(kernel).shipped),
                       ("reintegrated", ops.get_variant(kernel))):
            got = shape_call(kernel, args, g)()
            want = silu.plain(g, *args) if kernel == "silu_and_mul" \
                else rms.plain(g, *args, 1e-6)
            errs = [compare(a, b) for a, b in zip(got, want)] \
                if isinstance(got, tuple) else [compare(got, want)]
            good = all(e[2] for e in errs)
            ok &= good
            text.append(f"{who} {timer(shape_call(kernel, args, g)) * 1e3:.2f}"
                        f" us (max_abs {max(e[0] for e in errs):.3e} "
                        f"{'ok' if good else 'MISMATCH'})")
        label = shape_label(*spec)
        if parent.get(label):
            text.append("parent shipped " + " / ".join(
                f"{t:.2f}" for t in parent[label]) + " us")
        log(f"  {label}: " + "; ".join(text))
    return ok


def decode_plans():
    """The launch plan (splits, steps a split, grid, shared memory) of each
    decode-attention call the kernel phase times."""
    from repro_torch.kernels import flash_decode as fd
    for dtype in (torch.bfloat16, torch.float32):
        for hq, hkv, dh in ((14, 2, 64), (32, 8, 128)):
            plan = fd.paged_launch_plan(batch=8, q_heads=hq, kv_heads=hkv,
                                        head_dim=dh, page=16,
                                        n_pt=SERVE["max_seq"] // 16,
                                        dtype=dtype)
            log(f"  plan paged_flash_decode {str(dtype)[6:]} {hq}/{hkv} "
                f"d={dh}: splits {plan['splits']} x "
                f"{plan['steps_per_split']} steps of {fd.PAGED_STEP} rows, "
                f"grid {plan['grid']}, {plan['smem']} B shared")
        for b, hq, hkv, dh, s in ((8, 32, 8, 80, 4096), (8, 14, 2, 64, 512)):
            for g in (fd.OPTIMIZED, fd.BASELINE):
                plan = fd.launch_plan(g, batch=b, q_heads=hq, kv_heads=hkv,
                                      head_dim=dh, seq=s, dtype=dtype)
                log(f"  plan flash_decode {str(dtype)[6:]} {hq}/{hkv} d={dh}"
                    f" s={s} {g.name}: splits {plan['splits']} x "
                    f"{plan['steps_per_split']} chunks of {plan['chunk']}, "
                    f"grid {plan['grid']}, {plan['smem']} B shared")


def _edges(plan, rows, step):
    """kv_len 0, 1, the rows and every split boundary - 1, + 0, + 1."""
    per = plan["steps_per_split"] * step
    edges = {0, 1, rows}
    for sp in range(1, plan["splits"]):
        edges.update((sp * per - 1, sp * per, sp * per + 1))
    return sorted(e for e in edges if 0 <= e <= rows)


def _edge_cases():
    """(kernel, dtype, label, kv_len tensor, the kernel-table row's
    lengths, [kv_len batches], call(genome flags), plain(genome flags)) of
    the serve shapes: contiguous h2o and qwen2, paged 14/2 and 32/8.
    Inputs are made once; a batch of lengths is copied into the kv_len
    tensor before its calls."""
    from repro_torch.kernels import flash_decode as fd
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for b, hq, hkv, dh, s in ((8, 32, 8, 80, 4096), (8, 14, 2, 64, 512)):
            plan = fd.launch_plan(fd.OPTIMIZED, batch=b, q_heads=hq,
                                  kv_heads=hkv, head_dim=dh, seq=s,
                                  dtype=dtype)
            lens = _edges(plan, s, plan["chunk"])
            q, k, v, n_ = flash_inputs(b, hq, hkv, dh, s, [s] * b, dtype)
            cases.append((
                "flash_decode", dtype, f"{hq}/{hkv} s={s}", n_, [s] * b,
                [(lens[i:i + b] + [s] * b)[:b]
                 for i in range(0, len(lens), b)],
                lambda g, a=(q, k, v), n=n_: fd.flash_decode_attention(
                    *a, kv_len=n, variant=dataclasses.replace(
                        fd.OPTIMIZED, **g)),
                lambda g, a=(q, k, v), n=n_: fd.plain(
                    dataclasses.replace(fd.OPTIMIZED, **g), *a, n,
                    a[0].shape[-1] ** -0.5)))
        for hq, hkv, dh in ((14, 2, 64), (32, 8, 128)):
            b, page, n_pt = 8, 16, SERVE["max_seq"] // 16
            plan = fd.paged_launch_plan(batch=b, q_heads=hq, kv_heads=hkv,
                                        head_dim=dh, page=page, n_pt=n_pt,
                                        dtype=dtype)
            rows = n_pt * page
            lens = _edges(plan, rows, fd.PAGED_STEP)
            q, k, v, table, n_ = paged_inputs(b, hq, hkv, dh, page, n_pt,
                                              dtype)
            cases.append((
                "paged_flash_decode", dtype, f"{hq}/{hkv} rows={rows}", n_,
                n_.tolist(),
                [(lens[i:i + b] + [rows] * b)[:b]
                 for i in range(0, len(lens), b)],
                lambda g, a=(q, k, v, table), n=n_:
                    fd.paged_flash_decode_attention(
                        *a, kv_len=n, variant=dataclasses.replace(
                            fd.PAGED_OPTIMIZED, **g)),
                lambda g, a=(q, k, v, table), n=n_: fd.paged_plain(
                    dataclasses.replace(fd.PAGED_OPTIMIZED, **g), *a, n,
                    a[0].shape[-1] ** -0.5)))
    return cases


def _replayed(call, g):
    """``call(g)`` captured once in a CUDA graph: each call of the result
    replays it (reading the kv_len tensor anew) and returns its output."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call(g)

    def run():
        graph.replay()
        return out
    return run


def phase_edges() -> bool:
    """Both split-KV kernels against their plain versions, every genome of
    their flags, both dtypes, at kv_len 0, 1, the cache's rows and each
    split boundary +- 1 of the serve shapes (checked, not timed). The
    sweep runs ``EDGE_ROUNDS`` times in this process: eager calls, then
    each call captured once in a CUDA graph and replayed for every batch
    of lengths. Then the bf16 tolerance must see a fault: each request's
    last 64 rows dropped."""
    import itertools
    ok = True
    flags = [dict(mask_oob=mo, use_reciprocal=r)
             for mo, r in itertools.product((False, True), repeat=2)]
    cases = _edge_cases()
    need = {}                        # (kernel, dtype) -> worst atol needed
    for rnd in range(EDGE_ROUNDS):
        n, bad = 0, 0
        for name, dtype, label, n_, _, batches, call, plain in cases:
            for g in flags:
                run = _replayed(call, g) if rnd else functools.partial(
                    call, g)
                for part in batches:
                    n_.copy_(torch.tensor(part, dtype=torch.int32))
                    err = compare(run(), plain(g), DECODE_TOL)
                    key = (name, str(dtype)[6:])
                    need[key] = max(need.get(key, -1.0), err[3])
                    n += 1
                    if not err[2]:
                        bad += 1
                        log(f"  MISMATCH round {rnd} {name} {dtype} {label} "
                            f"kv_len={part} {g}: max_abs={err[0]:.3e}")
        torch.cuda.synchronize()
        log(f"  kv_len edges, round {rnd + 1} of {EDGE_ROUNDS} "
            f"({'graph replays' if rnd else 'eager calls'}): {n} calls "
            f"over every genome's flags, {bad} mismatches")
        ok &= bad == 0
    for (name, dt), v in sorted(need.items()):
        tol = DECODE_TOL[getattr(torch, dt)]
        log(f"  {name} {dt}: least atol that passes at rtol {tol['rtol']}: "
            f"{v:.3e} (tolerance atol {tol['atol']})")
    # the fault: the plain version with each request's last step missing,
    # held against the sound plain version at the shipped genome
    for name, dtype, label, n_, full, _, call, plain in cases:
        if dtype != torch.bfloat16:
            continue
        n_.copy_(torch.tensor(full, dtype=torch.int32))
        g = dict(mask_oob=True, use_reciprocal=True)
        want = plain(g)
        sound = compare(call(g), want, DECODE_TOL)
        n_.copy_(torch.tensor([max(0, x - 64) for x in full],
                              dtype=torch.int32))
        fault = compare(plain(g), want, DECODE_TOL)
        seen = not fault[2]
        ok &= seen and sound[2]
        log(f"  fault check {name} bf16 {label} kv_len={full}: sound "
            f"max_abs={sound[0]:.3e}, last 64 rows dropped "
            f"max_abs={fault[0]:.3e} "
            f"{'caught' if seen else 'NOT CAUGHT'} at atol "
            f"{DECODE_TOL[dtype]['atol']} rtol {DECODE_TOL[dtype]['rtol']}")
    return ok


def phase_kernels(rows_out: dict) -> bool:
    ok = True
    decode_plans()
    for name, label, dtype, kern, plain, nbytes, nops, l2_cold, main, \
            library in kernel_cases():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        tols = DECODE_TOL if name in DECODE else TOL
        if isinstance(got, tuple):
            errs = [compare(g, w, tols) for g, w in zip(got, want)]
            err = max(e[0] for e in errs), max(e[1] for e in errs), \
                all(e[2] for e in errs)
        else:
            err = compare(got, want, tols)
        timer = cold_ms if l2_cold else device_ms
        ms, plain_ms = timer(kern), timer(plain)
        lib_ms = timer(library) if library is not None else None
        bound_ms = max(nbytes / HBM_BYTES_S, nops / PEAK_OPS_S[dtype]) * 1e3
        tol = tols[dtype]
        log(f"  {name:20s} {str(dtype)[6:]:8s} {label}: max_abs={err[0]:.3e}"
            f" max_rel={err[1]:.3e} (tol rtol={tol['rtol']} "
            f"atol={tol['atol']}) {'ok' if err[2] else 'MISMATCH'}; "
            f"kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, "
            + (f"sdpa {lib_ms * 1e3:.2f} us, " if lib_ms is not None
               else "")
            + f"bound {bound_ms * 1e3:.3f} us (bytes)"
            f"{', L2 cold' if l2_cold else ''}")
        ok &= err[2]
        if main and dtype == torch.bfloat16:
            src, replaces = SOURCES[name]
            rows_out[name] = {
                "name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": None,
                "max_abs_err": err[0], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": "bytes",
                "library_ms": lib_ms, "shape": label,
                "timing": ("single launch after a 64 MB read, median of "
                           f"{REPS_COLD}") if l2_cold
                else "50 launches in a CUDA graph, L2 warm, median of 5"}
    return ok


def decode_chain(layers: int = CHAIN_LAYERS):
    """The MLP half of a qwen2-0.5b decode layer (8 rows, bf16), ``layers``
    times: rmsnorm (fp32 weight, as served), the gate/up product, silu, the
    down product; each layer's output and r' feed the next. The shipped
    genomes. Returns a function that runs the chain and returns (h, r')."""
    from repro_torch import configs
    from repro_torch.kernels import fused_add_rmsnorm as rms
    from repro_torch.kernels import ops
    from repro_torch.kernels import silu_and_mul as silu
    cfg = configs.get("qwen2-0.5b")
    d, d_ff = cfg.d_model, cfg.d_ff
    x, r = randn((8, d), BF16, 1), randn((8, d), BF16, 2)
    w = randn((d,), F32, 3) * 0.1 + 1.0
    w_gu = randn((2 * d_ff, d), BF16, 5, scale=d ** -0.5)
    w_down = randn((d, d_ff), BF16, 6, scale=d_ff ** -0.5)
    g_rms, g_silu = (ops.get_variant("fused_add_rmsnorm"),
                     ops.get_variant("silu_and_mul"))

    def run():
        h, res = x, r
        for _ in range(layers):
            y, res = rms.fused_add_rmsnorm(h, res, w, 1e-6, g_rms)
            h = silu.silu_and_mul(y @ w_gu.T, g_silu) @ w_down.T
        return h, res
    return run


TUNE_ROUNDS = 5


def tune_kernels() -> tuple:
    """The kernels phases 3 and 3c tune: the paper's three and both decode
    attentions."""
    from repro_torch.search import PAPER_KERNELS
    return PAPER_KERNELS + ("flash_decode", "paged_flash_decode")


def phase_tune() -> tuple[bool, dict, dict, dict]:
    """The agent loop on the card; returns (ok, launch counts of the loop,
    {kernel: Log}, {"cache": its EvalCache, "wall_s": its time}), with the
    best genomes reintegrated."""
    from repro_torch.core import (ProfilingAgent, TestingAgent,
                                  optimize_single_agent, reintegrate)
    from repro_torch.kernels import ops
    from repro_torch.kernels.registry import get_space, suite_tests
    from repro_torch.search import PAPER_KERNELS, EvalCache, optimize_all

    rounds = TUNE_ROUNDS
    testing = TestingAgent()
    profiling = ProfilingAgent(backend="cuda")
    cache = EvalCache()
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    results = optimize_all(rounds=rounds, testing=testing,
                           profiling=profiling, cache=cache,
                           kernels=tune_kernels())
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    wall = time.perf_counter() - t0
    log(f"  optimize_all(rounds={rounds}, greedy): {wall:.1f} s; launches "
        f"{counts}")
    ok = True
    for name, lg in results.items():
        log(f"  -- {name} ({len(lg.entries)} entries, cache "
            f"{lg.meta['cache']}, stages {lg.meta['stages']})")
        log(lg.table())
        if len(lg.entries) != rounds + 1:
            log(f"  FAIL {name}: {len(lg.entries)} log entries, want "
                f"{rounds + 1}")
            ok = False
        if not lg.best().correct:
            log(f"  FAIL {name}: best entry not correct")
            ok = False
    hifi = ProfilingAgent(backend="cuda")
    t2, t3 = [], []
    for i, (name, lg) in enumerate(results.items(), 1):
        space = get_space(name)
        tests = suite_tests(space, testing)
        base = hifi.profile(space, space.baseline, tests).geomean_latency_us
        # the loop profiles its baseline without validating it: Table 2
        # divides by its time, so it is held to the suite here
        base_ok, base_err = testing.validate(space, space.baseline, tests)
        best = lg.best().code
        opt = hifi.profile(space, best, tests).geomean_latency_us
        good, err = testing.validate(space, best, tests)
        ok &= good and base_ok
        t2.append((name, f"K{i}" if name in PAPER_KERNELS else "  ", base,
                   opt, good, err, best.describe(), base_ok, base_err))
        if name not in PAPER_KERNELS:
            continue
        sa = optimize_single_agent(name, rounds=rounds)
        sa_lat = hifi.profile(space, sa.final_variant,
                              tests).geomean_latency_us
        sa_ok, _ = testing.validate(space, sa.final_variant, tests)
        t3.append((name, base, base / sa_lat, base / opt, sa_ok,
                   sa.final_variant.describe()))
    log("  Table 2: baseline vs Astra-optimized, geomean over the suite "
        "(us, single launches, L2 flushed)")
    for name, k, base, opt, good, err, genome, base_ok, base_err in t2:
        log(f"    {k} {name}: baseline {base:.2f} us (correct {base_ok}, "
            f"max_err {base_err:.3f}), best {opt:.2f} us, speedup "
            f"{base / opt:.3f}x, correct {good} (max_err {err:.3f}), best "
            f"genome {genome}")
        if not good:
            log(f"  FAIL {name}: best genome fails re-validation on the card")
        if not base_ok:
            log(f"  FAIL {name}: baseline genome fails validation on the "
                "card")
    geo = float(np.exp(np.mean([np.log(r[2] / r[3]) for r in t2
                                 if r[0] in PAPER_KERNELS])))
    log(f"    geomean speedup over the paper's three {geo:.3f}x")
    log("  Table 3: single agent vs multi agent (speedup over baseline)")
    for name, base, sa, ma, sa_ok, genome in t3:
        log(f"    {name}: baseline {base:.2f} us, SA {sa:.3f}x (correct "
            f"{sa_ok}, {genome}), MA {ma:.3f}x")
    gs = float(np.exp(np.mean([np.log(r[2]) for r in t3])))
    gm = float(np.exp(np.mean([np.log(r[3]) for r in t3])))
    log(f"    geomean SA {gs:.3f}x MA {gm:.3f}x")
    reintegrate(results)
    log("  reintegrated: " + "; ".join(
        f"{n}={ops.get_variant(n).describe()}" for n in results))
    return ok, counts, results, {"cache": cache, "wall_s": wall}


VERDICT = ("passed", "validated", "screened", "finish_reason", "failed_test",
           "max_err")
INFRA = ("worker_crashes", "eval_timeouts", "corrupt_results", "quarantined")


def phase_process(tuned: dict, tune: dict) -> tuple[bool, dict]:
    """3c (a): phase 3's search in two sandboxed workers on the card,
    journaled, keep-going; returns (ok, the launch counts of the search,
    which the workers made)."""
    import tempfile

    from repro_torch.core import ProfilingAgent, TestingAgent
    from repro_torch.kernels import ops
    from repro_torch.kernels.registry import get_space, suite_tests
    from repro_torch.search import (EvalCache, SearchFailure, SearchJournal,
                                    optimize_all)

    testing = TestingAgent()
    cache = EvalCache()
    with tempfile.TemporaryDirectory() as tmp:
        journals = {k: SearchJournal(os.path.join(tmp, f"{k}.jsonl"))
                    for k in tune_kernels()}
        t0 = time.perf_counter()
        ops.reset_launch_counts()
        results = optimize_all(rounds=TUNE_ROUNDS, testing=testing,
                               profiling=ProfilingAgent(backend="cuda"),
                               cache=cache, kernels=tune_kernels(),
                               isolation="process", workers=2,
                               keep_going=True, journals=journals,
                               pool_config={"deadline_s": 300.0})
        counts = ops.launch_counts()
        wall = time.perf_counter() - t0
    log(f"  optimize_all(rounds={TUNE_ROUNDS}, greedy, isolation=process, "
        f"workers=2): {wall:.1f} s (phase 3: {tune['wall_s']:.1f} s, this "
        f"one's pool start-up included); launches in the workers {counts}")
    ok = True
    for name, lg in results.items():
        if isinstance(lg, SearchFailure):
            log(f"  FAIL {name}: the search failed: {lg.detail}")
            ok = False
            continue
        space = get_space(name)
        good, err = testing.validate(space, lg.best().code,
                                     suite_tests(space, testing))
        infra = {k: lg.meta["stages"][k] for k in INFRA}
        log(f"  {name}: best {lg.best().perf.geomean_latency_us:.2f} us "
            f"(phase 3: {tuned[name].best().perf.geomean_latency_us:.2f} us),"
            f" {len(lg.entries)} entries, best re-validated {good} (max_err "
            f"{err:.3f}), {infra}, journal {lg.meta['journal']}")
        if not good or len(lg.entries) != TUNE_ROUNDS + 1 \
                or any(infra.values()):
            log(f"  FAIL {name}: best not correct, wrong length or infra "
                "faults")
            ok = False
    ref = dict(tune["cache"].items())
    common = [(k, r) for k, r in cache.items() if k in ref]
    differ = [k for k, r in common
              if [getattr(r, f) for f in VERDICT]
              != [getattr(ref[k], f) for f in VERDICT]]
    log(f"  verdicts of the {len(common)} genomes both phases evaluated: "
        f"{len(differ)} differ")
    for k in differ:
        log(f"  FAIL verdict {k}: phase 3 "
            f"{[getattr(ref[k], f) for f in VERDICT]}, 3c "
            f"{[getattr(dict(common)[k], f) for f in VERDICT]}")
    return ok and not differ and bool(common), counts


def _rows(log_):
    return [(e.round, e.code.describe(), bool(e.correct), float(e.max_err),
             dataclasses.asdict(e.perf)) for e in log_.entries]


def phase_chaos() -> bool:
    """3c (b): the chaos drill on the card, against the thread path."""
    from repro_torch.core import ProfilingAgent, TestingAgent
    from repro_torch.kernels.registry import get_space, suite_tests
    from repro_torch.reliability import Fault, SearchChaosInjector
    from repro_torch.search import (EvalCache, EvalWorkerPool,
                                    SearchOrchestrator, TieredEvaluator)

    space = get_space("fused_add_rmsnorm")
    space = dataclasses.replace(space, suite_shapes=space.suite_shapes[:1])

    def roster():
        return dict(testing=TestingAgent(dtypes=(torch.bfloat16,)),
                    profiling=ProfilingAgent(backend="analytic"))
    t0 = time.perf_counter()
    ref = SearchOrchestrator(cache=EvalCache(), workers=2, **roster()).search(
        space, strategy="beam", rounds=2)
    ref_s = time.perf_counter() - t0
    tests = suite_tests(space, roster()["testing"])

    def key(g):
        return EvalCache().key(space.name, g, tests,
                               launch_key=space.launch_key)[1]
    keys = [key(e.code) for e in ref.entries]
    last = max(e.round for e in ref.entries)
    best = ref.best().code
    victims = [e.code for e, k in zip(ref.entries, keys)
               if e.round == last and k != key(best) and keys.count(k) == 1]
    others = [k for k in dict.fromkeys(keys)
              if not victims or k != key(victims[-1])]
    if not victims or len(others) < 3:
        log(f"  FAIL the beam search is too small for the drill "
            f"({len(ref.entries)} rows)")
        return False
    victim = victims[-1]
    deadline, hang, bound = 20.0, 600.0, 240.0
    chaos = SearchChaosInjector([
        Fault("kill_worker", digest=others[0]),
        Fault("hang_eval", digest=others[1], seconds=hang),
        Fault("corrupt_result", digest=others[2]),
        Fault("kill_worker", digest=key(victim), times=2)])
    ev = TieredEvaluator()
    t0 = time.perf_counter()
    with EvalWorkerPool(workers=2, deadline_s=deadline, quarantine_after=2,
                        chaos=chaos, on_stat=ev.bump) as pool:
        got = SearchOrchestrator(cache=EvalCache(), workers=2, evaluator=ev,
                                 isolation="process", pool=pool,
                                 **roster()).search(space, strategy="beam",
                                                    rounds=2)
    wall = time.perf_counter() - t0
    st = got.meta["stages"]
    log(f"  chaos drill: beam rounds=2 workers=2, {len(got.entries)} rows; "
        f"thread path {ref_s:.2f} s, with faults {wall:.1f} s (bound "
        f"{bound:.0f} s; deadline {deadline:.0f} s, hang {hang:.0f} s); "
        f"worker start-ups {[round(x, 2) for x in pool.startups]} s; "
        + ", ".join(f"{k} {st[k]}" for k in (
            "worker_crashes", "eval_timeouts", "corrupt_results", "retries",
            "recoveries", "quarantined")))
    ok = (st["quarantined"] == 1 and st["recoveries"] == 3
          and chaos.exhausted and got.best().code == best and wall < bound
          and len(got.entries) == len(ref.entries))
    for (r, desc, correct, err, prof), want in zip(_rows(got), _rows(ref)):
        if desc == victim.describe() and r == last:
            ok &= not correct and prof == want[4]
        elif (r, desc, correct, err, prof) != want:
            log(f"  FAIL chaos row {r} {desc} differs from the thread path")
            ok = False
    log(f"  chaos drill: quarantined the victim only, the undisturbed best "
        f"kept, other rows equal: {ok}")
    return ok


def journal_child(path: str, kill_after: int) -> None:
    """``--journal-child``: a journaled greedy search of silu_and_mul on the
    card, CUDA-event timed, that SIGKILLs this process right after its
    ``kill_after``-th eval record."""
    import signal

    from repro_torch.core import ProfilingAgent, TestingAgent
    from repro_torch.search import EvalCache, SearchJournal, SearchOrchestrator
    journal = SearchJournal(path)
    record, written = journal.record_eval, [0]

    def record_and_die(key, result):
        record(key, result)
        written[0] += 1
        if written[0] >= kill_after:
            os.kill(os.getpid(), signal.SIGKILL)
    journal.record_eval = record_and_die
    SearchOrchestrator(testing=TestingAgent(),
                       profiling=ProfilingAgent(backend="cuda"),
                       cache=EvalCache()).search(
        "silu_and_mul", rounds=TUNE_ROUNDS, journal=journal)


def phase_resume() -> bool:
    """3c (c): kill -9 a journaled search on the card, resume it here."""
    import subprocess
    import tempfile

    from repro_torch.core import ProfilingAgent, TestingAgent
    from repro_torch.kernels.registry import get_space, suite_tests
    from repro_torch.search import (EvalCache, JournalMismatch, SearchJournal,
                                    SearchOrchestrator)

    kill_after = 3
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "silu_and_mul.jsonl")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--journal-child",
             path, str(kill_after)], capture_output=True, text=True,
            timeout=600)
        child_s = time.perf_counter() - t0
        with open(path) as f:
            recs = [json.loads(line) for line in f if line.strip()]
        journaled = {tuple(r["key"]): r for r in recs if r["type"] == "eval"}
        testing = TestingAgent()
        cache = EvalCache()
        t0 = time.perf_counter()
        try:
            lg = SearchOrchestrator(testing=testing,
                                    profiling=ProfilingAgent(backend="cuda"),
                                    cache=cache).search(
                "silu_and_mul", rounds=TUNE_ROUNDS,
                journal=SearchJournal(path))
        except JournalMismatch as exc:
            log(f"  FAIL the resumed search left its journal: {exc}")
            return False
        resume_s = time.perf_counter() - t0
    space = get_space("silu_and_mul")
    tests = suite_tests(space, testing)
    sd = recs[0]["tests_digest"]
    replayed = 0
    ok = proc.returncode == -9 and kill_after == sum(
        r["type"] == "eval" for r in recs)
    for e in lg.entries:
        k = cache.key(space.name, e.code, tests, tests_digest=sd,
                      launch_key=space.launch_key)
        rec = journaled.get(k)
        if rec is None or (not rec["validated"] and e.round):
            continue
        replayed += 1
        same = (dataclasses.asdict(e.perf) == rec["profile"]
                and bool(e.correct) == rec["passed"]
                and float(e.max_err) == rec["max_err"])
        if not same:
            log(f"  FAIL round {e.round} was not replayed bit for bit")
            ok = False
    settled = dict(cache.items())
    need_profile = [k for k in settled if k not in journaled]
    need_validate = [k for k, r in settled.items() if r.validated and not
                     journaled.get(k, {}).get("validated")]
    st = lg.meta["stages"]
    ran = (st["profile_runs"],
           st["validations_full"] + st["validations_smoke_failed"])
    good, err = testing.validate(space, lg.best().code, tests)
    ok &= (len(lg.entries) == TUNE_ROUNDS + 1 and good
           and lg.meta["journal"]["resumed"]
           and ran == (len(need_profile), len(need_validate)))
    log(f"  kill -9: the child ({child_s:.1f} s) exited {proc.returncode} "
        f"after {len(journaled)} eval records; the resume ({resume_s:.1f} s)"
        f" replayed {replayed} rows bit for bit, profiled {ran[0]} and "
        f"validated {ran[1]} genomes (the journal lacked {len(need_profile)}"
        f" profiles, {len(need_validate)} verdicts), {len(lg.entries)} "
        f"entries, best re-validated {good} (max_err {err:.3f}), journal "
        f"{lg.meta['journal']['resumed']}: {'ok' if ok else 'FAIL'}")
    if proc.returncode != -9:
        log(proc.stdout[-2000:] + proc.stderr[-2000:])
    return ok


_PARAMS: dict = {}


def serve_params(cfg, seed: int):
    """Seeded full-width weights, made once per (arch, seed)."""
    from repro_torch.models import registry
    key = (cfg.name, seed)
    if key not in _PARAMS:
        t0 = time.perf_counter()
        _PARAMS[key] = registry.init_params(cfg, seed=seed)
        torch.cuda.synchronize()
        log(f"  {cfg.name} full width ({cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff "
            f"{cfg.d_ff}, vocab {cfg.padded_vocab}, window {cfg.window}) "
            f"{cfg.dtype}, seeded init {time.perf_counter() - t0:.1f} s")
    return _PARAMS[key]


def phase_serve(label: str, s: dict) -> tuple[bool, dict, list, dict]:
    """Serve ``s["requests"]`` requests of ``s["max_new"]`` tokens on
    ``s["arch"]`` at full width; returns (ok, launch counts of the run,
    the streams, the metrics). ``s`` may name ``num_pages`` (an
    oversubscribed pool), ``paged=False`` (the contiguous cache),
    ``sampled`` (every other request sampled with ``SAMPLED`` and its own
    seed), ``shared`` (the shared-prefix prompts), ``prefix_cache`` (off
    when False), ``scheduler`` and ``priorities`` (``"rid"``: the JAX
    benchmark's ``(rid * 5) % 3``)."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import (measure, prompts_for,
                                          shared_prefix_prompts)
    from repro_torch.serving import SamplingParams

    cfg = configs.get(s["arch"])
    params = serve_params(cfg, s["seed"])
    if s.get("shared"):
        prompts = shared_prefix_prompts(cfg, s["seed"])
    else:
        prompts = prompts_for(cfg, s["requests"], s["min_prompt"],
                              s["max_prompt"], s["seed"],
                              crossing=s["crossing"])
    sampling = None
    if s.get("sampled"):
        sampling = [SamplingParams(**SAMPLED, seed=1000 + rid)
                    if rid % 2 else None for rid in range(len(prompts))]
    priorities = [(rid * 5) % 3 for rid in range(len(prompts))] \
        if s.get("priorities") == "rid" else None
    m, outs = measure(params, cfg, prompts, max_new=s["max_new"],
                      slots=s["slots"], max_seq=s["max_seq"],
                      page_size=s["page_size"], device="cuda",
                      num_pages=s.get("num_pages"),
                      preemption=s.get("preemption", "swap"),
                      paged=s.get("paged"),
                      prefix_cache=s.get("prefix_cache", True),
                      scheduler=s.get("scheduler", "fcfs"),
                      sampling=sampling, priorities=priorities)
    steps = m["steps"]
    rms = ops.get_variant("fused_add_rmsnorm")
    # decode attention runs on the cache layout's kernel alone
    if m["paged"]:
        layout = f"paged pool of {m['num_pages']} pages of " \
            f"{s['page_size']}{', radix tree' if m['prefix_cache'] else ''}"
    else:
        layout = (f"contiguous cache of {m['max_seq']} rows a slot"
                  if not cfg.window else
                  f"contiguous ring of {cfg.window} rows a slot") + \
            f", flash_decode {ops.get_variant('flash_decode').describe()}"
    log(f"  {label}: fused_add_rmsnorm {rms.describe()}; silu_and_mul "
        f"{ops.get_variant('silu_and_mul').describe()}")
    log(f"  {len(prompts)} requests"
        f"{', every other sampled ' + str(SAMPLED) if sampling else ''}, "
        f"prompt lengths {m['prompt_lens']}, max_new_tokens {s['max_new']}, "
        f"slots {s['slots']}, max_seq {s['max_seq']}, {layout}, scheduler "
        f"{m['scheduler']} (reorders {m['sched_reorders']})")
    log(f"  tok_s={m['tok_s']:.1f} mean_ttft_s={m['ttft_s']:.4f} "
        f"steps={steps} readbacks={m['readbacks']} "
        f"prefill_buckets={m['prefill_buckets']} "
        f"peak_mem_GiB={m['peak_mem_gib']:.2f}")
    captures = 2 if sampling else 1
    log(f"  captured decode step: capture_s={m['capture_s']:.3f} "
        f"decode_captures={m['decode_captures']} (expected {captures}) "
        f"graph_replays={m['graph_replays']} "
        f"mean_decode_step_ms={1e3 * m['decode_step_s']:.3f} "
        f"table_uploads={m['table_uploads']}")
    log("  captures by step (seconds, graph pool MiB): " + ", ".join(
        f"{k} {v['s']:.3f} s {v['pool_mib']:.1f} MiB"
        for k, v in m["capture_by_step"].items()))
    ok = True
    if m["graph_replays"] != steps or m["decode_captures"] != captures \
            or m["sampling_step"] != bool(sampling):
        log(f"  FAIL graph_replays {m['graph_replays']} != steps {steps} "
            f"or {m['decode_captures']} captures, sampling step "
            f"{m['sampling_step']}")
        ok = False
    if m["paged"]:
        log(f"  preemption {m['preemption']}: preemptions="
            f"{m['preemptions']} pages swapped out={m['swapped_out_pages']}"
            f" back in={m['swapped_in_pages']} pool_check="
            f"{'ok' if m['pool_ok'] else m['pool_error']} pages in use "
            f"only the tree's ({m['tree_pages']}) and none after "
            f"clear_tree={m['pool_released']}")
        ok &= m["pool_ok"] and m["pool_released"]
        if s.get("num_pages") and m["preemptions"] < 1:
            log("  FAIL the oversubscribed pool never preempted")
            ok = False
    if m["prefix_cache"]:
        log(f"  prefix cache: prefix_hit_tokens={m['prefix_hit_tokens']} "
            f"of {m['prefix_query_tokens']}, suffix_prefills="
            f"{m['suffix_prefills']}, cow_copies={m['cow_copies']}, "
            f"tree_evictions={m['tree_evictions']}, tree_pages="
            f"{m['tree_pages']}")
    # every request is prefilled once (whole, or its suffix after a hit)
    if m["prefills"] + m["suffix_prefills"] != len(prompts):
        log(f"  FAIL {m['prefills']} prefills and {m['suffix_prefills']} "
            f"suffix prefills for {len(prompts)} requests")
        ok = False
    ok &= check_launches(m, expected_launches(cfg, m))
    if m["readbacks"] != steps:
        log(f"  FAIL readbacks {m['readbacks']} != steps {steps}")
        ok = False
    for o in outs:
        if o.finish_reason != "done" or len(o.tokens) != s["max_new"] \
                or not all(0 <= t < cfg.vocab for t in o.tokens):
            log(f"  FAIL request {o.rid}: {o.finish_reason} "
                f"{len(o.tokens)} tokens {o.error or ''}")
            ok = False
    return ok, m["launches"], [o.tokens for o in outs], m


def same(what: str, a, b) -> bool:
    """Log and return whether two lists of streams are equal."""
    eq = a == b
    diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
    log(f"  {what}: {'equal' if eq else f'DIFFER at requests {diff}'}")
    return eq


def bf16_rule(what: str, cfg, params, prompts, want, got) -> bool:
    """The rule the JAX goldens are held to: each stream of ``got`` may
    leave ``want``'s only at a token where the full prefill's logits of
    the two tokens are within the bf16 tolerance."""
    from repro_torch.models import registry
    tol, n, ok = TOL[torch.bfloat16], 0, True
    for rid, (prompt, w, g) in enumerate(zip(prompts, want, got)):
        diff = [i for i, (a, b) in enumerate(zip(w, g)) if a != b]
        if not diff:
            continue
        n, i = n + 1, diff[0]
        seq = np.concatenate([prompt, np.asarray(w[:i], prompt.dtype)])
        logits, _ = registry.prefill(params, cfg, torch.tensor(
            seq[None], dtype=torch.long, device="cuda"))
        lg = logits[0].float()
        a, b = float(lg[w[i]]), float(lg[g[i]])
        good = abs(a - b) <= tol["atol"] + tol["rtol"] * abs(a)
        ok &= good
        log(f"  r{rid} first differs at token {i} ({w[i]} / {g[i]}): "
            f"logits {a:.4f} / {b:.4f}, "
            f"{'within' if good else 'OUTSIDE'} the bf16 tolerance")
    log(f"  {what}: {n} of {len(want)} streams differ, "
        f"{'each first at a bf16 near-tie' if ok else 'NOT at near-ties'}")
    return ok


def chaos_plan() -> list:
    """Phase 4c's fault plan, keyed on engine steps."""
    from repro_torch.reliability import Fault
    return [Fault("abort", step=2, rid=1), Fault("abort", step=5, rid=5),
            Fault("device_fault", step=7, slot=1),
            Fault("pool_exhaustion", step=10, pages=5, steps=4),
            Fault("corrupt_readback", step=12, slot=2)]


def chaos_prompts(cfg, s: dict) -> list:
    """Phase 4's prompts, then an empty one and one of ``max_seq``
    tokens, which admission must reject."""
    from repro_torch.launch.serve import prompts_for
    prompts = prompts_for(cfg, s["requests"], s["min_prompt"],
                          s["max_prompt"], s["seed"], crossing=s["crossing"])
    return prompts + [np.zeros(0, np.int32),
                      np.ones(s["max_seq"], np.int32)]


def expected_launches(cfg, m: dict, k: int = 0, draft=None) -> dict:
    """What a serve's kernels launch, from its counts: every prefill
    (whole or suffix) and every decode pass launches the norms 2L+1 times
    (twice each for a two-pass rmsnorm) and silu L times, and a decode
    pass the layout's attention L times. A spec step (``k`` drafts) makes
    k + 1 target passes and, with a ``draft`` model config, k + 1 draft
    passes (contiguous ``flash_decode``) and one draft prefill per
    prefill. The merge is not on the path."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import WARMUP_STEPS

    # decode steps: the replays, and the warm-ups of a capture made
    # during the run (the draw's, at the first sampled admission)
    steps = m["steps"] + m["capture_warmups"] - WARMUP_STEPS
    passes = (k + 1) * steps
    prefills = m["prefills"] + m["suffix_prefills"]
    norm = 2 if ops.get_variant("fused_add_rmsnorm").two_pass else 1
    want = dict.fromkeys(SOURCES, 0)
    attn = "paged_flash_decode" if m["paged"] else "flash_decode"
    models = [(cfg, attn)] + ([(draft, "flash_decode")]
                              if draft is not None else [])
    for c, kernel in models:
        want["fused_add_rmsnorm"] += norm * (2 * c.n_layers + 1) \
            * (passes + prefills)
        want["silu_and_mul"] += c.n_layers * (passes + prefills)
        want[kernel] += c.n_layers * passes
    return want


def check_launches(m: dict, want: dict) -> bool:
    ok = True
    for name, n in m["launches"].items():
        good = n == want[name]
        ok &= good
        log(f"  launches {name}: {n} (expected {want[name]}) "
            f"{'ok' if good else 'WRONG'}")
    return ok


def check_run(m: dict, captures: int = 1) -> bool:
    """readbacks == steps == graph_replays, the captures, the pool."""
    ok = m["readbacks"] == m["steps"] == m["graph_replays"] \
        and m["decode_captures"] == captures
    log(f"  steps={m['steps']} readbacks={m['readbacks']} graph_replays="
        f"{m['graph_replays']} decode_captures={m['decode_captures']} "
        f"(expected {captures}) {'ok' if ok else 'WRONG'}")
    if m["paged"]:
        log(f"  pool_check={'ok' if m['pool_ok'] else m['pool_error']}, "
            f"every page but the tree's released={m['pool_released']}")
        ok &= m["pool_ok"] and m["pool_released"]
    return ok


def phase_chaos_serve(over: list, streams: list) -> tuple[dict, dict]:
    """4c (a): the chaos serve on the oversubscribed pool and the deadline
    drill. ``over``/``streams``: phase 4's oversubscribed and fully
    subscribed streams. Returns (ok by name, launch counts by path)."""
    from repro_torch import configs
    from repro_torch.launch.serve import measure, prompts_for
    from repro_torch.reliability import Fault

    ok, counts = {}, {}
    s = SERVE_OVER
    cfg = configs.get(s["arch"])
    params = serve_params(cfg, s["seed"])
    prompts = chaos_prompts(cfg, s)
    plan = chaos_plan()
    log(f"  chaos serve: phase 4's {s['requests']} requests plus an empty "
        f"prompt and one of {s['max_seq']} tokens, {s['num_pages']} pages "
        f"of {s['page_size']}, swap; plan " + ", ".join(
            f"{f.kind}@{f.step}" + (f" rid {f.rid}" if f.rid is not None
                                    else "")
            + (f" slot {f.slot}" if f.slot is not None else "")
            + (f" {f.pages} pages for {f.steps} steps" if f.pages else "")
            for f in plan))
    m, outs = measure(params, cfg, prompts, max_new=s["max_new"],
                      slots=s["slots"], max_seq=s["max_seq"],
                      page_size=s["page_size"], device="cuda",
                      num_pages=s["num_pages"], preemption=s["preemption"],
                      chaos=plan, check_steps=True)
    got = {key: m[key] for key in CHAOS_COUNTS}
    good = m["chaos_exhausted"] and got == CHAOS_COUNTS
    log(f"  plan exhausted={m['chaos_exhausted']}, injected "
        f"{m['chaos_injected']}, relents {m['chaos_relents']}; counts {got} "
        f"(expected {CHAOS_COUNTS}) {'ok' if good else 'WRONG'}; "
        f"deadline_expired={m['deadline_expired']} preemptions="
        f"{m['preemptions']}")
    log(f"  finish reasons: {m['reasons']}; pool checked after each of "
        f"{m['step_checks']} steps; tok_s={m['tok_s']:.1f} "
        f"mean_decode_step_ms={1e3 * m['decode_step_s']:.3f}")
    good &= check_run(m) and m["step_checks"] >= m["steps"]
    for o in outs[:s["requests"]]:
        want = over[o.rid]
        if o.finish_reason == "done":
            fine = o.tokens == want
        else:
            fine = o.finish_reason in ("aborted", "failed") \
                and o.tokens == want[:len(o.tokens)]
        if not fine:
            log(f"  FAIL request {o.rid} ({o.finish_reason}, "
                f"{len(o.tokens)} tokens) leaves phase 4's stream")
        good &= fine
    good &= all(o.finish_reason == "rejected" for o in outs[s["requests"]:])
    good &= check_launches(m, expected_launches(cfg, m))
    ok["serve_chaos"], counts["serve_chaos"] = good, m["launches"]

    d = SERVE
    prompts = prompts_for(cfg, d["requests"], d["min_prompt"],
                          d["max_prompt"], d["seed"])[:4]
    deadlines = [DEADLINE_S if rid == 1 else None for rid in range(4)]
    m, outs = measure(params, cfg, prompts, max_new=d["max_new"],
                      slots=d["slots"], max_seq=d["max_seq"],
                      page_size=d["page_size"], device="cuda",
                      chaos=[Fault("stall", step=3,
                                   seconds=DEADLINE_STALL_S)],
                      deadlines=deadlines, check_steps=True)
    good = [o.finish_reason for o in outs] == \
        ["done", "deadline", "done", "done"] \
        and m["deadline_expired"] == 1 and m["chaos_exhausted"]
    good &= all(o.tokens == streams[o.rid] if o.finish_reason == "done"
                else o.tokens == streams[o.rid][:len(o.tokens)]
                for o in outs)
    log(f"  deadline drill: a {DEADLINE_STALL_S} s stall at step 3, "
        f"request 1's deadline {DEADLINE_S} s: finish reasons "
        f"{[o.finish_reason for o in outs]}, request 1 cut at "
        f"{len(outs[1].tokens)} tokens, deadline_expired="
        f"{m['deadline_expired']} {'ok' if good else 'WRONG'}")
    good &= check_run(m) and check_launches(m, expected_launches(cfg, m))
    ok["serve_deadline"], counts["serve_deadline"] = good, m["launches"]
    return ok, counts


def phase_spec_serve(streams: list, base: dict) -> tuple[dict, dict]:
    """4c (b): phase 4's requests decoded speculatively with the n-gram
    drafter, the self-draft, and the self-draft on the oversubscribed
    pool. ``streams``/``base``: phase 4's reintegrated streams and
    metrics. Returns (ok by name, launch counts by path)."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import measure, prompts_for
    from repro_torch.serving import SpecConfig

    ok, counts = {}, {}
    cfg = configs.get(SERVE["arch"])
    params = serve_params(cfg, SERVE["seed"])
    tuned_fd = ops.get_variant("flash_decode")
    twin, _ = paged_twin(SERVE)
    base_step = base["decode_step_s"]
    log(f"  phase 4 (greedy, no spec): tok_s={base['tok_s']:.1f} "
        f"steps={base['steps']} mean_decode_step_ms={1e3 * base_step:.3f}")
    self_draft = SpecConfig("draft_model", k=3, draft_params=params,
                            draft_cfg=cfg)
    for path, label, s, spec in (
            ("serve_spec_ngram", "n-gram drafter, k 4", SERVE,
             SpecConfig("ngram", k=4)),
            ("serve_spec_draft", "self-draft, k 3", SERVE, self_draft),
            ("serve_spec_oversubscribed",
             "self-draft, k 3, oversubscribed pool", SERVE_OVER,
             self_draft)):
        draft = spec.draft_cfg
        if draft is not None:
            ops.set_variants(flash_decode=twin)
        prompts = prompts_for(cfg, s["requests"], s["min_prompt"],
                              s["max_prompt"], s["seed"])
        m, outs = measure(params, cfg, prompts, max_new=s["max_new"],
                          slots=s["slots"], max_seq=s["max_seq"],
                          page_size=s["page_size"], device="cuda",
                          num_pages=s.get("num_pages"),
                          preemption=s.get("preemption", "swap"),
                          spec=spec)
        if draft is not None:
            ops.set_variants(flash_decode=tuned_fd)
        cap = m["capture_by_step"].get("spec", {"s": 0.0, "pool_mib": 0.0})
        step = m["decode_step_s"]
        log(f"  {label}: tok_s={m['tok_s']:.1f} steps={m['steps']} "
            f"accepted_per_step={m['accepted_per_step']:.3f} draft_tokens="
            f"{m['draft_tokens']} accepted_tokens={m['accepted_tokens']} "
            f"accept_rate={m['accept_rate']:.3f} mean_decode_step_ms="
            f"{1e3 * step:.3f} (per committed token "
            f"{1e3 * step / max(m['accepted_per_step'], 1e-9):.3f}, phase 4's"
            f" step {1e3 * base_step:.3f}); spec step capture "
            f"{cap['s']:.3f} s, graph pool {cap['pool_mib']:.1f} MiB; "
            f"preemptions={m['preemptions']}")
        good = check_run(m)
        good &= m["spec_on"] and all(o.finish_reason == "done"
                                     and len(o.tokens) == s["max_new"]
                                     for o in outs)
        good &= same(f"{label} streams against phase 4's",
                     [o.tokens for o in outs], streams)
        if s.get("num_pages"):
            good &= m["preemptions"] >= 1
        good &= check_launches(m, expected_launches(cfg, m, spec.k, draft))
        ok[path], counts[path] = good, m["launches"]
    return ok, counts


def paged_twin(s: dict):
    """The flash_decode genome that does the installed paged genome's
    arithmetic on the contiguous cache of serve ``s``: the paged kernel's
    64-row steps and its two flags. The tuner picks either decode genome's
    flags by times within noise of each other, and ``use_reciprocal``
    moves the last bit of the attention, so streams compared across the
    two layouts would part at a near-tie when the flags differ. Returns
    (the genome, whether both kernels plan the same splits there)."""
    from repro_torch import configs
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ops

    cfg = configs.get(s["arch"])
    paged = ops.get_variant("paged_flash_decode")
    twin = fd.FlashDecodeVariant(name=f"{paged.name}~contiguous",
                                 chunk=fd.PAGED_STEP,
                                 use_reciprocal=paged.use_reciprocal,
                                 mask_oob=paged.mask_oob)
    shape = dict(batch=s["slots"], q_heads=cfg.n_heads,
                 kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                 dtype=cfg.torch_dtype)
    a = fd.launch_plan(twin, seq=s["max_seq"], **shape)
    b = fd.paged_launch_plan(page=s["page_size"],
                             n_pt=s["max_seq"] // s["page_size"], **shape)
    same_plan = (a["splits"], a["steps_per_split"]) == \
        (b["splits"], b["steps_per_split"])
    log(f"  contiguous twin of paged {paged.describe()}: {twin.describe()}; "
        f"splits {a['splits']} x {a['steps_per_split']} against paged "
        f"{b['splits']} x {b['steps_per_split']} "
        f"{'ok' if same_plan else 'DIFFER'}")
    return twin, same_plan


def phase_serve_requests(streams: list) -> tuple[dict, dict]:
    """Phase 4's sampled, shared-prefix and priority serves of qwen2 (the
    reintegrated genomes; the contiguous run's flash_decode is the paged
    genome's twin, ``paged_twin``). ``streams``: the greedy serve's.
    Returns (ok by name, launch counts by path)."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import shared_prefix_prompts

    ok, counts, runs = {}, {}, {}
    tuned_fd = ops.get_variant("flash_decode")
    twin, twin_ok = paged_twin(SERVE)
    for path, label, s in (
            ("serve_sampled", "every other request sampled, paged pool",
             dict(SERVE, sampled=True)),
            ("serve_sampled_contiguous", "sampled, contiguous cache",
             dict(SERVE, sampled=True, paged=False)),
            ("serve_sampled_oversubscribed",
             "sampled, oversubscribed pool", dict(SERVE_OVER, sampled=True)),
            ("serve_shared_prefix", "shared prefixes, radix tree",
             dict(SERVE_SHARED, shared=True)),
            ("serve_shared_prefix_cold", "shared prefixes, no tree",
             dict(SERVE_SHARED, shared=True, prefix_cache=False)),
            ("serve_priority", "rid-derived priorities",
             dict(SERVE, scheduler="priority", priorities="rid"))):
        contiguous = s.get("paged") is False
        if contiguous:
            ops.set_variants(flash_decode=twin)
        ok[path], counts[path], got, m = phase_serve(label, s)
        if contiguous:
            ops.set_variants(flash_decode=tuned_fd)
        runs[path] = (got, m)
    sampled = runs["serve_sampled"][0]
    good = same("sampled streams, contiguous cache against paged pool",
                runs["serve_sampled_contiguous"][0], sampled) and twin_ok
    good &= same("sampled streams, oversubscribed pool against paged pool",
                 runs["serve_sampled_oversubscribed"][0], sampled)
    good &= same("greedy requests of the sampled serve against the greedy "
                 "serve", sampled[::2], streams[::2])
    ok["serve_sampled"] &= good
    hot, mh = runs["serve_shared_prefix"]
    cold, mc = runs["serve_shared_prefix_cold"]
    # the suffix prefill sums in another order than the whole prompt's
    # (other attention, other matrix shapes), so in bf16 a stream may
    # leave the other at a near-tie, as the goldens may
    cfg = configs.get(SERVE_SHARED["arch"])
    good = same("shared-prefix streams with the tree against without",
                hot, cold) or bf16_rule(
        "shared-prefix streams with the tree against without", cfg,
        serve_params(cfg, SERVE_SHARED["seed"]),
        shared_prefix_prompts(cfg, SERVE_SHARED["seed"]), cold, hot)
    for key, want in SHARED_COUNTS.items():
        hit = mh[key] == want
        good &= hit
        log(f"  shared prefix {key}={mh[key]} (expected {want}) "
            f"{'ok' if hit else 'WRONG'}")
    hits = [i for i, h in enumerate(mh["hits"]) if h]
    log("  ttft of the requests that hit (with the tree / without), ms: "
        + ", ".join(f"r{i} {1e3 * mh['ttfts'][i]:.2f}/"
                    f"{1e3 * mc['ttfts'][i]:.2f}" for i in hits))
    log(f"  mean ttft of those requests: "
        f"{1e3 * np.mean([mh['ttfts'][i] for i in hits]):.2f} ms with the "
        f"tree, {1e3 * np.mean([mc['ttfts'][i] for i in hits]):.2f} ms "
        f"without")
    ok["serve_shared_prefix"] &= good
    got, mp = runs["serve_priority"]
    good = mp["sched_reorders"] > 0
    log(f"  priority: sched_reorders={mp['sched_reorders']} "
        f"{'ok' if good else 'WRONG (none)'}")
    good &= same("priority streams against the FCFS serve", got, streams)
    ok["serve_priority"] &= good
    return ok, counts


def time_serve(arch: str) -> dict:
    """``--time-serve``: phase 4's fully subscribed serve of ``arch``
    through the ``Engine`` of the ``repro_torch`` first on ``sys.path``,
    each ``step()`` timed on the host, after a warm-up wave on an engine
    of its own. Uses only what the engines of earlier commits have too."""
    from repro_torch import configs
    from repro_torch.launch.serve import prompts_for
    from repro_torch.models import registry
    from repro_torch.serving import CacheConfig, Engine, Request

    s = {SERVE["arch"]: SERVE, SERVE_H2O["arch"]: SERVE_H2O}[arch]
    cfg = configs.get(arch)
    params = registry.init_params(cfg, seed=s["seed"])

    def serve(prompts, max_new):
        eng = Engine(params, cfg, slots=s["slots"], max_seq=s["max_seq"],
                     cache_manager=CacheConfig(page_size=s["page_size"]))
        torch.cuda.synchronize()
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_new_tokens=max_new))
        decode = []
        t0 = time.perf_counter()
        while eng.has_work():
            admitted = eng.scheduler.stats()["sched_admitted"]
            t = time.perf_counter()
            if not eng.step():
                break
            if eng.scheduler.stats()["sched_admitted"] == admitted:
                decode.append(time.perf_counter() - t)
        eng.run()                       # settles the last readback
        torch.cuda.synchronize()
        return eng, decode, time.perf_counter() - t0

    serve(prompts_for(cfg, 2, 16, 64, seed=99), 4)
    prompts = prompts_for(cfg, s["requests"], s["min_prompt"],
                          s["max_prompt"], s["seed"], crossing=s["crossing"])
    eng, decode, wall = serve(prompts, s["max_new"])
    st = eng.stats()
    return {"arch": arch, "wall_s": wall, "tok_s": st["tokens"] / wall,
            "ttft_s": st["ttft"], "steps": st["steps"],
            "readbacks": st["readbacks"], "decode_steps": len(decode),
            "decode_step_ms": 1e3 * float(np.mean(decode)),
            "decode_step_ms_median": 1e3 * float(np.median(decode))}


def phase_reference() -> bool:
    """Reduced qwen2 config in fp32: prefill and decode logits and the
    greedy streams on the card against the plain versions on the CPU."""
    from repro_torch import configs
    from repro_torch.launch.serve import prompts_for
    from repro_torch.models import registry, transformer
    from repro_torch.serving import LLMEngine

    cfg = dataclasses.replace(configs.smoke("qwen2-0.5b"), dtype="float32")
    gpu = registry.init_params(cfg, seed=1)
    cpu = transformer.cast_params(gpu, cfg, torch.device("cpu"))
    ok = True
    rng = np.random.default_rng(1)
    toks = torch.tensor(rng.integers(0, cfg.vocab, (1, 32)))
    lg, cache_g = registry.prefill(gpu, cfg, toks.cuda(), length=29)
    lc, cache_c = registry.prefill(cpu, cfg, toks, length=29)
    err = compare(lg.cpu(), lc)
    log(f"  prefill logits card vs cpu: max_abs={err[0]:.3e} "
        f"{'ok' if err[2] else 'MISMATCH'}")
    ok &= err[2]
    def decode(params, cache, dev):
        """One decode step at position 29 over a pool whose pages 1, 2
        hold the prompt's rows (page 3 backs the write)."""
        page = 16
        pool = registry.init_paged_cache(cfg, 4, page, dev)
        registry.write_pages(cfg, pool, cache,
                             torch.tensor([1, 2], device=dev), page)
        i32 = dict(dtype=torch.int32, device=dev)
        logits, _ = registry.decode_cached(
            params, cfg, pool, torch.tensor([5], **i32),
            torch.tensor([29], **i32),
            page_table=torch.tensor([[1, 2, 3]], **i32))
        return logits.cpu()

    err = compare(decode(gpu, cache_g, "cuda"), decode(cpu, cache_c, "cpu"))
    log(f"  decode logits card vs cpu: max_abs={err[0]:.3e} "
        f"{'ok' if err[2] else 'MISMATCH'}")
    ok &= err[2]
    prompts = prompts_for(cfg, 6, 3, 40, 2)
    runs = []
    for params, dev in ((gpu, None), (cpu, "cpu")):
        llm = LLMEngine(params, cfg, slots=3, max_seq=64, device=dev)
        runs.append(([o.tokens for o in llm.generate(prompts,
                                                     max_new_tokens=8)],
                     llm.stats()["steps"]))
    same = runs[0] == runs[1]
    log(f"  greedy streams card vs cpu (6 requests, steps {runs[0][1]} vs "
        f"{runs[1][1]}): {'equal' if same else 'DIFFER'}")
    return ok and same


def phase_reference_window() -> bool:
    """Reduced h2o-danube config (window 64) in fp32: prefill logits and
    the ring for a prompt longer than the window, decode logits after the
    ring wraps, and greedy streams of prompts that cross the window, on
    the card against the plain versions on the CPU."""
    from repro_torch import configs
    from repro_torch.launch.serve import prompts_for
    from repro_torch.models import registry, transformer
    from repro_torch.serving import LLMEngine

    cfg = dataclasses.replace(configs.smoke("h2o-danube-1.8b"),
                              dtype="float32")
    gpu = registry.init_params(cfg, seed=2)
    cpu = transformer.cast_params(gpu, cfg, torch.device("cpu"))
    toks = torch.tensor(np.random.default_rng(2).integers(0, cfg.vocab,
                                                          (1, 100)))
    outs = []
    for params, dev in ((gpu, "cuda"), (cpu, "cpu")):
        lg, kv = registry.prefill(params, cfg, toks.to(dev))
        ring = kv["k"].cpu()
        cache = registry.init_cache(cfg, 2, 192, dev)
        registry.write_slot(cfg, cache, kv, 1)
        steps = []
        for t in range(3):       # slot 1 writes rows 36..38 of its ring
            i32 = dict(dtype=torch.int32, device=dev)
            logits, cache = registry.decode_cached(
                params, cfg, cache, torch.tensor([3, 5 + t], **i32),
                torch.tensor([t, 100 + t], **i32))
            steps.append(logits.cpu())
        outs.append((lg.cpu(), ring, torch.stack(steps)))
    ok = True
    for what, g, c in zip(("prefill logits (100 tokens, window 64)",
                           "ring after prefill",
                           "decode logits after the wrap"), *outs):
        err = compare(g, c)
        ok &= err[2]
        log(f"  {what} card vs cpu: max_abs={err[0]:.3e} "
            f"{'ok' if err[2] else 'MISMATCH'}")
    prompts = prompts_for(cfg, 6, 3, 40, 2, crossing=2)
    runs = []
    for params, dev in ((gpu, None), (cpu, "cpu")):
        llm = LLMEngine(params, cfg, slots=3, max_seq=192, device=dev)
        runs.append(([o.tokens for o in llm.generate(prompts,
                                                     max_new_tokens=30)],
                     llm.stats()["steps"]))
    same = runs[0] == runs[1]
    log(f"  greedy streams card vs cpu (prompt lengths "
        f"{[len(p) for p in prompts]}, steps {runs[0][1]} vs {runs[1][1]}):"
        f" {'equal' if same else 'DIFFER'}")
    return ok and same


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="a checkout of the parent commit: the "
                    "shapes phase times its rmsnorm and silu too")
    ap.add_argument("--time-shapes", metavar="SRC", help=argparse.SUPPRESS)
    ap.add_argument("--journal-child", nargs=2, metavar=("PATH", "N"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--time-serve", nargs=2, metavar=("SRC", "ARCH"),
                    help="time phase 4's serve of ARCH on the package "
                    "under SRC, and stop")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script runs only "
              "on an NVIDIA GPU", file=sys.stderr)
        return 1
    if args.time_shapes:
        sys.path.insert(0, os.path.abspath(args.time_shapes))
        print(json.dumps(time_shapes()))
        return 0
    if args.time_serve:
        sys.path.insert(0, os.path.abspath(args.time_serve[0]))
        print(json.dumps(time_serve(args.time_serve[1])))
        return 0
    sys.path.insert(0, os.path.join(ROOT, "src"))
    if args.journal_child:
        journal_child(args.journal_child[0], int(args.journal_child[1]))
        return 0
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.registry import get_space
    from repro_torch.launch.serve import card as card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_s = {}
    card = card_line()
    log(f"phase 1: environment and build\n  {card}; torch {torch.__version__}"
        f" CUDA {torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    _build.library()
    info = _build.build_info
    log(f"  kernel library {'cached' if info['cached'] else 'built'} in "
        f"{info['seconds']:.1f} s: {info['path']}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log("   " + line.strip())
    phase_s["build"] = time.perf_counter() - t_start

    ok: dict = {}
    rows: dict = {}
    t0 = time.perf_counter()
    log("phase 2: kernels against their plain versions on the card")
    ok["kernels"] = phase_kernels(rows)
    ok["kernels"] &= phase_edges()
    phase_s["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    log("phase 2b: rmsnorm and silu at the decode, prefill and largest "
        "suite shapes" + (f", beside the parent in {args.parent}"
                          if args.parent else ""))
    parent_us = phase_shapes(args.parent)
    phase_s["shapes"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    log("phase 3: tune (the Astra agent loop on the card)")
    ok["tune"], tune_counts, results, tune = phase_tune()
    phase_s["tune"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    log("phase 3b: the shipped and reintegrated rmsnorm and silu at the "
        "shapes of 2b, against their plain versions")
    ok["tuned shapes"] = phase_tuned_shapes(parent_us)
    phase_s["tuned shapes"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    log("phase 3c: the agent loop in sandboxed workers on the card")
    ok["tune process"], process_counts = phase_process(results, tune)
    ok["chaos"] = phase_chaos()
    ok["resume"] = phase_resume()
    phase_s["tune process"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    log("phase 4: serve qwen2-0.5b with the shipped genomes, then the "
        "reintegrated; h2o-danube-1.8b with the reintegrated")
    tuned = {n: ops.get_variant(n) for n in results}
    ops.set_variants(**{n: get_space(n).shipped for n in results})
    ok["serve shipped"], shipped_counts, _, _ = phase_serve(
        "shipped genomes", SERVE)
    ops.set_variants(**tuned)
    ok["serve"], serve_counts, streams, serve_m = phase_serve(
        "reintegrated genomes", SERVE)
    ok["serve h2o"], h2o_counts, _, _ = phase_serve("reintegrated genomes",
                                                    SERVE_H2O)
    ok["serve oversubscribed"], over_counts, over_streams, _ = phase_serve(
        "reintegrated genomes, oversubscribed pool", SERVE_OVER)
    ok["serve oversubscribed"] &= same(
        "oversubscribed streams against the fully subscribed serve",
        over_streams, streams)
    phase_s["serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    log("phase 4b: serve qwen2-0.5b with sampled, shared-prefix and "
        "prioritized requests (reintegrated genomes)")
    request_ok, request_counts = phase_serve_requests(streams)
    ok.update(request_ok)
    phase_s["serve requests"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    log("phase 4c: serve qwen2-0.5b under chaos, with deadlines, and "
        "decoded speculatively (reintegrated genomes)")
    chaos_ok, chaos_counts = phase_chaos_serve(over_streams, streams)
    spec_ok, spec_counts = phase_spec_serve(streams, serve_m)
    ok.update(chaos_ok)
    ok.update(spec_ok)
    request_counts.update(chaos_counts)
    request_counts.update(spec_counts)
    phase_s["serve lifecycle and spec"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    log("phase 5: reference on a small input")
    ok["reference"] = phase_reference()
    ok["reference"] &= phase_reference_window()
    phase_s["reference"] = time.perf_counter() - t0
    log("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                      for k, v in phase_s.items()))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    for name, row in rows.items():
        row["launches_by_path"] = {"tune": tune_counts[name],
                                   "tune_process": process_counts[name],
                                   "serve_shipped": shipped_counts[name],
                                   "serve_reintegrated": serve_counts[name],
                                   "serve_h2o": h2o_counts[name],
                                   "serve_oversubscribed": over_counts[name],
                                   **{path: c[name] for path, c
                                      in request_counts.items()}}
        # the main path: every run but the shipped-genome serve
        row["launches"] = sum(n for path, n in row["launches_by_path"]
                              .items() if path != "serve_shipped")
    rows["merge_attn_states_lse"]["note"] = (
        "not on the serve path (the model inlines its merge); the tune "
        "phase (the agent loop) drives it")
    idle = [n for n, r in rows.items() if not r["launches"]]
    if idle:
        log(f"FAIL: no launch on the driven paths for {idle}")
    idle_workers = [n for n in rows if not process_counts[n]]
    if idle_workers:
        log(f"FAIL: no launch in the workers for {idle_workers}")
        idle = idle or idle_workers
    log(json.dumps({"kernels": [rows[n] for n in SOURCES]}))
    log(card)
    if idle or not all(ok.values()):
        log("chip_smoke FAILED: " + ", ".join(f"{k} {v}"
                                              for k, v in ok.items()))
        return 1
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
