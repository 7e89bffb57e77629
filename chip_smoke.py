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
   never calls it). The shipped genomes at the olmoe-1b-7b shapes too
   (silu on the 3-D expert tensor of a decode step and of a 256-token
   prefill, rmsnorm at width 2048, flash_decode at head_dim 128, group
   1); the paged decode at the dense qk-norm configs' heads (8 slots of
   512 rows, 32/8, 56/8 and 64/8 heads of 128: qwen3-8b, yi-34b,
   chameleon-34b), flash_decode at recurrentgemma-2b's (8 slots, 10/1
   heads of 256, a 2,048-row ring; in fp32 on the ring of one slot) and
   at seamless-m4t-large-v2's cross-attention (8 slots, 16/16 heads of
   64, every row of a 1,024-row cross cache), the latter two beside
   SDPA. The shipped genomes, and the baseline genomes; the
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
2c. The prefill attention (``csrc/prefill_attention.cu``) in bf16 at the
   benchmark cells' prefill shapes (yi-34b's 512 and 2,048 buckets,
   h2o-danube-1.8b's 1,024 and 4,096 buckets and a 7,168-row prompt past
   its 4,096 window) against the fp32 walk it replaces on the serving
   path (``prefill_attention.walk``) at the decode attentions' bf16
   tolerance, timed beside its bound (the visible pairs' flops over 989
   TFLOP/s), the walk and one ``scaled_dot_product_attention`` call
   (the yardstick; the port never calls it). ``--prefill-only`` builds
   the library and runs this phase alone.
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
4d. The mixture of experts: olmoe-1b-7b at full width in bf16 (seeded
   weights, the router in fp32) with the reintegrated genomes, phase 4's
   16 greedy requests of 32 tokens (prompts of 16-256 tokens, within the
   dispatch group) on 8 slots of the contiguous cache (the family cannot
   page), each prompt prefilled at its exact length. Checks what phase 4
   checks (one capture, ``readbacks == steps == graph_replays``, launch
   counts: silu once a layer a pass on the experts' 3-D tensor,
   ``flash_decode`` as the attention); prints the seeded init time, the
   weight bytes, the capture and its graph pool, the mean decode step
   beside its bound (every weight but the embedding table read once a
   step, over the card's memory rate), tok_s and ttft.
4e. The other configs at full width in bf16 (seeded weights drawn and
   cast one layer at a time) with the reintegrated genomes, 8 slots:
   qwen3-8b from the paged pool on phase 4's requests; recurrentgemma-2b
   (its RG-LRU gates in fp32) from the contiguous cache, 16 greedy
   requests of 32 tokens, prompts of up to 3,072 tokens (two just under
   the 2,048-row window, two past it), max_seq 4,096, each prefilled at
   exact length; then yi-34b and chameleon-34b from the paged pool on
   phase 4's requests, each alone on the card (every earlier model and
   engine freed first), at full depth, or where that does not fit beside
   the cache at the largest depth that does (logged, never silent). Each
   checks what phase 4 checks (one capture, ``readbacks == steps ==
   graph_replays``, launch counts per family: recurrentgemma launches no
   rmsnorm, silu once a layer a pass and flash_decode once an attention
   layer a decode pass) and prints the decode step beside its bound
   (every weight but the embedding table read once a step), tok_s, ttft
   and the peak memory.
4f. The last two families at full width in bf16 (seeded weights drawn
   and cast one block at a time), reintegrated genomes, 8 slots of the
   contiguous cache, 16 greedy requests of 32 tokens, each prompt
   prefilled at its exact length, each model alone on the card:
   xlstm-1.3b (48 blocks, 6 periods of 7 mLSTM and 1 sLSTM; its cache is
   the recurrent state, 2.82 GB for 8 slots at any max_seq) on twelve
   prompts of 16-127 tokens and four of 1,024-4,096, max_seq 8,192; and
   seamless-m4t-large-v2 (24 encoder and 24 decoder layers) on frame
   prompts of 64-512 rows and two of 700 and 1,000 (the encoder's zero
   pad rows), max_seq 1,024, every slot reused. Each checks what phase 4
   checks (one capture, ``readbacks == steps == graph_replays``, launch
   counts: the xLSTM launches none of the kernels; the encoder-decoder
   silu once an encoder and a decoder layer and flash_decode twice a
   decoder layer a prefill, silu once and flash_decode twice a decoder
   layer a decode pass) and prints the cache bytes, the decode step
   beside its bound (the weights a step reads, once, plus the xLSTM
   state read and written or the cross K/V read), tok_s, ttft and the
   peak memory.
5. Reference: on the reduced qwen2, h2o-danube, olmoe, qwen3-8b,
   recurrentgemma-2b, xlstm-1.3b and seamless-m4t-large-v2 configs in
   fp32, the port's logits (the h2o and recurrentgemma ones past the
   window and after the ring wraps), caches and greedy streams on the
   card agree with its plain versions on the CPU; the olmoe streams on
   more slots than the decode capacity, with TF32 off (a TF32 router
   would pick other experts on the card), recurrentgemma's with its conv
   weights drawn non-zero (at init they are zero and the recurrence would
   see no input), xlstm's with its mLSTM gates drawn at their fan-in
   scale (at the JAX init's scale one ulp of a block's input moves its
   output past the fp32 tolerance), seamless's also on one slot reused
   by a shorter source.
6. Train: (a) qwen2-0.5b at full width and depth through
   ``launch.train.run`` (bf16 compute, fp32 masters and AdamW), 8 steps
   of 8 x 1,024 tokens in 2 microbatches, a checkpoint every 4 steps
   (7.6 GB each, under ``build/train_ckpt``, removed after) and a failure
   injected at step 6: the restart restores step 4 and its cursor, and
   the rerun steps 4-5 must give the first attempt's losses bit for bit
   (``torch.use_deterministic_algorithms(True)``); losses finite, launch
   counts from ``train_launches`` (rmsnorm 4 L + 1 and silu 2 L a
   microbatch: each layer's forward and its recompute, the final norm
   once; none of kernels 3-5). It prints the median step, tokens/s, the
   peak memory and the step's FLOP bound (6 N T + the causal attention,
   over 989 TFLOP/s) and its share. (b) One step of olmoe-1b-7b (1
   layer), recurrentgemma-2b (1 period), xlstm-1.3b (1 period) and
   seamless-m4t-large-v2 (1 encoder and 1 decoder layer) at full width,
   2 x 512 tokens, and one of qwen2-0.5b with compressed gradients:
   finite loss and norm, launches as ``train_launches`` gives. (c) The
   gradients of the rmsnorm and silu autograd Functions against
   autograd through the plain versions on the card, fp32 and bf16 at
   qwen2's training shapes, and an fp32 step of qwen2-0.5b cut to 2
   layers on the card against the same step on the CPU. The phase's
   wall time is printed.
7. Reference and mesh: (a) the host-driven ``ReferenceEngine`` (eager
   decode on the contiguous cache, one ``.item()`` a slot a step, exact
   prefills) serves phase 4's qwen2-0.5b requests at full width: its
   streams equal phase 4's under the bf16 rule, its launches are those
   of its prefills and decode steps, and its tok_s is printed beside
   phase 4's. (b) The tensor-parallel engine over a ``(1, 1)`` mesh of
   one NCCL rank (``launch/mesh.py``; heads, MLP and vocab "sharded" over
   one rank, so every hook runs its all-gather) serves phase 4e's
   qwen3-8b requests at full width: one capture of the measured engine
   with the collectives inside it (2 L + 1 all-gathers a captured pass),
   ``readbacks == steps == graph_replays``, phase 4e's streams and
   launch counts; the decode step is printed beside 4e's with the NCCL
   version. (c) The paged decode and silu at qwen3-8b's per-rank shapes
   for ``model`` 2 and 4 (16/4 and 8/2 heads of 128, silu over ``[8, 2 x
   6,144]`` and ``[8, 2 x 3,072]``) against their plain versions at the
   stated tolerances, each timed beside its bound. (d)
   ``examples/torch/quickstart.py`` and ``examples/torch/serve_lm.py``
   run on the card.
8. The dry run: (a) ``launch/dryrun.py`` traces qwen2-0.5b's three
   shapes and olmoe-1b-7b ``decode_32k`` on the ``(32, 8)`` mesh and
   xlstm-1.3b ``long_500k`` on the ``(2, 32, 8)`` one, each in its own
   process on this host's CPU (rank 0 of a fake world, nothing
   allocated), and every row is printed beside the card; a cell that is
   not ``ok`` fails the phase. (b) qwen2-0.5b ``decode_32k`` at world 1
   on the card: a contiguous cache of 128 slots x 32,768 rows (51.5 GB in
   bf16) filled from a seed, every slot at its last row, one eager decode
   step through the port's kernels timed with CUDA events (median of 5
   after 2 warm-ups; the launches counted) and held to the same cell's
   ``(1, 1)`` dry-run row: the step at least 0.95 of its ``step_ms`` and
   the peak memory (``max_memory_allocated`` over what was allocated
   before) within 10% of its ``hbm_gb_per_chip``. Kernel 5 at that shape
   is held against its plain version and timed beside its bound and
   SDPA.

``--time-serve SRC ARCH`` runs no phase: it serves phase 4's fully
subscribed workload of ARCH (qwen2-0.5b, h2o-danube-1.8b or
olmoe-1b-7b; the parent of the MoE port has no olmoe) with the
package under SRC (this tree's ``src``, or a checkout of the parent
commit), times every engine step on the host, and prints one JSON line:
tok_s, ttft, steps, and the mean wall time of a step that admits nothing
(its decode dispatch and the previous step's readback), so two commits'
engines compare in one call. ``--time-decode SRC`` likewise times rows 3
and 5 of the kernel table in bf16 (the installed genomes at their main
shapes, and kernel 5 at recurrentgemma-2b's) with the package under SRC
and prints them with the spilling kernels of its build, one JSON line.

The line before the last holds the card's name and power limit; the line
before that one JSON object with one row per kernel; the last line is
``{"ok": true, "device": {...}}``. There is no CPU path: without a GPU
the script exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
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
# olmoe-1b-7b on phase 4's requests: the contiguous cache (auto), exact
# prefill lengths
SERVE_OLMOE = dict(SERVE, arch="olmoe-1b-7b")
# phase 4e: the dense qk-norm configs on phase 4's requests (paged), and
# recurrentgemma-2b with prompts to 3,072 tokens, two just under its
# 2,048-row window and two past it (the contiguous cache, exact prefill)
SERVE_QWEN3 = dict(SERVE, arch="qwen3-8b")
SERVE_RGEMMA = dict(SERVE, arch="recurrentgemma-2b", max_seq=4096,
                    max_prompt=3072, crossing=2)
SERVE_34B = (dict(SERVE, arch="yi-34b"), dict(SERVE, arch="chameleon-34b"))
# phase 4f: xlstm-1.3b with twelve prompts of 16-127 tokens and four long
# ones that JAX's chunked scan takes (multiples of 64), its state the same
# size at any max_seq; seamless-m4t-large-v2 with frame prompts of 64-512
# rows and two past 512 and not a multiple of it (the encoder's zero pad
# rows), max_seq 1,024; both on the contiguous cache at exact length
SERVE_XLSTM = dict(SERVE, arch="xlstm-1.3b", max_seq=8192, max_prompt=127,
                   lengths=(1024, 2048, 3072, 4096))
SERVE_SEAMLESS = dict(SERVE, arch="seamless-m4t-large-v2", max_seq=1024,
                      min_prompt=64, max_prompt=512, lengths=(700, 1000))
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
        cases += moe_cases(dtype)
        cases += config_cases(dtype)
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


def moe_cases(dtype):
    """The olmoe-1b-7b shapes (shipped genomes), in kernel_cases' form:
    silu on the experts' ``[64, C, 2 * 1024]`` tensor of a decode step on
    8 slots (C 8) and of a 256-token prefill (C 40), rmsnorm at ``[8,
    2048]``, and flash_decode at b 8, 16/16 heads of 128 (group 1) on a
    512-row cache with ragged lengths, beside SDPA."""
    from repro_torch import configs
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ops, ref
    from repro_torch.models import moe
    cfg = configs.get(SERVE_OLMOE["arch"])
    es = torch.tensor([], dtype=dtype).element_size()
    e, f, d = cfg.n_experts, cfg.expert_ff, cfg.d_model
    cases = []
    for tokens in (SERVE_OLMOE["slots"], moe.GROUP):
        c = moe.capacity(cfg, tokens)
        x = randn((e, c, 2 * f), dtype, 7, scale=3.0)
        rows = e * c
        cases.append(("silu_and_mul", f"olmoe {tokens} tokens: experts={e} "
                      f"x rows={c} d={f}", dtype,
                      lambda x=x: ops.silu_and_mul(x),
                      lambda x=x: ref.silu_and_mul(x),
                      3 * rows * f * es, 6 * rows * f, False, False, None))
    rows = SERVE_OLMOE["slots"]
    x, r = randn((rows, d), dtype, 8), randn((rows, d), dtype, 9)
    w = randn((d,), torch.float32, 10) * 0.1 + 1.0
    cases.append(("fused_add_rmsnorm", f"olmoe rows={rows} d={d}", dtype,
                  lambda: ops.fused_add_rmsnorm(x, r, w),
                  lambda: ref.fused_add_rmsnorm(x, r, w),
                  4 * rows * d * es + 4 * d, 6 * rows * d, False, False,
                  None))
    b, hq, hkv, dh = rows, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = SERVE_OLMOE["max_seq"]
    lens = [1, 64, 511, 512, 200, 33, 300, 97]
    q, k, v, n = flash_inputs(b, hq, hkv, dh, s, lens, dtype)
    g = ops.get_variant("flash_decode")
    nbytes = 2 * b * hq * dh * es + 2 * sum(lens) * hkv * dh * es + 4 * b
    cases.append(("flash_decode", f"olmoe b={b} hq/hkv={hq}/{hkv} d={dh} "
                  f"s={s} kv_len={lens} {g.describe()}", dtype,
                  lambda: fd.flash_decode_attention(q, k, v, kv_len=n,
                                                    variant=g),
                  lambda: fd.plain(g, q, k, v, n, dh ** -0.5),
                  nbytes, 4 * sum(lens) * hq * dh, False, False,
                  sdpa(q, k, v, n)))
    return cases


def config_cases(dtype):
    """The shapes of phase 4e's decodes (the installed genomes), in
    kernel_cases' form: the paged decode at 8 slots of 512 rows (16-row
    pages, ragged lengths) with qwen3-8b's, yi-34b's and chameleon-34b's
    heads (32, 56 and 64 query heads on 8 kv heads of 128: groups 4, 7
    and 8), and flash_decode at recurrentgemma-2b's (8 slots, 10 query
    heads on one kv head of 256: group 10, two query subgroups) over a
    full 2,048-row ring, beside SDPA."""
    from repro_torch import configs
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ops
    es = torch.tensor([], dtype=dtype).element_size()
    cases = []
    b, page = SERVE_QWEN3["slots"], SERVE_QWEN3["page_size"]
    n_pt = SERVE_QWEN3["max_seq"] // page
    pg = ops.get_variant("paged_flash_decode")
    for s in (SERVE_QWEN3,) + SERVE_34B:
        cfg = configs.get(s["arch"])
        hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q, k, v, table, lens = paged_inputs(b, hq, hkv, dh, page, n_pt,
                                            dtype, seed=hq)
        rows = int(lens.sum())
        n_tab = int(sum(-(-int(n) // page) for n in lens))
        cases.append((
            "paged_flash_decode", f"{cfg.name} b={b} hq/hkv={hq}/{hkv} "
            f"d={dh} page={page} kv_len={lens.tolist()} {pg.describe()}",
            dtype,
            lambda q=q, k=k, v=v, t=table, n=lens:
                fd.paged_flash_decode_attention(q, k, v, t, kv_len=n,
                                                variant=pg),
            lambda q=q, k=k, v=v, t=table, n=lens:
                fd.paged_plain(pg, q, k, v, t, n, q.shape[-1] ** -0.5),
            2 * b * hq * dh * es + 2 * rows * hkv * dh * es + 4 * n_tab
            + 4 * b, 4 * rows * hq * dh, False, False, None))
    cfg = configs.get(SERVE_RGEMMA["arch"])
    hq, hkv, dh, s = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.window
    lens = [s] * b
    q, k, v, n = flash_inputs(b, hq, hkv, dh, s, lens, dtype, seed=11)
    g = ops.get_variant("flash_decode")
    plan = fd.launch_plan(g, batch=b, q_heads=hq, kv_heads=hkv,
                          head_dim=dh, seq=s, dtype=dtype)
    cases.append((
        "flash_decode", f"{cfg.name} b={b} hq/hkv={hq}/{hkv} d={dh} s={s} "
        f"kv_len={s} {g.describe()} (ring of {plan['stages']} slots, "
        f"{plan['smem']} B a block)", dtype,
        lambda a=(q, k, v), n=n: fd.flash_decode_attention(
            *a, kv_len=n, variant=g),
        lambda a=(q, k, v), n=n, dh=dh: fd.plain(g, *a, n, dh ** -0.5),
        2 * b * hq * dh * es + 2 * b * s * hkv * dh * es + 4 * b,
        4 * b * s * hq * dh, False, False, sdpa(q, k, v, n)))
    # seamless-m4t-large-v2's cross-attention at decode: 8 slots, 16/16
    # heads of 64 (group 1), every row of a 1,024-row cross cache
    cfg = configs.get(SERVE_SEAMLESS["arch"])
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = SERVE_SEAMLESS["max_seq"]
    q, k, v, n = flash_inputs(b, hq, hkv, dh, s, [s] * b, dtype, seed=13)
    cases.append((
        "flash_decode", f"{cfg.name} cross-attention b={b} hq/hkv={hq}/{hkv}"
        f" d={dh} s={s} kv_len={s} {g.describe()}", dtype,
        lambda a=(q, k, v), n=n: fd.flash_decode_attention(
            *a, kv_len=n, variant=g),
        lambda a=(q, k, v), n=n, dh=dh: fd.plain(g, *a, n, dh ** -0.5),
        2 * b * hq * dh * es + 2 * b * s * hkv * dh * es + 4 * b,
        4 * b * s * hq * dh, False, False, sdpa(q, k, v, n)))
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
    "prefill_attention": ("src/repro_torch/kernels/csrc/prefill_attention.cu",
                          None),
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


def run_case(case, tols=None) -> tuple:
    """Hold one kernel_cases-form case against its plain version (at
    ``tols``, else the kernel's default tolerance) and time it beside its
    bound; logs one line. Returns (ok, max abs error, ms, plain ms,
    library ms or None, bound ms)."""
    name, label, dtype, kern, plain, nbytes, nops, l2_cold, _, library \
        = case
    got, want = kern(), plain()
    torch.cuda.synchronize()
    tols = tols or (DECODE_TOL if name in DECODE else TOL)
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
        + (f"sdpa {lib_ms * 1e3:.2f} us, " if lib_ms is not None else "")
        + f"bound {bound_ms * 1e3:.3f} us (bytes)"
        f"{', L2 cold' if l2_cold else ''}")
    return err[2], err[0], ms, plain_ms, lib_ms, bound_ms


# the benchmark cells' prefill shapes: (label, seq, q heads, kv heads,
# head_dim, window)
PREFILL_SHAPES = (
    ("yi-34b, 512 bucket", 512, 56, 8, 128, None),
    ("yi-34b, 2,048 bucket", 2048, 56, 8, 128, None),
    ("h2o-danube-1.8b, 1,024 bucket", 1024, 32, 8, 80, 4096),
    ("h2o-danube-1.8b, 4,096 bucket", 4096, 32, 8, 80, 4096),
    ("h2o-danube-1.8b, 7,168 exact", 7168, 32, 8, 80, 4096))


def prefill_sdpa(q, k, v, window):
    """The library yardstick: one scaled_dot_product_attention call on
    the prefill inputs (views; a window's mask made once)."""
    s = q.shape[1]
    q4, k4, v4 = (t.transpose(1, 2) for t in (q, k, v))
    if window is None or window >= s:
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, enable_gqa=True)
    i = torch.arange(s, device=q.device)
    mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask, enable_gqa=True)


def phase_prefill_attention(rows_out: dict) -> bool:
    """2c: the prefill attention at ``PREFILL_SHAPES`` against the walk,
    timed beside its bound, the walk and SDPA; its kernel-table row (the
    2,048-row yi shape) goes to ``rows_out``."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import prefill_attention as pa

    ok, shapes = True, []
    bf = torch.bfloat16
    for label, s, hq, hkv, dh, window in PREFILL_SHAPES:
        q = randn((1, s, hq, dh), bf, 1)
        k = randn((1, s, hkv, dh), bf, 2)
        v = randn((1, s, hkv, dh), bf, 3)
        kern = functools.partial(ops.prefill_attention, q, k, v,
                                 window=window)
        plain = functools.partial(pa.walk, q, k, v, True, window)
        n0 = pa.prefill_attention.launches
        got = kern()
        want, _ = plain()
        torch.cuda.synchronize()
        err, rel, good, need = compare(got, want, DECODE_TOL)
        good &= pa.prefill_attention.launches == n0 + 1
        ok &= good
        flops, nbytes = pa.work(batch=1, seq=s, q_heads=hq, kv_heads=hkv,
                                head_dim=dh, window=window)
        bound_ms = max(flops / PEAK_OPS_S[bf], nbytes / HBM_BYTES_S) * 1e3
        ms = device_ms(kern)
        plain_ms = device_ms(lambda: plain()[0], reps=3, rounds=3)
        lib_ms = device_ms(prefill_sdpa(q, k, v, window))
        row = {"shape": label, "seq": s, "heads": f"{hq}/{hkv}",
               "head_dim": dh, "window": window, "max_abs_err": err,
               "least_atol": need, "ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": bound_ms,
               "bound_share": bound_ms / ms, "flops": flops,
               "bytes": nbytes}
        shapes.append(row)
        log(f"  prefill_attention bf16 {label} ({hq}/{hkv} heads of {dh}"
            f"{', window ' + str(window) if window else ''}): max_abs="
            f"{err:.3e} max_rel={rel:.3e} least atol {need:.2e} "
            f"{'ok' if good else 'MISMATCH'}; kernel {ms * 1e3:.2f} us "
            f"({100 * bound_ms / ms:.1f}% of its bound "
            f"{bound_ms * 1e3:.2f} us, {flops / ms / 1e9:.1f} TFLOP/s), "
            f"walk {plain_ms * 1e3:.2f} us, sdpa {lib_ms * 1e3:.2f} us")
    main = shapes[1]
    src, replaces = SOURCES["prefill_attention"]
    rows_out["prefill_attention"] = {
        "name": "prefill_attention", "route": "cuda", "source": src,
        "replaces": replaces, "launches": None,
        "max_abs_err": max(r["max_abs_err"] for r in shapes),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": "operations",
        "library_ms": main["library_ms"], "shape": main["shape"],
        "timing": "50 launches in a CUDA graph, L2 warm, median of 5 "
                  "(the walk: 3, median of 3)", "shapes": shapes}
    return ok


def phase_kernels(rows_out: dict) -> bool:
    ok = True
    decode_plans()
    for case in kernel_cases():
        name, label, dtype, _, _, _, _, l2_cold, main, _ = case
        good, max_abs, ms, plain_ms, lib_ms, bound_ms = run_case(case)
        ok &= good
        if main and dtype == torch.bfloat16:
            src, replaces = SOURCES[name]
            rows_out[name] = {
                "name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": None,
                "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
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
# arch -> (streams, metrics) of its phase 4d-4f serve (phase 7b reads
# qwen3-8b's)
SERVED: dict = {}


def serve_params(cfg, seed: int):
    """Seeded full-width weights, made once per (arch, depth, seed)."""
    from repro_torch.models import registry
    key = (cfg.name, cfg.n_layers, seed)
    if key not in _PARAMS:
        t0 = time.perf_counter()
        _PARAMS[key] = registry.init_params(cfg, seed=seed)
        torch.cuda.synchronize()
        ff = (f"{cfg.n_experts} experts top-{cfg.top_k} of expert_ff "
              f"{cfg.expert_ff}" if cfg.family == "moe"
              else f"d_ff {cfg.d_ff}")
        if cfg.family == "hybrid":
            ff += f", lru_width {cfg.lru_width}"
        elif cfg.family == "xlstm":
            ff = "periods of 7 mLSTM and 1 sLSTM blocks"
        elif cfg.family == "encdec":
            ff += f", {cfg.enc_layers} encoder layers, frame prompts"
        log(f"  {cfg.name} full width ({cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, {ff}, "
            f"vocab {cfg.padded_vocab}, window {cfg.window}) "
            f"{cfg.dtype}, seeded init {time.perf_counter() - t0:.1f} s, "
            f"weights {param_bytes(_PARAMS[key]) / 1e9:.3f} GB")
    return _PARAMS[key]


def param_bytes(tree) -> int:
    """Bytes of a parameter tree's tensors."""
    if isinstance(tree, dict):
        return sum(param_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(param_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def free_models() -> None:
    """Drop every cached model and return the allocator's free blocks to
    the card: a 34B model in bf16 needs the card to itself."""
    _PARAMS.clear()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def serve_config(s: dict):
    """The config phase 4 serves for ``s``: ``s["arch"]`` at full width,
    at ``s["n_layers"]`` layers where ``s`` cuts the depth."""
    from repro_torch import configs
    cfg = configs.get(s["arch"])
    if s.get("n_layers"):
        cfg = dataclasses.replace(cfg, n_layers=s["n_layers"])
    return cfg


def phase_serve(label: str, s: dict) -> tuple[bool, dict, list, dict]:
    """Serve ``s["requests"]`` requests of ``s["max_new"]`` tokens on
    ``s["arch"]`` at full width; returns (ok, launch counts of the run,
    the streams, the metrics). ``s`` may name ``n_layers`` (a cut depth),
    ``num_pages`` (an oversubscribed pool), ``paged=False`` (the
    contiguous cache), ``sampled`` (every other request sampled with
    ``SAMPLED`` and its own seed), ``shared`` (the shared-prefix
    prompts), ``prefix_cache`` (off when False), ``scheduler``,
    ``priorities`` (``"rid"``: the JAX benchmark's ``(rid * 5) % 3``) and
    ``lengths`` (the lengths of the last prompts)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import (measure, prompts_for,
                                          shared_prefix_prompts)
    from repro_torch.serving import SamplingParams

    cfg = serve_config(s)
    params = serve_params(cfg, s["seed"])
    if s.get("shared"):
        prompts = shared_prefix_prompts(cfg, s["seed"])
    else:
        prompts = prompts_for(cfg, s["requests"], s["min_prompt"],
                              s["max_prompt"], s["seed"],
                              crossing=s["crossing"],
                              lengths=s.get("lengths", ()))
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
    elif cfg.family == "xlstm":
        layout = "contiguous recurrent state (mLSTM and sLSTM)"
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


def cache_bytes(cfg, slots: int, max_seq: int, names=None) -> int:
    """Bytes of the contiguous cache's leaves (``names``, default all) for
    ``slots`` slots of ``max_seq`` rows."""
    from repro_torch.models import registry
    spec, _ = registry.cache_spec(cfg, slots, max_seq)
    return sum(int(np.prod(shape)) * torch.tensor([], dtype=dt)
               .element_size() for name, (shape, dt) in spec.items()
               if names is None or name in names)


def phase_serve_bound(s: dict) -> tuple[bool, dict, dict]:
    """``phase_serve`` of ``s`` with the reintegrated genomes, its decode
    step beside the step's bound (every weight a decode step reads, once,
    and the embedding table's rows of the step's tokens, over the card's
    memory rate: every weight but the table, the encoder-decoder's
    encoder left out too; the KV rows left out, but the xLSTM state read
    and written whole and the encoder-decoder's cross K/V read whole) and,
    for a family that prefills at exact length, the check that it did.
    Returns (ok, launch counts, the metrics)."""
    from repro_torch.models import registry
    cfg = serve_config(s)
    ok, counts, streams, m = phase_serve("reintegrated genomes", s)
    SERVED[cfg.name] = (streams, m)
    params = serve_params(cfg, s["seed"])
    emb = params["embed"]
    skip = ("embed", "enc_layers", "enc_norm")
    step_bytes = param_bytes({k: v for k, v in params.items()
                              if k not in skip}) \
        + s["slots"] * emb.shape[1] * emb.element_size()
    state = cache_bytes(cfg, s["slots"], s["max_seq"])
    if cfg.family == "xlstm":
        step_bytes += 2 * state
    elif cfg.family == "encdec":
        step_bytes += cache_bytes(cfg, s["slots"], s["max_seq"],
                                  ("ck", "cv"))
    m.update(cache_bytes=state)
    log(f"  {cfg.name}: contiguous cache {state / 1e9:.3f} GB for "
        f"{s['slots']} slots of {s['max_seq']} rows"
        + (f" ({cache_bytes(cfg, s['slots'], 1) / 1e9:.3f} GB at max_seq "
           "1: the state does not grow)" if cfg.family == "xlstm" else ""))
    bound_ms = step_bytes / HBM_BYTES_S * 1e3
    step_ms = 1e3 * m["decode_step_s"]
    m.update(bound_ms=bound_ms, step_bytes=step_bytes)
    log(f"  {cfg.name} ({cfg.n_layers} layers) decode step {step_ms:.3f} ms"
        f" against its bound {bound_ms:.3f} ms ({step_bytes / 1e9:.3f} GB "
        f"a step at {HBM_BYTES_S / 1e12:.2f} TB/s; "
        f"{100 * bound_ms / step_ms:.1f}% of the bound); tok_s="
        f"{m['tok_s']:.1f} mean_ttft_s={m['ttft_s']:.4f}; peak_mem_GiB="
        f"{m['peak_mem_gib']:.2f}")
    if not registry.pad_prefill_ok(cfg):
        lengths = len(set(m["prompt_lens"]))
        exact = not m["paged"] and len(m["prefill_buckets"]) == lengths \
            and set(m["prefill_buckets"]) == set(m["prompt_lens"])
        log(f"  contiguous cache, {len(m['prefill_buckets'])} prefill "
            f"shapes for {lengths} prompt lengths (exact-length prefill): "
            f"{'ok' if exact else 'WRONG'}")
        ok &= exact
    return ok, counts, m


def phase_serve_configs() -> tuple[dict, dict]:
    """4e: qwen3-8b and recurrentgemma-2b at full width and depth, then
    yi-34b and chameleon-34b, each alone on the card, at full depth or
    the largest of 3/4 and 1/2 of it that fits beside the cache (an
    out-of-memory error is logged, never silent). Returns (ok by path,
    launch counts by path)."""
    ok, counts = {}, {}
    for s in SERVE_34B:
        counts["serve_" + s["arch"].split("-")[0]] = dict.fromkeys(SOURCES, 0)
    for path, s in (("serve_qwen3", SERVE_QWEN3),
                    ("serve_recurrentgemma", SERVE_RGEMMA)):
        ok[path], counts[path], _ = phase_serve_bound(s)
    for s in SERVE_34B:
        path = "serve_" + s["arch"].split("-")[0]
        full = serve_config(s).n_layers
        ok[path] = False
        for depth in (full, 3 * full // 4, full // 2):
            free_models()
            log(f"  {s['arch']} at {depth} of {full} layers, alone on the "
                f"card ({torch.cuda.mem_get_info()[0] / 2**30:.2f} GiB "
                "free)")
            try:
                ok[path], counts[path], _ = phase_serve_bound(
                    dict(s, n_layers=depth))
            except RuntimeError as e:
                if "out of memory" not in str(e):
                    raise
                log(f"  {s['arch']} at {depth} layers does not fit: "
                    f"{str(e).splitlines()[0]}")
                continue
            if depth < full:
                log(f"  {s['arch']}: CUT to {depth} of {full} layers, the "
                    "largest depth that fit")
            break
        free_models()
    return ok, counts


def phase_serve_families() -> tuple[dict, dict]:
    """4f: xlstm-1.3b and seamless-m4t-large-v2 at full width, each alone
    on the card (every earlier model freed first). Returns (ok by path,
    launch counts by path)."""
    ok, counts = {}, {}
    for path, s in (("serve_xlstm", SERVE_XLSTM),
                    ("serve_seamless", SERVE_SEAMLESS)):
        free_models()
        ok[path], counts[path], _ = phase_serve_bound(s)
    free_models()
    return ok, counts


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


def launches_a_pass(cfg) -> dict:
    """{"prefill", "decode": (rmsnorm calls, silu launches,
    decode-attention launches, prefill-attention launches)} of one pass
    of ``cfg``: a dense or MoE layer calls the norm twice (and the final
    norm once) and silu once, in a decode pass the decode attention once
    and in a prefill the prefill attention once (bf16 only: an fp32
    model's stays on the walk); the Griffin hybrid's norms are plain,
    every layer's MLP launches silu, and only its attention layers (one a
    period of three) launch an attention; the xLSTM launches none of the
    kernels; the encoder-decoder's norms are plain, its prefill launches
    silu in every encoder and decoder layer and the decode attention twice
    a decoder layer (the BOS step's self and cross attention; its encoder
    is not causal), and a decode pass silu and the attention twice a
    decoder layer."""
    n = cfg.n_layers
    bf16 = cfg.dtype == "bfloat16"
    if cfg.family == "xlstm":
        return {"prefill": (0, 0, 0, 0), "decode": (0, 0, 0, 0)}
    if cfg.family == "encdec":
        return {"prefill": (0, cfg.enc_layers + n, 2 * n, 0),
                "decode": (0, n, 2 * n, 0)}
    if cfg.family == "hybrid":
        return {"prefill": (0, n, 0, bf16 * (n // 3)),
                "decode": (0, n, n // 3, 0)}
    return {"prefill": (2 * n + 1, n, 0, bf16 * n),
            "decode": (2 * n + 1, n, n, 0)}


def expected_launches(cfg, m: dict, k: int = 0, draft=None) -> dict:
    """What a serve's kernels launch, from its counts: every prefill
    (whole or suffix) and every decode pass launches what
    ``launches_a_pass`` says, the attention on the layout's kernel (a
    two-pass rmsnorm twice a call); the prefill attention runs in whole
    prefills only (a suffix prefill attends over the prefix's pages in
    plain PyTorch). A spec step (``k`` drafts) makes k + 1 target passes
    and, with a ``draft`` model config, k + 1 draft passes (contiguous
    ``flash_decode``) and one whole draft prefill per prefill. The merge
    is not on the path."""
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
    models = [(cfg, attn, m["prefills"])] + (
        [(draft, "flash_decode", prefills)] if draft is not None else [])
    for c, kernel, whole in models:
        counts = launches_a_pass(c)
        for kind, times in (("prefill", prefills), ("decode", passes)):
            norms, silu, attn_calls, _ = counts[kind]
            want["fused_add_rmsnorm"] += norm * norms * times
            want["silu_and_mul"] += silu * times
            want[kernel] += attn_calls * times
        want["prefill_attention"] += counts["prefill"][3] * whole
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

    s = {c["arch"]: c for c in (SERVE, SERVE_H2O, SERVE_OLMOE)}[arch]
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


def time_decode() -> dict:
    """``--time-decode``: rows 3 and 5 of the kernel table in bf16 with
    the installed genomes (the paged decode at qwen2's shape, the
    contiguous one at h2o-danube's) and kernel 5 at recurrentgemma-2b's
    (10/1 heads of 256, 2,048 rows), through the ``repro_torch`` first on
    ``sys.path`` after its library is built or loaded, with the kernels of
    that build that spill. Uses only what earlier commits' packages have
    too."""
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import flash_decode as fd
    _build.library()
    info = _build.build_info
    bf = torch.bfloat16
    out = {"build_s": info["seconds"], "cached": info["cached"],
           "spills": [r for r in ptxas_kernels(info["log"]) if r[2]]}
    q, k, v, t, n = paged_inputs(8, 14, 2, 64, 16, SERVE["max_seq"] // 16,
                                 bf)
    g3 = ops.get_variant("paged_flash_decode")
    out["row3_us"] = 1e3 * device_ms(
        lambda: fd.paged_flash_decode_attention(q, k, v, t, kv_len=n,
                                                variant=g3))
    g5 = ops.get_variant("flash_decode")
    for key, (hq, hkv, dh, s) in (("row5_us", (32, 8, 80, 4096)),
                                  ("recurrentgemma_us", (10, 1, 256, 2048))):
        q5, k5, v5, n5 = flash_inputs(8, hq, hkv, dh, s, [s] * 8, bf,
                                      seed=11)
        out[key] = 1e3 * device_ms(
            lambda: fd.flash_decode_attention(q5, k5, v5, kv_len=n5,
                                              variant=g5))
    return out


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


def phase_reference_moe() -> bool:
    """Reduced olmoe config in fp32: prefill and decode logits (three
    slots of the contiguous cache) and greedy streams on ten slots, more
    than the decode capacity of 8, so that slots, idle ones included,
    compete for expert capacity: on the card against the plain versions
    on the CPU. TF32 must be off: a TF32 router would pick other experts
    on the card than on the CPU."""
    from repro_torch import configs
    from repro_torch.launch.serve import prompts_for
    from repro_torch.models import moe, registry
    from repro_torch.serving import LLMEngine

    tf32 = torch.backends.cuda.matmul.allow_tf32 \
        or torch.get_float32_matmul_precision() != "highest"
    log(f"  TF32 matmuls {'ON' if tf32 else 'off'} (float32 matmul "
        f"precision {torch.get_float32_matmul_precision()!r})")
    cfg = dataclasses.replace(configs.smoke(SERVE_OLMOE["arch"]),
                              dtype="float32")
    gpu = registry.init_params(cfg, seed=3)
    cpu = moe.cast_params(gpu, cfg, torch.device("cpu"))
    ok = not tf32 and gpu["layers"][0]["router"].dtype == torch.float32
    rng = np.random.default_rng(3)
    toks = torch.tensor(rng.integers(0, cfg.vocab, (3, 40)))
    i32 = dict(dtype=torch.int32)
    outs = []
    for params, dev in ((gpu, "cuda"), (cpu, "cpu")):
        lg, kv = registry.prefill(params, cfg, toks.to(dev), cache_len=64)
        steps = []
        for t in range(3):
            logits, kv = registry.decode_cached(
                params, cfg, kv, torch.tensor([5 + t, 7, 9], **i32).to(dev),
                torch.tensor([40 + t] * 3, **i32).to(dev))
            steps.append(logits.cpu())
        outs.append((lg.cpu(), torch.stack(steps), kv["k"].cpu()))
    for what, g, c in zip(("prefill logits (3 x 40 tokens)",
                           "decode logits (3 steps, 3 slots)",
                           "cache after the steps"), *outs):
        err = compare(g, c)
        ok &= err[2]
        log(f"  {what} card vs cpu: max_abs={err[0]:.3e} "
            f"{'ok' if err[2] else 'MISMATCH'}")
    prompts = prompts_for(cfg, 14, 3, 40, 3)
    runs = []
    for params, dev in ((gpu, None), (cpu, "cpu")):
        llm = LLMEngine(params, cfg, slots=10, max_seq=64, device=dev)
        runs.append(([o.tokens for o in llm.generate(
            prompts, max_new_tokens=[4 + 2 * (i % 5) for i in range(14)])],
            llm.stats()["steps"]))
    same_ = runs[0] == runs[1]
    log(f"  greedy streams card vs cpu (14 requests on 10 slots, decode "
        f"capacity {moe.capacity(cfg, 10)}, steps {runs[0][1]} vs "
        f"{runs[1][1]}): {'equal' if same_ else 'DIFFER'}")
    return ok and same_


def phase_reference_configs() -> bool:
    """Reduced qwen3-8b (qk-norm) and recurrentgemma-2b (window 32, its
    conv weights drawn non-zero: seeded normal times 0.5) in fp32:
    prefill logits and every cache leaf for three prompts of 45 tokens
    (past the window), then 40 decode steps (the ring wraps) of logits
    and leaves on three slots of the contiguous cache, and greedy streams
    of prompts under and past the window, on the card against the plain
    versions on the CPU."""
    from repro_torch import configs
    from repro_torch.launch.serve import prompts_for
    from repro_torch.models import registry
    from repro_torch.serving import LLMEngine

    ok = True
    for arch, seed in (("qwen3-8b", 4), ("recurrentgemma-2b", 5)):
        cfg = dataclasses.replace(configs.smoke(arch), dtype="float32")
        cpu = registry.init_params(cfg, seed=seed, device="cpu")
        if cfg.family == "hybrid":
            gen = torch.Generator().manual_seed(seed)
            for block in [b for p in cpu["periods"] for b in p["rec"]] \
                    + cpu["tail"]:
                block["conv_w"] = 0.5 * torch.randn(block["conv_w"].shape,
                                                    generator=gen)
        mod = registry.module_for(cfg)
        gpu = mod.cast_params(cpu, cfg, torch.device("cuda"))
        rng = np.random.default_rng(seed)
        toks = torch.tensor(rng.integers(0, cfg.vocab, (3, 45)))
        feed = rng.integers(0, cfg.vocab, (40, 3))
        outs = []
        for params, dev in ((gpu, "cuda"), (cpu, "cpu")):
            lg, kv = registry.prefill(params, cfg, toks.to(dev),
                                      cache_len=96)
            # copies: the steps below update the cache in place
            first = {k: v.to("cpu", copy=True) for k, v in kv.items()}
            steps = []
            for t in range(40):
                logits, kv = registry.decode_cached(
                    params, cfg, kv,
                    torch.tensor(feed[t], dtype=torch.int32, device=dev),
                    torch.tensor([45 + t] * 3, dtype=torch.int32,
                                 device=dev))
                steps.append(logits.cpu())
            outs.append((lg.cpu(), first, torch.stack(steps),
                         {k: v.cpu() for k, v in kv.items()}))
        (lg_g, first_g, steps_g, last_g), (lg_c, first_c, steps_c,
                                           last_c) = outs
        checks = [("prefill logits (3 x 45 tokens)", lg_g, lg_c),
                  ("decode logits (40 steps, 3 slots)", steps_g, steps_c)]
        checks += [(f"cache leaf {k} after prefill", first_g[k], first_c[k])
                   for k in first_c]
        checks += [(f"cache leaf {k} after the steps", last_g[k], last_c[k])
                   for k in last_c]
        for what, g, c in checks:
            err = compare(g, c)
            ok &= err[2]
            log(f"  {arch} {what} card vs cpu: max_abs={err[0]:.3e} "
                f"{'ok' if err[2] else 'MISMATCH'}")
        window = cfg.window or 0
        prompts = prompts_for(cfg, 6, 3, 40, seed,
                              crossing=2 if window else 0)
        runs = []
        for params, dev in ((gpu, None), (cpu, "cpu")):
            llm = LLMEngine(params, cfg, slots=3, max_seq=128, device=dev)
            runs.append(([o.tokens for o in llm.generate(
                prompts, max_new_tokens=20)], llm.stats()["steps"]))
        same_ = runs[0] == runs[1]
        ok &= same_
        log(f"  {arch} greedy streams card vs cpu (prompt lengths "
            f"{[len(p) for p in prompts]}, steps {runs[0][1]} vs "
            f"{runs[1][1]}): {'equal' if same_ else 'DIFFER'}")
    return ok


def _fan_in_gates(params, cfg, seed: int) -> None:
    """Redraw every mLSTM block's ``w_i``, ``w_f`` in place at ``dh **
    -0.5``: at the JAX init's ``heads ** -0.5`` the block's output is so
    ill-conditioned that one ulp of its input moves it past the fp32
    tolerance (``tests/test_torch_xlstm.py``), so the card and the CPU,
    whose sums round otherwise, could not be compared there."""
    gen = torch.Generator().manual_seed(seed)
    for block in [b for p in params["periods"] for b in p["mlstm"]]:
        for name in ("w_i", "w_f"):
            w = block[name]
            block[name] = torch.randn(w.shape, generator=gen).clamp(
                -2, 2) * w.shape[-1] ** -0.5


def phase_reference_families() -> bool:
    """Reduced xlstm-1.3b (its mLSTM gates redrawn at their fan-in scale,
    ``_fan_in_gates``) and seamless-m4t-large-v2 in fp32: prefill logits
    and every cache leaf for three prompts (130 tokens: two chunks, the
    second ragged; 700 frames: the encoder's pad rows), then 40 decode
    steps of logits and leaves, and greedy streams (seamless also on one
    slot reused by a shorter source, whose stream depends on the last
    occupant's cross rows), on the card against the plain versions on the
    CPU."""
    from repro_torch import configs
    from repro_torch.launch.serve import prompts_for
    from repro_torch.models import registry
    from repro_torch.serving import LLMEngine

    ok = True
    for arch, seed, s in (("xlstm-1.3b", 6, 130),
                          ("seamless-m4t-large-v2", 7, 700)):
        cfg = dataclasses.replace(configs.smoke(arch), dtype="float32")
        cpu = registry.init_params(cfg, seed=seed, device="cpu")
        if cfg.family == "xlstm":
            _fan_in_gates(cpu, cfg, seed)
        gpu = registry.module_for(cfg).cast_params(cpu, cfg,
                                                   torch.device("cuda"))
        rng = np.random.default_rng(seed)
        if cfg.frontend == "frames":
            inp = torch.tensor(rng.standard_normal((3, s, cfg.d_model)),
                               dtype=torch.float32)
            start = 1
        else:
            inp = torch.tensor(rng.integers(0, cfg.vocab, (3, s)))
            start = s
        feed = rng.integers(0, cfg.vocab, (40, 3))
        outs = []
        for params, dev in ((gpu, "cuda"), (cpu, "cpu")):
            lg, kv = registry.prefill(params, cfg, inp.to(dev), cache_len=96)
            first = {k: v.to("cpu", copy=True) for k, v in kv.items()}
            steps = []
            for t in range(40):
                logits, kv = registry.decode_cached(
                    params, cfg, kv,
                    torch.tensor(feed[t], dtype=torch.int32, device=dev),
                    torch.tensor([start + t] * 3, dtype=torch.int32,
                                 device=dev))
                steps.append(logits.cpu())
            outs.append((lg.cpu(), first, torch.stack(steps),
                         {k: v.cpu() for k, v in kv.items()}))
        (lg_g, first_g, steps_g, last_g), (lg_c, first_c, steps_c,
                                           last_c) = outs
        checks = [(f"prefill logits (3 x {s})", lg_g, lg_c),
                  ("decode logits (40 steps, 3 slots)", steps_g, steps_c)]
        checks += [(f"cache leaf {k} after prefill", first_g[k], first_c[k])
                   for k in first_c]
        checks += [(f"cache leaf {k} after the steps", last_g[k], last_c[k])
                   for k in last_c]
        for what, g, c in checks:
            err = compare(g, c)
            ok &= err[2]
            log(f"  {arch} {what} card vs cpu: max_abs={err[0]:.3e} "
                f"{'ok' if err[2] else 'MISMATCH'}")
        prompts = prompts_for(cfg, 6, 3, 100, seed)
        runs = [(prompts, 3)]
        if cfg.frontend == "frames":
            forty, six = prompts_for(cfg, 2, 3, 100, seed + 1,
                                     lengths=(40, 6))
            runs += [([six], 1), ([forty, six], 1)]
        for wave, slots in runs:
            got = []
            for params, dev in ((gpu, None), (cpu, "cpu")):
                llm = LLMEngine(params, cfg, slots=slots, max_seq=128,
                                device=dev)
                got.append(([o.tokens for o in llm.generate(
                    wave, max_new_tokens=20)], llm.stats()["steps"]))
            same_ = got[0] == got[1]
            ok &= same_
            log(f"  {arch} greedy streams card vs cpu on {slots} slots "
                f"(prompt lengths {[len(p) for p in wave]}, steps "
                f"{got[0][1]} vs {got[1][1]}): "
                f"{'equal' if same_ else 'DIFFER'}")
    return ok


# phase 6: qwen2-0.5b trained at full width and depth through
# launch/train.run, checkpoints every 4 steps and a failure at step 6
TRAIN = dict(arch="qwen2-0.5b", steps=8, batch=8, seq=1024, microbatches=2,
             ckpt_every=4, fail_at=6)
# one step of each other family at full width, the depth cut to one layer
# (olmoe, seamless: one encoder and one decoder layer) or one period
TRAIN_CUTS = (("olmoe-1b-7b", 1), ("recurrentgemma-2b", 3),
              ("xlstm-1.3b", 8), ("seamless-m4t-large-v2", 1))
TRAIN_CUT_SHAPE = (2, 512)          # batch, seq
TRAIN_COMPRESS_SHAPE = (4, 1024)


def train_launches(cfg, passes: int) -> dict:
    """What ``passes`` microbatches of training launch: each layer's
    forward and its recompute in the backward pass (``layers.remat``)
    launch what a prefill does, the final norm (outside the recompute)
    once; the hybrid's tail blocks are not recomputed (a two-pass rmsnorm
    twice a call). The backward passes of the kernels' Functions are
    plain PyTorch."""
    from repro_torch.kernels import ops

    norm = 2 if ops.get_variant("fused_add_rmsnorm").two_pass else 1
    want = dict.fromkeys(SOURCES, 0)
    n = cfg.n_layers
    if cfg.family in ("dense", "moe"):
        norms, silu = 4 * n + 1, 2 * n
    elif cfg.family == "hybrid":
        periods = n // 3
        norms, silu = 0, 6 * periods + (n - 3 * periods)
    elif cfg.family == "encdec":
        norms, silu = 0, 2 * (cfg.enc_layers + n)
    else:
        norms, silu = 0, 0
    want["fused_add_rmsnorm"] = norm * norms * passes
    want["silu_and_mul"] = silu * passes
    return want


def train_flops(cfg, batch: int, seq: int) -> tuple[float, int]:
    """(the operations of one training step, the matrix parameters):
    ``6 N T`` for the N weights of the matrix products (the output head
    included, the embedding lookup not) over T tokens, and three times the
    causal attention's useful products (``2 B Hq S^2 dh`` a layer
    forward)."""
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    layer = d * hq * dh * 2 + 2 * d * hkv * dh + 3 * d * cfg.d_ff
    n = cfg.n_layers * layer + d * cfg.padded_vocab
    attn = 3 * 2 * batch * hq * seq * seq * dh * cfg.n_layers
    return 6.0 * n * batch * seq + attn, n


def _finite(*xs) -> bool:
    return all(bool(torch.isfinite(torch.as_tensor(x)).all()) for x in xs)


def phase_train_qwen2(card: str) -> tuple[bool, dict]:
    """6 (a): ``launch.train.run`` on qwen2-0.5b at full width and depth
    (bf16 compute, fp32 masters), 8 steps of 8 x 1,024 tokens in 2
    microbatches, checkpoints every 4 steps, a failure injected at step 6:
    the restart restores step 4 and its cursor and reruns steps 4 and 5,
    whose losses must equal the first attempt's bit for bit (deterministic
    algorithms on). Checks the losses finite and the launches
    (``train_launches``); prints the median step, tokens/s, the peak
    memory and the FLOP bound's share."""
    import shutil

    import torch.utils.deterministic
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    t = TRAIN
    cfg = configs.get(t["arch"])
    ckpt = os.path.join(ROOT, "build", "train_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    # the rerun's equal losses rest on one stream and the same algorithms
    # (cuBLAS is deterministic on one stream): PyTorch read the workspace
    # size when phase 1 made the first handle, so this setting only
    # satisfies the check use_deterministic_algorithms makes
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    # the step fills no fresh buffer (deterministic mode would by default)
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = False
    history: list = []
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        out = train.run(arch=t["arch"], smoke=False, steps=t["steps"],
                        batch=t["batch"], seq=t["seq"],
                        microbatches=t["microbatches"], ckpt_dir=ckpt,
                        ckpt_every=t["ckpt_every"], fail_at=t["fail_at"],
                        log_every=1, device="cuda", history=history)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    shutil.rmtree(ckpt, ignore_errors=True)
    steps = [h[0] for h in history]
    want_steps = list(range(t["fail_at"])) + list(
        range(t["fail_at"] - 2, t["steps"]))
    ok = steps == want_steps
    log(f"  steps run {steps} (expected {want_steps}) "
        f"{'ok' if ok else 'WRONG'}")
    first = {s: loss for s, loss, _ in history[:t["fail_at"]]}
    rerun = {s: loss for s, loss, _ in history[t["fail_at"]:]}
    same_ = all(first[s] == rerun[s] for s in range(t["fail_at"] - 2,
                                                   t["fail_at"]))
    ok &= same_
    log("  restart: steps 4-5 losses " + ", ".join(
        f"{first[s]!r} / {rerun[s]!r}" for s in (4, 5))
        + f" (first attempt / rerun): {'bit for bit' if same_ else 'DIFFER'}"
        " under torch.use_deterministic_algorithms(True)")
    fin = _finite([h[1] for h in history])
    ok &= fin
    log(f"  losses finite {fin}: " + ", ".join(
        f"{s_}: {loss:.4f}" for s_, loss, _ in history))
    want = train_launches(cfg, t["microbatches"] * len(history))
    ok &= check_launches({"launches": counts}, want)
    # the median step past each attempt's first (its warm-up)
    warm = [h[2] for i, h in enumerate(history)
            if i and h[0] == history[i - 1][0] + 1]
    step_s = float(np.median(warm))
    tokens = t["batch"] * t["seq"]
    flops, n = train_flops(cfg, t["batch"], t["seq"])
    bound_ms = 1e3 * flops / PEAK_OPS_S[torch.bfloat16]
    log(f"  {cfg.name} train step ({t['batch']} x {t['seq']} tokens, "
        f"{t['microbatches']} microbatches, {cfg.dtype} compute, fp32 "
        f"masters and AdamW): median {1e3 * step_s:.1f} ms "
        f"over {len(warm)} steps, {tokens / step_s:.0f} tokens/s, peak "
        f"memory {peak / 2**30:.2f} GiB; FLOP bound {bound_ms:.2f} ms "
        f"({flops / 1e12:.2f} TFLOP: 6 x {n / 1e6:.1f} M x {tokens} + "
        f"attention, at 989 TFLOP/s), {100 * bound_ms / (1e3 * step_s):.1f}%"
        f" of it; phase 6a {wall:.1f} s; {card}")
    return ok, counts


def train_cut_runs() -> list:
    """6 (b)'s runs: (config, ``TrainConfig``, (batch, seq)) of each
    ``TRAIN_CUTS`` family and of the compressed qwen2 step."""
    from repro_torch import configs
    from repro_torch.training.train_step import TrainConfig

    runs = [(dataclasses.replace(
        configs.get(arch), n_layers=depth,
        **({"enc_layers": depth} if arch.startswith("seamless") else {})),
        TrainConfig(), TRAIN_CUT_SHAPE) for arch, depth in TRAIN_CUTS]
    runs.append((configs.get("qwen2-0.5b"), TrainConfig(compress_grads=True),
                 TRAIN_COMPRESS_SHAPE))
    return runs


def train_kernel_shapes(cfg, batch: int, seq: int, microbatches: int) -> dict:
    """The input shape a training microbatch hands each kernel:
    ``fused_add_rmsnorm``'s x and residual ``[b, s, d]`` (the dense and MoE
    families), ``silu_and_mul``'s ``[b, s, 2 d_ff]`` (MoE: the experts'
    ``[E, N C, 2 F]``; the xLSTM launches neither)."""
    from repro_torch.models import moe

    b, out = batch // microbatches, {}
    if cfg.family in ("dense", "moe"):
        out["fused_add_rmsnorm"] = (b, seq, cfg.d_model)
    if cfg.family == "moe":
        g = min(moe.GROUP, b * seq)
        out["silu_and_mul"] = (cfg.n_experts,
                               b * seq // g * moe.capacity(cfg, g),
                               2 * cfg.expert_ff)
    elif cfg.family != "xlstm":
        out["silu_and_mul"] = (b, seq, 2 * cfg.d_ff)
    return out


def phase_train_cuts() -> tuple[bool, dict]:
    """6 (b): one train step (bf16 compute, fp32 masters) of each other
    family at full width, the depth cut (``TRAIN_CUTS``), and one of
    qwen2-0.5b at full depth with compressed gradients: a finite loss and
    gradient norm and the launches ``train_launches`` gives."""
    from repro_torch.data.pipeline import _batch_np
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.training import compression
    from repro_torch.training.train_step import init_state, make_train_step

    ok, counts = True, {}
    for cfg, tcfg, (b, s) in train_cut_runs():
        params = registry.init_master_params(cfg, seed=0, device="cuda")
        state = init_state(cfg, tcfg, params)
        step = make_train_step(cfg, tcfg)
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in _batch_np(cfg, b, s, 0, 0).items()}
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        dt = time.perf_counter() - t0
        path = "train_" + cfg.name.split("-")[0] + (
            "_compressed" if tcfg.compress_grads else "")
        counts[path] = ops.launch_counts()
        fin = _finite(loss, gn)
        ok &= fin
        extra = (f", compressed gradients, wire "
                 f"{compression.wire_bytes(params) / 1e9:.3f} GB a step"
                 if tcfg.compress_grads else "")
        log(f"  {cfg.name} ({cfg.n_layers} layers"
            + (f" + {cfg.enc_layers} encoder" if cfg.enc_layers else "")
            + f", {b} x {s} tokens{extra}): loss {loss:.4f}, grad norm "
            f"{gn:.4f}, finite {fin}, first step {1e3 * dt:.0f} ms")
        ok &= check_launches({"launches": counts[path]},
                             train_launches(cfg, tcfg.microbatches))
        del params, state, step, m
        gc.collect()
        torch.cuda.empty_cache()
    return ok, counts


def kernel_function_case(name: str, shape: tuple, dtype) -> list:
    """[(what, the Function's value, the plain version's)] for one kernel
    at ``shape``: its outputs (the kernel's launch, which must be the one
    launch of the call) against the plain version's on the same inputs,
    then its gradients against autograd through the plain version."""
    from repro_torch.kernels import ops, ref

    if name == "fused_add_rmsnorm":
        x, r, dy, dr = (randn(shape, dtype, s) for s in range(4))
        w = randn(shape[-1:], torch.float32, 4, 0.1) + 1.0
        leaves = [t.requires_grad_() for t in (x, r, w)]
        fn, plain = ops.fused_add_rmsnorm, ref.fused_add_rmsnorm
        cots = (dy, dr)
        whats = ("y", "r'", "dx", "dresidual", "dweight")
    else:
        leaves = [randn(shape, dtype, 5, 3.0).requires_grad_()]
        fn, plain = ops.silu_and_mul, ref.silu_and_mul
        cots = (randn(shape[:-1] + (shape[-1] // 2,), dtype, 6),)
        whats = ("out", "dx")
    n0 = ops.launch_counts()[name]
    got = fn(*leaves)
    torch.cuda.synchronize()
    launched = ops.launch_counts()[name] - n0
    want = plain(*leaves)
    got, want = ((o,) if torch.is_tensor(o) else tuple(o)
                 for o in (got, want))
    got_g = torch.autograd.grad(got, leaves, cots)
    want_g = torch.autograd.grad(want, leaves, cots)
    two = ops.get_variant(name).two_pass if name == "fused_add_rmsnorm" \
        else False
    if launched != (2 if two else 1):
        raise RuntimeError(f"{name} {shape}: the Function launched the "
                           f"kernel {launched} times")
    return list(zip(whats, [o.detach() for o in got] + list(got_g),
                    [o.detach() for o in want] + list(want_g)))


def phase_train_grads() -> bool:
    """6 (c): each kernel's autograd Function on the card at every shape
    that 6 (a) and 6 (b) hand it (``train_kernel_shapes``; their dtype,
    bf16, and qwen2's in fp32 too): the kernel's outputs against the plain
    version's, and the gradients against autograd through the plain
    version, at ``TOL``. Then one fp32 step of qwen2-0.5b cut to 2 layers
    (microbatches 2, ``cast_params=None``, AdamW at a rate of 1e-3 from the
    first step) on the card against the same step on the CPU: the loss and
    the norm at ``TOL``, both moments within 1e-4 of each leaf's largest,
    each parameter's move within 1e-3 of the rate; left out of the moves
    (and counted, at most 1%) are the elements whose gradient the two
    sides round apart by more than 2e-4 of its size, where Adam's first
    step turns a rounding error into up to +-lr (ROADMAP C, reference
    behaviour 6)."""
    from repro_torch import configs
    from repro_torch.data.pipeline import _batch_np
    from repro_torch.models import registry
    from repro_torch.training import optimizer, tree
    from repro_torch.training.train_step import (TrainConfig, init_state,
                                                 make_train_step)

    ok = True
    qwen = configs.get(TRAIN["arch"])
    runs = [(qwen, TRAIN["microbatches"], (TRAIN["batch"], TRAIN["seq"]))]
    runs += [(cfg, tcfg.microbatches, shape)
             for cfg, tcfg, shape in train_cut_runs()]
    cases: dict = {}
    for cfg, m, (b, s) in runs:
        for name, shape in train_kernel_shapes(cfg, b, s, m).items():
            cases.setdefault((name, shape, getattr(torch, cfg.dtype)),
                             cfg.name)
            if cfg is qwen:
                cases.setdefault((name, shape, torch.float32), cfg.name)
    for (name, shape, dtype), arch in cases.items():
        errs = [(what, compare(a, b))
                for what, a, b in kernel_function_case(name, shape, dtype)]
        good = all(e[2] for _, e in errs)
        ok &= good
        log(f"  {name} {list(shape)} {str(dtype)[6:]} ({arch}): Function "
            f"vs plain max_abs " + ", ".join(
                f"{what} {e[0]:.3e}" for what, e in errs)
            + f" {'ok' if good else 'MISMATCH'}")
        gc.collect()
        torch.cuda.empty_cache()

    lr, apart = 1e-3, 2e-4
    cfg = dataclasses.replace(qwen, n_layers=2, dtype="float32")
    tcfg = TrainConfig(microbatches=2, cast_params=None,
                       adamw=optimizer.AdamWConfig(lr=lr, warmup_steps=0))
    batch = _batch_np(cfg, 2, 128, 0, 0)
    p0 = tree.leaves(registry.init_master_params(cfg, seed=0, device="cpu"))
    outs = []
    for dev in ("cuda", "cpu"):
        params = registry.init_master_params(cfg, seed=0, device="cpu")
        params = tree.map_tree(lambda p: p.to(dev), params)
        state = init_state(cfg, tcfg, params)
        params, state, m = make_train_step(cfg, tcfg)(
            params, state, {k: torch.from_numpy(v).to(dev)
                            for k, v in batch.items()})
        outs.append((m, [tree.leaves(t) for t in (
            params, state["opt"].m, state["opt"].v)]))
    (m_g, (p_g, mom_g, v_g)), (m_c, (p_c, mom_c, v_c)) = outs
    good = all(compare(m_g[k].cpu(), m_c[k])[2] for k in ("loss",
                                                         "grad_norm"))
    # a first step's moment is (1 - b1) g
    keep = [(a.cpu() - b).abs() <= apart * torch.maximum(a.cpu().abs(),
                                                         b.abs())
            for a, b in zip(mom_g, mom_c)]
    left = sum(int((~k).sum()) for k in keep)
    total = sum(k.numel() for k in keep)
    good &= left <= 0.01 * total
    move = max(float(((a.cpu() - p) - (b - p))[k].abs().max()) / lr
               for k, p, a, b in zip(keep, p0, p_g, p_c))
    mom = max(float((a.cpu() - b).abs().max()
                    / b.abs().max().clamp(min=1e-30))
              for a, b in zip(mom_g + v_g, mom_c + v_c))
    good &= move <= 1e-3 and mom <= 1e-4
    ok &= good
    log(f"  fp32 train step of qwen2-0.5b (2 layers, 2 x 128 tokens, 2 "
        f"microbatches, lr {lr}) card vs cpu: loss {float(m_g['loss']):.6f}"
        f" / {float(m_c['loss']):.6f}, grad norm "
        f"{float(m_g['grad_norm']):.6f} / {float(m_c['grad_norm']):.6f}; "
        f"moves max |diff| {move:.3e} lr (limit 1e-3), moments max |diff| "
        f"{mom:.3e} of the leaf's largest (limit 1e-4); {left} of {total} "
        f"elements left out (gradients {apart} apart) "
        f"{'ok' if good else 'MISMATCH'}")
    return ok


# phase 7: the host-driven reference engine, the tensor-parallel engine at
# world 1, the per-rank kernel shapes of tensor parallelism, and two of the
# examples


def phase_reference_serve(streams: list,
                          serve_m: dict) -> tuple[bool, dict]:
    """7a: ``ReferenceEngine`` at full width on phase 4's qwen2-0.5b
    requests (8 slots of the contiguous cache, exact prefills, eager decode
    steps, one ``.item()`` a slot a step), its streams held to phase 4's
    under the bf16 rule and its tok_s beside phase 4's. Returns (ok, its
    launch counts)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import prompts_for
    from repro_torch.serving import ReferenceEngine, Request
    from repro_torch.serving.engine import WARMUP_STEPS

    s = SERVE
    cfg = serve_config(s)
    params = serve_params(cfg, s["seed"])
    prompts = prompts_for(cfg, s["requests"], s["min_prompt"],
                          s["max_prompt"], s["seed"])
    # a warm-up run (first uses of the prefill and decode shapes' GEMMs)
    warm = ReferenceEngine(params, cfg, slots=s["slots"],
                           max_seq=s["max_seq"])
    for rid, p in enumerate(prompts[:2]):
        warm.submit(Request(rid=rid, prompt=p, max_new_tokens=4))
    warm.run()
    del warm
    eng = ReferenceEngine(params, cfg, slots=s["slots"],
                          max_seq=s["max_seq"])
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=p, max_new_tokens=s["max_new"]))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    steps = 0
    while eng.queue or any(sl.req is not None for sl in eng.slots):
        steps += eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    got = [r.out_tokens for r in sorted(eng.finished, key=lambda r: r.rid)]
    tokens = sum(len(t) for t in got)
    log(f"  ReferenceEngine qwen2-0.5b: {len(prompts)} requests, {steps} "
        f"eager decode steps, {tokens} tokens in {wall:.3f} s: tok_s="
        f"{tokens / wall:.1f} against phase 4's captured engine tok_s="
        f"{serve_m['tok_s']:.1f} ({serve_m['steps']} steps)")
    ok = len(got) == len(prompts) \
        and all(len(t) == s["max_new"] for t in got)
    ok &= bf16_rule("reference streams against phase 4's", cfg, params,
                    prompts, streams, got)
    ok &= check_launches({"launches": counts}, expected_launches(
        cfg, {"steps": steps, "capture_warmups": WARMUP_STEPS,
              "prefills": len(prompts), "suffix_prefills": 0,
              "paged": False}))
    return ok, counts


def phase_mesh_serve(config_counts: dict) -> tuple[bool, dict]:
    """7b: the tensor-parallel engine over a ``(1, 1)`` mesh of one NCCL
    rank on phase 4e's qwen3-8b requests at full width: one capture of
    the measured engine holding the all-gathers, phase 4e's streams and
    launch counts, the decode step beside 4e's. Returns (ok, its launch
    counts)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import (free_port, init_world,
                                         make_local_mesh)
    from repro_torch.launch.serve import measure, prompts_for

    s = SERVE_QWEN3
    cfg = serve_config(s)
    params = serve_params(cfg, s["seed"])
    prompts = prompts_for(cfg, s["requests"], s["min_prompt"],
                          s["max_prompt"], s["seed"])
    want_streams, m4e = SERVED[cfg.name]
    init_world("cuda", rank=0, world_size=1, port=free_port())
    log(f"  NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}, backend "
        f"{dist.get_backend()}, world {dist.get_world_size()}")
    captured = []
    real = dist.all_gather_into_tensor

    def counted(*args, **kwargs):
        captured.append(torch.cuda.is_current_stream_capturing())
        return real(*args, **kwargs)
    try:
        dist.all_gather_into_tensor = counted
        mesh = make_local_mesh(1, "cuda")
        m, outs = measure(params, cfg, prompts, max_new=s["max_new"],
                          slots=s["slots"], max_seq=s["max_seq"],
                          page_size=s["page_size"], device="cuda",
                          mesh=mesh)
    finally:
        dist.all_gather_into_tensor = real
        dist.destroy_process_group()
    got = [o.tokens for o in outs]
    # the warm-up engine captures twice (argmax, then the draw of its
    # sampled request), the measured engine once; each capture records
    # one pass: heads and MLP a layer, the vocab once
    want_captured = 3 * (2 * cfg.n_layers + 1)
    log(f"  mesh {m['mesh']}: all-gathers {len(captured)}, "
        f"{sum(captured)} inside captures (expected {want_captured})")
    ok = sum(captured) == want_captured
    ok &= check_run(m)
    ok &= m["decode_captures"] == 1 and m["all_done"]
    ok &= same("mesh streams against phase 4e's", want_streams, got)
    single = config_counts["serve_qwen3"]
    for name, n in m["launches"].items():
        good = n == single[name]
        ok &= good
        log(f"  launches {name}: {n} (phase 4e {single[name]}) "
            f"{'ok' if good else 'WRONG'}")
    log(f"  qwen3-8b decode step on the (1, 1) mesh "
        f"{1e3 * m['decode_step_s']:.3f} ms against phase 4e's single-rank "
        f"{1e3 * m4e['decode_step_s']:.3f} ms; tok_s={m['tok_s']:.1f} "
        f"(4e {m4e['tok_s']:.1f}); mean_ttft_s={m['ttft_s']:.4f} (4e "
        f"{m4e['ttft_s']:.4f}); capture_s={m['capture_s']:.3f}; "
        f"peak_mem_GiB={m['peak_mem_gib']:.2f}")
    return ok, m["launches"]


def shard_cases(dtype):
    """qwen3-8b's per-rank decode shapes under tensor parallelism, in
    kernel_cases' form: at ``model`` 2 and 4 the paged decode at 16/4 and
    8/2 heads of 128 (8 slots of 512 rows, 16-row pages, ragged lengths)
    and silu over ``[8, 2 x 6,144]`` and ``[8, 2 x 3,072]`` (the installed
    genomes); rmsnorm keeps its width."""
    from repro_torch import configs
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ops, ref
    cfg = configs.get(SERVE_QWEN3["arch"])
    es = torch.tensor([], dtype=dtype).element_size()
    b, page = SERVE_QWEN3["slots"], SERVE_QWEN3["page_size"]
    n_pt = SERVE_QWEN3["max_seq"] // page
    pg = ops.get_variant("paged_flash_decode")
    cases = []
    for model in (2, 4):
        hq, hkv, dh = (cfg.n_heads // model, cfg.n_kv_heads // model,
                       cfg.head_dim)
        q, k, v, table, lens = paged_inputs(b, hq, hkv, dh, page, n_pt,
                                            dtype, seed=hq + model)
        rows = int(lens.sum())
        n_tab = int(sum(-(-int(n) // page) for n in lens))
        cases.append((
            "paged_flash_decode", f"qwen3-8b model={model} b={b} hq/hkv="
            f"{hq}/{hkv} d={dh} page={page} kv_len={lens.tolist()} "
            f"{pg.describe()}", dtype,
            lambda q=q, k=k, v=v, t=table, n=lens:
                fd.paged_flash_decode_attention(q, k, v, t, kv_len=n,
                                                variant=pg),
            lambda q=q, k=k, v=v, t=table, n=lens:
                fd.paged_plain(pg, q, k, v, t, n, q.shape[-1] ** -0.5),
            2 * b * hq * dh * es + 2 * rows * hkv * dh * es + 4 * n_tab
            + 4 * b, 4 * rows * hq * dh, False, False, None))
        d = cfg.d_ff // model
        x = randn((b, 2 * d), dtype, 4 + model, scale=3.0)
        cases.append((
            "silu_and_mul", f"qwen3-8b model={model} rows={b} d={d} "
            f"{ops.get_variant('silu_and_mul').describe()}", dtype,
            lambda x=x: ops.silu_and_mul(x),
            lambda x=x: ref.silu_and_mul(x),
            3 * b * d * es, 6 * b * d, False, False, None))
    return cases


def phase_shard_kernels() -> bool:
    """7c: ``shard_cases`` in bf16 and fp32, each against its plain
    version and timed beside its bound."""
    ok = True
    for dtype in (torch.bfloat16, torch.float32):
        for case in shard_cases(dtype):
            ok &= run_case(case)[0]
    return ok


def phase_examples() -> bool:
    """7d: ``examples/torch/quickstart.py`` (the agent loop on silu,
    reintegrated, one call of the tuned kernel) and
    ``examples/torch/serve_lm.py`` (three serves of qwen2-0.5b at full
    width) on the card, each in its own process (the kernel library is
    phase 1's build)."""
    import subprocess
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    ok = True
    for name, want in (("quickstart", "installed: silu_and_mul@"),
                       ("serve_lm", None)):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.join(ROOT, "examples", "torch",
                                          f"{name}.py")],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=420)
        out = proc.stdout.splitlines()
        good = proc.returncode == 0
        if name == "serve_lm":
            runs = [json.loads(line) for line in out
                    if line.startswith("{")]
            good &= len(runs) == 3 and all(
                r["all_done"] and r["device"].startswith("cuda")
                and r["steps"] == r["readbacks"] == r["graph_replays"]
                for r in runs)
            for r in runs:
                log(f"  serve_lm: {r['requests']} requests tok_s="
                    f"{r['tok_s']:.1f} steps={r['steps']} graph_replays="
                    f"{r['graph_replays']} preemptions={r['preemptions']} "
                    f"sampling_step={r['sampling_step']}")
        else:
            good &= any(want in line for line in out)
            for line in out[-3:]:
                log(f"  {name}: {line}")
        log(f"  examples/torch/{name}.py exit {proc.returncode} in "
            f"{time.perf_counter() - t0:.1f} s "
            f"{'ok' if good else 'FAILED'}")
        if not good:
            log("\n".join(out[-20:]) + "\n" + proc.stderr[-4000:])
        ok &= good
    return ok


# phase 8: the dry run's cells traced on this host (each in its own
# process: a trace is rank 0 of a fake world), and the one it checks
# against the card, qwen2-0.5b decode_32k at world 1
DRYRUN_CELLS = (("qwen2-0.5b", "train_4k", "single"),
                ("qwen2-0.5b", "prefill_32k", "single"),
                ("qwen2-0.5b", "decode_32k", "single"),
                ("olmoe-1b-7b", "decode_32k", "single"),
                ("xlstm-1.3b", "long_500k", "multi"),
                ("qwen2-0.5b", "decode_32k", "1,1"))
DRYRUN_OUT = os.path.join(ROOT, "build", "dryrun")
DECODE_32K_STEPS = 5           # timed steps, after 2 warm-up steps
# kernel 5 at decode_32k: every output averages ~32,768 / e rows of an
# N(0, 1) cache, so |out| is ~0.009 (RMS) and DECODE_TOL's atol would let
# a dropped 64-row tile (error ~4e-4 RMS) pass; atol is this share of the
# plain output's RMS instead (the kernel's error on the card: one bf16 ulp
# of the largest outputs, 2.44e-4; PERF.md)
DECODE_32K_ATOL_SHARE = 0.05


def start_dryruns(cells) -> list:
    """8a: ``launch/dryrun.py`` for each of ``cells``, all started at
    once, each in its own process with no card visible (the trace
    allocates nothing and runs on the host's CPU)."""
    import subprocess
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = []
    for arch, shape, mesh in cells:
        procs.append(((arch, shape, mesh), subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh, "--out", DRYRUN_OUT],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    return procs


def dryrun_row(arch: str, shape: str, mesh: str) -> dict:
    tag = f"{arch}_{shape}_{mesh.replace(',', 'x')}"
    with open(os.path.join(DRYRUN_OUT, tag + ".json")) as f:
        return json.load(f)


def finish_dryruns(procs: list, card: str, t0: float) -> bool:
    """8a: wait for every trace; print its row beside the card. A cell
    that is not ``ok`` fails the phase."""
    ok = True
    for (arch, shape, mesh), proc in procs:
        out, _ = proc.communicate(timeout=600)
        row = dryrun_row(arch, shape, mesh) if proc.returncode == 0 \
            else {"status": f"exit {proc.returncode}"}
        good = row.get("status") == "ok"
        ok &= good
        if not good:
            log(out[-4000:])
            continue
        mb = (f", {row['microbatches']} microbatches (traced at "
              f"{row['traced_microbatches']})" if "microbatches" in row
              else "")
        mb += (f", {row['depth_units']} depth units (traced at "
               f"{row['traced_depth_units']})")
        log(f"  {arch} x {shape} x {row['mesh']}: trace "
            f"{row['trace_s']:.1f} s{mb}; {row['hbm_gb_per_chip']:.2f} GiB "
            f"a card, {row['flops_per_chip']:.3e} FLOPs, "
            f"{row['bytes_per_chip']:.3e} B; compute "
            f"{row['compute_ms']:.3f} ms, memory {row['memory_ms']:.3f} ms,"
            f" collective {row['collective_ms']:.3f} ms -> "
            f"{row['dominant']}, step {row['step_ms']:.3f} ms, useful "
            f"{row['useful_flops_ratio']:.3f}, mfu "
            f"{row['mfu_at_roofline']:.3f}; collectives (MB) "
            f"{row['coll_breakdown_mb']} [roofline at the H100's rates; "
            f"traced on the host of {card}]")
    log(f"  8a: {len(procs)} traces in {time.perf_counter() - t0:.1f} s "
        f"{'ok' if ok else 'FAILED'}")
    return ok


def profile_step(step) -> str:
    """One call of ``step`` under ``torch.profiler``: its wall time (the
    profiler's host cost included), the device's busy time, kernel 5's
    share and the largest other kernels, as one line."""
    from repro_torch.launch.serve import kernel_times
    act = torch.profiler.ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and not e.is_user_annotation]
    dev_ms = sum(e.self_device_time_total for e in ev) / 1e3
    if dev_ms == 0:
        return (f"profiled step: wall {wall_ms:.3f} ms; device time not "
                f"measured (the profiler saw no device event)")
    k5 = kernel_times(ev).get("flash_decode", {"launches": 0,
                                                "device_us": 0.0})
    others = sorted((e for e in ev if "flash_decode" not in e.key),
                    key=lambda e: -e.self_device_time_total)
    top = "; ".join(f"{e.key[:60]} x{e.count} "
                    f"{e.self_device_time_total / 1e3:.3f} ms"
                    for e in others[:4])
    rest = dev_ms - k5["device_us"] / 1e3
    return (f"profiled step: wall {wall_ms:.3f} ms (the profiler's host "
            f"cost included), device busy {dev_ms:.3f} ms "
            f"({100 * dev_ms / wall_ms:.1f}%): kernel 5 "
            f"{k5['device_us'] / 1e3:.3f} ms in {k5['launches']} launches, "
            f"the rest {rest:.3f} ms in "
            f"{sum(e.count for e in others)} kernels (largest: {top})")


def phase_decode_32k(card: str) -> tuple[bool, dict]:
    """8b: qwen2-0.5b's decode_32k cell at world 1 on the card: full-width
    bf16 weights and a contiguous cache of 128 slots x 32,768 rows (51.5
    GB), every slot at its last row, one decode step through the port's
    kernels timed eagerly with CUDA events, held to the cell's ``(1, 1)``
    dry-run row (traced before; no trace runs meanwhile): the step at
    least 0.95 of its ``step_ms``, the peak memory within 10% of its
    ``hbm_gb_per_chip``. One more step under the profiler splits its
    time. Then kernel 5 at that shape against its plain version and
    beside SDPA. Returns (ok, the step's launches)."""
    from repro_torch import configs
    from repro_torch.configs.base import SHAPES
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    cfg, spec = configs.get("qwen2-0.5b"), SHAPES["decode_32k"]
    b, s = spec.global_batch, spec.seq_len
    free_models()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = registry.init_params(cfg, seed=0)
    cache = registry.init_cache(cfg, b, s, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for t in cache.values():
        for layer in t:
            layer.normal_(generator=gen)
    token = torch.randint(0, cfg.vocab, (b,), dtype=torch.int32,
                          device="cuda", generator=gen)
    pos = torch.full((b,), s - 1, dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    times, logits = [], None
    for i in range(2 + DECODE_32K_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        logits, _ = registry.decode_step(params, cfg, cache, token, pos)
        end.record()
        end.synchronize()
        if i >= 2:
            times.append(start.elapsed_time(end))
    counts = ops.launch_counts()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    step_ms = float(np.median(times))
    steps = 2 + DECODE_32K_STEPS
    want = {"fused_add_rmsnorm": (2 * cfg.n_layers + 1) * steps,
            "silu_and_mul": cfg.n_layers * steps,
            "flash_decode": cfg.n_layers * steps,
            "paged_flash_decode": 0, "merge_attn_states_lse": 0,
            "prefill_attention": 0}
    ok = counts == want
    finite = bool(torch.isfinite(logits).all())
    ok &= finite and tuple(logits.shape) == (b, cfg.padded_vocab)
    row = dryrun_row("qwen2-0.5b", "decode_32k", "1,1")
    ok &= row["status"] == "ok"
    met_time = step_ms >= 0.95 * row["step_ms"]
    met_mem = abs(peak - row["hbm_gb_per_chip"]) \
        <= 0.10 * row["hbm_gb_per_chip"]
    ok &= met_time and met_mem
    cache_gb = sum(t.numel() * t.element_size() for t in cache.values()) / 1e9
    log(f"  qwen2-0.5b decode_32k on the card: {b} slots x {s} rows, cache "
        f"{cache_gb:.2f} GB, weights {param_bytes(params) / 1e9:.3f} GB; step "
        f"{step_ms:.3f} ms (median of {DECODE_32K_STEPS}: "
        f"{[round(t, 3) for t in times]}) against the (1, 1) row's "
        f"{row['step_ms']:.3f} ms ({row['dominant']}): "
        f"{step_ms / row['step_ms']:.3f}x, {'met' if met_time else 'MISSED'}"
        f" (>= 0.95); peak {peak:.3f} GiB against the row's "
        f"{row['hbm_gb_per_chip']:.3f} GiB: "
        f"{100 * (peak / row['hbm_gb_per_chip'] - 1):+.2f}%, "
        f"{'met' if met_mem else 'MISSED'} (within 10%); logits finite "
        f"{finite}; launches {counts} {'ok' if counts == want else 'MISMATCH'}"
        f" (want {want}) [{card}]")
    log("  " + profile_step(
        lambda: registry.decode_step(params, cfg, cache, token, pos))
        + f" [{card}]")
    # kernel 5 at the cell's shape: one layer's cache, every row read
    g = ops.get_variant("flash_decode")
    k, v = cache["k"][0], cache["v"][0]
    q = randn((b, cfg.n_heads, cfg.head_dim), torch.bfloat16, 17)
    n = torch.full((b,), s, dtype=torch.int32, device="cuda")
    es = 2
    case = ("flash_decode",
            f"qwen2-0.5b decode_32k b={b} hq/hkv={cfg.n_heads}/"
            f"{cfg.n_kv_heads} d={cfg.head_dim} s={s} kv_len={s} "
            f"{g.describe()}", torch.bfloat16,
            lambda: fd.flash_decode_attention(q, k, v, kv_len=n, variant=g),
            lambda: fd.plain(g, q, k, v, n, cfg.head_dim ** -0.5),
            2 * b * cfg.n_heads * cfg.head_dim * es
            + 2 * b * s * cfg.n_kv_heads * cfg.head_dim * es + 4 * b,
            4 * b * s * cfg.n_heads * cfg.head_dim, False, False,
            sdpa(q, k, v, n))
    rms = float(case[4]().float().pow(2).mean().sqrt())
    atol = DECODE_32K_ATOL_SHARE * rms
    tols = {torch.bfloat16: dict(rtol=DECODE_TOL[torch.bfloat16]["rtol"],
                                 atol=atol)}
    good, max_abs, ms, plain_ms, lib_ms, bound_ms = run_case(case, tols)
    log(f"  kernel 5 at decode_32k: {ms * 1e3:.2f} us against its bound "
        f"{bound_ms * 1e3:.2f} us ({100 * bound_ms / ms:.1f}%), SDPA "
        f"{lib_ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, max_abs "
        f"{max_abs:.3e} against atol {atol:.3e} ({DECODE_32K_ATOL_SHARE} x "
        f"the plain output's RMS {rms:.3e}) {'ok' if good else 'MISMATCH'}"
        f" [{card}]")
    ok &= good
    del params, cache, k, v
    free_models()
    return ok, counts


def phase_dry_run(card: str, t0: float) -> tuple[bool, dict]:
    """Phase 8: the ``(1, 1)`` cell traced first; 8b on the card with no
    trace running (its timing is the host's alone); then the other cells
    traced at once (8a). Returns (ok, 8b's launches)."""
    first = start_dryruns(DRYRUN_CELLS[-1:])
    first[0][1].wait(timeout=600)
    ok, counts = phase_decode_32k(card)
    rest = start_dryruns(DRYRUN_CELLS[:-1])
    ok &= finish_dryruns(first + rest, card, t0)
    return ok, counts


def ptxas_kernels(text: str) -> list:
    """(kernel with its template arguments, registers, spill-store bytes)
    of each kernel in ptxas' report (``-Xptxas -v``), in its order."""
    import re
    rows, name, spill = [], None, 0
    for line in text.splitlines():
        found = re.search(r"Compiling entry function '(\w+)'", line)
        if found:
            short = re.search(r"\d([a-z][a-z_]*_kernel)(I.*?)?Ev",
                              found.group(1))
            name = "".join(short.groups("")) if short else found.group(1)
            continue
        found = re.search(r"(\d+) bytes spill stores", line)
        if found:
            spill = int(found.group(1))
            continue
        found = re.search(r"Used (\d+) registers", line)
        if found and name:
            rows.append((name, int(found.group(1)), spill))
            name, spill = None, 0
    return rows


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
    ap.add_argument("--time-decode", metavar="SRC",
                    help="time the decode kernels' rows on the package "
                    "under SRC, and stop")
    ap.add_argument("--dry-run-only", action="store_true",
                    help="build the kernels, run phase 8 alone, and stop")
    ap.add_argument("--prefill-only", action="store_true",
                    help="build the kernels, run phase 2c alone, and stop")
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
    if args.time_decode:
        sys.path.insert(0, os.path.abspath(args.time_decode))
        print(json.dumps(time_decode()))
        return 0
    sys.path.insert(0, os.path.join(ROOT, "src"))
    if args.journal_child:
        journal_child(args.journal_child[0], int(args.journal_child[1]))
        return 0
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.registry import get_space, registered_kernels
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
    for name, regs, spill in ptxas_kernels(info["log"]):
        log(f"   {name}: {regs} registers, {spill} bytes spill stores")
    phase_s["build"] = time.perf_counter() - t_start
    if args.dry_run_only:
        t0 = time.perf_counter()
        good, _ = phase_dry_run(card, t0)
        log(f"phase 8 alone {'ok' if good else 'FAILED'} in "
            f"{time.perf_counter() - t0:.1f} s")
        return 0 if good else 1
    if args.prefill_only:
        t0 = time.perf_counter()
        rows = {}
        good = phase_prefill_attention(rows)
        log(json.dumps(rows["prefill_attention"]))
        log(f"phase 2c alone {'ok' if good else 'FAILED'} in "
            f"{time.perf_counter() - t0:.1f} s")
        return 0 if good else 1

    ok: dict = {}
    rows: dict = {}
    t0 = time.perf_counter()
    log("phase 2: kernels against their plain versions on the card")
    ok["kernels"] = phase_kernels(rows)
    ok["kernels"] &= phase_edges()
    phase_s["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    log("phase 2c: the prefill attention at the cells' shapes against the "
        "walk, beside its bound and SDPA")
    ok["prefill attention"] = phase_prefill_attention(rows)
    phase_s["prefill attention"] = time.perf_counter() - t0
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
    log("phase 4d: serve olmoe-1b-7b, the mixture of experts, on the "
        "contiguous cache (reintegrated genomes)")
    ok["serve olmoe"], olmoe_counts, _ = phase_serve_bound(SERVE_OLMOE)
    phase_s["serve olmoe"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    log("phase 4e: serve qwen3-8b and recurrentgemma-2b, then yi-34b and "
        "chameleon-34b, at full width (reintegrated genomes)")
    config_ok, config_counts = phase_serve_configs()
    ok.update(config_ok)
    phase_s["serve configs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    log("phase 4f: serve xlstm-1.3b and seamless-m4t-large-v2 at full "
        "width (reintegrated genomes)")
    family_ok, family_counts = phase_serve_families()
    ok.update(family_ok)
    config_counts.update(family_counts)
    phase_s["serve families"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    log("phase 5: reference on a small input")
    ok["reference"] = phase_reference()
    ok["reference"] &= phase_reference_window()
    ok["reference"] &= phase_reference_moe()
    ok["reference"] &= phase_reference_configs()
    ok["reference"] &= phase_reference_families()
    phase_s["reference"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    log("phase 6: train qwen2-0.5b at full width with a restart, one step "
        "of each other family, the Functions' gradients")
    free_models()
    ok["train"], train_counts = phase_train_qwen2(card)
    cut_ok, cut_counts = phase_train_cuts()
    ok["train families"] = cut_ok
    train_counts = {"train_qwen2": train_counts, **cut_counts}
    ok["train gradients"] = phase_train_grads()
    phase_s["train"] = time.perf_counter() - t0
    log(f"  phase 6 {phase_s['train']:.1f} s")
    t0 = time.perf_counter()
    log("phase 7: the reference engine, the tensor-parallel engine on a "
        "(1, 1) NCCL mesh, the per-rank kernel shapes, two examples")
    free_models()
    ok["reference engine"], ref_counts = phase_reference_serve(streams,
                                                               serve_m)
    free_models()
    ok["mesh"], mesh_counts = phase_mesh_serve(config_counts)
    free_models()
    ok["shard kernels"] = phase_shard_kernels()
    ok["examples"] = phase_examples()
    counts7 = {"reference_qwen2": ref_counts, "mesh_qwen3": mesh_counts}
    phase_s["reference and mesh"] = time.perf_counter() - t0
    log(f"  phase 7 {phase_s['reference and mesh']:.1f} s")
    t0 = time.perf_counter()
    log("phase 8: the dry run (launch/dryrun.py) traced on this host, and "
        "qwen2-0.5b decode_32k at world 1 on the card against its row")
    ok["dry run"], counts7["decode_32k_qwen2"] = phase_dry_run(card, t0)
    phase_s["dry run"] = time.perf_counter() - t0
    log(f"  phase 8 {phase_s['dry run']:.1f} s")
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
                                      in request_counts.items()},
                                   "serve_olmoe": olmoe_counts[name],
                                   **{path: c[name] for path, c
                                      in config_counts.items()},
                                   **{path: c[name] for path, c
                                      in train_counts.items()},
                                   **{path: c[name] for path, c
                                      in counts7.items()}}
        # the main path: every run but the shipped-genome serve
        row["launches"] = sum(n for path, n in row["launches_by_path"]
                              .items() if path != "serve_shipped")
    rows["merge_attn_states_lse"]["note"] = (
        "not on the serve path (the model inlines its merge); the tune "
        "phase (the agent loop) drives it")
    rows["prefill_attention"]["note"] = (
        "replaces no TPU kernel (JAX computes this attention in jnp); the "
        "bf16 prefills of the serve phases drive it; no search space, so "
        "the tune paths launch none")
    idle = [n for n, r in rows.items() if not r["launches"]]
    if idle:
        log(f"FAIL: no launch on the driven paths for {idle}")
    idle_workers = [n for n in rows if n in registered_kernels()
                    and not process_counts[n]]
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
