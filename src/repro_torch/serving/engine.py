"""Device-resident continuous-batching serving engine (the core of the JAX
``serving/engine.py``).

A fixed pool of decode slots; requests join as slots free up. Each decode
step is one pass of the model over every slot (``decode_step_paged`` on
the paged pool or ``decode_step`` on the contiguous cache, then the
token draw and the stop conditions, all on the device) and ONE batched
``(token-or-minus-one, done)`` copy to the host. Step *k*'s copy
goes into one of two pinned host buffers right after its dispatch and is
read only after step *k+1* has been dispatched, so the host never waits
on the step it just queued (``readbacks == steps``). Prefill admission
pads prompts to pow2 buckets (at most the cache's rows: a sliding-window
config prefills a prompt longer than its window at its exact length) and
takes the logits at the true length, then writes the prompt's K/V into
its pages or its slot.

**Sampling.** Each request carries ``SamplingParams`` (the engine's
``sampling=`` default when it has none). The step comes in two variants:
the bare argmax, and the draw of ``sampling.sample_tokens`` over every
slot with per-slot seed, temperature, top-k and top-p buffers (greedy
rows still take the argmax, so a greedy stream is the same under either).
The engine starts with the argmax step (or the draw, when its default
samples) and switches to the draw for good at the first admission of a
sampled request. Token *t* of a request draws noise that is a pure
function of ``(seed, t)``, so its stream is the same across restarts,
cache layouts and preemption.

**Scheduling.** Admission order is a ``Scheduler`` (FCFS, priority or
shortest job first; ``scheduler=`` takes a name or an instance).

**The radix prefix cache** (paged pool, ``CacheConfig.prefix_cache``, on by
default). Admission maps the longest cached page-aligned prefix of a
prompt read-only into the slot's table and prefills only the rest against
the cached rows (``transformer.prefill_suffix``); a prompt that matches
whole first copies its last page to a private one (copy-on-write) and
prefills that page again, so the decode step never writes a shared page.
A prompt's full pages join the tree when it is prefilled, and a finished
request's when it leaves; tree pages are evicted before any request is
preempted. The page copy and the suffix prefill run eagerly, on the
stream the next step replays on.

**The captured step.** The step reads and writes a static carry: token,
position, activity, emit count and budget per slot, the sampling buffers,
the emit pair and, on the paged pool, a device page table ``[slots,
pages_per_slot]``. These
buffers are allocated once and only ever written in place (``copy_``,
index assignment). ``_step_body`` is the whole step. On the CPU it runs
eagerly; on the card it is captured once as a CUDA graph at construction,
with every slot idle, and each step replays it: the counterpart of the
JAX engine's one donated jitted program. The host copies its page table
to the device table only when the table changed (``PagePool.version``:
allocation, release, shared mapping, copy-on-write), through pinned
memory, queued before the replay on the same stream. The graph holds the
step variant and the genomes of the path's kernels installed at capture;
a step that finds another variant or other genomes (``ops.set_variants``)
captures again first (``decode_captures`` counts every capture). A
capture that fails raises: on the card the engine never runs the step
eagerly. The kernels' launch counts are kept exact under replay
(``ops.add_launch_counts``).

Capture leaves no trace. Its warm-up passes run the real kernels (which
allocates what they keep, such as the split-KV counters) with the carry
and the cache's state leaves (``registry.state_leaves``: the Griffin
conv and RG-LRU states, which a step overwrites whole) saved before and
restored after, so they write only the K/V rows the next step writes
before it reads them: an idle paged slot writes to the trap page, an idle
contiguous slot row ``pos % S`` of its own stripe (which the next prefill
overwrites and ``kv_len`` masks until then), and a resident slot the row
of its next write.

**Mixed caches.** A contiguous cache may hold recurrent state beside the
K/V (the Griffin hybrid: ``conv``, ``h``, ``tconv``, ``th``) or instead
of it (the xLSTM's six state leaves). Admission writes every leaf of the
slot along the axes the family names (``registry.write_slot``), so
nothing of a state leaf's last occupant survives, a re-prefilled
(recomputed) request included; recovery puts every leaf back to a fresh
cache's values in place.

**Frame prompts** (``cfg.frontend == "frames"``, the encoder-decoder). A
prompt is a float ``[S, d_model]`` array of frame embeddings: admission
rejects non-finite values, prefill takes the frames as fp32, and the
slot's first decode step is at position 1 (its prefill decoded BOS at
0). Crash recovery on the contiguous cache fails a frames survivor
("lost to device-fault recovery"), since its generated tokens cannot be
folded back into a float prompt to recompute it.

**Preemption** (paged pool below full subscription). Admission waits for
pages; a decode write that finds the pool dry settles the in-flight step
(finished slots free pages) and then evicts the ``PreemptionPolicy``'s
victim, the youngest occupant, until the write fits. ``swap`` copies the
victim's pages and device state to the host and restores them byte for
byte into the static carry on re-admission; ``recompute`` drops them and
re-prefills prompt + generated prefix, and a re-admission whose prefill
gives the request's final token finishes it there.

The host keeps an exact mirror of each slot's device position, emit count
and activity: the stop conditions are deterministic, so the page
allocator can back the next write without waiting for the readback.

**The request lifecycle.** A request ends as ``done``, ``aborted``
(``abort``), ``rejected`` (it can never be served: checked at submission,
and by a watchdog when the engine is idle with a head of line that never
fits), ``failed`` (a quarantined request) or ``deadline`` (its
``deadline_s`` ran out). Abort, deadline and quarantine deactivate the
slot on the device carry, stream-ordered after the last queued step, and
release its pages. A readback token outside ``[0, vocab)`` quarantines
its request alone. ``chaos=`` takes a ``ChaosInjector`` (or a ``Fault``
list, ``serving/chaos.py``) whose faults fire at chosen steps.

**Crash recovery.** An error raised before a step's replay is queued (the
chaos harness's ``InjectedDeviceFault``) leaves the carry and the pool as
they were before the step. The engine settles the in-flight readback,
fails the faulting slot's request, copies every other resident request's
pages, carry and draft rows to the host (swap-out), releases everything,
zeroes the pool, the carry, the emit buffer, the device table and the
draft cache IN PLACE (the captured graph keeps replaying those tensors,
so nothing is reallocated and nothing is captured again) and requeues the
survivors, whose streams then equal an undisturbed run's. An error from
the step itself (a CUDA error from a replay, which is sticky: the context
is lost, or on the CPU an error of the eager body) is not recovered: it
propagates and ends the run.

**Speculative decoding** (``spec=``, a ``SpecConfig``; paged pool only,
inert on the contiguous cache). The step becomes ``_spec_body``: the
drafter's ``k`` proposals per slot (the n-gram drafter's copied from the
host into a static ``[slots, k]`` buffer before the replay; the draft
model's computed inside the captured step), then ``k + 1`` sequential
passes of the target over the paged pool, pass ``j`` feeding draft ``j``
at ``pos + j`` with its K/V write masked by its commit flag (rejected
positions go to the trap page), and commits that run from the start of
the row. It emits ``[k + 1, slots]`` tokens and the done flags, applied
at once each step (one readback a step), and only greedy requests are
admitted. The n-gram drafter is host work; the draft model's passes run
the contiguous ``flash_decode`` kernel on its own cache.

**Spans.** ``tracer`` (``serving/tracing.py``) records the host's work at
the engine's boundaries while it is started: ``engine.step`` with its
``engine.drain`` (cause ``before_dispatch``, ``idle``, ``pages``,
``flush``, ``abort``, ``deadline`` or ``recovery``),
``engine.readback_wait`` and ``engine.apply``; per admission
``cache.admit_prompt`` or ``cache.alloc``, then ``engine.admit`` with
``engine.prefill.launch``, ``engine.first_token`` and
``cache.insert_prompt``, and the request's ``request.queue`` wait;
``cache.ensure_pages`` with ``engine.preempt`` and ``engine.swap_out``;
``engine.dispatch`` with ``engine.table_upload``, ``engine.capture`` and
``engine.replay``. Per-slot work gets no span. Off, each site costs one
attribute test.

**Tensor parallelism** (``mesh=``, a ``(data, model)`` ``DeviceMesh``;
the dense family on the paged pool). SPMD: every rank builds the same
engine and runs the same host loop, keeping its shard of the weights and
its KV heads of the pool (``sharding.tp``). The decode step (argmax,
draw or spec verify), the prefill and the suffix prefill run under the
plan, whose hooks all-gather the sharded partials (on the card inside
the captured graph); a data shard decodes and draws its own slot rows
and the tokens are gathered back, so every rank holds the same carry and
reads back the same emit (one readback a step a rank). The swap copies
and the copy-on-write page copy are rank-local (each rank's pool holds
its own heads) and need no hook; a draft model runs replicated, outside
the plan.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import registry
from repro_torch.serving.cache_manager import make_cache_manager
from repro_torch.serving.chaos import ChaosInjector
from repro_torch.serving.sampling import SamplingParams, sample_tokens
from repro_torch.serving.scheduler import make_preemption, make_scheduler
from repro_torch.serving.spec import make_drafter
from repro_torch.serving.tracing import Tracer
from repro_torch.sharding import tp

I32 = torch.int32
F32 = torch.float32
WARMUP_STEPS = 2        # eager passes of the step body before a capture


@dataclasses.dataclass
class Request:
    """One generation request: prompt, budget, sampling, and its stream."""

    rid: int
    prompt: np.ndarray                  # token ids [S] (or frames [S, D])
    max_new_tokens: int = 16
    sampling: Optional[SamplingParams] = None   # None -> engine default
    priority: int = 0                   # read by PriorityScheduler
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    t_submit: float = 0.0               # set by Engine.submit
    t_first: float = 0.0                # wall time of the first token
    preemptions: int = 0                # times evicted and requeued
    arrival: int = -1                   # submission rank, set by submit
    prefix_hit_tokens: int = 0          # prompt tokens served from the tree
    deadline_s: Optional[float] = None  # wall-clock budget from t_submit;
    #                                     expiry finishes as "deadline"
    # None while live, then done | aborted | rejected | failed | deadline
    finish_reason: Optional[str] = None
    error: Optional[str] = None         # what went wrong, if anything
    accepted_tokens: int = 0            # draft tokens the verify committed
    # swap-preemption payload: (host KV pages, token, pos, emitted,
    # n_pages, the drafter's copy or None), the victim's exact device
    # state, restored verbatim
    swap_state: Optional[tuple] = dataclasses.field(default=None,
                                                    repr=False)


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None
    dpos: int = 0                       # device pos (next write position)
    demitted: int = 0                   # device emitted count
    dactive: bool = False               # device active flag


class Engine:
    """Continuous-batching core: one decode step (a CUDA graph replay on
    the card) and one batched host readback per step."""

    def __init__(self, params, cfg: ModelConfig, *, slots: int = 4,
                 max_seq: int = 512,
                 sampling: Optional[SamplingParams] = None, scheduler=None,
                 preemption=None, cache_manager=None, chaos=None, spec=None,
                 mesh=None, device=None):
        """``params`` in the port's layout (``registry.init_params`` or
        ``convert.params_from_jax``) are moved to ``device`` (default
        ``cuda``). ``sampling`` is the ``SamplingParams`` of requests that
        carry none (greedy when None). ``scheduler`` is a policy name
        (``"fcfs"``, the default, ``"priority"`` or ``"sjf"``) or a
        ``Scheduler``; ``preemption`` a policy name (``"swap"``, the
        default, or ``"recompute"``) or a ``PreemptionPolicy``;
        ``cache_manager`` a ``CacheConfig`` or a ready manager; ``chaos`` a
        ``ChaosInjector`` or a list of ``reliability.Fault``; ``spec`` a
        ``SpecConfig`` (speculative decoding on the paged pool; inert on
        the contiguous cache); ``mesh`` a ``(data, model)`` ``DeviceMesh``
        (``launch/mesh.py``), for tensor-parallel serving of the dense
        family from the paged pool: every rank of the mesh builds the
        same engine, keeps its shard of the weights and of the pool
        (``sharding.tp``), and runs its programs under the plan, whose
        hooks all-gather the sharded partials. On the card the decode
        step is captured here, before any admission."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = registry.module_for(cfg).cast_params(params, cfg,
                                                           self.device)
        self.n_slots, self.max_seq = slots, max_seq
        self.slots = [_Slot() for _ in range(slots)]
        self.default_sampling = sampling if sampling is not None \
            else SamplingParams()
        self.scheduler = make_scheduler(scheduler)
        self.preemption = make_preemption(preemption)
        self.preempt_mode = self.preemption.mode
        self.cm = make_cache_manager(cache_manager, cfg, slots, max_seq,
                                     self.device)
        self._plan = None
        self.cache = self.cm.init()
        if mesh is not None:
            if not self.cm.paged:
                raise ValueError(
                    "mesh serving requires the paged cache manager")
            self._plan = tp.make_plan(cfg, mesh, slots)
            # this rank's weights (gate/up columns permuted per shard when
            # the MLP axis shards) and KV heads
            self.params = tp.shard_params(self.params, cfg, self._plan)
            self.cache = tp.put_cache(self.cache, self._plan)
        self._pad_ok = registry.pad_prefill_ok(cfg)
        self._prefix_cache = self.cm.prefix_cache
        self._cuda = self.device.type == "cuda"
        self.chaos = None
        if chaos is not None:
            self.chaos = chaos if hasattr(chaos, "on_step") \
                else ChaosInjector(chaos)
        # speculative decoding: ``spec_config`` as requested (its counters
        # show even when inert), ``spec`` the one in effect
        self.spec_config = spec
        self.spec = spec if spec is not None and self.cm.paged \
            and cfg.frontend != "frames" else None
        self._drafter = None
        if self.spec is not None:
            self._drafter = make_drafter(spec, cfg, slots, max_seq,
                                         self.device)
        self._spec_slot_steps = 0       # slot-steps that committed
        self._spec_emitted = 0          # tokens they committed
        k = self.spec.k if self.spec is not None else 0
        # the static carry: allocated once, written only in place
        self._token = self._zeros(I32)
        self._pos = self._zeros(I32)
        self._active = self._zeros(torch.bool)
        self._emitted = self._zeros(I32)
        self._max_new = self._zeros(I32)
        # per-slot sampling parameters (seed as its uint32 value)
        self._seed = self._zeros(torch.int64)
        self._temp = self._zeros(F32)
        self._topk = self._zeros(I32)
        self._topp = torch.ones((slots,), dtype=F32, device=self.device)
        # the argmax step until a sampled request is admitted
        self._greedy_only = self.default_sampling.greedy
        # the emit: a token row (k + 1 rows for a spec step), then done
        emit_rows = k + 2 if self.spec is not None else 2
        self._emit = torch.zeros((emit_rows, slots), dtype=I32,
                                 device=self.device)
        # the spec step's drafts: [slots, k], written only in place
        self._drafts = torch.zeros((slots, k), dtype=I32,
                                   device=self.device) \
            if self.spec is not None else None
        self._table = None
        if self.cm.paged:
            # all trap pages, as the host table starts (version 0)
            self._table = torch.zeros(self.cm.page_table().shape, dtype=I32,
                                      device=self.device)
        self._table_version = self.cm.table_version
        self._table_uploads = 0
        # step k's readback lands in _host[k % 2]
        self._host = [torch.zeros((emit_rows, slots), dtype=I32,
                                  pin_memory=self._cuda) for _ in range(2)]
        self._path = ("fused_add_rmsnorm", "silu_and_mul",
                      "paged_flash_decode" if self.cm.paged
                      else "flash_decode")
        if self._drafter is not None and self._drafter.on_device:
            self._path += ("flash_decode",)     # the draft model's passes
        self.finished: list[Request] = []
        self.preemptions = 0
        self.recoveries = 0
        self._lifecycle = {"done": 0, "aborted": 0, "rejected": 0,
                           "failed": 0, "deadline": 0}
        self._has_deadlines = False
        self._arrivals = 0
        self._admissions = 0
        # ((host copy, its event), step number, request snapshot) of the
        # last dispatched step, not yet applied: applied after the NEXT
        # dispatch
        self._pending = None
        self._steps = 0
        self._readbacks = 0
        self._tokens_out = 0
        self._run_s = 0.0
        self._ttft_s = 0.0                  # submit -> first token, s,
        self._ttft_n = 0                    # summed over requests
        self._drains_first = 0              # readbacks settled before a
        #                                     dispatch (``step``)
        self._prefills = 0                  # whole-prompt prefills
        self._prefill_shapes: set[int] = set()
        self._suffix_shapes: set[int] = set()
        self._suffix_prefills = 0
        self._swapped_out_pages = 0
        self._swapped_in_pages = 0
        self._decode_s = 0.0                # wall time of steps that
        self._decode_steps = 0              # admitted nothing, and count
        self._graph = None
        self._graph_key = None
        self._graph_delta: dict = {}
        self._captures = 0
        self._replays = 0
        self._warmups = 0
        self._capture_s = 0.0
        # step variant -> the last capture's seconds and graph pool MiB
        self._capture_by: dict = {}
        # spans of the host's work, off until ``tracer.start()``
        self.tracer = Tracer(self.device)
        if self._cuda:
            self._capture()

    def _zeros(self, dtype):
        return torch.zeros((self.n_slots,), dtype=dtype, device=self.device)

    def _carry(self) -> tuple:
        carry = (self._token, self._pos, self._active, self._emitted,
                 self._max_new, self._emit)
        return carry if self._drafts is None else carry + (self._drafts,)

    def _upload(self, x) -> torch.Tensor:
        """A device copy of a host array or tensor that the host may
        change or drop next. On the card the copy goes through pinned
        memory without blocking the host (the caching host allocator keeps
        the staging buffer until the copy is done), so it does not wait
        for queued steps."""
        t = torch.from_numpy(x) if isinstance(x, np.ndarray) else x
        if self._cuda:
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    # -- the captured step ---------------------------------------------------

    def _step_body(self) -> None:
        """One decode step over every slot, on the static carry (the body
        of the JAX engine's ``_make_step``): the model decode, the argmax
        (the argmax step) or ``sample_tokens`` with each slot's emit count
        as the stream index (the sampling step), the stop conditions, and
        the emit pair ``(token or -1 where the slot was idle, done)``."""
        with tp.active(self._plan):
            logits, _ = self.cm.decode(self.params, self.cache, self._token,
                                       self._pos, self._table)
            logits = logits[:, :self.cfg.vocab]
            if self._greedy_only:
                nxt = torch.argmax(logits, dim=-1).to(I32)
            else:
                # a data shard's logits are its own slots' rows: the
                # draw's per-slot buffers slice down to match
                nxt = sample_tokens(logits, *map(tp.data_shard, (
                    self._seed, self._emitted, self._temp, self._topk,
                    self._topp)))
            # the token back to every slot (identity off the mesh)
            nxt = tp.gather_data(nxt)
        active = self._active
        new_pos = self._pos + 1
        new_emitted = self._emitted + active.to(I32)
        done = active & ((new_emitted >= self._max_new)
                         | (new_pos >= self.max_seq - 1))
        self._emit[0].copy_(torch.where(active, nxt, -1))
        self._emit[1].copy_(done)
        self._token.copy_(nxt)
        self._pos.copy_(new_pos)
        self._emitted.copy_(new_emitted)
        self._active.copy_(active & ~done)

    def _spec_body(self) -> None:
        """One speculative step over every slot, on the static carry (the
        body of the JAX engine's ``_make_step_spec``). Pass ``j`` feeds
        ``x_j`` (the carry token, then draft ``j``) at ``pos + j`` and
        takes ``t_j = argmax``. Draft ``j`` is accepted while every
        earlier one was, it equals ``t_{j-1}``, and ``j`` is under the
        slot's remaining token and sequence budget; each pass's K/V write
        is masked by its own flag, so a rejected position writes the trap
        page. The new carry is the last committed ``t_j``; pos and the
        emit count advance by the slot's commits."""
        if self._drafter.on_device:
            self._drafts.copy_(self._drafter.propose(
                self.slots, self._token, self._pos))
        k, vocab = self.spec.k, self.cfg.vocab
        token, pos, active = self._token, self._pos, self._active
        budget = torch.minimum(self._max_new - self._emitted,
                               (self.max_seq - 1) - pos)
        flag = active                   # the carry token always commits
        x = carry = prev = token
        commits = torch.zeros_like(pos)
        for j in range(k + 1):
            if j > 0:
                d_j = self._drafts[:, j - 1]
                flag = flag & (d_j == prev) & (j < budget)
                x = d_j
            with tp.active(self._plan):
                logits, _ = self.cm.decode(self.params, self.cache, x,
                                           pos + j, self._table,
                                           write_mask=flag)
                t_j = tp.gather_data(
                    torch.argmax(logits[:, :vocab], dim=-1).to(I32))
            carry = torch.where(flag, t_j, carry)
            self._emit[j].copy_(torch.where(flag, t_j, -1))
            commits = commits + flag.to(I32)
            prev = t_j
        new_pos = pos + commits
        new_emitted = self._emitted + commits
        done = active & ((new_emitted >= self._max_new)
                         | (new_pos >= self.max_seq - 1))
        self._emit[k + 1].copy_(done)
        self._token.copy_(carry)
        self._pos.copy_(new_pos)
        self._emitted.copy_(new_emitted)
        self._active.copy_(active & ~done)

    def _run_step(self) -> None:
        """The step body in effect: the spec step, or the plain one."""
        if self.spec is not None:
            self._spec_body()
        else:
            self._step_body()

    def _step_kind(self) -> str:
        if self.spec is not None:
            return "spec"
        return "greedy" if self._greedy_only else "sampling"

    def _variant_key(self) -> tuple:
        return (self._greedy_only, self.spec is not None) + tuple(
            ops.get_variant(name) for name in self._path)

    def _warm_up(self) -> None:
        """``WARMUP_STEPS`` eager passes of the step body that leave the
        carry and the cache's state leaves (a recurrent family's conv and
        RG-LRU states, which a step overwrites whole) as they found them;
        the K/V rows they write are those the next step writes before it
        reads them (module docstring)."""
        bufs = self._carry() + tuple(self.cache[name] for name in
                                     registry.state_leaves(self.cfg))
        saved = [b.clone() for b in bufs]
        for _ in range(WARMUP_STEPS):
            self._run_step()
            for buf, old in zip(bufs, saved):
                buf.copy_(old)
        self._warmups += WARMUP_STEPS

    def _capture(self) -> None:
        """Capture ``_step_body`` as a CUDA graph with the step variant
        and the genomes now installed, after a warm-up on a side stream
        (PyTorch's recipe). The launches the capture recorded are taken
        off the kernels' counts and added back on each replay. Raises when
        the step cannot be captured."""
        t0 = time.perf_counter()
        if self._graph is not None:
            # the last replay ends before its graph's memory is reused
            torch.cuda.synchronize(self.device)
            self._graph = None
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self._warm_up()
        main.wait_stream(side)
        # the capture empties the allocator's cache before it starts (as
        # ``torch.cuda.graph`` does), so that what it reserves after is
        # the graph's private pool: the step's temporaries
        torch.cuda.synchronize(self.device)
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        before = ops.launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                self._run_step()
        except RuntimeError as e:
            raise RuntimeError(
                "the decode step could not be captured as a CUDA graph "
                f"(the engine does not run it eagerly on the card): {e}") \
                from e
        recorded = {name: n - before[name]
                    for name, n in ops.launch_counts().items()}
        ops.add_launch_counts({name: -n for name, n in recorded.items()})
        self._graph, self._graph_delta = graph, recorded
        self._graph_key = self._variant_key()
        self._captures += 1
        torch.cuda.synchronize(self.device)
        seconds = time.perf_counter() - t0
        self._capture_s += seconds
        self._capture_by[self._step_kind()] = {
            "s": seconds, "pool_mib":
            (torch.cuda.memory_reserved(self.device) - reserved) / 2**20}

    def _sync_table(self) -> None:
        """Copy the host page table to the device table if it changed
        since the last copy (queued before the step that reads it)."""
        if self._table is None or self.cm.table_version == \
                self._table_version:
            return
        tr = self.tracer
        sp = tr.open("engine.table_upload") if tr.on else None
        src = torch.from_numpy(self.cm.page_table())
        if self._cuda:
            src = src.pin_memory()
        self._table.copy_(src, non_blocking=True)
        self._table_version = self.cm.table_version
        self._table_uploads += 1
        if sp is not None:
            tr.close(sp)

    def _dispatch(self, drafts: Optional[np.ndarray] = None):
        """Queue one decode step and its readback; returns (host buffer,
        the event that marks the copy complete, or None on the CPU).
        ``drafts``: a host drafter's ``[slots, k]`` proposals, copied into
        the static draft buffer before the step, like the page table."""
        tr = self.tracer
        sp = tr.open("engine.dispatch") if tr.on else None
        self._sync_table()
        if drafts is not None:
            src = torch.from_numpy(drafts)
            if self._cuda:
                src = src.pin_memory()
            self._drafts.copy_(src, non_blocking=True)
        if self._cuda and self._variant_key() != self._graph_key:
            cp = tr.open("engine.capture") if tr.on else None
            self._capture()
            if cp is not None:
                tr.close(cp)
        # on the CPU the body runs eagerly in the replay's place
        rp = tr.open("engine.replay", step=self._steps, timed=True) \
            if tr.on else None
        if not self._cuda:
            self._run_step()
        else:
            self._graph.replay()
            ops.add_launch_counts(self._graph_delta)
            self._replays += 1
        if rp is not None:
            tr.close(rp)
        host = self._host[self._steps % 2]
        host.copy_(self._emit, non_blocking=True)
        event = None
        if self._cuda:
            event = torch.cuda.Event()
            event.record()
        if sp is not None:
            tr.close(sp)
        return host, event

    # -- request lifecycle ---------------------------------------------------

    def submit(self, req: Request) -> None:
        """Queue ``req``; an inadmissible one finishes as ``rejected``."""
        req.t_submit = time.perf_counter()
        req.arrival = self._arrivals
        self._arrivals += 1
        if req.deadline_s is not None:
            self._has_deadlines = True
        msg = self._admission_error(req)
        if msg is not None:
            self._finish(req, "rejected", msg)
            return
        self.scheduler.push(req)

    def _admission_error(self, req: Request) -> Optional[str]:
        """Why ``req`` can never be served (rejected up front instead of
        wedging the head of line or failing inside a prefill), or None."""
        prompt = np.asarray(req.prompt)
        n = len(prompt)
        if n == 0:
            return "empty prompt"
        if self.cfg.frontend == "frames":
            if prompt.shape[1:] != (self.cfg.d_model,):
                return (f"frame prompt must be [S, {self.cfg.d_model}], "
                        f"got shape {prompt.shape}")
            if not np.all(np.isfinite(prompt)):
                return "non-finite values in frame prompt"
        else:
            if prompt.ndim != 1:
                return f"token prompt must be 1-d, got shape {prompt.shape}"
            if not np.issubdtype(prompt.dtype, np.integer):
                return ("token prompt must be integer-typed, got "
                        f"{prompt.dtype}")
            lo, hi = int(prompt.min()), int(prompt.max())
            if lo < 0 or hi >= self.cfg.vocab:
                return (f"token id {lo if lo < 0 else hi} outside "
                        f"[0, {self.cfg.vocab})")
        if n > self.max_seq - 1:
            return (f"prompt length {n} cannot fit max_seq={self.max_seq} "
                    "(no room to emit a token)")
        if self.spec is not None:
            sp = req.sampling if req.sampling is not None \
                else self.default_sampling
            if not sp.greedy:
                return ("speculative decoding verifies drafts against "
                        "the greedy (argmax) target stream; non-greedy "
                        "sampling cannot serve with spec enabled")
        return self.cm.infeasible(n)

    def _finish(self, req: Request, reason: str,
                error: Optional[str] = None) -> None:
        """The end of every request, whatever its outcome."""
        req.done = True
        req.finish_reason = reason
        req.error = error
        self.finished.append(req)
        self._lifecycle[reason] += 1

    def _deactivate(self, i: int) -> None:
        """Take slot ``i`` off the device, stream-ordered after the last
        queued step (its later idle writes go to the trap page), and
        release its pages."""
        self._active[i] = False
        self.cm.evict(i)

    def _cancel_resident(self, i: int, reason: str,
                         error: Optional[str] = None) -> None:
        """Finish slot ``i``'s occupant and release its residency (tree
        pages live on through their references). The in-flight readback
        must be settled first, so that it cannot revive the request."""
        assert self._pending is None
        slot = self.slots[i]
        req = slot.req
        slot.req = None
        slot.dactive = False
        slot.dpos = slot.demitted = 0
        self._deactivate(i)
        self._finish(req, reason, error)

    def abort(self, rid: int, *, reason: str = "aborted",
              error: Optional[str] = None) -> bool:
        """Cancel the live request ``rid`` wherever it is: waiting (a
        swapped-out victim included) or resident. True when one was found;
        it has finished when the call returns. A resident one is settled
        through a drain first, so an abort that races its natural finish
        resolves to whichever came first."""
        live = [r for r in self.scheduler.waiting() if r.rid == rid] + \
            [s.req for s in self.slots if s.req is not None
             and s.req.rid == rid]
        return bool(live) and self.cancel_request(live[0], reason, error)

    def cancel_request(self, req: Request, reason: str = "aborted",
                       error: Optional[str] = None) -> bool:
        """``abort`` by identity instead of rid (the facade's handle)."""
        if req.done:
            return False
        if self.scheduler.remove(req):
            req.swap_state = None       # a swapped victim: pages freed
            self._finish(req, reason, error)
            return True
        for i, slot in enumerate(self.slots):
            if slot.req is req:
                self._drain("abort")
                if self.slots[i].req is req:
                    self._cancel_resident(i, reason, error)
                return True
        return False

    def _expire_deadlines(self) -> None:
        """Finish every request whose ``deadline_s`` ran out: waiting ones
        leave the queue, resident ones are cancelled as ``abort`` does."""
        now = time.perf_counter()

        def expired(req):
            return (req.deadline_s is not None
                    and now - req.t_submit >= req.deadline_s)

        for req in self.scheduler.waiting():
            if expired(req):
                self.scheduler.remove(req)
                req.swap_state = None
                self._finish(req, "deadline")
        if any(s.req is not None and expired(s.req) for s in self.slots):
            self._drain("deadline")
            for i, slot in enumerate(self.slots):
                if slot.req is not None and expired(slot.req):
                    self._cancel_resident(i, "deadline")

    def _bucket_len(self, n: int) -> Optional[int]:
        """Pow2 padded prompt length, at most the cache's rows per slot
        (``max_seq``, or the window); None for an exact-length prefill,
        as for a prompt longer than that."""
        if not self._pad_ok:
            return None
        cap = min(self.max_seq, self.cfg.window or self.max_seq)
        if n > cap:
            return None
        b = 1
        while b < n:
            b *= 2
        return min(b, cap)

    def _suffix_bucket(self, s_len: int) -> int:
        """Suffix-prefill bucket: pow2 like ``_bucket_len``, at least one
        page, so the short suffixes of radix hits share one shape."""
        b = self._bucket_len(s_len)
        return max(self.cm.page_size, b if b is not None else s_len)

    def _sampling_of(self, req: Request) -> SamplingParams:
        """The request's sampling parameters. The first sampled one
        switches the engine to the sampling step for good (captured at the
        next dispatch on the card)."""
        sp = req.sampling if req.sampling is not None \
            else self.default_sampling
        if self._greedy_only and not sp.greedy:
            self._greedy_only = False
        return sp

    def _admit(self) -> None:
        tr = self.tracer
        for i, slot in enumerate(self.slots):
            if slot.req is not None or not len(self.scheduler):
                continue
            req = self.scheduler.peek()
            if req.swap_state is not None:
                if not self._readmit_swapped(i, slot, req):
                    return         # head-of-line: admission waits for pages
                continue
            prompt = np.asarray(req.prompt)
            was_requeued = bool(req.out_tokens)
            if was_requeued:
                # recompute re-admission: the generated prefix joins the
                # prompt, so prefill rebuilds the cache the victim lost
                prompt = np.concatenate(
                    [prompt, np.asarray(req.out_tokens, prompt.dtype)])
            n = len(prompt)
            cs = tr.open("cache.admit_prompt" if self._prefix_cache
                         else "cache.alloc", rid=req.rid) if tr.on else None
            plan = None
            if self._prefix_cache:
                # maps the longest cached prefix read-only and reserves
                # private pages for the rest
                plan = self.cm.admit_prompt(i, prompt)
                held = plan is not None
            else:
                held = self.cm.alloc(i, n)
            if cs is not None:
                tr.close(cs)
            if not held:
                return             # head-of-line: admission waits for pages
            self.scheduler.pop()
            self._admissions += 1
            ad = self._trace_admit(req) if tr.on else None
            sp = self._sampling_of(req)
            if plan is not None and plan["suffix_start"] > 0:
                tok0 = self._prefill_suffix(i, req, prompt, plan, sp)
                req.prefix_hit_tokens += plan["suffix_start"]
            else:
                tok0 = self._prefill(i, req, prompt, sp)
            if self._drafter is not None:
                # the drafter takes the whole prompt (the generated prefix
                # of a recomputed request, the tree's prefix of a hit)
                self._drafter.prefill(i, prompt)
            if self._prefix_cache:
                # the prompt's full pages are written: publish them
                ins = tr.open("cache.insert_prompt", rid=req.rid) \
                    if ad is not None else None
                self.cm.insert_prompt(i, prompt, n)
                if ins is not None:
                    tr.close(ins)
            req.out_tokens.append(tok0)     # host sync: admission only
            self._tokens_out += 1
            if not req.t_first:
                req.t_first = time.perf_counter()
                self._ttft_s += req.t_first - req.t_submit
                self._ttft_n += 1
            if was_requeued and (len(req.out_tokens) >= req.max_new_tokens
                                 or n >= self.max_seq - 1):
                # the re-admission's prefill gave the request's final
                # token: in the run without preemption it came from the
                # step that fired the stop condition, so it must not
                # decode again
                self._finish(req, "done")
                self._deactivate(i)
            else:
                slot.req = req
                slot.dpos = self._start_pos(n)
                slot.demitted = len(req.out_tokens)
                slot.dactive = True
            if ad is not None:
                tr.close(ad)

    def _trace_admit(self, req: Request):
        """Open ``req``'s ``engine.admit`` span and record the wait in the
        queue that it ends."""
        tr = self.tracer
        ad = tr.open("engine.admit", rid=req.rid)
        t = tr.waited_since(req.rid, req.t_submit, req.preemptions > 0)
        if t is not None:
            tr.add("request.queue", t, ad.t0, rid=req.rid,
                   requeue=req.preemptions > 0)
        return ad

    def _start_pos(self, n: int) -> int:
        """The position of a slot's first decode step after an ``n``-row
        prefill: n, or 1 for the encoder-decoder (its prefill decoded BOS
        at 0; the frames are the encoder's, not the decoder's)."""
        return 1 if self.cfg.family == "encdec" else n

    def _first_token(self, logits, req: Request, sp: SamplingParams) -> int:
        """The token a prefill emits: the argmax, or the draw with index
        ``len(req.out_tokens)`` (its place in the stream). Its host read
        waits for the prefill."""
        tr = self.tracer
        ft = tr.open("engine.first_token", rid=req.rid) if tr.on else None
        logits = logits[:, :self.cfg.vocab]
        if sp.greedy:
            tok = torch.argmax(logits[0])
        else:
            dev = logits.device
            tok = sample_tokens(
                logits,
                torch.tensor([sp.resolve_seed(req.rid) & 0xFFFFFFFF],
                             device=dev),
                torch.tensor([len(req.out_tokens)], dtype=I32, device=dev),
                torch.tensor([sp.temperature], dtype=F32, device=dev),
                torch.tensor([sp.top_k], dtype=I32, device=dev),
                torch.tensor([sp.top_p], dtype=F32, device=dev))[0]
        tok = int(tok)
        if ft is not None:
            tr.close(ft)
            tr.settle()
        return tok

    def _set_slot(self, i: int, tok: int, pos: int, emitted: int,
                  req: Request, sp: SamplingParams) -> None:
        """Write slot ``i``'s carry in place: an active request at ``pos``
        with ``emitted`` tokens out and its sampling parameters."""
        self._token[i] = tok
        self._pos[i] = pos
        self._active[i] = True
        self._emitted[i] = emitted
        self._max_new[i] = req.max_new_tokens
        self._seed[i] = sp.resolve_seed(req.rid) & 0xFFFFFFFF
        self._temp[i] = sp.temperature
        self._topk[i] = sp.top_k
        self._topp[i] = sp.top_p

    def _prefill(self, i: int, req: Request, prompt: np.ndarray,
                 sp: SamplingParams) -> int:
        """Prefill one prompt (padded to its bucket), write its pages
        (paged) or slot ``i`` (contiguous) and reset slot ``i``'s carry in
        place (the body of the JAX engine's ``_make_admit``). Returns the
        first token."""
        tr = self.tracer
        pl = tr.open("engine.prefill.launch", rid=req.rid, timed=True) \
            if tr.on else None
        n = len(prompt)
        b = self._bucket_len(n)
        pages = self.cm.prefill_pages(i, n, b)
        if pages is not None:
            pages = self._upload(pages)
        if b is not None and b > n:
            prompt = np.concatenate([prompt, np.zeros(b - n, prompt.dtype)])
        self._prefill_shapes.add(len(prompt))
        self._prefills += 1
        frames = self.cfg.frontend == "frames"
        tokens = torch.tensor(prompt[None], device=self.device,
                              dtype=torch.float32 if frames else torch.long)
        with tp.active(self._plan):
            logits, kv = registry.prefill(self.params, self.cfg, tokens,
                                          length=n if self._pad_ok else None)
        self.cache = self.cm.write(self.cache, kv, slot=i, pages=pages)
        if pl is not None:
            tr.close(pl)
        tok0 = self._first_token(logits, req, sp)
        self._set_slot(i, tok0, self._start_pos(n), len(req.out_tokens) + 1,
                       req, sp)
        return tok0

    def _prefill_suffix(self, i: int, req: Request, prompt: np.ndarray,
                        plan: dict, sp: SamplingParams) -> int:
        """A radix hit (the JAX engine's ``_dispatch_suffix`` and
        ``_make_admit_suffix``): the copy-on-write page copy if the plan
        has one, then the prefill of the suffix alone against the cached
        prefix rows, written into the slot's private pages."""
        tr = self.tracer
        pl = tr.open("engine.prefill.launch", rid=req.rid, timed=True) \
            if tr.on else None
        n, ss = len(prompt), plan["suffix_start"]
        s_len = n - ss
        sb = self._suffix_bucket(s_len)
        suffix = np.concatenate([prompt[ss:],
                                 np.zeros(sb - s_len, prompt.dtype)])
        if plan["cow"] is not None:
            # the copy keeps the rows the suffix prefill does not rewrite
            src, dst = plan["cow"]
            registry.copy_pages(self.cfg, self.cache, src, dst)
        self._suffix_shapes.add(sb)
        self._suffix_prefills += 1
        prefix = self.cm.read(self.cache,
                              self._upload(self.cm.prefix_page_vec(i, ss)))
        tokens = torch.tensor(suffix[None], dtype=torch.long,
                              device=self.device)
        with tp.active(self._plan):
            logits, kv = registry.prefill_suffix(self.params, self.cfg,
                                                 tokens, prefix,
                                                 prefix_len=ss, length=s_len)
        self.cache = self.cm.write(
            self.cache, kv,
            pages=self._upload(self.cm.suffix_pages(i, ss, n, sb)))
        if pl is not None:
            tr.close(pl)
        tok0 = self._first_token(logits, req, sp)
        self._set_slot(i, tok0, n, len(req.out_tokens) + 1, req, sp)
        return tok0

    def _readmit_swapped(self, i: int, slot: _Slot, req: Request) -> bool:
        """Swap-in re-admission: write the victim's saved pages into the
        pages it holds now and its device state into the carry, in place
        (no prefill, no token). False when the pool cannot hold the pages
        yet (head-of-line waits)."""
        saved, tok, dpos, demitted, n_pages, draft_saved = req.swap_state
        tr = self.tracer
        cs = tr.open("cache.alloc", rid=req.rid) if tr.on else None
        held = self.cm.restore(i, n_pages)
        if cs is not None:
            tr.close(cs)
        if not held:
            return False
        self.scheduler.pop()
        self._admissions += 1
        ad = self._trace_admit(req) if tr.on else None
        sp = self._sampling_of(req)
        pages = self._upload(self.cm.pages_of(i))
        self.cache = self.cm.write(
            self.cache, {name: self._upload(t) for name, t in saved.items()},
            pages=pages)
        self._set_slot(i, tok, dpos, demitted, req, sp)
        if draft_saved is not None:
            # the draft rows come back with the target's pages, so the
            # restored stream's proposals replay an undisturbed run's
            self._drafter.restore_slot(i, draft_saved)
        self._swapped_in_pages += n_pages
        req.swap_state = None
        slot.req = req
        slot.dpos = dpos
        slot.demitted = demitted
        slot.dactive = True
        if ad is not None:
            tr.close(ad)
        return True

    def _preempt(self, victim: int) -> None:
        """Evict the occupant of ``victim`` and requeue it with precedence:
        ``swap`` first copies its pages (shared ones too) and device state
        to the host, ``recompute`` drops them. The in-flight step must be
        settled."""
        assert self._pending is None
        slot = self.slots[victim]
        req = slot.req
        tr = self.tracer
        sp = tr.open("engine.preempt", rid=req.rid) if tr.on else None
        if self.preemption.mode == "swap":
            self._swap_out(victim)
        slot.req = None
        slot.dactive = False
        self._deactivate(victim)
        req.preemptions += 1
        self.preemptions += 1
        self.scheduler.requeue(req)
        if sp is not None:
            tr.requeued(req.rid)
            tr.close(sp)

    def _swap_out(self, i: int) -> None:
        """Copy slot ``i``'s pages (shared ones too), its device state and
        its draft rows to the host, into its request's ``swap_state``."""
        slot = self.slots[i]
        owned = self.cm.pages_of(i)
        tr = self.tracer
        sp = tr.open("engine.swap_out", rid=slot.req.rid) if tr.on else None
        saved = self.cm.read(self.cache, self._upload(owned))
        draft_saved = self._drafter.snapshot_slot(i) \
            if self._drafter is not None else None
        slot.req.swap_state = (
            {name: t.cpu() for name, t in saved.items()},
            int(self._token[i]), slot.dpos, slot.demitted, len(owned),
            draft_saved)
        self._swapped_out_pages += len(owned)
        if sp is not None:
            tr.close(sp)

    def _lookahead(self, slot: _Slot) -> int:
        """Positions slot's next step may write: 1, or under speculative
        decoding its most commits, ``k + 1`` capped by the slot's token
        and sequence budget (the device's ``j < budget`` gate)."""
        if self.spec is None:
            return 1
        budget = min(slot.req.max_new_tokens - slot.demitted,
                     (self.max_seq - 1) - slot.dpos)
        return max(1, min(self.spec.k + 1, budget))

    def _ensure_pages(self) -> None:
        """Back every position each device-active slot's next step may
        write. When the pool is dry (tree pages evicted first, by
        ``grow``): settle the in-flight step (finished slots free pages),
        then evict the preemption policy's victim until the writes fit."""
        tr = self.tracer
        sp = tr.open("cache.ensure_pages") if tr.on else None
        for i in range(self.n_slots):
            slot = self.slots[i]
            if slot.req is None or not slot.dactive:
                continue
            while not self.cm.backed(i, slot.dpos + self._lookahead(slot)
                                     - 1):
                if self.cm.grow(i):
                    continue
                self._drain("pages")
                if self.slots[i].req is None or not self.slots[i].dactive:
                    break              # the drain settled this very slot
                if self.cm.has_free:
                    continue           # the drain freed finished slots
                occ = [(j, self.slots[j].req) for j in range(self.n_slots)
                       if self.slots[j].req is not None]
                victim = self.preemption.select_victim(occ)
                self._preempt(victim)
                if victim == i:
                    break              # preempted ourselves; requeued
        if sp is not None:
            tr.close(sp)

    # -- failure isolation and crash recovery --------------------------------

    def _reject_unadmittable_head(self) -> bool:
        """The watchdog: the engine is idle (no resident slot, nothing in
        flight) yet the head of line was not admitted. If it can never fit
        (more pages than the pool, or no room under ``max_seq``), reject
        it instead of deadlocking every request behind it. A passing cause
        (a chaos page hold) leaves it queued and returns False."""
        req = self.scheduler.peek()
        if req is None or req.swap_state is not None:
            return False               # a swapped victim always fits again
        n = len(req.prompt) + len(req.out_tokens)
        if n > self.max_seq - 1:
            msg = (f"sequence length {n} cannot fit max_seq="
                   f"{self.max_seq} (no room to emit a token)")
        else:
            msg = self.cm.infeasible(n)
        if msg is None:
            return False
        self.scheduler.remove(req)      # not an admission: no pop counted
        self._finish(req, "rejected", msg)
        return True

    def _reset_device_state(self) -> None:
        """Put the pool back to a fresh cache's values (zeros; the xLSTM
        stabilisers at their start) and zero the carry, the emit buffer,
        the drafts and the device table, in place: the captured step
        keeps reading and writing these very tensors, so none is
        reallocated (the state a fresh engine starts from: all slots
        idle, every table entry on the trap page)."""
        registry.reset_cache(self.cfg, self.cache)
        for t in (self._token, self._pos, self._active, self._emitted,
                  self._max_new, self._seed, self._temp, self._topk,
                  self._emit):
            t.zero_()
        self._topp.fill_(1.0)
        if self._drafts is not None:
            self._drafts.zero_()
        if self._table is not None:
            # every slot was released, so the host table is all trap too
            self._table.zero_()
            self._table_version = self.cm.table_version

    def _recover_step_fault(self, exc: BaseException) -> None:
        """Roll back after an error raised before a step's replay was
        queued: the carry and the pool still hold the state from before
        the step. Settle the in-flight readback, fail the faulting slot's
        request (``exc.slot`` when the error names one, else the
        preemption policy's victim), swap every other resident request
        out (pages, carry and draft rows, byte for byte; on the
        contiguous cache it is recomputed instead), release everything,
        reset the device state in place, and requeue the survivors in
        slot order: their streams finish as an undisturbed run's."""
        self._drain("recovery")
        bad = getattr(exc, "slot", None)
        if bad is not None and not (0 <= bad < self.n_slots
                                    and self.slots[bad].req is not None):
            bad = None
        occ = [(i, s.req) for i, s in enumerate(self.slots)
               if s.req is not None]
        if bad is None and occ:
            bad = self.preemption.select_victim(occ)
        survivors: list[Request] = []
        for i, slot in enumerate(self.slots):
            req = slot.req
            if req is None or i == bad:
                continue
            req.swap_state = None
            if self.cm.paged:
                self._swap_out(i)
            elif np.asarray(req.prompt).ndim != 1:
                # frames on the contiguous cache: generated tokens cannot
                # be folded back into a float prompt to recompute it
                self._finish(req, "failed",
                             f"lost to device-fault recovery: {exc}")
                slot.req = None
                continue
            req.preemptions += 1
            survivors.append(req)
        for i, slot in enumerate(self.slots):
            req, slot.req = slot.req, None
            slot.dactive = False
            slot.dpos = slot.demitted = 0
            self.cm.evict(i)
            if req is not None and i == bad:
                self._finish(req, "failed", f"device step fault: {exc}")
        # reversed: slot 0's occupant ends at the head of the queue
        for req in reversed(survivors):
            self.scheduler.requeue(req)
            if self.tracer.on:
                self.tracer.requeued(req.rid)
        if self.cm.paged:
            self.cm.clear_tree()        # the tree's KV went with the pool
            self.cm.pool.check()
        self._reset_device_state()
        if self._drafter is not None:
            self._drafter.reset()
        self.recoveries += 1

    # -- one engine step -----------------------------------------------------

    def has_work(self) -> bool:
        """True while anything is queued, in flight, or resident."""
        return bool(len(self.scheduler) or self._pending is not None
                    or any(s.req is not None for s in self.slots))

    def step(self) -> bool:
        """Admit what fits, dispatch one decode step, and apply the
        previous step's readback (a spec step's own, at once). False when
        nothing could run."""
        t0 = time.perf_counter()
        admissions = self._admissions
        step_no = self._steps
        tr = self.tracer
        sp = tr.open("engine.step", step=step_no) if tr.on else None
        try:
            if self.chaos is not None:
                self.chaos.on_step(self, step_no)
            if self._has_deadlines:
                self._expire_deadlines()
            if self._pending is not None and \
                    (len(self.scheduler)
                     and all(s.req is not None for s in self.slots)
                     or all(s.req is None or not s.dactive
                            for s in self.slots)):
                # apply the pending emit first when it can change what to do
                # next: its done flags may free slots for waiting requests,
                # or every occupied slot finishes inside it (dispatching first
                # would burn an all-idle step)
                self._drains_first += 1
                self._drain("before_dispatch")
            self._admit()
            self._ensure_pages()
            if not any(s.req is not None for s in self.slots):
                self._drain("idle")
                self._admit()
                self._ensure_pages()
                if not any(s.req is not None for s in self.slots):
                    if len(self.scheduler):
                        # idle with a wedged head of line: reject it if it can
                        # never fit, or end a chaos page hold that alone
                        # blocks it, and try again next step
                        if self._reject_unadmittable_head():
                            return True
                        if self.chaos is not None and self.chaos.relent(self):
                            return True
                    return False
            drafts = None
            try:
                # host work before the replay is queued: an error here leaves
                # the carry, the pool and the draft cache as they were
                if self.chaos is not None:
                    self.chaos.pre_dispatch(self, step_no)
                if self.spec is not None and not self._drafter.on_device:
                    drafts = self._drafter.propose(self.slots, self._token,
                                                   self._pos)
            except RuntimeError as e:
                self._recover_step_fault(e)
                return True
            emit = self._dispatch(drafts)
            self._steps += 1
            if self.spec is not None:
                # commits vary, so the host shadows advance from the readback:
                # a spec step is applied at once (still one readback a step)
                self._apply_spec((emit, step_no, [s.req for s in self.slots]))
                self._note_step()
                if self._admissions == admissions:
                    self._decode_s += time.perf_counter() - t0
                    self._decode_steps += 1
                return True
            # mirror the device's stop conditions on the host shadows (this
            # step's readback is still in flight)
            for s in self.slots:
                if s.req is not None and s.dactive:
                    s.demitted += 1
                    s.dpos += 1
                    if (s.demitted >= s.req.max_new_tokens
                            or s.dpos >= self.max_seq - 1):
                        s.dactive = False
            self._note_step()
            prev, self._pending = self._pending, (emit, step_no,
                                                  [s.req for s in self.slots])
            if prev is not None:
                self._apply(prev)           # readback of step k-1 after k
            if self._admissions == admissions:
                self._decode_s += time.perf_counter() - t0
                self._decode_steps += 1
            return True
        finally:
            if sp is not None:
                tr.close(sp)

    def _note_step(self) -> None:
        self.cm.note_step({i: min(s.dpos, self.max_seq)
                           for i, s in enumerate(self.slots)
                           if s.req is not None})

    def _drain(self, cause: str = "flush") -> None:
        """Settle the in-flight readback, if any; ``cause`` names why (the
        ``engine.drain`` span's)."""
        if self._pending is not None:
            tr = self.tracer
            sp = tr.open("engine.drain", cause=cause) if tr.on else None
            prev, self._pending = self._pending, None
            self._apply(prev)
            if sp is not None:
                tr.close(sp)

    def _readback(self, emit, step_no: int):
        """THE host readback of a step: wait for its one batched copy and
        count it (``readbacks == steps`` is checked exactly). Returns the
        pinned host buffer as numpy, after the chaos harness's corrupt
        readbacks (written into that host copy, never the device)."""
        host, event = emit
        tr = self.tracer
        sp = tr.open("engine.readback_wait", step=step_no) if tr.on else None
        if event is not None:
            event.synchronize()
        if sp is not None:
            tr.close(sp)
            tr.settle()
        self._readbacks += 1
        arr = host.numpy()
        if self.chaos is not None:
            tok = arr[0] if self.spec is None else arr[:-1].T
            self.chaos.filter_emit(step_no, (tok, arr[-1]))
        return arr

    def _quarantine(self, i: int, req: Request, bad: int) -> None:
        """Fail ``req`` over a corrupt readback token; only its own slot
        is taken off the device, the others carry on undisturbed."""
        if self.slots[i].req is req:
            self.slots[i].req = None
            self.slots[i].dactive = False
            self._deactivate(i)
        self._finish(req, "failed", f"corrupt readback: token {bad} "
                     f"outside [0, {self.cfg.vocab})")

    def _finish_done(self, i: int, req: Request) -> None:
        """``req`` emitted its last token: finish it, and if it still
        holds slot ``i`` publish its full pages to the tree (the last
        token's row was never written) and free the slot (later steps
        send its idle writes to the trap page)."""
        self._finish(req, "done")
        if self.slots[i].req is req:
            if self._prefix_cache:
                prompt = np.asarray(req.prompt)
                toks = np.concatenate(
                    [prompt, np.asarray(req.out_tokens, prompt.dtype)])
                self.cm.insert_prompt(i, toks, len(toks) - 1)
            self.slots[i].req = None
            self.cm.evict(i)

    def _apply(self, pending) -> None:
        emit, step_no, reqs = pending
        tok, fin = self._readback(emit, step_no)
        tr = self.tracer
        ap = tr.open("engine.apply") if tr.on else None
        for i, req in enumerate(reqs):
            # ``req.done``: a request quarantined while the next step was
            # already queued must not take that step's late token
            if req is None or req.done or tok[i] == -1:
                continue
            t = int(tok[i])
            if not 0 <= t < self.cfg.vocab:
                self._quarantine(i, req, t)
                continue
            req.out_tokens.append(t)
            self._tokens_out += 1
            if fin[i]:
                self._finish_done(i, req)
        if ap is not None:
            tr.close(ap)

    def _apply_spec(self, pending) -> None:
        """Settle a spec step: its ``[k + 1, slots]`` commits (-1 past
        each row's accepted prefix) and done flags, from one readback;
        each slot's host shadows advance by its commits."""
        emit, step_no, reqs = pending
        arr = self._readback(emit, step_no)
        tr = self.tracer
        ap = tr.open("engine.apply") if tr.on else None
        tok, fin = arr[:-1].T, arr[-1]
        for i, req in enumerate(reqs):
            if req is None or req.done:
                continue
            row = tok[i]
            committed = row[row != -1]
            if committed.size == 0:
                continue               # the slot was idle this step
            bad = (committed < 0) | (committed >= self.cfg.vocab)
            if bad.any():
                self._quarantine(i, req, int(committed[bad][0]))
                continue
            e = int(committed.size)
            self._spec_slot_steps += 1
            self._spec_emitted += e
            req.accepted_tokens += e - 1    # the carry's token, then drafts
            req.out_tokens.extend(int(t) for t in committed)
            self._tokens_out += e
            slot = self.slots[i]
            if slot.req is req and slot.dactive:
                slot.demitted += e
                slot.dpos += e
                if (slot.demitted >= req.max_new_tokens
                        or slot.dpos >= self.max_seq - 1):
                    slot.dactive = False
            if fin[i]:
                self._finish_done(i, req)
        if ap is not None:
            tr.close(ap)

    def flush(self) -> None:
        """Settle the in-flight readback (the streaming facade calls
        this when it stops stepping)."""
        self._drain()

    def check_pool(self) -> None:
        """``PagePool.check()`` with every position each device-active
        slot's next step may write: no decode write may land in a shared
        page."""
        if self.cm.paged:
            self.cm.pool.check({
                i: range(s.dpos, s.dpos + self._lookahead(s))
                for i, s in enumerate(self.slots)
                if s.req is not None and s.dactive})

    def run(self, max_steps: int = 10_000) -> list:
        """Step until no work is left (or ``max_steps``); returns the
        finished requests."""
        t0 = time.perf_counter()
        while max_steps > 0 and self.has_work():
            if not self.step():
                break
            max_steps -= 1
        self._drain()
        self._run_s += time.perf_counter() - t0
        return self.finished

    # -- introspection -------------------------------------------------------

    def stats(self) -> dict:
        """Decode steps, readbacks, prefill buckets, throughput, time to
        first token, the captured step's counters, preemption, scheduler,
        pool and prefix-cache counters."""
        out = {
            "steps": self._steps,
            "readbacks": self._readbacks,
            "prefill_compiles": len(self._prefill_shapes)
            + len(self._suffix_shapes),
            "prefill_shapes": sorted(self._prefill_shapes),
            "suffix_shapes": sorted(self._suffix_shapes),
            "suffix_prefills": self._suffix_prefills,
            "sampling_step": not self._greedy_only,
            "pad_prefill": self._pad_ok,
            "slots": self.n_slots,
            "tokens": self._tokens_out,
            "tok_s": self._tokens_out / self._run_s if self._run_s else 0.0,
            "ttft": self._ttft_s / self._ttft_n if self._ttft_n else None,
            # host wall time of a step that admitted nothing: its
            # dispatch and the previous step's readback
            "decode_step_s": (self._decode_s / self._decode_steps
                              if self._decode_steps else None),
            # readbacks settled before the step's dispatch: a full engine
            # with requests waiting, or every slot finishing
            "drains_before_dispatch": self._drains_first,
            "prefills": self._prefills,
            # request-lifecycle outcomes
            "aborted": self._lifecycle["aborted"],
            "rejected": self._lifecycle["rejected"],
            "failed": self._lifecycle["failed"],
            "deadline_expired": self._lifecycle["deadline"],
            "recoveries": self.recoveries,
            "decode_captures": self._captures,
            "graph_replays": self._replays,
            "capture_warmups": self._warmups,
            "capture_s": self._capture_s,
            "capture_by_step": dict(self._capture_by),
            "table_uploads": self._table_uploads,
            "preemptions": self.preemptions,
            "swapped_out_pages": self._swapped_out_pages,
            "swapped_in_pages": self._swapped_in_pages,
        }
        out.update(self.scheduler.stats())
        if self.spec_config is not None:
            # shown whenever spec was asked for: zeros where it is inert
            ss, emitted = self._spec_slot_steps, self._spec_emitted
            draft_tokens = ss * self.spec_config.k
            accepted = emitted - ss
            out.update({
                "spec_on": self.spec is not None,
                "spec_drafter": self.spec_config.drafter,
                "spec_k": self.spec_config.k,
                "draft_tokens": draft_tokens,
                "accepted_tokens": accepted,
                "accepted_per_step": emitted / ss if ss else 0.0,
                "accept_rate":
                    accepted / draft_tokens if draft_tokens else 0.0})
        if self.chaos is not None:
            out.update(self.chaos.stats())
        if self.cm.paged:
            out["preempt_mode"] = self.preempt_mode
        if self._plan is not None:
            out["mesh"] = self._plan.describe()
        out.update(self.cm.stats())
        return out
