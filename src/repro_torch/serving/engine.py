"""Device-resident continuous-batching serving engine (the core of the JAX
``serving/engine.py``).

A fixed pool of decode slots; requests join as slots free up. Each decode
step is one pass of the model over every slot (``decode_step_paged`` on
the paged pool or ``decode_step`` on the contiguous cache, then the
greedy argmax and the stop conditions, all on the device) and ONE
batched ``(token-or-minus-one, done)`` copy to the host. Step *k*'s copy
is started right after its dispatch and read only after step *k+1* has
been dispatched, so the host never waits on the step it just queued
(``readbacks == steps``). Prefill admission pads prompts to pow2 buckets
(at most the cache's rows: a sliding-window config prefills a prompt
longer than its window at its exact length) and takes the logits at the
true length, then writes the prompt's K/V into its pages or its slot.

The host keeps an exact mirror of each slot's device position, emit count
and activity: the stop conditions are deterministic, so the page
allocator can back the next write without waiting for the readback.

Not ported yet: sampling other than greedy (refused at submission),
preemption (the pool is fully subscribed by default, and a decode write
that finds no free page raises), the prefix cache, chaos, deadlines,
speculative decoding and tensor parallelism.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.serving.cache_manager import make_cache_manager
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import FCFSScheduler

I32 = torch.int32


@dataclasses.dataclass
class Request:
    """One generation request: prompt, budget, sampling, and its stream."""

    rid: int
    prompt: np.ndarray                  # token ids [S]
    max_new_tokens: int = 16
    sampling: Optional[SamplingParams] = None   # None -> greedy
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    t_submit: float = 0.0               # set by Engine.submit
    t_first: float = 0.0                # wall time of the first token
    arrival: int = -1                   # submission rank, set by submit
    finish_reason: Optional[str] = None  # done | rejected
    error: Optional[str] = None


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None
    dpos: int = 0                       # device pos (next write position)
    demitted: int = 0                   # device emitted count
    dactive: bool = False               # device active flag


class Engine:
    """Continuous-batching core: one decode pass and one batched host
    readback per step."""

    def __init__(self, params, cfg: ModelConfig, *, slots: int = 4,
                 max_seq: int = 512, scheduler=None, cache_manager=None,
                 device=None):
        """``params`` in the port's layout (``registry.init_params`` or
        ``convert.params_from_jax``) are moved to ``device`` (default
        ``cuda``). ``scheduler`` is a ``Scheduler`` (FCFS when None);
        ``cache_manager`` a ``CacheConfig`` or a ready manager."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = registry.module_for(cfg).cast_params(params, cfg,
                                                           self.device)
        self.n_slots, self.max_seq = slots, max_seq
        self.slots = [_Slot() for _ in range(slots)]
        self.scheduler = scheduler if scheduler is not None \
            else FCFSScheduler()
        self.cm = make_cache_manager(cache_manager, cfg, slots, max_seq,
                                     self.device)
        self.cache = self.cm.init()
        self._pad_ok = registry.pad_prefill_ok(cfg)
        self._token = self._zeros(I32)
        self._pos = self._zeros(I32)
        self._active = self._zeros(torch.bool)
        self._emitted = self._zeros(I32)
        self._max_new = self._zeros(I32)
        self.finished: list[Request] = []
        self._arrivals = 0
        # (host copy, its event, request snapshot) of the last dispatched
        # step, not yet applied: applied after the NEXT dispatch
        self._pending = None
        self._steps = 0
        self._readbacks = 0
        self._tokens_out = 0
        self._run_s = 0.0
        self._ttfts: list[float] = []       # submit -> first token, s
        self._rejected = 0
        self._prefill_shapes: set[int] = set()

    def _zeros(self, dtype):
        return torch.zeros((self.n_slots,), dtype=dtype, device=self.device)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A device copy of a host array that the host may change next.
        On the card the copy goes through pinned memory without blocking
        the host (the caching host allocator keeps the staging buffer
        until the copy is done), so it does not wait for queued steps."""
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    # -- request lifecycle ---------------------------------------------------

    def submit(self, req: Request) -> None:
        """Queue ``req``; an inadmissible one finishes as ``rejected``.
        A non-greedy request raises ValueError."""
        sp = req.sampling if req.sampling is not None else SamplingParams()
        if not sp.greedy:
            raise ValueError(
                f"request {req.rid}: temperature={sp.temperature} asks for "
                "sampling, which this engine does not serve yet; only "
                "greedy decoding (temperature 0) is ported")
        req.t_submit = time.perf_counter()
        req.arrival = self._arrivals
        self._arrivals += 1
        msg = self._admission_error(req)
        if msg is not None:
            self._finish(req, "rejected", msg)
            return
        self.scheduler.push(req)

    def _admission_error(self, req: Request) -> Optional[str]:
        prompt = np.asarray(req.prompt)
        n = len(prompt)
        if n == 0:
            return "empty prompt"
        if prompt.ndim != 1 or not np.issubdtype(prompt.dtype, np.integer):
            return f"prompt must be a 1-d integer array, got {prompt.dtype}"
        lo, hi = int(prompt.min()), int(prompt.max())
        if lo < 0 or hi >= self.cfg.vocab:
            return (f"token id {lo if lo < 0 else hi} outside "
                    f"[0, {self.cfg.vocab})")
        if n > self.max_seq - 1:
            return (f"prompt length {n} cannot fit max_seq={self.max_seq} "
                    "(no room to emit a token)")
        return self.cm.infeasible(n)

    def _finish(self, req: Request, reason: str,
                error: Optional[str] = None) -> None:
        req.done = True
        req.finish_reason = reason
        req.error = error
        self._rejected += reason == "rejected"
        self.finished.append(req)

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

    def _admit(self) -> None:
        for i, slot in enumerate(self.slots):
            if slot.req is not None or not len(self.scheduler):
                continue
            req = self.scheduler.peek()
            prompt = np.asarray(req.prompt)
            n = len(prompt)
            b = self._bucket_len(n)
            if not self.cm.alloc(i, n):
                return             # head-of-line: admission waits for pages
            self.scheduler.pop()
            pages = self.cm.prefill_pages(i, n, b)
            if pages is not None:
                pages = self._upload(pages)
            if b is not None and b > n:
                prompt = np.concatenate([prompt,
                                         np.zeros(b - n, prompt.dtype)])
            self._prefill_shapes.add(len(prompt))
            tok0 = self._prefill(i, req, prompt, n, pages)
            req.out_tokens.append(int(tok0))   # host sync: admission only
            self._tokens_out += 1
            req.t_first = time.perf_counter()
            self._ttfts.append(req.t_first - req.t_submit)
            slot.req = req
            slot.dpos = n
            slot.demitted = len(req.out_tokens)
            slot.dactive = True

    def _prefill(self, i: int, req: Request, prompt: np.ndarray, n: int,
                 pages: Optional[torch.Tensor]) -> torch.Tensor:
        """Prefill one prompt, write its pages (paged) or slot ``i``
        (contiguous) and reset slot ``i``'s device state (the body of the
        JAX engine's ``_make_admit``). Returns the first token (a device
        scalar)."""
        tokens = torch.tensor(prompt[None], dtype=torch.long,
                              device=self.device)
        logits, kv = registry.prefill(self.params, self.cfg, tokens,
                                      length=n if self._pad_ok else None)
        self.cache = self.cm.write(self.cache, kv, slot=i, pages=pages)
        tok0 = torch.argmax(logits[0, :self.cfg.vocab]).to(I32)
        self._token[i] = tok0
        self._pos[i] = n
        self._active[i] = True
        self._emitted[i] = len(req.out_tokens) + 1
        self._max_new[i] = req.max_new_tokens
        return tok0

    def _ensure_pages(self) -> None:
        """Back every device-active slot's next write position. With the
        default full subscription a page is always free; a smaller pool
        that runs dry raises, as preemption is not ported yet."""
        for i in range(self.n_slots):
            slot = self.slots[i]
            if slot.req is None or not slot.dactive:
                continue
            while not self.cm.backed(i, slot.dpos):
                if self.cm.grow(i):
                    continue
                self._drain()          # finished slots may free pages
                if self.slots[i].req is None or not self.slots[i].dactive:
                    break
                if self.cm.has_free:
                    continue
                raise RuntimeError(
                    "the KV pool has no free page for a decode write and "
                    "preemption is not ported yet; use the default, fully "
                    "subscribed pool (num_pages=None)")

    # -- one engine step -----------------------------------------------------

    def has_work(self) -> bool:
        """True while anything is queued, in flight, or resident."""
        return bool(len(self.scheduler) or self._pending is not None
                    or any(s.req is not None for s in self.slots))

    def _decode(self):
        """Dispatch one decode step over every slot (the greedy body of
        the JAX engine's ``_make_step``); returns the device ``(emit_tok,
        done)`` pair (emit -1 where the slot was idle)."""
        table = self.cm.page_table()
        if table is not None:
            table = self._upload(table)
        logits, self.cache = self.cm.decode(self.params, self.cache,
                                            self._token, self._pos, table)
        nxt = torch.argmax(logits[:, :self.cfg.vocab], dim=-1).to(I32)
        new_pos = self._pos + 1
        new_emitted = self._emitted + self._active.to(I32)
        done = self._active & ((new_emitted >= self._max_new)
                               | (new_pos >= self.max_seq - 1))
        emit_tok = torch.where(self._active, nxt, -1)
        self._token, self._pos, self._emitted = nxt, new_pos, new_emitted
        self._active = self._active & ~done
        return emit_tok, done

    def _start_readback(self, emit_tok, done):
        """Queue the step's one device-to-host copy; returns (host buffer,
        event that marks it complete or None on the CPU)."""
        packed = torch.stack([emit_tok, done.to(I32)])
        if self.device.type != "cuda":
            return packed, None
        host = torch.empty(packed.shape, dtype=I32, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def step(self) -> bool:
        """Admit what fits, dispatch one decode step, and apply the
        previous step's readback. False when nothing could run."""
        if self._pending is not None and \
                (len(self.scheduler)
                 and all(s.req is not None for s in self.slots)
                 or all(s.req is None or not s.dactive
                        for s in self.slots)):
            # apply the pending emit first when it can change what to do
            # next: its done flags may free slots for waiting requests,
            # or every occupied slot finishes inside it (dispatching first
            # would burn an all-idle step)
            self._drain()
        self._admit()
        self._ensure_pages()
        if not any(s.req is not None for s in self.slots):
            self._drain()
            self._admit()
            self._ensure_pages()
            if not any(s.req is not None for s in self.slots):
                return False
        emit = self._start_readback(*self._decode())
        self._steps += 1
        # mirror the device's stop conditions on the host shadows (this
        # step's readback is still in flight)
        for s in self.slots:
            if s.req is not None and s.dactive:
                s.demitted += 1
                s.dpos += 1
                if (s.demitted >= s.req.max_new_tokens
                        or s.dpos >= self.max_seq - 1):
                    s.dactive = False
        self.cm.note_step()
        prev, self._pending = self._pending, (emit,
                                              [s.req for s in self.slots])
        if prev is not None:
            self._apply(prev)           # readback of step k-1 after k
        return True

    def _drain(self) -> None:
        if self._pending is not None:
            prev, self._pending = self._pending, None
            self._apply(prev)

    def _apply(self, pending) -> None:
        (host, event), reqs = pending
        # THE host readback of a step: one batched copy, counted so that
        # readbacks == steps can be checked exactly
        if event is not None:
            event.synchronize()
        self._readbacks += 1
        tok, fin = host.numpy()
        for i, req in enumerate(reqs):
            if req is None or req.done or tok[i] == -1:
                continue
            req.out_tokens.append(int(tok[i]))
            self._tokens_out += 1
            if fin[i]:
                self._finish(req, "done")
                if self.slots[i].req is req:
                    # later dispatches route this slot's idle writes to
                    # the trap page; its pages are safe to reuse
                    self.slots[i].req = None
                    self.cm.evict(i)

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
        first token, scheduler and pool counters."""
        out = {
            "steps": self._steps,
            "readbacks": self._readbacks,
            "prefill_compiles": len(self._prefill_shapes),
            "prefill_shapes": sorted(self._prefill_shapes),
            "pad_prefill": self._pad_ok,
            "slots": self.n_slots,
            "tokens": self._tokens_out,
            "tok_s": self._tokens_out / self._run_s if self._run_s else 0.0,
            "ttft": float(np.mean(self._ttfts)) if self._ttfts else None,
            "rejected": self._rejected,
        }
        out.update(self.scheduler.stats())
        out.update(self.cm.stats())
        return out
