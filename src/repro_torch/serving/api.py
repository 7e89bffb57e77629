"""Facade layer of the serving API: ``LLMEngine``.

Two entry points over the engine:

    generate(prompts, sampling_params) -> list[RequestOutput]
        Submit a batch, run it to completion, return one output per
        prompt, in submission order.

    stream(prompts, sampling_params) -> iterator[TokenEvent]
        The same submission, but yields one event per token as the
        engine's readbacks land: tokens of concurrent requests interleave,
        and each event carries (rid, token, index, done).

Both take one ``SamplingParams`` for the whole batch or one per prompt,
and per-request ``max_new_tokens``, ``priorities`` and ``deadlines``
(seconds from submission). The engine (its slots, KV pool and prefix
tree) is shared across calls, and request ids keep increasing, so one
``LLMEngine`` serves successive waves. ``abort(rid)`` cancels a live
request. No request is dropped: one the engine leaves unfinished (it
stopped making progress, or ``max_steps`` ran out) finishes as
``failed``, as every other outcome does, with its ``finish_reason``.
A prompt is token ids ``[S]``, or for a frames config (the
encoder-decoder) frame embeddings ``[S, d_model]``; ``prompt_len`` is S.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, Optional, Sequence, Union

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.serving.cache_manager import CacheConfig
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.sampling import SamplingParams


@dataclasses.dataclass(frozen=True)
class TokenEvent:
    """One token of one request, in stream order. A request that ends
    without a fresh token (aborted, rejected, deadline-expired, or failed
    with nothing new since its last event) closes its stream with a
    terminal sentinel: ``token=-1, done=True`` and its
    ``finish_reason``."""

    rid: int
    token: int
    index: int          # 0-based position within the request's output
    done: bool          # True on the request's last event
    finish_reason: Optional[str] = None  # set on the last event only
    accepted_tokens: int = 0    # draft tokens the verify committed for
    #                             this request so far (0 without spec)


@dataclasses.dataclass
class RequestOutput:
    """A finished request: its output stream plus serving metadata.
    ``finish_reason`` is ``done``, ``aborted``, ``rejected``, ``failed``
    or ``deadline``; anything but ``done`` carries its cause in ``error``
    (where there is one) and possibly part of a stream."""

    rid: int
    prompt_len: int                     # tokens, or frames
    tokens: list
    ttft_s: Optional[float] = None      # submit -> first token
    preemptions: int = 0                # times evicted and requeued
    prefix_hit_tokens: int = 0          # prompt tokens served from the tree
    accepted_tokens: int = 0            # draft tokens the verify committed
    finish_reason: str = "done"
    error: Optional[str] = None


SamplingLike = Union[SamplingParams, Sequence[SamplingParams], None]


class LLMEngine:
    """vLLM-style facade over ``Engine``.

    Runs on ``device`` (default ``cuda``; with no GPU it raises unless the
    caller passes ``device="cpu"``). ``paged`` picks the KV layout: None
    serves from the paged pool where the architecture can page and from
    the contiguous cache otherwise (a sliding-window config's ring);
    ``page_size`` / ``num_pages`` configure the pool (``num_pages=None``
    fully subscribes; fewer pages oversubscribe it); ``prefix_cache``
    turns the radix prefix cache on for the paged pool. ``scheduler`` is
    ``"fcfs"``, ``"priority"`` or ``"sjf"`` (or a ``Scheduler``);
    ``preemption`` ``"swap"`` or ``"recompute"`` (or a
    ``PreemptionPolicy``); ``sampling`` the ``SamplingParams`` of prompts
    given none (greedy when None); ``chaos`` a ``ChaosInjector`` (or a
    ``Fault`` list) that injects faults at chosen steps; ``spec`` a
    ``SpecConfig`` for speculative decoding (greedy requests only; the
    streams equal target-only decoding's, in fewer steps); ``mesh`` a
    ``(data, model)`` ``DeviceMesh`` for tensor-parallel serving (every
    rank builds the same facade; see ``Engine``)."""

    def __init__(self, params, cfg: ModelConfig, *, slots: int = 4,
                 max_seq: int = 512, scheduler="fcfs", preemption="swap",
                 paged: Optional[bool] = None, page_size: int = 16,
                 num_pages: Optional[int] = None, prefix_cache: bool = True,
                 sampling: Optional[SamplingParams] = None, chaos=None,
                 spec=None, mesh=None, device=None):
        self.cfg = cfg
        self.engine = Engine(
            params, cfg, slots=slots, max_seq=max_seq, sampling=sampling,
            scheduler=scheduler, preemption=preemption, chaos=chaos,
            spec=spec, mesh=mesh, device=device,
            cache_manager=CacheConfig(paged=paged, page_size=page_size,
                                      num_pages=num_pages,
                                      prefix_cache=prefix_cache))
        self._next_rid = 0

    def abort(self, rid: int) -> bool:
        """Cancel a live request by rid (``finish_reason="aborted"``); its
        pages are released at once. True when a live one was found."""
        return self.engine.abort(rid)

    def _submit(self, prompts: Iterable, sampling_params: SamplingLike,
                max_new_tokens, priorities, deadlines) -> list[Request]:
        prompts = list(prompts)
        n = len(prompts)
        if isinstance(sampling_params, SamplingParams) \
                or sampling_params is None:
            sampling_params = [sampling_params] * n
        if isinstance(max_new_tokens, int):
            max_new_tokens = [max_new_tokens] * n
        priorities = list(priorities) if priorities is not None else [0] * n
        if deadlines is None or isinstance(deadlines, (int, float)):
            deadlines = [deadlines] * n
        for name, arg in (("sampling_params", sampling_params),
                          ("max_new_tokens", max_new_tokens),
                          ("priorities", priorities),
                          ("deadlines", deadlines)):
            if len(arg) != n:
                raise ValueError(f"{len(arg)} {name} for {n} prompts")
        reqs = []
        for prompt, sp, mnt, prio, dl in zip(prompts, sampling_params,
                                             max_new_tokens, priorities,
                                             deadlines):
            req = Request(rid=self._next_rid, prompt=np.asarray(prompt),
                          max_new_tokens=int(mnt), sampling=sp,
                          priority=int(prio),
                          deadline_s=None if dl is None else float(dl))
            self._next_rid += 1
            self.engine.submit(req)
            reqs.append(req)
        return reqs

    def stream(self, prompts: Iterable, sampling_params: SamplingLike = None,
               *, max_new_tokens=16, priorities=None, deadlines=None,
               max_steps: int = 10_000) -> Iterator[TokenEvent]:
        """Submit ``prompts`` and yield ``TokenEvent``s as tokens land.

        Events of concurrent requests interleave; per request they come in
        stream order with ``done=True`` on the last one. The events of a
        step come from its one readback, which the engine applies after
        the next step's dispatch: an event trails its step by one step,
        never more, and streaming adds no device sync. Every stream ends:
        a request that ends without a fresh token (aborted, rejected,
        deadline, failed; and one left unfinished when the engine stops
        making progress or ``max_steps`` runs out, which fails) closes
        with a ``token=-1, done=True`` sentinel."""
        reqs = self._submit(prompts, sampling_params, max_new_tokens,
                            priorities, deadlines)
        emitted = {req.rid: 0 for req in reqs}
        closed: set = set()

        def new_events():
            for req in reqs:
                while emitted[req.rid] < len(req.out_tokens):
                    i = emitted[req.rid]
                    emitted[req.rid] += 1
                    last = req.done \
                        and emitted[req.rid] == len(req.out_tokens)
                    if last:
                        closed.add(req.rid)
                    yield TokenEvent(
                        rid=req.rid, token=req.out_tokens[i], index=i,
                        done=last,
                        finish_reason=req.finish_reason if last else None,
                        accepted_tokens=req.accepted_tokens)
                if req.done and req.rid not in closed:
                    # the terminal sentinel: finished with no fresh token
                    closed.add(req.rid)
                    yield TokenEvent(rid=req.rid, token=-1,
                                     index=len(req.out_tokens), done=True,
                                     finish_reason=req.finish_reason,
                                     accepted_tokens=req.accepted_tokens)

        steps = max_steps
        while steps > 0 and self.engine.has_work():
            if not self.engine.step():
                break
            steps -= 1
            yield from new_events()
        self.engine.flush()
        self._fail_leftovers(reqs)
        yield from new_events()
        self._release(reqs)

    def generate(self, prompts: Iterable,
                 sampling_params: SamplingLike = None, *,
                 max_new_tokens=16, priorities=None, deadlines=None,
                 max_steps: int = 10_000) -> list[RequestOutput]:
        """Submit ``prompts``, run to completion, return their outputs in
        submission order. ``sampling_params`` is one ``SamplingParams`` for
        all prompts or one per prompt; ``max_new_tokens`` and
        ``deadlines`` a number or one per prompt, ``priorities`` a list.
        A request's failure never raises: its output carries its
        ``finish_reason`` (and ``error``)."""
        reqs = self._submit(prompts, sampling_params, max_new_tokens,
                            priorities, deadlines)
        self.engine.run(max_steps=max_steps)
        self._fail_leftovers(reqs)
        self._release(reqs)
        return [RequestOutput(
            rid=r.rid, prompt_len=len(r.prompt), tokens=list(r.out_tokens),
            ttft_s=(r.t_first - r.t_submit) if r.t_first else None,
            preemptions=r.preemptions, prefix_hit_tokens=r.prefix_hit_tokens,
            accepted_tokens=r.accepted_tokens,
            finish_reason=r.finish_reason, error=r.error) for r in reqs]

    def _fail_leftovers(self, reqs) -> None:
        """Finish as ``failed`` every request the engine left unfinished
        (it stopped making progress, or ``max_steps`` ran out), releasing
        what it still holds, so that no stream is dropped."""
        for req in reqs:
            if not req.done:
                self.engine.cancel_request(
                    req, "failed",
                    "engine stopped making progress before this request "
                    "finished")

    def _release(self, reqs) -> None:
        """Drop this wave's requests from the engine's finished list (by
        identity), so a long-lived facade keeps no prompt it served."""
        done = {id(r) for r in reqs}
        self.engine.finished = [r for r in self.engine.finished
                                if id(r) not in done]

    def stats(self) -> dict:
        """The engine's counters."""
        return self.engine.stats()
