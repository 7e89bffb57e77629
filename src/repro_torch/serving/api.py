"""Facade layer of the serving API: ``LLMEngine``.

``generate(prompts)`` submits a batch, runs the engine to completion and
returns one ``RequestOutput`` per prompt, in submission order. The engine
(its slots and KV pool) is shared across calls, and request ids keep
increasing, so one ``LLMEngine`` serves successive waves.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence, Union

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.serving.cache_manager import CacheConfig
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.sampling import SamplingParams


@dataclasses.dataclass
class RequestOutput:
    """A finished request: its output stream plus serving metadata.
    ``finish_reason`` is ``done`` or ``rejected`` (with ``error``)."""

    rid: int
    prompt_len: int
    tokens: list
    ttft_s: Optional[float] = None      # submit -> first token
    preemptions: int = 0                # times evicted and requeued
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
    fully subscribes; fewer pages oversubscribe it). ``preemption``
    (``"swap"`` or ``"recompute"``, or a ``PreemptionPolicy``) says what
    happens to a request evicted when the pool runs dry."""

    def __init__(self, params, cfg: ModelConfig, *, slots: int = 4,
                 max_seq: int = 512, preemption="swap",
                 paged: Optional[bool] = None, page_size: int = 16,
                 num_pages: Optional[int] = None, device=None):
        self.cfg = cfg
        self.engine = Engine(
            params, cfg, slots=slots, max_seq=max_seq, device=device,
            preemption=preemption,
            cache_manager=CacheConfig(paged=paged, page_size=page_size,
                                      num_pages=num_pages))
        self._next_rid = 0

    def generate(self, prompts: Iterable,
                 sampling_params: SamplingLike = None, *,
                 max_new_tokens=16,
                 max_steps: int = 10_000) -> list[RequestOutput]:
        """Submit ``prompts``, run to completion, return their outputs in
        submission order. ``sampling_params`` is one ``SamplingParams`` for
        all prompts or one per prompt; ``max_new_tokens`` an int or one per
        prompt."""
        prompts = list(prompts)
        n = len(prompts)
        if isinstance(sampling_params, SamplingParams) \
                or sampling_params is None:
            sampling_params = [sampling_params] * n
        if isinstance(max_new_tokens, int):
            max_new_tokens = [max_new_tokens] * n
        if len(sampling_params) != n or len(max_new_tokens) != n:
            raise ValueError(f"{len(sampling_params)} sampling_params and "
                             f"{len(max_new_tokens)} max_new_tokens for "
                             f"{n} prompts")
        reqs = []
        for prompt, sp, mnt in zip(prompts, sampling_params, max_new_tokens):
            reqs.append(Request(rid=self._next_rid, prompt=np.asarray(prompt),
                                max_new_tokens=int(mnt), sampling=sp))
            self._next_rid += 1
        for req in reqs:
            self.engine.submit(req)
        self.engine.run(max_steps=max_steps)
        stuck = [r.rid for r in reqs if not r.done]
        if stuck:
            raise RuntimeError(f"requests {stuck} did not finish within "
                               f"max_steps={max_steps}")
        done = {id(r) for r in reqs}
        self.engine.finished = [r for r in self.engine.finished
                                if id(r) not in done]
        return [RequestOutput(
            rid=r.rid, prompt_len=len(r.prompt), tokens=list(r.out_tokens),
            ttft_s=(r.t_first - r.t_submit) if r.t_first else None,
            preemptions=r.preemptions, finish_reason=r.finish_reason,
            error=r.error) for r in reqs]

    def stats(self) -> dict:
        """The engine's counters."""
        return self.engine.stats()
