"""Host-driven reference engine (the JAX ``serving/reference.py``): the
historical continuous-batching loop from before the device-resident
engine, kept as the equivalence oracle.

``Engine`` (``serving/engine.py``) must give the same per-request token
streams as this loop where the JAX tests hold the JAX pair equal. Every
per-token pathology the engine removes is here on purpose: an eager
decode step (never captured), a host argmax with one ``.item()`` readback
per slot per step, an eager scatter of each request's prefill cache into
its slot, and a prefill at each prompt's exact length.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.serving.engine import Request, _Slot


class ReferenceEngine:
    """Host-driven greedy oracle pinning the pre-refactor token streams,
    on ``device`` (default ``cuda``)."""

    def __init__(self, params, cfg: ModelConfig, *, slots: int = 4,
                 max_seq: int = 512, greedy: bool = True, sampling=None,
                 spec=None, device=None):
        # greedy-only by design: it pins the argmax streams. ``sampling``
        # is accepted for signature parity with Engine but must describe
        # greedy decoding
        if not greedy or (sampling is not None and not sampling.greedy):
            raise ValueError("ReferenceEngine is the greedy (argmax) "
                             "oracle; non-greedy streams have no "
                             "host-driven reference")
        # ``spec`` is signature parity only: the oracle IS the target-only
        # stream speculative decoding must reproduce
        if spec is not None:
            raise ValueError("ReferenceEngine is the target-only oracle "
                             "speculative streams are checked against; "
                             "SpecConfig has no host-driven reference "
                             "(pass spec=None)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = registry.module_for(cfg).cast_params(params, cfg,
                                                           self.device)
        self.n_slots, self.max_seq = slots, max_seq
        self.slots = [_Slot() for _ in range(slots)]
        self._pos_host = [0] * slots
        self.cache = registry.init_cache(cfg, slots, max_seq, self.device)
        self.queue: list[Request] = []
        self.finished: list[Request] = []
        self._token = torch.zeros((slots,), dtype=torch.int32,
                                  device=self.device)
        self._pos = torch.zeros((slots,), dtype=torch.int32,
                                device=self.device)

    def submit(self, req: Request) -> None:
        """Queue ``req`` (admitted first come, first served)."""
        self.queue.append(req)

    def _admit(self) -> None:
        frames = self.cfg.frontend == "frames"
        for i, slot in enumerate(self.slots):
            if slot.req is None and self.queue:
                req = self.queue.pop(0)
                prompt = torch.tensor(
                    np.asarray(req.prompt)[None], device=self.device,
                    dtype=torch.float32 if frames else torch.long)
                logits, kv = registry.prefill(self.params, self.cfg, prompt)
                # scatter this request's prefill cache into slot i
                for name, pool in self.cache.items():
                    _write_slot(pool, kv[name], i, self.max_seq)
                tok = int(torch.argmax(logits[0, :self.cfg.vocab]).item())
                req.out_tokens.append(tok)
                slot.req = req
                self._pos_host[i] = len(req.prompt) \
                    if self.cfg.family != "encdec" else 1
                self._token[i] = tok
                self._pos[i] = self._pos_host[i]

    def step(self) -> bool:
        """Admit into free slots, then one eager decode step over every
        slot with a host argmax per slot. False when no slot is busy."""
        self._admit()
        if not any(s.req for s in self.slots):
            return False
        logits, self.cache = registry.decode_cached(
            self.params, self.cfg, self.cache, self._token, self._pos)
        next_tok = torch.argmax(logits[:, :self.cfg.vocab], dim=-1) \
            .to(torch.int32)
        self._token = next_tok
        self._pos = self._pos + 1
        for i, slot in enumerate(self.slots):
            if slot.req is None:
                continue
            self._pos_host[i] += 1
            tok = int(next_tok[i].item())
            slot.req.out_tokens.append(tok)
            if (len(slot.req.out_tokens) >= slot.req.max_new_tokens
                    or self._pos_host[i] >= self.max_seq - 1):
                slot.req.done = True
                self.finished.append(slot.req)
                slot.req = None
        return True

    def run(self, max_steps: int = 10_000) -> list:
        """Step until nothing is queued or resident (or ``max_steps``);
        returns the finished requests."""
        while (self.queue or any(s.req for s in self.slots)) \
                and max_steps > 0:
            self.step()
            max_steps -= 1
        return self.finished


def _write_slot(pool: torch.Tensor, new: torch.Tensor, i: int,
                max_seq: int) -> None:
    """Insert one request's prefill cache leaf ``[L, 1, S, ...]`` into
    slot ``i`` of ``pool`` along axis 1, in place, with the JAX
    reference's leaf filter and ``dynamic_update_slice`` semantics.

    Right for families whose cache holds the slot on axis 1 (dense, MoE,
    the encoder-decoder); the engine replaces it with the axes-driven
    ``registry.write_slot``. A leaf whose rank or leading dimension
    differs from ``new``'s, or of rank under 3, is left as it was. The
    update is ``new[:, :1, :min(S, max_seq)]`` where the pool has the
    rows, else its last ``pool.shape[2]`` rows; it lands at index 0 of
    every other axis, and its start on axis 1 is clamped so that the
    update fits (so a recurrent state ``[P, stack, slots, ...]`` is
    written where JAX writes it)."""
    if pool.ndim != new.ndim or pool.shape[0] != new.shape[0] \
            or new.ndim < 3:
        return
    if pool.shape[2] >= new.shape[2]:
        upd = new[:, :1, :min(new.shape[2], max_seq)]
    else:
        upd = new[:, :1, -pool.shape[2]:]
    if any(u > p for u, p in zip(upd.shape, pool.shape)):
        raise ValueError(f"update {tuple(upd.shape)} does not fit the "
                         f"cache leaf {tuple(pool.shape)}")
    start = min(max(i, 0), pool.shape[1] - upd.shape[1])
    dst = pool.narrow(1, start, upd.shape[1])
    for axis in range(2, upd.ndim):
        dst = dst.narrow(axis, 0, upd.shape[axis])
    dst.copy_(upd)
