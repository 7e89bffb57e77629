"""The drafters of speculative decoding (the port of the JAX
``serving/spec/drafter.py``).

A ``Drafter`` proposes ``k`` next tokens per slot per decode step; the
engine's captured step verifies all ``k + 1`` positions with the target
model, commits the longest accepted prefix on the device, and sends every
rejected position's K/V write to the paged pool's trap page.

``NGramDrafter``: prompt-lookup self-drafting, no model. The request's
prompt and emitted tokens are searched for the latest earlier occurrence
of their trailing n-gram, and the ``k`` tokens that followed it are
proposed. It runs on the host and keeps no state; the engine copies its
proposals into the step's static draft buffer before the replay.

``DraftModelDrafter``: a small dense draft model with its own contiguous
``slots x max_seq`` KV cache. Its ``propose`` is device work that the
engine runs inside the captured step: ``k + 1`` greedy ``decode_step``
passes fed with the target's committed carry token first, so its cache
mirrors the target stream on every accepted position (the last pass only
writes its row, so that an all-accept verify leaves the cache complete).
Rollback is free: rows past the committed position are masked by
``kv_len`` and written again by the next step before any read. Swap
preemption copies a victim's draft rows to the host and writes them back
on re-admission; crash recovery zeroes the cache in place and restores
the survivors from their copies.

Both return target token ids; a wrong proposal never makes wrong output,
since the verify commits a draft only where it equals the target's own
argmax.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import registry
from repro_torch.serving.spec.config import SpecConfig


class Drafter:
    """What the engine asks of a drafter. ``propose`` runs once a spec
    step: on the host before the replay (``on_device`` False), or inside
    the captured step (``on_device`` True). The state hooks do nothing for
    a drafter without state; ``stateful`` says whether crash recovery
    needs a copy of a slot's state."""

    stateful = False
    on_device = False

    def propose(self, slots, token, pos):
        """``[slots, k]`` int32 proposals for the current decode carry."""
        raise NotImplementedError

    def prefill(self, slot, tokens) -> None:
        """Admission: take in ``tokens`` (the whole prompt, a recomputed
        request's generated prefix included) for ``slot``."""

    def snapshot_slot(self, slot):
        """A host copy of ``slot``'s state (swap-out), or None."""
        return None

    def restore_slot(self, slot, saved) -> None:
        """Write a ``snapshot_slot`` copy back (swap-in)."""

    def reset(self) -> None:
        """Drop all state (crash recovery)."""


class NGramDrafter(Drafter):
    """Prompt-lookup self-drafting: propose what followed the latest
    earlier occurrence of the stream's trailing n-gram, backing off from
    ``ngram`` tokens to 1; with no recurrence, zeros (a valid token id
    that the verify just rejects)."""

    def __init__(self, k: int, ngram: int):
        """``k`` tokens a step, matching up to ``ngram``."""
        self.k, self.ngram = k, ngram

    def propose(self, slots, token, pos):
        """Per-slot lookup over prompt and emitted tokens, on the host."""
        out = np.zeros((len(slots), self.k), np.int32)
        for i, s in enumerate(slots):
            if s.req is None or not s.dactive:
                continue
            prompt = np.asarray(s.req.prompt)
            ctx = np.concatenate(
                [prompt, np.asarray(s.req.out_tokens, prompt.dtype)])
            out[i] = self._lookup(ctx.astype(np.int64))
        return out

    def _lookup(self, ctx: np.ndarray) -> np.ndarray:
        """The continuation of the last recurrence of the trailing
        n-gram."""
        n_ctx = len(ctx)
        out = np.zeros((self.k,), np.int32)
        for n in range(min(self.ngram, n_ctx - 1), 0, -1):
            tail = ctx[n_ctx - n:]
            # every length-n window that still has a continuation token
            win = np.lib.stride_tricks.sliding_window_view(
                ctx[:n_ctx - 1], n)
            hits = np.flatnonzero((win == tail).all(axis=1))
            if hits.size:
                j = int(hits[-1]) + n
                cand = ctx[j:j + self.k]
                out[:len(cand)] = cand
                break
        return out


class DraftModelDrafter(Drafter):
    """A small dense draft model with a contiguous per-slot KV cache that
    keeps the engine's carry invariant: positions ``0..pos-1`` written,
    the carry token's row at ``pos`` not yet."""

    stateful = True
    on_device = True

    def __init__(self, params, cfg, k: int, slots: int, max_seq: int,
                 device):
        """``params`` in the port's layout, moved to ``device``."""
        self.cfg, self.k = cfg, k
        self.slots, self.max_seq = slots, max_seq
        self.device = torch.device(device)
        self.params = registry.module_for(cfg).cast_params(params, cfg,
                                                           self.device)
        self.cache = registry.init_cache(cfg, slots, max_seq, self.device)

    def propose(self, slots, token, pos):
        """``k + 1`` greedy decode passes on the draft cache, in place;
        returns the ``[slots, k]`` drafts on the device (no host sync, so
        the engine runs it inside the captured step). Pass ``j`` writes
        its input's row at ``pos + j`` and proposes draft ``j + 1``."""
        x, drafts = token, []
        for j in range(self.k + 1):
            logits, _ = registry.decode_cached(self.params, self.cfg,
                                               self.cache, x, pos + j)
            x = torch.argmax(logits[:, :self.cfg.vocab], dim=-1) \
                .to(torch.int32)
            if j < self.k:
                drafts.append(x)
        return torch.stack(drafts, dim=1)

    def prefill(self, slot, tokens) -> None:
        """Prefill the whole prompt into ``slot``'s rows, right-padded to
        its pow2 bucket (exact: the draft family pads exactly)."""
        tokens = np.asarray(tokens)
        n = len(tokens)
        b = 1
        while b < n:
            b *= 2
        b = min(b, self.max_seq)
        if b > n:
            tokens = np.concatenate([tokens, np.zeros(b - n, tokens.dtype)])
        t = torch.tensor(tokens[None], dtype=torch.long, device=self.device)
        _, kv = registry.prefill(self.params, self.cfg, t, length=n)
        registry.write_slot(self.cfg, self.cache, kv, slot)

    def snapshot_slot(self, slot):
        """A host copy of ``slot``'s rows on every cache leaf."""
        return {name: c[:, slot:slot + 1].to("cpu", copy=True)
                for name, c in self.cache.items()}

    def restore_slot(self, slot, saved) -> None:
        """Write a ``snapshot_slot`` copy back into ``slot``, in place."""
        registry.write_slot(self.cfg, self.cache,
                            {name: t.to(self.device)
                             for name, t in saved.items()}, slot)

    def reset(self) -> None:
        """Zero the cache in place (its tensors stay where a captured
        step reads them)."""
        for c in self.cache.values():
            c.zero_()


def make_drafter(spec: SpecConfig, cfg, slots: int, max_seq: int,
                 device) -> Drafter:
    """Resolve a ``SpecConfig`` into a drafter for this engine, checking
    the draft model against the target: token prompts, exact right-padded
    prefill (the drafter buckets prompts like the engine), and a vocab
    that covers every target token id."""
    if spec.drafter == "ngram":
        return NGramDrafter(spec.k, spec.ngram)
    dcfg = spec.draft_cfg
    if getattr(dcfg, "frontend", "tokens") == "frames":
        raise ValueError("draft models take token prompts; a frames "
                         "frontend cannot draft")
    if not registry.pad_prefill_ok(dcfg):
        raise ValueError(
            f"draft family {dcfg.family!r} has no exact right-padded "
            "prefill; use a dense draft model (or drafter='ngram')")
    if dcfg.vocab < cfg.vocab:
        raise ValueError(
            f"draft vocab {dcfg.vocab} cannot cover target vocab "
            f"{cfg.vocab}: proposals are target token ids")
    return DraftModelDrafter(spec.draft_params, dcfg, spec.k, slots,
                             max_seq, device)
