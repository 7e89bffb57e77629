"""Search space over the speculative-decoding knobs (drafter, k) (the
port of the JAX ``serving/spec/space.py``).

A ``SpecVariant`` names one point of the space; ``evaluate`` scores it by
end-to-end serving throughput (one in-process ``LLMEngine.generate`` over
a fixed request mix), and ``autotune`` sweeps the space and returns the
best valid variant. Validity is the acceptance oracle: a variant counts
only if its greedy streams equal the target-only streams token for token
(a drafter may be slow, never wrong).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

from repro_torch.serving.spec.config import DRAFTERS, SpecConfig


@dataclasses.dataclass(frozen=True)
class SpecVariant:
    """One point of the space: the drafter and the draft length."""

    drafter: str
    k: int

    def to_config(self, draft_params=None, draft_cfg=None) -> SpecConfig:
        """The ``SpecConfig`` of this variant (the draft model's weights
        attached for ``"draft_model"``)."""
        if self.drafter == "draft_model":
            return SpecConfig(drafter=self.drafter, k=self.k,
                              draft_params=draft_params,
                              draft_cfg=draft_cfg)
        return SpecConfig(drafter=self.drafter, k=self.k)


def enumerate_variants(ks: Sequence[int] = (1, 2, 3, 4, 6),
                       drafters: Sequence[str] = DRAFTERS,
                       *, with_draft_model: bool = True):
    """The swept (drafter, k) grid; without draft weights, no draft-model
    points."""
    return [SpecVariant(drafter=d, k=k) for d in drafters
            if d != "draft_model" or with_draft_model for k in ks]


def _serve(params, cfg, prompts, spec, *, slots, max_seq, max_new,
           page_size, device):
    """One in-process serve; returns (streams, wall seconds, stats)."""
    from repro_torch.serving.api import LLMEngine
    eng = LLMEngine(params, cfg, slots=slots, max_seq=max_seq,
                    page_size=page_size, spec=spec, device=device)
    t0 = time.perf_counter()
    outs = eng.generate(prompts, max_new_tokens=max_new)
    wall = time.perf_counter() - t0
    return [o.tokens for o in outs], wall, eng.stats()


def evaluate(params, cfg, variant: SpecVariant, prompts, *,
             draft_params=None, draft_cfg=None, slots: int = 4,
             max_seq: int = 128, max_new: int = 16, page_size: int = 16,
             baseline: Optional[tuple] = None, device=None) -> dict:
    """Score one variant against the target-only serve: a row with
    ``tok_per_s``, the spec counters and ``valid`` (greedy streams equal
    to target-only). ``baseline=(streams, wall_s)`` shares one
    target-only serve across a sweep; without it one runs here."""
    kw = dict(slots=slots, max_seq=max_seq, max_new=max_new,
              page_size=page_size, device=device)
    if baseline is None:
        baseline = _serve(params, cfg, prompts, None, **kw)[:2]
    base_streams, base_wall = baseline
    spec = variant.to_config(draft_params=draft_params,
                             draft_cfg=draft_cfg)
    streams, wall, stats = _serve(params, cfg, prompts, spec, **kw)
    toks = sum(len(s) for s in streams)
    return {
        "drafter": variant.drafter,
        "k": variant.k,
        "tok_per_s": toks / max(wall, 1e-9),
        "base_tok_per_s": sum(len(s) for s in base_streams)
        / max(base_wall, 1e-9),
        "wall_s": wall,
        "steps": stats["steps"],
        "accepted_per_step": stats.get("accepted_per_step", 0.0),
        "accept_rate": stats.get("accept_rate", 0.0),
        "draft_tokens": stats.get("draft_tokens", 0),
        "valid": streams == base_streams,
    }


def autotune(params, cfg, prompts, *, draft_params=None, draft_cfg=None,
             ks: Sequence[int] = (1, 2, 3, 4, 6), slots: int = 4,
             max_seq: int = 128, max_new: int = 16, page_size: int = 16,
             device=None) -> dict:
    """Sweep the (drafter, k) grid against serving tokens a second.
    Returns ``{"rows": [...], "best": row or None}``: ``best`` is the
    fastest valid variant, None when none is valid (a fault the caller
    must surface)."""
    kw = dict(slots=slots, max_seq=max_seq, max_new=max_new,
              page_size=page_size, device=device)
    base = _serve(params, cfg, prompts, None, **kw)[:2]
    rows = [evaluate(params, cfg, v, prompts, draft_params=draft_params,
                     draft_cfg=draft_cfg, baseline=base, **kw)
            for v in enumerate_variants(
                ks=ks, with_draft_model=draft_params is not None)]
    valid = [r for r in rows if r["valid"]]
    best = max(valid, key=lambda r: r["tok_per_s"]) if valid else None
    return {"rows": rows, "best": best}
