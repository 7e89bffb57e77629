"""``SpecConfig``: the speculative-decoding settings (the port of the JAX
``serving/spec/config.py``).

A frozen config the caller hands to ``LLMEngine(spec=...)`` /
``Engine(spec=...)`` (or builds from ``launch/serve.py --spec/--spec-k``).
It names the drafter (``"ngram"`` self-drafting, or ``"draft_model"``
with a small dense draft model), the draft length ``k`` and the
drafter's own knobs; the engine resolves it into a ``Drafter`` through
``make_drafter`` and runs the verify, acceptance and rollback inside its
captured decode step. Like ``CacheConfig.prefix_cache`` it is inert where
it cannot run (the contiguous cache): the engine then serves target-only
with zero spec counters.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

DRAFTERS = ("ngram", "draft_model")


@dataclasses.dataclass(frozen=True, eq=False)
class SpecConfig:
    """Speculative-decoding configuration for the serving engine.

    drafter: ``"ngram"`` (prompt lookup in the request's own prompt and
        emitted tokens: no model, no device state) or ``"draft_model"``
        (a small dense draft model with its own contiguous KV cache).
    k: tokens proposed a step; the verify scores all ``k + 1`` positions,
        so a step commits between 1 and ``k + 1`` tokens.
    ngram: the longest trailing n-gram the n-gram drafter looks up (it
        backs off toward 1 until one recurs).
    draft_params / draft_cfg: the draft model's weights (in the port's
        layout) and ``ModelConfig`` (``drafter="draft_model"`` only). Its
        vocab must cover the target's: proposals are target token ids.
    """

    drafter: str = "ngram"
    k: int = 4
    ngram: int = 3
    draft_params: Optional[Any] = dataclasses.field(default=None,
                                                    repr=False)
    draft_cfg: Optional[Any] = None

    def __post_init__(self):
        """Reject unusable configurations up front."""
        if self.drafter not in DRAFTERS:
            raise ValueError(f"drafter={self.drafter!r} must be one of "
                             f"{DRAFTERS}")
        if self.k < 1:
            raise ValueError(f"k={self.k} must be >= 1 (propose at least "
                             "one draft token)")
        if self.ngram < 1:
            raise ValueError(f"ngram={self.ngram} must be >= 1")
        if self.drafter == "draft_model" and (
                self.draft_params is None or self.draft_cfg is None):
            raise ValueError("drafter='draft_model' needs draft_params= "
                             "and draft_cfg= (the small draft model)")
