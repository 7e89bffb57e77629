"""Speculative decoding inside the captured decode step (the port of the
JAX ``serving/spec/``).

``SpecConfig`` names a drafter (``"ngram"`` prompt lookup, or
``"draft_model"``) and a draft length ``k``; the engine resolves it with
``make_drafter`` and verifies all ``k + 1`` positions in its one decode
step: ``k + 1`` sequential passes of the target over the paged pool, each
pass's K/V write masked by its own commit flag (rejected positions go to
the trap page), and still one batched host readback a step. Greedy spec
streams equal target-only decoding token for token. ``space`` searches
(drafter, k) against serving throughput.
"""

from repro_torch.serving.spec.config import DRAFTERS, SpecConfig
from repro_torch.serving.spec.drafter import (Drafter, DraftModelDrafter,
                                              NGramDrafter, make_drafter)

__all__ = ["DRAFTERS", "SpecConfig", "Drafter", "DraftModelDrafter",
           "NGramDrafter", "make_drafter"]
