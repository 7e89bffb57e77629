"""Sampling layer of the serving API: ``SamplingParams``.

``temperature == 0`` is greedy argmax, the only mode the port serves so
far: the engine refuses a request with ``temperature > 0`` at submission.
The fields of the JAX package's ``SamplingParams`` are all here, so that
requests carry the same knobs on both sides.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration.

    temperature: 0.0 => greedy argmax (the default).
    top_k: keep only the k highest-logit tokens (0 => disabled).
    top_p: nucleus mass (1.0 => disabled).
    seed: per-request seed (None => the request id).
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError(f"temperature={self.temperature} must be >= 0")
        if self.top_k < 0:
            raise ValueError(f"top_k={self.top_k} must be >= 0 (0 disables)")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p={self.top_p} must be in (0, 1]")

    @property
    def greedy(self) -> bool:
        """True for greedy argmax decoding."""
        return self.temperature == 0.0
