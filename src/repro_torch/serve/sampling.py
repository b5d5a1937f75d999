"""Per-request sampling configuration.

This slice of the port decodes greedily only: ``SamplingParams`` and
``GREEDY`` keep the JAX package's contract so requests carry the same
fields, and the engine refuses a sampled request until in-graph sampling
is ported (ROADMAP P8).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Immutable per-request sampling configuration.

    temperature == 0 selects greedy argmax (the default).  ``top_k <= 0``
    disables the top-k filter; ``top_p = 1`` disables the nucleus
    filter.  ``seed=None`` derives the request's stream from its
    ``seq_id``.
    """
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got "
                             f"{self.temperature}")
        if not 0 < self.top_p <= 1:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")

    @property
    def is_greedy(self) -> bool:
        return self.temperature == 0


GREEDY = SamplingParams()


def require_greedy(params: SamplingParams) -> None:
    if not params.is_greedy:
        raise NotImplementedError(
            "sampled decoding (temperature > 0) is not ported yet "
            "(ROADMAP P8); use greedy SamplingParams")
