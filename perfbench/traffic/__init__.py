"""Traffic: one data file per mix (``<mix>.json``: its generator's name and
parameters) and one general generator per arrival process
(``<generator>.py``, a function ``generate(params, seconds, vocab, rng)``
returning :class:`Item`\\ s). The harness finds both by name."""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class Item:
    """One request: due ``arrival_s`` seconds into the window."""

    arrival_s: float
    prompt: np.ndarray
    max_new_tokens: int


def stratified_outputs(bounds: Sequence[int], n: int, rng: np.random.Generator) -> np.ndarray:
    """n output lengths at the midpoints of n equal steps over [lo, hi], in
    seeded order."""
    lo, hi = int(bounds[0]), int(bounds[1])
    mids = lo + (hi - lo + 1) * (np.arange(n) + 0.5) / n
    return rng.permutation(np.clip(np.floor(mids).astype(np.int64), lo, hi))
