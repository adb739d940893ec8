"""Workload traces for the serving runtime (numpy, drawn exactly as
``repro/serving/workload.py`` draws them).

Each generator returns a list of `Request`s whose ``arrival_s`` offsets
(seconds from the runtime clock start) follow a named arrival process:

  steady          — fixed inter-arrival gap (closed-form rate).
  bursty_poisson  — two-state Markov-modulated Poisson: calm and burst
                    phases alternate every ``phase_s`` seconds, with the
                    burst rate ``burst_factor``× the calm rate; the mean
                    rate stays ≈ ``rate``. The backlog built in bursts is
                    what the concurrency knob has to absorb.
  diurnal         — inhomogeneous Poisson with a sinusoidal rate (period
                    ``period_s``), the load-shape analogue of day/night
                    traffic, sampled by thinning.

Prompt lengths are drawn from ``prompt_lens`` (keep this set small — each
distinct length forms its own groups) and output lengths uniformly
from ``new_tokens`` when a (lo, hi) tuple is given.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import numpy as np

from repro_torch.serving.runtime import Request

Lens = Union[int, Sequence[int]]
NewTokens = Union[int, Tuple[int, int]]


def _materialize(
    times: Sequence[float],
    rng: np.random.Generator,
    prompt_lens: Lens,
    new_tokens: NewTokens,
    vocab: int,
    rid0: int,
) -> List[Request]:
    lens = (prompt_lens,) if isinstance(prompt_lens, int) else tuple(prompt_lens)
    out = []
    for i, t in enumerate(times):
        length = int(rng.choice(lens))
        if isinstance(new_tokens, tuple):
            n = int(rng.integers(new_tokens[0], new_tokens[1] + 1))
        else:
            n = int(new_tokens)
        out.append(
            Request(
                rid0 + i,
                rng.integers(0, vocab, length, dtype=np.int32),
                n,
                arrival_s=float(t),
            )
        )
    return out


def steady(
    rate: float,
    duration_s: float,
    prompt_lens: Lens = 16,
    new_tokens: NewTokens = 8,
    vocab: int = 512,
    seed: int = 0,
    rid0: int = 0,
) -> List[Request]:
    """Deterministic constant-rate arrivals: one request every
    ``1/rate`` seconds for ``duration_s``."""
    rng = np.random.default_rng(seed)
    times = np.arange(0.0, duration_s, 1.0 / rate)
    return _materialize(times, rng, prompt_lens, new_tokens, vocab, rid0)


def bursty_poisson(
    rate: float,
    duration_s: float,
    burst_factor: float = 4.0,
    phase_s: float = 0.5,
    prompt_lens: Lens = 16,
    new_tokens: NewTokens = 8,
    vocab: int = 512,
    seed: int = 0,
    rid0: int = 0,
) -> List[Request]:
    """MMPP-style bursty trace: Poisson arrivals alternating between a
    calm and a ``burst_factor``× rate every ``phase_s`` seconds, with
    the duty cycle averaging back to ``rate``."""
    rng = np.random.default_rng(seed)
    # calm/burst rates chosen so the 50% duty cycle averages back to `rate`
    calm = 2.0 * rate / (1.0 + burst_factor)
    times = []
    t = float(rng.exponential(1.0 / rate))
    while t < duration_s:
        times.append(t)
        in_burst = int(t / phase_s) % 2 == 1
        lam = calm * burst_factor if in_burst else calm
        t += float(rng.exponential(1.0 / lam))
    return _materialize(times, rng, prompt_lens, new_tokens, vocab, rid0)


def diurnal(
    rate: float,
    duration_s: float,
    period_s: float = 4.0,
    depth: float = 0.8,
    prompt_lens: Lens = 16,
    new_tokens: NewTokens = 8,
    vocab: int = 512,
    seed: int = 0,
    rid0: int = 0,
) -> List[Request]:
    """Sinusoidally modulated Poisson trace (a compressed diurnal
    cycle): rate swings ±``depth`` around ``rate`` with period
    ``period_s``, sampled by thinning."""
    rng = np.random.default_rng(seed)
    lam_max = rate * (1.0 + depth)
    times = []
    t = 0.0
    while True:  # thinning: homogeneous candidates at lam_max, accept at λ(t)/lam_max
        t += float(rng.exponential(1.0 / lam_max))
        if t >= duration_s:
            break
        lam_t = rate * (1.0 + depth * np.sin(2.0 * np.pi * t / period_s))
        if rng.uniform() * lam_max <= lam_t:
            times.append(t)
    return _materialize(times, rng, prompt_lens, new_tokens, vocab, rid0)
