"""Open-loop arrivals: a Poisson process, or a two-state Markov-modulated
one (the arrival process of ``repro_torch.serving.workload.bursty_poisson``:
calm and burst phases alternate every ``phase_s`` seconds, the burst
rate ``burst_factor`` times the calm one, the mean rate ``rate``).

Parameters: ``rate`` (req/s, set by the cell), ``burst_factor``,
``phase_s``, ``prompt_lens``, ``new_tokens`` ([lo, hi]) and
``traffic_seed``.

The arrivals are one sample of the process over the window, drawn from
the mix's fixed ``traffic_seed``, not from the run's seed: a Poisson
count of arrivals with mean Λ(seconds), the integrated rate, placed
uniformly in the process's own time and mapped to the window by the
inverse of Λ; each request's prompt length drawn uniformly from
``prompt_lens`` and its output length uniformly from [lo, hi]. So every
run of a cell at one window length serves the same arrival trace, with
the variance in arrival counts that sets a queueing tail, and the run's
seed draws the prompts' token ids alone (the weights being its other
use). (Draws from the run's seed moved the tails by 10-15 % from run to
run: PERF.md.)
"""
from __future__ import annotations

from typing import List

import numpy as np

from perfbench.traffic import Item


def _rates(rate: float, burst_factor: float) -> np.ndarray:
    """The calm and the burst phase's rates, whose mean is ``rate``."""
    calm = 2.0 * rate / (1.0 + burst_factor)
    return np.array([calm, calm * burst_factor])


def _integrated(t: float, lam: np.ndarray, phase_s: float) -> float:
    """Λ(t): the expected arrivals in [0, t)."""
    pairs, rest = divmod(t, 2.0 * phase_s)
    return float(pairs * lam.sum() * phase_s + lam[0] * min(rest, phase_s)
                 + lam[1] * max(rest - phase_s, 0.0))


def _warp(u: np.ndarray, lam: np.ndarray, phase_s: float) -> np.ndarray:
    """Times t with Λ(t) = u."""
    per_pair = lam.sum() * phase_s  # Λ over one calm and one burst phase
    pairs = np.floor(u / per_pair)
    rest = u - pairs * per_pair
    in_calm = rest < lam[0] * phase_s
    t_in = np.where(in_calm, rest / lam[0], phase_s + (rest - lam[0] * phase_s) / lam[1])
    return pairs * 2.0 * phase_s + t_in


def generate(params: dict, seconds: float, vocab: int, rng: np.random.Generator) -> List[Item]:
    lam = _rates(float(params["rate"]), float(params.get("burst_factor", 1.0)))
    phase_s = float(params.get("phase_s", 1.0))
    trace = np.random.default_rng(int(params["traffic_seed"]))
    total = _integrated(seconds, lam, phase_s)
    n = int(trace.poisson(total))
    times = _warp(np.sort(trace.uniform(0.0, total, n)), lam, phase_s)
    lens = trace.choice(np.asarray(params["prompt_lens"], dtype=np.int64), n)
    lo, hi = (int(x) for x in params["new_tokens"])
    outs = trace.integers(lo, hi + 1, n)
    return [Item(float(t), rng.integers(0, vocab, int(s), dtype=np.int32), int(o))
            for t, s, o in zip(times, lens, outs)]
