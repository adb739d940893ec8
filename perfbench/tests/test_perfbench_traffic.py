"""Traffic: the same inputs for a seed, the same work for every seed, the
rate it was asked for; and the percentiles over every request, with an
unfinished one counting as missing."""
import collections
import json
import math
from pathlib import Path

import numpy as np
import pytest

from perfbench import stats
from perfbench.traffic import backlog, mmpp

PB = Path(__file__).resolve().parents[1]
DOCQA = json.loads((PB / "traffic" / "docqa-poisson.json").read_text())
CHAT = json.loads((PB / "traffic" / "chat-backlog.json").read_text())


def _key(items):
    return [(round(i.arrival_s, 9), i.prompt.tobytes(), i.max_new_tokens) for i in items]


def test_a_seed_gives_the_same_inputs():
    params = {**CHAT, "requests": 96, "group": 32}
    a = backlog.generate(params, 50.0, 1000, np.random.default_rng(2**31 + 17))
    b = backlog.generate(params, 50.0, 1000, np.random.default_rng(2**31 + 17))
    c = backlog.generate(params, 50.0, 1000, np.random.default_rng(2**31 + 18))
    assert _key(a) == _key(b) and _key(a) != _key(c)


def test_open_loop_arrivals_are_the_mixs_and_token_ids_the_runs():
    """Every run seed serves the mix's one arrival trace (times and
    lengths, from ``traffic_seed``); the run seed draws the token ids."""
    params = {**DOCQA, "rate": 3.2}
    a = mmpp.generate(params, 50.0, 1000, np.random.default_rng(2**31 + 17))
    b = mmpp.generate(params, 50.0, 1000, np.random.default_rng(2**31 + 17))
    c = mmpp.generate(params, 50.0, 1000, np.random.default_rng(2**31 + 18))
    d = mmpp.generate({**params, "traffic_seed": params["traffic_seed"] + 1}, 50.0, 1000,
                      np.random.default_rng(2**31 + 17))
    assert _key(a) == _key(b)
    shape = [[(i.arrival_s, i.prompt.size, i.max_new_tokens) for i in x] for x in (a, c, d)]
    assert shape[0] == shape[1] and shape[0] != shape[2]
    assert [i.prompt.tobytes() for i in a] != [i.prompt.tobytes() for i in c]
    lo, hi = DOCQA["new_tokens"]
    t = np.array([i.arrival_s for i in a])
    assert t.min() >= 0 and t.max() < 50.0 and np.all(np.diff(t) >= 0)
    assert {i.prompt.size for i in a} == set(DOCQA["prompt_lens"])
    assert all(lo <= i.max_new_tokens <= hi for i in a)


def _counts(params, seconds, seeds, bins):
    """Arrivals per bin of the window, one row per traffic seed."""
    return np.array([np.histogram([i.arrival_s for i in mmpp.generate(
        {**params, "traffic_seed": s}, seconds, 1000, np.random.default_rng(0))],
        bins=bins, range=(0, seconds))[0] for s in seeds])


@pytest.mark.parametrize("rate", [0.8, 2.4, 3.2])
def test_open_loop_is_poisson_at_its_rate(rate):
    """Over many traffic seeds: arrivals at the asked rate, and counts per
    5 s whose variance is their mean, as a Poisson process's are."""
    n = _counts({**DOCQA, "rate": rate}, 50.0, range(400), 10)
    mean = n.mean()
    assert mean == pytest.approx(rate * 5.0, rel=0.05)
    assert n.var() / mean == pytest.approx(1.0, abs=0.12)
    # the committed trace itself lies within three standard deviations
    own = _counts({**DOCQA, "rate": rate}, 50.0, [DOCQA["traffic_seed"]], 1)[0, 0]
    assert abs(own - rate * 50.0) <= 3 * math.sqrt(rate * 50.0)


def test_bursts_keep_the_mean_rate():
    params = {**DOCQA, "rate": 4.0, "burst_factor": 4.0, "phase_s": 0.5}
    n = _counts(params, 50.0, range(100), 100)  # one bin per phase
    assert n.sum(axis=1).mean() == pytest.approx(200.0, rel=0.03)
    in_burst = n[:, 1::2].sum() / n.sum()
    assert in_burst == pytest.approx(0.8, abs=0.02)  # 4 / (1 + 4) of the arrivals


def test_backlog_groups_carry_the_same_work():
    params = {**CHAT, "requests": 768, "group": 32}
    for seed in (1, 2):
        items = backlog.generate(params, 50.0, 1000, np.random.default_rng(seed))
        assert len(items) == 768 and all(i.arrival_s == 0.0 for i in items)
        blocks = [items[k:k + 32] for k in range(0, 768, 32)]
        assert all(len({i.prompt.size for i in b}) == 1 for b in blocks)
        assert len({tuple(sorted(i.max_new_tokens for i in b)) for b in blocks}) == 1
        assert collections.Counter(b[0].prompt.size for b in blocks) == {128: 8, 256: 8, 512: 8}


def test_percentile_by_nearest_rank_over_every_request():
    v = list(range(1, 101))
    assert stats.percentile(v, 95) == 95 and stats.percentile(v, 90) == 90
    assert stats.percentile([3.0], 95) == 3.0 and stats.percentile([], 95) is None
    # unfinished requests count as missing every limit
    assert math.isinf(stats.percentile(v[:94] + [math.inf] * 6, 95))
    assert stats.percentile(v[:95] + [math.inf] * 5, 95) == 95


def test_spread_is_the_quartile_distance_over_the_median():
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx((4.5 - 1.5) / 3.0)
