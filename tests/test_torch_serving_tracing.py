"""The serving loop's records of itself (``serving/tracing.py``) on a tiny
CPU engine (reduced Qwen2.5-3B at one layer): the request stamps in
order, each retire's tuple in order and its rows adding up to the tokens
served, the padded rows of a short group, no profiler range opened while
no profiler runs, and, under a profiler, the retire's four steps nested
in its range. One test, marked ``gpu``, holds a graphed engine's replay
count and decode ranges on the card. No JAX."""
import numpy as np
import pytest
import torch

from repro_torch.launch.serve import build_engine
from repro_torch.serving import Request, ServingRuntime
from repro_torch.serving.tracing import RETIRE_FIELDS, GroupTrace

BATCH = 4
RETIRE_STEPS = ("serving.retire.wait", "serving.retire.sample", "serving.retire.account",
                "serving.retire.dispatch")


@pytest.fixture(scope="module")
def engine():
    return build_engine("qwen2.5-3b", BATCH, 32, reduced=True, layers=1, device="cpu")


def _serve(engine, n=10, arrivals=None, seed=0):
    """``n`` requests of prompt length 8 (the last two of length 6), 2 to 5
    tokens each, served to the end at concurrency 2; the runtime."""
    rng = np.random.default_rng(seed)
    rt = ServingRuntime(engine, batch_size=BATCH, concurrency=2)
    vocab = engine.ctx.cfg.vocab
    for i in range(n):
        s = 6 if i >= n - 2 else 8
        rt.submit(Request(i, rng.integers(0, vocab, s, dtype=np.int32), int(rng.integers(2, 6)),
                          arrival_s=None if arrivals is None else arrivals[i]))
    rt.drain()
    assert len(rt.done) == n
    return rt


def _groups(rt):
    return list({id(r.group): r.group for r in rt.done}.values())


def test_request_stamps_are_in_order(engine):
    arrivals = [0.0] * 6 + [0.02, 0.02, 0.05, 0.05]
    rt = _serve(engine, arrivals=arrivals)
    for r in rt.done:
        assert isinstance(r.group, GroupTrace)
        stamps = (rt._effective_arrival(r), r.admitted, r.started, r.first_token, r.finished)
        assert all(a <= b for a, b in zip(stamps, stamps[1:])), stamps
        assert r.admitted > 0 and r.first_token > 0


def test_retire_tuples_are_ordered_and_count_the_tokens_served(engine, monkeypatch):
    decodes = []
    decode = engine.decode
    monkeypatch.setattr(engine, "decode", lambda *a: decodes.append(1) or decode(*a))
    rt = _serve(engine)
    for g in _groups(rt):
        assert len(g.retires[0]) == len(RETIRE_FIELDS)
        assert g.t_prefill <= g.t_prefilled <= g.retires[0][0]
        for rec in g.retires:
            times = rec[:5]
            assert all(a <= b for a, b in zip(times, times[1:])), rec
        for prev, nxt in zip(g.retires, g.retires[1:]):
            assert prev[4] <= nxt[0] and prev[6] == nxt[5]  # the decode it dispatched
        served = [r for r in rt.done if r.group is g]
        assert sum(rec[5] for rec in g.retires) == sum(len(r.tokens) for r in served)
        assert g.retires[0][5] == g.rows and g.retires[-1][6] == 0
    # one decode for each retire that left rows live
    assert len(decodes) == sum(rec[6] > 0 for g in _groups(rt) for rec in g.retires)
    assert engine.replays == 0  # the CPU engine decodes eagerly


def test_a_short_group_records_its_padded_rows(engine):
    rt = _serve(engine)
    groups = sorted(_groups(rt), key=lambda g: g.gid)
    assert [g.gid for g in groups] == list(range(len(groups)))
    # 8 requests of length 8 fill two groups; the 2 of length 6 pad one
    assert [(g.rows, g.batch, g.prompt_len) for g in groups] == [(4, 4, 8), (4, 4, 8),
                                                                 (2, 4, 6)]
    assert sum(g.batch - g.rows for g in groups) == 2


def test_no_range_is_opened_without_a_profiler(engine, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    rt = _serve(engine, n=4)
    assert all(len(r.tokens) == r.max_new_tokens for r in rt.done)


def test_profiler_ranges_nest_the_retire_steps(engine):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rt = _serve(engine, n=6)
    events = [e for e in prof.events() if e.name.startswith("serving.")]
    retires = [e for e in events if e.name == "serving.retire"]
    assert len(retires) == sum(len(g.retires) for g in _groups(rt))
    assert sum(e.name == "serving.prefill" for e in events) == len(_groups(rt))
    assert sum(e.name == "serving.logits.copy" for e in events) == len(retires)
    for ret in retires:
        inside = sorted((e.time_range.start, e.name) for e in events if e.name in RETIRE_STEPS
                        and ret.time_range.start <= e.time_range.start
                        and e.time_range.end <= ret.time_range.end)
        assert [name for _, name in inside] == list(RETIRE_STEPS)


@pytest.mark.gpu
def test_a_graphed_engine_counts_its_replays_and_names_them():
    """On the card: one replay per decode a retire dispatched, and under a
    profiler the token upload and the replay named inside the retire's
    dispatch."""
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the decode step is replayed from a CUDA graph")
    card = build_engine("qwen2.5-3b", BATCH, 32, reduced=True, layers=1, device="cuda")
    rt = _serve(card)
    assert card.replays == sum(rec[6] > 0 for g in _groups(rt) for rec in g.retires) > 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rt = _serve(card, n=4)
    torch.cuda.synchronize()
    # the host's ranges (the profiler keeps a copy of each on the device's side)
    events = [e for e in prof.events() if e.name.startswith("serving.")
              and e.device_type == torch.autograd.DeviceType.CPU]
    dispatches = [e.time_range for e in events if e.name == "serving.retire.dispatch"]
    decodes = sum(rec[6] > 0 for g in _groups(rt) for rec in g.retires)
    for name in ("serving.decode.upload", "serving.decode.replay"):
        got = [e.time_range for e in events if e.name == name]
        assert len(got) == decodes
        assert all(any(d.start <= e.start and e.end <= d.end for d in dispatches) for e in got)
