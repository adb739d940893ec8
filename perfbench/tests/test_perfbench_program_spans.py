"""The readers of the program's own records (``program_records.py``):
``retire_host_ms``, ``host_busy_share`` and ``decode_row_occupancy.program``
read in a traced CPU run of each tiny backlog cell, the program's
occupancy equals the one the benchmark's wrap counts in the same run,
each reader gives None for requests that carry no record, as a program
without them does, and the calls that held the profiler's start or stop
are left out of the host's time."""
from types import SimpleNamespace

import pytest

from perfbench import harness, manifest
from perfbench.tests.conftest import TINY

READERS = ("retire_host_ms", "host_busy_share", "decode_row_occupancy.program")
WINDOW_S = 3.0


@pytest.mark.parametrize("name", sorted(TINY))
def test_the_readers_read_a_traced_run(tiny_root, name):
    res = harness.run(f"{name}.chat-backlog", 2**31 + 7, WINDOW_S, True, root=tiny_root,
                      device="cpu")
    assert res["correct"], res["checks"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(READERS) <= set(m)
    assert m["decode_row_occupancy.program"] == m["decode_row_occupancy"]
    assert 0 < m["host_busy_share"] <= 1
    assert 0 < m["retire_host_ms"] < 1e3 * WINDOW_S


class _Request:
    """A request as a program without records serves it."""


@pytest.mark.parametrize("reader", READERS)
@pytest.mark.parametrize("group", ["absent", None])
def test_a_program_without_records_gives_none(tiny_root, reader, group):
    r = _Request()
    if group is None:
        r.group = None
    obs = harness.Obs(requests=[r, r], t0=0.0, t_end=1.0, seconds=1.0, batch=4)
    assert manifest.reader(reader, tiny_root).read(obs) is None


def test_the_profilers_start_and_stop_are_left_out(tiny_root):
    """A retire whose dispatch held the profiler's start (a wrapped decode
    whose ``traced`` changed) and a prefill that held its stop count in
    neither the host time nor the window; the rows still count."""
    g = SimpleNamespace(t_prefill=0.0, t_prefilled=1.0, retires=[
        (1.0, 2.0, 2.0, 2.0, 3.0, 4, 4),  # 1 s on the host
        (3.0, 4.0, 4.0, 4.0, 9.0, 4, 3),  # holds the start: 5 s
        (9.0, 9.5, 9.5, 9.5, 10.0, 3, 3)])  # 0.5 s
    h = SimpleNamespace(t_prefill=10.0, t_prefilled=13.0, retires=[])  # holds the stop
    obs = harness.Obs(requests=[SimpleNamespace(group=g), SimpleNamespace(group=h)],
                      t0=0.0, t_end=20.0, batch=4,
                      decodes=[{"t": 2.5, "traced": None}, {"t": 4.5, "traced": 0},
                               {"t": 9.7, "traced": 0}],
                      prefills=[{"t": 12.0, "traced": None}])
    read = {m: manifest.reader(m, tiny_root).read(obs) for m in READERS}
    assert read["retire_host_ms"] == pytest.approx(750.0)
    # 1.5 s of retires and 1 s of prefill over 20 - 5 - 3 s
    assert read["host_busy_share"] == pytest.approx(2.5 / 12.0)
    assert read["decode_row_occupancy.program"] == pytest.approx(11 / 12)
