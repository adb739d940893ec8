"""The program's own records of its serving loop, as the per-layer metrics
of the ``runtime`` layer read them: each served request's ``group``, the
record of the decode group that served it (``GroupTrace`` in the
program's ``serving/tracing.py``), with its prefill's dispatch and one
tuple per retire. A program whose requests carry no ``group`` gives
None, and the metrics that read it are left out of the line.

A ``--trace 1`` run starts and stops the profiler from inside a wrapped
``prefill`` or ``decode`` (``instrument.py``), so one retire or prefill
dispatch of the program holds each start and each stop: a drained
device queue and seconds of the profiler's own work, which are not the
program's. :func:`host_intervals` leaves those out."""
from __future__ import annotations

from typing import List, Optional, Tuple

# the fields of a retire's tuple, in the program's order
T_ENTER, T_READY, T_SAMPLED, T_ACCOUNTED, T_LEFT, LIVE, LIVE_NEXT = range(7)


def _groups(obs) -> list:
    found = {}
    for r in obs.requests:
        g = getattr(r, "group", None)
        if g is not None:
            found[id(g)] = g
    return list(found.values())


def retires(obs) -> Optional[List[tuple]]:
    """The retires that began inside the window, or None where there are
    none or the program keeps no records."""
    rec = [t for g in _groups(obs) for t in g.retires if obs.t0 <= t[T_ENTER] <= obs.t_end]
    return rec or None


def _tracer_marks(obs) -> List[float]:
    """The host stamps of the wrapped calls inside which the profiler was
    started or stopped: each call whose ``traced`` differs from the call's
    before it (the wrap reads its stamp right after the start or stop)."""
    marks, prev = [], None
    for rec in sorted(getattr(obs, "prefills", []) + getattr(obs, "decodes", []),
                      key=lambda r: r["t"]):
        if rec["traced"] != prev:
            marks.append(rec["t"])
        prev = rec["traced"]
    return marks


def host_intervals(obs) -> Optional[Tuple[List[float], List[float], float]]:
    """The window's host seconds outside the waits on the device: each
    retire's ``t_left - t_ready`` and each prefill dispatch's, and the
    seconds of those left out for holding a start or stop of the
    profiler; None where the program keeps no records."""
    rec = retires(obs)
    if rec is None:
        return None
    marks = _tracer_marks(obs)

    def held(a, b):
        return any(a <= m <= b for m in marks)

    ret = [(t[T_ENTER], t[T_LEFT], t[T_LEFT] - t[T_READY]) for t in rec]
    pre = [(g.t_prefill, g.t_prefilled, g.t_prefilled - g.t_prefill) for g in _groups(obs)
           if obs.t0 <= g.t_prefill <= obs.t_end]
    return ([s for a, b, s in ret if not held(a, b)], [s for a, b, s in pre if not held(a, b)],
            sum(s for a, b, s in ret + pre if held(a, b)))
