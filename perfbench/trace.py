"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over a part
of the window, read once the window has closed.

The profiler is started and stopped from the benchmark's own wraps
(``instrument.py``), each time behind a ``torch.cuda.synchronize()``, so
the traced span holds exactly the device work enqueued inside it. Spin
kernels mark its two ends on the device's own clock: a few lead it (the
profiler has been seen to drop a profile's first records) and one
closes it. They are left out of every sum.

What is read, from the profiler's raw (kineto) events:

- ``window_s``: from the end of the last lead spin to the start of the
  closing one, on the device's clock, which the device intervals share
  (the host's clock and the device's drift apart by some tenths of a
  percent over seconds);
- ``busy_s``: the union of the device's kernel, copy and set intervals
  inside that window;
- ``kernels``: per kernel name, launches and device seconds;
- ``spans``: the benchmark's host spans (``perfbench.prefill`` and the
  like) in order, each with the device work launched inside it, found
  through the profiler's link from each device record to the host
  operation that launched it, or, for a record without one, from the
  record before it on the stream;
- ``device_ops``: the ten names that took the most device time;
- ``idle_gaps``: the ten longest gaps between device intervals, each
  named by the benchmark's host span it fell in, or ``host: serving
  loop`` outside them.
"""
from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional, Tuple

LEAD_SPINS = 10
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    """One profiled span of the window. A span whose device records the
    profiler lost (no closing mark, or no record between the marks) is
    dropped when it stops, and the next wrapped call starts another, up to
    ``ATTEMPTS`` spans. (A span may also miss the records of a single
    graph replay among dozens, which then reads as idle time: PERF.md.)"""

    ATTEMPTS = 5

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.t_start: Optional[float] = None
        self.t_stop: Optional[float] = None
        self.result: Optional[dict] = None
        self.lost = 0  # spans dropped

    @staticmethod
    def warm(torch) -> None:
        """Start and stop the profiler once (set-up), so that its first
        start inside the window does not pay for initialising it."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()

    @property
    def running(self) -> bool:
        return self.prof is not None and self.t_stop is None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        for _ in range(LEAD_SPINS):
            self.torch.cuda._sleep(1000)
        self.t_start = time.monotonic()

    def stop(self) -> None:
        self.torch.cuda._sleep(1000)  # the closing mark
        self.torch.cuda.synchronize()
        self.t_stop = time.monotonic()
        self.prof.stop()
        events = list(self.prof.profiler.kineto_results.events())
        self.result = summarize(events, self.t_stop - self.t_start)
        if not _sound(events) and self.lost + 1 < self.ATTEMPTS:
            self.lost += 1
            self.prof = self.result = self.t_start = self.t_stop = None

    def summary(self) -> Optional[dict]:
        if self.result is None:
            return None
        return dict(self.result, spans_lost=self.lost)


def _is_device(e) -> bool:
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() in DEVICE_ACTIVITIES
    return str(e.device_type()).endswith("CUDA") and not e.is_user_annotation()


def _is_spin(name: str) -> bool:
    return "spin_kernel" in name or "sleep" in name


def _sound(events) -> bool:
    """The span kept a lead mark, its closing mark after every other device
    record, and at least one such record."""
    spins, last_end, n = [], 0, 0
    for e in events:
        if _is_device(e):
            if _is_spin(e.name()):
                spins.append(e.start_ns())
            else:
                n += 1
                last_end = max(last_end, e.start_ns() + e.duration_ns())
    return len(spins) >= 2 and n > 0 and max(spins) >= last_end


def summarize(events, host_window_s: float) -> dict:
    events = list(events)
    dev: List[Tuple[int, int, str, int]] = []
    spins: List[Tuple[int, int]] = []
    host: List[Tuple[int, int, str]] = []
    launched_at: Dict[int, int] = {}  # host operation's correlation id -> its start
    for e in events:
        name = e.name()
        if _is_device(e):
            a, b = e.start_ns(), e.start_ns() + e.duration_ns()
            if _is_spin(name):
                spins.append((a, b))
            else:
                dev.append((a, b, name, e.linked_correlation_id()))
        elif str(e.device_type()).endswith("CPU"):  # not the device's copy of an annotation
            launched_at[e.correlation_id()] = e.start_ns()
            if name.startswith("perfbench."):
                host.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
    spins.sort()
    if len(spins) >= 2:  # device clock: after the lead marks, before the closing one
        lo, hi = max(b for a, b in spins[:-1]), spins[-1][0]
        window_s = (hi - lo) / 1e9
        dev = [(max(a, lo), min(b, hi), n, c) for a, b, n, c in dev if b > lo and a < hi]
    else:
        window_s = host_window_s
    host.sort()
    starts = [h[0] for h in host]
    spans = [{"name": n, "kernels": {}} for _, _, n in host]
    # each device record's span: through the profiler's link to the host
    # operation that launched it; a record with no link (a kernel launched
    # by a library call outside any aten operation, as the hand-written
    # kernels are) takes the span of the record before it on the stream,
    # which runs its work in order
    dev.sort()
    kernels: Dict[str, List[float]] = {}
    span = None
    for a, b, name, corr in dev:
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (b - a) / 1e9
        linked = _span_of(host, starts, launched_at.get(corr)) if corr else None
        span = linked if linked is not None else span
        if span is not None:
            k = spans[span]["kernels"].setdefault(name, [0, 0.0])
            k[0] += 1
            k[1] += (b - a) / 1e9
    dev.sort()
    busy_ns = 0
    gaps: List[Tuple[int, int]] = []
    cur_a = cur_b = None
    for a, b, _, _ in dev:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy_ns += cur_b - cur_a
                gaps.append((cur_b, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        busy_ns += cur_b - cur_a
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    idle = [[_host_at(host, (a + b) // 2), (b - a) / 1e9] for a, b in longest]
    ops = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return {
        "busy_s": busy_ns / 1e9,
        "window_s": window_s,
        "host_window_s": host_window_s,
        "kernels": {n: {"count": c, "seconds": t} for n, (c, t) in kernels.items()},
        "spans": spans,
        "device_ops": [[n, t] for n, (_, t) in ops],
        "idle_gaps": idle,
    }


def _span_of(host, starts, t) -> Optional[int]:
    """Index of the benchmark span that holds host time ``t``."""
    if t is None:
        return None
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:  # the latest span that began before t and still ran: the innermost
        if host[i][1] >= t:
            return i
        i -= 1
    return None


def _host_at(host, t) -> str:
    """The innermost benchmark span covering host time ``t``."""
    best = None
    for a, b, name in host:
        if a > t:
            break
        if b >= t and (best is None or a >= best[0]):
            best = (a, name)
    return best[1] if best else "host: serving loop"


def roofline_share(obs, pattern, bound_of) -> Optional[float]:
    """A kernel's share of its roofline over the traced span, in percent:
    the sum of its launches' bounds over the sum of their device times.
    The launches are those of the prefills dispatched while the trace ran
    (each finished inside it), one per layer, found in each prefill's
    span of the trace; ``bound_of(prefill)`` gives one launch's (FLOPs,
    bytes). A launch may be several kernels (the SSD scan's three): the
    kernel names of the pattern found in the span are counted. Where the
    profiler kept other than one record per layer of each such kernel
    of a prefill, the share is not read (None), as :class:`Trace` drops a
    span that lost records."""
    from perfbench.counts import peaks

    if obs.trace is None:
        return None
    calls = [p for p in obs.prefills if p["traced"] == obs.trace["spans_lost"]]
    spans = [sp for sp in obs.trace["spans"] if sp["name"] == "perfbench.prefill"]
    if not calls or len(spans) != len(calls):
        return None
    layers = obs.conf["num_hidden_layers"]
    bound = seconds = 0.0
    for p, sp in zip(calls, spans):
        found = {n: k for n, k in sp["kernels"].items() if pattern.search(n)}
        if not found or any(k[0] != layers for k in found.values()):
            return None
        seconds += sum(k[1] for k in found.values())
        bound += layers * peaks.bound_s(*bound_of(p))
    return 100.0 * bound / seconds
