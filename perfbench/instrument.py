"""What the benchmark attaches to the program to time it from outside.

Every run gives each request a :class:`TimedTokens` list: the runtime's
retire appends each served token right after it reads the clock, and the
list stamps each append with ``time.monotonic()``.

A ``--trace 1`` run also wraps three methods, each on the instance and
nowhere else: the engine's ``prefill`` and ``decode`` (host time,
CUDA events on the device timeline before and after, a
``record_function`` span, the call's shape and, for a decode, the rows
still serving a request and the cache position) and the ring's
``_start_group`` and ``_retire`` (the group's real rows and prompt
length; a retire's span). It starts and stops the profiler's trace from
inside those wraps (``trace.Trace``), at the first call ``trace_after_s``
into the window (of ``prefill`` only, where the cell asks the trace to
hold a prefill), for ``trace_s`` seconds.
"""
from __future__ import annotations

import time
from typing import List, Optional


class TimedTokens(list):
    """A request's token list that records when each token was appended."""

    def __init__(self):
        super().__init__()
        self.times: List[float] = []

    def append(self, tok) -> None:
        self.times.append(time.monotonic())
        super().append(tok)


class Instrument:
    def __init__(self, torch, engine, ring, tracer=None, trace_after_s: float = 0.0,
                 trace_s: float = 0.0, trace_on_prefill: bool = False):
        self.torch = torch
        self.on_card = engine.device.type == "cuda"
        self.engine, self.ring = engine, ring
        self.tracer = tracer
        self.trace_after_s, self.trace_s = trace_after_s, trace_s
        self.trace_on_prefill = trace_on_prefill
        self.t0: Optional[float] = None  # the window's start, set by the harness
        self.prefills: List[dict] = []
        self.decodes: List[dict] = []
        self.retires: List[dict] = []
        self._pos = {}  # pool entry -> its cache position
        self._group = None  # (rows, prompt length) of the group being started
        self._slot = None  # the slot being retired
        self._orig = {}
        for obj, name, wrap in ((engine, "prefill", self._prefill),
                                (engine, "decode", self._decode),
                                (ring, "_start_group", self._start_group),
                                (ring, "_retire", self._retire)):
            self._orig[name] = getattr(obj, name)
            setattr(obj, name, wrap)

    def remove(self) -> None:
        for obj, name in ((self.engine, "prefill"), (self.engine, "decode"),
                          (self.ring, "_start_group"), (self.ring, "_retire")):
            delattr(obj, name)

    # ----------------------------------------------------------- trace window
    def _tick(self, prefill: bool) -> None:
        tr = self.tracer
        if tr is None or self.t0 is None:
            return
        now = time.monotonic()
        if tr.prof is None:
            if now - self.t0 >= self.trace_after_s and (prefill or not self.trace_on_prefill):
                tr.start()
        elif tr.running and now - tr.t_start >= self.trace_s:
            tr.stop()

    def _events(self):
        if not self.on_card:
            return None, None
        a = self.torch.cuda.Event(enable_timing=True)
        b = self.torch.cuda.Event(enable_timing=True)
        return a, b

    def _tracing(self):
        """The number of the trace span running (spans dropped before it),
        or None."""
        tr = self.tracer
        return tr.lost if tr is not None and tr.running else None

    # ------------------------------------------------------------------ wraps
    def _start_group(self, slot, group):
        s = int(group[0].prompt.size)
        self._group = (len(group), s)
        self._orig["_start_group"](slot, group)
        self._pos[slot.entry] = s

    def _prefill(self, tokens, extras=None, entry=None):
        self._tick(prefill=True)
        rows, s = self._group if self._group is not None else (tokens.shape[0], tokens.shape[1])
        self._group = None
        a, b = self._events()
        t = time.monotonic()
        with self.torch.profiler.record_function("perfbench.prefill"):
            if a is not None:
                a.record()
            out = self._orig["prefill"](tokens, extras, entry)
            if b is not None:
                b.record()
        self.prefills.append({"t": t, "host_s": time.monotonic() - t, "rows": rows, "s": s,
                              "batch": int(tokens.shape[0]), "events": (a, b),
                              "traced": self._tracing()})
        return out

    def _decode(self, cache, tokens):
        self._tick(prefill=False)
        k = cache.get("entry")
        pos = self._pos.get(k, 0)
        live = sum(self._slot.live) if self._slot is not None else int(tokens.shape[0])
        a, b = self._events()
        t = time.monotonic()
        with self.torch.profiler.record_function("perfbench.decode"):
            if a is not None:
                a.record()
            out = self._orig["decode"](cache, tokens)
            if b is not None:
                b.record()
        self._pos[k] = pos + 1
        self.decodes.append({"t": t, "pos": pos, "rows": live, "batch": int(tokens.shape[0]),
                             "events": (a, b), "traced": self._tracing()})
        return out

    def _retire(self, slot):
        self._slot = slot
        live = sum(slot.live)
        t = time.monotonic()
        with self.torch.profiler.record_function("perfbench.retire"):
            self._orig["_retire"](slot)
        self._slot = None
        self.retires.append({"t": t, "rows": live})

    # ---------------------------------------------------------- after the window
    def device_seconds(self) -> None:
        """Each wrapped call's device seconds from its CUDA events (the
        device has finished by now), as ``device_s``."""
        for rec in self.prefills + self.decodes:
            a, b = rec.pop("events")
            rec["device_s"] = a.elapsed_time(b) / 1e3 if a is not None else None
