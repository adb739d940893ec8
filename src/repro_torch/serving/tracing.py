"""What the serving loop records of itself.

Always on, and nearly free (a few ``time.monotonic()`` reads and one
tuple append per retire):

- ``Request.admitted``, ``started``, ``first_token`` and ``finished``,
  and ``Request.group``, the :class:`GroupTrace` of the group that
  served it;
- one :class:`GroupTrace` per group a ring starts: its pool entry, real
  and padded rows, prompt length, the positions its prefill put before
  each prompt (``prefix_tokens``: the published Hymba's meta tokens), the
  host interval of its prefill's dispatch, and one tuple per retire
  (:data:`RETIRE_FIELDS`);
- ``ServingEngine.replays``, the CUDA graph replays the engine made.

Every stamp is ``time.monotonic()``, the clock of the runtime's
``_t0``. A record lives as long as the requests that hold it:
``{id(r.group): r.group for r in runtime.done}`` gives the groups of
the finished requests.

Only while a profiler runs (:func:`trace_range`), ``torch.profiler``
ranges name the loop's host work on the profiler's clock, which it
shares with the device's records, and link each kernel to the range
that launched it: ``serving.prefill``; ``serving.retire`` and, inside it,
``serving.retire.wait`` (on the slot's logits), ``.sample`` (the host
argmax), ``.account`` (the per-row bookkeeping) and ``.dispatch`` (the
next decode, or the release of the pool entry); ``serving.decode.upload``
and ``serving.decode.replay`` (a graphed decode); ``serving.logits.copy``
(the last position's logits started on their way to the host);
``serving.idle`` (``run_for``'s sleep while nothing could progress); and
in the published Hymba's prefill, per layer, ``model.hybrid.attn`` and
``model.hybrid.ssm`` around its two branches (``models/hymba.py``).
"""
from __future__ import annotations

from typing import List, Tuple

import torch
from torch.autograd import profiler as _profiler

# one tuple of GroupTrace.retires per retire of the group:
#   t_enter      the retire begins
#   t_ready      the slot's logits are on the host (after the wait)
#   t_sampled    the host argmax is done: the stamp of the tokens served
#   t_accounted  the per-row bookkeeping is done
#   t_left       the next decode and its logits' copy are dispatched, or
#                the pool entry released
#   live         rows served a token at this retire
#   live_next    rows live in the decode it dispatched (0: none)
RETIRE_FIELDS = ("t_enter", "t_ready", "t_sampled", "t_accounted", "t_left", "live",
                 "live_next")

class _Off:
    """The context :func:`trace_range` gives while no profiler runs."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


_OFF = _Off()


def trace_range(name: str):
    """A ``torch.profiler`` range named ``name`` while a profiler runs, and
    otherwise a shared context that does nothing: a range costs
    microseconds even with no profiler to record it, the check tens of
    nanoseconds."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


class GroupTrace:
    """One decode group's record: where it ran, its shape, its prefill's
    dispatch and its retires. ``batch - rows`` prefill rows were padding;
    the retires with ``live_next > 0`` each dispatched one decode."""

    __slots__ = ("gid", "entry", "rows", "batch", "prompt_len", "prefix_tokens", "t_prefill",
                 "t_prefilled", "retires")

    def __init__(self, gid: int, entry, rows: int, batch: int, prompt_len: int,
                 t_prefill: float, t_prefilled: float, prefix_tokens: int = 0):
        self.gid = gid  # the ring's sequence number of the group
        self.entry = entry  # the engine's pool entry
        self.rows = rows
        self.batch = batch
        self.prompt_len = prompt_len
        self.prefix_tokens = prefix_tokens  # positions prefilled before each prompt
        self.t_prefill = t_prefill  # dispatch begins: pad, acquire, prefill,
        self.t_prefilled = t_prefilled  # and the logits' copy started
        self.retires: List[Tuple[float, float, float, float, float, int, int]] = []
