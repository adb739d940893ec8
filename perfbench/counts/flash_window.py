"""Operations and bytes of one flash attention launch of a prefill with a
sliding window and a sink (the published Hymba's window layers: a window
of W keys, under which the first ``sink`` keys, the meta tokens, stay
visible), or of a full causal one (``window`` None), positions contiguous
from 0 and Sq = Sk = S.

Operations: Q·Kᵀ and P·V over the (query, key) pairs the mask keeps, 2
FLOP per multiply-add, so 2·(D + Dv) per pair and query head. Query i
keeps min(i + 1, W) keys of its window, and the sink keys below the
window's start, min(sink, i + 1 - W) where that is positive. Bytes: as
``counts/flash.py``, each input read once and the output written once.
At the Hymba cell's longest prefill (B 8, S 8,064 = 128 + 7,936, Hq 25,
Hkv 5, D 64, Dv 128) a window layer keeps 8,626,752 pairs a row and head
(663 GFLOP) against 743 MB, a global layer 32,518,080 (2,497 GFLOP): both
bound by operations.
"""
from __future__ import annotations

from typing import Optional

from perfbench.counts import flash


def visible(pos: int, window: Optional[int], sink: int = 0) -> int:
    """Keys a query at position ``pos`` sees: every earlier key and itself,
    or its window's and the sink's below the window."""
    if window is None:
        return pos + 1
    return min(pos + 1, window) + max(0, min(sink, pos + 1 - window))


def _tri(n: int) -> int:
    return n * (n + 1) // 2


def pairs(s: int, window: Optional[int], sink: int = 0) -> int:
    """Σ over queries 0 .. s - 1 of :func:`visible`, in closed form."""
    if window is None:
        return _tri(s)
    inside = _tri(s) if s <= window else _tri(window) + (s - window) * window
    over = max(s - window, 0)  # queries whose window has left key 0 behind
    below = _tri(over) if over <= sink else _tri(sink) + (over - sink) * sink
    return inside + below


def flops(b: int, hq: int, s: int, d: int, dv: int, window: Optional[int] = None,
          sink: int = 0) -> float:
    return 2.0 * b * hq * (d + dv) * pairs(s, window, sink)


def nbytes(b: int, hq: int, hkv: int, s: int, d: int, dv: int, itemsize: int = 2) -> float:
    return flash.nbytes(b, hq, hkv, s, s, d, dv, itemsize)
