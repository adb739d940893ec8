"""Operations and bytes of one flash attention launch (the prefill's
attention over the whole prompt, positions contiguous from 0).

Operations: Q·Kᵀ and P·V over the (query, key) pairs the mask keeps, 2
FLOP per multiply-add, so 2·(D + Dv) per pair and query head. A causal
launch with Sq = Sk keeps Sq·(Sq + 1)/2 pairs per row and head. Bytes:
each input (Q, K, V) read once and the output written once, in the
tensors' own dtype. At B = 4, Hq = 16, Hkv = 2, S = 512, D = Dv = 128 in
bf16 this gives 4.30 GFLOP and 18.9 MB, at B = 1, S = 4096, 68.7 GFLOP
(the Bound column of the kernel table in PERF.md).
"""
from __future__ import annotations


def pairs(sq: int, sk: int, causal: bool = True) -> int:
    """(query, key) pairs a causal (or full) mask keeps, positions from 0
    and queries at the end of the keys."""
    if not causal:
        return sq * sk
    off = sk - sq  # query i sees keys 0 .. off + i
    return sq * (off + 1) + sq * (sq - 1) // 2


def flops(b: int, hq: int, sq: int, sk: int, d: int, dv: int, causal: bool = True) -> float:
    return 2.0 * b * hq * (d + dv) * pairs(sq, sk, causal)


def nbytes(b: int, hq: int, hkv: int, sq: int, sk: int, d: int, dv: int,
           itemsize: int = 2) -> float:
    q = b * sq * hq * d
    k = b * sk * hkv * d
    v = b * sk * hkv * dv
    o = b * sq * hq * dv
    return float(itemsize * (q + k + v + o))
