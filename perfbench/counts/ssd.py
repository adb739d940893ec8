"""Operations and bytes of one SSD chunked scan launch (Mamba2's prefill
scan, ngroups = 1: B and C shared by every head).

Operations per (row, chunk) of Q positions, 2 FLOP per multiply-add:
C·Bᵀ once per chunk (2·Q²·N), the intra-chunk product with x over the
causal half (nh · Q² · hd, i.e. 2·(Q²/2)·hd per head), each chunk's end
state (2·Q·hd·N per head) and the inter-chunk term C·S (2·Q·N·hd per
head). The ragged tail is counted as a whole chunk, as the kernel pads
it. Bytes: x, dt, A, B and C read once, y and the float32 final state
written once. At B = 4, S = 512, nh = 80, hd = 64, N = 128 in bf16 this
gives 54.1 MB, and at nh = 50, N = 16 (Hymba) 27.6 MB and 2.11 GFLOP (the
Bound column of the kernel table in PERF.md).
"""
from __future__ import annotations


def flops(b: int, s: int, nh: int, hd: int, n: int, chunk: int) -> float:
    nc = -(-s // chunk)
    q = chunk
    per_chunk = 2.0 * q * q * n + nh * (q * q * hd + 4.0 * q * hd * n)
    return b * nc * per_chunk


def nbytes(b: int, s: int, nh: int, hd: int, n: int, itemsize: int = 2,
           initial_state: bool = False) -> float:
    x = b * s * nh * hd * itemsize
    y = x
    dt = b * s * nh * 4
    a = nh * 4
    bc = 2 * b * s * n * itemsize
    state = b * nh * hd * n * 4
    return float(x + y + dt + a + bc + state * (2 if initial_state else 1))
