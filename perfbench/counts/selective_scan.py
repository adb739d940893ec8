"""Operations and bytes of one Mamba-1 selective scan launch (the published
Hymba's SSM heads in prefill: ``kernels/selective_scan`` of the program).

Operations: per (row, position, channel, state) dt·A, h·exp(·), (dt·x)·B,
their sum, h·C and its sum into y, 6 FLOP; the exponential is not
counted (it runs on the special-function units, at 16 a clock per SM,
which is what bounds the kernel on the card: PERF.md). Bytes: x, dt and z
read and y written, (B, S, di) each; B and C read, (B, S, N) each; A_log
(di, N), dt_bias and D (di,) in float32; the final state written, (B, di,
N). At the Hymba cell's longest prefill (B 8, S 8,064, di 3,200, N 16, bf16)
this gives 1.656 GB (0.494 ms at 3.35 TB/s) and 19.8 GFLOP.
"""
from __future__ import annotations


def flops(b: int, s: int, di: int, n: int) -> float:
    return 6.0 * b * s * di * n


def nbytes(b: int, s: int, di: int, n: int, itemsize: int = 2) -> float:
    streams = 4 * b * s * di * itemsize  # x, dt, z in; y out
    bc = 2 * b * s * n * itemsize
    params = di * n * 4 + 2 * di * 4
    state = b * di * n * itemsize
    return float(streams + bc + params + state)
