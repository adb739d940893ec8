"""Model FLOPs of one prefill and one decode step, from the configuration
file's published keys (2 FLOP per multiply-add of every matmul, plus
attention's scores and weighted sums over the positions each token sees,
or the SSD scan's). The LM head runs on the last position of a prefill
and on every decode row, as the program's ``unembed`` does. Embedding
lookups, norms and elementwise work are not counted.

Only rows that carry a request are counted: a prefill group padded to
the batch, or a decode row whose request has finished, is work the card
does and no user asked for, so it lowers the share of the peak.
"""
from __future__ import annotations

from perfbench.counts import flash, ssd


def _dense_layer_matmul(c: dict) -> float:
    d, hd = c["hidden_size"], c["head_dim"]
    hq, hkv, ff = c["num_attention_heads"], c["num_key_value_heads"], c["intermediate_size"]
    return 2.0 * (d * hq * hd + 2 * d * hkv * hd + hq * hd * d + 3 * d * ff)


def _mamba_dims(c: dict):
    d = c["hidden_size"]
    di = c["expand"] * d
    n = c["state_size"]
    hd = c["head_dim"]
    nh = di // hd
    return d, di, n, hd, nh


def _mamba_layer_matmul(c: dict) -> float:
    d, di, n, _, nh = _mamba_dims(c)
    return 2.0 * (d * (2 * di + 2 * n + nh) + di * d)


def _head(c: dict) -> float:
    return 2.0 * c["hidden_size"] * c["vocab_size"]


def prefill_flops(c: dict, rows: int, s: int) -> float:
    """FLOPs of a prefill of ``rows`` prompts of ``s`` tokens."""
    L = c["num_hidden_layers"]
    if c["family"] == "mamba2":
        _, _, n, hd, nh = _mamba_dims(c)
        per_row = (s * L * _mamba_layer_matmul(c)
                   + L * ssd.flops(1, s, nh, hd, n, c["chunk_size"]) + _head(c))
    else:
        hq, hd = c["num_attention_heads"], c["head_dim"]
        per_row = (s * L * _dense_layer_matmul(c)
                   + L * flash.flops(1, hq, s, s, hd, hd) + _head(c))
    return rows * per_row


def decode_flops(c: dict, rows: int, t: int) -> float:
    """FLOPs of one decode step of ``rows`` rows at cache position ``t``
    (the step's token attends to t + 1 positions)."""
    L = c["num_hidden_layers"]
    if c["family"] == "mamba2":
        _, _, n, hd, nh = _mamba_dims(c)
        per_row = L * (_mamba_layer_matmul(c) + 4.0 * nh * hd * n) + _head(c)
    else:
        hq, hd = c["num_attention_heads"], c["head_dim"]
        per_row = L * (_dense_layer_matmul(c) + 2.0 * hq * 2 * hd * (t + 1)) + _head(c)
    return rows * per_row
