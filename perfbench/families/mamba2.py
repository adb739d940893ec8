"""The Mamba2 family (arXiv:2405.21060): pre-norm Mamba2 blocks (SSD),
ngroups = 1.

What the benchmark knows of a family, found by its name
(``manifest.family``): how the configuration file's published keys set
the program's ``ModelConfig`` (``model_config``), and the FLOPs and least
HBM bytes of its prefill and decode steps (``counts/model.py`` says what
is counted). It imports nothing of the program: ``program.py`` hands it
the registry's ``ModelConfig`` to start from.
"""
from __future__ import annotations

import dataclasses

from perfbench.counts import ssd
from perfbench.counts.model import embed_bytes, head_flops, itemsize, leaf_bytes

# published key -> the program's ModelConfig field, and its SSM group's
KEYS = {
    "num_hidden_layers": "n_layers",
    "hidden_size": "d_model",
    "vocab_size": "vocab",
    "rms_norm_eps": "norm_eps",
    "tie_word_embeddings": "tie_embeddings",
}
SSM_KEYS = {
    "state_size": "d_state",
    "head_dim": "headdim",
    "expand": "expand",
    "chunk_size": "chunk_size",
    "conv_kernel": "d_conv",
}


def model_config(conf: dict, base):
    """``base`` (the program's registry ``ModelConfig``) with every
    published key of ``conf`` set on it."""
    if conf.get("n_groups", 1) != 1:
        raise ValueError("the program's Mamba2 shares B and C over all heads (n_groups 1)")
    ssm = dataclasses.replace(base.ssm, **{f: conf[k] for k, f in SSM_KEYS.items()})
    if ssm.n_ssm_heads(conf["hidden_size"]) != conf["num_heads"]:
        raise ValueError("num_heads disagrees with expand * hidden_size / head_dim")
    return dataclasses.replace(base, ssm=ssm, **{f: conf[k] for k, f in KEYS.items()})


def _dims(c: dict):
    d = c["hidden_size"]
    di = c["expand"] * d
    n = c["state_size"]
    hd = c["head_dim"]
    nh = di // hd
    return d, di, n, hd, nh


def _layer_matmul(c: dict) -> float:
    d, di, n, _, nh = _dims(c)
    return 2.0 * (d * (2 * di + 2 * n + nh) + di * d)


def prefill_flops(c: dict, rows: int, s: int) -> float:
    L = c["num_hidden_layers"]
    _, _, n, hd, nh = _dims(c)
    return rows * (s * L * _layer_matmul(c)
                   + L * ssd.flops(1, s, nh, hd, n, c["chunk_size"]) + head_flops(c))


def decode_flops(c: dict, rows: int, t: int) -> float:
    L = c["num_hidden_layers"]
    _, _, n, hd, nh = _dims(c)
    return rows * (L * (_layer_matmul(c) + 4.0 * nh * hd * n) + head_flops(c))


def weight_bytes(c: dict, rows: int) -> float:
    """Bytes of every weight a decode step of ``rows`` rows reads."""
    d, di, n, _, nh = _dims(c)
    conv = di + 2 * n
    layer = {"in_proj": d * (2 * di + 2 * n + nh), "conv_w": c["conv_kernel"] * conv,
             "conv_b": conv, "dt_bias": nh, "A_log": nh, "D": nh, "norm_w": di,
             "out_proj": di * d, "ln1": d}
    return (c["num_hidden_layers"] * leaf_bytes(c, layer) + leaf_bytes(c, {"final_norm": d})
            + embed_bytes(c, rows))


def decode_bytes(c: dict, rows: int, t: int) -> float:
    """The weights once; per row, whatever the position, its recurrent
    state (nh × hd × N) and its conv state (the last conv_kernel - 1
    inputs of x, B and C) of every layer, read and written."""
    _, di, n, hd, nh = _dims(c)
    state = nh * hd * n + (c["conv_kernel"] - 1) * (di + 2 * n)
    return weight_bytes(c, rows) + rows * 2 * c["num_hidden_layers"] * state * itemsize(c)
