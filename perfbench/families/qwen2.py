"""The Qwen2 family (Qwen2.5): dense pre-norm decoder, grouped-query
attention with biases on Q, K and V, SwiGLU MLP.

What the benchmark knows of a family, found by its name
(``manifest.family``): how the configuration file's published keys set
the program's ``ModelConfig`` (``model_config``), and the FLOPs and least
HBM bytes of its prefill and decode steps (``counts/model.py`` says what
is counted). It imports nothing of the program: ``program.py`` hands it
the registry's ``ModelConfig`` to start from.
"""
from __future__ import annotations

import dataclasses

from perfbench.counts import flash
from perfbench.counts.model import embed_bytes, head_flops, itemsize, leaf_bytes

# published key -> the program's ModelConfig field
KEYS = {
    "num_hidden_layers": "n_layers",
    "hidden_size": "d_model",
    "num_attention_heads": "n_heads",
    "num_key_value_heads": "n_kv_heads",
    "head_dim": "head_dim",
    "intermediate_size": "d_ff",
    "vocab_size": "vocab",
    "rope_theta": "rope_theta",
    "rms_norm_eps": "norm_eps",
    "tie_word_embeddings": "tie_embeddings",
    "attention_bias": "qkv_bias",
}


def model_config(conf: dict, base):
    """``base`` (the program's registry ``ModelConfig``) with every
    published key of ``conf`` set on it."""
    if conf.get("hidden_act", "silu") != "silu":
        raise ValueError("the qwen2 family runs SwiGLU")
    return dataclasses.replace(base, **{f: conf[k] for k, f in KEYS.items()})


def _layer_matmul(c: dict) -> float:
    d, hd = c["hidden_size"], c["head_dim"]
    hq, hkv, ff = c["num_attention_heads"], c["num_key_value_heads"], c["intermediate_size"]
    return 2.0 * (d * hq * hd + 2 * d * hkv * hd + hq * hd * d + 3 * d * ff)


def prefill_flops(c: dict, rows: int, s: int) -> float:
    L, hq, hd = c["num_hidden_layers"], c["num_attention_heads"], c["head_dim"]
    return rows * (s * L * _layer_matmul(c) + L * flash.flops(1, hq, s, s, hd, hd) + head_flops(c))


def decode_flops(c: dict, rows: int, t: int) -> float:
    L, hq, hd = c["num_hidden_layers"], c["num_attention_heads"], c["head_dim"]
    return rows * (L * (_layer_matmul(c) + 2.0 * hq * 2 * hd * (t + 1)) + head_flops(c))


def weight_bytes(c: dict, rows: int) -> float:
    """Bytes of every weight a decode step of ``rows`` rows reads."""
    d, hd, L = c["hidden_size"], c["head_dim"], c["num_hidden_layers"]
    q, kv, ff = c["num_attention_heads"] * hd, c["num_key_value_heads"] * hd, c["intermediate_size"]
    layer = {"wq": d * q, "wk": d * kv, "wv": d * kv, "wo": q * d,
             "wg": d * ff, "wu": d * ff, "wd": ff * d, "ln1": d, "ln2": d}
    if c["attention_bias"]:
        layer.update(bq=q, bk=kv, bv=kv)
    return L * leaf_bytes(c, layer) + leaf_bytes(c, {"final_norm": d}) + embed_bytes(c, rows)


def decode_bytes(c: dict, rows: int, t: int) -> float:
    """The weights once; per row, the t cached positions of every layer's
    K and V read and the new one written (its K and V need not make a
    round trip through HBM before attention reads them)."""
    per_position = c["num_hidden_layers"] * 2 * c["num_key_value_heads"] * c["head_dim"]
    return weight_bytes(c, rows) + rows * (t + 1) * per_position * itemsize(c)
