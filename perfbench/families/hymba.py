"""The Hymba family (arXiv:2411.13676, nvidia/Hymba-1.5B-Base): attention
heads and Mamba-1 SSM heads side by side in every layer, learned meta
tokens before every prompt, a sliding window (its sink the meta tokens)
outside the global layers, K/V caches shared by groups of consecutive
layers.

What the benchmark knows of a family, found by its name
(``manifest.family``): how the configuration file's published keys set
the program's ``ModelConfig`` (``model_config``), and the FLOPs and least
HBM bytes of its prefill and decode steps (``counts/model.py`` says what
is counted). It imports nothing of the program: ``program.py`` hands it
the registry's ``ModelConfig`` to start from.

What this family counts beside the shared rules. The meta tokens are
work: a prefill of ``s`` prompt tokens runs ``s + num_memory_tokens``
positions, and a decode step at position ``t`` (the prompt and the tokens
decoded, as the benchmark counts them) sits at ``t + num_memory_tokens``
in the cache. A layer that reuses its group's K/V projects none. A
window layer's query sees min(its position + 1, window) keys plus the
meta tokens that lie outside the window (``counts/flash_window.py``); a
global layer's, every earlier key. The tied head is read once. Each
K/V cache is counted once, whatever the number of layers that read it:
the global layers' over every position, the window groups' over the
window and the meta tokens.
"""
from __future__ import annotations

import dataclasses

from perfbench.counts import flash_window, selective_scan
from perfbench.counts.model import embed_bytes, head_flops, itemsize, leaf_bytes

# published key -> the program's ModelConfig field
KEYS = {
    "num_hidden_layers": "n_layers",
    "hidden_size": "d_model",
    "num_attention_heads": "n_heads",
    "num_key_value_heads": "n_kv_heads",
    "intermediate_size": "d_ff",
    "vocab_size": "vocab",
    "rope_theta": "rope_theta",
    "rms_norm_eps": "norm_eps",
    "tie_word_embeddings": "tie_embeddings",
    "v_head_dim": "v_head_dim",
    "sliding_window": "sliding_window",
    "num_memory_tokens": "n_meta_tokens",
    "mamba_dt_rank": "dt_rank",
}
SSM_KEYS = {"mamba_d_state": "d_state", "mamba_expand": "expand", "mamba_d_conv": "d_conv"}


def model_config(conf: dict, base):
    """``base`` (the program's registry ``ModelConfig``) with every
    published key of ``conf`` set on it."""
    if conf.get("hidden_act", "silu") != "silu":
        raise ValueError("the hymba family runs SwiGLU")
    if not (conf["mamba_inner_layernorms"] and conf["mamba_conv_bias"]):
        raise ValueError("the program's Mamba-1 heads norm dt, B and C and bias the conv")
    ssm = dataclasses.replace(base.ssm, **{f: conf[k] for k, f in SSM_KEYS.items()})
    return dataclasses.replace(
        base, ssm=ssm, head_dim=conf["hidden_size"] // conf["num_attention_heads"],
        global_layers=tuple(conf["global_attn_idx"]),
        kv_groups=tuple(tuple(g) for g in conf["kv_reuse_group"]),
        **{f: conf[k] for k, f in KEYS.items()})


def _dims(c: dict):
    d, hq, hkv = c["hidden_size"], c["num_attention_heads"], c["num_key_value_heads"]
    di, n = c["mamba_expand"] * d, c["mamba_d_state"]
    return d, hq, hkv, d // hq, c["v_head_dim"], di, n, c["mamba_dt_rank"]


def kv_owners(c: dict) -> list:
    """Per layer, the layer whose K/V it reads (the first of its group)."""
    owner = list(range(c["num_hidden_layers"]))
    for g in c["kv_reuse_group"]:
        for i in g:
            owner[i] = g[0]
    return owner


def _window(c: dict, layer: int):
    if layer in c["global_attn_idx"]:
        return None, 0
    return c["sliding_window"], c["num_memory_tokens"]


def _layer_matmul(c: dict, projects_kv: bool) -> float:
    """FLOPs of one position's matmuls in one layer."""
    d, hq, hkv, hd, dv, di, n, r = _dims(c)
    macs = (d * (2 * di + hq * hd) + di * (r + 2 * n) + r * di + di * d
            + 3 * d * c["intermediate_size"])
    if projects_kv:
        macs += d * hkv * (hd + dv)
    return 2.0 * macs


def attention_flops(c: dict, layer: int, rows: int, s: int) -> float:
    """FLOPs of layer ``layer``'s prefill attention over ``s`` positions
    (meta tokens included)."""
    _, hq, _, hd, dv, _, _, _ = _dims(c)
    window, sink = _window(c, layer)
    return flash_window.flops(rows, hq, s, hd, dv, window, sink)


def prefill_flops(c: dict, rows: int, s: int) -> float:
    _, _, _, _, _, di, n, _ = _dims(c)
    t = s + c["num_memory_tokens"]
    owner = kv_owners(c)
    per_row = sum(t * _layer_matmul(c, owner[i] == i) for i in range(len(owner)))
    per_row += len(owner) * selective_scan.flops(1, t, di, n) + head_flops(c)
    return rows * per_row + sum(attention_flops(c, i, rows, t) for i in range(len(owner)))


def _keys(c: dict, layer: int, pos: int) -> int:
    """Keys a decode token at cache position ``pos`` sees in ``layer``."""
    window, sink = _window(c, layer)
    return flash_window.visible(pos, window, sink)


def decode_flops(c: dict, rows: int, t: int) -> float:
    _, hq, _, hd, dv, di, n, _ = _dims(c)
    pos = t + c["num_memory_tokens"]
    owner = kv_owners(c)
    per_row = head_flops(c)
    for i in range(len(owner)):
        per_row += (_layer_matmul(c, owner[i] == i) + 2.0 * hq * (hd + dv) * _keys(c, i, pos)
                    + selective_scan.flops(1, 1, di, n))
    return rows * per_row


def weight_bytes(c: dict, rows: int) -> float:
    """Bytes of every weight a decode step reads (the meta tokens are read
    by prefill only)."""
    d, hq, hkv, hd, dv, di, n, r = _dims(c)
    ff, L = c["intermediate_size"], c["num_hidden_layers"]
    layer = {"ln1": d, "in_proj": d * (2 * di + hq * hd), "conv_w": c["mamba_d_conv"] * di,
             "conv_b": di, "x_proj": di * (r + 2 * n), "dt_norm": r, "B_norm": n, "C_norm": n,
             "dt_proj": r * di, "dt_bias": di, "A_log": di * n, "D": di, "attn_norm": hq * dv,
             "ssm_norm": di, "out_proj": di * d, "ln2": d, "wg": d * ff, "wu": d * ff,
             "wd": ff * d}
    kv = len(set(kv_owners(c))) * d * hkv * (hd + dv)
    return (L * leaf_bytes(c, layer) + leaf_bytes(c, {"kv_proj": kv, "final_norm": d})
            + embed_bytes(c, rows))


def decode_bytes(c: dict, rows: int, t: int) -> float:
    """The weights once; per row, each K/V cache once (the positions its
    layers see read, the new one written), and every layer's recurrent
    state (di × N) and conv state (the last mamba_d_conv - 1 inputs of x)
    read and written."""
    _, _, hkv, hd, dv, di, n, _ = _dims(c)
    pos = t + c["num_memory_tokens"]
    per_position = hkv * (hd + dv)
    kv = sum(_keys(c, i, pos) for i in sorted(set(kv_owners(c)))) * per_position
    state = di * n + (c["mamba_d_conv"] - 1) * di
    per_row = kv + 2 * c["num_hidden_layers"] * state
    return weight_bytes(c, rows) + rows * per_row * itemsize(c)
