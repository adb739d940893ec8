"""Plain PyTorch reference of the Qwen2 decoder (Qwen2.5): pre-norm RMSNorm,
grouped-query attention with biases on Q, K and V, rotate-half RoPE,
SwiGLU MLP, final RMSNorm and the LM head.

It runs one sequence at a time over its whole length (no cache, no
batching), in float32 with TF32 off, whatever dtype the weights are
served in: each layer's weights are widened to float32 as it is applied.
Attention is taken in blocks of query rows against every key, so the
score matrix of an 8k-token sequence never materialises whole. It reads
the configuration file's published key names and the parameter tree's
leaf names, and nothing else.

``precision="fp8"`` is the control, the step below the configuration's
bfloat16 wherever the program holds bfloat16: every matmul in fp8
(``ops.linear``), and the keys and values that attention reads (the
program's bf16 KV cache) rounded to fp8, one scale per token and head.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.ops import fp8_round, linear, rms

Q_BLOCK = 1024  # query rows per block of attention scores


def _rope(x, pos, theta):
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = pos[:, None].float() * inv  # (T, d/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v):
    """Causal GQA over one sequence: q (T, Hq, D), k and v (T, Hkv, D)."""
    t, hq, d = q.shape
    g = hq // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    out = torch.empty_like(q)
    kpos = torch.arange(t, device=q.device)
    for lo in range(0, t, Q_BLOCK):
        hi = min(lo + Q_BLOCK, t)
        s = torch.einsum("qhd,khd->hqk", q[lo:hi], k[:hi]) / math.sqrt(d)
        mask = kpos[None, :hi] <= torch.arange(lo, hi, device=q.device)[:, None]
        s = s.masked_fill(~mask[None], float("-inf"))
        out[lo:hi] = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v[:hi])
    return out


def logits(conf: dict, params: dict, tokens: torch.Tensor, first: int,
           precision: str = "float32") -> torch.Tensor:
    """Float32 logits (T - first, vocab) at positions first .. T-1 of the
    sequence ``tokens`` (T,)."""
    eps = conf["rms_norm_eps"]
    hq, hkv, hd = conf["num_attention_heads"], conf["num_key_value_heads"], conf["head_dim"]
    t = tokens.shape[0]
    pos = torch.arange(t, device=tokens.device)
    h = params["embed"][tokens.long()].float()
    lp = params["layers"]
    for i in range(conf["num_hidden_layers"]):
        a = lp["attn"]
        x = rms(h, lp["ln1"][i], eps)
        q = linear(x, a["wq"][i], precision)
        k = linear(x, a["wk"][i], precision)
        v = linear(x, a["wv"][i], precision)
        if conf["attention_bias"]:
            q, k, v = q + a["bq"][i].float(), k + a["bk"][i].float(), v + a["bv"][i].float()
        q = _rope(q.view(t, hq, hd), pos, conf["rope_theta"])
        k = _rope(k.view(t, hkv, hd), pos, conf["rope_theta"])
        v = v.view(t, hkv, hd)
        if precision == "fp8":  # the cache the keys and values are read from
            k, v = fp8_round(k, -1), fp8_round(v, -1)
        o = _attention(q, k, v).reshape(t, hq * hd)
        h = h + linear(o, a["wo"][i], precision)
        f = lp["ffn"]
        x = rms(h, lp["ln2"][i], eps)
        gate = F.silu(linear(x, f["wg"][i], precision)) * linear(x, f["wu"][i], precision)
        h = h + linear(gate, f["wd"][i], precision)
    x = rms(h[first:], params["final_norm"], eps)
    head = params["embed"].T if conf["tie_word_embeddings"] else params["head"]
    return linear(x, head, precision)
