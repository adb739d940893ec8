"""Plain PyTorch reference of the published Hymba-1.5B (arXiv:2411.13676;
nvidia/Hymba-1.5B-Base): every layer runs attention heads and Mamba-1 SSM
heads side by side on one normed input.

Per layer: RMSNorm; one input projection to x, z and q, and, in the first
layer of a K/V group, k and v (``kv_proj`` holds each group's K and V
columns; the other layers of the group attend over the first one's K and
V); attention with RoPE, grouped-query heads, V ``v_head_dim`` wide, a
sliding window of ``sliding_window`` keys in every layer outside
``global_attn_idx``, under which the ``num_memory_tokens`` meta tokens
stay visible to every query; the Mamba-1 branch (depthwise causal conv
with bias and SiLU over x; ``x_proj`` to dt, B and C, each RMS-normed;
dt = softplus(dt_proj(dt) + dt_bias); h_t = exp(dt_t·A)·h_{t-1} +
(dt_t·x_t)·B_t with A = -exp(A_log) per channel and state; y = h·C + D·x,
gated by SiLU(z)); the two outputs each through its own RMSNorm,
averaged, through ``out_proj``; the residual; then RMSNorm, the SwiGLU
MLP and the residual. The learned meta tokens stand at positions 0 ..
M - 1 in front of the sequence; the final RMSNorm and the tied head.

The scan runs in blocks of ``SCAN_BLOCK`` positions: inside a block its
closed form over the block's positions, across blocks the state carried
in order. Attention is taken in blocks of ``Q_BLOCK`` query rows against
the keys each block can see (its window and the meta tokens), so an 8k
sequence never holds its whole score matrix. It runs one sequence at a
time, no cache, no batching, in float32 with TF32 off, and reads only the
configuration file's published keys and the parameter tree's leaf names.

Departures from the published description, each a recalled or assumed
value of the configuration's ``assumed`` list: the branch mean's 1/2, the
K/V groups as listed, and the layout of the input projection's columns
(random weights make any fixed layout the same model).

``precision="fp8"`` is the control: every matmul in fp8 (``ops.linear``),
and the keys and values attention reads (the program's bf16 K/V cache)
rounded to fp8, one scale per token and head; the scan stays in float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.ops import fp8_round, linear, rms

Q_BLOCK = 1024  # query rows per block of attention scores
SCAN_BLOCK = 32  # positions per block of the scan's closed form


def _rope(x, pos, theta):
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = pos[:, None].float() * inv  # (T, d/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, window, sink):
    """Causal GQA over one sequence: q (T, Hq, D), k (T, Hkv, D), v (T,
    Hkv, Dv); with a window, key j is visible to query i iff i - j <
    window or j < sink."""
    t, hq, d = q.shape
    g = hq // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    out = q.new_empty((t, hq, v.shape[-1]))
    for lo in range(0, t, Q_BLOCK):
        hi = min(lo + Q_BLOCK, t)
        start = 0 if window is None else max(lo - window + 1, 0)
        keys = torch.cat([torch.arange(min(sink, start), device=q.device),
                          torch.arange(start, hi, device=q.device)])
        qpos = torch.arange(lo, hi, device=q.device)[:, None]
        mask = keys[None, :] <= qpos
        if window is not None:
            mask &= (qpos - keys[None, :] < window) | (keys[None, :] < sink)
        s = torch.einsum("qhd,khd->hqk", q[lo:hi], k[keys]) / math.sqrt(d)
        s = s.masked_fill(~mask[None], float("-inf"))
        out[lo:hi] = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v[keys])
    return out


def scan(x, dt, a, bm, cm):
    """y (T, di) of h_t = exp(dt_t a)·h_{t-1} + (dt_t x_t) B_t, y_t = h_t·C_t
    from a zero state, over x and dt (T, di), a (di, N), B and C (T, N)."""
    t = x.shape[0]
    q = SCAN_BLOCK
    pad = (-t) % q
    if pad:  # dt = 0 and x = 0: the padded steps neither decay nor add
        x, dt, bm, cm = (F.pad(u, (0, 0, 0, pad)) for u in (x, dt, bm, cm))
    causal = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
    state = torch.zeros_like(a)
    ys = []
    for lo in range(0, x.shape[0], q):
        u = dt[lo:lo + q] * x[lo:lo + q]  # (q, di)
        bb, cb = bm[lo:lo + q], cm[lo:lo + q]
        cs = torch.cumsum(dt[lo:lo + q, :, None] * a, dim=0)  # (q, di, N) log-decay from the start
        seg = (cs[:, None] - cs[None, :]).masked_fill(~causal[:, :, None, None], float("-inf"))
        w = torch.exp(seg) * (cb[:, None, None, :] * bb[None, :, None, :])  # (i, j, di, N)
        y = torch.einsum("ijcn,jc->ic", w, u)
        y = y + torch.einsum("in,icn,cn->ic", cb, torch.exp(cs), state)
        state = torch.exp(cs[-1]) * state + torch.einsum("jcn,jc,jn->cn",
                                                         torch.exp(cs[-1:] - cs), u, bb)
        ys.append(y)
    return torch.cat(ys)[:t]


def _conv(x, w, b):
    """Depthwise causal conv1d: out_t = Σ_i w_i · x_{t-K+1+i} + b, then SiLU."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = sum(pad[i: i + x.shape[0]] * w[i].float() for i in range(k))
    return F.silu(out + b.float())


def kv_owners(conf: dict) -> list:
    """Per layer, the layer whose K and V it attends over: the first of its
    ``kv_reuse_group``, or itself."""
    owner = list(range(conf["num_hidden_layers"]))
    for g in conf["kv_reuse_group"]:
        for i in g:
            owner[i] = g[0]
    return owner


def logits(conf: dict, params: dict, tokens: torch.Tensor, first: int,
           precision: str = "float32") -> torch.Tensor:
    """Float32 logits (T - first, vocab) at positions first .. T-1 of the
    sequence ``tokens`` (T,), the meta tokens in front of it."""
    eps = conf["rms_norm_eps"]
    d, hq, hkv = conf["hidden_size"], conf["num_attention_heads"], conf["num_key_value_heads"]
    hd, dv = d // hq, conf["v_head_dim"]
    di, n, r = conf["mamba_expand"] * d, conf["mamba_d_state"], conf["mamba_dt_rank"]
    m = conf["num_memory_tokens"]
    owner = kv_owners(conf)
    slots = sorted(set(owner))
    h = torch.cat([params["meta_tokens"].float(), params["embed"][tokens.long()].float()])
    t = h.shape[0]
    pos = torch.arange(t, device=tokens.device)
    kv = {}
    for i in range(conf["num_hidden_layers"]):
        lp = {k: v[i] for k, v in params["layers"].items() if not isinstance(v, dict)}
        x = rms(h, lp["ln1"], eps)
        xs, z, q = linear(x, lp["in_proj"], precision).split([di, di, hq * hd], dim=-1)
        if owner[i] == i:
            kp = linear(x, params["kv_proj"][slots.index(i)], precision)
            k, v = kp.split([hkv * hd, hkv * dv], dim=-1)
            k, v = _rope(k.view(t, hkv, hd), pos, conf["rope_theta"]), v.view(t, hkv, dv)
            if precision == "fp8":  # the cache the keys and values are read from
                k, v = fp8_round(k, -1), fp8_round(v, -1)
            kv[i] = k, v
        k, v = kv[owner[i]]
        window = None if i in conf["global_attn_idx"] else conf["sliding_window"]
        o = attention(_rope(q.view(t, hq, hd), pos, conf["rope_theta"]), k, v, window,
                      0 if window is None else m).reshape(t, hq * dv)
        xc = _conv(xs, lp["conv_w"], lp["conv_b"])
        dt, bm, cm = linear(xc, lp["x_proj"], precision).split([r, n, n], dim=-1)
        dt = linear(rms(dt, lp["dt_norm"], eps), lp["dt_proj"], precision)
        dt = F.softplus(dt + lp["dt_bias"].float())
        a = -torch.exp(lp["A_log"].float())
        y = scan(xc, dt, a, rms(bm, lp["B_norm"], eps), rms(cm, lp["C_norm"], eps))
        y = (y + xc * lp["D"].float()) * F.silu(z)
        mixed = (rms(o, lp["attn_norm"], eps) + rms(y, lp["ssm_norm"], eps)) / 2
        h = h + linear(mixed, lp["out_proj"], precision)
        f = {k: v[i] for k, v in params["layers"]["ffn"].items()}
        x = rms(h, lp["ln2"], eps)
        gate = F.silu(linear(x, f["wg"], precision)) * linear(x, f["wu"], precision)
        h = h + linear(gate, f["wd"], precision)
    x = rms(h[m + first:], params["final_norm"], eps)
    head = params["embed"].T if conf["tie_word_embeddings"] else params["head"]
    return linear(x, head, precision)
