"""Plain PyTorch reference of the Mamba2 language model (arXiv:2405.21060):
pre-norm RMSNorm, the Mamba2 block (one in-projection to z, x, B, C and
dt; depthwise causal conv1d with SiLU over x, B and C; dt through
softplus with its bias; the selective state-space recurrence with
A = -exp(A_log) and the skip D; the gated RMSNorm y·SiLU(z); the
out-projection), final RMSNorm and the LM head. ngroups = 1: B and C are
shared by every head.

The recurrence S_t = exp(dt_t·A)·S_{t-1} + dt_t·x_t ⊗ B_t, y_t = S_t·C_t
is evaluated as a scan over blocks of ``SCAN_BLOCK`` positions: inside a
block, its closed form over the block's own positions; across blocks,
the state carried in order, one block after the other. The block length
is the reference's own, not the program's chunk. It runs one sequence at
a time, in float32 with TF32 off, each layer's weights widened as the
layer is applied, and reads only the configuration file's published keys
and the parameter tree's leaf names.

``precision="fp8"`` is the control: the in- and out-projections and the
LM head round their weights and inputs to float8 e4m3 (per column and
per row) before a float32 product; the scan stays in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.ops import linear, rms

SCAN_BLOCK = 64


def scan(x, dt, a, bm, cm):
    """y (T, nh, hd) of the recurrence over x (T, nh, hd), dt (T, nh),
    a (nh,), B and C (T, N)."""
    t, nh, hd = x.shape
    q = SCAN_BLOCK
    pad = (-t) % q
    if pad:  # dt = 0 and x = 0: the padded steps neither decay nor add
        x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        bm, cm = F.pad(bm, (0, 0, 0, pad)), F.pad(cm, (0, 0, 0, pad))
    nb = x.shape[0] // q
    x, dt = x.view(nb, q, nh, hd), dt.view(nb, q, nh)
    bm, cm = bm.view(nb, q, -1), cm.view(nb, q, -1)
    cs = torch.cumsum(dt * a, dim=1)  # (nb, q, nh), log-decay from the block's start
    xdt = x * dt[..., None]
    causal = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
    seg = (cs[:, :, None, :] - cs[:, None, :, :]).masked_fill(~causal[None, :, :, None],
                                                              float("-inf"))
    w = torch.einsum("bin,bjn->bij", cm, bm)[..., None] * torch.exp(seg)  # (nb, i, j, nh)
    y = torch.einsum("bijh,bjhp->bihp", w, xdt)
    # the state each block hands on, from zero at its start
    ends = torch.einsum("bjh,bjhp,bjn->bhpn", torch.exp(cs[:, -1:, :] - cs), xdt, bm)
    state = torch.zeros_like(ends[0])
    for b in range(nb):
        y[b] += torch.einsum("in,ih,hpn->ihp", cm[b], torch.exp(cs[b]), state)
        state = state * torch.exp(cs[b, -1])[:, None, None] + ends[b]
    return y.reshape(nb * q, nh, hd)[:t]


def _conv(xbc, w, b):
    """Depthwise causal conv1d: out_t = Σ_i w_i · xbc_{t-K+1+i} + b, then SiLU."""
    k = w.shape[0]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[i: i + xbc.shape[0]] * w[i].float() for i in range(k))
    return F.silu(out + b.float())


def logits(conf: dict, params: dict, tokens: torch.Tensor, first: int,
           precision: str = "float32") -> torch.Tensor:
    """Float32 logits (T - first, vocab) at positions first .. T-1 of the
    sequence ``tokens`` (T,)."""
    eps = conf["rms_norm_eps"]
    d, n, hd = conf["hidden_size"], conf["state_size"], conf["head_dim"]
    di = conf["expand"] * d
    nh = di // hd
    t = tokens.shape[0]
    h = params["embed"][tokens.long()].float()
    lp = params["layers"]
    for i in range(conf["num_hidden_layers"]):
        p = {k: v[i] for k, v in lp["ssm"].items()}
        x = rms(h, lp["ln1"][i], eps)
        proj = linear(x, p["in_proj"], precision)
        z, xbc, dt = proj.split([di, di + 2 * n, nh], dim=-1)
        xbc = _conv(xbc, p["conv_w"], p["conv_b"])
        xs, bm, cm = xbc.split([di, n, n], dim=-1)
        dt = F.softplus(dt + p["dt_bias"].float())
        a = -torch.exp(p["A_log"].float())
        xs = xs.reshape(t, nh, hd)
        y = scan(xs, dt, a, bm, cm) + xs * p["D"].float()[None, :, None]
        y = rms(y.reshape(t, di) * F.silu(z), p["norm_w"], eps)
        h = h + linear(y, p["out_proj"], precision)
    x = rms(h[first:], params["final_norm"], eps)
    head = params["embed"].T if conf["tie_word_embeddings"] else params["head"]
    return linear(x, head, precision)
