"""Mixture-of-Experts FFN (the counterpart of ``repro/models/moe.py``).

Three implementations, as in the reference:
  * ``dense``              — compute all experts + a one-hot combine. Exact
                             and differentiable; the one-device path (its
                             FLOPs are E/k times the routed ones: 10.7x for
                             Moonlight-16B-A3B's 64 experts, top-6).
  * ``expert_parallel``    — tokens over the data axes, experts over
                             ``"model"``. Each model shard routes its own
                             slice of the local tokens, sorts the
                             assignments by expert (stably: the order
                             decides which tokens a full expert drops),
                             scatters them into fixed-capacity (E, cap, d)
                             buffers, then an ``all_to_all`` to the expert
                             owners, the grouped SwiGLU products, an
                             ``all_to_all`` back, the weighted combine in
                             float32, the shared experts and an
                             ``all_gather`` over ``"model"``.
  * ``expert_parallel_2d`` — serving: experts over ``"model"``, d_ff over
                             the data axes, tokens replicated; the expert
                             and shared-expert outputs reduce with a sum
                             over the data axes.

Token dropping follows the standard fixed-capacity model (capacity =
ceil(T_sub·k·cf / E), rounded up to a multiple of 8). The reference's
``shard_map`` bodies are functions on the local shards here: inputs and
weights are redistributed to the reference's in-specs and taken with
``to_local`` (a plain tensor is the global value, the same on every rank,
and is sliced locally), the collectives are functional ones over
``mesh.get_group(axis)`` (autograd ones, so the training step
differentiates through them), and outputs are wrapped back with
``DTensor.from_local`` (a plain input gets a plain global output).

Everything in the dense path is fixed-shape and reads nothing on the host
(``topk``, ``scatter_add_``, ``index_add_``), so a decode step through it
can be captured in a CUDA graph. Its combine adds each token's k weights
into a zero (T, E) row at k distinct experts, one add per slot, so its
atomics on the card are exact and the result does not depend on their
order.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.runtime import RunConfig
from repro_torch.models.layers import ParamSpec, swiglu
from repro_torch.sharding.specs import (
    Spec, all_gather, batch_split, from_local, is_dtensor, psum, to_local)

EXPERT_PARALLEL = ("expert_parallel", "expert_parallel_2d")


def moe_param_specs(cfg: ModelConfig, n_layers: int) -> dict:
    e = cfg.moe
    d = cfg.d_model
    L = (n_layers,)
    lx = ("layers",)
    specs = {
        "router": ParamSpec(L + (d, e.n_experts), lx + ("embed", None)),
        "we_gate": ParamSpec(L + (e.n_experts, d, e.d_ff_expert), lx + ("experts", "embed", "ff")),
        "we_up": ParamSpec(L + (e.n_experts, d, e.d_ff_expert), lx + ("experts", "embed", "ff")),
        "we_down": ParamSpec(L + (e.n_experts, e.d_ff_expert, d), lx + ("experts", "ff", "embed")),
    }
    if e.n_shared_experts:
        ff_sh = e.d_ff_expert * e.n_shared_experts
        specs.update(
            {
                "ws_gate": ParamSpec(L + (d, ff_sh), lx + ("embed", "ff")),
                "ws_up": ParamSpec(L + (d, ff_sh), lx + ("embed", "ff")),
                "ws_down": ParamSpec(L + (ff_sh, d), lx + ("ff", "embed")),
            }
        )
    return specs


def _route(cfg: ModelConfig, router_w: torch.Tensor, xt: torch.Tensor):
    """xt: (T, d) -> (weights (T, k), ids (T, k), probs (T, E)), in float32
    from float32 router weights; the top-k weights renormalised."""
    logits = xt.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(probs, cfg.moe.top_k, dim=-1)
    topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)
    return topw, topi, probs


def _aux_loss(cfg: ModelConfig, probs: torch.Tensor, topi: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balance loss: E · Σ_e f_e · P_e."""
    e = cfg.moe
    counts = torch.zeros(e.n_experts, dtype=torch.float32, device=probs.device)
    counts.index_add_(0, topi.reshape(-1), torch.ones(topi.numel(), device=probs.device))
    f = counts / (topi.shape[0] * e.top_k)
    return e.n_experts * torch.sum(f * probs.mean(0))


def _shared(p: dict, xt: torch.Tensor) -> torch.Tensor:
    if "ws_gate" not in p:
        return torch.zeros_like(xt)
    return swiglu(xt, p["ws_gate"], p["ws_up"], p["ws_down"])


def _experts(p: dict, xt: torch.Tensor) -> torch.Tensor:
    """Every expert on every token, in ``xt.dtype``: (T, d) -> (E, T, d).
    The reference's ``einsum("td,edf->tef")`` products, as one batched
    matrix product per weight over the expert axis (the tokens broadcast),
    so that no weight is copied into another layout."""
    cdt = xt.dtype
    g = torch.matmul(xt, p["we_gate"].to(cdt))  # (E, T, F)
    u = torch.matmul(xt, p["we_up"].to(cdt))
    return torch.bmm(F.silu(g) * u, p["we_down"].to(cdt))


def moe_ffn_dense(cfg: ModelConfig, p: dict, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compute-all-experts path. x: (B, S, d) -> (y (B, S, d), aux loss)."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    topw, topi, probs = _route(cfg, p["router"], xt)
    ye = _experts(p, xt)
    combine = torch.zeros((xt.shape[0], cfg.moe.n_experts), dtype=torch.float32, device=x.device)
    combine.scatter_add_(1, topi, topw)
    # y[t] = sum_e combine[t, e] ye[e, t], in float32, as the reference's
    # einsum("ted,te->td") over ye in float32: one (1, E) x (E, d) product per token
    y = torch.bmm(combine[:, None, :], ye.float().transpose(0, 1))[:, 0].to(x.dtype)
    y = y + _shared(p, xt)
    return y.reshape(b, s, d), _aux_loss(cfg, probs, topi)


# ---------------------------------------------------------------------------
# Expert-parallel paths
# ---------------------------------------------------------------------------


def _capacity(cfg: ModelConfig, t_sub: int, cf: float) -> int:
    e = cfg.moe
    cap = int(math.ceil(t_sub * e.top_k * cf / e.n_experts))
    return max(8, -(-cap // 8) * 8)  # round up to a multiple of 8


def _expert_counts(n_experts: int, ids: torch.Tensor) -> torch.Tensor:
    counts = torch.zeros(n_experts, dtype=torch.int64, device=ids.device)
    return counts.index_add_(0, ids.reshape(-1), torch.ones_like(ids.reshape(-1)))


def dropped_assignments(cfg: ModelConfig, topi: torch.Tensor, cf: float) -> int:
    """How many of one shard's (T_sub, k) expert assignments ``topi`` fall
    past the fixed capacity at capacity factor ``cf`` (and are dropped)."""
    cap = _capacity(cfg, topi.shape[0], cf)
    return int(torch.clamp_min(_expert_counts(cfg.moe.n_experts, topi) - cap, 0).sum())


def _pmean(mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    return psum(mesh, x, axis) / mesh.size(mesh.mesh_dim_names.index(axis))


def _all_to_all(mesh, x: torch.Tensor) -> torch.Tensor:
    """Equal chunks of ``x``'s leading axis to each ``"model"`` rank; the
    received chunks stacked along it in rank order (waited on outside
    autograd; under it, the first use waits)."""
    from torch.distributed import _functional_collectives as fc

    out = fc.all_to_all_single_autograd(x.contiguous(), None, None, mesh.get_group("model"))
    return out if out.requires_grad else fc.wait_tensor(out)


def _dispatch(cfg: ModelConfig, rcfg: RunConfig, mesh, router_w, xs: torch.Tensor):
    """Route the shard's tokens ``xs`` (T_sub, d) and scatter them into
    fixed-capacity (E, cap, d) buffers sent to the expert owners. Returns
    (recv (E_loc, n_model·cap, d), the combine's indices, probs, topi)."""
    e = cfg.moe
    t_sub, d = xs.shape
    topw, topi, probs = _route(cfg, router_w, xs)
    tk = t_sub * e.top_k
    eid = topi.reshape(tk)
    tokid = torch.arange(t_sub, device=xs.device).repeat_interleave(e.top_k)
    w_assign = topw.reshape(tk)
    cap = _capacity(cfg, t_sub, rcfg.capacity_factor)
    order = torch.argsort(eid, stable=True)
    eid_s, tok_s, w_s = eid[order], tokid[order], w_assign[order]
    counts = _expert_counts(e.n_experts, eid)
    start = torch.cumsum(counts, 0) - counts
    pos = torch.arange(tk, device=xs.device) - start[eid_s]
    pos = torch.where(pos < cap, pos, cap)  # cap: past the buffer, dropped
    buf = torch.zeros((e.n_experts, cap + 1, d), dtype=xs.dtype, device=xs.device)
    buf = buf.index_put((eid_s, pos), xs[tok_s])[:, :cap]  # slot cap takes the drops
    n_model = mesh.size(mesh.mesh_dim_names.index("model"))
    recv = _all_to_all(mesh, buf)  # (n_model·E_loc, cap, d), by source rank
    e_loc = e.n_experts // n_model
    recv = recv.reshape(n_model, e_loc, cap, d).transpose(0, 1).reshape(e_loc, n_model * cap, d)
    return recv, (eid_s, tok_s, w_s, pos, cap), probs, topi


def _combine(mesh, yexp: torch.Tensor, index, t_sub: int) -> torch.Tensor:
    """Send each expert's outputs back to the token's shard and add them,
    weighted, into the shard's (T_sub, d) rows in float32."""
    eid_s, tok_s, w_s, pos, cap = index
    e_loc, ncap, d = yexp.shape
    n_model = ncap // cap
    out = yexp.reshape(e_loc, n_model, cap, d).transpose(0, 1)
    back = _all_to_all(mesh, out).reshape(n_model * e_loc, cap, d)  # (E, cap, d)
    y_tok = back[eid_s, torch.clamp_max(pos, cap - 1)]
    y_tok = torch.where((pos < cap)[:, None], y_tok, torch.zeros((), dtype=y_tok.dtype,
                                                                 device=y_tok.device))
    contrib = y_tok * w_s[:, None].to(y_tok.dtype)
    ysub = torch.zeros((t_sub, d), dtype=torch.float32, device=yexp.device)
    return ysub.index_add(0, tok_s, contrib.float())


def _model_slice(mesh, xt: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """This ``"model"`` rank's slice of the local tokens (padded with zero
    rows to a multiple of the axis size), and the padded count."""
    n_model = mesh.size(mesh.mesh_dim_names.index("model"))
    t = xt.shape[0]
    t_pad = -(-t // n_model) * n_model
    xt_p = torch.nn.functional.pad(xt, (0, 0, 0, t_pad - t))
    t_sub = t_pad // n_model
    midx = mesh.get_local_rank("model")
    return xt_p[midx * t_sub:(midx + 1) * t_sub], t_pad


def _experts_local(recv: torch.Tensor, wg, wu, wd) -> torch.Tensor:
    cdt = recv.dtype
    g = torch.bmm(recv, wg.to(cdt))
    u = torch.bmm(recv, wu.to(cdt))
    return torch.bmm(F.silu(g) * u, wd.to(cdt))


def _shared_keys(p: dict) -> list:
    return [k for k in ("ws_gate", "ws_up", "ws_down") if k in p]


def moe_ffn_ep(cfg: ModelConfig, rcfg: RunConfig, mesh, p: dict, x: torch.Tensor):
    """Expert-parallel MoE FFN over ``mesh``. x: (B, S, d) global (a
    DTensor, or a plain tensor held whole by every rank)."""
    names = mesh.mesh_dim_names
    data = tuple(a for a in names if a != "model")
    n_data = math.prod(mesh.size(names.index(a)) for a in data)
    b, s, d = x.shape
    x_spec = Spec(data if (b % max(n_data, 1) == 0 and n_data > 1) else None, None, None)
    xl = to_local(mesh, x, x_spec)
    router = to_local(mesh, p["router"], Spec(None, None))
    wg, wu, wd = (to_local(mesh, p[k], Spec("model", None, None))
                  for k in ("we_gate", "we_up", "we_down"))
    shared = {k: to_local(mesh, p[k], Spec(None, None)) for k in _shared_keys(p)}

    bl, sl, _ = xl.shape
    t = bl * sl
    xs, _ = _model_slice(mesh, xl.reshape(t, d))
    recv, index, probs, topi = _dispatch(cfg, rcfg, mesh, router, xs)
    ysub = _combine(mesh, _experts_local(recv, wg, wu, wd), index, xs.shape[0])
    ysub = ysub.to(xs.dtype) + _shared(shared, xs)
    yl = all_gather(mesh, ysub, "model")[:t].reshape(bl, sl, d)
    aux = _aux_loss(cfg, probs, topi)
    for ax in ("model",) + data:
        aux = _pmean(mesh, aux, ax)
    return from_local(mesh, yl, x_spec, x), from_local(mesh, aux, Spec(), x)


def moe_ffn_ep2d(cfg: ModelConfig, rcfg: RunConfig, mesh, p: dict, x: torch.Tensor):
    """2-D expert sharding for serving: experts over ``"model"``, d_ff over
    the data axes, tokens replicated (few at decode). Each data shard
    computes a d_ff slice of every local expert, and the partial
    down-projections reduce with a sum over the data axes instead of
    gathering the weights."""
    data = tuple(a for a in mesh.mesh_dim_names if a != "model")
    da = data[0] if len(data) == 1 else data
    b, s, d = x.shape
    x_spec = Spec(None, None, None)
    xl = to_local(mesh, x, x_spec)
    router = to_local(mesh, p["router"], Spec(None, None))
    wg = to_local(mesh, p["we_gate"], Spec("model", None, da))
    wu = to_local(mesh, p["we_up"], Spec("model", None, da))
    wd = to_local(mesh, p["we_down"], Spec("model", da, None))
    shared_specs = {"ws_gate": Spec(None, da), "ws_up": Spec(None, da), "ws_down": Spec(da, None)}
    shared = {k: to_local(mesh, p[k], shared_specs[k]) for k in _shared_keys(p)}

    t = b * s
    xs, _ = _model_slice(mesh, xl.reshape(t, d))
    recv, index, probs, topi = _dispatch(cfg, rcfg, mesh, router, xs)
    yexp = _experts_local(recv, wg, wu, wd)
    for ax in data:  # partial over the d_ff slice
        yexp = psum(mesh, yexp, ax)
    ysub = _combine(mesh, yexp, index, xs.shape[0]).to(xs.dtype)
    if shared:  # shared experts: the same d_ff slice, then the sum
        ys = swiglu(xs, shared["ws_gate"], shared["ws_up"], shared["ws_down"])
        for ax in data:
            ys = psum(mesh, ys, ax)
        ysub = ysub + ys
    yl = all_gather(mesh, ysub, "model")[:t].reshape(b, s, d)
    aux = _pmean(mesh, _aux_loss(cfg, probs, topi), "model")
    return from_local(mesh, yl, x_spec, x), from_local(mesh, aux, Spec(), x)


def moe_ffn(cfg: ModelConfig, rcfg: RunConfig, mesh, p: dict, x: torch.Tensor):
    """The MoE FFN that ``rcfg.moe_impl`` names. ``"auto"`` is
    expert-parallel where ``mesh``'s ``"model"`` axis has more than one
    device and divides the experts, else dense (always without a mesh)."""
    impl = rcfg.moe_impl
    if impl not in ("auto", "dense") + EXPERT_PARALLEL:
        raise ValueError(f"unknown moe_impl {impl!r}")
    if impl == "auto":
        n_model = 1
        if mesh is not None and "model" in mesh.mesh_dim_names:
            n_model = mesh.size(mesh.mesh_dim_names.index("model"))
        impl = "expert_parallel" if n_model > 1 and cfg.moe.n_experts % n_model == 0 else "dense"
    if impl in EXPERT_PARALLEL and mesh is None:
        raise ValueError(f"moe_impl={impl!r} shards experts over a mesh's 'model' axis: "
                         "it needs a mesh (ApplyCtx.mesh)")
    if impl == "expert_parallel_2d":
        return moe_ffn_ep2d(cfg, rcfg, mesh, p, x)
    if impl == "expert_parallel":
        return moe_ffn_ep(cfg, rcfg, mesh, p, x)
    if is_dtensor(x):
        return _dense_sharded(cfg, mesh, p, x)
    return moe_ffn_dense(cfg, p, x)


def _dense_sharded(cfg: ModelConfig, mesh, p: dict, x):
    """``moe_ffn_dense`` under a mesh (no ``"model"`` split of the
    experts): every rank holds all the experts and computes them on its
    data shard of the tokens; the aux loss is averaged over the data axes."""
    bs = batch_split(mesh, x.shape[0])
    xl = to_local(mesh, x, Spec(bs, None, None))
    pl = {k: to_local(mesh, v, Spec(*([None] * v.ndim))) for k, v in p.items()}
    y, aux = moe_ffn_dense(cfg, pl, xl)
    for ax in (bs or ()):
        aux = _pmean(mesh, aux, ax)
    return from_local(mesh, y, Spec(bs, None, None), x), from_local(mesh, aux, Spec(), x)
