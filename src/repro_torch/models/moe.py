"""Mixture-of-Experts FFN (the counterpart of ``repro/models/moe.py``).

One implementation, the reference's one-device path ``moe_ffn_dense``:
every expert computes every token, and a one-hot combine weights each
token's top-k experts. Its FLOPs are E/k times the routed ones (10.7x for
Moonlight-16B-A3B's 64 experts, top-6), and a decode step reads every
expert's weights. The reference's ``moe_impl="auto"`` picks this path
whenever there is no mesh, so on one card the port computes the same
function and adds no grouped dispatch the reference lacks there. The
expert-parallel paths (``shard_map`` + ``all_to_all``, ``moe.py:117-307``)
exist only across devices: they raise, naming ROADMAP queue 1 item 16.

Everything here is fixed-shape and reads nothing on the host (``topk``,
``scatter_add_``, ``index_add_``), so a decode step through it can be
captured in a CUDA graph. The combine adds each token's k weights into a
zero (T, E) row at k distinct experts, one add per slot, so its atomics
on the card are exact and the result does not depend on their order.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.runtime import RunConfig
from repro_torch.models.layers import ParamSpec, swiglu

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


def moe_ffn(cfg: ModelConfig, rcfg: RunConfig, p: dict, x: torch.Tensor):
    """The MoE FFN that ``rcfg.moe_impl`` names; ``"auto"`` is ``"dense"``
    on one device (the reference's choice without a mesh)."""
    if rcfg.moe_impl in EXPERT_PARALLEL:
        raise NotImplementedError(
            f"moe_impl={rcfg.moe_impl!r} shards experts across devices: it waits for "
            "ROADMAP queue 1 item 16 (multi-device launch)"
        )
    if rcfg.moe_impl not in ("auto", "dense"):
        raise ValueError(f"unknown moe_impl {rcfg.moe_impl!r}")
    return moe_ffn_dense(cfg, p, x)
