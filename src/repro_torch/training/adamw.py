"""AdamW with decoupled weight decay and a cosine schedule, hand-rolled
(the counterpart of ``repro/training/adamw.py``), as plain functions on a
tree (nested dicts) of tensors.

Scalars are float32 tensors, as JAX evaluates them (weak-typed Python
floats against an int32 step): the schedule, the bias corrections
``b**step``, the clip scale. What remains between the packages is the
rounding of one op here and there (``pow`` and ``cos`` in XLA against
ATen, an add with ``alpha`` that ATen may fuse into one FMA, the order of
two divisions): last-place differences, 1e-6 relative over a few steps
(``tests/test_torch_training.py``).

``update`` writes the parameters, m and v in place, under
``torch.no_grad()``, as the reference's donated buffers are reused, and
leaf by leaf through one float32 temporary of the leaf's size, which
holds the clipped gradient and then the step: Qwen2.5-3B's largest
stacked leaf, 36 x 2048 x 11008 float32, is 3.25 GB. It divides by the
bias correction of m last, where the reference divides first.
m and v are float32 from ``init`` on: the reference's start in the
parameter dtype and become float32 at the first update (its update is
taken in float32), so in float32 parameters, the launcher's, the two are
the same.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_clip: float = 1.0


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{"a/b/c": tensor} in the order ``jax.tree`` flattens dicts (sorted
    keys, depth first), keyed by the path joined by "/" as the reference's
    checkpoints key it."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    flat = {}
    for k in sorted(tree):
        flat.update(flatten(tree[k], f"{prefix}/{k}" if prefix else str(k)))
    return flat


def leaves(tree) -> list:
    """The tensors of a tree in ``flatten``'s order."""
    return list(flatten(tree).values())


def tree_map(fn: Callable[[torch.Tensor], Any], tree):
    """``fn`` on every tensor of a tree, keeping its dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``cfg.lr``, then a cosine decay to 0.1 x ``lr`` at
    ``total_steps``: a float32 tensor from an int32 step tensor."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def init(params) -> dict:
    """``{"m", "v", "step"}``: float32 zeros shaped as each parameter, and
    an int32 step 0 on the parameters' device (the reference's keys, so a
    checkpoint's keys match)."""
    dev = leaves(params)[0].device
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in ``leaves`` order) of each leaf's sum
    of squares, in float32."""
    return torch.sqrt(sum(torch.sum(leaf.float() ** 2) for leaf in leaves(tree)))


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state: dict, params) -> Tuple[Any, dict, dict]:
    """One AdamW step of ``params`` by ``grads`` (trees of one structure):
    the global norm clipped to ``cfg.grad_clip``, m and v updated, bias
    corrected, and the decoupled weight decay added, each parameter
    written in place (in float32, rounded back to its dtype). Returns
    (params, state with m, v and step + 1, {"grad_norm", "lr"})."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    bc1 = 1 - cfg.b1 ** step
    bc2 = 1 - cfg.b2 ** step
    for g, m, v, p in zip(leaves(grads), leaves(state["m"]), leaves(state["v"]), leaves(params)):
        t = g.to(torch.float32, copy=True).mul_(scale)  # the one temporary
        m.mul_(cfg.b1).add_(t, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(t, t, value=1 - cfg.b2)
        # t becomes lr * (m / (sqrt(v / bc2) + eps) / bc1 + wd * p)
        torch.div(v, bc2, out=t).sqrt_().add_(cfg.eps)
        torch.div(m, t, out=t).div_(bc1)
        t.add_(p, alpha=cfg.weight_decay).mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(t)
        else:
            p.copy_(t.neg_().add_(p))
        del t  # before the next leaf's is made
    new_state = {"m": state["m"], "v": state["v"], "step": step}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
