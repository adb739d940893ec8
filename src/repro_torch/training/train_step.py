"""Loss, train step and eval step (the counterpart of
``repro/training/train_step.py``).

The train step runs ``forward_train`` under grad, ``loss.backward()``,
the AdamW update in place, and clears the parameters' grads. It reaches
no kernel: the launcher trains with ``use_kernels=False``, as the
reference trains with ``use_pallas=False``, and a kernel wrapper given an
input that requires grad raises. The eval step runs under
``torch.no_grad()``, so with ``use_kernels=True`` its prefill-shaped
attention and SSD scans go through the flash and SSD kernels, as the
reference's eval reaches its Pallas kernels with ``use_pallas=True``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.transformer import ApplyCtx, forward_train
from repro_torch.training import adamw

AUX_LOSS_COEF = 1e-2


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy in float32. logits (B, S, V), labels (B, S)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def loss_fn(ctx: ApplyCtx, params, batch) -> Tuple[torch.Tensor, dict]:
    logits, aux = forward_train(ctx, params, batch)
    xent = cross_entropy(logits, batch["labels"])
    loss = xent + AUX_LOSS_COEF * aux
    return loss, {"loss": loss, "xent": xent, "moe_aux": aux}


def make_train_step(ctx: ApplyCtx, opt_cfg: adamw.AdamWConfig):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: metrics ``loss``, ``xent``, ``moe_aux``, ``grad_norm`` and
    ``lr`` as 0-dim tensors on the device (no host read). Every parameter
    is made a leaf that requires grad (every one of them reaches the loss,
    in every model of the registry)."""

    def train_step(params, opt_state, batch):
        for p in adamw.leaves(params):
            p.requires_grad_(True)
        loss, metrics = loss_fn(ctx, params, batch)
        loss.backward()
        grads = adamw.tree_map(lambda p: p.grad, params)
        params, opt_state, opt_metrics = adamw.update(opt_cfg, grads, opt_state, params)
        del grads
        for p in adamw.leaves(params):
            p.grad = None
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, dict(metrics, **opt_metrics)

    return train_step


def make_eval_step(ctx: ApplyCtx):
    """``eval_step(params, batch) -> metrics`` under ``torch.no_grad()``."""

    @torch.no_grad()
    def eval_step(params, batch):
        return loss_fn(ctx, params, batch)[1]

    return eval_step
