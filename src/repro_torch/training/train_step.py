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
from repro_torch.sharding.specs import is_dtensor
from repro_torch.training import adamw

AUX_LOSS_COEF = 1e-2


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy in float32. logits (B, S, V), labels (B, S)."""
    if is_dtensor(logits):
        return _cross_entropy_sharded(logits, labels)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def _cross_entropy_sharded(logits, labels) -> torch.Tensor:
    """``cross_entropy`` under a mesh, on each rank's shard, vocab-parallel:
    the log-sum-exp's max and sum and the labels' logits (picked by the
    ``"model"`` shard whose slice of the vocabulary holds them) reduce
    over ``"model"``, and the mean over the data axes; the logits are
    never gathered."""
    from torch.distributed import _functional_collectives as fc
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.sharding.specs import Spec, batch_split, mesh_shape, psum, to_local

    mesh = logits.device_mesh
    shape = mesh_shape(mesh)
    b, s, v = logits.shape
    bs = batch_split(mesh, b)
    vs = "model" if v % shape.get("model", 1) == 0 and shape.get("model", 1) > 1 else None
    ll = to_local(mesh, logits, Spec(bs, None, vs)).float()
    idx = to_local(mesh, labels, Spec(bs, None)).long()
    mx = ll.detach().amax(dim=-1, keepdim=True)
    if vs:
        mx = fc.wait_tensor(fc.all_reduce(mx, "max", mesh.get_group("model")))
        idx = idx - mesh.get_local_rank("model") * ll.shape[-1]
    se = torch.exp(ll - mx).sum(dim=-1)
    inside = (idx >= 0) & (idx < ll.shape[-1])
    gold = torch.gather(ll, -1, idx.clamp(0, ll.shape[-1] - 1)[..., None])[..., 0]
    gold = torch.where(inside, gold, torch.zeros((), dtype=gold.dtype, device=gold.device))
    if vs:
        se, gold = psum(mesh, se, "model"), psum(mesh, gold, "model")
    total = (torch.log(se) + mx[..., 0] - gold).sum()
    for ax in (bs or ()):
        total = psum(mesh, total, ax)
    return DTensor.from_local(total / (b * s), mesh, [Replicate()] * mesh.ndim, run_check=False)


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
        grads = adamw.tree_map(_reduced_grad, params)
        params, opt_state, opt_metrics = adamw.update(opt_cfg, grads, opt_state, params)
        del grads
        for p in adamw.leaves(params):
            p.grad = None
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, dict(metrics, **opt_metrics)

    return train_step


def _reduced_grad(p: torch.Tensor) -> torch.Tensor:
    """A parameter's gradient; under a mesh, reduced to the parameter's own
    placements (a pending partial sum over the data axes is reduced, or
    reduce-scattered onto an fsdp-sharded parameter)."""
    g = p.grad
    if is_dtensor(g):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_eval_step(ctx: ApplyCtx):
    """``eval_step(params, batch) -> metrics`` under ``torch.no_grad()``."""

    @torch.no_grad()
    def eval_step(params, batch):
        return loss_fn(ctx, params, batch)[1]

    return eval_step
