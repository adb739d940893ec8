"""The port's training forward (``models/transformer.py::forward_train``)
and its gradients against the JAX package's, for every architecture of
the registry (reduced), in float32 compute, the JAX model's weights
carried over by ``params_from_jax`` and the batch (tokens, labels and the
stub front ends' inputs) drawn from a numpy seed.

Tolerances (float32 reordering only: XLA's and ATen's CPU kernels sum in
other orders). Logits within 1e-4 of their largest magnitude, the MoE aux
loss within 1e-5 relative, the loss within 1e-5 relative, the global
gradient norm within 1e-4 relative, and each leaf's gradient within 1e-3
of its largest magnitude, but no tighter than 1e-6 of the largest
gradient of the tree: a leaf whose gradient vanishes in exact arithmetic
(Whisper's key biases: softmax is blind to a shift of every key, and
Whisper rotates no key) carries only rounding, ~1e-9 in both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCH_IDS as JAX_ARCH_IDS
from repro.configs.registry import REGISTRY as JAX_REGISTRY
from repro.configs.runtime import RunConfig as JaxRunConfig
from repro.models import ApplyCtx as JaxCtx
from repro.models import forward_train as jax_forward_train
from repro.models import init_model_params as jax_init
from repro.training import adamw as jax_adamw
from repro.training.train_step import loss_fn as jax_loss_fn
from repro_torch.configs.registry import ARCH_IDS, REGISTRY
from repro_torch.launch.train import run_config
from repro_torch.models import ApplyCtx, forward_train
from repro_torch.models.convert import params_from_jax
from repro_torch.training import adamw
from repro_torch.training.data import multimodal_extras
from repro_torch.training.train_step import loss_fn

B, S = 2, 32
LOGIT_REL, AUX_REL, LOSS_REL, NORM_REL = 1e-4, 1e-5, 1e-5, 1e-4
GRAD_REL, GRAD_FLOOR = 1e-3, 1e-6


def test_arch_ids_match():
    assert tuple(ARCH_IDS) == tuple(JAX_ARCH_IDS)


def _setup(arch):
    jcfg = JAX_REGISTRY[arch].reduced()
    jrcfg = JaxRunConfig(remat="none", moe_impl="dense", compute_dtype="float32")
    jp = jax_init(jax.random.PRNGKey(0), jcfg, jrcfg)
    np_params = jax.tree.map(np.asarray, jp)
    cfg = REGISTRY[arch].reduced()
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)}
    # the stub inputs at normal(0, 1): at the reference's 0.02 every encoder
    # row would be its sinusoidal positions and little else
    batch.update(multimodal_extras(cfg, B, 0, 1.0))
    jctx = JaxCtx(jcfg, jrcfg, None)
    ctx = ApplyCtx(cfg, run_config("none", "float32"))
    return jctx, jp, ctx, params_from_jax(np_params, "cpu"), batch


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_train_matches_jax(arch):
    jctx, jp, ctx, params, batch = _setup(arch)
    jl, ja = jax.jit(lambda p, b: jax_forward_train(jctx, p, b))(jp, _jb(batch))
    with torch.no_grad():
        tl, ta = forward_train(ctx, params, _tb(batch))
    jl = np.asarray(jl)
    assert tl.shape == (B, S, ctx.cfg.vocab) and tl.dtype == torch.float32
    assert ta.dtype == torch.float32 and ta.shape == ()
    err = float(np.abs(tl.numpy() - jl).max())
    assert err <= LOGIT_REL * np.abs(jl).max(), err
    assert float(ta) == pytest.approx(float(ja), rel=AUX_REL, abs=0.0)
    assert (float(ta) > 0) == (ctx.cfg.moe is not None)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_gradients_match_jax(arch):
    jctx, jp, ctx, params, batch = _setup(arch)
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jax_loss_fn(jctx, p, b), has_aux=True))(jp, _jb(batch))
    jnorm = float(jax_adamw.global_norm(jg))
    for p in adamw.leaves(params):
        p.requires_grad_(True)
    loss, metrics = loss_fn(ctx, params, _tb(batch))
    loss.backward()
    assert loss.item() == pytest.approx(float(jloss), rel=LOSS_REL)
    grads = adamw.tree_map(lambda p: p.grad, params)
    assert float(adamw.global_norm(grads)) == pytest.approx(jnorm, rel=NORM_REL)
    want = _flat(jax.tree.map(np.asarray, jg))
    got = _flat(adamw.tree_map(lambda g: g.numpy(), grads))
    assert got.keys() == want.keys()
    floor = GRAD_FLOOR * max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        tol = max(GRAD_REL * float(np.abs(w).max()), floor)
        err = float(np.abs(got[k] - w).max())
        assert err <= tol, f"{arch} {k}: {err:.3g} > {tol:.3g}"
