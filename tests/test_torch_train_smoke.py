"""The port's training path on its own, at the reduced sizes: the
counterparts of ``tests/test_models_smoke.py``'s forward and train-step
tests (bf16 compute, every architecture), the rematerialisation policies
of ``forward_train`` (``RunConfig.remat``) and the kernel wrappers' grad
guard (``kernels/runtime.py::refuse_grad``).

Remat changes what backward keeps, not what it computes: the layer is
recomputed from the same inputs by the same CPU kernels, which are
deterministic, so ``none``, ``full`` and ``dots`` give the same loss and
the same gradients bit for bit (tolerance 0).
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.registry import ARCH_IDS, REGISTRY
from repro_torch.configs.runtime import RunConfig
from repro_torch.kernels.dcov import dcov_gram, dcov_gram_windows
from repro_torch.kernels.flash_attention import flash_attention_bhsd
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import ApplyCtx, forward_train, init_model_params
from repro_torch.models import transformer
from repro_torch.training import AdamWConfig, adamw, make_eval_step, make_train_step
from repro_torch.training.data import multimodal_extras
from repro_torch.training.train_step import loss_fn

RCFG = RunConfig(remat="none", moe_impl="dense")  # bf16 compute, float32 params
B, S = 2, 32
REMAT_ARCHS = ["qwen2.5-3b", "moonshot-v1-16b-a3b", "whisper-medium", "mamba2-2.7b",
               "hymba-1.5b"]


def _setup(name, rcfg=RCFG, seed=0):
    cfg = REGISTRY[name].reduced()
    assert cfg.n_layers <= 2 and cfg.d_model <= 512
    params = init_model_params(cfg, rcfg, torch.Generator().manual_seed(seed), "cpu")
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)}
    batch.update(multimodal_extras(cfg, B, 0))
    return cfg, ApplyCtx(cfg, rcfg), params, {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("name", ARCH_IDS)
def test_forward_shapes_and_no_nans(name):
    cfg, ctx, params, batch = _setup(name)
    with torch.no_grad():
        logits, aux = forward_train(ctx, params, batch)
    assert logits.shape == (B, S, cfg.vocab) and logits.dtype == torch.bfloat16
    assert not torch.isnan(logits).any(), f"{name}: NaN in logits"
    assert torch.isfinite(aux)


@pytest.mark.parametrize("name", ARCH_IDS)
def test_one_train_step(name):
    cfg, ctx, params, batch = _setup(name)
    before = [p.clone() for p in adamw.leaves(params)]
    step = make_train_step(ctx, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10))
    new_params, _, metrics = step(params, adamw.init(params), batch)
    assert torch.isfinite(metrics["loss"]), f"{name}: non-finite loss"
    delta = sum(float((a - b.detach()).abs().sum())
                for a, b in zip(before, adamw.leaves(new_params)))
    assert delta > 0


def test_eval_step_runs_without_grad_and_matches_the_loss():
    cfg, ctx, params, batch = _setup("qwen2.5-3b")
    for p in adamw.leaves(params):
        p.requires_grad_(True)
    m = make_eval_step(ctx)(params, batch)
    assert set(m) == {"loss", "xent", "moe_aux"}
    assert not m["loss"].requires_grad
    loss, _ = loss_fn(ctx, params, batch)
    assert m["loss"].item() == loss.item()


# ----------------------------------------------------------------- remat


def _loss_and_grads(name, remat):
    _, ctx, params, batch = _setup(name, RunConfig(remat=remat, moe_impl="dense",
                                                   compute_dtype="float32"))
    for p in adamw.leaves(params):
        p.requires_grad_(True)
    loss, _ = loss_fn(ctx, params, batch)
    loss.backward()
    return loss.detach(), [p.grad for p in adamw.leaves(params)]


@pytest.mark.parametrize("name", REMAT_ARCHS)
def test_remat_policies_give_the_same_loss_and_gradients(name):
    loss, grads = _loss_and_grads(name, "none")
    for remat in ("full", "dots"):
        l2, g2 = _loss_and_grads(name, remat)
        assert torch.equal(loss, l2), remat
        assert all(torch.equal(a, b) for a, b in zip(grads, g2)), remat


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("remat,recomputed", [("none", False), ("full", True), ("dots", False)])
def test_remat_recomputes_weight_products_only_when_full(remat, recomputed):
    """Backward's ``aten.mm`` count: ``full`` reruns the layers' weight
    products, ``dots`` keeps them (and recomputes the rest)."""
    counts = {}
    for r in ("none", remat):
        _, ctx, params, batch = _setup("qwen2.5-3b", RunConfig(remat=r, moe_impl="dense"))
        for p in adamw.leaves(params):
            p.requires_grad_(True)
        loss, _ = loss_fn(ctx, params, batch)
        with _CountMM() as mode:
            loss.backward()
        counts[r] = mode.mm
    assert (counts[remat] > counts["none"]) == recomputed, counts


def test_remat_checkpoints_each_main_layer_only_under_grad(monkeypatch):
    calls = []
    real = transformer.torch_checkpoint.checkpoint

    def spy(fn, *args, **kwargs):
        calls.append(fn.__name__)
        return real(fn, *args, **kwargs)

    monkeypatch.setattr(transformer.torch_checkpoint, "checkpoint", spy)
    for name, want in [("moonshot-v1-16b-a3b", ["layer_full"]),  # the prologue's layer is not
                       ("whisper-medium", ["_encoder_layer"] * 2 + ["layer_full"] * 2)]:
        cfg, ctx, params, batch = _setup(name, RunConfig(remat="full", moe_impl="dense"))
        with torch.no_grad():
            forward_train(ctx, params, batch)
        assert calls == []
        forward_train(ctx, adamw.tree_map(lambda p: p.requires_grad_(True), params), batch)
        assert calls == want, name
        calls.clear()
        # prefill never rematerialises, whatever remat says
        transformer.prefill(ctx, params, {k: v for k, v in batch.items() if k != "labels"})
        assert calls == []


def test_unknown_remat_raises():
    _, ctx, params, batch = _setup("qwen2.5-3b", RunConfig(remat="some"))
    with pytest.raises(ValueError, match="remat"):
        forward_train(ctx, params, batch)


# ----------------------------------------------------------------- the grad guard


def _wrapper_calls():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 16, 16, generator=g) for _ in range(3))
    x = torch.randn(1, 16, 2, 4, generator=g)
    dt = torch.rand(1, 16, 2, generator=g)
    A = -torch.rand(2, generator=g)
    Bm, Cm = torch.randn(1, 16, 4, generator=g), torch.randn(1, 16, 4, generator=g)
    cols = torch.randn(3, 10, 4, generator=g)
    n_valid = torch.tensor([10, 7, 3], dtype=torch.int32)
    return [
        ("flash_attention_bhsd", lambda t: flash_attention_bhsd(*t), [q, k, v]),
        ("ssd_scan", lambda t: ssd_scan(*t, chunk=8), [x, dt, A, Bm, Cm]),
        ("dcov_gram_windows", lambda t: dcov_gram_windows(t[0], n_valid), [cols]),
        ("dcov_gram", lambda t: dcov_gram(t[0]), [cols[0]]),
    ]


@pytest.mark.parametrize("which", range(4))
def test_each_wrapper_refuses_an_input_that_requires_grad(which):
    name, call, inputs = _wrapper_calls()[which]
    plain = call(inputs)
    for i in range(len(inputs)):
        leafs = [t.clone().requires_grad_(j == i) for j, t in enumerate(inputs)]
        with pytest.raises(RuntimeError, match=f"{name}.*no backward"):
            call(leafs)
        with torch.no_grad():
            out = call(leafs)
        with torch.inference_mode():
            call(leafs)
        first = out[0] if isinstance(out, tuple) else out
        want = plain[0] if isinstance(plain, tuple) else plain
        assert torch.equal(first, want)


@pytest.mark.parametrize("name", ["qwen2.5-3b", "mamba2-2.7b"])
def test_forward_train_through_the_kernels_under_grad_raises(name):
    rcfg = RunConfig(remat="none", use_kernels=True, compute_dtype="float32")
    _, ctx, params, batch = _setup(name, rcfg)
    for p in adamw.leaves(params):
        p.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        forward_train(ctx, params, batch)
    # the eval step reaches the kernels' call sites under no_grad (here their
    # plain versions, the tensors lie on the CPU) and equals the plain eval
    got = make_eval_step(ctx)(params, batch)
    plain_ctx = ApplyCtx(ctx.cfg, RunConfig(remat="none", compute_dtype="float32"))
    plain = make_eval_step(plain_ctx)(params, batch)
    assert got["xent"].item() == pytest.approx(plain["xent"].item(), rel=1e-6)
