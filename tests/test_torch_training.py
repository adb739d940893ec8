"""The port's training package (``repro_torch/training``) and training
launcher (``repro_torch/launch/train.py``): the counterparts of
``tests/test_training_serving.py``'s training tests, and the same
functions held to the JAX package's on numpy inputs from a seed, with
the JAX model's weights carried over by ``params_from_jax``.

Tolerances. Cross-entropy on random logits 1e-6 relative (float32
logsumexp, summation order only). AdamW fed the same gradients for three
steps: each leaf of the parameters, m and v within 1e-6 of its largest
magnitude (float32 scalars on both sides; the ops round apart in the last
place here and there: ``pow``, an add that ATen fuses into one FMA).
Five train steps of reduced Qwen2.5-3B and Moonlight-16B-A3B (its MoE
aux loss in the loss) in float32 compute: each step's loss within 1e-4
relative (the forward and backward sum in other orders, and the updates
carry that on). Checkpoints: bitwise, in both directions between the
packages, in float32; a bfloat16 leaf round-trips exactly through its
float32 widening.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import REGISTRY as JAX_REGISTRY
from repro.configs.runtime import RunConfig as JaxRunConfig
from repro.models import ApplyCtx as JaxCtx
from repro.models import init_model_params as jax_init
from repro.training import AdamWConfig as JaxAdamWConfig
from repro.training import SyntheticLM as JaxSyntheticLM
from repro.training import adamw as jax_adamw
from repro.training import checkpoint as jax_ckpt
from repro.training import make_train_step as jax_make_train_step
from repro.training import multimodal_extras as jax_extras
from repro.training.train_step import cross_entropy as jax_cross_entropy
from repro_torch.configs.registry import REGISTRY
from repro_torch.launch import serve as t_serve
from repro_torch.launch.train import run_config, train
from repro_torch.models import ApplyCtx, init_model_params
from repro_torch.models.convert import params_from_jax
from repro_torch.training import AdamWConfig, SyntheticLM, adamw, make_train_step
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import multimodal_extras
from repro_torch.training.train_step import cross_entropy

ADAMW_REL = 1e-6
TRAJ_REL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree.detach() if isinstance(tree, torch.Tensor) else tree)}


def _leaves_close(got, want, rel, what):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys(), what
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        err = float(np.abs(got[k].astype(np.float64) - want[k]).max())
        assert err <= rel * scale, f"{what}{k}: {err:.3g} > {rel} x {scale:.3g}"


def _jax_model(arch, compute="float32", seed=0):
    cfg = JAX_REGISTRY[arch].reduced()
    rcfg = JaxRunConfig(remat="none", moe_impl="dense", compute_dtype=compute)
    params = jax_init(jax.random.PRNGKey(seed), cfg, rcfg)
    return cfg, JaxCtx(cfg, rcfg, None), params


# ----------------------------------------------------------------- loss and data


def test_cross_entropy_matches_uniform():
    logits = torch.zeros((2, 3, 7))
    labels = torch.zeros((2, 3), dtype=torch.int32)
    assert float(cross_entropy(logits, labels)) == pytest.approx(np.log(7), rel=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_cross_entropy_matches_jax(dtype):
    rng = np.random.default_rng(5)
    logits = (rng.normal(size=(3, 11, 97)) * 4).astype(np.float32)
    labels = rng.integers(0, 97, (3, 11), dtype=np.int32)
    want = float(jax_cross_entropy(jnp.asarray(logits, dtype), jnp.asarray(labels)))
    t = _t(logits).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    got = float(cross_entropy(t, _t(labels)))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 1), (11, 250)])
def test_synthetic_batches_bitwise_the_references(seed, step):
    got = SyntheticLM(vocab=512, seq_len=32, global_batch=8, seed=seed).batch(step)
    want = JaxSyntheticLM(vocab=512, seq_len=32, global_batch=8, seed=seed).batch(step)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


def test_synthetic_data_deterministic_and_shaped():
    d = SyntheticLM(vocab=100, seq_len=16, global_batch=4, seed=3)
    b1, b2 = d.batch(7), d.batch(7)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert b1["tokens"].shape == (4, 16) and b1["labels"].shape == (4, 16)
    assert b1["tokens"].max() < 100
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    first = next(iter(d))
    np.testing.assert_array_equal(first["tokens"], d.batch(0)["tokens"])


@pytest.mark.parametrize("arch", ["whisper-medium", "qwen2-vl-72b", "qwen2.5-3b"])
def test_multimodal_extras_bitwise_the_references(arch):
    cfg = REGISTRY[arch].reduced()
    got, want = multimodal_extras(cfg, 3, seed=4), jax_extras(JAX_REGISTRY[arch].reduced(), 3, 4)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # still importable from the serving launcher, its home before this package
    assert t_serve.multimodal_extras is multimodal_extras


# ----------------------------------------------------------------- AdamW


@pytest.mark.parametrize("step", [0, 1, 2, 5, 9, 10, 40])
def test_schedule_matches_jax(step):
    kw = dict(lr=2e-3, warmup_steps=3, total_steps=10)
    got = adamw.schedule(AdamWConfig(**kw), torch.tensor(step, dtype=torch.int32))
    want = jax_adamw.schedule(JaxAdamWConfig(**kw), jnp.asarray(step, jnp.int32))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_init_layout_matches_jax():
    _, _, jp = _jax_model("qwen2.5-3b")
    params = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    got, want = adamw.init(params), jax_adamw.init(jp)
    assert set(_flat(got)) == set(_flat(jax.tree.map(np.asarray, want)))
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 0
    assert all(float(t.abs().max()) == 0 for t in adamw.leaves(got["m"]))


def test_adamw_same_gradients_match_jax():
    """Three updates of reduced Qwen2.5-3B's parameters by the same numpy
    gradients (large enough that clipping acts) in both packages."""
    _, _, jp = _jax_model("qwen2.5-3b")
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1)
    jcfg, tcfg = JaxAdamWConfig(**kw), AdamWConfig(**kw)
    np_params = jax.tree.map(np.asarray, jp)
    tp = params_from_jax(np_params, "cpu")
    jstate, tstate = jax_adamw.init(jp), adamw.init(tp)
    rng = np.random.default_rng(9)
    for i in range(3):
        np_g = jax.tree.map(lambda a: rng.normal(0, 0.1 * (i + 1), a.shape).astype(np.float32),
                            np_params)
        jp, jstate, jm = jax_adamw.update(jcfg, jax.tree.map(jnp.asarray, np_g), jstate, jp)
        tp, tstate, tm = adamw.update(tcfg, params_from_jax(np_g, "cpu"), tstate, tp)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
        assert float(tm["grad_norm"]) > tcfg.grad_clip  # the clip acts
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert int(tstate["step"]) == int(jstate["step"]) == i + 1
        _leaves_close(tp, jax.tree.map(np.asarray, jp), ADAMW_REL, f"step {i} params")
        for key in ("m", "v"):
            _leaves_close(tstate[key], jax.tree.map(np.asarray, jstate[key]), ADAMW_REL,
                          f"step {i} {key}")


def test_adamw_updates_in_place_and_keeps_dtype():
    p = {"a": torch.ones(3, 4), "b": {"c": torch.ones(5, dtype=torch.bfloat16)}}
    ids = [id(t) for t in adamw.leaves(p)]
    state = adamw.init(p)
    g = adamw.tree_map(lambda t: torch.full_like(t, 0.5), p)
    p2, state2, metrics = adamw.update(AdamWConfig(warmup_steps=1), g, state, p)
    assert [id(t) for t in adamw.leaves(p2)] == ids
    assert p2["b"]["c"].dtype == torch.bfloat16
    assert state2["m"]["a"] is state["m"]["a"] and state2["m"]["a"].dtype == torch.float32
    assert float(p2["a"][0, 0]) < 1.0 and int(state2["step"]) == 1
    assert float(metrics["grad_norm"]) == pytest.approx(0.5 * np.sqrt(17), rel=1e-6)


# ----------------------------------------------------------------- train steps


def _batches(cfg, n, batch, seq, seed=0):
    data = SyntheticLM(cfg.vocab, seq, batch, seed=seed)
    extras = multimodal_extras(cfg, batch, seed)
    return [dict(data.batch(i), **extras) for i in range(n)]


def test_loss_decreases_tiny_model():
    """The reference test's settings: reduced Qwen2.5-3B, lr 2e-3, warm-up
    2, 40 total, no weight decay, 30 steps of 8 x 32."""
    cfg = REGISTRY["qwen2.5-3b"].reduced()
    rcfg = run_config("none")
    params = init_model_params(cfg, rcfg, torch.Generator().manual_seed(0), "cpu")
    opt_cfg = AdamWConfig(lr=2e-3, warmup_steps=2, total_steps=40, weight_decay=0.0)
    step = make_train_step(ApplyCtx(cfg, rcfg), opt_cfg)
    opt = adamw.init(params)
    losses = []
    for b in _batches(cfg, 30, 8, 32):
        params, opt, m = step(params, opt, {k: _t(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.5, losses[:3] + losses[-3:]


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "moonshot-v1-16b-a3b"])
def test_train_steps_match_jax(arch):
    """Five steps from the same parameters on the same batches, float32
    compute: each step's loss, xent, MoE aux and grad norm."""
    cfg, jctx, jp = _jax_model(arch)
    tcfg = REGISTRY[arch].reduced()
    kw = dict(lr=2e-3, warmup_steps=2, total_steps=10)
    jstep = jax.jit(jax_make_train_step(jctx, JaxAdamWConfig(**kw)))
    tstep = make_train_step(ApplyCtx(tcfg, run_config("none", "float32")), AdamWConfig(**kw))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    jopt, topt = jax_adamw.init(jp), adamw.init(tp)
    for i, b in enumerate(_batches(tcfg, 5, 4, 24)):
        jp, jopt, jm = jstep(jp, jopt, {k: jnp.asarray(v) for k, v in b.items()})
        tp, topt, tm = tstep(tp, topt, {k: _t(v) for k, v in b.items()})
        for key in ("loss", "xent", "grad_norm", "lr"):
            assert float(tm[key]) == pytest.approx(float(jm[key]), rel=TRAJ_REL), (i, key)
        assert float(tm["moe_aux"]) == pytest.approx(float(jm["moe_aux"]), rel=TRAJ_REL,
                                                     abs=1e-12), i
    if cfg.moe is not None:
        assert float(tm["moe_aux"]) > 0


def test_train_step_clears_grads_and_returns_the_references_keys():
    cfg = REGISTRY["qwen2.5-3b"].reduced()
    rcfg = run_config("none")
    params = init_model_params(cfg, rcfg, torch.Generator().manual_seed(0), "cpu")
    step = make_train_step(ApplyCtx(cfg, rcfg), AdamWConfig())
    b = {k: _t(v) for k, v in _batches(cfg, 1, 2, 16)[0].items()}
    params, opt, m = step(params, adamw.init(params), b)
    assert set(m) == {"loss", "xent", "moe_aux", "grad_norm", "lr"}
    assert all(p.grad is None and p.requires_grad for p in adamw.leaves(params))
    assert not any(v.requires_grad for v in m.values())


# ----------------------------------------------------------------- checkpoints


def _qwen_port_params(dtype=torch.float32):
    cfg = REGISTRY["qwen2.5-3b"].reduced()
    return init_model_params(cfg, run_config(), torch.Generator().manual_seed(0), "cpu"), cfg


def test_checkpoint_roundtrip(tmp_path):
    params, cfg = _qwen_port_params()
    opt = adamw.init(params)
    opt["m"]["embed"].fill_(0.25)
    path = os.path.join(tmp_path, "ckpt")
    ckpt.save(path, params, opt, step=11, meta={"arch": cfg.name})
    assert sorted(os.listdir(path)) == ["manifest.json", "opt_state.npz", "params.npz"]
    p2, o2, step = ckpt.restore(path, params, opt)
    assert step == 11
    for a, b in zip(adamw.leaves(params) + adamw.leaves(opt), adamw.leaves(p2) + adamw.leaves(o2)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_bf16_is_exact_through_float32(tmp_path):
    params, _ = _qwen_port_params()
    bf = adamw.tree_map(lambda t: t.to(torch.bfloat16), params)
    ckpt.save(str(tmp_path), bf)
    with np.load(os.path.join(tmp_path, "params.npz")) as npz:
        assert npz["layers/attn/wq"].dtype == np.float32
    p2, opt, _ = ckpt.restore(str(tmp_path), bf)
    assert opt is None
    assert all(b.dtype == torch.bfloat16 and torch.equal(a, b)
               for a, b in zip(adamw.leaves(bf), adamw.leaves(p2)))


def test_checkpoint_refuses_a_wrong_shape(tmp_path):
    params, _ = _qwen_port_params()
    ckpt.save(str(tmp_path), params)
    bad = dict(params, final_norm=torch.ones(3))
    with pytest.raises(ValueError, match="final_norm"):
        ckpt.restore(str(tmp_path), bad)


def test_checkpoint_interop_with_jax(tmp_path):
    """The JAX package's checkpoint restores in the port, and the port's in
    the JAX package, keys, step and every value bitwise (float32)."""
    _, _, jp = _jax_model("qwen2.5-3b")
    jopt = jax_adamw.init(jp)
    jopt = dict(jopt, m=jax.tree.map(lambda a: a + 0.5, jopt["m"]), step=jnp.asarray(7, jnp.int32))
    np_params = jax.tree.map(np.asarray, jp)
    tp = params_from_jax(np_params, "cpu")
    tmpl = adamw.init(tp)

    jdir, tdir = os.path.join(tmp_path, "jax"), os.path.join(tmp_path, "port")
    jax_ckpt.save(jdir, jp, jopt, step=7, meta={"arch": "qwen2.5-3b"})
    p2, o2, step = ckpt.restore(jdir, tp, tmpl)
    assert step == 7 and int(o2["step"]) == 7
    _leaves_close(p2, np_params, 0.0, "params")
    _leaves_close(o2, jax.tree.map(np.asarray, jopt), 0.0, "opt")

    ckpt.save(tdir, p2, o2, step=7, meta={"arch": "qwen2.5-3b"})
    jp2, jo2, jstep = jax_ckpt.restore(tdir, jp, jopt)
    assert jstep == 7
    _leaves_close(jax.tree.map(np.asarray, jp2), np_params, 0.0, "params back")
    _leaves_close(jax.tree.map(np.asarray, jo2), jax.tree.map(np.asarray, jopt), 0.0, "opt back")


# ----------------------------------------------------------------- launcher


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    params, losses, history = train("qwen2.5-3b", steps=12, batch=4, seq=32, reduced=True,
                                    lr=2e-3, device="cpu", log_every=0,
                                    ckpt_dir=str(tmp_path), ckpt_every=5)
    assert len(losses) == len(history) == 12
    assert np.mean(losses[-3:]) < np.mean(losses[:3]) - 0.3, losses
    assert all(np.isfinite(h["grad_norm"]) and h["seconds"] > 0 for h in history)
    assert [h["loss"] for h in history] == losses
    assert all(p.device.type == "cpu" for p in adamw.leaves(params))
    p2, o2, step = ckpt.restore(str(tmp_path), params, adamw.init(params))
    assert step == 12 and int(o2["step"]) == 12
    assert all(torch.equal(a.detach(), b) for a, b in zip(adamw.leaves(params), adamw.leaves(p2)))
    assert "12 steps in" in capsys.readouterr().out


def test_launcher_runs_the_plain_paths():
    rcfg = run_config()
    assert (rcfg.remat, rcfg.moe_impl, rcfg.param_dtype, rcfg.compute_dtype) == (
        "none", "dense", "float32", "bfloat16")
    assert rcfg.use_kernels is False
