"""The port's Mamba2 slice (``repro_torch.models.ssm`` and the SSM branch of
``models/transformer.py``) against the JAX package, on reduced Mamba2-2.7B
with the JAX model's weights carried over by ``params_from_jax``.

The JAX initialiser sets A_log = 1 and dt_bias = 0 for every head; the
tests draw both per head from a seeded numpy generator (A_log = log U(1, 16)
and dt_bias = U(-4, -1), Mamba2's own ranges) so that every head decays at
its own rate.

Tolerances. Float32 compute: atol 1e-4 on outputs of magnitude ~1-5 —
only summation order differs (XLA vs PyTorch, and the chunked scan's
einsums). The caches are bf16 in both packages; their float32 sources
differ by summation order only, so an element may round to the other side
of a bf16 rounding point: caches are compared at rtol 2^-7 (one bf16 ulp)
plus atol 1e-5 for values near zero, and at most 1% of their elements may
differ at all. Decode reads and rewrites that cache every step, and one
element rounded apart moves the next logits by more than float32
reordering does, so decode logits are compared at atol 1e-3; prefill
logits, which read no cache, at 1e-4.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import REGISTRY as JAX_REGISTRY
from repro.configs.runtime import RunConfig as JaxRunConfig
from repro.models import ApplyCtx as JaxCtx
from repro.models import decode_step as jax_decode
from repro.models import init_model_params as jax_init
from repro.models import prefill as jax_prefill
from repro.models import ssm as jax_ssm
from repro_torch.configs.registry import REGISTRY
from repro_torch.configs.runtime import RunConfig
from repro_torch.models import ApplyCtx, decode_step, param_specs, prefill
from repro_torch.models import ssm
from repro_torch.models.convert import params_from_jax

ARCH = "mamba2-2.7b"
VOCAB = 512  # reduced() clamps mamba2-2.7b's vocab to this
ATOL = 1e-4
DECODE_ATOL = 1e-3  # logits after reading the bf16 cache (module note)
CACHE_RTOL, CACHE_ATOL = 2.0**-7, 1e-5


def mamba_np_params(seed: int = 0) -> dict:
    """Reduced Mamba2 parameters from the JAX initialiser, as numpy, with
    A_log and dt_bias drawn per head (see the module note)."""
    cfg = JAX_REGISTRY[ARCH].reduced()
    params = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(seed), cfg, JaxRunConfig()))
    sp = params["layers"]["ssm"]
    rng = np.random.default_rng(seed)
    sp["A_log"] = np.log(rng.uniform(1, 16, sp["A_log"].shape)).astype(np.float32)
    sp["dt_bias"] = rng.uniform(-4, -1, sp["dt_bias"].shape).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def np_params():
    return mamba_np_params()


def _ctxs(kernels):
    """Float32 compute in both packages, the kernel path on or off."""
    jctx = JaxCtx(JAX_REGISTRY[ARCH].reduced(),
                  JaxRunConfig(remat="none", moe_impl="dense", compute_dtype="float32",
                               use_pallas=kernels))
    tctx = ApplyCtx(REGISTRY[ARCH].reduced(),
                    RunConfig(compute_dtype="float32", use_kernels=kernels))
    return jctx, tctx


def _layer0(tree):
    return {k: _layer0(v) if isinstance(v, dict) else v[0] for k, v in tree.items()}


@pytest.mark.parametrize("kernels", [False, True])
def test_mamba2_forward_matches_jax(np_params, kernels):
    jctx, tctx = _ctxs(kernels)
    cfg = tctx.cfg
    p_np = _layer0(np_params["layers"]["ssm"])
    x = np.random.default_rng(1).normal(size=(2, 13, cfg.d_model)).astype(np.float32)
    ref, ref_state = jax_ssm.mamba2_forward(jctx.cfg, jax.tree.map(jnp.asarray, p_np),
                                            jnp.asarray(x), jctx.rcfg)
    p = params_from_jax(p_np, "cpu")
    out, state = ssm.mamba2_forward(cfg, p, torch.from_numpy(x), tctx.rcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(ref_state), atol=ATOL)
    # the conv tail is sliced from the same in-projection the reference redoes
    _, _, proj = ssm.mamba2_prefill(cfg, p, torch.from_numpy(x), tctx.rcfg)
    tail = ssm.conv_tail(cfg, proj)
    assert tail.dtype == torch.bfloat16 and tail.shape == (2, cfg.ssm.d_conv - 1, 288)


def test_mamba2_decode_matches_jax(np_params):
    """The model's decode entry point, kernels off, on a float32 cache
    (its plain state step at float32, stored back unrounded) against the
    reference's step: out, the new state and the new conv state."""
    jctx, tctx = _ctxs(False)
    cfg = tctx.cfg
    s = cfg.ssm
    nh, di = s.n_ssm_heads(cfg.d_model), s.inner(cfg.d_model)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    st = rng.normal(size=(2, nh, s.headdim, s.d_state)).astype(np.float32)
    conv = rng.normal(size=(2, s.d_conv - 1, di + 2 * s.d_state)).astype(np.float32)
    p_np = _layer0(np_params["layers"]["ssm"])
    ref = jax_ssm.mamba2_decode(jctx.cfg, jax.tree.map(jnp.asarray, p_np),
                                *(jnp.asarray(a) for a in (x, st, conv)))
    cache = {"ssm": torch.from_numpy(st.copy()), "conv": torch.from_numpy(conv.copy())}
    y = ssm.mamba2_decode(cfg, params_from_jax(p_np, "cpu"), torch.from_numpy(x), cache,
                          RunConfig(use_kernels=False))
    for a, b in zip((y, cache["ssm"], cache["conv"]), ref):
        assert a.shape == b.shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


def test_params_from_jax_carries_the_ssm_tree(np_params):
    """A leaf-by-leaf copy: the port's spec tree, key for key, with every
    value unchanged (bf16 leaves widened exactly)."""
    p = params_from_jax(np_params, "cpu")
    specs = param_specs(REGISTRY[ARCH].reduced())
    assert set(p) == set(specs) == {"embed", "final_norm", "head", "layers"}
    assert set(p["layers"]) == {"ln1", "ssm"}
    assert set(p["layers"]["ssm"]) == set(specs["layers"]["ssm"]) == {
        "in_proj", "conv_w", "conv_b", "dt_bias", "A_log", "D", "norm_w", "out_proj"}
    for k, spec in specs["layers"]["ssm"].items():
        t = p["layers"]["ssm"][k]
        assert tuple(t.shape) == spec.shape and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np_params["layers"]["ssm"][k])
    bf = params_from_jax({"w": np.asarray(jnp.asarray(np_params["layers"]["ssm"]["A_log"],
                                                      jnp.bfloat16))}, "cpu")["w"]
    np.testing.assert_array_equal(
        bf.numpy(), np.asarray(jnp.asarray(np_params["layers"]["ssm"]["A_log"], jnp.bfloat16),
                               np.float32))


def _run_both(np_params, kernels, prompt, n_steps, cap=24):
    """Prefill + ``n_steps`` decodes fed the same numpy-drawn tokens in both
    packages; returns the (jax, port) logits per step and the two caches
    after prefill."""
    jctx, tctx = _ctxs(kernels)
    rng = np.random.default_rng(5)
    feeds = rng.integers(0, VOCAB, (n_steps, prompt.shape[0], 1), dtype=np.int32)
    jp = jax.jit(functools.partial(jax_prefill, jctx, capacity=cap))
    jd = jax.jit(functools.partial(jax_decode, jctx))
    params = params_from_jax(np_params, "cpu")
    jcache, jlog = jp(np_params, {"tokens": prompt})
    with torch.inference_mode():
        tcache, tlog = prefill(tctx, params, {"tokens": torch.from_numpy(prompt)}, capacity=cap)
    caches = (jax.tree.map(lambda a: np.asarray(a, np.float32), jcache),
              {k: v.clone() for k, v in tcache["main"].items()})
    pairs = [(np.asarray(jlog, np.float32), tlog.float().numpy())]
    for tok in feeds:
        jcache, jlog = jd(np_params, jcache, tok)
        with torch.inference_mode():
            tcache, tlog = decode_step(tctx, params, tcache, torch.from_numpy(tok))
        pairs.append((np.asarray(jlog, np.float32), tlog.float().numpy()))
    assert tcache["length"] == int(jcache["length"]) == prompt.shape[1] + n_steps
    return pairs, caches


@pytest.mark.parametrize("kernels", [False, True])
def test_prefill_and_decode_match_jax_fp32(np_params, kernels):
    """Prompt 13 with chunk 8: one full chunk and a ragged tail."""
    prompt = np.random.default_rng(4).integers(0, VOCAB, (2, 13), dtype=np.int32)
    pairs, (jcache, tcache) = _run_both(np_params, kernels, prompt, n_steps=4)
    assert set(tcache) == set(jcache["main"]) == {"ssm", "conv"}  # no K/V for Mamba2
    cfg = REGISTRY[ARCH].reduced()
    s = cfg.ssm
    shapes = {"ssm": (2, 2, 16, 16, 16), "conv": (2, 2, s.d_conv - 1, 288)}
    for name, shape in shapes.items():
        assert tcache[name].dtype == torch.bfloat16
        assert tuple(tcache[name].shape) == jcache["main"][name].shape == shape
        got = tcache[name].float().numpy()
        np.testing.assert_allclose(got, jcache["main"][name], rtol=CACHE_RTOL, atol=CACHE_ATOL)
        assert (got != jcache["main"][name]).mean() <= 0.01  # isolated rounding, not drift
    for step, (ref, out) in enumerate(pairs):
        assert out.shape == ref.shape == (2, 1, VOCAB)
        np.testing.assert_allclose(out, ref, atol=ATOL if step == 0 else DECODE_ATOL)


@pytest.mark.parametrize("prompt_len", [1, 2])
def test_prompts_shorter_than_the_conv_window(np_params, prompt_len):
    """d_conv - 1 = 3 > S: the conv state is front-padded with zeros."""
    prompt = np.random.default_rng(6).integers(0, VOCAB, (2, prompt_len), dtype=np.int32)
    pairs, (jcache, tcache) = _run_both(np_params, True, prompt, n_steps=3)
    conv = tcache["conv"].float().numpy()
    assert (conv[:, :, : 3 - prompt_len] == 0).all()
    np.testing.assert_allclose(conv, jcache["main"]["conv"], rtol=CACHE_RTOL, atol=CACHE_ATOL)
    for step, (ref, out) in enumerate(pairs):
        np.testing.assert_allclose(out, ref, atol=ATOL if step == 0 else DECODE_ATOL)
