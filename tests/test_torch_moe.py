"""The port's MoE FFN (``models/moe.py``), its dense prologue and the
DeepSeek family's models against the JAX package, on reduced
Moonlight-16B-A3B (shared experts, a dense layer 0 ahead of the MoE
stack), Qwen3-MoE-235B-A22B (no shared experts, every layer MoE) and
DeepSeek-V2-236B (MLA and MoE, a dense layer 0), with the JAX model's
weights carried over by ``params_from_jax`` and inputs from a numpy seed.

Routing. The top-k expert ids are asserted identical before any value is
compared: a flipped choice is a different function, not a rounding.

Tolerances. Float32 compute: the module outputs within 1e-5 of their
largest magnitude (summation order only), the routing weights and
probabilities at rtol 1e-5, prefill logits atol 1e-4, and decode logits,
each step from the JAX package's own cache, atol 1e-4 too. The caches
(K/V, or MLA's ``ckv`` and ``krope``; the prologue's ``"pro"`` and the
main stack's) at rtol 2^-7 (one bf16 ulp) plus atol 1e-5, with at most 1%
of their elements apart at all: both packages round float32 values to the
bf16 cache, and a value whose two float32 sources straddle a rounding
point lands one ulp apart; run freely, such ulps compound (4e-4 to 8e-4
in the reduced models' logits after three steps), so each decode step
starts from the JAX package's cache, as ``tests/test_torch_hybrid.py``
does. Bfloat16 compute: the experts' products in bf16 on both sides,
rounded at other places by XLA's and PyTorch's CPU kernels, so the FFN
output within 2e-2 of its largest magnitude (a few bf16 ulps, 2^-8
relative, over three products and the float32 combine) and prefill
logits within 0.1, as ``tests/test_torch_serving.py`` holds the dense
model; the routing itself is float32 in both, so its ids stay identical.
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
from repro.models import moe as jax_moe
from repro.models import prefill as jax_prefill
from repro.models import transformer as jax_transformer
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs.registry import REGISTRY
from repro_torch.configs.runtime import RunConfig
from repro_torch.models import ApplyCtx, decode_step, moe, param_specs, prefill
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import ServingEngine

MOE_ARCHS = ["moonshot-v1-16b-a3b", "qwen3-moe-235b-a22b"]
MODEL_ARCHS = MOE_ARCHS + ["deepseek-v2-236b"]
VOCAB = 512  # reduced() clamps every vocab to this
PROMPT, STEPS = 12, 4
REL = 1e-5  # float32 modules, relative to the largest magnitude
BF16_REL = 2e-2  # bf16 FFN output, relative to the largest magnitude
ATOL = 1e-4  # float32 logits
BF16_ATOL = 0.1  # bf16 prefill logits
CACHE_RTOL, CACHE_ATOL = 2.0**-7, 1e-5
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@functools.lru_cache(maxsize=None)
def _np_params(arch):
    """The reduced model's parameters from the JAX initialiser, as numpy."""
    cfg = JAX_REGISTRY[arch].reduced()
    return jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0), cfg, JaxRunConfig()))


def _moe_layer(arch):
    """Layer 0 of the main stack's FFN (an MoE layer), numpy and torch."""
    fp = {k: v[0] for k, v in _np_params(arch)["layers"]["ffn"].items()}
    return fp, params_from_jax(fp, "cpu")


def _x(shape, dtype, seed=3):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _close(got, want, rel, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max(), err_msg=what)


def _spec_shapes(tree):
    if isinstance(tree, dict):
        return {k: _spec_shapes(v) for k, v in tree.items()}
    return (tuple(tree.shape), tree.init)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_param_specs_are_the_references(arch, reduced):
    """The spec tree, key for key, shape for shape: MoE layers, the dense
    ``"prologue"``, MLA attention (no parameter is drawn)."""
    tcfg, jcfg = REGISTRY[arch], JAX_REGISTRY[arch]
    if reduced:
        tcfg, jcfg = tcfg.reduced(), jcfg.reduced()
    got = _spec_shapes(param_specs(tcfg))
    assert got == _spec_shapes(jax_transformer.param_specs(jcfg))
    assert ("prologue" in got) == (tcfg.moe.first_moe_layer > 0)
    assert ("wkv_b" in got["layers"]["attn"]) == (tcfg.mla is not None)
    assert "router" in got["layers"]["ffn"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_route_matches_jax(arch, dtype):
    fp, tp = _moe_layer(arch)
    jx, tx = _x((40, REGISTRY[arch].reduced().d_model), dtype)
    jw, ji, jprobs = jax_moe._route(JAX_REGISTRY[arch].reduced(), jnp.asarray(fp["router"]), jx)
    tw, ti, tprobs = moe._route(REGISTRY[arch].reduced(), tp["router"], tx)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert tw.dtype == tprobs.dtype == torch.float32
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=REL)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), rtol=REL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_dense_matches_jax(arch, dtype):
    """y and the load-balance loss, with the top-k ids identical first."""
    fp, tp = _moe_layer(arch)
    jcfg, tcfg = JAX_REGISTRY[arch].reduced(), REGISTRY[arch].reduced()
    jx, tx = _x((2, 20, tcfg.d_model), dtype)
    jfp = jax.tree.map(jnp.asarray, fp)
    _, ji, _ = jax_moe._route(jcfg, jfp["router"], jx.reshape(40, -1))
    _, ti, _ = moe._route(tcfg, tp["router"], tx.reshape(40, -1))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    jy, jaux = jax_moe.moe_ffn_dense(jcfg, jfp, jx)
    ty, taux = moe.moe_ffn_dense(tcfg, tp, tx)
    assert ty.dtype == tx.dtype and ty.shape == tx.shape
    _close(ty, jy, REL if dtype == "float32" else BF16_REL, "y")
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=REL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_shared_experts_match_jax(arch):
    fp, tp = _moe_layer(arch)
    jx, tx = _x((40, REGISTRY[arch].reduced().d_model), "float32")
    ys = moe._shared(tp, tx)
    _close(ys, jax_moe._shared(jax.tree.map(jnp.asarray, fp), jx), REL, "shared")
    assert ("ws_gate" in tp) == (arch == "moonshot-v1-16b-a3b")
    if "ws_gate" not in tp:
        assert not ys.any()


def test_moe_impl_choices():
    """``auto`` and ``dense`` run the compute-all path without a mesh; the
    expert-parallel paths need one and say so."""
    cfg = REGISTRY["moonshot-v1-16b-a3b"].reduced()
    _, tp = _moe_layer("moonshot-v1-16b-a3b")
    _, x = _x((1, 6, cfg.d_model), "float32")
    ref = moe.moe_ffn_dense(cfg, tp, x)[0]
    assert RunConfig().moe_impl == "auto"
    for impl in ("auto", "dense"):
        assert torch.equal(moe.moe_ffn(cfg, RunConfig(moe_impl=impl), None, tp, x)[0], ref)
    for impl in moe.EXPERT_PARALLEL:
        with pytest.raises(ValueError, match="needs a mesh"):
            moe.moe_ffn(cfg, RunConfig(moe_impl=impl), None, tp, x)
    with pytest.raises(ValueError, match="unknown moe_impl"):
        moe.moe_ffn(cfg, RunConfig(moe_impl="grouped"), None, tp, x)


def _ctxs(arch, kernels, compute_dtype="float32"):
    jctx = JaxCtx(JAX_REGISTRY[arch].reduced(),
                  JaxRunConfig(remat="none", moe_impl="dense", compute_dtype=compute_dtype,
                               use_pallas=kernels))
    tctx = ApplyCtx(REGISTRY[arch].reduced(),
                    RunConfig(compute_dtype=compute_dtype, use_kernels=kernels))
    return jctx, tctx


def _parts(cache):
    return [p for p in ("pro", "main") if p in cache]


def _as_np(cache):
    return {p: {k: np.asarray(v.float() if isinstance(v, torch.Tensor) else v, np.float32)
                for k, v in cache[p].items()} for p in _parts(cache)}


def _run_both(arch, kernels, cap, n_steps=STEPS, seed=5):
    """Prefill PROMPT tokens in both packages, then ``n_steps`` decodes fed
    the same tokens, the port's each from the JAX package's cache of that
    step (module note). Returns (jax, port) logits and caches per step."""
    jctx, tctx = _ctxs(arch, kernels)
    np_params = _np_params(arch)
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, VOCAB, (2, PROMPT), dtype=np.int32)
    feeds = rng.integers(0, VOCAB, (n_steps, 2, 1), dtype=np.int32)
    params = params_from_jax(np_params, "cpu")
    jcache, jlog = jax.jit(functools.partial(jax_prefill, jctx, capacity=cap))(
        np_params, {"tokens": prompt})
    with torch.inference_mode():
        tcache, tlog = prefill(tctx, params, {"tokens": torch.from_numpy(prompt)}, capacity=cap)
    steps = [(np.asarray(jlog, np.float32), tlog.float().numpy(), _as_np(jcache),
              _as_np(tcache))]
    jd = jax.jit(functools.partial(jax_decode, jctx))
    for tok in feeds:
        start = {p: {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in c.items()}
                 for p, c in _as_np(jcache).items()}
        start["length"] = int(jcache["length"])
        with torch.inference_mode():
            tcache, tlog = decode_step(tctx, params, start, torch.from_numpy(tok))
        jcache, jlog = jd(np_params, jcache, tok)
        assert tcache["length"] == int(jcache["length"])
        steps.append((np.asarray(jlog, np.float32), tlog.float().numpy(), _as_np(jcache),
                      _as_np(tcache)))
    return steps


def _caches_close(jcache, tcache):
    assert set(tcache) == set(jcache)
    for part in jcache:
        assert set(tcache[part]) == set(jcache[part]), part
        for name, want in jcache[part].items():
            got = tcache[part][name]
            what = f"{part}/{name}"
            assert got.shape == want.shape, what
            np.testing.assert_allclose(got, want, rtol=CACHE_RTOL, atol=CACHE_ATOL, err_msg=what)
            assert (got != want).mean() <= 0.01, what  # isolated rounding, not drift


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_prefill_and_decode_match_jax_fp32(arch, kernels):
    """Prefill logits and the whole cache (the prologue's ``"pro"`` and
    the main stack's, K/V or MLA's latent and RoPE key, zero-padded to
    the capacity), then decode steps from the JAX package's cache."""
    cap = PROMPT + STEPS
    steps = _run_both(arch, kernels, cap)
    cfg = REGISTRY[arch].reduced()
    want_keys = {"ckv", "krope"} if cfg.mla else {"k", "v"}
    assert set(steps[0][3]["main"]) == want_keys
    assert ("pro" in steps[0][3]) == (cfg.moe.first_moe_layer > 0)
    for step, (ref, out, jcache, tcache) in enumerate(steps):
        assert out.shape == ref.shape == (2, 1, VOCAB)
        np.testing.assert_allclose(out, ref, atol=ATOL, err_msg=f"{arch} step {step}")
        _caches_close(jcache, tcache)


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_ring_decode_matches_jax_fp32(arch):
    """A capacity of PROMPT alone: each step overwrites the oldest ring slot
    of every layer, prologue included, and masks by the slots' positions."""
    for step, (ref, out, jcache, tcache) in enumerate(_run_both(arch, False, PROMPT, seed=7)):
        np.testing.assert_allclose(out, ref, atol=ATOL, err_msg=f"{arch} step {step}")
        _caches_close(jcache, tcache)


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_prefill_matches_jax_bf16(arch):
    jctx, tctx = _ctxs(arch, True, "bfloat16")
    np_params = _np_params(arch)
    prompt = np.random.default_rng(6).integers(0, VOCAB, (2, PROMPT), dtype=np.int32)
    _, jlog = jax.jit(functools.partial(jax_prefill, jctx))(np_params, {"tokens": prompt})
    with torch.inference_mode():
        _, tlog = prefill(tctx, params_from_jax(np_params, "cpu"),
                          {"tokens": torch.from_numpy(prompt)})
    out = tlog.float().numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, np.asarray(jlog, np.float32), atol=BF16_ATOL)


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_greedy_generation_matches_jax_engine(arch):
    """Float32 compute, so no near-tie of two logits can flip an argmax: the
    serving engines of both packages give the same tokens."""
    jctx, tctx = _ctxs(arch, True)
    np_params = _np_params(arch)
    prompt = np.random.default_rng(9).integers(0, VOCAB, (2, 10), dtype=np.int32)
    ref = JaxEngine(jctx, np_params, batch_size=2, max_len=24).generate(prompt, 6)
    out = ServingEngine(tctx, params_from_jax(np_params, "cpu"), 2, 24).generate(prompt, 6)
    assert out.dtype == np.int32 and out.shape == (2, 6)
    np.testing.assert_array_equal(out, np.asarray(ref))
