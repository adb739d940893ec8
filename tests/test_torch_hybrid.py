"""The port's hybrid slice (the hybrid branch of ``models/transformer.py``,
``models/attention.py::_blocked_swa`` and the serving path of Hymba-1.5B)
against the JAX package, with the JAX model's weights carried over by
``params_from_jax``.

The model. ``reduced()`` Hymba has two layers, and ``layer_windows`` makes
layers {0, n // 2, n - 1} global, so both would be global and no layer
would slide its window. Both packages' configs are therefore built with
``dataclasses.replace(reduced, n_layers=4)``: layers 0, 2 and 3 are global,
layer 1 attends over a window of 16. A prompt of 24 is longer than that
window, and 12 decode steps run past it.

Parameters. The JAX initialiser sets A_log = 1, dt_bias = 0, norm_w = 1
and mix_gate = 1 everywhere; the tests draw them from a seeded numpy
generator (A_log = log U(1, 16) and dt_bias = U(-4, -1), Mamba2's own
ranges; norm_w = U(0.5, 1.5); mix_gate ~ N(0, 1)), so every head decays at
its own rate and the two halves of a layer are mixed unequally.

Decode. Both packages keep every cache in bf16, and an element whose two
float32 sources straddle a rounding point lands one ulp apart. Run freely,
each package decoding from its own cache, those ulps compound: over 12
steps past the window 4.8% of the ``ssm`` cache's elements end one ulp
apart and the decode logits 2.2e-3 apart (kernels off), beyond the Mamba2
slice's 1e-3, while the prefill caches differ in 0.1% of their elements.
So every decode step here starts from the JAX package's own cache (bf16
values, exact in both): each step is held alone, with no compounding.
From one cache the two steps still differ by more than float32 summation
order: each writes its own new K/V into the bf16 cache and attends over
it. Where the two packages' float32 values of one element straddle a bf16
rounding point, that element lands one ulp apart inside the step, and its
effect runs through the later layers (ring decode, seed 7: one element of
layer 1's new V one ulp apart at decode step 4 moved the logits 1.28e-4,
every other step 2e-6 to 1.3e-5). Which step straddles depends on the
host's float32 summation order.

Tolerances are the Mamba2 slice's (tests/test_torch_ssm.py), float32
compute: prefill logits atol 1e-4; a decode step's logits atol 1e-4 where
the K/V it wrote (slot ``t % capacity`` of every layer) equal the JAX
package's bit for bit, and else the Mamba2 slice's decode 1e-3 (a step
that reads a cache element of its own), once every differing element of
the first layer whose new K/V differ is exactly one bf16 ulp from the JAX
package's: a straddle. Later layers carry its effect and may differ by
more in elements near 0 (capacity 36: a 1e-4 element of layer 3's new K
4 ulps apart after one of layer 1's 1 ulp apart). The K/V, ``ssm`` and
``conv`` caches after prefill and after each step at rtol 2^-7 (one bf16
ulp) plus atol 1e-5, or, after a straddle, plus the decode logits' 1e-3
(the ring's step 4 moved ``conv`` 3.6e-5 and K 1.3e-5 past one ulp), with
at most 1% of their elements apart at all.
``_blocked_swa`` against the reference's at rtol 1e-5 / atol 2e-5, as the
other attention paths (tests/test_torch_models.py).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import REGISTRY as JAX_REGISTRY
from repro.configs.runtime import RunConfig as JaxRunConfig
from repro.models import ApplyCtx as JaxCtx
from repro.models import attention as jax_attention
from repro.models import decode_step as jax_decode
from repro.models import init_model_params as jax_init
from repro.models import prefill as jax_prefill
from repro.models import transformer as jax_transformer
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs.registry import REGISTRY
from repro_torch.configs.runtime import RunConfig
from repro_torch.launch.serve import serve
from repro_torch.models import ApplyCtx, decode_step, param_specs, prefill
from repro_torch.models import attention as t_attention
from repro_torch.models import transformer
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import ServingEngine

ARCH = "hymba-1.5b"
N_LAYERS = 4  # globals {0, 2, 3}; layer 1 on the window (module note)
VOCAB = 512  # reduced() clamps hymba-1.5b's vocab to this
PROMPT, STEPS = 24, 12
ATOL = 1e-4
DECODE_ATOL = 1e-3  # a step whose own new K/V landed a bf16 ulp apart (module note)
CACHE_RTOL, CACHE_ATOL = 2.0**-7, 1e-5


def _cfg(registry):
    return dataclasses.replace(registry[ARCH].reduced(), n_layers=N_LAYERS)


def hymba_np_params(seed: int = 0) -> dict:
    """4-layer reduced Hymba parameters from the JAX initialiser, as numpy,
    with A_log, dt_bias, norm_w and mix_gate drawn (module note)."""
    params = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(seed), _cfg(JAX_REGISTRY),
                                               JaxRunConfig()))
    lp = params["layers"]
    sp = lp["ssm"]
    rng = np.random.default_rng(seed)
    sp["A_log"] = np.log(rng.uniform(1, 16, sp["A_log"].shape)).astype(np.float32)
    sp["dt_bias"] = rng.uniform(-4, -1, sp["dt_bias"].shape).astype(np.float32)
    sp["norm_w"] = rng.uniform(0.5, 1.5, sp["norm_w"].shape).astype(np.float32)
    lp["mix_gate"] = rng.normal(size=lp["mix_gate"].shape).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def np_params():
    return hymba_np_params()


def _ctxs(kernels, compute_dtype="float32"):
    """Both packages' contexts: float32 compute, the kernel path on or off
    (the JAX side runs its Pallas kernels in interpret mode on the CPU)."""
    jctx = JaxCtx(_cfg(JAX_REGISTRY),
                  JaxRunConfig(remat="none", moe_impl="dense", compute_dtype=compute_dtype,
                               use_pallas=kernels))
    tctx = ApplyCtx(_cfg(REGISTRY), RunConfig(compute_dtype=compute_dtype, use_kernels=kernels))
    return jctx, tctx


def test_the_test_model_slides_one_window():
    cfg = _cfg(REGISTRY)
    assert transformer.layer_windows(cfg) == [None, 16, None, None]
    assert transformer.layer_windows(cfg) == jax_transformer.layer_windows(
        _cfg(JAX_REGISTRY), N_LAYERS)
    assert cfg.ssm.d_state == 16 and PROMPT > cfg.sliding_window


def test_params_from_jax_carries_the_hybrid_tree(np_params):
    """The port's spec tree, key for key: attention and Mamba2 side by side
    in each layer, with a (layers, 2) mixing gate of ones."""
    specs = param_specs(_cfg(REGISTRY))
    p = params_from_jax(np_params, "cpu")
    assert set(p["layers"]) == set(specs["layers"]) == {
        "ln1", "attn", "ssm", "mix_gate", "ln2", "ffn"}
    assert specs["layers"]["mix_gate"].shape == (N_LAYERS, 2)
    assert specs["layers"]["mix_gate"].init == "ones"
    assert set(p["layers"]["ssm"]) == set(specs["layers"]["ssm"])
    np.testing.assert_array_equal(p["layers"]["mix_gate"].numpy(), np_params["layers"]["mix_gate"])


def _as_np(cache):
    return {k: np.asarray(v, np.float32) for k, v in cache.items()}


def _run_both(np_params, kernels, cap, n_steps=STEPS, seed=5):
    """Prefill a prompt of PROMPT in both packages, then ``n_steps`` decodes
    fed the same numpy-drawn tokens, the port's each from the JAX package's
    cache of that step (module note). Returns the (jax, port) logits and
    caches after prefill and after each step."""
    jctx, tctx = _ctxs(kernels)
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, VOCAB, (2, PROMPT), dtype=np.int32)
    feeds = rng.integers(0, VOCAB, (n_steps, 2, 1), dtype=np.int32)
    jp = jax.jit(functools.partial(jax_prefill, jctx, capacity=cap))
    jd = jax.jit(functools.partial(jax_decode, jctx))
    params = params_from_jax(np_params, "cpu")
    jcache, jlog = jp(np_params, {"tokens": prompt})
    with torch.inference_mode():
        tcache, tlog = prefill(tctx, params, {"tokens": torch.from_numpy(prompt)}, capacity=cap)
    steps = [(np.asarray(jlog, np.float32), tlog.float().numpy(),
              _as_np(jcache["main"]), _as_np({k: v.float() for k, v in tcache["main"].items()}))]
    for tok in feeds:
        start = {"main": {k: torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16)
                          for k, v in jcache["main"].items()},
                 "length": int(jcache["length"])}
        with torch.inference_mode():
            tcache, tlog = decode_step(tctx, params, start, torch.from_numpy(tok))
        jcache, jlog = jd(np_params, jcache, tok)
        assert tcache["length"] == int(jcache["length"])
        steps.append((np.asarray(jlog, np.float32), tlog.float().numpy(),
                      _as_np(jcache["main"]),
                      _as_np({k: v.float() for k, v in tcache["main"].items()})))
    assert int(jcache["length"]) == PROMPT + n_steps
    return steps


def _caches_close(jcache, tcache, cap, atol=CACHE_ATOL):
    cfg = _cfg(REGISTRY)
    s = cfg.ssm
    nh = s.n_ssm_heads(cfg.d_model)
    shapes = {
        "k": (N_LAYERS, 2, cap, cfg.n_kv_heads, cfg.resolved_head_dim),
        "v": (N_LAYERS, 2, cap, cfg.n_kv_heads, cfg.resolved_head_dim),
        "ssm": (N_LAYERS, 2, nh, s.headdim, s.d_state),
        "conv": (N_LAYERS, 2, s.d_conv - 1, s.inner(cfg.d_model) + 2 * s.d_state),
    }
    assert set(tcache) == set(jcache) == set(shapes)  # K/V and the Mamba2 states
    for name, shape in shapes.items():
        got, want = tcache[name], jcache[name]
        assert got.shape == want.shape == shape, name
        np.testing.assert_allclose(got, want, rtol=CACHE_RTOL, atol=atol, err_msg=name)
        assert (got != want).mean() <= 0.01, name  # isolated rounding, not drift


def _bf16_ulps(got, want):
    """Elementwise distance in bf16 ulps of two arrays of bf16 values held
    as float32 (the bf16 bits ordered as integers, sign and magnitude)."""
    def order(a):
        bits = (np.ascontiguousarray(a, np.float32).view(np.uint32) >> 16).astype(np.int64)
        return np.where(bits & 0x8000, -(bits & 0x7FFF), bits)

    return np.abs(order(got) - order(want))


def _hold_to_jax(steps, cap):
    """The prefill and each decode step of ``_run_both`` against the JAX
    package: logits and caches, a decode step's by what it wrote (module
    note)."""
    for step, (ref, out, jcache, tcache) in enumerate(steps):
        assert out.shape == ref.shape == (2, 1, VOCAB)
        atol, cache_atol = ATOL, CACHE_ATOL
        if step:
            slot = (PROMPT + step - 1) % cap
            ulps = np.stack([_bf16_ulps(tcache[n][:, :, slot], jcache[n][:, :, slot])
                             for n in ("k", "v")], axis=1)  # (layers, k|v, B, heads, hd)
            apart = [layer for layer in range(N_LAYERS) if ulps[layer].any()]
            if apart:
                worst = ulps[apart[0]].max()
                assert worst == 1, f"step {step}: layer {apart[0]}'s new K/V {worst} bf16 ulps apart"
                atol = cache_atol = DECODE_ATOL
        np.testing.assert_allclose(out, ref, atol=atol, err_msg=f"step {step}")
        _caches_close(jcache, tcache, cap, cache_atol)


@pytest.mark.parametrize("kernels", [False, True])
def test_prefill_and_decode_match_jax_fp32(np_params, kernels):
    """A capacity of PROMPT + STEPS: every position stays in the cache, so
    the global layers see all of it and layer 1 masks by its window."""
    _hold_to_jax(_run_both(np_params, kernels, PROMPT + STEPS), PROMPT + STEPS)


def test_ring_decode_matches_jax_fp32(np_params):
    """A capacity of PROMPT alone: each decode step overwrites the oldest
    ring slot (``t % W``), in every layer over the one cache width, and
    masks by ``_ring_kv_pos`` as the reference does."""
    _hold_to_jax(_run_both(np_params, False, PROMPT, n_steps=6, seed=7), PROMPT)


def test_greedy_generation_matches_jax_engine(np_params):
    """Float32 compute, so no near-tie of two logits can flip an argmax: the
    serving engines of both packages give the same tokens."""
    jctx, tctx = _ctxs(True)
    prompt = np.random.default_rng(9).integers(0, VOCAB, (2, 20), dtype=np.int32)
    ref = JaxEngine(jctx, np_params, batch_size=2, max_len=40).generate(prompt, 8)
    out = ServingEngine(tctx, params_from_jax(np_params, "cpu"), 2, 40).generate(prompt, 8)
    assert out.dtype == np.int32 and out.shape == (2, 8)
    np.testing.assert_array_equal(out, np.asarray(ref))


def test_weights_cast_once_keep_the_gate_float32(np_params):
    """The engine casts weights to bf16 at load but keeps what the reference
    reads in float32 (here the mixing gate too), so its prefill equals the
    model's on float32 weights cast at use, bit for bit."""
    _, tctx = _ctxs(True, "bfloat16")
    params = params_from_jax(np_params, "cpu")
    eng = ServingEngine(tctx, params, 2, 32)
    lp = eng.params["layers"]
    assert lp["attn"]["wq"].dtype == lp["ssm"]["in_proj"].dtype == torch.bfloat16
    for t in (lp["mix_gate"], lp["ssm"]["A_log"], lp["ssm"]["dt_bias"], lp["ssm"]["norm_w"]):
        assert t.dtype == torch.float32
    prompt = np.arange(2 * PROMPT, dtype=np.int32).reshape(2, PROMPT) % VOCAB
    _, logits = eng.prefill(prompt)
    with torch.inference_mode():
        _, at_use = prefill(tctx, params, {"tokens": torch.from_numpy(prompt)}, capacity=32)
    assert torch.equal(logits, at_use)


def test_serve_hymba_reduced_on_cpu():
    m = serve(ARCH, requests=3, prompt_len=20, new_tokens=3, batch=2,
              concurrency=2, reduced=True, device="cpu")
    assert m["requests"] == 3 and m["throughput_tok_s"] > 0


# (b, s, hq, hkv, d, window, block_q, block_k): whole tiles, a ragged tail,
# block_q != block_k, a window wider than a tile, a tiny window, GQA group 5
SWA_CASES = [
    (2, 40, 4, 2, 16, 12, 8, 8),
    (2, 37, 4, 2, 16, 12, 8, 8),
    (1, 50, 4, 1, 16, 6, 16, 8),
    (1, 64, 2, 2, 16, 40, 8, 16),
    (1, 30, 4, 2, 16, 3, 8, 8),
    (1, 45, 10, 2, 16, 16, 8, 8),
]


@pytest.mark.parametrize("b,s,hq,hkv,d,window,bq,bk", SWA_CASES)
def test_blocked_swa_matches_jax(monkeypatch, b, s, hq, hkv, d, window, bq, bk):
    """A sliding-window prefill above a lowered ``attn_blocked_threshold``
    takes ``_blocked_swa`` in both packages, with the same output."""
    rng = np.random.default_rng(s * 10 + window)
    q = rng.normal(size=(b, s, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    calls = []

    def spy(module):
        real = module._blocked_swa

        def counted(*args, **kw):
            calls.append(module.__name__)
            return real(*args, **kw)

        monkeypatch.setattr(module, "_blocked_swa", counted)

    spy(jax_attention)
    spy(t_attention)
    kw = dict(attn_blocked_threshold=4, attn_block_q=bq, attn_block_k=bk)
    ref = jax_attention.attention(*(jnp.asarray(a) for a in (q, k, v, pos, pos)),
                                  causal=True, window=window, rcfg=JaxRunConfig(**kw))
    out = t_attention.attention(*(torch.from_numpy(a) for a in (q, k, v, pos, pos)),
                                causal=True, window=window, rcfg=RunConfig(**kw))
    assert calls == [jax_attention.__name__, t_attention.__name__]
    assert out.shape == (b, s, hq, d)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=2e-5)
    # and the same function as the masked blocked path over every key tile
    full = t_attention._blocked(
        torch.from_numpy(q).reshape(b, s, hkv, hq // hkv, d), *(torch.from_numpy(a) for a in
                                                                (k, v, pos, pos)),
        True, window, 1.0 / np.sqrt(d), bq, bk)
    np.testing.assert_allclose(out.numpy(), full.reshape(b, s, hq, d).numpy(),
                               rtol=1e-5, atol=2e-5)
