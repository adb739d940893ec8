"""The port's encoder-decoder path (Whisper-medium) against the JAX
package, on the reduced model (2 encoder and 2 decoder layers, d_model
128, 4 heads of 32, 16 encoder frames), the JAX initialiser's weights
carried over by ``params_from_jax`` with every constant leaf (LayerNorm
weights and biases, the attention and MLP biases) redrawn from a numpy
seed: the initialiser's ones and zeros would hide a bias or norm applied
to the wrong tensor. Inputs are normal draws, for the same reason.
The JAX side runs with ``use_pallas`` off and on (its Pallas kernel in
interpret mode), the port's with ``use_kernels`` off and on (the flash
kernel's plain version on the CPU): the encoder's bidirectional
attention and the cross attention (Sq = the prompt, Sk = the encoder's
frames) reach the kernel's call site.

Tolerances. The elementary ops in float32 within 1e-6 of their largest
magnitude; sin and cos are taken in float32 on both sides and may differ
by an ulp. At Whisper's 1500 encoder positions ``sinusoidal_pos`` is
held within 1e-6 + 1499 * 2^-23 instead: the two packages' float32
``exp`` give frequencies an ulp apart at some indices, and an ulp of the
frequency is up to 1499 * 2^-23 of the angle at position 1499 (the JAX
package's own jitted and eager forms differ by 1.2e-4 there). The model
in float32: outputs within 1e-5 of their largest magnitude; the bf16
caches at rtol 2^-7 (one bf16 ulp) plus atol 1e-5, with at most 1% of
their elements apart, since both packages round float32 values to the
bf16 cache and a value whose two float32 sources straddle a rounding
point lands an ulp apart; each decode step starts from the JAX
package's cache (``tests/test_torch_moe.py`` says why). In bf16
compute, logits within 2e-2 of their largest magnitude, as
``tests/test_torch_mla.py`` states it.
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
from repro.models import layers as jax_layers
from repro.models import prefill as jax_prefill
from repro.models import transformer as jax_transformer
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs.registry import REGISTRY
from repro_torch.configs.runtime import RunConfig
from repro_torch.launch.serve import serve
from repro_torch.models import ApplyCtx, decode_step, param_specs, prefill
from repro_torch.models import layers, transformer
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import ServingEngine

ARCH = "whisper-medium"
B, PROMPT, STEPS = 2, 12, 4
REL = 1e-5  # float32 model outputs, relative to the largest magnitude
OP_REL = 1e-6  # float32 elementary ops, relative to the largest magnitude
BF16_REL = 2e-2
CACHE_RTOL, CACHE_ATOL = 2.0**-7, 1e-5


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _close(got, want, rel, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max(), err_msg=what)


@functools.lru_cache(maxsize=None)
def drawn_params(arch, seed=0):
    """The reduced model's JAX parameters as numpy, every constant leaf
    (ones or zeros from the initialiser) redrawn: 1 + 0.1 N or 0.1 N."""
    cfg = JAX_REGISTRY[arch].reduced()
    params = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(seed), cfg, JaxRunConfig()))
    rng = np.random.default_rng(seed + 100)

    def redraw(a):
        if np.all(a == a.flat[0]):
            return (a.flat[0] + 0.1 * rng.normal(size=a.shape)).astype(a.dtype)
        return a

    return jax.tree.map(redraw, params)


def ctxs(arch, kernels, dtype="float32"):
    jctx = JaxCtx(JAX_REGISTRY[arch].reduced(),
                  JaxRunConfig(remat="none", moe_impl="dense", compute_dtype=dtype,
                               use_pallas=kernels), None)
    tctx = ApplyCtx(REGISTRY[arch].reduced(), RunConfig(compute_dtype=dtype, use_kernels=kernels))
    return jctx, tctx


def extras(cfg, seed=3, b=B):
    """Stub front-end inputs, normal(0, 1) from a numpy seed."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.is_encoder_decoder:
        out["enc_feats"] = rng.normal(size=(b, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    if cfg.n_vision_tokens:
        out["vision_embeds"] = rng.normal(size=(b, cfg.n_vision_tokens, cfg.d_model)).astype(
            np.float32)
    return out


def as_np(cache):
    return {p: {k: np.asarray(v.float() if isinstance(v, torch.Tensor) else v, np.float32)
                for k, v in cache[p].items()} for p in ("pro", "main") if p in cache}


def caches_close(jcache, tcache):
    assert set(tcache) == set(jcache)
    for part in jcache:
        assert set(tcache[part]) == set(jcache[part]), part
        for name, want in jcache[part].items():
            got, what = tcache[part][name], f"{part}/{name}"
            assert got.shape == want.shape, what
            np.testing.assert_allclose(got, want, rtol=CACHE_RTOL, atol=CACHE_ATOL, err_msg=what)
            assert (got != want).mean() <= 0.01, what  # isolated rounding, not drift


def run_both(arch, kernels, cap, seed=5):
    """Prefill PROMPT tokens (with the model's extras) in both packages,
    then STEPS decodes fed the same tokens, the port's each from the JAX
    package's cache of that step. Returns (jax, port) logits and caches
    per step."""
    jctx, tctx = ctxs(arch, kernels)
    np_params = drawn_params(arch)
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, tctx.cfg.vocab, (B, PROMPT), dtype=np.int32)
    feeds = rng.integers(0, tctx.cfg.vocab, (STEPS, B, 1), dtype=np.int32)
    batch = {"tokens": prompt, **extras(tctx.cfg)}
    params = params_from_jax(np_params, "cpu")
    jcache, jlog = jax.jit(functools.partial(jax_prefill, jctx, capacity=cap))(np_params, batch)
    with torch.inference_mode():
        tcache, tlog = prefill(tctx, params, {k: _t(v) if v.dtype != np.int32 else _t(v, torch.int32)
                                              for k, v in batch.items()}, capacity=cap)
    steps = [(np.asarray(jlog, np.float32), tlog.float().numpy(), as_np(jcache), as_np(tcache))]
    jd = jax.jit(functools.partial(jax_decode, jctx))
    for tok in feeds:
        start = {p: {k: _t(v, torch.bfloat16) for k, v in c.items()}
                 for p, c in as_np(jcache).items()}
        start["length"] = torch.tensor(int(jcache["length"]), dtype=torch.int32)
        with torch.inference_mode():
            tcache, tlog = decode_step(tctx, params, start, _t(tok, torch.int32))
        jcache, jlog = jd(np_params, jcache, tok)
        assert int(tcache["length"]) == int(jcache["length"])
        steps.append((np.asarray(jlog, np.float32), tlog.float().numpy(), as_np(jcache),
                      as_np(tcache)))
    return steps


def spec_tree(tree):
    if isinstance(tree, dict):
        return {k: spec_tree(v) for k, v in tree.items()}
    return (tuple(tree.shape), tuple(tree.axes), tree.init, tree.scale)


# ---------------------------------------------------------------------------
# Elementary ops
# ---------------------------------------------------------------------------


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = (3.0 + 2.0 * rng.normal(size=(2, 7, 48))).astype(np.float32)
    w, b = rng.normal(size=(2, 48)).astype(np.float32)
    _close(layers.layer_norm(_t(x), _t(w), _t(b), 1e-5),
           jax_layers.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-5),
           OP_REL, "layer_norm")
    out = layers.layer_norm(_t(x, torch.bfloat16), _t(w), _t(b), 1e-5)
    assert out.dtype == torch.bfloat16  # float32 inside, cast back


def test_gelu_mlp_matches_jax_tanh_form():
    """``jax.nn.gelu`` is the tanh form; the erf form differs by ~1e-3
    here, past ten times the bound, so the test tells the two apart."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    w1, w2 = rng.normal(size=(32, 64)).astype(np.float32), rng.normal(size=(64, 32)).astype(
        np.float32)
    b1, b2 = rng.normal(size=64).astype(np.float32), rng.normal(size=32).astype(np.float32)
    want = np.asarray(jax_layers.gelu_mlp(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2))))
    _close(layers.gelu_mlp(*(_t(a) for a in (x, w1, b1, w2, b2))), want, OP_REL, "gelu_mlp")
    h = _t(x) @ _t(w1) + _t(b1)
    erf = torch.nn.functional.gelu(h) @ _t(w2) + _t(b2)
    assert np.abs(erf.numpy() - want).max() > 10 * OP_REL * np.abs(want).max()


@pytest.mark.parametrize("n,d", [(16, 128), (1500, 1024)])
def test_sinusoidal_positions_table_matches_jax(n, d):
    _close(layers.sinusoidal_positions(n, d), jax_layers.sinusoidal_positions(n, d), OP_REL,
           "sinusoidal_positions")


def test_sinusoidal_pos_matches_jax():
    """At the reduced model's positions (the encoder's 16 frames, the
    decoder's prompt and steps), within 1e-6."""
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (B, 24))
    got = transformer.sinusoidal_pos(_t(pos, torch.int32), 128)
    assert got.dtype == torch.float32
    _close(got, jax_transformer.sinusoidal_pos(jnp.asarray(pos), 128), OP_REL, "sinusoidal_pos")


def test_sinusoidal_pos_at_whisper_frames():
    """Whisper's 1500 positions at d_model 1024: within 1e-6 + 1499 * 2^-23
    (module note), and equal to the float64 table within that too."""
    pos = np.arange(1500, dtype=np.int32)[None]
    got = transformer.sinusoidal_pos(_t(pos, torch.int32), 1024)
    tol = OP_REL + 1499 * 2.0**-23
    want = np.asarray(jax_transformer.sinusoidal_pos(jnp.asarray(pos), 1024))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    np.testing.assert_allclose(got.numpy()[0], layers.sinusoidal_positions(1500, 1024).numpy(),
                               rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
def test_param_specs_are_the_references(reduced):
    """Key for key: shape, axes, init and scale, the ``encoder`` subtree,
    the ``cross`` attention, ``ln_cross`` and every ``_b`` bias."""
    tcfg, jcfg = REGISTRY[ARCH], JAX_REGISTRY[ARCH]
    if reduced:
        tcfg, jcfg = tcfg.reduced(), jcfg.reduced()
    got = spec_tree(param_specs(tcfg))
    assert got == spec_tree(jax_transformer.param_specs(jcfg))
    assert set(got["layers"]) >= {"cross", "ln_cross", "ln_cross_b", "ln1_b", "ln2_b"}
    assert set(got["layers"]["ffn"]) == {"wg", "bg", "wd", "bd"}
    assert "cross" not in got["encoder"]["layers"] and "final_norm_b" in got["encoder"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernels", [False, True])
def test_encode_matches_jax(kernels, dtype):
    jctx, tctx = ctxs(ARCH, kernels, dtype)
    np_params = drawn_params(ARCH)
    feats = extras(tctx.cfg)["enc_feats"]
    jout, jpos = jax.jit(functools.partial(jax_transformer.encode, jctx))(np_params, feats)
    with torch.inference_mode():
        tout, tpos = transformer.encode(tctx, params_from_jax(np_params, "cpu"), _t(feats))
    assert tout.dtype == tctx.rcfg.cdtype
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    _close(tout, jout, REL if dtype == "float32" else BF16_REL, "encoder output")


@pytest.mark.parametrize("kernels", [False, True])
def test_prefill_and_decode_match_jax_fp32(kernels):
    """Prefill logits, the decoder's K/V (zero-padded to the capacity) and
    the cross attention's ``cross_k`` / ``cross_v``, then four decode
    steps, each from the JAX package's cache."""
    steps = run_both(ARCH, kernels, PROMPT + STEPS)
    assert set(steps[0][3]["main"]) == {"k", "v", "cross_k", "cross_v"}
    assert steps[0][3]["main"]["cross_k"].shape[2] == REGISTRY[ARCH].reduced().encoder_seq_len
    for step, (ref, out, jcache, tcache) in enumerate(steps):
        _close(out, ref, REL, f"logits, step {step}")
        caches_close(jcache, tcache)


def test_prefill_matches_jax_bf16():
    jctx, tctx = ctxs(ARCH, True, "bfloat16")
    np_params = drawn_params(ARCH)
    prompt = np.random.default_rng(6).integers(0, tctx.cfg.vocab, (B, PROMPT), dtype=np.int32)
    feats = extras(tctx.cfg, seed=7)["enc_feats"]
    _, jlog = jax.jit(functools.partial(jax_prefill, jctx))(
        np_params, {"tokens": prompt, "enc_feats": feats})
    with torch.inference_mode():
        _, tlog = prefill(tctx, params_from_jax(np_params, "cpu"),
                          {"tokens": _t(prompt, torch.int32), "enc_feats": _t(feats)})
    assert torch.isfinite(tlog).all()
    _close(tlog, jlog, BF16_REL, "bf16 prefill logits")


def test_greedy_generation_matches_jax_engine():
    """Float32 compute, so no near-tie of two logits can flip an argmax:
    the serving engines of both packages give the same tokens from the
    same prompt and encoder features."""
    jctx, tctx = ctxs(ARCH, True)
    np_params = drawn_params(ARCH)
    prompt = np.random.default_rng(9).integers(0, tctx.cfg.vocab, (B, 10), dtype=np.int32)
    ex = extras(tctx.cfg, seed=10)
    ref = JaxEngine(jctx, np_params, batch_size=B, max_len=24).generate(prompt, 6, ex)
    eng = ServingEngine(tctx, params_from_jax(np_params, "cpu"), B, 24)
    out = eng.generate(prompt, 6, ex)
    assert out.dtype == np.int32 and out.shape == (B, 6)
    np.testing.assert_array_equal(out, np.asarray(ref))
    other = eng.generate(prompt, 6, extras(tctx.cfg, seed=11))
    assert not np.array_equal(other, out)  # the encoder's features reach the decoder


def test_mismatched_enc_feats_raise():
    """A prefill whose ``enc_feats`` length differs from the pool entry's
    cross-attention cache raises before it writes, as an overflowing
    prompt does; a prefill without ``enc_feats`` raises too."""
    _, tctx = ctxs(ARCH, False)
    eng = ServingEngine(tctx, params_from_jax(drawn_params(ARCH), "cpu"), B, 20)
    k = eng.acquire()
    cache = eng.pool[k].cache
    before = {n: t.clone() for n, t in cache["main"].items()}
    prompt = np.zeros((B, 6), np.int32)
    enc_len = tctx.cfg.encoder_seq_len
    for frames in (enc_len - 1, enc_len + 1):
        feats = np.ones((B, frames, tctx.cfg.d_model), np.float32)
        with pytest.raises(ValueError, match="do not fit"):
            eng.prefill(prompt, {"enc_feats": feats}, entry=k)
    for n, t in cache["main"].items():
        assert torch.equal(t, before[n]), n
    assert int(cache["length"]) == 0
    with pytest.raises(ValueError, match="enc_feats"):
        eng.prefill(prompt, entry=k)
    # a new cache takes the features' own length
    cache, logits = eng.prefill(prompt, {"enc_feats": np.ones((B, enc_len + 3, tctx.cfg.d_model),
                                                              np.float32)})
    assert cache["main"]["cross_k"].shape[2] == enc_len + 3 and torch.isfinite(logits).all()


def test_serve_refuses_an_encoder_decoder_model():
    with pytest.raises(ValueError, match="encoder features"):
        serve(ARCH, requests=2, prompt_len=4, new_tokens=2, batch=2, reduced=True, device="cpu")
