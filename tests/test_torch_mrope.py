"""The port's M-RoPE path (Qwen2-VL-72B) against the JAX package, on the
reduced model (2 layers, d_model 128, 4 query heads over 2 KV heads of
32, ``mrope_sections`` (4, 6, 6), 8 vision tokens), with the JAX
initialiser's weights (every constant leaf redrawn) and normal inputs,
as ``tests/test_torch_whisper.py`` builds them, whose tolerances these
are: float32 ops within 1e-6 and model outputs within 1e-5 of their
largest magnitude, the bf16 caches within one bf16 ulp, bf16 logits
within 2e-2. The JAX side runs with ``use_pallas`` off and on (its
Pallas kernel in interpret mode), the port's with ``use_kernels`` off
and on.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_whisper import (
    B,
    BF16_REL,
    OP_REL,
    PROMPT,
    REL,
    _close,
    _t,
    caches_close,
    ctxs,
    drawn_params,
    extras,
    run_both,
    spec_tree,
)

from repro.configs.registry import REGISTRY as JAX_REGISTRY
from repro.models import layers as jax_layers
from repro.models import prefill as jax_prefill
from repro.models import transformer as jax_transformer
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs.registry import REGISTRY
from repro_torch.launch.serve import serve
from repro_torch.models import param_specs, prefill
from repro_torch.models import layers, transformer
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import ServingEngine

ARCH = "qwen2-vl-72b"


@pytest.mark.parametrize("b,s,n_vision,offset", [(2, 24, 8, 0), (3, 600, 256, 0),
                                                 (2, 40, 0, 5), (1, 20, 20, 2)])
def test_build_mrope_positions_matches_jax(b, s, n_vision, offset):
    want = np.asarray(jax_transformer.build_mrope_positions(b, s, n_vision, offset))
    got = transformer.build_mrope_positions(b, s, n_vision, offset)
    assert got.dtype == torch.int32 and got.shape == (3, b, s)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("d,theta,sections,s,n_vision", [
    (32, 1e6, (4, 6, 6), 24, 8),  # the reduced model
    (128, 1e6, (16, 24, 24), 600, 256),  # Qwen2-VL-72B's head and sections
])
def test_apply_mrope_matches_jax(d, theta, sections, s, n_vision):
    """Each section rotates by its own position row: the vision span's h
    and w rows differ, so a section that read the other row fails."""
    rng = np.random.default_rng(d)
    x = rng.normal(size=(2, s, 3, d)).astype(np.float32)
    pos = np.asarray(jax_transformer.build_mrope_positions(2, s, n_vision))
    want = np.asarray(jax_layers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), theta, sections))
    got = layers.apply_mrope(_t(x), _t(pos, torch.int32), theta, sections)
    _close(got, want, OP_REL, "apply_mrope")
    swapped = layers.apply_mrope(_t(x), _t(pos[[0, 2, 1]], torch.int32), theta, sections)
    assert np.abs(swapped.numpy() - want).max() > 1e3 * OP_REL * np.abs(want).max()
    assert layers.apply_mrope(_t(x, torch.bfloat16), _t(pos, torch.int32), theta,
                              sections).dtype == torch.bfloat16


def test_apply_mrope_refuses_sections_that_miss_frequencies():
    with pytest.raises(ValueError, match="sections"):
        layers.apply_mrope(torch.zeros((1, 2, 1, 32)), torch.zeros((3, 1, 2), dtype=torch.int32),
                           1e6, (4, 6, 4))


@pytest.mark.parametrize("reduced", [False, True])
def test_param_specs_are_the_references(reduced):
    tcfg, jcfg = REGISTRY[ARCH], JAX_REGISTRY[ARCH]
    if reduced:
        tcfg, jcfg = tcfg.reduced(), jcfg.reduced()
    got = spec_tree(param_specs(tcfg))
    assert got == spec_tree(jax_transformer.param_specs(jcfg))
    assert "bq" in got["layers"]["attn"] and "encoder" not in got


@pytest.mark.parametrize("kernels", [False, True])
def test_prefill_and_decode_match_jax_fp32(kernels):
    """Prefill with ``vision_embeds`` over the first 8 positions: logits
    and the K/V cache, then four decode steps at t - 8 + 1 on every
    position row, each from the JAX package's cache."""
    steps = run_both(ARCH, kernels, PROMPT + 4)
    assert set(steps[0][3]["main"]) == {"k", "v"}
    for step, (ref, out, jcache, tcache) in enumerate(steps):
        _close(out, ref, REL, f"logits, step {step}")
        caches_close(jcache, tcache)


def test_vision_embeds_replace_the_first_rows():
    """The vision embeds replace exactly the first n_vision_tokens rows of
    the embeddings: changing them moves the logits, changing the token ids
    under them does not."""
    _, tctx = ctxs(ARCH, False)
    params = params_from_jax(drawn_params(ARCH), "cpu")
    tok = np.random.default_rng(1).integers(0, tctx.cfg.vocab, (B, PROMPT), dtype=np.int32)
    nv = tctx.cfg.n_vision_tokens

    def logits(tokens, seed):
        batch = {"tokens": _t(tokens, torch.int32),
                 "vision_embeds": _t(extras(tctx.cfg, seed)["vision_embeds"])}
        with torch.inference_mode():
            return prefill(tctx, params, batch)[1]

    base = logits(tok, 3)
    under = tok.copy()
    under[:, :nv] = (under[:, :nv] + 1) % tctx.cfg.vocab
    assert torch.equal(logits(under, 3), base)
    assert not torch.allclose(logits(tok, 4), base)


def test_prefill_matches_jax_bf16():
    jctx, tctx = ctxs(ARCH, True, "bfloat16")
    np_params = drawn_params(ARCH)
    prompt = np.random.default_rng(6).integers(0, tctx.cfg.vocab, (B, PROMPT), dtype=np.int32)
    ve = extras(tctx.cfg, seed=7)["vision_embeds"]
    _, jlog = jax.jit(functools.partial(jax_prefill, jctx))(
        np_params, {"tokens": prompt, "vision_embeds": ve})
    with torch.inference_mode():
        _, tlog = prefill(tctx, params_from_jax(np_params, "cpu"),
                          {"tokens": _t(prompt, torch.int32), "vision_embeds": _t(ve)})
    assert torch.isfinite(tlog).all()
    _close(tlog, jlog, BF16_REL, "bf16 prefill logits")


def test_greedy_generation_matches_jax_engine():
    jctx, tctx = ctxs(ARCH, True)
    np_params = drawn_params(ARCH)
    prompt = np.random.default_rng(9).integers(0, tctx.cfg.vocab, (B, 12), dtype=np.int32)
    ex = extras(tctx.cfg, seed=10)
    ref = JaxEngine(jctx, np_params, batch_size=B, max_len=24).generate(prompt, 6, ex)
    out = ServingEngine(tctx, params_from_jax(np_params, "cpu"), B, 24).generate(prompt, 6, ex)
    assert out.dtype == np.int32 and out.shape == (B, 6)
    np.testing.assert_array_equal(out, np.asarray(ref))


def test_serve_runs_text_only():
    """The runtime serves the M-RoPE model text-only, as the reference's:
    token embeddings at the vision positions, decode through the pool."""
    m = serve(ARCH, requests=4, prompt_len=12, new_tokens=3, batch=2, concurrency=2,
              reduced=True, device="cpu")
    assert m["requests"] == 4 and m["pool_entries"] == 2 and m["graph_captures"] == 0


def test_vision_embeds_longer_than_the_prompt_raise():
    _, tctx = ctxs(ARCH, False)
    nv = tctx.cfg.n_vision_tokens
    batch = {"tokens": torch.zeros((B, nv - 1), dtype=torch.int32),
             "vision_embeds": _t(extras(tctx.cfg)["vision_embeds"])}
    with pytest.raises(ValueError, match="vision embeds do not fit"):
        prefill(tctx, params_from_jax(drawn_params(ARCH), "cpu"), batch)
