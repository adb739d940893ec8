"""The port's configs, layers and attention paths against the JAX
package, on numpy inputs from a seed. Float32 throughout; tolerances
cover float32 reordering only (different BLAS/XLA summation orders)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import REGISTRY as JAX_REGISTRY
from repro.configs.runtime import RunConfig as JaxRunConfig
from repro.models import attention as jax_attention
from repro.models import layers as jax_layers
from repro_torch.configs.registry import REGISTRY
from repro_torch.configs.runtime import RunConfig
from repro_torch.models import attention as t_attention
from repro_torch.models import layers as t_layers
from repro_torch.models.transformer import ApplyCtx, param_specs, prefill

RNG_SEED = 11


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("arch", sorted(JAX_REGISTRY))
def test_configs_are_plain_copies(arch):
    a, b = JAX_REGISTRY[arch], REGISTRY[arch]
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert dataclasses.asdict(a.reduced()) == dataclasses.asdict(b.reduced())
    assert a.n_params() == b.n_params()


def test_run_config_dtypes():
    assert RunConfig().pdtype == torch.float32
    assert RunConfig().cdtype == torch.bfloat16
    assert RunConfig().use_kernels is JaxRunConfig().use_pallas is False


def test_rms_norm_swiglu_rope_match_jax():
    rng = np.random.default_rng(RNG_SEED)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)
    np.testing.assert_allclose(
        t_layers.rms_norm(_t(x), _t(w), 1e-5).numpy(),
        np.asarray(jax_layers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)),
        rtol=1e-5, atol=1e-6,
    )
    pos = rng.integers(0, 4000, size=(2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        t_layers.apply_rope(_t(x), _t(pos), 1e6).numpy(),
        np.asarray(jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        rtol=1e-4, atol=1e-4,
    )
    h = rng.normal(size=(2, 5, 16)).astype(np.float32)
    wg, wu = (rng.normal(size=(16, 24)).astype(np.float32) for _ in range(2))
    wd = rng.normal(size=(24, 16)).astype(np.float32)
    np.testing.assert_allclose(
        t_layers.swiglu(*(_t(a) for a in (h, wg, wu, wd))).numpy(),
        np.asarray(jax_layers.swiglu(*(jnp.asarray(a) for a in (h, wg, wu, wd)))),
        rtol=1e-4, atol=1e-4,
    )


def test_init_params_follows_specs():
    cfg = REGISTRY["qwen2.5-3b"].reduced()
    params = t_layers.init_params(param_specs(cfg), torch.Generator().manual_seed(0))
    assert params["layers"]["attn"]["wq"].shape == (2, 128, 128)
    assert torch.all(params["layers"]["attn"]["bq"] == 0)
    assert torch.all(params["layers"]["ln1"] == 1)
    std = params["layers"]["ffn"]["wg"].std().item()
    assert abs(std - 1 / np.sqrt(128)) < 0.01  # normal(0, 1/sqrt(fan_in))


def _qkv(rng, b, sq, skv, hq, hkv, d):
    q = rng.normal(size=(b, sq, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, skv, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, skv, hkv, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize(
    "sq,skv,window,threshold",
    [
        (1, 24, None, 2048),  # decode: direct path over a ring with empty slots
        (1, 24, 6, 2048),  # decode with a window
        (20, 20, None, 2048),  # short prefill: direct
        (20, 20, None, 8),  # long-sequence path: blocked (forced by threshold)
        (1, 24, None, 2),  # blocked with invalid (negative) slots
    ],
)
def test_attention_paths_match_jax(sq, skv, window, threshold):
    rng = np.random.default_rng(sq * 100 + skv)
    b, hq, hkv, d = 2, 4, 2, 16
    q, k, v = _qkv(rng, b, sq, skv, hq, hkv, d)
    if sq == 1:  # a decode step at position 17 over a 24-slot ring
        q_pos = np.full((b, 1), 17, np.int32)
        kv_pos = np.broadcast_to(17 - ((17 - np.arange(skv)) % skv), (b, skv))
    else:
        q_pos = np.broadcast_to(np.arange(sq, dtype=np.int32), (b, sq))
        kv_pos = q_pos
    kv_pos = np.ascontiguousarray(kv_pos, np.int32)
    jr = JaxRunConfig(attn_blocked_threshold=threshold, attn_block_q=8, attn_block_k=8)
    tr = RunConfig(attn_blocked_threshold=threshold, attn_block_q=8, attn_block_k=8)
    ref = jax_attention.attention(*(jnp.asarray(a) for a in (q, k, v, q_pos, kv_pos)),
                                  causal=True, window=window, rcfg=jr)
    out = t_attention.attention(*(_t(a) for a in (q, k, v, q_pos, kv_pos)),
                                causal=True, window=window, rcfg=tr)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "qwen3-moe-235b-a22b",
                                  "deepseek-v2-236b", "whisper-medium",
                                  "qwen2-vl-72b", "hymba-1.5b"])
def test_unported_branches_raise(arch):
    cfg = REGISTRY[arch].reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 1[23]"):
        param_specs(cfg)
    ctx = ApplyCtx(cfg, RunConfig())
    with pytest.raises(NotImplementedError):
        prefill(ctx, {}, {"tokens": torch.zeros((1, 4), dtype=torch.int32)})
