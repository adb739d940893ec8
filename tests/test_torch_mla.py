"""The port's Multi-head Latent Attention (``models/mla.py``) against the
JAX package's, on reduced DeepSeek-V2-236B (128 heads cut to 4, D =
qk_nope + qk_rope = 32, Dv = 16), with layer 0's attention weights from
the JAX initialiser carried over by ``params_from_jax`` and inputs from a
numpy seed. The whole model (prologue, MoE, caches, decode) is held in
``tests/test_torch_moe.py``.

Tolerances. Float32 compute: outputs within 1e-5 of their largest
magnitude (summation order only), the latent and the rotated RoPE key at
rtol 1e-5; ``mla_decode`` works in float32 in both packages whatever the
compute dtype. Bfloat16 compute: the projections in bf16 on both sides,
rounded at other places by XLA's and PyTorch's CPU kernels, so outputs
within 2e-2 of their largest magnitude (a few bf16 ulps, 2^-8 relative,
over the chain of products), as ``tests/test_torch_moe.py`` holds the FFN.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import REGISTRY as JAX_REGISTRY
from repro.configs.runtime import RunConfig as JaxRunConfig
from repro.models import init_model_params as jax_init
from repro.models import mla as jax_mla
from repro_torch.configs.registry import REGISTRY
from repro_torch.configs.runtime import RunConfig
from repro_torch.models import mla
from repro_torch.models.convert import params_from_jax

ARCH = "deepseek-v2-236b"
B, S, W = 2, 20, 24  # decode: a 24-slot ring holding positions 0..19, then the new token
REL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def attn_params():
    """Layer 0's MLA weights as numpy, with q_norm and kv_norm drawn (the
    initialiser's ones would hide a norm applied to the wrong tensor)."""
    cfg = JAX_REGISTRY[ARCH].reduced()
    params = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0), cfg, JaxRunConfig()))
    ap = {k: v[0] for k, v in params["layers"]["attn"].items()}
    rng = np.random.default_rng(2)
    for name in ("q_norm", "kv_norm"):
        ap[name] = rng.uniform(0.5, 1.5, ap[name].shape).astype(np.float32)
    return ap


def _cfgs():
    return JAX_REGISTRY[ARCH].reduced(), REGISTRY[ARCH].reduced()


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _close(got, want, rel, what):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max(), err_msg=what)


def test_reduced_shapes_take_dv_unequal_d():
    _, cfg = _cfgs()
    m = cfg.mla
    assert cfg.n_heads == 4 and m.qk_nope_head_dim + m.qk_rope_head_dim == 32
    assert m.v_head_dim == 16 and m.kv_lora_rank == 32


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_full_matches_jax(attn_params, dtype, kernels):
    """The prefill form, through the direct path or the flash kernel's
    call site (its plain version on the CPU; the JAX package's Pallas
    kernel in interpret mode), and the cached latent and RoPE key."""
    jcfg, tcfg = _cfgs()
    jdt, tdt = DTYPES[dtype]
    x = np.random.default_rng(4).normal(size=(B, S, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jout, (jlat, jkr) = jax_mla.mla_full(
        jcfg, jax.tree.map(jnp.asarray, attn_params), jnp.asarray(x, jdt), jnp.asarray(pos),
        JaxRunConfig(compute_dtype=dtype, use_pallas=kernels))
    tout, (tlat, tkr) = mla.mla_full(
        tcfg, params_from_jax(attn_params, "cpu"), _t(x, tdt), _t(pos),
        RunConfig(compute_dtype=dtype, use_kernels=kernels))
    assert tout.dtype == tdt
    for got, want, what in ((tout, jout, "out"), (tlat, jlat, "latent"), (tkr, jkr, "k_rope")):
        _close(got, want, REL[dtype], what)


def test_mla_full_passes_v_as_a_strided_view(attn_params, monkeypatch):
    """V is the Dv half of the expanded (B, S, H, dn + Dv) tensor, read in
    place: its row stride is H (dn + Dv), so the kernel takes it strided."""
    _, cfg = _cfgs()
    m = cfg.mla
    seen = {}
    attention = mla.attention

    def spy(q, k, v, *a, **kw):
        seen.update(q=q.shape, k=k.shape, v=v.shape, v_stride=v.stride())
        return attention(q, k, v, *a, **kw)

    monkeypatch.setattr(mla, "attention", spy)
    x = torch.zeros((B, S, cfg.d_model))
    pos = torch.arange(S, dtype=torch.int32).expand(B, S)
    mla.mla_full(cfg, params_from_jax(attn_params, "cpu"), x, pos, RunConfig())
    h, dqk = cfg.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim
    assert seen["q"] == seen["k"] == (B, S, h, dqk)
    assert seen["v"] == (B, S, h, m.v_head_dim)
    assert seen["v_stride"] == (S * h * (m.qk_nope_head_dim + m.v_head_dim),
                                h * (m.qk_nope_head_dim + m.v_head_dim),
                                m.qk_nope_head_dim + m.v_head_dim, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_matches_jax(attn_params, dtype):
    """The absorbed one-token form over a ring of W slots: positions 0..19
    written, the new token at 20 in slot 20, slots 21..23 unwritten
    (negative positions, masked)."""
    jcfg, tcfg = _cfgs()
    m = tcfg.mla
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, 1, tcfg.d_model)).astype(np.float32)
    lat = rng.normal(size=(B, W, m.kv_lora_rank)).astype(np.float32)
    kr = rng.normal(size=(B, W, m.qk_rope_head_dim)).astype(np.float32)
    pos = np.full((B, 1), S, np.int32)
    kv_pos = np.broadcast_to(S - ((S - np.arange(W)) % W), (B, W)).astype(np.int32)
    assert (kv_pos < 0).sum() == B * (W - S - 1)
    jout = jax_mla.mla_decode(jcfg, jax.tree.map(jnp.asarray, attn_params), jnp.asarray(x, jdt),
                              jnp.asarray(pos), jnp.asarray(lat, jdt), jnp.asarray(kr, jdt),
                              jnp.asarray(kv_pos))
    tout = mla.mla_decode(tcfg, params_from_jax(attn_params, "cpu"), _t(x, tdt), _t(pos),
                          _t(lat, tdt), _t(kr, tdt), _t(kv_pos))
    assert tout.dtype == tdt and tout.shape == (B, 1, tcfg.d_model)
    _close(tout, jout, REL[dtype], "out")


def test_mla_decode_ignores_masked_slots(attn_params):
    """Whatever an unwritten slot holds (an earlier group's latent in a
    reused cache), it is masked: the output is that of zeros there."""
    _, cfg = _cfgs()
    m = cfg.mla
    rng = np.random.default_rng(6)
    x = _t(rng.normal(size=(B, 1, cfg.d_model)))
    lat = _t(rng.normal(size=(B, W, m.kv_lora_rank)))
    kr = _t(rng.normal(size=(B, W, m.qk_rope_head_dim)))
    pos = torch.full((B, 1), 5, dtype=torch.int32)
    kv_pos = torch.arange(W, dtype=torch.int32).expand(B, W) - (W - 6)  # slots 18..23 hold 0..5
    ap = params_from_jax(attn_params, "cpu")
    clean_lat, clean_kr = lat.clone(), kr.clone()
    clean_lat[:, : W - 6] = 0
    clean_kr[:, : W - 6] = 0
    torch.testing.assert_close(mla.mla_decode(cfg, ap, x, pos, lat, kr, kv_pos),
                               mla.mla_decode(cfg, ap, x, pos, clean_lat, clean_kr, kv_pos),
                               rtol=0, atol=0)
