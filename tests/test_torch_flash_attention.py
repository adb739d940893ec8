"""The port's flash attention (``repro_torch.kernels.flash_attention``)
against the JAX package's Pallas kernel, run as tests/test_kernels.py runs
it on the CPU (interpret mode), over the same sweep.

On the CPU the port's wrapper takes its plain version (``attention_ref``);
the CUDA kernel itself is held to it on the card by
tests/test_torch_kernels_gpu.py and by chip_smoke.py. Tolerances are the
reference's: atol 2e-5 in float32, 3e-2 in bfloat16 (one bf16 rounding
of outputs of magnitude <= ~2).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_bhsd as jax_flash
from repro_torch.kernels import runtime
from repro_torch.kernels.flash_attention import (
    attention_ref,
    body_for,
    body_launches,
    flash_attention,
    flash_attention_bhsd,
)

SWEEP = [
    (1, 2, 2, 64, 32, 32, True, None),
    (2, 4, 2, 96, 32, 32, True, None),  # GQA
    (1, 4, 1, 128, 16, 16, True, 24),  # MQA + sliding window
    (2, 2, 2, 80, 32, 32, False, None),  # bidirectional
    (1, 8, 2, 72, 64, 64, True, 16),
    (1, 4, 2, 70, 32, 32, True, None),  # unpadded tail
    (2, 4, 2, 48, 32, 64, True, None),  # Dv != D
]
TORCH_DT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _inputs(seed, b, hq, hkv, s, d, dv):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, s, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, dv)).astype(np.float32)
    return q, k, v


def _jax(q, k, v, dtype, **kw):
    out = jax_flash(*(jnp.asarray(a, dtype) for a in (q, k, v)),
                    block_q=32, block_k=32, **kw)
    return np.asarray(out, np.float32)


def _torch(a, dtype):
    return torch.from_numpy(a).to(TORCH_DT[dtype])


@pytest.mark.parametrize("b,hq,hkv,s,d,dv,causal,window", SWEEP)
def test_flash_attention_matches_jax(b, hq, hkv, s, d, dv, causal, window):
    q, k, v = _inputs(s, b, hq, hkv, s, d, dv)
    ref = _jax(q, k, v, jnp.float32, causal=causal, window=window)
    tq, tk, tv = (_torch(a, jnp.float32) for a in (q, k, v))
    for fn in (attention_ref, flash_attention_bhsd):
        out = fn(tq, tk, tv, causal=causal, window=window)
        assert out.shape == (b, hq, s, dv) and out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), ref, atol=2e-5)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_flash_attention_dtypes_match_jax(dtype):
    q, k, v = _inputs(1, 1, 2, 2, 64, 32, 32)
    ref = _jax(q, k, v, dtype)
    out = flash_attention_bhsd(*(_torch(a, dtype) for a in (q, k, v)))
    assert out.dtype == TORCH_DT[dtype]
    atol = 2e-5 if dtype == jnp.float32 else 3e-2
    np.testing.assert_allclose(out.float().numpy(), ref, atol=atol)


@pytest.mark.parametrize("window", [None, 8])
def test_grouped_wrapper_matches_jax_layout(window):
    """ops.flash_attention: (B,S,Hkv,G,D) in and out, as the reference's."""
    from repro.kernels.flash_attention.ops import flash_attention as jax_ops

    rng = np.random.default_rng(3)
    b, s, hkv, g, d = 2, 40, 2, 3, 32
    qg = rng.normal(size=(b, s, hkv, g, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    ref = jax_ops(jnp.asarray(qg), jnp.asarray(k), jnp.asarray(v), window=window,
                  block_q=16, block_k=16)
    out = flash_attention(torch.from_numpy(qg), torch.from_numpy(k),
                          torch.from_numpy(v), window=window)
    assert out.shape == (b, s, hkv, g, d)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_rows_that_see_no_key_match_jax(causal):
    """Window 16 with Sq > Sk + window: rows at or past Sk - 1 + window see
    no key, and the reference softmaxes their row of -1e30 into the mean of
    V over the Sk keys. The port's plain path (and, on the card, every
    body through the wrapper) gives the same rows."""
    from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
    from repro_torch.kernels.flash_attention.flash_attention import first_blind_row

    rng = np.random.default_rng(11)
    b, hq, hkv, sq, sk, d, window = 2, 4, 2, 48, 20, 32, 16
    q, k, v = (rng.normal(size=shape).astype(np.float32)
               for shape in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    ref = np.asarray(jax_attention_ref(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                                       window=window))
    blind = first_blind_row(sk, window)
    assert blind == sk - 1 + window < sq
    mean = v.mean(axis=2).repeat(hq // hkv, axis=1)[:, :, None]
    np.testing.assert_allclose(ref[:, :, blind:], np.broadcast_to(mean, ref[:, :, blind:].shape),
                               atol=2e-5)
    out = flash_attention_bhsd(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                               window=window)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5)


def test_first_blind_row_is_where_the_window_leaves_every_key():
    from repro_torch.kernels.flash_attention.flash_attention import first_blind_row
    from repro_torch.kernels.flash_attention.ref import attention_ref as plain

    assert first_blind_row(100, None) > 10**9
    for sk, window in ((20, 16), (1, 1), (64, 3)):
        sq = sk + window + 5
        q = torch.zeros((1, 1, sq, 4))
        k = torch.zeros((1, 1, sk, 4))
        v = torch.arange(sk, dtype=torch.float32).reshape(1, 1, sk, 1).expand(1, 1, sk, 4)
        for causal in (False, True):
            out = plain(q, k, v.contiguous(), causal=causal, window=window)[0, 0, :, 0]
            # a row that sees keys averages a window ending at min(q, Sk - 1);
            # the first blind row and every later one average all Sk keys
            blind = first_blind_row(sk, window)
            assert torch.allclose(out[blind:], torch.full((sq - blind,), (sk - 1) / 2))
            assert out[blind - 1].item() == sk - 1


def test_cpu_path_launches_nothing():
    runtime.reset_launch_counts()
    q, k, v = (torch.from_numpy(a) for a in _inputs(0, 1, 2, 1, 16, 16, 16))
    flash_attention_bhsd(q, k, v)
    assert runtime.launch_counts() == {name: 0 for name in runtime.SOURCES}


def test_cpu_path_counts_no_body():
    runtime.reset_launch_counts()
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(0, 1, 4, 2, 16, 64, 64))
    flash_attention_bhsd(q, k, v)
    assert body_launches() == {"simt": 0, "mma": 0, "wgmma": 0}


def _bhsd(b, h, s, d, dtype=torch.bfloat16):
    return torch.zeros((b, h, s, d), dtype=dtype)


def _model_view(b, h, s, d):
    """(B, S, H, D) memory seen as (B, H, S, D), as models/transformer.py
    hands q, k and v to the kernel."""
    return torch.zeros((b, s, h, d), dtype=torch.bfloat16).transpose(1, 2)


def _one_in(b, h, s, d):
    """A view one element into a wider row: neither 16-byte aligned nor
    with a row stride that is a multiple of 8."""
    return torch.zeros((b, h, s, d + 1), dtype=torch.bfloat16)[..., 1:]


def _mla_views(b, s, h, dtype=torch.bfloat16, pad=0):
    """q, k and v as models/mla.py hands them to the kernel at DeepSeek-V2's
    head widths (qk_nope 128, qk_rope 64, v 128), seen as (B, H, S, D): q
    and k concatenated, v the Dv half of the expanded (B, S, H, 256)
    latent (row stride H * 256). ``pad`` widens the latent by that many
    columns ahead of v, so v's rows lose their 16-byte alignment."""
    dn, dr, dv = 128, 64, 128
    kv = torch.zeros((b, s, h, dn + pad + dv), dtype=dtype)
    k_nope, v = kv[..., :dn], kv[..., dn + pad:]
    q = torch.cat([torch.zeros((b, s, h, dn), dtype=dtype),
                   torch.zeros((b, s, h, dr), dtype=dtype)], dim=-1)
    k = torch.cat([k_nope, torch.zeros((b, s, 1, dr), dtype=dtype).expand(b, s, h, dr)], dim=-1)
    return tuple(t.transpose(1, 2) for t in (q, k, v))


# (q, k, v, window, body): the serving shape (Qwen2.5-3B prefill, B=4,
# Hq=16, Hkv=2, S=512, D=128) contiguous and in the model's views, D = 64
# with a window (Hymba's widths), D = 32 (the mma body's widths),
# DeepSeek-V2's MLA widths (D = 192, Dv = 128) contiguous and in the
# model's views, and the cases no tensor-core body takes
BODY_CASES = [
    ("serving-contiguous", lambda: (_bhsd(4, 16, 512, 128), _bhsd(4, 2, 512, 128),
                                    _bhsd(4, 2, 512, 128)), None, "wgmma"),
    ("serving-model-views", lambda: (_model_view(4, 16, 512, 128), _model_view(4, 2, 512, 128),
                                     _model_view(4, 2, 512, 128)), None, "wgmma"),
    ("d64-window", lambda: (_bhsd(1, 25, 96, 64), _bhsd(1, 5, 96, 64), _bhsd(1, 5, 96, 64)),
     1024, "wgmma"),
    ("d32", lambda: (_bhsd(1, 4, 64, 32), _bhsd(1, 2, 64, 32), _bhsd(1, 2, 64, 32)), None, "mma"),
    ("mla-contiguous", lambda: (_bhsd(2, 8, 64, 192), _bhsd(2, 8, 64, 192), _bhsd(2, 8, 64, 128)),
     None, "wgmma"),
    ("mla-model-views", lambda: _mla_views(2, 64, 8), None, "wgmma"),
    ("mla-float32", lambda: _mla_views(2, 64, 8, torch.float32), None, "simt"),
    ("d192-dv64", lambda: (_bhsd(2, 8, 64, 192), _bhsd(2, 8, 64, 192), _bhsd(2, 8, 64, 64)),
     None, "simt"),
    ("d160-dv128", lambda: (_bhsd(2, 8, 64, 160), _bhsd(2, 8, 64, 160), _bhsd(2, 8, 64, 128)),
     None, "simt"),
    ("mla-unaligned", lambda: _mla_views(2, 64, 8, pad=1), None, "simt"),
    ("float32", lambda: (_bhsd(1, 4, 64, 128, torch.float32), _bhsd(1, 2, 64, 128, torch.float32),
                         _bhsd(1, 2, 64, 128, torch.float32)), None, "simt"),
    ("dv-not-d", lambda: (_bhsd(1, 4, 64, 128), _bhsd(1, 2, 64, 128), _bhsd(1, 2, 64, 64)),
     None, "simt"),
    ("one-element-in", lambda: (_one_in(1, 4, 40, 128), _one_in(1, 2, 40, 128),
                                _one_in(1, 2, 40, 128)), None, "simt"),
]


@pytest.mark.parametrize("make,window,body", [c[1:] for c in BODY_CASES],
                         ids=[c[0] for c in BODY_CASES])
def test_body_for_names_the_body(make, window, body):
    q, k, v = make()
    assert body_for(q, k, v, window) == body


@pytest.mark.parametrize(
    "shapes,dtype,err",
    [
        (((1, 3, 8, 16), (1, 2, 8, 16), (1, 2, 8, 16)), torch.float32, ValueError),
        (((1, 2, 8, 16), (1, 2, 8, 16), (1, 2, 8, 24)), torch.float32, ValueError),
        (((1, 2, 8, 16), (1, 2, 8, 16), (1, 2, 8, 16)), torch.float16, TypeError),
    ],
)
def test_wrapper_refuses_what_the_kernel_does_not_take(shapes, dtype, err):
    q, k, v = (torch.zeros(s, dtype=dtype) for s in shapes)
    with pytest.raises(err):
        flash_attention_bhsd(q, k, v)


def test_wrapper_refuses_devices_it_cannot_serve():
    """Neither CPU nor CUDA: no silent move, no plain-version fallback."""
    q = torch.zeros((1, 2, 8, 16), device="meta")
    with pytest.raises(ValueError):
        flash_attention_bhsd(q, q, q)


def test_build_command_targets_hopper(tmp_path, monkeypatch):
    monkeypatch.setattr(runtime.shutil, "which", lambda name: "/opt/cuda/bin/nvcc")
    cmd = runtime.nvcc_command("flash_attention", tmp_path / "lib.so")
    assert cmd[0] == "/opt/cuda/bin/nvcc"
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert cmd[-1].endswith("csrc/flash_attention.cu")
    assert runtime.library_path("flash_attention").parent == runtime.BUILD_DIR


def _fake_nvcc(tmp_path, body):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\n" + body)
    fake.chmod(0o755)
    return str(fake)


def test_build_writes_the_library_and_reports_failures(tmp_path, monkeypatch):
    """build() runs the compiler once per missing library, moves its output
    into place, and raises with the compiler's log when it fails."""
    monkeypatch.setattr(runtime, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(runtime, "BUILD_LOG", {})
    monkeypatch.setattr(runtime, "nvcc_path", lambda: _fake_nvcc(
        tmp_path, 'while [ "$1" != "-o" ]; do shift; done\necho built > "$2"\n'))
    log = runtime.build(["flash_attention"])
    lib = runtime.library_path("flash_attention")
    assert lib.parent == tmp_path / "build" and lib.read_text() == "built\n"
    assert log["flash_attention"]["seconds"] >= 0
    assert list(lib.parent.iterdir()) == [lib]  # no temporary left behind

    monkeypatch.setattr(runtime, "BUILD_DIR", tmp_path / "build2")
    monkeypatch.setattr(runtime, "nvcc_path", lambda: _fake_nvcc(
        tmp_path, 'echo "error: no such intrinsic"\nexit 2\n'))
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        runtime.build(["flash_attention"])
    assert not runtime.library_path("flash_attention").exists()


def test_ablation_variants_take_out_what_they_name():
    """tools/flash_ablation.py cuts parts of the wgmma body by markers in
    the CUDA source: each variant must find its markers and drop exactly
    its part (the tool times them on the card)."""
    from tools import flash_ablation

    src = flash_ablation.SOURCE.read_text()
    v = flash_ablation.variants(src)
    assert v["as built"] == src
    assert "fast_exp2(fmaf(s[i]" in src and "fast_exp2(fmaf(s[i]" not in v["no softmax"]
    assert "wgmma_n64_rs(o[cb]" in src and "wgmma_n64_rs(o[cb]" not in v["no products"]
    assert "wgmma_n128_ss(s," not in v["no products"]
    assert "(FIT < 4 ? FIT : 4) - 1;" in v["one stage fewer"]
    assert "(FIT < 4 ? FIT : 4) - 1;" not in src
    assert "HEAD_MAJOR = D == DV;" in v["grid order flipped"] and "HEAD_MAJOR = D != DV;" in src


@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("case", [SWEEP[1], SWEEP[-1]], ids=["gqa", "dv_ne_d"])
def test_logit_control_computes_attention_ref(case, tile):
    """chip_smoke.py's control for the full-width logits
    (``blocked_bhsd``: the plain route summed in key tiles) must compute
    ``attention_ref``'s function, so that its logit gap measures a change
    of summation order alone."""
    import chip_smoke

    b, hq, hkv, s, d, dv, causal, window = case
    q, k, v = (torch.from_numpy(x) for x in _inputs(5, b, hq, hkv, s, d, dv))
    out = chip_smoke.blocked_bhsd(q, k, v, causal=causal, window=window, tile=tile)
    ref = attention_ref(q, k, v, causal=causal, window=window)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-5, rtol=0)
