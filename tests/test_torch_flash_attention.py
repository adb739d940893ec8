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


def test_cpu_path_launches_nothing():
    runtime.reset_launch_counts()
    q, k, v = (torch.from_numpy(a) for a in _inputs(0, 1, 2, 1, 16, 16, 16))
    flash_attention_bhsd(q, k, v)
    assert runtime.launch_counts() == {"flash_attention": 0}


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

