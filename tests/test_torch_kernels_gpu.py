"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test here is marked ``gpu`` and skips without a CUDA
device (a CUDA kernel has no CPU mode). This file imports no JAX, so it
runs where only PyTorch is installed:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerances: float32 atol 2e-5 (summation order only; TF32 is off),
bfloat16 atol 3e-2 (one bf16 rounding of outputs of magnitude <= ~2).
"""
import numpy as np
import pytest
import torch

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
    (4, 16, 2, 512, 128, 128, True, None),  # Qwen2.5-3B prefill
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, dtype, b, hq, hkv, s, d, dv):
    rng = np.random.default_rng(s)
    return tuple(
        torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device, dtype)
        for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, dv))
    )


@pytest.mark.gpu
@pytest.mark.parametrize("b,hq,hkv,s,d,dv,causal,window", SWEEP)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_ref(cuda, b, hq, hkv, s, d, dv, causal, window, dtype):
    q, k, v = _inputs(cuda, dtype, b, hq, hkv, s, d, dv)
    before = runtime.launch_counts()["flash_attention"]
    out = flash_attention_bhsd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert runtime.launch_counts()["flash_attention"] == before + 1
    assert out.shape == (b, hq, s, dv) and out.dtype == dtype
    ref = attention_ref(q, k, v, causal=causal, window=window)
    atol = 2e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_wrapper_on_card(cuda, dtype):
    """Strided (B,S,Hkv,G,D) views go in and out without copies."""
    rng = np.random.default_rng(0)
    b, s, hkv, g, d = 2, 100, 2, 4, 64
    qg, k, v = (
        torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda, dtype)
        for shape in ((b, s, hkv, g, d), (b, s, hkv, d), (b, s, hkv, d))
    )
    out = flash_attention(qg, k, v, window=32)
    ref = flash_attention(qg.cpu(), k.cpu(), v.cpu(), window=32)
    atol = 2e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(out.cpu().float(), ref.float(), atol=atol, rtol=0)


@pytest.mark.gpu
def test_unaligned_views_take_the_general_body(cuda):
    """Rows not 16-byte aligned (a view one element in) still compute."""
    rng = np.random.default_rng(1)
    base = [torch.from_numpy(rng.normal(size=(1, 4, 40, 33)).astype(np.float32))
            .to(cuda, torch.bfloat16) for _ in range(3)]
    q, k, v = (t[..., 1:] for t in base)  # D = Dv = 32, row stride 33
    out = flash_attention_bhsd(q, k, v)
    torch.testing.assert_close(out.float(), attention_ref(q, k, v).float(),
                               atol=3e-2, rtol=0)
