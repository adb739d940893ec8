"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test here is marked ``gpu`` and skips without a CUDA
device (a CUDA kernel has no CPU mode). This file imports no JAX, so it
runs where only PyTorch is installed:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerances. Flash attention: float32 atol 2e-5 (summation order only;
TF32 is off), bfloat16 atol 3e-2 (one bf16 rounding of outputs of
magnitude <= ~2). SSD scan: y in float32 atol max(1e-4, 1e-5 × max|y|)
(the reference's 1e-4 on the small sweep; summation order only, whose
error grows with the magnitude of y, up to ~10 at the serving shape), y
in bfloat16 1e-2 × max|y| (both sides round one float32 result to bf16,
so they may differ by one bf16 ulp, 2^-7 of the value), and the float32
final state 1e-4 × max(1, max|S|) (summation order only, in either input
dtype).
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
from repro_torch.kernels.ssd_scan import ssd_ref, ssd_scan

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


# (b, s, nh, hd, n, chunk): tests/test_kernels.py's sweep, a ragged tail,
# the reduced Mamba2 and the Mamba2-2.7B serving shape
SSD_SWEEP = [
    (1, 32, 2, 16, 8, 8),
    (2, 64, 4, 16, 16, 16),
    (1, 48, 1, 8, 4, 16),
    (2, 45, 3, 16, 8, 16),  # S % chunk != 0
    (2, 12, 16, 16, 16, 8),  # reduced Mamba2
    (1, 300, 4, 64, 128, 256),  # two chunks, ragged, full-width head
    (2, 200, 3, 64, 128, 64),  # full-width head, chunk 64, ragged
    (4, 512, 80, 64, 128, 256),  # Mamba2-2.7B prefill
]


def _ssd_inputs(device, dtype, b, s, nh, hd, n, seed=0, state=False):
    """dt and A drawn as in tests/test_kernels.py; x, B, C in ``dtype``."""
    rng = np.random.default_rng(seed)

    def t(a, dt=dtype):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device, dt)

    out = (t(rng.normal(size=(b, s, nh, hd))), t(rng.uniform(0.01, 0.2, (b, s, nh)), torch.float32),
           t(-rng.uniform(0.5, 2, (nh,)), torch.float32), t(rng.normal(size=(b, s, n))),
           t(rng.normal(size=(b, s, n))))
    s0 = t(rng.normal(size=(b, nh, hd, n)), torch.float32) if state else None
    return out, s0


def _ssd_close(y, st, y_ref, st_ref):
    assert y.shape == y_ref.shape and y.dtype == y_ref.dtype and st.dtype == torch.float32
    y_max = y_ref.float().abs().max().item()
    tol = max(1e-4, 1e-5 * y_max) if y.dtype == torch.float32 else 1e-2 * y_max
    y, y_ref = y.float(), y_ref.float()
    torch.testing.assert_close(y, y_ref, atol=tol, rtol=0)
    torch.testing.assert_close(st, st_ref, atol=1e-4 * max(1.0, st_ref.abs().max().item()),
                               rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,nh,hd,n,chunk", SSD_SWEEP)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("state", [False, True])
def test_ssd_kernel_matches_ref(cuda, b, s, nh, hd, n, chunk, dtype, state):
    (x, dt, A, Bm, Cm), s0 = _ssd_inputs(cuda, dtype, b, s, nh, hd, n, seed=s, state=state)
    before = runtime.launch_counts()["ssd_scan"]
    y, st = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, initial_state=s0)
    torch.cuda.synchronize()
    assert runtime.launch_counts()["ssd_scan"] == before + 1
    y_ref, st_ref = ssd_ref(x, dt, A, Bm, Cm, chunk, s0)
    _ssd_close(y, st, y_ref, st_ref)


@pytest.mark.gpu
@pytest.mark.parametrize("nh,hd,n,chunk", [(4, 16, 16, 16), (2, 64, 128, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
def test_ssd_kernel_takes_the_models_strided_views(cuda, nh, hd, n, chunk, dtype, offset):
    """x, B and C as views of one (B, S, conv_dim) tensor, as the model
    hands them in: the kernel reads them through their strides. With
    ``offset`` 1 the rows are not 16-byte aligned, which the bf16
    tensor-core body does not take: the CUDA-core body computes them."""
    rng = np.random.default_rng(3)
    b, s = 2, 300
    di = nh * hd
    base = torch.from_numpy(rng.normal(size=(b, s, offset + di + 2 * n)).astype(np.float32))
    xbc = base.to(cuda, dtype)[..., offset:]
    xh = xbc[..., :di].reshape(b, s, nh, hd)
    Bm, Cm = xbc[..., di:di + n], xbc[..., di + n:]
    assert not xh.is_contiguous() and not Bm.is_contiguous()
    dt = torch.from_numpy(rng.uniform(0.01, 0.2, (b, s, nh)).astype(np.float32)).to(cuda)
    A = torch.from_numpy(-rng.uniform(0.5, 2, (nh,)).astype(np.float32)).to(cuda)
    y, st = ssd_scan(xh, dt, A, Bm, Cm, chunk=chunk)
    y_ref, st_ref = ssd_ref(xh.contiguous(), dt, A, Bm.contiguous(), Cm.contiguous(), chunk)
    _ssd_close(y, st, y_ref, st_ref)


@pytest.mark.gpu
def test_ssd_kernel_chains_initial_state(cuda):
    """Two halves with the state carried == the whole sequence."""
    (x, dt, A, Bm, Cm), _ = _ssd_inputs(cuda, torch.float32, 1, 64, 2, 16, 8, seed=4)
    y, st = ssd_scan(x, dt, A, Bm, Cm, chunk=16)
    h = 24  # not a chunk boundary
    y1, s1 = ssd_scan(x[:, :h], dt[:, :h], A, Bm[:, :h], Cm[:, :h], chunk=16)
    y2, s2 = ssd_scan(x[:, h:], dt[:, h:], A, Bm[:, h:], Cm[:, h:], chunk=16, initial_state=s1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, atol=1e-4, rtol=0)
    torch.testing.assert_close(s2, st, atol=1e-4, rtol=0)
