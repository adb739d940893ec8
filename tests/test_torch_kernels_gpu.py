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
so they may differ by one bf16 ulp, 2^-7 of the value; the bf16 cases
also print the worst error in ulps of y, the bf16 values between kernel
and reference), and the float32 final state 1e-4 × max(1, max|S|)
(summation order only, in either input dtype). dcov: the windows form's Grams within 1e-6 of each episode's
max|G| (float32; the kernel sums in the plain version's order without
fused multiply-adds, so it should agree to the bit, and the bound only
allows for reordering), and bitwise equal alone and inside a batch, and
on the fault ablation's windows (NaN rows, x1000 spikes) bit for bit,
NaN positions included; the
ORACLE-scale form's Gram within 1e-4 of max|G| (float32 sums over n²
terms, up to 16.8 M, in another order than the materialized plain
version) and its dCor within 1e-3 (the square root of a ratio: near 0 a
ratio error of 1e-6 is 1e-3 in dCor); against the float64 plain version,
its normalised Gram ⟨A,B⟩/√(⟨A,A⟩⟨B,B⟩) (dCor² before the root) within
1e-6 at every pair and its dCor within 1e-4 wherever the float64 dCor is
at least 1e-2 (at an exact zero of dCor, 1e-8 of float32 rounding in dCor²
is 1e-4 in dCor), and two runs bitwise equal. The offload cells run on
the card: records against ``BENCH_matrix.json`` at rel 1e-12 (both rebuild
τ and p in float64 from the same landscapes and noise). The fleet runs on
the card: its windows launches bitwise at the fleet's shapes, its results
block equal to ``BENCH_fleet.json``'s (``json.dumps`` with sorted keys).
With the contract and NaN lanes on (``REPRO_CONTRACTS=1
REPRO_CHECKIFY=1``) a static call over the grid and the 64-twin fleet
give the lane-off record exactly, with the same dcov launches.
Mamba2's decode state step (``ssm_decode``): the new bf16 state bit for
bit against the plain version on the card (the kernel computes the plain
version's float32 operations in its order, with no fused multiply-add, and
rounds once, to nearest even, as ``copy_`` does), after one step and after
each of ten chained steps; y in float32 within 1e-5 × max|y| (the sum over N
in another order only), y in bf16 within one bf16 ulp of y_p = Σ_n C·s' plus
one of y at each element (the two float32 sums may round to neighbouring
bf16 values before the skip is added to them, and that sum is rounded once
more).
The serving engine's CUDA graph of the decode step (reduced Qwen2.5-3B,
Mamba2-2.7B, a 4-layer Hymba-1.5B, DeepSeek-V2-236B,
Moonlight-16B-A3B, Whisper-medium with its encoder's features and
Qwen2-VL-72B with its vision embeds, bf16): its logits and caches
bitwise equal to the eager step's (the same kernels in the same order),
one capture per pool entry, an entry-less cache refused by a graphed
engine, and the runtime's tokens through graphs equal to its tokens
through the eager step.
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.flash_attention import (
    attention_ref,
    body_for,
    body_launches,
    flash_attention,
    flash_attention_bhsd,
)
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.dcov import (
    dcor_all_blocked,
    dcor_from_sums,
    dcov_gram,
    dcov_gram_ref,
    dcov_gram_windows,
    dcov_gram_windows_ref,
)
from repro_torch.kernels.flash_attention.flash_attention import first_blind_row
from repro_torch.kernels.ssd_scan import ssd_ref, ssd_scan
from repro_torch.kernels.ssm_decode import ssm_decode, ssm_decode_ref, ssm_step_ref
from repro_torch.kernels.ssd_scan.ssd_scan import body_for as ssd_body_for
from repro_torch.kernels.ssd_scan.ssd_scan import body_launches as ssd_body_launches

SWEEP = [
    (1, 2, 2, 64, 32, 32, True, None),
    (2, 4, 2, 96, 32, 32, True, None),  # GQA
    (1, 4, 1, 128, 16, 16, True, 24),  # MQA + sliding window
    (2, 2, 2, 80, 32, 32, False, None),  # bidirectional
    (1, 8, 2, 72, 64, 64, True, 16),
    (1, 4, 2, 70, 32, 32, True, None),  # unpadded tail
    (2, 4, 2, 48, 32, 64, True, None),  # Dv != D
    (4, 16, 2, 512, 128, 128, True, None),  # Qwen2.5-3B prefill
    (2, 16, 2, 300, 128, 128, True, None),  # ragged tail in the query and key tiles
    (1, 25, 5, 1536, 64, 64, True, 1024),  # Hymba's widths: GQA group 5, a long window
    (4, 25, 5, 512, 64, 64, True, 1024),  # Hymba-1.5B serving prefill, B=4 x 512
    (2, 25, 5, 2048, 64, 64, True, 1024),  # Hymba-1.5B prefill of 2048: the window masks
    (1, 16, 2, 4096, 128, 128, True, None),  # long prefill
    (2, 4, 2, 200, 128, 128, False, None),  # bidirectional, ragged
    (4, 16, 2, 8, 128, 128, True, None),  # Qwen2.5-3B prompts of the control loop's trace,
    (4, 16, 2, 32, 128, 128, True, None),  # of WalltimeDevice's probe and of the tau probe:
    (4, 16, 2, 64, 128, 128, True, None),  # one query and one key tile hold the whole prompt
    (4, 128, 128, 512, 192, 128, True, None),  # DeepSeek-V2 MLA prefill: D 192, Dv 128
    (2, 8, 8, 8, 192, 128, True, None),  # MLA widths: one query and one key tile, mostly empty
    (2, 8, 8, 32, 192, 128, True, None),
    (2, 8, 8, 300, 192, 128, True, None),  # ragged tail in the query and key tiles
    (2, 8, 8, 200, 192, 128, False, None),  # bidirectional, ragged
    (1, 8, 8, 2048, 192, 128, True, None),  # 16 key tiles through a ring of two stages
    (2, 16, 2, 256, 192, 128, True, None),  # GQA at the MLA widths
    (4, 16, 16, 1500, 64, 64, False, None),  # Whisper's encoder: MHA, a 92-row tail
    (1, 64, 8, 512, 128, 128, True, None),  # Qwen2-VL-72B: GQA group 8
]
# Whisper's cross attention: non-causal, the decoder's Sq queries over the
# encoder's Sk = 1500 frames (Sq < Sk; one query row is a decode step's)
CROSS = [(sq, d) for sq in (1, 64, 128, 200) for d in (64, 128)]
# (D, Dv) pairs the tensor-core bodies take in bf16 (flash_attention.py)
WGMMA_DIMS = {(64, 64), (128, 128), (192, 128)}


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
    body = body_for(q, k, v, window)
    assert body == ("simt" if dtype != torch.bfloat16 else
                    "wgmma" if (d, dv) in WGMMA_DIMS else "mma" if d == dv else "simt")
    before = runtime.launch_counts()["flash_attention"]
    before_body = body_launches()[body]
    out = flash_attention_bhsd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert runtime.launch_counts()["flash_attention"] == before + 1
    assert body_launches()[body] == before_body + 1
    assert out.shape == (b, hq, s, dv) and out.dtype == dtype
    ref = attention_ref(q, k, v, causal=causal, window=window)
    atol = 2e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("sq,d", CROSS)
def test_flash_cross_attention_queries_fewer_than_keys(cuda, sq, d):
    """Non-causal with Sq < Sk (Whisper's cross attention, Sk = 1500 with
    a 92-row tail): the grid and Q's tensor map follow Sq, the key tiles
    Sk, O's stores stop at Sq's tail. On the wgmma body, within 3e-2."""
    rng = np.random.default_rng(sq + d)
    b, h, sk = 2, 16, 1500
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda, torch.bfloat16)
               for shape in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d)))
    assert body_for(q, k, v) == "wgmma"
    before = body_launches()["wgmma"]
    out = flash_attention_bhsd(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert body_launches()["wgmma"] == before + 1 and out.shape == (b, h, sq, d)
    torch.testing.assert_close(out.float(), attention_ref(q, k, v, causal=False).float(),
                               atol=3e-2, rtol=0)


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
def test_models_strided_views_through_the_wgmma_body(cuda, monkeypatch):
    """q, k and v as models/transformer.py makes them, (B, S, H, D) memory
    at D = 128, go through ``flash_attention`` on the wgmma body, read in
    place, and agree with the plain route on the same views."""
    rng = np.random.default_rng(2)
    b, s, hkv, g, d = 2, 384, 2, 8, 128
    qkv = torch.from_numpy(rng.normal(size=(b, s, hkv * (g + 2), d)).astype(np.float32))
    qkv = qkv.to(cuda, torch.bfloat16)
    q = qkv[:, :, :hkv * g]  # (B, S, Hq, D) views of one projection output
    k, v = qkv[:, :, hkv * g:hkv * (g + 1)], qkv[:, :, hkv * (g + 1):]
    qg = q.reshape(b, s, hkv, g, d)
    assert not k.is_contiguous() and body_for(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2)) == "wgmma"
    before = body_launches()["wgmma"]
    out = flash_attention(qg, k, v)
    torch.cuda.synchronize()
    assert body_launches()["wgmma"] == before + 1
    monkeypatch.setattr(fa_ops, "flash_attention_bhsd", attention_ref)
    ref = flash_attention(qg, k, v)
    torch.testing.assert_close(out.float(), ref.float(), atol=3e-2, rtol=0)


@pytest.mark.gpu
def test_mla_strided_views_through_the_wgmma_body(cuda, monkeypatch):
    """q, k and v as models/mla.py makes them at DeepSeek-V2's widths (128
    heads, D = 128 + 64, Dv = 128): q and k concatenated, v the Dv half of
    the expanded (B, S, H, 256) latent, row stride H * 256. They go
    through ``flash_attention`` on the wgmma body, V read in place by TMA
    at its 256-byte offset, and agree with the plain route on the same
    views."""
    rng = np.random.default_rng(3)
    b, s, h, dn, dr, dv = 2, 256, 128, 128, 64, 128

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda, torch.bfloat16)

    kv = t(b, s, h, dn + dv)
    k_nope, v = kv.split([dn, dv], dim=-1)
    q = torch.cat([t(b, s, h, dn), t(b, s, h, dr)], dim=-1)
    k = torch.cat([k_nope, t(b, s, 1, dr).expand(b, s, h, dr)], dim=-1)
    assert v.stride(1) == h * (dn + dv) and not v.is_contiguous()
    qg = q.reshape(b, s, h, 1, dn + dr)
    assert body_for(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)) == "wgmma"
    before = body_launches()["wgmma"]
    out = flash_attention(qg, k, v)
    torch.cuda.synchronize()
    assert body_launches()["wgmma"] == before + 1 and out.shape == (b, s, h, 1, dv)
    monkeypatch.setattr(fa_ops, "flash_attention_bhsd", attention_ref)
    ref = flash_attention(qg, k, v)
    torch.testing.assert_close(out.float(), ref.float(), atol=3e-2, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("d,dtype", [(128, torch.bfloat16), (64, torch.bfloat16),
                                     (32, torch.bfloat16), (32, torch.float32)])
def test_flash_rows_that_see_no_key(cuda, d, dtype):
    """Bidirectional, window 16, Sq > Sk + window: query rows at or past
    Sk - 1 + window see no key, and every body gives them attention_ref's
    answer, the mean of V over the Sk keys."""
    rng = np.random.default_rng(5)
    b, hq, hkv, sq, sk, window = 2, 4, 2, 200, 120, 16
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda, dtype)
               for shape in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    body = body_for(q, k, v, window)
    before = body_launches()[body]
    out = flash_attention_bhsd(q, k, v, causal=False, window=window)
    torch.cuda.synchronize()
    assert body_launches()[body] == before + 1
    ref = attention_ref(q, k, v, causal=False, window=window)
    blind = first_blind_row(sk, window)
    assert 0 < blind < sq
    atol = 2e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)
    mean = v.float().mean(dim=2).repeat_interleave(hq // hkv, dim=1)
    torch.testing.assert_close(out[:, :, blind:].float(),
                               mean[:, :, None].expand(-1, -1, sq - blind, -1), atol=atol, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
def test_flash_simt_body_still_computes_the_mla_widths(cuda, monkeypatch, causal):
    """D = 192, Dv = 128 in bf16 forced onto the simt body (body_for names
    wgmma there): the generic body stays held to attention_ref at the
    widths that no longer reach it on the serving path."""
    fa_module = importlib.import_module("repro_torch.kernels.flash_attention.flash_attention")
    q, k, v = _inputs(cuda, torch.bfloat16, 2, 8, 8, 300, 192, 128)
    assert body_for(q, k, v) == "wgmma"
    monkeypatch.setattr(fa_module, "body_for", lambda *a: "simt")
    before = body_launches()
    out = flash_attention_bhsd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    after = body_launches()
    assert after["simt"] == before["simt"] + 1 and after["wgmma"] == before["wgmma"]
    torch.testing.assert_close(out.float(), attention_ref(q, k, v, causal=causal).float(),
                               atol=3e-2, rtol=0)


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
# the reduced Mamba2 and the Mamba2-2.7B serving shape, then Hymba-1.5B's
# N = 16 (every case with and without an initial state)
SSD_SWEEP = [
    (1, 32, 2, 16, 8, 8),
    (2, 64, 4, 16, 16, 16),
    (1, 48, 1, 8, 4, 16),
    (2, 45, 3, 16, 8, 16),  # S % chunk != 0
    (2, 12, 16, 16, 16, 8),  # reduced Mamba2
    (1, 300, 4, 64, 128, 256),  # two chunks, ragged, full-width head
    (2, 200, 3, 64, 128, 64),  # full-width head, chunk 64, ragged
    (4, 512, 80, 64, 128, 256),  # Mamba2-2.7B prefill
    (1, 4096, 80, 64, 128, 256),  # 16 chunks at the full width: state passing
    (2, 1000, 8, 64, 128, 64),  # chunk 64, ragged, 16 chunks
    (4, 512, 50, 64, 16, 256),  # Hymba-1.5B prefill: NH = 50, a ragged head group of 2
    (1, 300, 4, 64, 16, 256),  # two chunks, ragged tail
    (2, 200, 3, 64, 16, 64),  # chunk 64, ragged
    (1, 2048, 50, 64, 16, 256),  # 8 chunks: state passing
    (2, 1000, 50, 64, 16, 64),  # chunk 64, 16 chunks, ragged
]


def bf16_ulps(y, y_ref):
    """The bf16 values between y and y_ref, element by element: the
    distance of their bit patterns once mapped to a monotone integer
    scale (sign and magnitude to two's complement)."""
    def order(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return (order(y) - order(y_ref)).abs()


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


def _ssd_body(x, Bm, Cm, chunk):
    """The body body_for names, which must be wgmma exactly where the
    serving conditions hold (bf16, hd 64, N 128 or 16, chunk % 64 == 0,
    16-byte aligned rows)."""
    body = ssd_body_for(x, Bm, Cm, chunk)
    aligned = all(t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in t.stride()[:-1])
                  for t in (x, Bm, Cm))
    want = x.dtype == torch.bfloat16 and x.shape[-1] == 64 and Bm.shape[-1] in (16, 128) \
        and chunk % 64 == 0 and aligned
    assert body == ("wgmma" if want else "simt")
    return body


def _ssd_close(y, st, y_ref, st_ref):
    assert y.shape == y_ref.shape and y.dtype == y_ref.dtype and st.dtype == torch.float32
    y_max = y_ref.float().abs().max().item()
    tol = max(1e-4, 1e-5 * y_max) if y.dtype == torch.float32 else 1e-2 * y_max
    if y.dtype == torch.bfloat16:
        err = (y.float() - y_ref.float()).abs()
        at = err.argmax()
        ulps = bf16_ulps(y, y_ref)
        print(f"y max_abs_err {err.max().item():.4g} at |y| {y_ref.float().abs().flatten()[at]:.4g}"
              f" = {ulps.flatten()[at].item()} ulps of y; "
              f"{(ulps > 1).float().mean().item():.3%} of y more than 1 ulp apart")
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
    body = _ssd_body(x, Bm, Cm, chunk)
    before = runtime.launch_counts()["ssd_scan"]
    before_body = ssd_body_launches()[body]
    y, st = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, initial_state=s0)
    torch.cuda.synchronize()
    assert runtime.launch_counts()["ssd_scan"] == before + 1
    assert ssd_body_launches()[body] == before_body + 1
    y_ref, st_ref = ssd_ref(x, dt, A, Bm, Cm, chunk, s0)
    _ssd_close(y, st, y_ref, st_ref)


@pytest.mark.gpu
@pytest.mark.parametrize("nh,hd,n,chunk", [(4, 16, 16, 16), (2, 64, 128, 256), (80, 64, 128, 256),
                                           (50, 64, 16, 256), (50, 64, 16, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
def test_ssd_kernel_takes_the_models_strided_views(cuda, nh, hd, n, chunk, dtype, offset):
    """x, B and C as views of one (B, S, conv_dim) tensor, as the model
    hands them in: the kernel reads them through their strides (Hymba's
    conv_dim 3232, B and C at 3200 and 3216). With ``offset`` 1 the rows
    are not 16-byte aligned, which the bf16 tensor-core body does not take:
    the CUDA-core body computes them."""
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
    body = _ssd_body(xh, Bm, Cm, chunk)
    before = ssd_body_launches()[body]
    y, st = ssd_scan(xh, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_body_launches()[body] == before + 1
    y_ref, st_ref = ssd_ref(xh.contiguous(), dt, A, Bm.contiguous(), Cm.contiguous(), chunk)
    _ssd_close(y, st, y_ref, st_ref)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [(4, 512, 80, 64, 128, 256), (1, 4096, 80, 64, 128, 256),
                                  (4, 512, 50, 64, 16, 256), (1, 2048, 50, 64, 16, 256),
                                  (2, 1000, 50, 64, 16, 64)])
def test_ssd_wgmma_body_is_deterministic(cuda, case):
    """No float atomics and no order that depends on the schedule: two
    launches on the same inputs give the same bits, y and final state."""
    b, s, nh, hd, n, chunk = case
    (x, dt, A, Bm, Cm), s0 = _ssd_inputs(cuda, torch.bfloat16, b, s, nh, hd, n, seed=6,
                                         state=True)
    assert ssd_body_for(x, Bm, Cm, chunk) == "wgmma"
    y1, s1 = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, initial_state=s0)
    y2, s2 = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, initial_state=s0)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


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


# Column scales of a CORAL window: five knob values (MHz, cores, MHz, MHz,
# streams), then τ and p; an eighth column for C = 8.
DCOV_SCALES = (1500.0, 4.0, 800.0, 2000.0, 3.0, 50.0, 5.0, 1.0)


def dcov_windows_inputs(device, b, w, c, seed):
    """B (W, C) windows at CORAL's column scales, n_valid drawn per episode
    from {1, 2, 3, W-1, W}, rows past n_valid zero, and in every third
    episode a constant first column."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, w, c)) * np.asarray(DCOV_SCALES[:c]) + np.asarray(DCOV_SCALES[:c])
    x[::3, :, 0] = DCOV_SCALES[0]
    n = rng.choice(sorted({1, 2, 3, max(w - 1, 1), w}), size=b).astype(np.int32)
    x[np.arange(w)[None, :] >= n[:, None]] = 0.0
    return (torch.from_numpy(x.astype(np.float32)).to(device),
            torch.from_numpy(n).to(device))


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 3, 162, 1024])
@pytest.mark.parametrize("w", [3, 10, 64])
@pytest.mark.parametrize("c", [2, 7, 8])
def test_dcov_windows_kernel_matches_ref(cuda, b, w, c):
    cols, n = dcov_windows_inputs(cuda, b, w, c, seed=b * 100 + w * 10 + c)
    before = runtime.launch_counts()["dcov"]
    gram = dcov_gram_windows(cols, n)
    torch.cuda.synchronize()
    assert runtime.launch_counts()["dcov"] == before + 1
    ref = dcov_gram_windows_ref(cols, n)
    assert gram.shape == (b, c, c) and gram.dtype == torch.float32
    scale = ref.abs().amax(dim=(1, 2)).clamp_min(1e-30)
    err = ((gram - ref).abs().amax(dim=(1, 2)) / scale).max().item()
    assert err <= 1e-6
    diag = torch.diagonal(gram, dim1=1, dim2=2)
    corr = dcor_from_sums(gram[:, :1, 1:], diag[:, :1, None], diag[:, None, 1:])
    assert torch.isfinite(corr).all()


@pytest.mark.gpu
def test_dcov_windows_kernel_is_batch_independent(cuda):
    """Each episode's Gram alone equals its Gram inside B=162, bitwise."""
    cols, n = dcov_windows_inputs(cuda, 162, 10, 7, seed=7)
    batch = dcov_gram_windows(cols, n)
    for i in range(162):
        alone = dcov_gram_windows(cols[i:i + 1], n[i:i + 1])
        assert torch.equal(alone[0], batch[i]), f"episode {i}"


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1024, 256])
def test_dcov_windows_kernel_bitwise_at_the_fleet_shapes(cuda, b):
    """The fleet's cold (B = 1024) and warm (B = 256) calls launch at
    (B, W, C) = (B, 12, 7): the Grams equal the plain version's bit for
    bit."""
    cols, n = dcov_windows_inputs(cuda, b, 12, 7, seed=b + 12)
    gram = dcov_gram_windows(cols, n)
    assert torch.equal(gram, dcov_gram_windows_ref(cols, n))


@pytest.mark.gpu
def test_dcov_windows_kernel_on_fault_windows(cuda):
    """The fault ablation's windows at its batch shape (B, W, C) = (36, 10,
    7): dropped samples as NaN rows and x1000 spikes in the τ and p
    columns (one NaN past n_valid too). NaN times the mask is NaN in the
    kernel as in the plain version, so the Grams agree bit for bit, NaN
    positions included."""
    cols, n = dcov_windows_inputs(cuda, 36, 10, 7, seed=36)
    x = cols.cpu().numpy()
    rng = np.random.default_rng(36)
    for b in range(36):
        valid = int(n[b])
        spiked = rng.random(valid) < 0.3
        x[b, :valid, 5][spiked] *= 1000.0
        x[b, :valid, 6][rng.random(valid) < 0.2] *= 1000.0
        if b % 3 == 1:  # a dropped sample
            x[b, rng.integers(valid), 5:7] = np.nan
    x[2, 9, 5] = np.nan
    cols = torch.from_numpy(x).to(cuda)
    gram = dcov_gram_windows(cols, n)
    ref = dcov_gram_windows_ref(cols, n)
    nan = torch.isnan(ref)
    assert nan.any() and (~nan).any()
    assert torch.equal(torch.isnan(gram), nan)
    assert torch.equal(gram[~nan], ref[~nan])


def normalised_gram(g, eps=1e-12):
    """<A_c,A_d> / sqrt(<A_c,A_c> <A_d,A_d>) in float64, 0 where a column is
    constant: dCor^2 before the square root."""
    g = g.to(torch.float64)
    d = torch.diagonal(g).clamp_min(0.0).sqrt()
    den = d[:, None] * d[None, :]
    return torch.where(den < eps, 0.0, g / den.clamp_min(eps))


def every_dcor(g):
    """dCor of every pair c != d of a Gram, as the port computes it."""
    diag = torch.diagonal(g)
    off = ~torch.eye(g.shape[0], dtype=torch.bool, device=g.device)
    return dcor_from_sums(g, diag[:, None], diag[None, :])[off]


def assert_near_float64(gram, ref64):
    """The single-block Gram against its float64 plain version: the
    normalised Gram within 1e-6 at every pair, dCor within 1e-4 wherever
    the float64 dCor is at least 1e-2."""
    gap = (normalised_gram(gram) - normalised_gram(ref64)).abs().max().item()
    assert gap <= 1e-6, f"normalised Gram {gap:.3g} off float64"
    got, want = every_dcor(gram).to(torch.float64), every_dcor(ref64)
    big = want >= 1e-2
    if big.any():
        assert (got - want)[big].abs().max().item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 2, 30, 63, 65, 200, 512, 1440, 1600, 2160, 4099, 16384])
@pytest.mark.parametrize("c", [1, 2, 7, 8])
def test_dcov_gram_kernel_matches_ref(cuda, n, c):
    rng = np.random.default_rng(n + c)
    x = rng.normal(size=(n, c)) * np.asarray(DCOV_SCALES[:c]) + np.asarray(DCOV_SCALES[:c])
    cols = torch.from_numpy(x.astype(np.float32)).to(cuda)
    before = runtime.launch_counts()["dcov"]
    gram = dcov_gram(cols)
    torch.cuda.synchronize()
    assert runtime.launch_counts()["dcov"] == before + 1
    assert torch.equal(dcov_gram(cols), gram), "two runs give different bits"
    ref = dcov_gram_ref(cols)
    torch.testing.assert_close(gram, ref, atol=1e-4 * ref.abs().max().item(), rtol=0)
    assert_near_float64(gram, dcov_gram_ref(cols, dtype=torch.float64))
    if c == 1:
        return
    d = c - 1
    got = dcor_all_blocked(cols[:, :d], cols[:, d:])
    diag = torch.diagonal(ref)
    want = dcor_from_sums(ref[:d, d:], diag[:d, None], diag[None, d:])
    torch.testing.assert_close(got, want, atol=1e-3, rtol=0)


@pytest.mark.gpu
def test_dcov_gram_kernel_at_an_exact_zero_pair(cuda):
    """A noise-free landscape (a full factorial grid of the knobs) in which
    tau does not depend on gpu_freq: their dCor is exactly 0, and any
    float32 rounding of <A,B> shows under the square root. The kernel is
    held to float64 in normalised-Gram terms there, and in dCor elsewhere."""
    from repro_torch.experiments import scenarios

    cell = scenarios.enumerate_cells(workloads=scenarios.FULL_MATRIX_WORKLOADS)[9]
    sim0 = scenarios.cell_simulator(cell, noise=0.0)
    land = np.stack(sim0.exact_all(), axis=1)
    cols = torch.from_numpy(np.concatenate([sim0.space.grid(), land], 1).astype(np.float32))
    cols = cols.to(cuda)
    gram = dcov_gram(cols)
    ref64 = dcov_gram_ref(cols, dtype=torch.float64)
    g, t = sim0.space.index("gpu_freq"), len(sim0.space.names)  # columns: knobs, tau, p
    assert normalised_gram(ref64)[g, t].abs().item() < 1e-12  # an exact zero: dCor < 1e-6
    assert_near_float64(gram, ref64)


@pytest.mark.gpu
def test_offload_cells_on_the_card_reproduce_the_record(cuda):
    """The 4 offload cells x 3 seeds through ``run_matrix`` on the card: one
    batched call of OFFLOAD_ITERS steps, one windows-kernel launch each,
    its records and summary keys equal to ``BENCH_matrix.json``'s (floats
    at rel 1e-12, the rest exactly)."""
    import json
    from pathlib import Path

    from repro_torch.experiments import matrix, scenarios

    record = json.loads((Path(__file__).resolve().parents[1] / "BENCH_matrix.json").read_text())
    before = runtime.launch_counts()["dcov"]
    rec = matrix.run_matrix([], offload_cells=scenarios.MATRIX_OFFLOAD_CELLS, device="cuda")
    assert runtime.launch_counts()["dcov"] == before + matrix.OFFLOAD_ITERS
    assert matrix.diff_records(rec["offload_cells"], record["offload_cells"]) == []
    keys = [k for k in record["summary"] if "offload" in k]
    assert len(keys) == 4
    assert matrix.diff_records({k: rec["summary"][k] for k in keys},
                               {k: record["summary"][k] for k in keys}) == []


@pytest.mark.gpu
def test_fleet_on_the_card_reproduces_the_record(cuda):
    """The 1024-twin fleet on the card: one cold call and one warm call of
    30 steps, one windows-kernel launch each, and the results block equal
    to ``BENCH_fleet.json``'s key for key."""
    import json
    from pathlib import Path

    from repro_torch.experiments.fleet import run_fleet

    record = json.loads((Path(__file__).resolve().parents[1] / "BENCH_fleet.json").read_text())
    before = runtime.launch_counts()["dcov"]
    rec = run_fleet(1024, seed=0, iters=30, window=12, device="cuda")
    assert runtime.launch_counts()["dcov"] == before + 2 * 30
    assert json.dumps(rec["results"], sort_keys=True) == json.dumps(
        record["results"], sort_keys=True)
    assert rec["engine"]["backend"] == "cuda" and rec["engine"]["peak_device_bytes"] > 0


def _lanes_on_and_off(monkeypatch, fn):
    """``fn``'s result and its dcov launches with the contract and NaN
    lanes off, then on."""
    out = []
    for on in (False, True):
        for name in ("REPRO_CONTRACTS", "REPRO_CHECKIFY"):
            if on:
                monkeypatch.setenv(name, "1")
            else:
                monkeypatch.delenv(name, raising=False)
        before = runtime.launch_counts()["dcov"]
        res = fn()
        out.append((res, runtime.launch_counts()["dcov"] - before))
    return out


@pytest.mark.gpu
def test_lanes_leave_a_static_call_unchanged(cuda, monkeypatch):
    """A static call over the grid (54 cells x 3 seeds) with the lanes on
    gives the lane-off record exactly, with the same dcov launches (one
    per step)."""
    from repro_torch.experiments import matrix, scenarios

    cells = scenarios.enumerate_cells(workloads=scenarios.FULL_MATRIX_WORKLOADS)
    (off, n_off), (on, n_on) = _lanes_on_and_off(
        monkeypatch, lambda: matrix.run_matrix(cells, device="cuda"))
    assert n_on == n_off == 10
    assert matrix.diff_records(on["cells"], off["cells"], rel=0.0) == []
    assert on["summary"] == off["summary"]


@pytest.mark.gpu
def test_lanes_leave_a_fleet_call_unchanged(cuda, monkeypatch):
    """The 64-twin fleet with the lanes on gives the lane-off results block
    exactly, with the same dcov launches (30 in each of its calls)."""
    import json

    from repro_torch.experiments.fleet import run_fleet

    (off, n_off), (on, n_on) = _lanes_on_and_off(
        monkeypatch, lambda: run_fleet(64, seed=0, iters=30, window=12, device="cuda"))
    assert n_on == n_off == 2 * 30
    assert json.dumps(on["results"], sort_keys=True) == json.dumps(off["results"],
                                                                   sort_keys=True)


GRAPH_ARCHS = ["qwen2.5-3b", "mamba2-2.7b", "hymba-1.5b", "deepseek-v2-236b",
               "moonshot-v1-16b-a3b"]
EXTRAS_ARCHS = ["whisper-medium", "qwen2-vl-72b"]  # through the engine, not the runtime


def _graph_engines(arch, batch=2, max_len=48):
    """An eager and a graphed engine over the same reduced bf16 weights
    (Hymba with 4 layers, so that one slides its window)."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.configs.runtime import RunConfig
    from repro_torch.models.transformer import ApplyCtx, init_model_params
    from repro_torch.serving import ServingEngine

    cfg = get_config(arch).reduced()
    if cfg.arch_type == "hybrid":
        cfg = dataclasses.replace(cfg, n_layers=4)
    ctx = ApplyCtx(cfg, RunConfig(compute_dtype="bfloat16", use_kernels=True))
    params = init_model_params(cfg, ctx.rcfg, torch.Generator(device="cuda").manual_seed(0),
                               "cuda")
    return (ServingEngine(ctx, params, batch, max_len, graphs=False),
            ServingEngine(ctx, params, batch, max_len, graphs=True))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", GRAPH_ARCHS + EXTRAS_ARCHS)
def test_graphed_decode_is_bitwise_the_eager_step(cuda, arch):
    """The graph captures the whole step: Whisper's cross-attention read of
    the entry's cached encoder K/V and Qwen2-VL's M-RoPE positions too."""
    from repro_torch.launch.serve import multimodal_extras
    from repro_torch.serving.engine import capture_counts, reset_capture_counts

    reset_capture_counts()
    eager, graphed = _graph_engines(arch)
    rng = np.random.default_rng(3)
    vocab = eager.ctx.cfg.vocab
    prompt = rng.integers(0, vocab, (2, 20), dtype=np.int32)
    feeds = rng.integers(0, vocab, (12, 2, 1), dtype=np.int32)
    extras = multimodal_extras(eager.ctx.cfg, 2, seed=3, std=1.0)
    out = {}
    for name, eng in (("eager", eager), ("graphed", graphed)):
        k = eng.acquire()
        cache, logits = eng.prefill(prompt, extras, entry=k)
        steps = [logits.clone()]
        for tok in feeds:
            cache, logits = eng.decode(cache, tok)
            steps.append(logits.clone())
        torch.cuda.synchronize()
        out[name] = (steps, {(p, n): c.clone() for p in ("pro", "main") if p in cache
                             for n, c in cache[p].items()}, int(cache["length"]))
    assert capture_counts() == {graphed.ctx.cfg.name: 1} and len(graphed.pool) == 1
    (es, ec, el), (gs, gc, gl) = out["eager"], out["graphed"]
    assert el == gl == 20 + len(feeds)
    for a, b in zip(es, gs):
        assert torch.equal(a, b)
    for n in ec:
        assert torch.equal(ec[n], gc[n]), n


@pytest.mark.gpu
def test_graphed_engine_decodes_only_pool_entries(cuda):
    """On an engine with graphs the eager step is never taken implicitly:
    a cache from a prefill without a pool entry, or a prompt that fits
    no entry, raises; ``graphs=False`` is the way to the eager step."""
    eager, graphed = _graph_engines("qwen2.5-3b")
    prompt = np.zeros((2, 8), np.int32)
    cache, logits = graphed.prefill(prompt)
    tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    with pytest.raises(ValueError, match="pool-entry caches"):
        graphed.decode(cache, tok)
    with pytest.raises(ValueError, match="does not fit a pool entry"):
        graphed.generate(np.zeros((3, 8), np.int32), 2)
    cache, logits = eager.prefill(prompt)
    assert eager.decode(cache, tok)[1].shape == logits.shape
    assert not graphed.pool and not eager.pool


@pytest.mark.gpu
def test_one_capture_per_pool_entry(cuda):
    from repro_torch.serving import Request, ServingRuntime
    from repro_torch.serving.engine import capture_counts, reset_capture_counts

    _, graphed = _graph_engines("qwen2.5-3b")
    reset_capture_counts()
    for c in (3, 2):  # a second runtime reuses the entries of the first
        rt = ServingRuntime(graphed, concurrency=c)
        rng = np.random.default_rng(c)
        for rid in range(12):
            rt.submit(Request(rid, rng.integers(0, 500, 16, dtype=np.int32), 5))
        m = rt.drain()
        assert m["requests"] == 12
    assert len(graphed.pool) == 3 and capture_counts() == {graphed.ctx.cfg.name: 3}
    assert not any(e.busy for e in graphed.pool)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_static_logits_are_read_before_the_next_replay(cuda, arch):
    """Three slots in flight on one queue: each retire's tokens come from
    its own slot's step, so the graphed runtime gives every request the
    tokens the eager runtime gives it."""
    from repro_torch.serving import Request, ServingRuntime

    outputs = {}
    for eng in _graph_engines(arch):
        rt = ServingRuntime(eng, concurrency=3)
        rng = np.random.default_rng(7)
        for rid in range(10):
            rt.submit(Request(rid, rng.integers(0, eng.ctx.cfg.vocab, 12, dtype=np.int32),
                              6 + rid % 3))
        rt.drain()
        outputs[eng.graphs] = {r.rid: r.output.tolist() for r in rt.done}
    assert len(outputs[True]) == 10
    assert outputs[True] == outputs[False]


@pytest.mark.gpu
def test_capture_survives_a_collected_engine(cuda):
    """An engine left in a reference cycle (runtime <-> tenant ring) is
    freed by the garbage collector, graphs and all; a graph freed while
    another is being captured invalidates that capture. With collections
    made as frequent as they go, a new engine still captures its pool."""
    import gc

    from repro_torch.serving import ServingEngine, ServingRuntime
    from repro_torch.serving.engine import capture_counts, reset_capture_counts

    _, old = _graph_engines("qwen2.5-3b")
    old.acquire()
    ctx, params = old.ctx, old.params
    ServingRuntime(old)  # the cycle that holds the engine until a collection
    del old
    reset_capture_counts()
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        new = ServingEngine(ctx, params, 2, 48, graphs=True)
        new.reserve(2)
    finally:
        gc.set_threshold(*thresholds)
    assert len(new.pool) == 2 and capture_counts() == {ctx.cfg.name: 2}


# ------------------------------------------------------------- ssm decode

# (B, nh, hd, N): the Mamba2 cell's (B 32), Hymba-1.5B's at B 32 and 3, the
# reduced models' at B 2
SSM_DECODE_SHAPES = [(32, 80, 64, 128), (3, 80, 64, 128), (32, 50, 64, 16), (3, 50, 64, 16),
                     (2, 16, 16, 16)]


def _ssm_decode_inputs(b, nh, hd, n, dtype, seed=0):
    """The state step's inputs as the model passes them: x, B and C views of
    one convolution output (B, 1, nh hd + 2N), raw dt a view of a wider
    projection row, the bf16 state a layer of a stacked cache; dt_bias,
    A_log in Mamba2's ranges (as ``tests/test_torch_ssm.py`` draws them)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    di = nh * hd
    xbc = torch.randn(b, 1, di + 2 * n, generator=g, device="cuda").to(dtype)
    proj = torch.randn(b, 1, nh + 24, generator=g, device="cuda").to(dtype)
    cache = torch.randn(2, b, nh, hd, n, generator=g, device="cuda").to(torch.bfloat16)
    heads = torch.rand(3, nh, generator=g, device="cuda")
    x = xbc[..., :di].reshape(b, nh, hd)
    return (cache[1], x, proj[:, 0, 24:], -4 + 3 * heads[0], torch.log(1 + 15 * heads[1]),
            xbc[:, 0, di:di + n], xbc[:, 0, di + n:], 1 + heads[2])


def _bf16_ulp(v):
    """One bf16 ulp at the magnitude of each element of ``v``."""
    v = v.float().abs().clamp_min(2.0 ** -100)
    return 2.0 ** (torch.floor(torch.log2(v)) - 7)


def _ssm_decode_close(y, y_ref, state, state_ref, y_sum):
    """The state bit for bit; y in float32 within 1e-5 max|y| (the sum's
    order only); y in bf16 within one bf16 ulp of the sum y_p = Σ_n C s'
    (the two float32 sums may round to neighbouring bf16 values before the
    skip is added) and one of y (the skip's sum rounded once more), at each
    element."""
    assert state.dtype == torch.bfloat16 and torch.equal(state, state_ref)
    assert y.shape == y_ref.shape and y.dtype == y_ref.dtype
    if y.dtype == torch.float32:
        torch.testing.assert_close(y, y_ref, atol=1e-5 * y_ref.abs().max().item(), rtol=0)
        return
    tol = _bf16_ulp(y_sum.to(torch.bfloat16)) + _bf16_ulp(torch.maximum(y.float().abs(),
                                                                       y_ref.float().abs()))
    err = (y.float() - y_ref.float()).abs()
    ulps = bf16_ulps(y, y_ref)
    print(f"y: {(ulps > 0).float().mean().item():.4%} of elements apart, "
          f"at most {ulps.max().item()} ulps of y")
    assert bool((err <= tol).all()), (err / tol).max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("b,nh,hd,n", SSM_DECODE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_decode_kernel_matches_ref(cuda, b, nh, hd, n, dtype):
    """One launch against the plain version on the card, on the model's
    strided views: the new state held bit for bit (the kernel follows the
    plain version's operations and order, with no FMA), y as
    ``_ssm_decode_close`` says. Ten chained steps, new inputs each step,
    are held the same way after every step."""
    args = _ssm_decode_inputs(b, nh, hd, n, dtype)
    state_ref = args[0].clone()
    for step in range(10):
        if step:
            args = (args[0],) + _ssm_decode_inputs(b, nh, hd, n, dtype, seed=step)[1:]
        before = runtime.launch_counts()["ssm_decode"]
        y = ssm_decode(*args)
        torch.cuda.synchronize()
        assert runtime.launch_counts()["ssm_decode"] == before + 1
        _, new_state = ssm_step_ref(state_ref.float(), *args[1:])
        y_sum = torch.einsum("bn,bhpn->bhp", args[6].float(), new_state)
        y_ref = ssm_decode_ref(state_ref, *args[1:])
        _ssm_decode_close(y, y_ref, args[0], state_ref, y_sum)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "hymba-1.5b"])
def test_captured_decode_step_runs_the_ssm_decode_kernel(cuda, arch):
    """Full width and depth, bf16: capturing the decode step records one
    ``ssm_decode`` launch per layer (64 for Mamba2-2.7B, 32 for
    Hymba-1.5B), the three warm-up steps as many each, and replays none;
    eight replays give the eager step's logits and caches bit for bit."""
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.runtime import RunConfig
    from repro_torch.models.transformer import ApplyCtx, init_model_params
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.engine import WARMUP_STEPS

    cfg = get_config(arch)
    ctx = ApplyCtx(cfg, RunConfig(compute_dtype="bfloat16", use_kernels=True))
    params = init_model_params(cfg, ctx.rcfg, torch.Generator(device="cuda").manual_seed(0),
                               "cuda")
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab, (4, 32), dtype=np.int32)
    feeds = rng.integers(0, cfg.vocab, (8, 4, 1), dtype=np.int32)
    out = {}
    for graphs in (False, True):
        eng = ServingEngine(ctx, params, 4, 48, graphs=graphs)
        runtime.reset_launch_counts()
        k = eng.acquire()
        if graphs:
            assert runtime.launch_counts()["ssm_decode"] == (WARMUP_STEPS + 1) * cfg.n_layers
        runtime.reset_launch_counts()
        cache, logits = eng.prefill(prompt, entry=k)
        steps = [logits.clone()]
        for tok in feeds:
            cache, logits = eng.decode(cache, tok)
            steps.append(logits.clone())
        torch.cuda.synchronize()
        launches = runtime.launch_counts()["ssm_decode"]
        assert launches == (0 if graphs else len(feeds) * cfg.n_layers)
        if graphs:
            assert eng.replays == len(feeds)
        out[graphs] = (steps, cache["main"]["ssm"].clone(), cache["main"]["conv"].clone())
        del eng, cache
    for a, b in zip(out[False][0], out[True][0]):
        assert torch.equal(a, b)
    assert torch.equal(out[False][1], out[True][1]) and torch.equal(out[False][2], out[True][2])


# ----------------------------------------------------------------- training


@pytest.mark.gpu
def test_wrappers_refuse_grad_on_the_card(cuda):
    """A requires-grad CUDA input under grad mode raises before any launch;
    under no_grad the same call launches the kernel."""
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(1, 2, 64, 64, generator=g, device="cuda", dtype=torch.bfloat16)
               for _ in range(3))
    x = torch.randn(1, 64, 2, 64, generator=g, device="cuda")
    dt = torch.rand(1, 64, 2, generator=g, device="cuda")
    A = -torch.rand(2, generator=g, device="cuda")
    Bm, Cm = (torch.randn(1, 64, 16, generator=g, device="cuda") for _ in range(2))
    cols = torch.randn(3, 10, 7, generator=g, device="cuda")
    n_valid = torch.tensor([10, 7, 3], dtype=torch.int32, device="cuda")
    dec = _ssm_decode_inputs(2, 4, 16, 16, torch.bfloat16)
    calls = {
        "flash_attention": lambda t: flash_attention_bhsd(t, k, v),
        "ssd_scan": lambda t: ssd_scan(t, dt, A, Bm, Cm, chunk=64),
        "dcov": lambda t: dcov_gram_windows(t, n_valid),
        "ssm_decode": lambda t: ssm_decode(dec[0], t, *dec[2:]),
    }
    first = {"flash_attention": q, "ssd_scan": x, "dcov": cols, "ssm_decode": dec[1]}
    for name, call in calls.items():
        leaf = first[name].clone().requires_grad_(True)
        runtime.reset_launch_counts()
        with pytest.raises(RuntimeError, match="no backward"):
            call(leaf)
        assert runtime.launch_counts()[name] == 0
        with torch.no_grad():
            call(leaf)
        torch.cuda.synchronize()
        assert runtime.launch_counts()[name] == 1
    with pytest.raises(RuntimeError, match="dcov_gram.*no backward"):
        dcov_gram(cols[0].clone().requires_grad_(True))


def _train_losses(arch, device, steps=5):
    """Reduced ``arch``'s losses and grad norms over ``steps`` train steps in
    float32 compute, from parameters drawn on the CPU (seed 0) and moved to
    ``device``: the same start on both devices."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.train import run_config
    from repro_torch.models.transformer import ApplyCtx, init_model_params
    from repro_torch.training import AdamWConfig, SyntheticLM, adamw, make_train_step
    from repro_torch.training.data import multimodal_extras

    cfg = get_config(arch).reduced()
    rcfg = run_config("none", "float32")
    params = init_model_params(cfg, rcfg, torch.Generator().manual_seed(0), "cpu")
    params = adamw.tree_map(lambda t: t.to(device), params)
    step = make_train_step(ApplyCtx(cfg, rcfg), AdamWConfig(lr=2e-3, warmup_steps=2,
                                                             total_steps=10))
    opt = adamw.init(params)
    data = SyntheticLM(cfg.vocab, 32, 8, seed=0)
    extras = multimodal_extras(cfg, 8, 0)
    out = []
    for i in range(steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in dict(data.batch(i), **extras).items()}
        params, opt, m = step(params, opt, batch)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "moonshot-v1-16b-a3b", "mamba2-2.7b"])
def test_reduced_train_steps_on_the_card_match_the_cpu(cuda, arch):
    """Five steps from the same parameters: each loss and grad norm within
    1e-4 relative (float32, TF32 off; summation order only, carried on by
    the updates)."""
    card, cpu = _train_losses(arch, "cuda"), _train_losses(arch, "cpu")
    for i, ((lc, gc), (lh, gh)) in enumerate(zip(card, cpu)):
        assert lc == pytest.approx(lh, rel=1e-4), (i, card, cpu)
        assert gc == pytest.approx(gh, rel=1e-4), (i, card, cpu)
    assert card[-1][0] < card[0][0]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-2.7b", "hymba-1.5b"])
def test_bf16_eval_through_the_kernels_matches_the_plain_eval(cuda, arch):
    """The eval step with ``use_kernels=True`` (bf16 compute, parameters that
    require grad, as after training) launches flash and/or SSD once per
    layer, and its xent is within 2e-2 of the plain eval's (both round
    to bf16 at other places, 2^-8 relative, on a loss near 6)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.runtime import RunConfig
    from repro_torch.models.transformer import ApplyCtx, init_model_params
    from repro_torch.training import SyntheticLM, adamw, make_eval_step

    cfg = get_config(arch).reduced()
    params = init_model_params(cfg, RunConfig(), torch.Generator(device="cuda").manual_seed(0),
                               "cuda")
    for p in adamw.leaves(params):
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v).cuda() for k, v in SyntheticLM(cfg.vocab, 64, 4).batch(0).items()}
    runtime.reset_launch_counts()
    got = make_eval_step(ApplyCtx(cfg, RunConfig(use_kernels=True)))(params, batch)
    counts = runtime.launch_counts()
    plain = make_eval_step(ApplyCtx(cfg, RunConfig()))(params, batch)
    assert runtime.launch_counts() == counts
    want_flash = 0 if cfg.arch_type == "ssm" else cfg.n_layers
    want_ssd = cfg.n_layers if cfg.arch_type in ("ssm", "hybrid") else 0
    assert (counts["flash_attention"], counts["ssd_scan"]) == (want_flash, want_ssd)
    assert torch.isfinite(got["xent"])
    assert abs(got["xent"].item() - plain["xent"].item()) <= 2e-2


# ---------------------------------------------------------------------------
# Multi-device launch on the card (tools/dryrun_card_check.py,
# tools/moe_ep_check.py), each in processes of their own
# ---------------------------------------------------------------------------

PEAK_REL, PEAK_ABS = 0.10, 256 << 20  # the dry run's peak against the card's allocator


def _tool(*args) -> list:
    """Run a tool from the repository root; its JSON lines."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, *args], capture_output=True, text=True, timeout=600,
                       cwd=root)
    assert r.returncode == 0, r.stderr[-3000:]
    return [json.loads(line) for line in r.stdout.splitlines() if line.startswith("{")]


@pytest.mark.gpu
def test_dryrun_counts_a_card_prefill(cuda):
    """Reduced Qwen2.5-3B's prefill (4 x 512) on a 1×1 mesh: the dry run's
    argument bytes and matmul FLOPs equal the card run's exactly, and its
    peak is within max(10 %, 256 MB) of ``max_memory_allocated``."""
    dry = _tool("tools/dryrun_card_check.py", "--mode", "dry", "--reduced")[-1]
    real = _tool("tools/dryrun_card_check.py", "--mode", "real", "--reduced")[-1]
    assert real["finite"]
    assert dry["argument_bytes"] == real["argument_bytes"]
    assert dry["flops"] == real["flops"]
    assert dry["collective_bytes"] == 0
    assert abs(dry["peak_bytes"] - real["peak_bytes"]) <= max(PEAK_REL * real["peak_bytes"], PEAK_ABS)


@pytest.mark.gpu
def test_expert_parallel_on_the_card(cuda):
    """Reduced Moonlight-16B-A3B's MoE layer over 2 gloo ranks on the
    card's tensors (a 1×2 mesh: two expert owners; 2×1: the tokens split
    over data and gathered back), float32: EP and EP2D equal the dense
    path within 2e-4 at capacity factor 8."""
    rows = _tool("tools/moe_ep_check.py", "--reduced", "--ranks", "2", "--meshes", "1x2", "2x1",
                 "--tokens", "4x64", "4x1", "--dtype", "float32", "--reps", "1")
    assert len(rows) == 16
    for r in rows:
        if r["capacity_factor"] == 8.0:
            assert r["max_abs_err"] < 2e-4, r
            assert r["dropped_share"] == 0.0, r
