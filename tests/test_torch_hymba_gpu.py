"""The published Hymba's kernels on the card, against their plain PyTorch
versions: the Mamba-1 selective scan (``kernels/selective_scan``) and the
flash kernel's (D, Dv) = (64, 128) body with a sink. Every test is marked
``gpu`` and skips without a CUDA device (a CUDA kernel has no CPU mode);
this file imports no JAX:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_hymba_gpu.py

Tolerances. The scan: y within 1e-2 × max|y| (both sides round one
float32 value to bf16, 2^-8 of it, and the kernel's decay is ``ex2.approx``
of dt·A·log2(e), a few float32 ulps from ``exp``, carried through the
recurrence), the bf16 final state within 1e-2 × max|h| (one bf16 rounding
on each side of float32 states that differ by the same few ulps). Flash:
atol 3e-2 in bf16 (one bf16 rounding of outputs of magnitude <= ~2), as
``tests/test_torch_kernels_gpu.py``. The graphed decode step of a reduced
published Hymba: bitwise the eager step (the same kernels in the same
order).
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # the benchmark's family file and weights
    sys.path.insert(0, str(ROOT))

from perfbench import weights  # noqa: E402
from perfbench.families import hymba as family  # noqa: E402
from perfbench.program import param_shapes  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.configs.runtime import RunConfig  # noqa: E402
from repro_torch.kernels import runtime  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_ref,
    body_for,
    flash_attention_bhsd,
)
from repro_torch.kernels.selective_scan import selective_scan, selective_scan_ref  # noqa: E402
from repro_torch.models.transformer import ApplyCtx  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

# (B, S, di): the cell's longest prefill (128 meta + 7,936), its shortest,
# a ragged length (not a multiple of the kernel's 16-position chunk), and a
# channel count that leaves a warp part-filled
SCAN_SHAPES = [(8, 8064, 3200), (8, 2176, 3200), (3, 1001, 3200), (2, 77, 200)]
# (B, Hq, Hkv, S, window, sink): the cell's window layers at its shortest
# prefill, windows that cross tile edges with sinks inside, across and
# beyond the first key tile, and full causal attention (a global layer)
FLASH_CASES = [
    (8, 25, 5, 2176, 1024, 128),
    (2, 25, 5, 1100, 256, 128),
    (2, 4, 2, 700, 64, 16),
    (1, 4, 2, 900, 200, 300),
    (2, 10, 5, 640, 128, 0),
    (2, 25, 5, 1500, None, 0),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _scan_inputs(device, b, s, di, n=16, seed=0):
    """bf16 x, raw dt, z (views of one wider tensor, as the model's), B and
    C; float32 dt_bias, A_log, D as the cell's configuration draws them."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    wide = torch.randn((b, s, 3 * di + 8), generator=g)
    x, dt, z = wide[..., :di], wide[..., di:2 * di], wide[..., 2 * di + 8:]
    bm, cm = torch.randn((2, b, s, n), generator=g)
    dt_bias = torch.log(torch.expm1(torch.exp(torch.rand(di, generator=g) * 4.6 - 6.9)))
    a_log = torch.log(torch.rand((di, n), generator=g) * 15 + 1)
    d = 1 + 0.1 * torch.randn(di, generator=g)
    to = lambda t, dtype=torch.bfloat16: t.to(device, dtype)  # noqa: E731
    wide = to(wide)
    return (wide[..., :di], wide[..., di:2 * di], to(dt_bias, torch.float32),
            to(a_log, torch.float32), to(bm), to(cm), to(d, torch.float32),
            wide[..., 2 * di + 8:])


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,di", SCAN_SHAPES)
def test_selective_scan_matches_the_plain_scan(cuda, b, s, di):
    x, dt, dt_bias, a_log, bm, cm, d, z = _scan_inputs(cuda, b, s, di)
    assert x.stride(1) != di and z.stride(1) != di  # the model's strided views
    state = torch.empty((b, di, 16), dtype=torch.bfloat16, device=cuda)
    before = runtime.launch_counts()["selective_scan"]
    y = selective_scan(x, dt, dt_bias, a_log, bm, cm, d, z, state)
    torch.cuda.synchronize()
    assert runtime.launch_counts()["selective_scan"] == before + 1
    assert y.shape == (b, s, di) and y.dtype == torch.bfloat16
    y_ref, h_ref = selective_scan_ref(x, dt, dt_bias, a_log, bm, cm, d, z)
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=0,
                               atol=1e-2 * y_ref.float().abs().max().item())
    torch.testing.assert_close(state.float(), h_ref, rtol=0,
                               atol=1e-2 * h_ref.abs().max().item())


@pytest.mark.gpu
def test_selective_scan_refuses_what_it_does_not_take(cuda):
    x, dt, dt_bias, a_log, bm, cm, d, z = _scan_inputs(cuda, 1, 32, 64)
    with pytest.raises(TypeError):
        selective_scan(x.float(), dt.float(), dt_bias, a_log, bm.float(), cm.float(), d, z.float())
    with pytest.raises(ValueError):
        selective_scan(x, dt, dt_bias, a_log[:, :8], bm[..., :8], cm[..., :8], d, z)


@pytest.mark.gpu
@pytest.mark.parametrize("b,hq,hkv,s,window,sink", FLASH_CASES)
def test_flash_d64_dv128_with_a_sink(cuda, b, hq, hkv, s, window, sink):
    rng = np.random.default_rng(s)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda, torch.bfloat16)
               for shape in ((b, hq, s, 64), (b, hkv, s, 64), (b, hkv, s, 128)))
    assert body_for(q, k, v, window) == "wgmma"
    out = flash_attention_bhsd(q, k, v, causal=True, window=window, sink=sink)
    torch.cuda.synchronize()
    ref = attention_ref(q, k, v, causal=True, window=window, sink=sink)
    torch.testing.assert_close(out.float(), ref.float(), atol=3e-2, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d,dv", [(torch.float32, 64, 128), (torch.bfloat16, 32, 32),
                                        (torch.bfloat16, 64, 64)])
def test_flash_sink_on_the_other_bodies(cuda, dtype, d, dv):
    """The sink on the simt body (float32), the mma body (D = Dv = 32) and
    the wgmma body at (64, 64): the same mask as ``attention_ref``'s."""
    rng = np.random.default_rng(d + dv)
    b, hq, hkv, s = 2, 4, 2, 333
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda, dtype)
               for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, dv)))
    out = flash_attention_bhsd(q, k, v, causal=True, window=70, sink=20)
    torch.cuda.synchronize()
    ref = attention_ref(q, k, v, causal=True, window=70, sink=20)
    atol = 2e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)


@pytest.mark.gpu
def test_graphed_hymba_decode_is_bitwise_the_eager_step(cuda):
    """A reduced published Hymba (the family's mapping of a cut configuration
    file): the engine's graph of the decode step against the eager step on
    the same cache, logits and every cache tensor bitwise, over 6 steps
    that run past the window and the meta tokens."""
    conf = json.loads((ROOT / "perfbench" / "configs" / "hymba-1.5b.json").read_text())
    conf.update(num_hidden_layers=4, global_attn_idx=[0, 3], kv_reuse_group=[[1, 2]],
                num_memory_tokens=8, sliding_window=16)
    cfg = family.model_config(conf, get_config(conf["registry"]))
    params = weights.draw(conf, param_shapes(cfg), 5, cuda)
    rcfg = RunConfig(param_dtype="bfloat16", compute_dtype="bfloat16", use_kernels=True)
    graphed = ServingEngine(ApplyCtx(cfg, rcfg), params, 2, 64)
    eager = ServingEngine(ApplyCtx(cfg, rcfg), params, 2, 64, graphs=False)
    prompt = np.random.default_rng(1).integers(0, conf["vocab_size"], (2, 20), dtype=np.int32)
    kg = graphed.acquire()
    cg, lg = graphed.prefill(prompt, entry=kg)
    ce, le = eager.prefill(prompt)
    for step in range(6):
        tok = lg[:, -1].float().argmax(-1, keepdim=True).to(torch.int32)
        torch.testing.assert_close(le, lg, atol=0, rtol=0)
        cg, lg = graphed.decode(cg, tok)
        ce, le = eager.decode(ce, tok)
        torch.cuda.synchronize()
    torch.testing.assert_close(le, lg, atol=0, rtol=0)
    for name in ("k", "v", "ssm", "conv"):
        torch.testing.assert_close(ce["main"][name], cg["main"][name], atol=0, rtol=0)
    assert graphed.kv_caches == cfg.n_kv_caches == 3 and graphed.prefix_tokens == 8
