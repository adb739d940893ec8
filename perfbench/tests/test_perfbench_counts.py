"""The FLOP and byte counts against cases worked by hand (the Bound column
of PERF.md's kernel table) and against each other."""
import json
from pathlib import Path

import pytest

from perfbench.counts import flash, model, peaks, ssd

PB = Path(__file__).resolve().parents[1]


def test_flash_at_the_qwen_serving_shape():
    # B=4, Hq=16, Hkv=2, S=512, D=Dv=128, causal, bf16: 4.30 GFLOP, 18.9 MB, 5.63 us
    f = flash.flops(4, 16, 512, 512, 128, 128)
    b = flash.nbytes(4, 16, 2, 512, 512, 128, 128)
    assert f == pytest.approx(4.30e9, rel=2e-3)
    assert b == pytest.approx(18.87e6, rel=1e-3)
    assert peaks.bound_s(f, b) == pytest.approx(5.63e-6, rel=2e-3)


def test_flash_at_4096_is_compute_bound():
    f = flash.flops(1, 16, 4096, 4096, 128, 128)
    assert f == pytest.approx(68.7e9, rel=1e-3)
    assert peaks.bound_s(f, flash.nbytes(1, 16, 2, 4096, 4096, 128, 128)) == pytest.approx(
        69.5e-6, rel=2e-3)


def test_flash_pairs():
    assert flash.pairs(4, 4) == 10 and flash.pairs(4, 4, causal=False) == 16
    assert flash.pairs(1, 8) == 8  # one decode query over 8 keys


def test_ssd_at_the_mamba2_and_hymba_serving_shapes():
    # Mamba2: B=4, S=512, nh=80, hd=64, N=128: 54.1 MB, 16.2 us
    b = ssd.nbytes(4, 512, 80, 64, 128)
    assert b == pytest.approx(54.13e6, rel=1e-3)
    assert peaks.bound_s(ssd.flops(4, 512, 80, 64, 128, 256), b) == pytest.approx(16.16e-6, rel=2e-3)
    # Hymba: nh=50, N=16: 27.6 MB, 2.11 GFLOP
    assert ssd.nbytes(4, 512, 50, 64, 16) == pytest.approx(27.6e6, rel=2e-3)
    assert ssd.flops(4, 512, 50, 64, 16, 256) == pytest.approx(2.11e9, rel=3e-3)


def _conf(name):
    return json.loads((PB / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["qwen2.5-3b", "mamba2-2.7b"])
def test_model_steps_near_two_flops_per_parameter(name):
    c = _conf(name)
    d, v, L = c["hidden_size"], c["vocab_size"], c["num_hidden_layers"]
    if c["family"] == "qwen2":
        per_layer = (d * 16 * 128 * 2 + 2 * d * 2 * 128 + 3 * d * c["intermediate_size"])
    else:
        di = 2 * d
        per_layer = d * (2 * di + 2 * 128 + 80) + di * d
    params = L * per_layer + d * v
    step = model.decode_flops(c, 1, 0)
    # a Mamba2 step also updates its state: 4 FLOP per (head, hd, N) element
    state = 4 * 80 * 64 * 128 * L if c["family"] == "mamba2" else 0
    assert step == pytest.approx(2 * params + state, rel=1e-3)
    # a prefill of S tokens is S decode steps' matmuls, the head once
    s = 256
    pre = model.prefill_flops(c, 2, s)
    assert pre > 2 * (s * 2 * L * per_layer)
    assert pre < 2 * (s * step)


def test_decode_attention_grows_with_the_cache():
    c = _conf("qwen2.5-3b")
    grow = model.decode_flops(c, 1, 1000) - model.decode_flops(c, 1, 0)
    assert grow == pytest.approx(36 * 2 * 16 * 2 * 128 * 1000)


def _traced_prefill(kernels):
    """What a reader sees of a trace holding one prefill of a two-layer
    model (B=1, S=4096) whose span kept ``kernels``."""
    from types import SimpleNamespace

    return SimpleNamespace(
        conf={"num_hidden_layers": 2},
        prefills=[{"traced": 0, "batch": 1, "s": 4096}],
        trace={"spans_lost": 0,
               "spans": [{"name": "perfbench.prefill", "kernels": kernels}]})


def _flash_bound(p):
    return (flash.flops(p["batch"], 16, p["s"], p["s"], 128, 128),
            flash.nbytes(p["batch"], 16, 2, p["s"], p["s"], 128, 128))


@pytest.mark.parametrize("kernels,share", [
    # each layer's launch at twice its 69.5 us bound
    ({"flash_fwd_wgmma<128>": [2, 4 * 69.5e-6], "gemm": [9, 1.0]}, 50.0),
    # a layer's record lost, one doubled, none linked to the span: not read
    ({"flash_fwd_wgmma<128>": [1, 2 * 69.5e-6]}, None),
    ({"flash_fwd_wgmma<128>": [3, 6 * 69.5e-6]}, None),
    ({"gemm": [9, 1.0]}, None),
])
def test_roofline_share_reads_only_whole_prefills(kernels, share):
    import re

    from perfbench.trace import roofline_share

    got = roofline_share(_traced_prefill(kernels), re.compile("flash_fwd"), _flash_bound)
    if share is None:
        assert got is None
    else:
        assert got == pytest.approx(share, rel=2e-3)
