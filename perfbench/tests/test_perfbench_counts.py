"""The FLOP and byte counts against cases worked by hand (the Bound column
of PERF.md's kernel table), against the values they had before each
family had a file of its own, against the program's parameter tree, and
against each other."""
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


# (rows, t) -> decode FLOPs and (rows, s) -> prefill FLOPs, as counted
# before the formulas moved into the family files
PARENT_FLOPS = {
    "qwen2.5-3b": {
        ("decode", 1, 0): 6171688960.0, ("decode", 32, 300): 200325201920.0,
        ("decode", 23, 777): 147219218432.0, ("prefill", 1, 128): 713337339904.0,
        ("prefill", 32, 512): 92175148777472.0, ("prefill", 7, 300): 11750598049792.0},
    "mamba2-2.7b": {
        ("decode", 1, 0): 5568512000.0, ("decode", 32, 300): 178192384000.0,
        ("decode", 23, 777): 128075776000.0, ("prefill", 1, 128): 724093681664.0,
        ("prefill", 32, 512): 88467385614336.0, ("prefill", 7, 300): 11719634927616.0},
}


@pytest.mark.parametrize("name,step,rows,t", [
    (n, *k) for n, v in PARENT_FLOPS.items() for k in v])
def test_flops_are_as_before_the_families_had_files(name, step, rows, t):
    count = model.decode_flops if step == "decode" else model.prefill_flops
    assert count(_conf(name), rows, t) == PARENT_FLOPS[name][(step, rows, t)]


def test_qwen_decode_bytes_by_hand():
    c = _conf("qwen2.5-3b")
    d, L, ff, v = 2048, 36, 11008, 151936
    params = (v * d + d + L * (2 * d * 2048 + 2 * d * 256 + 3 * d * ff + 2048 + 2 * 256 + 2 * d))
    assert params == pytest.approx(3.086e9, rel=1e-3)
    # bf16, the three norms in float32, the tied head read once
    assert model.decode_bytes(c, 0, 0) == 2 * params + 2 * d * (2 * L + 1)
    assert model.decode_bytes(c, 0, 0) == pytest.approx(6.17e9, rel=1e-3)
    # per live row and position: 36 layers' K and V, 2 heads of 128, bf16
    per_position = model.decode_bytes(c, 1, 1) - model.decode_bytes(c, 1, 0)
    assert per_position == 36 * 2 * 2 * 128 * 2 == 36864
    assert model.decode_bytes(c, 32, 499) - model.decode_bytes(c, 0, 499) == 32 * 500 * 36864


def test_mamba2_decode_bytes_by_hand():
    c = _conf("mamba2-2.7b")
    assert model.decode_bytes(c, 0, 0) == pytest.approx(5.40e9, rel=2e-3)
    # 32 rows' recurrent state (64 layers of 80 x 64 x 128) and conv state
    # (3 inputs of x, B and C: 5120 + 2 x 128) in bf16, read and written
    state = 32 * 64 * 80 * 64 * 128 * 2 * 2
    assert state == pytest.approx(5.37e9, rel=1e-3)
    conv = 32 * 64 * 3 * (5120 + 256) * 2 * 2
    for t in (0, 300, 1024):
        assert model.decode_bytes(c, 32, t) - model.decode_bytes(c, 0, t) == state + conv


def _leaves(tree):
    for k, v in tree.items():
        yield from (_leaves(v) if isinstance(v, dict) else [(k, v)])


@pytest.mark.parametrize("name", ["qwen2.5-3b", "mamba2-2.7b"])
@pytest.mark.parametrize("tiny", [False, True], ids=["published", "tiny"])
def test_weight_bytes_are_the_programs_parameter_tree(name, tiny):
    """The weights a step reads are every leaf of the program's tree, each
    in the dtype ``weights.draw`` serves it in."""
    import math

    from perfbench import manifest, program
    from perfbench.tests.conftest import TINY

    c = _conf(name)
    if tiny:
        c.update(next(sizes for base, sizes in TINY.values() if base == name))
    tree = program.param_shapes(program.model_config(c))
    want = sum(math.prod(shape) * model.itemsize(c, leaf) for leaf, shape in _leaves(tree))
    assert manifest.family_of(c).weight_bytes(c, 32) == want


def _decodes_in_window(device_s):
    from types import SimpleNamespace

    recs = [{"t": 1.0 + i, "rows": 20 + i, "pos": 300 + 10 * i, "device_s": device_s}
            for i in range(3)]
    recs.append({"t": 99.0, "rows": 32, "pos": 0, "device_s": device_s})  # after the window
    return SimpleNamespace(conf=_conf("mamba2-2.7b"), decodes=recs,
                           in_window=lambda rs: [r for r in rs if r["t"] <= 10.0])


@pytest.mark.parametrize("metric,count,peak", [
    ("decode_mfu", model.decode_flops, peaks.BF16_FLOPS),
    ("decode_hbm_share", model.decode_bytes, peaks.HBM_BYTES),
])
def test_the_model_steps_shares_of_the_peaks(metric, count, peak):
    from perfbench import manifest

    read = manifest.reader(metric).read
    obs = _decodes_in_window(0.01)
    want = sum(count(obs.conf, 20 + i, 300 + 10 * i) for i in range(3)) / 0.03 / peak
    assert read(obs) == pytest.approx(100.0 * want, rel=1e-12)
    assert read(_decodes_in_window(None)) is None


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
