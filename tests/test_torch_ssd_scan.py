"""The port's SSD chunked scan (``repro_torch.kernels.ssd_scan``) against the
JAX package's Pallas kernel, run as tests/test_kernels.py runs it on the
CPU (interpret mode), and against its jnp oracle ``ssd_ref``, on numpy
inputs from a seed.

On the CPU the port's wrapper takes its plain version (``ssd_ref``); the
CUDA kernel itself is held to it on the card by
tests/test_torch_kernels_gpu.py and by chip_smoke.py. Tolerances: float32
atol 1e-4, the reference's own (summation order only); bfloat16 y
1e-2 × max|y| (each side rounds its float32 result to bf16 once, so the
two may sit one bf16 ulp, 2^-7 of the value, apart).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd as jax_ssd
from repro.kernels.ssd_scan import ssd_ref as jax_ssd_ref
from repro_torch.kernels import runtime
from repro_torch.kernels.ssd_scan import ops, ssd, ssd_ref, ssd_scan
from repro_torch.kernels.ssd_scan.ssd_scan import MAX_SMEM_BYTES, smem_bytes

# (b, s, nh, hd, n, chunk): tests/test_kernels.py's sweep, then ragged tails
SWEEP = [
    (1, 32, 2, 16, 8, 8),
    (2, 64, 4, 16, 16, 16),
    (1, 48, 1, 8, 4, 16),
    (2, 45, 3, 16, 8, 16),  # S % chunk != 0
    (1, 5, 2, 8, 4, 8),  # shorter than one chunk
]
ATOL = 1e-4


def _inputs(seed, b, s, nh, hd, n):
    """dt and A drawn as in tests/test_kernels.py."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, nh, hd)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, size=(b, s, nh)).astype(np.float32)
    A = -rng.uniform(0.5, 2, size=(nh,)).astype(np.float32)
    Bm = rng.normal(size=(b, s, n)).astype(np.float32)
    Cm = rng.normal(size=(b, s, n)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("b,s,nh,hd,n,chunk", SWEEP)
def test_ssd_matches_jax(b, s, nh, hd, n, chunk):
    args = _inputs(s, b, s, nh, hd, n)
    y_pl, s_pl = jax_ssd(*(jnp.asarray(a) for a in args), chunk=chunk)
    y_jr, s_jr = jax_ssd_ref(*(jnp.asarray(a) for a in args), chunk=chunk)
    t = _t(*args)
    for y, st in (ssd_scan(*t, chunk=chunk), ops.ssd(*t, chunk=chunk), ssd_ref(*t, chunk)):
        assert y.shape == (b, s, nh, hd) and y.dtype == torch.float32
        assert st.shape == (b, nh, hd, n) and st.dtype == torch.float32
        for ref_y, ref_s in ((y_pl, s_pl), (y_jr, s_jr)):
            np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), atol=ATOL)
            np.testing.assert_allclose(st.numpy(), np.asarray(ref_s), atol=ATOL)


@pytest.mark.parametrize("b,s,nh,hd,n,chunk", SWEEP[:3])
def test_ssd_initial_state_matches_jax(b, s, nh, hd, n, chunk):
    args = _inputs(s + 1, b, s, nh, hd, n)
    s0 = np.random.default_rng(s).normal(size=(b, nh, hd, n)).astype(np.float32)
    y_ref, s_ref = jax_ssd(*(jnp.asarray(a) for a in args), chunk=chunk,
                           initial_state=jnp.asarray(s0))
    y, st = ssd(*_t(*args), chunk=chunk, initial_state=torch.from_numpy(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=ATOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(s_ref), atol=ATOL)


@pytest.mark.parametrize("split", [16, 13])  # on a chunk boundary, and not
def test_ssd_initial_state_chaining(split):
    """Running two parts with the carried state == running the whole
    sequence (tests/test_kernels.py's chaining case, split anywhere)."""
    x, dt, A, Bm, Cm = _t(*_inputs(7, 1, 32, 2, 8, 4))
    y_full, s_full = ssd_scan(x, dt, A, Bm, Cm, chunk=8)
    h = split
    y1, st = ssd_scan(x[:, :h], dt[:, :h], A, Bm[:, :h], Cm[:, :h], chunk=8)
    y2, s_end = ssd_scan(x[:, h:], dt[:, h:], A, Bm[:, h:], Cm[:, h:], chunk=8,
                         initial_state=st)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y_full.numpy(), atol=ATOL)
    np.testing.assert_allclose(s_end.numpy(), s_full.numpy(), atol=ATOL)


@pytest.mark.parametrize("chunk", [4, 8])
def test_ssd_decode_step_equals_scan(chunk):
    """The recurrent decode step, one token at a time, equals the chunked
    scan (the serve path vs the prefill path), in the port and in JAX."""
    b, s, nh, hd, n = 1, 6, 2, 8, 4
    x, dt, A, Bm, Cm = _t(*_inputs(8, b, s, nh, hd, n))
    y_scan, s_scan = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    state = torch.zeros((b, nh, hd, n))
    ys = []
    for t in range(s):
        dA = torch.exp(dt[:, t] * A[None, :])
        dBx = torch.einsum("bn,bh,bhp->bhpn", Bm[:, t], dt[:, t], x[:, t])
        state = state * dA[:, :, None, None] + dBx
        ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, t], state))
    y_step = torch.stack(ys, dim=1)
    np.testing.assert_allclose(y_scan.numpy(), y_step.numpy(), atol=ATOL)
    np.testing.assert_allclose(s_scan.numpy(), state.numpy(), atol=ATOL)
    y_jax, _ = jax_ssd_ref(*(jnp.asarray(a.numpy()) for a in (x, dt, A, Bm, Cm)), chunk=chunk)
    np.testing.assert_allclose(y_step.numpy(), np.asarray(y_jax), atol=ATOL)


def test_ssd_bf16_inputs_match_jax():
    """bf16 x, B, C (the serving dtypes) with float32 dt and A: y comes
    back in bf16, the state in float32, as in the Pallas kernel."""
    b, s, nh, hd, n, chunk = 2, 40, 2, 16, 16, 16
    x, dt, A, Bm, Cm = _inputs(9, b, s, nh, hd, n)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (x, Bm, Cm)]
    y_ref, s_ref = jax_ssd(bf[0], jnp.asarray(dt), jnp.asarray(A), bf[1], bf[2], chunk=chunk)
    tb = [torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16) for a in bf]
    y, st = ssd_scan(tb[0], torch.from_numpy(dt), torch.from_numpy(A), tb[1], tb[2], chunk=chunk)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    y_ref = np.asarray(y_ref, np.float32)
    np.testing.assert_allclose(y.float().numpy(), y_ref, atol=1e-2 * np.abs(y_ref).max())
    np.testing.assert_allclose(st.numpy(), np.asarray(s_ref), atol=ATOL)


def test_ssd_ref_selects_the_decay_where_it_overflows():
    """At full-width magnitudes (dt ≈ 0.7, A = -e, chunk 256) cs falls to
    about -490, so exp(cs_i - cs_j) is inf above the diagonal: the mask
    must select, not multiply, or y turns NaN."""
    b, s, nh, hd, n = 1, 256, 2, 8, 4
    x, _, _, Bm, Cm = _inputs(10, b, s, nh, hd, n)
    dt = np.full((b, s, nh), 0.7, np.float32)
    A = np.full((nh,), -np.e, np.float32)
    y, st = ssd_scan(*_t(x, dt, A, Bm, Cm), chunk=256)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    y_ref, s_ref = jax_ssd_ref(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), chunk=256)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=ATOL)


def test_cpu_path_launches_nothing():
    runtime.reset_launch_counts()
    ssd_scan(*_t(*_inputs(0, 1, 8, 2, 8, 4)), chunk=4)
    assert runtime.launch_counts() == {name: 0 for name in runtime.SOURCES}


@pytest.mark.parametrize(
    "change,err",
    [
        ({"x": (1, 8, 3, 8)}, ValueError),  # heads of x and dt differ
        ({"Cm": (1, 8, 6)}, ValueError),  # B and C widths differ
        ({"x": (1, 8, 2, 160)}, ValueError),  # hd above MAX_HEAD_DIM
        ({"x_dtype": torch.float16}, TypeError),
        ({"dt_dtype": torch.bfloat16}, TypeError),
        ({"state": (1, 2, 8, 5)}, ValueError),
    ],
)
def test_wrapper_refuses_what_the_kernel_does_not_take(change, err):
    shapes = {"x": (1, 8, 2, 8), "dt": (1, 8, 2), "A": (2,), "Bm": (1, 8, 4), "Cm": (1, 8, 4)}
    shapes.update({k: v for k, v in change.items() if k in shapes})
    t = {k: torch.zeros(v) for k, v in shapes.items()}
    t["x"] = t["x"].to(change.get("x_dtype", torch.float32))
    t["dt"] = t["dt"].to(change.get("dt_dtype", torch.float32))
    state = torch.zeros(change["state"]) if "state" in change else None
    with pytest.raises(err):
        ssd_scan(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"], chunk=4, initial_state=state)


def test_wrapper_refuses_tiles_beyond_shared_memory():
    assert smem_bytes(256, 64, 128) <= MAX_SMEM_BYTES  # the Mamba2-2.7B shape fits
    assert smem_bytes(16384, 64, 128) > MAX_SMEM_BYTES
    x, dt, A, Bm, Cm = _t(*_inputs(0, 1, 8, 2, 8, 128))
    with pytest.raises(ValueError, match="shared memory"):
        ssd_scan(x, dt, A, Bm, Cm, chunk=16384)


def test_wrapper_refuses_devices_it_cannot_serve():
    """Neither CPU nor CUDA: no silent move, no plain-version fallback."""
    x, dt, A, Bm, Cm = (torch.zeros(s, device="meta") for s in
                        ((1, 8, 2, 8), (1, 8, 2), (2,), (1, 8, 4), (1, 8, 4)))
    with pytest.raises(ValueError):
        ssd_scan(x, dt, A, Bm, Cm, chunk=4)


def test_build_command_targets_hopper(tmp_path, monkeypatch):
    monkeypatch.setattr(runtime.shutil, "which", lambda name: "/toolkit/bin/nvcc")
    cmd = runtime.nvcc_command("ssd_scan", tmp_path / "lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert cmd[-1].endswith("ssd_scan/csrc/ssd_scan.cu")
    assert runtime.library_path("ssd_scan") != runtime.library_path("flash_attention")
