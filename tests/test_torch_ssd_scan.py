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
import ctypes
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd as jax_ssd
from repro.kernels.ssd_scan import ssd_pallas as jax_ssd_pallas
from repro.kernels.ssd_scan import ssd_ref as jax_ssd_ref
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels import runtime
from repro_torch.kernels.ssd_scan import ops, ssd, ssd_ref, ssd_scan
from repro_torch.kernels.ssd_scan.ref import (
    ssd_chunk_outputs_ref,
    ssd_chunk_states_ref,
    ssd_state_passing_ref,
)
from repro_torch.kernels.ssd_scan.ssd_scan import (
    MAX_SMEM_BYTES,
    body_for,
    body_launches,
    smem_bytes,
)

# (b, s, nh, hd, n, chunk): tests/test_kernels.py's sweep, then ragged tails
SWEEP = [
    (1, 32, 2, 16, 8, 8),
    (2, 64, 4, 16, 16, 16),
    (1, 48, 1, 8, 4, 16),
    (2, 45, 3, 16, 8, 16),  # S % chunk != 0
    (1, 5, 2, 8, 4, 8),  # shorter than one chunk
]
ATOL = 1e-4
# the wrapper's module (the package exports its function of the same name)
ssd_scan_module = importlib.import_module("repro_torch.kernels.ssd_scan.ssd_scan")


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
    # the wgmma body: the serving chunk fits (two CTAs per SM), and past its
    # limit body_for names the simt body while that one fits, then raises
    assert smem_bytes(256, 64, 128, "wgmma") <= MAX_SMEM_BYTES // 2
    assert smem_bytes(8192, 64, 128, "wgmma") > MAX_SMEM_BYTES
    assert smem_bytes(8192, 64, 128) <= MAX_SMEM_BYTES
    x, dt, A, Bm, Cm = _t(*_inputs(0, 1, 8, 2, 64, 128))
    xb, Bb, Cb = (t.to(torch.bfloat16) for t in (x, Bm, Cm))
    assert body_for(xb, Bb, Cb, 256) == "wgmma"
    assert body_for(xb, Bb, Cb, 8192) == "simt"
    ssd_scan(xb, dt, A, Bb, Cb, chunk=8192)  # the simt body's limit, not the wgmma body's
    with pytest.raises(ValueError, match="shared memory"):
        ssd_scan(xb, dt, A, Bb, Cb, chunk=16384)


def test_wgmma_shared_memory_at_both_widths():
    """The wgmma body's shared memory mirrors the CUDA source at N = 128 and
    N = 16: phase 3 sets it at chunk 256, 1024 of alignment, C and the two
    wide slots (64 x N bf16 tiles each), four 8 KB x boxes, 13 barriers and
    cs, dt of four heads over the chunk."""
    for n, tile in ((128, 16384), (16, 2048)):
        assert smem_bytes(256, 64, n, "wgmma") == 1024 + 3 * tile + 4 * 8192 + 8 * 13 + 8 * 4 * 256
    assert smem_bytes(256, 64, 16, "wgmma") < smem_bytes(256, 64, 128, "wgmma")


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


def _state(seed, b, nh, hd, n):
    return np.random.default_rng(seed).normal(size=(b, nh, hd, n)).astype(np.float32)


# (b, s, nh, hd, n, chunk, initial state): at least four chunks, a ragged
# tail, an initial state
PHASE_CASES = [
    (2, 77, 3, 16, 8, 16, True),  # 5 chunks, ragged
    (1, 128, 2, 8, 4, 16, False),  # 8 whole chunks
    (2, 45, 3, 16, 8, 8, True),  # 6 chunks, ragged
    (1, 300, 2, 64, 128, 64, True),  # the Mamba2 widths, chunk 64, ragged
]


@pytest.mark.parametrize("b,s,nh,hd,n,chunk,state", PHASE_CASES)
def test_phase_composition_matches_jax(b, s, nh, hd, n, chunk, state):
    """ssd_ref, the composition of the three phases, against the JAX
    package's ssd_chunked and its Pallas kernel in interpret mode, float32."""
    args = _inputs(s + 3, b, s, nh, hd, n)
    s0 = _state(s, b, nh, hd, n) if state else None
    jargs = [jnp.asarray(a) for a in args]
    js0 = None if s0 is None else jnp.asarray(s0)
    refs = (jax_ssd_chunked(*jargs, chunk, initial_state=js0),
            jax_ssd_pallas(*jargs, chunk=chunk, initial_state=js0, interpret=True))
    t = _t(*args)
    ts0 = None if s0 is None else torch.from_numpy(s0)
    cs, states, decay = ssd_chunk_states_ref(t[0], t[1], t[2], t[3], chunk)
    prev, final = ssd_state_passing_ref(states, decay, ts0)
    y = ssd_chunk_outputs_ref(t[0], t[1], t[3], t[4], cs, prev, chunk)
    y_ref, s_ref = ssd_ref(*t, chunk, ts0)
    assert torch.equal(y, y_ref) and torch.equal(final, s_ref)  # ssd_ref is the composition
    for ref_y, ref_s in refs:
        np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), atol=ATOL)
        np.testing.assert_allclose(final.numpy(), np.asarray(ref_s), atol=ATOL)


def _jax_chunk(args, c0, c1, s0=None):
    """The JAX package's scan over positions [c0, c1) alone (one chunk of
    that length), from state ``s0``."""
    x, dt, A, Bm, Cm = args
    return jax_ssd_chunked(jnp.asarray(x[:, c0:c1]), jnp.asarray(dt[:, c0:c1]), jnp.asarray(A),
                           jnp.asarray(Bm[:, c0:c1]), jnp.asarray(Cm[:, c0:c1]), c1 - c0,
                           initial_state=None if s0 is None else jnp.asarray(s0))


@pytest.mark.parametrize("b,s,nh,hd,n,chunk,state", PHASE_CASES[:3])
def test_chunk_states_match_each_chunk_alone(b, s, nh, hd, n, chunk, state):
    """Phase 1, per chunk: cs is the cumsum of dt·A within the chunk, the
    chunk's decay its exp(sum), and its end state the JAX scan's final
    state over that chunk alone from zero."""
    args = _inputs(s + 5, b, s, nh, hd, n)
    t = _t(*args)
    cs, states, decay = ssd_chunk_states_ref(t[0], t[1], t[2], t[3], chunk)
    nc = -(-s // chunk)
    assert cs.shape == (b, nc, chunk, nh) and states.shape == (b, nc, nh, hd, n)
    dA = np.pad(args[1] * args[2][None, None, :], ((0, 0), (0, nc * chunk - s), (0, 0)))
    dA = dA.reshape(b, nc, chunk, nh)
    np.testing.assert_allclose(cs.numpy(), np.cumsum(dA, axis=2), atol=1e-5)
    np.testing.assert_allclose(decay.numpy(), np.exp(dA.sum(axis=2)), rtol=1e-5)
    for c in range(nc):
        _, s_alone = _jax_chunk(args, c * chunk, min(s, (c + 1) * chunk))
        np.testing.assert_allclose(states[:, c].numpy(), np.asarray(s_alone), atol=ATOL)


@pytest.mark.parametrize("b,s,nh,hd,n,chunk,state", PHASE_CASES[:3])
def test_state_passing_matches_each_prefix(b, s, nh, hd, n, chunk, state):
    """Phase 2: the state entering chunk c is the JAX scan's final state
    over positions [0, c·chunk) from the initial state (the initial state
    itself for c = 0), and the final state the whole sequence's."""
    args = _inputs(s + 7, b, s, nh, hd, n)
    s0 = _state(s + 1, b, nh, hd, n) if state else None
    t = _t(*args)
    _, states, decay = ssd_chunk_states_ref(t[0], t[1], t[2], t[3], chunk)
    prev, final = ssd_state_passing_ref(states, decay,
                                        None if s0 is None else torch.from_numpy(s0))
    want0 = np.zeros((b, nh, hd, n), np.float32) if s0 is None else s0
    np.testing.assert_array_equal(prev[:, 0].numpy(), want0)
    for c in range(1, prev.shape[1]):
        _, s_prefix = jax_ssd_chunked(*(jnp.asarray(a[:, :c * chunk]) if a.ndim > 1 else
                                        jnp.asarray(a) for a in args), chunk,
                                      initial_state=None if s0 is None else jnp.asarray(s0))
        np.testing.assert_allclose(prev[:, c].numpy(), np.asarray(s_prefix), atol=ATOL)
    _, s_full = jax_ssd_chunked(*(jnp.asarray(a) for a in args), chunk,
                                initial_state=None if s0 is None else jnp.asarray(s0))
    np.testing.assert_allclose(final.numpy(), np.asarray(s_full), atol=ATOL)


@pytest.mark.parametrize("b,s,nh,hd,n,chunk,state", PHASE_CASES[:3])
def test_chunk_outputs_match_each_chunk_from_its_entering_state(b, s, nh, hd, n, chunk, state):
    """Phase 3, per chunk: y over the chunk is the JAX scan's y over that
    chunk alone, started from the state that phase 2 says enters it."""
    args = _inputs(s + 9, b, s, nh, hd, n)
    s0 = _state(s + 2, b, nh, hd, n) if state else None
    t = _t(*args)
    cs, states, decay = ssd_chunk_states_ref(t[0], t[1], t[2], t[3], chunk)
    prev, _ = ssd_state_passing_ref(states, decay, None if s0 is None else torch.from_numpy(s0))
    y = ssd_chunk_outputs_ref(t[0], t[1], t[3], t[4], cs, prev, chunk)
    assert y.shape == (b, s, nh, hd) and y.dtype == torch.float32
    for c in range(prev.shape[1]):
        c0, c1 = c * chunk, min(s, (c + 1) * chunk)
        y_alone, _ = _jax_chunk(args, c0, c1, prev[:, c].numpy())
        np.testing.assert_allclose(y[:, c0:c1].numpy(), np.asarray(y_alone), atol=ATOL)


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def _xbc_views(b, s, nh, hd, n, offset=0):
    """x, B and C as views of one (B, S, offset + NH·hd + 2N) tensor, as the
    model hands them in (row stride 5376 at the Mamba2-2.7B widths, 3232 at
    Hymba-1.5B's, with B and C at 3200 and 3216)."""
    di = nh * hd
    xbc = _bf16(b, s, offset + di + 2 * n)[..., offset:]
    return xbc[..., :di].reshape(b, s, nh, hd), xbc[..., di:di + n], xbc[..., di + n:]


# (x, B, C, chunk, body): the serving shapes (N 128 and N 16) contiguous
# and in the model's views, and the cases the wgmma body does not take
SSD_BODY_CASES = [
    ("serving-contiguous", lambda: (_bf16(4, 512, 80, 64), _bf16(4, 512, 128),
                                    _bf16(4, 512, 128)), 256, "wgmma"),
    ("serving-model-views", lambda: _xbc_views(4, 512, 80, 64, 128), 256, "wgmma"),
    ("chunk-64", lambda: (_bf16(1, 100, 2, 64), _bf16(1, 100, 128), _bf16(1, 100, 128)),
     64, "wgmma"),
    ("float32", lambda: (torch.zeros(1, 64, 2, 64), torch.zeros(1, 64, 128),
                         torch.zeros(1, 64, 128)), 64, "simt"),
    ("hd-32", lambda: (_bf16(1, 64, 2, 32), _bf16(1, 64, 128), _bf16(1, 64, 128)), 64, "simt"),
    ("n-16", lambda: (_bf16(1, 64, 2, 64), _bf16(1, 64, 16), _bf16(1, 64, 16)), 64, "wgmma"),
    ("hymba-contiguous", lambda: (_bf16(4, 512, 50, 64), _bf16(4, 512, 16),
                                  _bf16(4, 512, 16)), 256, "wgmma"),
    ("hymba-model-views", lambda: _xbc_views(4, 512, 50, 64, 16), 256, "wgmma"),
    ("hymba-views-chunk-64", lambda: _xbc_views(2, 2048, 50, 64, 16), 64, "wgmma"),
    ("hymba-one-element-in", lambda: _xbc_views(1, 64, 50, 64, 16, offset=1), 256, "simt"),
    ("hymba-float32", lambda: (torch.zeros(1, 64, 2, 64), torch.zeros(1, 64, 16),
                               torch.zeros(1, 64, 16)), 64, "simt"),
    ("hymba-chunk-96", lambda: _xbc_views(1, 96, 50, 64, 16), 96, "simt"),
    ("n-32", lambda: (_bf16(1, 64, 2, 64), _bf16(1, 64, 32), _bf16(1, 64, 32)), 64, "simt"),
    ("n-64", lambda: (_bf16(1, 64, 2, 64), _bf16(1, 64, 64), _bf16(1, 64, 64)), 64, "simt"),
    ("hd-32-n-16", lambda: (_bf16(1, 64, 2, 32), _bf16(1, 64, 16), _bf16(1, 64, 16)), 64,
     "simt"),
    ("chunk-96", lambda: (_bf16(1, 96, 2, 64), _bf16(1, 96, 128), _bf16(1, 96, 128)),
     96, "simt"),
    ("one-element-in", lambda: _xbc_views(1, 64, 2, 64, 128, offset=1), 64, "simt"),
]


@pytest.mark.parametrize("make,chunk,body", [c[1:] for c in SSD_BODY_CASES],
                         ids=[c[0] for c in SSD_BODY_CASES])
def test_body_for_names_the_body(make, chunk, body):
    x, Bm, Cm = make()
    assert body_for(x, Bm, Cm, chunk) == body


def test_cpu_path_counts_no_body():
    runtime.reset_launch_counts()
    x, Bm, Cm = _xbc_views(1, 64, 2, 64, 128)
    dt, A = torch.full((1, 64, 2), 0.1), -torch.ones(2)
    ssd_scan(x, dt, A, Bm, Cm, chunk=64)
    assert body_launches() == {"simt": 0, "wgmma": 0}


@pytest.mark.parametrize("dtype,body", [(torch.bfloat16, "wgmma"), (torch.float32, "simt")])
def test_card_path_hands_the_entry_its_arguments(monkeypatch, dtype, body):
    """The launch path, with the C entry replaced by a recorder: one launch
    counted on the body body_for names, the body's code, scratch for the
    wgmma body alone (cs, dt, chunk states, entering states), and an argument
    list that matches the entry's ctypes signature."""
    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(runtime, "on_card", lambda *t: True)
    monkeypatch.setattr(runtime, "stream_handle", lambda device: ctypes.c_void_p(0))
    monkeypatch.setattr(ssd_scan_module, "_entry", lambda: (None, entry))
    b, s, nh, hd, n, chunk = 2, 200, 3, 64, 128, 64
    x, dt, A, Bm, Cm = _t(*_inputs(1, b, s, nh, hd, n))
    x, Bm, Cm = (t.to(dtype) for t in (x, Bm, Cm))
    runtime.reset_launch_counts()
    y, st = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    assert runtime.launch_counts()["ssd_scan"] == 1 and body_launches()[body] == 1
    (args,) = calls
    assert len(args) == len(ssd_scan_module._ARGTYPES)
    assert args[13] == ssd_scan_module.BODIES.index(body)
    scratch = args[8:12]
    if body == "wgmma":
        assert all(isinstance(p, ctypes.c_void_p) and p.value for p in scratch)
    else:
        assert scratch == (None,) * 4
    assert y.shape == (b, s, nh, hd) and y.dtype == dtype and st.shape == (b, nh, hd, n)


def test_ablation_variants_change_what_they_name():
    """tools/ssd_ablation.py edits the wgmma body by markers in the CUDA
    source: each variant differs from the source, and a marker that went
    missing raises instead of timing the unchanged kernel."""
    from tools import ssd_ablation

    src = ssd_ablation.SOURCE.read_text()
    v = ssd_ablation.variants(src)
    assert v["as built"] == src
    assert all(text != src for name, text in v.items() if name != "as built")
    assert "constexpr int SCAN_G = 2;" in v["G = 2"]
    with pytest.raises(ValueError, match="marker"):
        ssd_ablation.variants(src.replace("constexpr int SCAN_G = 4;", ""))
