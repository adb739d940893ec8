"""The port's dCor (``repro_torch.core.dcov``) and the plain versions of its
dcov kernel (``repro_torch.kernels.dcov``) against the JAX package, on the
CPU. Inputs come from numpy seeds and reach both packages as numpy arrays.

Tolerances. dCor values: atol 1e-6 (float32; the port sums W² terms in
another order than XLA's matmul). Grams against the Pallas kernel run in
interpret mode: rtol 1e-4 of max|G| and dCor atol 1e-5, the reference's
own bounds for its kernel against its oracle
(tests/test_batched_analytics.py). Batch independence: bitwise. Float32
Grams against float64 at exact-zero dCor pairs: see the section below.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dcov as ref_dcov
from repro.kernels.dcov import (
    dcor_all_pallas,
    dcor_pallas,
    dcov_gram_pallas,
    dcov_sums_pallas,
)
from repro_torch.core import dcov
from repro_torch.kernels import runtime
from repro_torch.kernels.dcov import (
    dcor_all_blocked,
    dcor_blocked,
    dcor_from_sums,
    dcov_gram,
    dcov_gram_ref,
    dcov_gram_windows,
    dcov_sums,
)
from repro_torch.kernels.dcov import ref as dcov_ref

# Column scales of a CORAL window: five knob values, then τ and p.
SCALES = np.asarray([1500.0, 4.0, 800.0, 2000.0, 3.0, 50.0, 5.0])


def window(seed, w=10, n=10, constant=False):
    """A (W, 7) CORAL-like window, rows past n zero."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(w, 7)) * 0.2 + 1.0) * SCALES
    if constant:
        x[:, 1] = SCALES[1]
        x[:, 6] = SCALES[6]
    x[n:] = 0.0
    return x.astype(np.float32)


CASES = [  # (seed, W, n_valid, constant columns)
    (0, 10, 10, False),
    (1, 10, 7, False),
    (2, 10, 3, False),
    (3, 10, 2, False),
    (4, 10, 1, False),
    (5, 10, 10, True),
    (6, 10, 5, True),
    (7, 64, 64, False),
    (8, 64, 40, True),
]


@pytest.mark.parametrize("seed,w,n,constant", CASES)
def test_dcor_all_matches_reference(seed, w, n, constant):
    x = window(seed, w, n, constant)
    want = np.asarray(ref_dcov.dcor_all(jnp.asarray(x[:, :5]), jnp.asarray(x[:, 5:]),
                                        np.int32(n)))
    got = dcov.dcor_all(x[:, :5], x[:, 5:], n, device="cpu")
    assert got.shape == (5, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_dcor_all_cols_batched_matches_reference_per_episode():
    xs = np.stack([window(seed, w, n, constant) for seed, w, n, constant in CASES[:7]])
    ns = np.asarray([n for _, _, n, _ in CASES[:7]], np.int32)
    got = dcov.dcor_all_cols(torch.from_numpy(xs), torch.from_numpy(ns), 5).numpy()
    for i in range(xs.shape[0]):
        want = np.asarray(ref_dcov.dcor_all_cols(jnp.asarray(xs[i]), jnp.int32(ns[i]), 5))
        np.testing.assert_allclose(got[i], want, atol=1e-6, rtol=0)


def test_constant_and_short_windows_give_zero_not_nan():
    """n = 1 and constant columns: denominators below eps give dCor 0."""
    x = window(5, constant=True)
    got = dcov.dcor_all(x[:, :5], x[:, 5:], 10, device="cpu")
    assert torch.isfinite(got).all()
    assert (got[1] == 0).all() and (got[:, 1] == 0).all()
    one = dcov.dcor_all(window(4, n=1)[:, :5], window(4, n=1)[:, 5:], 1, device="cpu")
    assert torch.equal(one, torch.zeros((5, 2)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dcor_and_dcov2_match_reference(seed):
    rng = np.random.default_rng(seed)
    x, y = rng.normal(size=(2, 40)).astype(np.float32)
    y = x**2 + 0.1 * y  # dependent, not linearly
    np.testing.assert_allclose(
        dcov.dcor(torch.from_numpy(x), torch.from_numpy(y)).item(),
        float(ref_dcov.dcor(jnp.asarray(x), jnp.asarray(y))), atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        dcov.dcov2(torch.from_numpy(x), torch.from_numpy(y)).item(),
        float(ref_dcov.dcov2(jnp.asarray(x), jnp.asarray(y))), rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_dcor_numpy_matches_reference(seed):
    """The host-side wrapper: float64 numpy in, float32 dCor, a Python float out."""
    rng = np.random.default_rng(seed)
    x, y = rng.normal(size=(2, 40))
    y = x**2 + 0.1 * y
    got = dcov.dcor_numpy(x, y, device="cpu")
    assert type(got) is float
    np.testing.assert_allclose(got, ref_dcov.dcor_numpy(x, y), atol=1e-6, rtol=0)


def test_centered_distance_stack_matches_reference():
    x = window(1, n=7)
    want = np.asarray(ref_dcov.centered_distance_stack(jnp.asarray(x), jnp.int32(7)))
    got = dcov.centered_distance_stack(torch.from_numpy(x), 7).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("n,block", [(30, 64), (200, 128)])
def test_plain_gram_matches_pallas_kernel(n, block):
    rng = np.random.default_rng(n)
    cols = rng.normal(size=(n, 7)).astype(np.float32)
    want = np.asarray(dcov_gram_pallas(jnp.asarray(cols), block=block))
    got = dcov_gram(torch.from_numpy(cols)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("n,block", [(30, 64), (200, 128)])
def test_dcor_all_blocked_matches_pallas_kernel(n, block):
    rng = np.random.default_rng(n + 1)
    s = rng.normal(size=(n, 5)).astype(np.float32)
    m = rng.normal(size=(n, 2)).astype(np.float32)
    m[:, 0] += s[:, 0] ** 2  # one dependent pair
    want = np.asarray(dcor_all_pallas(jnp.asarray(s), jnp.asarray(m), block=block))
    got = dcor_all_blocked(torch.from_numpy(s), torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_dcov_sums_and_dcor_blocked_match_pallas_kernel():
    rng = np.random.default_rng(3)
    x, y = rng.normal(size=(2, 50)).astype(np.float32)
    want = [float(v) for v in dcov_sums_pallas(jnp.asarray(x), jnp.asarray(y), block=64)]
    got = [v.item() for v in dcov_sums(torch.from_numpy(x), torch.from_numpy(y))]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(
        dcor_blocked(torch.from_numpy(x), torch.from_numpy(y)).item(),
        float(dcor_pallas(jnp.asarray(x), jnp.asarray(y), block=64)), atol=1e-5, rtol=0)


@pytest.mark.parametrize("b", [3, 162])
def test_episode_alone_equals_episode_in_batch(b):
    """The plain windows form gives an episode the same bits alone as
    inside a batch, wherever it sits: the scalar spec (B = 1) and the
    batched engine see the same correlations."""
    rng = np.random.default_rng(b)
    ns = rng.integers(1, 11, b).astype(np.int32)
    xs = np.stack([window(int(s), 10, int(n)) for s, n in zip(rng.integers(0, 1000, b), ns)])
    batch = dcov.dcor_all_cols(torch.from_numpy(xs), torch.from_numpy(ns), 5)
    for i in (0, b // 2, b - 1):
        alone = dcov.dcor_all(xs[i, :, :5], xs[i, :, 5:], int(ns[i]), device="cpu")
        assert torch.equal(alone, batch[i])


def test_cpu_tensors_take_the_plain_version():
    before = runtime.launch_counts()["dcov"]
    x = torch.from_numpy(np.stack([window(0)]))
    dcov_gram_windows(x, torch.tensor([10], dtype=torch.int32))
    dcov_gram(x[0])
    assert runtime.launch_counts()["dcov"] == before


@pytest.mark.parametrize("bad", ["shape", "dtype", "n_shape"])
def test_windows_wrapper_rejects_bad_inputs(bad):
    x = torch.zeros((2, 10, 7))
    n = torch.tensor([3, 4], dtype=torch.int32)
    if bad == "shape":
        x = x[0]
    elif bad == "dtype":
        n = n.to(torch.int64)
    else:
        n = n[:1]
    with pytest.raises((ValueError, TypeError)):
        dcov_gram_windows(x, n)


# ---------------------------------------------------------------------------
# Exact-zero dCor pairs. A noise-free landscape is a full factorial grid of
# the five knobs, so where a metric does not depend on a knob the empirical
# joint distribution is exactly the product of its marginals and the
# V-statistic dCov is exactly 0 (a product sub-grid keeps this). There any
# float32 rounding of <A,B> shows under dCor's square root: 1e-8 in dCor^2
# is 1e-4 in dCor. So float32 Grams are held to float64 in normalised-Gram
# terms, <A_c,A_d> / sqrt(<A_c,A_c> <A_d,A_d>) (dCor^2 before the root),
# within 1e-6 at every pair, and in dCor within 1e-4 only where the float64
# dCor is at least 1e-2. The JAX package's own kernel is held the same way.

ZERO_PAIRS = [(6, "mem_freq"), (9, "gpu_freq")]  # (cell, knob independent of tau)


def landscape_subgrid(cell_index):
    """A noise-free (n, 7) landscape of knobs, tau and p on a product
    sub-grid (every other level of each knob with more than 3 levels), and
    the knob names."""
    from repro_torch.experiments import scenarios

    cell = scenarios.enumerate_cells(workloads=scenarios.FULL_MATRIX_WORKLOADS)[cell_index]
    sim0 = scenarios.cell_simulator(cell, noise=0.0)
    levels = [d.values[::2] if len(d.values) > 3 else d.values for d in sim0.space.dims]
    grid = np.asarray(list(itertools.product(*levels)), np.float64)
    land = np.stack(sim0.exact_all(grid), axis=1)
    return np.concatenate([grid, land], axis=1).astype(np.float32), sim0.space.names


def normalised(gram):
    g = np.asarray(gram, np.float64)
    d = np.sqrt(np.maximum(np.diag(g), 0.0))
    return g / (d[:, None] * d[None, :])


def dcor_of(gram, d=5):
    """The (D, 2) knob-by-metric dCor of a (7, 7) Gram, in float64."""
    g = torch.as_tensor(np.asarray(gram, np.float64))
    diag = torch.diagonal(g)
    return dcor_from_sums(g[:d, d:], diag[:d, None], diag[None, d:]).numpy()


@pytest.mark.parametrize("cell,knob", ZERO_PAIRS)
def test_float32_grams_hold_to_float64_at_an_exact_zero_pair(cell, knob):
    cols, names = landscape_subgrid(cell)
    assert cols.shape == (216, 7)
    g64 = dcov_gram_ref(torch.from_numpy(cols), dtype=torch.float64).numpy()
    want = dcor_of(g64)
    assert want[names.index(knob), 0] < 1e-6  # tau does not depend on this knob
    plain = dcov_gram_ref(torch.from_numpy(cols)).numpy()
    pallas = np.asarray(dcov_gram_pallas(jnp.asarray(cols)))
    for gram in (plain, pallas):
        np.testing.assert_allclose(normalised(gram), normalised(g64), atol=1e-6, rtol=0)
    big = want >= 1e-2
    for got in (dcor_of(plain),
                np.asarray(dcor_all_pallas(jnp.asarray(cols[:, :5]), jnp.asarray(cols[:, 5:])))):
        np.testing.assert_allclose(got[big], want[big], atol=1e-4, rtol=0)


def test_reference_kernel_is_nonzero_at_an_exact_zero_pair():
    """The JAX package's Pallas kernel gives gpu_freq against tau a dCor of
    6.8e-5 on cell 9's sub-grid where the float64 dCor is 0: the square
    root of float32 rounding, not a fault of either kernel."""
    cols, names = landscape_subgrid(9)
    got = np.asarray(dcor_all_pallas(jnp.asarray(cols[:, :5]), jnp.asarray(cols[:, 5:])))
    g64 = dcov_gram_ref(torch.from_numpy(cols), dtype=torch.float64).numpy()
    k = names.index("gpu_freq")
    assert dcor_of(g64)[k, 0] < 1e-6 < got[k, 0] < 1e-4


@pytest.mark.parametrize("stack_bytes", [None, 150 * 4 * 8 * 16], ids=["whole", "in-blocks"])
def test_plain_gram_takes_float64(monkeypatch, stack_bytes):
    """dcov_gram_ref(..., dtype=torch.float64) is a float64 computation
    (the stack whole, or in blocks of 16 rows), not a float32 one cast
    back."""
    if stack_bytes is not None:
        monkeypatch.setattr(dcov_ref, "STACK_BYTES", stack_bytes)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(150, 4)) * 1000.0 + 5000.0
    dist = np.abs(x[:, None, :] - x[None, :, :])
    A = dist - dist.mean(1, keepdims=True) - dist.mean(0, keepdims=True) + dist.mean((0, 1))
    want = np.einsum("ijc,ijd->cd", A, A)
    got = dcov_gram_ref(torch.from_numpy(x), dtype=torch.float64)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12 * np.abs(want).max(), rtol=0)
    assert dcov_gram_ref(torch.from_numpy(x)).dtype == torch.float32


def test_ablation_variants_change_what_they_name():
    """tools/dcov_ablation.py edits the single-block form by markers in the
    CUDA source: each variant differs from the source, and a marker that
    went missing (or now occurs more often) raises instead of timing the
    unchanged kernel."""
    from tools import dcov_ablation

    src = dcov_ablation.SOURCE.read_text()
    v = dcov_ablation.variants(src)
    assert v["as built"] == src
    assert all(text != src for name, text in v.items() if name != "as built")
    assert "double acc[NP];" in v["f64 accumulators"]
    assert "programmaticStreamSerializationAllowed = 0;" in v["no dependent launch"]
    with pytest.raises(ValueError, match="marker"):
        dcov_ablation.variants(src.replace("  if (!last) return;", ""))
    with pytest.raises(ValueError, match="marker"):
        dcov_ablation.variants(src + "\n// float (&acc)[C * (C + 1) / 2]\n")


# ---------------------------------------------------------------------------
# The incremental dCor state (the reference's fleet path; the port's engine
# gathers the window instead, see core/dcov.py). Held to the JAX package's
# functions through fill-up and wrap-around: the window and the distance
# stack bitwise (the same subtract, abs and mask), the row sums and cross
# products at rel 1e-6 (matmuls summed in another order); the correlations
# to dcor_all_cols at the reference tests' 2e-3 (pushes) and 1e-4 (a state
# built from a window).


def _state_np(st):
    return {k: np.asarray(v) for k, v in st.items()}


def _hold_state(got, want):
    for k in ("win", "dist"):
        assert np.array_equal(got[k].numpy(), want[k]), k
    for k in ("rows", "cross"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6,
                                   atol=1e-6 * np.abs(want[k]).max(), err_msg=k)


@pytest.mark.parametrize("w,d", [(8, 4), (12, 5)])
def test_state_push_matches_reference_through_wraparound(w, d):
    rng = np.random.default_rng(w + d)
    c = d + 2
    rows = (rng.normal(size=(3 * w, c)) * SCALES[:c]).astype(np.float32)
    st = dcov.dcor_state_init(w, c, device="cpu")
    ref = ref_dcov.dcor_state_init(w, c)
    win = np.zeros((w, c), np.float32)
    for t, r in enumerate(rows):
        slot, n_filled = t % w, min(t, w)
        st = dcov.dcor_state_push(st, torch.from_numpy(r), slot, n_filled)
        ref = ref_dcov.dcor_state_push(ref, jnp.asarray(r), jnp.int32(slot),
                                       jnp.int32(n_filled))
        _hold_state(st, _state_np(ref))
        win[slot] = r
        n_valid = min(t + 1, w)
        full = dcov.dcor_all_cols(torch.from_numpy(win), n_valid, d)
        np.testing.assert_allclose(dcov.dcor_state_corr(st, n_valid, d).numpy(),
                                   full.numpy(), atol=2e-3, rtol=0)


@pytest.mark.parametrize("n", [0, 1, 6, 10])
def test_state_from_window_matches_reference(n):
    rng = np.random.default_rng(n + 20)
    w, d = 10, 3
    cols = np.zeros((w, d + 2), np.float32)
    cols[:n] = rng.normal(size=(n, d + 2))
    st = dcov.dcor_state_from_window(torch.from_numpy(cols), n)
    _hold_state(st, _state_np(ref_dcov.dcor_state_from_window(jnp.asarray(cols), jnp.int32(n))))
    if n >= 2:
        got = dcov.dcor_state_corr(st, n, d).numpy()
        full = dcov.dcor_all_cols(torch.from_numpy(cols), n, d).numpy()
        np.testing.assert_allclose(got, full, atol=1e-4, rtol=0)
        assert got.shape == (d, 2)


def test_state_from_window_equals_its_pushes():
    """n_valid sequential pushes into an empty state hold what one build
    from the window holds: the window and distances bitwise."""
    rng = np.random.default_rng(31)
    w, c, n = 10, 7, 7
    cols = np.zeros((w, c), np.float32)
    cols[:n] = rng.normal(size=(n, c)) * SCALES
    st = dcov.dcor_state_init(w, c, device="cpu")
    for t in range(n):
        st = dcov.dcor_state_push(st, torch.from_numpy(cols[t]), t, t)
    built = dcov.dcor_state_from_window(torch.from_numpy(cols), n)
    _hold_state(st, {k: v.numpy() for k, v in built.items()})


def test_state_batched_equals_per_episode():
    """The leading batch axis: B states pushed together, each at its own
    slot and fill, hold what B unbatched pushes hold."""
    rng = np.random.default_rng(41)
    b, w, c, d = 4, 6, 7, 5
    cols = (rng.normal(size=(b, w, c)) * SCALES).astype(np.float32)
    ns = np.asarray([0, 2, 5, 6], np.int64)
    st = dcov.dcor_state_from_window(torch.from_numpy(cols), torch.from_numpy(ns))
    empty = dcov.dcor_state_from_window(torch.zeros(b, w, c), torch.zeros(b, dtype=torch.int64))
    for k, v in dcov.dcor_state_init(w, c, device="cpu").items():
        assert torch.equal(empty[k], v.expand_as(empty[k]))
    row = (rng.normal(size=(b, c)) * SCALES).astype(np.float32)
    slots = ns % w
    pushed = dcov.dcor_state_push(st, torch.from_numpy(row), torch.from_numpy(slots),
                                  torch.from_numpy(np.minimum(ns, w)))
    corr = dcov.dcor_state_corr(pushed, torch.from_numpy(np.minimum(ns + 1, w)), d)
    assert corr.shape == (b, d, 2)
    for i in range(b):
        one = dcov.dcor_state_from_window(torch.from_numpy(cols[i]), int(ns[i]))
        one = dcov.dcor_state_push(one, torch.from_numpy(row[i]), int(slots[i]),
                                   int(min(ns[i], w)))
        _hold_state({k: v[i] for k, v in pushed.items()}, {k: v.numpy() for k, v in one.items()})
        np.testing.assert_allclose(
            corr[i].numpy(), dcov.dcor_state_corr(one, int(min(ns[i] + 1, w)), d).numpy(),
            atol=1e-6, rtol=0)
