"""The port's dCor (``repro_torch.core.dcov``) and the plain versions of its
dcov kernel (``repro_torch.kernels.dcov``) against the JAX package, on the
CPU. Inputs come from numpy seeds and reach both packages as numpy arrays.

Tolerances. dCor values: atol 1e-6 (float32; the port sums W² terms in
another order than XLA's matmul). Grams against the Pallas kernel run in
interpret mode: rtol 1e-4 of max|G| and dCor atol 1e-5, the reference's
own bounds for its kernel against its oracle
(tests/test_batched_analytics.py). Batch independence: bitwise.
"""
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
    dcov_gram,
    dcov_gram_windows,
    dcov_sums,
)

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
