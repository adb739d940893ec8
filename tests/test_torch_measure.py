"""``device/measure.py`` against the JAX package's: the analytical
(rate scale, power) split over the whole ``tpu_pod_space`` grid, and
``WalltimeDevice.measure`` over a stubbed rate cache with the same seed,
both exactly (plain numpy float64 in both packages, the same draws); the
counterparts of ``tests/test_serving_fixes.py``'s walltime cases; and
CORAL over the measured twin of a reduced model on the CPU, as
``tests/test_training_serving.py`` runs it (no wall-clock ratio is
asserted: the rate is a CPU measurement).
"""
import numpy as np
import pytest

from repro.core.space import tpu_pod_space as jax_tpu_pod_space
from repro.device.measure import WalltimeDevice as JaxWalltimeDevice
from repro.device.measure import analytic_scale_and_power as jax_scale_and_power
from repro_torch.core.space import tpu_pod_space
from repro_torch.device.measure import WalltimeDevice, analytic_scale_and_power


def test_analytic_split_equals_the_reference_over_the_grid():
    space, jspace = tpu_pod_space(), jax_tpu_pod_space()
    assert space.names == jspace.names
    grid = space.grid()
    np.testing.assert_array_equal(grid, jspace.grid())
    assert len(grid) > 1000
    for row in grid:
        cfg = tuple(float(v) for v in row)
        assert analytic_scale_and_power(space.names, cfg) == jax_scale_and_power(
            jspace.names, cfg)


def _stubbed(cls, space, base=50.0, seed=0):
    """A WalltimeDevice whose per-concurrency rates are stubbed: no engine."""
    dev = cls(space, engine=None, seed=seed)
    c = space.dims[space.index("concurrency")].values
    dev._rate_cache = {int(v): base * (1.0 + 0.25 * k) for k, v in enumerate(c)}
    return dev


def test_walltime_measure_equals_the_reference_on_stubbed_rates():
    space, jspace = tpu_pod_space(), jax_tpu_pod_space()
    dev, jdev = _stubbed(WalltimeDevice, space, seed=7), _stubbed(JaxWalltimeDevice, jspace, seed=7)
    assert dev.groups == jdev.groups == 10
    rng = np.random.default_rng(3)
    configs = [space.preset("default"), space.preset("max_power")] + [
        space.random(rng) for _ in range(40)]
    for cfg in configs:
        assert dev.exact(cfg) == jdev.exact(cfg)
        assert dev.measure(cfg) == jdev.measure(cfg)
    assert dev.n_measurements == jdev.n_measurements == len(configs)


class _FixedNoise:
    """Stand-in rng whose normal() always returns the same draw."""

    def __init__(self, z):
        self.z = z

    def normal(self, loc, scale):
        return self.z


def test_walltime_measure_clamps_noise_tail():
    space = tpu_pod_space()
    dev = _stubbed(WalltimeDevice, space)
    dev.rng = _FixedNoise(-200.0)  # 1 + z < 0 on both channels
    tau, p = dev.measure(space.preset("default"))
    assert tau > 0 and p > 0


def test_walltime_noise_is_symmetric_on_power():
    space = tpu_pod_space()
    dev = _stubbed(WalltimeDevice, space)
    tau0, p0 = dev.exact(space.preset("default"))
    dev.rng = _FixedNoise(0.5)
    tau, p = dev.measure(space.preset("default"))
    assert tau == pytest.approx(tau0 * 1.5)
    assert p == pytest.approx(p0 * 1.5)


def test_walltime_device_integration_on_the_cpu():
    """CORAL against the measured decode rate of a reduced Qwen2.5-3B on
    the CPU: each concurrency level is probed once through the runtime
    and cached."""
    from repro_torch.core.evaluate import run_coral
    from repro_torch.launch.serve import build_engine

    eng = build_engine("qwen2.5-3b", 2, 64, reduced=True, device="cpu")
    space = tpu_pod_space()
    dev = WalltimeDevice(space, eng, prompt_len=8, steps=4)
    tau0, p0 = dev.measure(space.preset("default"))
    assert tau0 > 0 and p0 > 0
    out, trace = run_coral(space, dev, tau_target=tau0 * 0.5, iters=6, device="cpu")
    assert out.config is not None and out.tau > 0
    assert len(trace.configs) == 6 and dev.n_measurements == 7
    levels = {int(c[space.index("concurrency")]) for c in trace.configs}
    assert set(dev._rate_cache) == levels | {int(space.preset("default")[space.index(
        "concurrency")])}
    assert all(r > 0 for r in dev._rate_cache.values())
    assert not any(e.busy for e in eng.pool)
