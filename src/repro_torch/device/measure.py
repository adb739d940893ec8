"""WalltimeDevice: CORAL against *measured* throughput (the counterpart
of ``repro/device/measure.py``).

Runs a model's decode loop through the serving runtime (on the card, the
engine's captured decode step; real wall-clock tokens/sec) instead of
the analytical simulator. The base rate *and the concurrency effect* are
measured — each concurrency level is probed once through the
continuous-batching runtime (``repro_torch.serving.runtime``) and cached,
so the knob's τ response is the real pipelining behaviour of this host
and card, not a modeled utilization curve. Clock knobs still modulate
the measured rate analytically, and power is the reference's analytical
model on ``DEFAULT_HW`` (the TPU v5e constants): the reference reads no
power rail, so neither does the port, and that power is the model's, not
the card's. Used by the serving controller and the integration tests.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.core.space import Config, ConfigSpace
from repro_torch.device.hw import DEFAULT_HW, TPUv5eSpec
from repro_torch.device.perfmodel import PerfModel, RooflineTerms, canon
from repro_torch.device.power import PowerModel


def analytic_scale_and_power(
    names, config: Config, hw: TPUv5eSpec = DEFAULT_HW
) -> Tuple[float, float]:
    """(device-rate scale, analytical power) for a config on this host.

    The scale is the relative decode-rate multiplier of the DVFS knobs
    (min of the compute and memory rooflines); power reuses the analytical
    pod model at n_chips=1. Shared between WalltimeDevice and the serving
    controller so both halves of the measured/analytical split agree.
    """
    d = canon(dict(zip(names, config)))
    f_rel = d["tpu_freq"] / hw.nominal_tpu_freq
    m_rel = d["hbm_freq"] / hw.nominal_hbm_freq
    dev_rel = min(f_rel, m_rel * 1.25)
    terms = RooflineTerms(1e-3 / max(f_rel, 1e-3), 8e-4 / max(m_rel, 1e-3),
                          0.0, 1e-3, 1.0, n_chips=1)
    pm = PowerModel(PerfModel(terms, hw), hw)
    return dev_rel, pm.power(d)


class WalltimeDevice:
    def __init__(
        self,
        space: ConfigSpace,
        engine,  # repro_torch.serving.ServingEngine
        prompt_len: int = 32,
        steps: int = 8,
        hw: TPUv5eSpec = DEFAULT_HW,
        seed: int = 0,
        groups: int = 0,  # saturating groups per probe; 0 = auto from space
    ):
        self.space = space
        self.engine = engine
        self.prompt_len = prompt_len
        self.steps = steps
        self.hw = hw
        self.rng = np.random.default_rng(seed)
        self.n_measurements = 0
        self._c_index = space.index("concurrency")
        c_max = int(space.dims[self._c_index].hi)
        self.groups = groups or max(4, 2 * c_max)
        self._rate_cache: Dict[int, float] = {}

    def _measured_rate(self, concurrency: int) -> float:
        """Drain throughput of the runtime at this concurrency (measured
        once per level; decode rate is stable within a process)."""
        c = max(1, int(concurrency))
        if c not in self._rate_cache:
            from repro_torch.serving.runtime import measure_runtime_throughput

            self._rate_cache[c] = measure_runtime_throughput(
                self.engine,
                concurrency=c,
                prompt_len=self.prompt_len,
                new_tokens=self.steps,
                groups=self.groups,
            )
        return self._rate_cache[c]

    def exact(self, config: Config) -> Tuple[float, float]:
        base = self._measured_rate(config[self._c_index])
        dev_rel, power = analytic_scale_and_power(self.space.names, config, self.hw)
        return base * dev_rel, power

    def measure(self, config: Config) -> Tuple[float, float]:
        self.n_measurements += 1
        tau, p = self.exact(config)
        # symmetric noise on both channels; clamp like DeviceSimulator so a
        # noise tail can never emit τ ≤ 0 (which would flip the reward
        # penalty's sign) or negative power
        tau *= 1.0 + self.rng.normal(0, 0.01)
        p *= 1.0 + self.rng.normal(0, 0.01)
        return max(tau, 1e-9), max(p, 1e-9)
