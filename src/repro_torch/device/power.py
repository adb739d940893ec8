"""Pod power model.

Structure mirrors what Jetson exposes via tegrastats, scaled to a pod:
  chip:   P_idle + P_dyn·(f/f0)³·util + P_hbm·(m/m0)·mem_bound·util
  host:   P_idle + cores·P_core·(f_cpu/f0)²
Dynamic power ∝ f³ (DVFS: P ∝ f·V², V ∝ f) is the classic non-linearity
that makes "same throughput, 2× power" configurations possible (Fig. 1).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.device.hw import DEFAULT_HW, TPUv5eSpec
from repro_torch.device.perfmodel import PerfModel


@dataclasses.dataclass(frozen=True)
class PowerModel:
    perf: PerfModel
    hw: TPUv5eSpec = DEFAULT_HW

    def power(self, config: dict) -> float:
        """Total pod power (W) for a knob dict."""
        hw = self.hw
        n = self.perf.terms.n_chips
        util = self.perf.utilization(config)
        f_rel = config["tpu_freq"] / hw.nominal_tpu_freq
        m_rel = config["hbm_freq"] / hw.nominal_hbm_freq
        mem_frac = self.perf.memory_boundedness(config)
        p_chip = (
            hw.p_idle_chip
            + hw.p_dyn_chip * (f_rel**3) * util
            + hw.p_hbm_chip * m_rel * mem_frac * util
        )
        n_hosts = max(n // hw.chips_per_host, 1)
        c_rel = config["host_cpu_freq"] / hw.nominal_host_freq
        p_host = hw.p_host_idle + config["host_cores"] * hw.p_host_core * c_rel**2
        return n * p_chip + n_hosts * p_host

    def power_batch(
        self,
        cols: Dict[str, np.ndarray],
        util: np.ndarray = None,
        mem_frac: np.ndarray = None,
    ) -> np.ndarray:
        """Batched twin of ``power``: canonical knob columns (N,) → (N,).
        ``util``/``mem_frac`` can be passed from a prior ``stats_batch``
        call to avoid recomputing the pipeline terms."""
        hw = self.hw
        n = self.perf.terms.n_chips
        if util is None or mem_frac is None:
            _, util, mem_frac = self.perf.stats_batch(cols)
        f_rel = cols["tpu_freq"] / hw.nominal_tpu_freq
        m_rel = cols["hbm_freq"] / hw.nominal_hbm_freq
        p_chip = (
            hw.p_idle_chip
            + hw.p_dyn_chip * (f_rel**3) * util
            + hw.p_hbm_chip * m_rel * mem_frac * util
        )
        n_hosts = max(n // hw.chips_per_host, 1)
        c_rel = cols["host_cpu_freq"] / hw.nominal_host_freq
        p_host = hw.p_host_idle + cols["host_cores"] * hw.p_host_core * c_rel**2
        return n * p_chip + n_hosts * p_host
