"""Analytical throughput model of a TPU pod under DVFS + concurrency.

The base times come from the *compiled dry-run* of the selected
(arch × shape × mesh): compute seconds, memory seconds and collective
seconds at nominal clocks (EXPERIMENTS.md §Roofline). The knobs rescale
them:

    t_comp(f)   = t_comp0 · f0/f          (MXU clock)
    t_mem(m)    = t_mem0  · m0/m          (HBM clock)
    t_coll      = t_coll0                 (ICI links are not DVFS-scaled)
    device step = max(t_comp, t_mem, t_coll) · contention(c)
    host step   = t_host0 · (f_cpu0/f_cpu) · (cores0/cores)^0.7

Concurrency pipelines host work against device work (classic two-stage
pipeline): with c in-flight streams the steady-state throughput is

    τ(s) = min( c / (t_host + t_dev),  1 / t_dev_contended ) · batch_rate

which saturates once the device is busy — reproducing the non-linear
knee the paper exploits (Fig. 1). Contention grows mildly with c
(shared HBM): t_dev · (1 + κ·(c−1)).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np

from repro_torch.device.hw import DEFAULT_HW, TPUv5eSpec


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    """Per-step base times at nominal clocks (seconds) + workload meta."""

    t_compute: float
    t_memory: float
    t_collective: float
    t_host: float = 2.0e-3  # host-side dispatch/preprocess per step
    items_per_step: float = 1.0  # inferences (or sequences) per device step
    n_chips: int = 256

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)


def model_roofline_terms(
    model_cfg,
    profile,
    kind: str = "decode",
    batch: int = 8,
    seq: int = 256,
) -> RooflineTerms:
    """Per-(device, model) RooflineTerms from a model's analytic footprint.

    ``model_cfg`` is a ``repro_torch.configs.base.ModelConfig`` (anything with
    ``flops_per_token``/``bytes_per_token``); ``profile`` a
    ``repro_torch.device.hw.DeviceProfile``. Two workload kinds:

      decode  — one step produces ``batch`` tokens; compute scales with
                the batch, the weight stream does not → memory-bound at
                small batch (the LLM analogue of the paper's detectors).
      prefill — one step ingests ``seq`` prompt tokens for one sequence;
                compute-bound for any realistic ``seq``.

    Device work is sharded across the profile's chips; host preprocess
    scales with items per step. This is what lets the scenario matrix
    build a simulator for every (device profile × registry model) cell
    instead of the single hand-wired device the scripts used before.
    """
    hw = profile.hw
    eff_flops = hw.peak_flops_bf16 * profile.compute_eff * profile.n_chips
    eff_bw = hw.hbm_bw * profile.mem_eff * profile.n_chips
    bytes_per_step = model_cfg.bytes_per_token()
    if kind == "decode":
        flops_per_step = model_cfg.flops_per_token() * batch
        items = float(batch)
    elif kind == "prefill":
        flops_per_step = model_cfg.flops_per_token() * seq
        items = 1.0
    else:
        raise KeyError(f"unknown workload kind {kind!r}")
    return RooflineTerms(
        t_compute=flops_per_step / eff_flops,
        t_memory=bytes_per_step / eff_bw,
        t_collective=0.0 if profile.n_chips == 1 else 0.05 * flops_per_step / eff_flops,
        t_host=profile.t_host_per_item * items,
        items_per_step=items,
        n_chips=profile.n_chips,
    )


# knob-name aliases: TPU-pod space vs the paper's original Jetson grids
_ALIASES = {
    "tpu_freq": ("tpu_freq", "gpu_freq"),
    "hbm_freq": ("hbm_freq", "mem_freq"),
    "host_cpu_freq": ("host_cpu_freq", "cpu_freq"),
    "host_cores": ("host_cores", "cpu_cores"),
    "concurrency": ("concurrency",),
}


def canon(config: dict) -> dict:
    """Normalize a knob dict to canonical names (``gpu_freq`` →
    ``tpu_freq`` etc.); raises KeyError when any of the five canonical
    knobs is missing from the input."""
    out = {}
    for canon_name, names in _ALIASES.items():
        for n in names:
            if n in config:
                out[canon_name] = config[n]
                break
        else:
            raise KeyError(f"missing knob {canon_name} in {sorted(config)}")
    return out


def canon_columns(names: Sequence[str], grid: np.ndarray) -> Dict[str, np.ndarray]:
    """Split an (N, D) config matrix into canonical knob columns.

    ``names`` are the space's dimension names (either alias family); the
    result maps every canonical knob to its (N,) column — the batched
    analogue of ``canon`` for the array-based sweeps."""
    cols = {n: grid[:, i] for i, n in enumerate(names)}
    return canon(cols)


@dataclasses.dataclass(frozen=True)
class PerfModel:
    terms: RooflineTerms
    hw: TPUv5eSpec = DEFAULT_HW
    contention_kappa: float = 0.06  # HBM contention per extra stream

    def device_time(
        self, tpu_freq: float, hbm_freq: float, concurrency: float
    ) -> float:
        t_c = self.terms.t_compute * (self.hw.nominal_tpu_freq / tpu_freq)
        t_m = self.terms.t_memory * (self.hw.nominal_hbm_freq / hbm_freq)
        t_l = self.terms.t_collective
        base = max(t_c, t_m, t_l)
        return base * (1.0 + self.contention_kappa * (concurrency - 1.0))

    def host_time(self, cpu_freq: float, cores: float) -> float:
        return (
            self.terms.t_host
            * (self.hw.nominal_host_freq / cpu_freq)
            * (6.0 / cores) ** 0.7
        )

    def throughput(self, config: dict) -> float:
        """items/sec for a knob dict (see repro_torch.core.space.tpu_pod_space)."""
        c = config["concurrency"]
        t_dev = self.device_time(config["tpu_freq"], config["hbm_freq"], c)
        t_host = self.host_time(config["host_cpu_freq"], config["host_cores"])
        rate = min(c / (t_host + t_dev), 1.0 / t_dev)
        return rate * self.terms.items_per_step

    def utilization(self, config: dict) -> float:
        c = config["concurrency"]
        t_dev = self.device_time(config["tpu_freq"], config["hbm_freq"], c)
        t_host = self.host_time(config["host_cpu_freq"], config["host_cores"])
        rate = min(c / (t_host + t_dev), 1.0 / t_dev)
        return min(rate * t_dev, 1.0)

    def memory_boundedness(self, config: dict) -> float:
        """Fraction of device time attributable to HBM streaming (for the
        HBM power term)."""
        t_c = self.terms.t_compute * (self.hw.nominal_tpu_freq / config["tpu_freq"])
        t_m = self.terms.t_memory * (self.hw.nominal_hbm_freq / config["hbm_freq"])
        return t_m / max(t_c + t_m, 1e-12)

    # ------------------------------------------------------------------
    # Batched twins: identical formulas, numpy broadcasting over (N,)
    # knob columns (see ``canon_columns``) — one sweep call instead of N
    # Python evaluations for ORACLE / ALERT / figure-level exhaustive
    # searches.
    # ------------------------------------------------------------------
    def device_time_batch(
        self, tpu_freq: np.ndarray, hbm_freq: np.ndarray, concurrency: np.ndarray
    ) -> np.ndarray:
        t_c = self.terms.t_compute * (self.hw.nominal_tpu_freq / tpu_freq)
        t_m = self.terms.t_memory * (self.hw.nominal_hbm_freq / hbm_freq)
        base = np.maximum(np.maximum(t_c, t_m), self.terms.t_collective)
        return base * (1.0 + self.contention_kappa * (concurrency - 1.0))

    def host_time_batch(self, cpu_freq: np.ndarray, cores: np.ndarray) -> np.ndarray:
        return (
            self.terms.t_host
            * (self.hw.nominal_host_freq / cpu_freq)
            * (6.0 / cores) ** 0.7
        )

    def stats_batch(
        self, cols: Dict[str, np.ndarray]
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(throughput, utilization, memory_boundedness) in one pass —
        the pipeline terms are computed once and shared (the power model
        needs util and mem_frac on top of τ)."""
        c = cols["concurrency"]
        t_dev = self.device_time_batch(cols["tpu_freq"], cols["hbm_freq"], c)
        t_host = self.host_time_batch(cols["host_cpu_freq"], cols["host_cores"])
        rate = np.minimum(c / (t_host + t_dev), 1.0 / t_dev)
        tau = rate * self.terms.items_per_step
        util = np.minimum(rate * t_dev, 1.0)
        t_c = self.terms.t_compute * (self.hw.nominal_tpu_freq / cols["tpu_freq"])
        t_m = self.terms.t_memory * (self.hw.nominal_hbm_freq / cols["hbm_freq"])
        mem_frac = t_m / np.maximum(t_c + t_m, 1e-12)
        return tau, util, mem_frac

    def throughput_batch(self, cols: Dict[str, np.ndarray]) -> np.ndarray:
        """items/sec for canonical knob columns (N,) → (N,)."""
        return self.stats_batch(cols)[0]
