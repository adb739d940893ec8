"""``build_twin``: one constructor for the device twin a cell calls for.

The port of ``repro.device.factory``. A cell's regime name alone decides
which twin is built:

  stationary regime  → ``DeviceSimulator``         (single-model edge)
  drift regime       → ``DriftingSimulator``       (non-stationary wrap)
  offload regime     → ``OffloadSimulator``        (edge↔pod joint grid)
  cotenant regime    → ``CotenantSimulator``       (multi-tenant rail)
  fault regime       → ``FaultySimulator``         (fault-injected wrap)

Imports from ``repro_torch.experiments.scenarios`` are lazy: the regime
tables live in experiments (they are calibration data, not device
physics), and ``device`` stays importable without them.
"""
from __future__ import annotations

from typing import Optional


def build_twin(cell, noise: Optional[float] = None, seed: int = 0):
    """Build the device twin a cell's regime calls for.

    ``noise=None`` takes the cell's workload-trace noise (the noisy
    device the optimizer sees); ``noise=0.0`` is the ground-truth twin
    scoring and oracles use. Raises ``KeyError`` on an unknown regime.
    """
    from repro_torch.experiments import scenarios as sc

    if cell.regime in sc.COTENANT_REGIMES:
        return sc.cotenant_cell_simulator(cell, noise=noise, seed=seed)
    if cell.regime in sc.OFFLOAD_REGIMES:
        return sc.offload_cell_simulator(cell, noise=noise, seed=seed)
    if cell.regime in sc.FAULT_REGIMES:
        return sc.fault_cell_simulator(cell, noise=noise, seed=seed)
    if sc.REGIMES[cell.regime].dynamic:
        return sc.drifting_cell_simulator(cell, noise=noise, seed=seed)
    return sc.cell_simulator(cell, noise=noise, seed=seed)
