"""``build_twin``: one constructor for the device twin a cell calls for.

The port of ``repro.device.factory``. A cell's regime name alone decides
which twin is built:

  stationary regime  → ``DeviceSimulator``         (single-model edge)
  drift regime       → ``DriftingSimulator``       (non-stationary wrap)
  fault regime       → ``FaultySimulator``         (fault-injected wrap)

The reference's offload and cotenant twins are not ported yet: their
cells raise ``NotImplementedError`` naming the ROADMAP item that ports
each (``scenarios.check_ported``).

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
    scoring and oracles use.
    """
    from repro_torch.experiments import scenarios as sc

    sc.check_ported(cell)
    if cell.regime in sc.FAULT_REGIMES:
        return sc.fault_cell_simulator(cell, noise=noise, seed=seed)
    if sc.REGIMES[cell.regime].dynamic:
        return sc.drifting_cell_simulator(cell, noise=noise, seed=seed)
    return sc.cell_simulator(cell, noise=noise, seed=seed)
