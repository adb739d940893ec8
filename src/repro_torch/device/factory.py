"""``build_twin``: one constructor for the device twin a cell calls for.

The port of ``repro.device.factory`` for the static cells: a stationary
regime builds a ``DeviceSimulator``. The reference's other families
(drift, fault, offload, cotenant twins) raise ``NotImplementedError``
naming the ROADMAP item that ports each (``scenarios.check_static``).

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

    sc.check_static(cell)
    return sc.cell_simulator(cell, noise=noise, seed=seed)
