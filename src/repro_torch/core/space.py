"""Hardware configuration space (paper §III-A, Table 2 analogue).

The five tunable dimensions mirror the paper's Jetson knobs mapped onto a
TPU v5e pod (DESIGN.md §2):

    host_cpu_freq  (MHz)  — input pipeline / dispatch speed
    host_cores     (#)    — preprocessing cores
    tpu_freq       (MHz)  — TPU core clock (scales peak FLOP/s)
    hbm_freq       (MHz)  — HBM clock (scales memory bandwidth)
    concurrency    (#)    — concurrent inference streams sharing the pod

Values are the *actual* physical values (not indices), as in the paper —
Alg. 2 does arithmetic on them and MINMAX/ROUND snaps back to the grid.

A plain copy of ``repro.core.space`` without the joint offload and
cotenant grids, which wait for their cells (ROADMAP queue 1 items 9, 10).
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Iterable, List, Sequence, Tuple

import numpy as np

Config = Tuple[float, ...]


@dataclasses.dataclass(frozen=True)
class Dim:
    name: str
    values: Tuple[float, ...]  # sorted ascending

    def snap(self, v: float) -> float:
        arr = np.asarray(self.values)
        return float(arr[np.argmin(np.abs(arr - v))])

    @property
    def lo(self) -> float:
        return self.values[0]

    @property
    def hi(self) -> float:
        return self.values[-1]


@dataclasses.dataclass(frozen=True)
class ConfigSpace:
    dims: Tuple[Dim, ...]

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(d.name for d in self.dims)

    def size(self) -> int:
        n = 1
        for d in self.dims:
            n *= len(d.values)
        return n

    def snap(self, vec: Sequence[float]) -> Config:
        return tuple(d.snap(v) for d, v in zip(self.dims, vec))

    def clamp_round(self, vec: Sequence[float]) -> Config:
        """MINMAX(ROUND(v), r) of Alg. 2 — snap to the discrete grid."""
        return self.snap(vec)

    def all_configs(self) -> Iterable[Config]:
        return itertools.product(*(d.values for d in self.dims))

    def grid(self) -> np.ndarray:
        """(N, D) array of every config, rows in ``all_configs`` order —
        the array-native enumeration the batched device model sweeps."""
        mesh = np.meshgrid(
            *(np.asarray(d.values, np.float64) for d in self.dims), indexing="ij"
        )
        return np.stack([m.reshape(-1) for m in mesh], axis=1)

    def random(self, rng: np.random.Generator) -> Config:
        return tuple(float(rng.choice(d.values)) for d in self.dims)

    def index(self, name: str) -> int:
        return self.names.index(name)

    def midpoint(self) -> Config:
        """Grid midpoint — CORAL's iteration-0 probe (start anchor)."""
        return tuple(d.values[len(d.values) // 2] for d in self.dims)

    def preset(self, kind: str) -> Config:
        """Manufacturer-preset analogues (§IV-A baselines)."""
        if kind == "max_power":
            return tuple(d.hi for d in self.dims)
        if kind == "default":
            # nvpmodel default modes cap aggressively (e.g. Xavier 10W mode:
            # 2 cores, low clocks): second-lowest level, single stream.
            vals = []
            for d in self.dims:
                if d.name == CONCURRENCY_DIM:
                    vals.append(d.lo)
                else:
                    vals.append(d.values[min(1, len(d.values) - 1)])
            return tuple(vals)
        if kind == "min_power":
            return tuple(d.lo for d in self.dims)
        raise KeyError(kind)

    def neighbors(self, cfg: Config) -> List[Config]:
        out = []
        for i, d in enumerate(self.dims):
            j = d.values.index(cfg[i])
            for dj in (-1, 1):
                if 0 <= j + dj < len(d.values):
                    nb = list(cfg)
                    nb[i] = d.values[j + dj]
                    out.append(tuple(nb))
        return out


def tpu_pod_space() -> ConfigSpace:
    """Default TPU-pod knob grid (≈3.6k configs — paper scale, Table 4)."""
    return ConfigSpace(
        dims=(
            Dim("host_cpu_freq", tuple(float(v) for v in range(1200, 2800, 200))),  # 8
            Dim("host_cores", (2.0, 3.0, 4.0, 5.0, 6.0)),  # 5
            Dim("tpu_freq", (470.0, 564.0, 658.0, 752.0, 846.0, 940.0)),  # 6
            Dim("hbm_freq", (1600.0, 2133.0, 2665.0)),  # 3 (scales 819 GB/s)
            Dim("concurrency", (1.0, 2.0, 3.0, 4.0, 5.0)),  # 5
        )
    )


def jetson_like_space(device: str = "xavier_nx") -> ConfigSpace:
    """The paper's original Table-2 grids (for the fig-level benchmarks)."""
    if device == "xavier_nx":
        return ConfigSpace(
            dims=(
                Dim("cpu_freq", tuple(float(v) for v in range(1190, 1909, 100))),  # 8
                Dim("cpu_cores", (2.0, 3.0, 4.0, 5.0, 6.0)),  # 5
                Dim("gpu_freq", tuple(float(v) for v in range(510, 1101, 100))),  # 6
                Dim("mem_freq", (1500.0, 1600.0, 1866.0)),  # 3
                Dim("concurrency", (1.0, 2.0, 3.0)),  # 3
            )
        )
    if device == "orin_nano":
        return ConfigSpace(
            dims=(
                Dim("cpu_freq", tuple(float(v) for v in range(806, 1511, 100))),  # 8
                Dim("cpu_cores", (2.0, 3.0, 4.0, 5.0, 6.0)),  # 5
                Dim("gpu_freq", (306.0, 406.0, 506.0, 624.0)),  # 4
                Dim("mem_freq", (2133.0, 3199.0)),  # 2
                Dim("concurrency", (1.0, 2.0, 3.0, 4.0, 5.0)),  # 5
            )
        )
    raise KeyError(device)


def profile_space(kind: str) -> ConfigSpace:
    """Knob grids owned by the device-profile registry (``repro_torch.device.hw``).

    These are the *deployment* ladders the scenario matrix tunes over —
    distinct from ``jetson_like_space``, which reproduces the paper's
    Table-2 grids verbatim for the figure-level benchmarks. The edge
    profiles differ in every ladder (CPU/GPU/EMC steps, stream counts):
    per-device tuning landscapes genuinely differ, which is what the
    matrix exists to show.
    """
    if kind == "edge_xavier_nx":
        return ConfigSpace(
            dims=(
                Dim("cpu_freq", tuple(float(v) for v in range(1190, 1909, 100))),  # 8
                Dim("cpu_cores", (2.0, 3.0, 4.0, 5.0, 6.0)),  # 5
                Dim("gpu_freq", tuple(float(v) for v in range(510, 1101, 100))),  # 6
                Dim("mem_freq", (1600.0, 1866.0)),  # 2 binned EMC steps
                Dim("concurrency", (1.0, 2.0, 3.0)),  # 3
            )
        )
    if kind == "edge_orin_nano":
        return ConfigSpace(
            dims=(
                Dim("cpu_freq", tuple(float(v) for v in range(806, 1511, 100))),  # 8
                Dim("cpu_cores", (2.0, 3.0, 4.0, 5.0, 6.0)),  # 5
                Dim("gpu_freq", (306.0, 406.0, 506.0, 624.0)),  # 4
                Dim("mem_freq", (2133.0, 3199.0)),  # 2
                Dim("concurrency", (1.0, 2.0, 3.0, 4.0, 5.0)),  # 5
            )
        )
    if kind == "edge_orin_nx":
        return ConfigSpace(
            dims=(
                Dim("cpu_freq", tuple(float(v) for v in range(1190, 1985, 110))),  # 8
                Dim("cpu_cores", (2.0, 3.0, 4.0, 5.0, 6.0)),  # 5
                Dim("gpu_freq", (306.0, 408.0, 510.0, 612.0, 765.0, 918.0)),  # 6
                Dim("mem_freq", (1866.0, 2665.0, 3733.0)),  # 3 LPDDR5 steps
                Dim("concurrency", (1.0, 2.0, 3.0, 4.0)),  # 4
            )
        )
    if kind == "tpu_pod":
        return tpu_pod_space()
    raise KeyError(kind)


# Dimension roles used by Alg. 2's power-optimization heuristic
CORES_DIM_CANDIDATES = ("host_cores", "cpu_cores")
CONCURRENCY_DIM = "concurrency"
CPU_FREQ_DIM_CANDIDATES = ("host_cpu_freq", "cpu_freq")


# ---------------------------------------------------------------------------
# Cached array views of a space — the index-space twin of ``grid()``.
#
# The episode engine (repro_torch.core.episode) represents configurations as
# grid-row indices inside its batched step; the scalar CORAL loop shares
# these same cached arrays so the two paths resolve rows, level indices
# and neighbor distances identically. ConfigSpace is a frozen (hashable)
# dataclass, so an lru_cache keyed on the space itself is sound.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def space_grid(space: ConfigSpace) -> np.ndarray:
    """Cached ``space.grid()`` — (N, D) float64, ``all_configs`` order."""
    return space.grid()


@functools.lru_cache(maxsize=None)
def space_rows(space: ConfigSpace) -> Tuple[Config, ...]:
    """Row index → config tuple, in ``all_configs`` order."""
    return tuple(space.all_configs())


@functools.lru_cache(maxsize=None)
def index_coords(space: ConfigSpace) -> np.ndarray:
    """(N, D) int32 per-dimension *level* indices for every grid row."""
    sizes = [len(d.values) for d in space.dims]
    mesh = np.meshgrid(*(np.arange(s) for s in sizes), indexing="ij")
    return np.stack([m.reshape(-1) for m in mesh], axis=1).astype(np.int32)


@functools.lru_cache(maxsize=None)
def level_strides(space: ConfigSpace) -> np.ndarray:
    """(D,) int32 strides mapping level indices to the grid-row index
    (dim 0 outermost, matching ``all_configs``/``grid`` order)."""
    sizes = [len(d.values) for d in space.dims]
    strides = np.ones(len(sizes), np.int64)
    for i in range(len(sizes) - 2, -1, -1):
        strides[i] = strides[i + 1] * sizes[i + 1]
    return strides.astype(np.int32)


def row_index(space: ConfigSpace, cfg: Sequence[float]) -> int:
    """Grid-row index of an on-grid config (exact value match)."""
    levels = [d.values.index(v) for d, v in zip(space.dims, cfg)]
    return int(np.dot(levels, level_strides(space)))
