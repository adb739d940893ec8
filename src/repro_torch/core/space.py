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

A plain copy of ``repro.core.space``.
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


def offload_space(edge_kind: str) -> ConfigSpace:
    """The joint edge↔pod offload grid for one edge profile.

    Five dimensions — the same D as every profile space, so offload
    episodes batch into the same batched engine call as
    the stationary matrix cells (``repro_torch.core.episode`` requires
    one grid dimensionality per batch):

        gpu_freq      — the edge accelerator ladder, coarsened to ≤4
                        levels (ends kept) to hold N in the low hundreds;
        mem_freq      — the edge memory ladder, unchanged;
        concurrency   — edge inference streams (first 3 ladder steps);
        offload_frac  — the route split φ: the fraction of admitted
                        items shipped to the pod (0 = all-local);
        pod_tpu_freq  — the pod-side TPU DVFS point (coarse 3-step
                        ladder), visible from the edge through the
                        offload path's window/slice capacity.

    Edge CPU knobs are not searched — ``OffloadSimulator`` pins them at
    nominal — so Alg. 2's cores-role mask is empty here, which
    ``repro_torch.core.search.role_mask`` handles as a no-op."""
    edge = profile_space(edge_kind)
    gpu = edge.dims[edge.names.index("gpu_freq")].values
    if len(gpu) > 4:
        keep = np.linspace(0, len(gpu) - 1, 4).round().astype(int)
        gpu = tuple(gpu[i] for i in keep)
    mem = edge.dims[edge.names.index("mem_freq")].values
    conc = edge.dims[edge.names.index("concurrency")].values[:3]
    pod = tpu_pod_space()
    pod_f = pod.dims[pod.names.index("tpu_freq")].values
    pod_keep = np.linspace(0, len(pod_f) - 1, 3).round().astype(int)
    return ConfigSpace(
        dims=(
            Dim("gpu_freq", gpu),
            Dim("mem_freq", mem),
            Dim("concurrency", conc),
            Dim(OFFLOAD_DIM, (0.0, 0.2, 0.4, 0.6, 0.8)),
            Dim("pod_tpu_freq", tuple(pod_f[i] for i in pod_keep)),
        )
    )


def cotenant_space(edge_kind: str, n_tenants: int = 2) -> ConfigSpace:
    """The joint multi-tenant grid for one edge profile: per-tenant decode
    slot allocations × shared DVFS.

    Five dimensions for the default two tenants — the same D as every
    profile/offload space, so cotenant episodes batch into the same
    batched engine call as the rest of the scenario matrix:

        gpu_freq   — the shared accelerator ladder, coarsened to ≤4
                     levels (ends kept) to hold N in the low hundreds;
        mem_freq   — the shared memory ladder, unchanged;
        cpu_freq   — the shared host ladder, coarsened to 3 levels (the
                     host stage is per-tenant work but the clock is one
                     rail-wide knob);
        slots_t0   — tenant 0's decode-slot allocation (streams);
        slots_t1   — tenant 1's decode-slot allocation.

    There is no ``concurrency`` or cores dimension: total stream pressure
    is the *sum* of the slot knobs (``CotenantSimulator`` feeds it into
    the shared contention kappa), so Alg. 2's cores/concurrency role
    masks are empty no-ops here, exactly as in ``offload_space``."""
    edge = profile_space(edge_kind)
    gpu = edge.dims[edge.names.index("gpu_freq")].values
    if len(gpu) > 4:
        keep = np.linspace(0, len(gpu) - 1, 4).round().astype(int)
        gpu = tuple(gpu[i] for i in keep)
    mem = edge.dims[edge.names.index("mem_freq")].values
    cpu = edge.dims[edge.names.index("cpu_freq")].values
    cpu_keep = np.linspace(0, len(cpu) - 1, 3).round().astype(int)
    slot_dims = tuple(
        Dim(f"{TENANT_SLOT_PREFIX}{k}", (1.0, 2.0, 3.0))
        for k in range(n_tenants)
    )
    return ConfigSpace(
        dims=(
            Dim("gpu_freq", gpu),
            Dim("mem_freq", mem),
            Dim("cpu_freq", tuple(cpu[i] for i in cpu_keep)),
        )
        + slot_dims
    )


def tenant_slot_indices(space: ConfigSpace) -> Tuple[int, ...]:
    """Indices of the per-tenant slot dims (``slots_t0``, ``slots_t1``, …)
    in tenant order — empty for single-tenant spaces. The serving
    controller and the cotenant twin both locate the allocation knobs
    through this instead of hard-coding positions."""
    found = [
        (int(n[len(TENANT_SLOT_PREFIX) :]), i)
        for i, n in enumerate(space.names)
        if n.startswith(TENANT_SLOT_PREFIX)
    ]
    return tuple(i for _, i in sorted(found))


# Dimension roles used by Alg. 2's power-optimization heuristic
CORES_DIM_CANDIDATES = ("host_cores", "cpu_cores")
CONCURRENCY_DIM = "concurrency"
CPU_FREQ_DIM_CANDIDATES = ("host_cpu_freq", "cpu_freq")
# The route-split knob of the joint edge↔pod offload space — a role
# name so the serving controller and admission seam can locate it
# without hard-coding a dimension index.
OFFLOAD_DIM = "offload_frac"
# Per-tenant slot-allocation knobs of the joint cotenant space are named
# ``slots_t<k>`` (tenant index k) — a prefix role, not a fixed name,
# because the tenant count is a property of the space.
TENANT_SLOT_PREFIX = "slots_t"


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
