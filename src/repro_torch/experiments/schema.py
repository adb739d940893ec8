"""JSON schemas for BENCH_matrix.json / BENCH_fleet.json and a
dependency-free validator.

The port's own copy of ``repro.experiments.schema``, with one change:
``MATRIX_SCHEMA``'s ``engine`` enum is ``["compiled", "batched",
"scalar"]``, so that the port's records (``"batched"`` or ``"scalar"``)
and the committed records of the JAX package (``"compiled"``) both
validate. Everything else is the reference's, constraint for constraint.

``MATRIX_SCHEMA`` and ``FLEET_SCHEMA`` are standard JSON Schema (draft
2020-12 subset). When the ``jsonschema`` package is importable it is
used directly; otherwise the validators fall back to a built-in
structural checker covering the same constraints (type, required, enum,
bounds), so a machine without ``jsonschema`` validates either way.

The version history of every BENCH_*.json artifact (what each schema
bump added, which blocks are deterministic vs machine-dependent) is
documented in docs/BENCH_SCHEMAS.md.
"""
from __future__ import annotations

from typing import Any, List

_OUTCOME = {
    "type": "object",
    "required": [
        "score",
        "tau",
        "power",
        "violates_tau",
        "violates_power",
        "measurements",
    ],
    "properties": {
        "score": {"type": ["number", "null"], "minimum": 0},
        "tau": {"type": "number", "minimum": 0},
        "power": {"type": "number", "minimum": 0},
        "violates_tau": {"type": "boolean"},
        "violates_power": {"type": "boolean"},
        "measurements": {"type": "integer", "minimum": 0},
    },
}

_CELL = {
    "type": "object",
    "required": [
        "device",
        "model",
        "workload",
        "regime",
        "mode",
        "tau_target",
        "p_budget",
        "space_size",
        "oracle",
        "coral",
        "baselines",
    ],
    "properties": {
        "device": {"type": "string"},
        "model": {"type": "string"},
        "workload": {"type": "string"},
        "regime": {"type": "string"},
        "mode": {"type": "string", "enum": ["dual", "throughput"]},
        "tau_target": {"type": "number", "minimum": 0},
        "p_budget": {"type": ["number", "null"]},
        "space_size": {"type": "integer", "minimum": 1},
        "oracle": {
            "type": "object",
            "required": ["config", "tau", "power", "measurements"],
            "properties": {
                "config": {
                    "type": ["array", "null"],
                    "items": {"type": "number"},
                },
                "tau": {"type": "number", "minimum": 0},
                "power": {"type": "number", "minimum": 0},
                "measurements": {"type": "integer", "minimum": 0},
            },
        },
        "coral": {
            "type": "object",
            "required": [
                "score",
                "score_min",
                "score_floor",
                "violation_rate",
                "power_violations",
                "found_feasible_rate",
                "measurements_to_feasible",
                "measurements",
                "tau",
                "power",
                "config",
            ],
            "properties": {
                "score": {"type": "number", "minimum": 0},
                "score_min": {"type": "number", "minimum": 0},
                "score_floor": {"type": "number", "minimum": 0},
                "violation_rate": {
                    "type": "number",
                    "minimum": 0,
                    "maximum": 1,
                },
                "power_violations": {"type": "integer", "minimum": 0},
                "found_feasible_rate": {
                    "type": "number",
                    "minimum": 0,
                    "maximum": 1,
                },
                "measurements_to_feasible": {
                    "type": ["number", "null"],
                    "minimum": 0,
                },
                "measurements": {"type": "integer", "minimum": 0},
                "tau": {"type": "number", "minimum": 0},
                "power": {"type": "number", "minimum": 0},
                "config": {
                    "type": ["array", "null"],
                    "items": {"type": "number"},
                },
            },
        },
        "baselines": {
            "type": "object",
            "required": ["alert", "alert_online", "max_power", "default"],
            "additionalProperties": _OUTCOME,
        },
    },
}

# Offload cells (schema v4) extend the static-cell shape: the baselines
# block additionally records the min_power preset (every preset must be
# visibly infeasible on a calibrated offload cell), and the ``offload``
# block carries the network/demand provenance plus the no-offload
# ablation — the best φ=0 row of the joint grid, with the violation
# flags that show why routing is required.
_OFFLOAD_CELL = {
    "type": "object",
    "required": _CELL["required"] + ["offload"],
    "properties": {
        **_CELL["properties"],
        "baselines": {
            "type": "object",
            "required": [
                "alert",
                "alert_online",
                "max_power",
                "default",
                "min_power",
            ],
            "additionalProperties": _OUTCOME,
        },
        "offload": {
            "type": "object",
            "required": [
                "network",
                "trace",
                "demand",
                "demand_factor",
                "slo_frac",
                "p_slack",
                "edge_only_max",
                "no_offload",
            ],
            "properties": {
                "network": {"type": "string"},
                "trace": {"type": "string"},
                "demand": {"type": "number", "minimum": 0},
                "demand_factor": {"type": "number", "minimum": 1},
                "slo_frac": {"type": "number", "minimum": 0, "maximum": 1},
                "p_slack": {"type": "number", "minimum": 1},
                "edge_only_max": {"type": "number", "minimum": 0},
                "no_offload": {
                    "type": "object",
                    "required": [
                        "feasible_rows",
                        "config",
                        "tau",
                        "power",
                        "violates_tau",
                        "violates_power",
                    ],
                    "properties": {
                        "feasible_rows": {"type": "integer", "minimum": 0},
                        "config": {
                            "type": ["array", "null"],
                            "items": {"type": "number"},
                        },
                        "tau": {"type": "number", "minimum": 0},
                        "power": {"type": "number", "minimum": 0},
                        "violates_tau": {"type": "boolean"},
                        "violates_power": {"type": "boolean"},
                    },
                },
            },
        },
    },
}

# Cotenant cells (schema v5) reuse the static-cell shape on the
# scalarized (joint headroom, rail power) channel — tau_target is the
# constant 1.0, the min_power preset is recorded (every preset must be
# visibly infeasible on a calibrated cell) — and add the ``cotenant``
# block: per-tenant provenance (model, workload, floor, solo max) plus
# the per-tenant-greedy ablation, whose combined config must miss a
# floor or bust the shared cap.
_COTENANT_CELL = {
    "type": "object",
    "required": _CELL["required"] + ["cotenant"],
    "properties": {
        **_CELL["properties"],
        "baselines": {
            "type": "object",
            "required": [
                "alert",
                "alert_online",
                "max_power",
                "default",
                "min_power",
            ],
            "additionalProperties": _OUTCOME,
        },
        "cotenant": {
            "type": "object",
            "required": ["n_tenants", "p_slack", "tenants", "greedy"],
            "properties": {
                "n_tenants": {"type": "integer", "minimum": 2},
                "p_slack": {"type": "number", "minimum": 1},
                "tenants": {
                    "type": "array",
                    "minItems": 2,
                    "items": {
                        "type": "object",
                        "required": [
                            "model",
                            "workload",
                            "tau_frac",
                            "floor",
                            "solo_max",
                        ],
                        "properties": {
                            "model": {"type": "string"},
                            "workload": {"type": "string"},
                            "tau_frac": {
                                "type": "number",
                                "minimum": 0,
                                "maximum": 1,
                            },
                            "floor": {"type": "number", "minimum": 0},
                            "solo_max": {"type": "number", "minimum": 0},
                        },
                    },
                },
                "greedy": {
                    "type": "object",
                    "required": [
                        "config",
                        "headroom",
                        "power",
                        "violates_tau",
                        "violates_power",
                    ],
                    "properties": {
                        "config": {
                            "type": ["array", "null"],
                            "items": {"type": "number"},
                        },
                        "headroom": {"type": "number", "minimum": 0},
                        "power": {"type": "number", "minimum": 0},
                        "violates_tau": {"type": "boolean"},
                        "violates_power": {"type": "boolean"},
                    },
                },
            },
        },
    },
}

_DRIFT_VARIANT = {
    "type": "object",
    "required": [
        "final_score",
        "final_score_min",
        "final_score_max",
        "score_floor",
        "recovered_rate",
        "recovery_intervals",
        "transient_violation_rate",
        "resets",
    ],
    "properties": {
        "final_score": {"type": "number", "minimum": 0},
        "final_score_min": {"type": "number", "minimum": 0},
        "final_score_max": {"type": "number", "minimum": 0},
        "score_floor": {"type": "number", "minimum": 0},
        "recovered_rate": {"type": "number", "minimum": 0, "maximum": 1},
        "recovery_intervals": {"type": ["number", "null"], "minimum": 0},
        "transient_violation_rate": {
            "type": "number",
            "minimum": 0,
            "maximum": 1,
        },
        "resets": {"type": "number", "minimum": 0},
    },
}

_DRIFT_CELL = {
    "type": "object",
    "required": [
        "device",
        "model",
        "workload",
        "regime",
        "mode",
        "tau_target",
        "p_budget",
        "p_budget_post",
        "space_size",
        "drift",
        "post_oracle",
        "adaptive",
        "static",
    ],
    "properties": {
        "device": {"type": "string"},
        "model": {"type": "string"},
        "workload": {"type": "string"},
        "regime": {"type": "string"},
        "mode": {"type": "string", "enum": ["dual", "throughput"]},
        "tau_target": {"type": "number", "minimum": 0},
        "p_budget": {"type": ["number", "null"]},
        "p_budget_post": {"type": ["number", "null"]},
        "space_size": {"type": "integer", "minimum": 1},
        "drift": {
            "type": "object",
            "required": ["schedule", "shift_start", "shift_end", "intervals"],
            "properties": {
                "schedule": {"type": "string"},
                "shift_start": {"type": "integer", "minimum": 0},
                "shift_end": {"type": "integer", "minimum": 0},
                "intervals": {"type": "integer", "minimum": 1},
            },
        },
        "post_oracle": {
            "type": "object",
            "required": ["config", "tau", "power"],
            "properties": {
                "config": {
                    "type": ["array", "null"],
                    "items": {"type": "number"},
                },
                "tau": {"type": "number", "minimum": 0},
                "power": {"type": "number", "minimum": 0},
            },
        },
        "adaptive": _DRIFT_VARIANT,
        "static": _DRIFT_VARIANT,
    },
}

# Fault-injection cell (schema v6): hardened CORAL vs the non-hardened
# ablation through byte-identical fault realizations, both scored on the
# fault-free twin against the fault-free oracle. ``failed_runs`` counts
# per-seed runs that ended infeasible or violating — the committed gate
# is hardened score ≥ 0.85 with zero power violations while the ablation
# has ``failed_runs == n_runs`` on every cell.
_FAULT_VARIANT = {
    "type": "object",
    "required": [
        "score",
        "score_min",
        "score_floor",
        "violation_rate",
        "power_violations",
        "n_runs",
        "failed_runs",
        "fallback_intervals",
        "rejected_samples",
        "tau",
        "power",
        "config",
    ],
    "properties": {
        "score": {"type": "number", "minimum": 0},
        "score_min": {"type": "number", "minimum": 0},
        "score_floor": {"type": "number", "minimum": 0},
        "violation_rate": {"type": "number", "minimum": 0, "maximum": 1},
        "power_violations": {"type": "integer", "minimum": 0},
        "n_runs": {"type": "integer", "minimum": 1},
        "failed_runs": {"type": "integer", "minimum": 0},
        "fallback_intervals": {"type": "number", "minimum": 0},
        "rejected_samples": {"type": "number", "minimum": 0},
        "tau": {"type": "number", "minimum": 0},
        "power": {"type": "number", "minimum": 0},
        "config": {"type": ["array", "null"], "items": {"type": "number"}},
    },
}

_FAULT_CELL = {
    "type": "object",
    "required": [
        "device",
        "model",
        "workload",
        "regime",
        "mode",
        "tau_target",
        "p_budget",
        "space_size",
        "fault",
        "oracle",
        "hardened",
        "ablation",
    ],
    "properties": {
        "device": {"type": "string"},
        "model": {"type": "string"},
        "workload": {"type": "string"},
        "regime": {"type": "string"},
        "mode": {"type": "string", "enum": ["dual", "throughput"]},
        "tau_target": {"type": "number", "minimum": 0},
        "p_budget": {"type": ["number", "null"]},
        "space_size": {"type": "integer", "minimum": 1},
        "fault": {
            "type": "object",
            "required": ["schedule", "base_regime", "intervals"],
            "properties": {
                "schedule": {"type": "string"},
                "base_regime": {"type": "string"},
                "intervals": {"type": "integer", "minimum": 1},
            },
        },
        "oracle": {
            "type": "object",
            "required": ["config", "tau", "power", "measurements"],
            "properties": {
                "config": {
                    "type": ["array", "null"],
                    "items": {"type": "number"},
                },
                "tau": {"type": "number", "minimum": 0},
                "power": {"type": "number", "minimum": 0},
                "measurements": {"type": "integer", "minimum": 0},
            },
        },
        "hardened": _FAULT_VARIANT,
        "ablation": _FAULT_VARIANT,
    },
}

# Per-phase wall-clock accounting (since schema v3; offload phases added
# in v4, cotenant in v5, fault in v6): where a matrix run spends its
# time. All fields in seconds; the ``*_episodes_s`` entries are the
# episode *control loops* — the part the compiled engine replaces.
_WALL_CLOCK_KEYS = (
    "static_prep_s",
    "static_episodes_s",
    "static_score_s",
    "offload_prep_s",
    "offload_episodes_s",
    "offload_score_s",
    "cotenant_prep_s",
    "cotenant_episodes_s",
    "cotenant_score_s",
    "fault_prep_s",
    "fault_episodes_s",
    "fault_score_s",
    "drift_prep_s",
    "drift_episodes_s",
    "drift_score_s",
)

_WALL_CLOCK = {
    "type": "object",
    "required": list(_WALL_CLOCK_KEYS),
    "properties": {
        k: {"type": "number", "minimum": 0} for k in _WALL_CLOCK_KEYS
    },
}

# Compiled-vs-scalar episode-engine speedup probe (benchmarks only —
# optional because plain ``run_matrix`` records don't re-run the scalar
# layer). ``compile_s`` is the one-time jit cost, amortized by the
# persistent compilation cache in CI.
_EPISODE_ENGINE = {
    "type": "object",
    "required": ["static", "drift", "compile_s"],
    "properties": {
        "static": {
            "type": "object",
            "required": ["scalar_s", "compiled_s", "speedup"],
            "properties": {
                "scalar_s": {"type": "number", "minimum": 0},
                "compiled_s": {"type": "number", "minimum": 0},
                "speedup": {"type": "number", "minimum": 0},
            },
        },
        "drift": {
            "type": "object",
            "required": ["scalar_s", "compiled_s", "speedup"],
            "properties": {
                "scalar_s": {"type": "number", "minimum": 0},
                "compiled_s": {"type": "number", "minimum": 0},
                "speedup": {"type": "number", "minimum": 0},
            },
        },
        "compile_s": {"type": "number", "minimum": 0},
    },
}

MATRIX_SCHEMA = {
    "$schema": "https://json-schema.org/draft/2020-12/schema",
    "title": "BENCH_matrix",
    "type": "object",
    "required": [
        "schema_version",
        "regenerate",
        "quick",
        "engine",
        "iters",
        "seeds",
        "wall_clock_s",
        "grid",
        "cells",
        "drift_cells",
        "offload_cells",
        "cotenant_cells",
        "fault_cells",
        "summary",
    ],
    "properties": {
        "schema_version": {"type": "integer", "enum": [6]},
        "regenerate": {"type": "string"},
        "quick": {"type": "boolean"},
        "engine": {"type": "string", "enum": ["compiled", "batched", "scalar"]},
        "wall_clock_s": _WALL_CLOCK,
        "episode_engine": _EPISODE_ENGINE,
        "iters": {"type": "integer", "minimum": 1},
        "seeds": {
            "type": "array",
            "items": {"type": "integer"},
            "minItems": 1,
        },
        "grid": {
            "type": "object",
            "required": [
                "devices",
                "models",
                "workloads",
                "regimes",
                "offload_regimes",
                "cotenant_regimes",
                "fault_regimes",
            ],
            "properties": {
                **{
                    k: {
                        "type": "array",
                        "items": {"type": "string"},
                        "minItems": 1,
                    }
                    for k in ("devices", "models", "workloads", "regimes")
                },
                # empty when the run carries no offload cells
                "offload_regimes": {
                    "type": "array",
                    "items": {"type": "string"},
                },
                # empty when the run carries no cotenant cells
                "cotenant_regimes": {
                    "type": "array",
                    "items": {"type": "string"},
                },
                # empty when the run carries no fault-injection cells
                "fault_regimes": {
                    "type": "array",
                    "items": {"type": "string"},
                },
            },
        },
        "cells": {"type": "array", "items": _CELL, "minItems": 1},
        # empty when the grid has no dynamic regime (e.g. trimmed runs)
        "drift_cells": {"type": "array", "items": _DRIFT_CELL},
        # empty when the run carries no edge↔pod offload cells
        "offload_cells": {"type": "array", "items": _OFFLOAD_CELL},
        # empty when the run carries no multi-tenant co-inference cells
        "cotenant_cells": {"type": "array", "items": _COTENANT_CELL},
        # empty when the run carries no fault-injection cells
        "fault_cells": {"type": "array", "items": _FAULT_CELL},
        "summary": {
            "type": "object",
            "required": [
                "n_cells",
                "mean_coral_score",
                "min_single_target_score",
                "dual_power_violations",
                "dual_tau_miss_cells",
                "n_drift_cells",
                "min_drift_adaptive_score",
                "max_drift_static_score",
                "min_drift_separation",
                "n_offload_cells",
                "min_offload_score",
                "offload_power_violations",
                "offload_feasible_baselines",
                "n_cotenant_cells",
                "min_cotenant_score",
                "cotenant_power_violations",
                "cotenant_feasible_baselines",
                "n_fault_cells",
                "min_fault_hardened_score",
                "fault_power_violations",
                "fault_feasible_ablations",
            ],
            "properties": {
                "n_cells": {"type": "integer", "minimum": 1},
                "mean_coral_score": {"type": "number"},
                "min_single_target_score": {"type": ["number", "null"]},
                "dual_power_violations": {"type": "integer", "minimum": 0},
                "dual_tau_miss_cells": {"type": "integer", "minimum": 0},
                "n_drift_cells": {"type": "integer", "minimum": 0},
                "min_drift_adaptive_score": {"type": ["number", "null"]},
                "max_drift_static_score": {"type": ["number", "null"]},
                "min_drift_separation": {"type": ["number", "null"]},
                "n_offload_cells": {"type": "integer", "minimum": 0},
                "min_offload_score": {"type": ["number", "null"]},
                "offload_power_violations": {"type": "integer", "minimum": 0},
                "offload_feasible_baselines": {
                    "type": "integer",
                    "minimum": 0,
                },
                "n_cotenant_cells": {"type": "integer", "minimum": 0},
                "min_cotenant_score": {"type": ["number", "null"]},
                "cotenant_power_violations": {
                    "type": "integer",
                    "minimum": 0,
                },
                "cotenant_feasible_baselines": {
                    "type": "integer",
                    "minimum": 0,
                },
                "n_fault_cells": {"type": "integer", "minimum": 0},
                "min_fault_hardened_score": {"type": ["number", "null"]},
                "fault_power_violations": {"type": "integer", "minimum": 0},
                "fault_feasible_ablations": {
                    "type": "integer",
                    "minimum": 0,
                },
            },
        },
    },
}

# ---------------------------------------------------------------------------
# BENCH_fleet.json — fleet-scale heterogeneous-twin tuning record.
#
# The ``results`` block is deterministic for a given (n_twins, seed,
# iters, window): twin sampling, noise streams and the compiled engine
# are all seeded, so two runs on the same software stack must agree
# byte-for-byte (tests/test_fleet.py enforces this). The ``engine``
# block is machine-dependent wall-clock/memory telemetry and is never
# part of the determinism contract.
# ---------------------------------------------------------------------------

_FLEET_FAMILY = {
    "type": "object",
    "required": ["n_twins", "feasible_rate", "mean_m2f", "mean_score"],
    "properties": {
        "n_twins": {"type": "integer", "minimum": 0},
        "feasible_rate": {"type": "number", "minimum": 0, "maximum": 1},
        "mean_m2f": {"type": ["number", "null"], "minimum": 0},
        "mean_score": {"type": ["number", "null"], "minimum": 0},
    },
}

_FLEET_CURVE = {
    "type": "object",
    "required": ["cold", "warm"],
    "properties": {
        k: {
            "type": "array",
            "items": {"type": "number", "minimum": 0, "maximum": 1},
        }
        for k in ("cold", "warm")
    },
}

FLEET_SCHEMA = {
    "$schema": "https://json-schema.org/draft/2020-12/schema",
    "title": "BENCH_fleet",
    "type": "object",
    "required": ["schema_version", "regenerate", "quick", "results", "engine"],
    "properties": {
        "schema_version": {"type": "integer", "enum": [1]},
        "regenerate": {"type": "string"},
        "quick": {"type": "boolean"},
        "results": {
            "type": "object",
            "required": [
                "n_twins",
                "seed",
                "iters",
                "window",
                "families",
                "model",
                "workload",
                "feasible_rate",
                "mean_m2f_cold",
                "mean_score",
                "warm_cohort",
                "warm_matched",
                "mean_m2f_cold_cohort",
                "mean_m2f_warm_cohort",
                "warm_gain",
                "per_family",
                "convergence",
            ],
            "properties": {
                "n_twins": {"type": "integer", "minimum": 1},
                "seed": {"type": "integer"},
                "iters": {"type": "integer", "minimum": 1},
                "window": {"type": "integer", "minimum": 2},
                "families": {
                    "type": "array",
                    "items": {"type": "string"},
                    "minItems": 1,
                },
                "model": {"type": "string"},
                "workload": {"type": "string"},
                "feasible_rate": {"type": "number", "minimum": 0, "maximum": 1},
                "mean_m2f_cold": {"type": ["number", "null"], "minimum": 0},
                "mean_score": {"type": ["number", "null"], "minimum": 0},
                "warm_cohort": {"type": "integer", "minimum": 0},
                "warm_matched": {"type": "integer", "minimum": 0},
                "mean_m2f_cold_cohort": {
                    "type": ["number", "null"],
                    "minimum": 0,
                },
                "mean_m2f_warm_cohort": {
                    "type": ["number", "null"],
                    "minimum": 0,
                },
                "warm_gain": {"type": ["number", "null"], "minimum": 0},
                "per_family": {
                    "type": "object",
                    "additionalProperties": _FLEET_FAMILY,
                },
                "convergence": {
                    "type": "object",
                    "additionalProperties": _FLEET_CURVE,
                },
            },
        },
        "engine": {
            "type": "object",
            "required": [
                "backend",
                "prep_s",
                "cold_wall_s",
                "warm_wall_s",
                "table_bytes",
                "batch_bytes",
                "consts_bytes",
            ],
            "properties": {
                "backend": {"type": "string"},
                "prep_s": {"type": "number", "minimum": 0},
                "cold_wall_s": {"type": "number", "minimum": 0},
                "warm_wall_s": {"type": "number", "minimum": 0},
                "steady_wall_s": {"type": ["number", "null"], "minimum": 0},
                "twins_per_s": {"type": ["number", "null"], "minimum": 0},
                "table_bytes": {"type": "integer", "minimum": 0},
                "batch_bytes": {"type": "integer", "minimum": 0},
                "consts_bytes": {"type": "integer", "minimum": 0},
                "peak_device_bytes": {"type": ["integer", "null"], "minimum": 0},
            },
        },
    },
}

_TYPES = {
    "object": dict,
    "array": list,
    "string": str,
    "boolean": bool,
    "null": type(None),
}


def _check(node: Any, schema: dict, path: str, errors: List[str]) -> None:
    """Minimal structural validator for the subset MATRIX_SCHEMA uses."""
    types = schema.get("type")
    if types is not None:
        allowed = [types] if isinstance(types, str) else list(types)
        ok = False
        for t in allowed:
            if t == "number":
                ok |= isinstance(node, (int, float)) and not isinstance(node, bool)
            elif t == "integer":
                ok |= isinstance(node, int) and not isinstance(node, bool)
            else:
                ok |= isinstance(node, _TYPES[t])
        if not ok:
            errors.append(f"{path}: expected {allowed}, got {type(node).__name__}")
            return
    if node is None:
        return
    if "enum" in schema and node not in schema["enum"]:
        errors.append(f"{path}: {node!r} not in {schema['enum']}")
    if isinstance(node, (int, float)) and not isinstance(node, bool):
        if "minimum" in schema and node < schema["minimum"]:
            errors.append(f"{path}: {node} < minimum {schema['minimum']}")
        if "maximum" in schema and node > schema["maximum"]:
            errors.append(f"{path}: {node} > maximum {schema['maximum']}")
    if isinstance(node, dict):
        for req in schema.get("required", ()):
            if req not in node:
                errors.append(f"{path}: missing required key {req!r}")
        props = schema.get("properties", {})
        extra = schema.get("additionalProperties")
        for k, v in node.items():
            if k in props:
                _check(v, props[k], f"{path}.{k}", errors)
            elif isinstance(extra, dict):
                _check(v, extra, f"{path}.{k}", errors)
    if isinstance(node, list):
        if "minItems" in schema and len(node) < schema["minItems"]:
            errors.append(f"{path}: fewer than {schema['minItems']} items")
        item_schema = schema.get("items")
        if isinstance(item_schema, dict):
            for i, v in enumerate(node):
                _check(v, item_schema, f"{path}[{i}]", errors)


def _validate(record: dict, schema: dict, title: str) -> None:
    try:
        import jsonschema
    except ImportError:
        jsonschema = None
    if jsonschema is not None:
        try:
            jsonschema.validate(record, schema)
        except jsonschema.ValidationError as e:
            raise ValueError(f"{title} record invalid: {e.message}") from e
        return
    errors: List[str] = []
    _check(record, schema, "$", errors)
    if errors:
        raise ValueError(
            f"{title} record invalid:\n  " + "\n  ".join(errors[:20])
        )


def validate_matrix_record(record: dict) -> None:
    """Raise ValueError if the record does not conform to MATRIX_SCHEMA."""
    _validate(record, MATRIX_SCHEMA, "BENCH_matrix")


def validate_fleet_record(record: dict) -> None:
    """Raise ValueError if the record does not conform to FLEET_SCHEMA."""
    _validate(record, FLEET_SCHEMA, "BENCH_fleet")
