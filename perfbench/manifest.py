"""Finding every piece of the benchmark by the name ``BENCHMARK.json``
gives it, so that a later change adds a cell, a configuration, a traffic
mix or a per-layer metric by adding files alone:

- ``perfbench/workloads/<cell>.json``: the cell's batch, concurrency,
  cache length, rate or backlog, trace span, grace period, sample and
  limits;
- ``perfbench/configs/<config>.json``: the model as it is run;
- ``perfbench/traffic/<mix>.json``, naming ``perfbench/traffic/<generator>.py``;
- ``perfbench/metrics/<metric>.py``: a reader ``read(obs)`` per per-layer
  metric, returning a number or None;
- ``perfbench/reference/<family>.py``: the plain reference;
- ``perfbench/families/<family>.py``: how the configuration file's keys
  set the program's ``ModelConfig``, and the FLOPs and bytes of the
  family's steps (``counts/model.py``).

A new model family is three files: its family file, its reference, and
a configuration whose ``init`` has a rule for every leaf of the
program's parameter tree (``weights.py``).
"""
from __future__ import annotations

import functools
import importlib.util
import json
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parents[1]
# the key under which a configuration found by :func:`cell` keeps the
# root it was found in, so that its family file is taken from there too
ROOT_KEY = "_root"


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _json(root: Path, *parts: str) -> dict:
    path = root.joinpath("perfbench", *parts)
    if not path.is_file():
        raise FileNotFoundError(f"the benchmark has no file {path.relative_to(root)}")
    return json.loads(path.read_text())


def _module(root: Path, *parts: str) -> ModuleType:
    path = root.joinpath("perfbench", *parts)
    if not path.is_file():
        raise FileNotFoundError(f"the benchmark has no file {path.relative_to(root)}")
    name = "perfbench_files." + ".".join(p.replace(".", "_").replace("-", "_") for p in parts)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(name: str, root: Path = ROOT) -> dict:
    """Everything a run of cell ``name`` needs: its entry in
    ``BENCHMARK.json``, its file, its configuration, its traffic mix and
    the metrics it reports."""
    man = manifest(root)
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    spec = _json(root, "workloads", name + ".json")
    conf = _json(root, "configs", entry["config"] + ".json")
    conf[ROOT_KEY] = str(root)
    mix = _json(root, "traffic", entry["traffic"] + ".json")
    e2e = [m for m in man["end_to_end"] if name in m.get("workloads", [name])]
    per_layer = [m for m in man["per_layer"] if name in m.get("workloads", [name])
                 and any(e["name"] == m["moves"] for e in e2e)]
    return {"entry": entry, "spec": spec, "conf": conf, "mix": mix, "end_to_end": e2e,
            "per_layer": per_layer, "run_seconds": man["run_seconds"]}


def generator(name: str, root: Path = ROOT) -> ModuleType:
    return _module(root, "traffic", name + ".py")


def reader(metric: str, root: Path = ROOT) -> ModuleType:
    return _module(root, "metrics", metric + ".py")


def reference(family: str, root: Path = ROOT) -> ModuleType:
    return _module(root, "reference", family + ".py")


@functools.lru_cache(maxsize=None)
def family(name: str, root: Path = ROOT) -> ModuleType:
    """``perfbench/families/<name>.py``, loaded once per root."""
    return _module(root, "families", name + ".py")


def family_of(conf: dict) -> ModuleType:
    """The family file of configuration ``conf``, from the root its cell
    was found in (the repository's, for a configuration read directly)."""
    return family(conf["family"], Path(conf.get(ROOT_KEY, ROOT)))
