"""Multi-pod dry run (the counterpart of ``repro/launch/dryrun.py``): run
one step of every (arch × input shape) pair on the production mesh, count
its per-chip costs and memory, and write the roofline artifact that
``report`` renders and ``tune`` reads.

The reference lowers and compiles each step for 512 forced host devices.
Here the step runs once on meta-device DTensors over a ``fake`` process
group (``launch/mesh.py``): every parameter, optimizer state, input and
cache tensor is the meta local shard its rank would hold under
``rcfg.sharding_rules``; DTensor propagates the sharding op by op, as
GSPMD does, issuing the local ops and collectives of one rank, which
``launch/hlo_analysis.CostModel`` counts. Nothing is allocated and
nothing is communicated. Plain tensors the model makes (positions,
masks) are taken as replicated (``implicit_replication``). The dry run
takes the plain paths, as the reference's lowers with ``use_pallas=False``.

``compile_seconds`` is the traced step's wall time. ``memory``:
``argument_bytes`` the local bytes of the step's arguments, ``output_bytes``
of its outputs, ``peak_bytes`` the most local bytes alive at once, and
``temp_bytes`` the peak less the arguments.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --multi-pod
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback

from repro_torch.configs.registry import REGISTRY, get_config
from repro_torch.configs.runtime import RunConfig
from repro_torch.configs.shapes import SHAPES


def _mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh.shape)


def _batch_specs(mesh, batch, global_batch):
    from repro_torch.sharding.specs import activation_sharding

    return {k: activation_sharding(mesh, global_batch, v.ndim - 1) for k, v in batch.items()}


def build_step(cfg, shape, mesh, rcfg: RunConfig):
    """(step, args) of one (config, ``InputShape``) pair: the step function
    over meta DTensors sharded on ``mesh`` (the reference's ``lower_one``
    before lowering)."""
    from repro_torch.launch.specs import input_specs
    from repro_torch.models.layers import abstract_params
    from repro_torch.models.transformer import ApplyCtx, param_specs
    from repro_torch.serving.engine import make_prefill_step, make_serve_step
    from repro_torch.sharding.specs import (
        Spec, activation_sharding, cache_shardings, distribute_tree, param_shardings)
    from repro_torch.training import AdamWConfig, make_train_step
    from repro_torch.training.adamw import init as adamw_init

    if rcfg.use_kernels:
        raise ValueError("the dry run counts the plain paths: use_kernels must be False")
    ctx = ApplyCtx(cfg, rcfg, mesh)
    specs = param_specs(cfg)
    p_spec = param_shardings(mesh, specs, rcfg.sharding_rules)
    params = distribute_tree(mesh, abstract_params(specs, rcfg.pdtype), p_spec)
    kwargs = input_specs(cfg, shape, rcfg)

    if shape.kind == "train":
        step = make_train_step(ctx, AdamWConfig())
        opt_state = adamw_init(params)
        batch = distribute_tree(mesh, kwargs["batch"],
                                _batch_specs(mesh, kwargs["batch"], shape.global_batch))
        return step, (params, opt_state, batch)
    if shape.kind == "prefill":
        step = make_prefill_step(ctx)
        batch = distribute_tree(mesh, kwargs["batch"],
                                _batch_specs(mesh, kwargs["batch"], shape.global_batch))
        return step, (params, batch)
    step = make_serve_step(ctx)
    cache = distribute_tree(mesh, kwargs["cache"],
                            cache_shardings(mesh, cfg, kwargs["cache"], shape.global_batch))
    if rcfg.decode_tp_over_data:
        # TP decode: tokens replicated over data; the contraction over the
        # data-sharded embed dim reduces activations instead of gathering
        # weights.
        t_spec = Spec(None, None)
    else:
        t_spec = activation_sharding(mesh, shape.global_batch, 1)
    tokens = distribute_tree(mesh, kwargs["tokens"], t_spec)
    return step, (params, cache, tokens)


def count_step(step, args):
    """Run ``step(*args)`` once under the cost model: (costs, memory dict,
    seconds)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.hlo_analysis import CostModel

    t0 = time.time()
    cm = CostModel()
    with cm:
        arg_bytes = cm.track(args)
        with implicit_replication():
            out = step(*args)
        out_bytes = sum(_local_bytes(t) for t in _tensors(out))
    seconds = time.time() - t0
    memory = {
        "argument_bytes": int(arg_bytes),
        "output_bytes": int(out_bytes),
        "temp_bytes": int(max(cm.peak - arg_bytes, 0)),
        "peak_bytes": int(cm.peak),
    }
    return cm.costs, memory, seconds


def _tensors(tree):
    from torch.utils._pytree import tree_flatten

    import torch

    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _local_bytes(t) -> int:
    from repro_torch.sharding.specs import is_dtensor

    local = t._local_tensor if is_dtensor(t) else t
    return local.numel() * local.element_size()


def model_flops(cfg, shp) -> float:
    """6·N_active·D (train), 2·N_active·D (prefill), 2·N_active·B (decode)."""
    if shp.kind == "train":
        return 6.0 * cfg.n_active_params() * shp.global_batch * shp.seq_len
    if shp.kind == "prefill":
        return 2.0 * cfg.n_active_params() * shp.global_batch * shp.seq_len
    return 2.0 * cfg.n_active_params() * shp.global_batch


def record(cfg, shp, mesh, rcfg: RunConfig, costs, memory, seconds: float) -> dict:
    """The reference's artifact, key for key."""
    from repro_torch.launch.hlo_analysis import roofline_from_costs

    n_chips = math.prod(mesh.shape)
    rec = {
        "arch": cfg.name,
        "shape": shp.name,
        "mesh": _mesh_name(mesh),
        "n_chips": n_chips,
        "compile_seconds": round(seconds, 1),
        "sharding_rules": rcfg.sharding_rules,
        "memory": memory,
        "roofline": roofline_from_costs(costs, n_chips).as_dict(),
        "model_params": cfg.n_params(),
        "model_params_active": cfg.n_active_params(),
        "global_batch": shp.global_batch,
        "seq_len": shp.seq_len,
    }
    rec["model_flops"] = model_flops(cfg, shp)
    hlo_global = rec["roofline"]["flops_per_chip"] * n_chips
    rec["model_flops_ratio"] = rec["model_flops"] / hlo_global if hlo_global else 0.0
    return rec


def write(rec: dict, out_dir: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    fn = os.path.join(out_dir, f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json")
    with open(fn, "w") as f:
        json.dump(rec, f, indent=2)
    return fn


def run_on_mesh(cfg, shape, mesh, rcfg: RunConfig, out_dir: str = "") -> dict:
    """Count one step of ``cfg`` (a ``ModelConfig``) at ``shape`` (an
    ``InputShape``) on ``mesh``; write its artifact under ``out_dir``."""
    costs, memory, seconds = count_step(*build_step(cfg, shape, mesh, rcfg))
    rec = record(cfg, shape, mesh, rcfg, costs, memory, seconds)
    if out_dir:
        write(rec, out_dir)
    return rec


def run_pair(arch: str, shape_name: str, multi_pod: bool, rcfg: RunConfig,
             out_dir: str) -> dict:
    from repro_torch.launch.mesh import make_production_mesh

    return run_on_mesh(get_config(arch), SHAPES[shape_name],
                       make_production_mesh(multi_pod=multi_pod), rcfg, out_dir)


def ok_line(tag: str, rec: dict) -> str:
    r = rec["roofline"]
    return (f"[OK] {tag}: compile={rec['compile_seconds']}s "
            f"peak={rec['memory']['peak_bytes']/2**30:.2f}GiB/dev "
            f"t_comp={r['t_compute']*1e3:.2f}ms t_mem={r['t_memory']*1e3:.2f}ms "
            f"t_coll={r['t_collective']*1e3:.2f}ms dominant={r['dominant']}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--rules", default=None, help="sharding rule set override")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--continue-on-error", action="store_true")
    args = ap.parse_args(argv)

    archs = list(REGISTRY) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    rcfg = RunConfig()
    if args.rules:
        rcfg = dataclasses.replace(rcfg, sharding_rules=args.rules)

    failures = []
    for arch in archs:
        for shape in shapes:
            tag = f"{arch} × {shape} × {'2x16x16' if args.multi_pod else '16x16'}"
            try:
                rec = run_pair(arch, shape, args.multi_pod, rcfg, args.out)
                print(ok_line(tag, rec), flush=True)
            except Exception as e:  # noqa: BLE001
                failures.append(tag)
                print(f"[FAIL] {tag}: {type(e).__name__}: {e}", flush=True)
                if not args.continue_on_error:
                    traceback.print_exc()
                    sys.exit(1)
    if failures:
        print(f"{len(failures)} failures: {failures}")
        sys.exit(1)
    print("all dry-runs passed")


if __name__ == "__main__":
    main()
