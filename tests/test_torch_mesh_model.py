"""Every reduced model of the registry run on DTensors over a 2×4 (data,
model) mesh of 8 CPU ranks over ``gloo`` (in a subprocess) against the
same model on one device, on the same parameters, sharded by the default
rules (``megatron_fsdp``), in float32 compute. This is the code the dry
run counts: its local attention, the decode cache split over its slots,
the vocab-parallel lookup and cross-entropy, the fsdp gathers, the
expert-parallel MoE (capacity factor 8: no drops).

Tolerances. Prefill logits within 1e-4 and the training cross-entropy
within 1e-5 relative (float32, summation order only). One decode step
after the prefill within 1e-3: both caches are bfloat16, and a K or V
value computed in another order can round to the neighbouring bf16.
"""
import json
import os
import socket
import subprocess
import sys

import pytest

from repro_torch.configs.registry import REGISTRY

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = sorted(REGISTRY)
PREFILL_TOL, DECODE_TOL, XENT_REL = 1e-4, 1e-3, 1e-5

SNIPPET = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run(rank, port, out, archs):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=8)
    torch.set_num_threads(1)
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs.registry import REGISTRY
    from repro_torch.configs.runtime import RunConfig
    from repro_torch.models.transformer import (ApplyCtx, decode_step, init_model_params,
                                                param_specs, prefill)
    from repro_torch.sharding.specs import Spec, distribute, distribute_tree, param_shardings
    from repro_torch.training import multimodal_extras
    from repro_torch.training.train_step import loss_fn

    mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 4), mesh_dim_names=("data", "model"))
    res = {}
    for arch in archs:
        cfg = REGISTRY[arch].reduced()
        rcfg = RunConfig(compute_dtype="float32", capacity_factor=8.0)
        params = init_model_params(cfg, rcfg, torch.Generator().manual_seed(0))
        rng = np.random.default_rng(1)
        tok = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32))
        nxt = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 1)).astype(np.int32))
        extras = {k: torch.from_numpy(v) for k, v in multimodal_extras(cfg, 4, std=1.0).items()}
        one = ApplyCtx(cfg, rcfg)
        cache, want_pre = prefill(one, params, {"tokens": tok, **extras}, capacity=32)
        _, want_dec = decode_step(one, params, cache, nxt)
        want_xent = loss_fn(one, params, {"tokens": tok, "labels": tok, **extras})[1]["xent"]
        sharded = distribute_tree(mesh, params, param_shardings(mesh, param_specs(cfg),
                                                                rcfg.sharding_rules))
        ctx = ApplyCtx(cfg, rcfg, mesh)
        with implicit_replication():
            batch = {"tokens": distribute(mesh, tok, Spec("data", None)),
                     **{k: distribute(mesh, v, Spec("data", None, None)) for k, v in extras.items()}}
            cache, pre = prefill(ctx, sharded, batch, capacity=32)
            _, dec = decode_step(ctx, sharded, cache, distribute(mesh, nxt, Spec("data", None)))
            xent = loss_fn(ctx, sharded, dict(batch, labels=batch["tokens"]))[1]["xent"]
        pre, dec, xent = pre.full_tensor(), dec.full_tensor(), xent.full_tensor()
        res[arch] = {"prefill": float((pre - want_pre).abs().max()),
                     "decode": float((dec - want_dec).abs().max()),
                     "xent": float(xent), "want_xent": float(want_xent),
                     "finite": bool(torch.isfinite(pre).all() and torch.isfinite(dec).all())}
    if rank == 0:
        json.dump(res, open(out, "w"))
    dist.destroy_process_group()


if __name__ == "__main__":
    port, out = int(sys.argv[1]), sys.argv[2]
    mp.spawn(run, args=(port, out, sys.argv[3:]), nprocs=8)
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_model")
    script, out = d / "run.py", d / "out.json"
    script.write_text(SNIPPET)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {"PYTHONPATH": os.path.join(ROOT, "src"), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, str(script), str(port), str(out), *ARCHS],
                       capture_output=True, text=True, timeout=900, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_model_matches_one_device(results, arch):
    r = results[arch]
    assert r["finite"]
    assert r["prefill"] < PREFILL_TOL, r
    assert r["decode"] < DECODE_TOL, r
    assert r["xent"] == pytest.approx(r["want_xent"], rel=XENT_REL), r
