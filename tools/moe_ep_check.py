"""The expert-parallel MoE paths (``models/moe.py``) on several ranks of one
machine, held to the dense path: one MoE layer of an architecture (full
width, or ``--reduced``) with random weights from a seeded
``torch.Generator``, the same on every rank, run through ``moe_ffn_ep``
and ``moe_ffn_ep2d`` on each (data, model) mesh asked for, over each token
shape, and through ``moe_ffn_dense`` on rank 0.

The ranks are processes over a ``gloo`` process group (one card cannot
hold two NCCL ranks), on the card's tensors with ``--device cuda`` or on
the CPU's. Prints one JSON line per
(mesh, tokens, impl, capacity factor): the largest |EP − dense| beside
max|dense|, the wall time per call (the median of ``--reps``, after one
warm-up), and the share of expert assignments past capacity (dropped).
Run from the repository root:

    python3 tools/moe_ep_check.py [--arch moonshot-v1-16b-a3b] [--ranks 4]
        [--meshes 2x2 1x4] [--tokens 4x512 4x1] [--dtype bfloat16]
        [--device cuda] [--reduced] [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import socket
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CAPACITY_FACTORS = (8.0, 1.25)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def layer(cfg, dtype, device, seed: int = 0):
    """One MoE layer's parameters (the layer axis taken off), drawn on the
    device from a seeded generator; the router in float32, as the serving
    engine keeps it."""
    import torch

    from repro_torch.models import moe
    from repro_torch.models.layers import init_params

    gen = torch.Generator(device=device).manual_seed(seed)
    p = init_params(moe.moe_param_specs(cfg, 1), gen, dtype, device)
    p = {k: v[0] for k, v in p.items()}
    p["router"] = p["router"].float()
    return p


def tokens(cfg, shape, dtype, device, seed: int = 1):
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape + (cfg.d_model,), generator=gen, device=device).to(dtype)


def dropped_share(cfg, mesh_shape, p, x, cf):
    """Assignments past capacity over every (data, model) shard of the
    tokens, as ``moe_ffn_ep`` splits them, over all assignments."""
    from repro_torch.models import moe

    n_data, n_model = mesh_shape
    b, s, d = x.shape
    xd = x.reshape(n_data, -1, d) if b % n_data == 0 else x.reshape(1, -1, d).expand(n_data, -1, d)
    dropped = total = 0
    for xl in xd:
        t = xl.shape[0]
        t_pad = -(-t // n_model) * n_model
        xl = torch_pad(xl, t_pad)
        for xs in xl.reshape(n_model, -1, d):
            _, topi, _ = moe._route(cfg, p["router"], xs)
            dropped += moe.dropped_assignments(cfg, topi, cf)
            total += topi.numel()
    return dropped / total


def torch_pad(x, rows):
    import torch.nn.functional as F

    return F.pad(x, (0, 0, 0, rows - x.shape[0]))


def worker(rank, world, port, args, queue):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.runtime import RunConfig
    from repro_torch.models import moe

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    torch.set_num_threads(1)
    dtype = getattr(torch, args.dtype)
    cfg = get_config(args.arch)
    cfg = cfg.reduced() if args.reduced else cfg
    p = layer(cfg, dtype, args.device)
    sync = torch.cuda.synchronize if args.device == "cuda" else (lambda: None)
    for mesh_name in args.meshes:
        shape = tuple(int(n) for n in mesh_name.split("x"))
        mesh = DeviceMesh(args.device, torch.arange(world).reshape(shape),
                          mesh_dim_names=("data", "model"))
        for tok in args.tokens:
            x = tokens(cfg, tuple(int(n) for n in tok.split("x")), dtype, args.device)
            ref = moe.moe_ffn_dense(cfg, p, x)[0].float() if rank == 0 else None
            for cf in CAPACITY_FACTORS:
                for impl in ("expert_parallel", "expert_parallel_2d"):
                    rcfg = RunConfig(moe_impl=impl, capacity_factor=cf)
                    times = []
                    for _ in range(args.reps + 1):
                        dist.barrier()
                        sync()
                        t0 = time.perf_counter()
                        y, aux = moe.moe_ffn(cfg, rcfg, mesh, p, x)
                        sync()
                        times.append((time.perf_counter() - t0) * 1e3)
                    if rank == 0:
                        wall = sorted(times[1:])[len(times[1:]) // 2]
                        queue.put({
                            "mesh": mesh_name, "tokens": tok, "impl": impl, "capacity_factor": cf,
                            "max_abs_err": float((y.float() - ref).abs().max()),
                            "max_abs_dense": float(ref.abs().max()),
                            "aux": float(aux), "wall_ms": wall,
                            "dropped_share": dropped_share(cfg, shape, p, x, cf),
                        })
    dist.barrier()
    dist.destroy_process_group()


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="moonshot-v1-16b-a3b")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--meshes", nargs="+", default=["2x2", "1x4"])
    ap.add_argument("--tokens", nargs="+", default=["4x512", "4x1"])
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", type=Path, default=None, help="also write the JSON lines here")
    args = ap.parse_args(argv)
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=worker, args=(r, args.ranks, port, args, queue))
             for r in range(args.ranks)]
    for pr in procs:
        pr.start()
    rows = []
    n = len(args.meshes) * len(args.tokens) * len(CAPACITY_FACTORS) * 2
    try:
        while len(rows) < n:
            if any(pr.exitcode not in (None, 0) for pr in procs):
                raise SystemExit(f"a rank failed: exit codes {[pr.exitcode for pr in procs]}")
            try:
                rows.append(queue.get(timeout=5))
            except Exception:  # noqa: BLE001  (queue.Empty: poll the ranks again)
                continue
            print(json.dumps(rows[-1]), flush=True)
    finally:
        for pr in procs:
            pr.join(timeout=60)
            if pr.is_alive():
                pr.kill()
    if any(pr.exitcode != 0 for pr in procs):
        raise SystemExit(f"a rank failed: exit codes {[pr.exitcode for pr in procs]}")
    if args.out:
        args.out.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return rows


if __name__ == "__main__":
    main()
