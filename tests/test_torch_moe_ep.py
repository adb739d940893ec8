"""The port's expert-parallel MoE paths (``models/moe.py::moe_ffn_ep`` and
``moe_ffn_ep2d``) on a 2×4 (data, model) mesh of 8 CPU ranks over
``gloo``, in a subprocess, against the port's ``moe_ffn_dense`` and the
JAX package's expert-parallel paths (8 forced host devices, in another
subprocess), on reduced Qwen3-MoE-235B-A22B (no shared experts) and
DeepSeek-V2-236B (shared experts), in float32, with one layer's
parameters from the JAX initialiser and inputs from a numpy seed.

Tolerances. At ``capacity_factor=8.0`` no token is dropped, and EP and
EP2D equal the dense path within 2e-4 (the reference's own bound,
``tests/test_sharding_hlo.py``): the same products in another order. At
``capacity_factor=1.0`` tokens are dropped (asserted), and the port's
output and aux loss equal the reference's within 2e-5, which holds the
stable sort and so which tokens a full expert drops.
"""
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import REGISTRY as JAX_REGISTRY
from repro.models import moe as jax_moe
from repro.models.layers import init_params as jax_init_params
from repro_torch.configs.registry import REGISTRY
from repro_torch.configs.runtime import RunConfig
from repro_torch.models import moe

ARCHS = ["qwen3-moe-235b-a22b", "deepseek-v2-236b"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
X_SHAPE = (8, 64)  # (B, S): 64 tokens per model shard, so cf = 1.0 drops some
DENSE_TOL = 2e-4
REF_TOL = 2e-5

JAX_SNIPPET = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from repro.configs.registry import REGISTRY
from repro.configs.runtime import RunConfig
from repro.models import moe
d = sys.argv[1]
mesh = jax.make_mesh((2, 4), ("data", "model"))
out = {}
for arch in sys.argv[2:]:
    cfg = REGISTRY[arch].reduced()
    z = np.load(os.path.join(d, arch + ".npz"))
    p = {k[2:]: z[k] for k in z.files if k.startswith("p_")}
    x = z["x"]
    for name, fn in (("ep", moe.moe_ffn_ep), ("ep2d", moe.moe_ffn_ep2d)):
        rcfg = RunConfig(capacity_factor=1.0)
        with mesh:
            y, aux = jax.jit(lambda xx: fn(cfg, rcfg, mesh, p, xx))(x)
        out[f"{arch}/{name}/y"] = np.asarray(y)
        out[f"{arch}/{name}/aux"] = np.asarray(aux)
np.savez(os.path.join(d, "jax_out.npz"), **out)
print("JAX_OK")
"""

TORCH_SNIPPET = r"""
import os, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run(rank, d, port, archs):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=8)
    torch.set_num_threads(1)
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs.registry import REGISTRY
    from repro_torch.configs.runtime import RunConfig
    from repro_torch.models import moe
    mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 4), mesh_dim_names=("data", "model"))
    out = {}
    for arch in archs:
        cfg = REGISTRY[arch].reduced()
        z = np.load(os.path.join(d, arch + ".npz"))
        p = {k[2:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("p_")}
        x = torch.from_numpy(z["x"])
        out[f"{arch}/dense/y"] = moe.moe_ffn_dense(cfg, p, x)[0].numpy()
        for cf in (8.0, 1.0):
            for impl, name in (("expert_parallel", "ep"), ("expert_parallel_2d", "ep2d")):
                y, aux = moe.moe_ffn(cfg, RunConfig(moe_impl=impl, capacity_factor=cf), mesh, p, x)
                out[f"{arch}/{name}/{cf}/y"] = y.numpy()
                out[f"{arch}/{name}/{cf}/aux"] = aux.numpy()
    if rank == 0:
        np.savez(os.path.join(d, "torch_out.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    d, port = sys.argv[1], int(sys.argv[2])
    mp.spawn(run, args=(d, port, sys.argv[3:]), nprocs=8)
    print("TORCH_OK")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run(d, name, snippet, *args):
    """Run ``snippet`` as a script in ``d`` (``torch.multiprocessing``'s
    spawn re-imports the main module, so it must be a file)."""
    path = os.path.join(d, name)
    with open(path, "w") as f:
        f.write(snippet)
    env = {"PYTHONPATH": os.path.join(ROOT, "src"), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, path, *args], capture_output=True, text=True,
                       timeout=600, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One layer's parameters and input per arch, written to disk; both
    packages' runs over them, read back."""
    d = str(tmp_path_factory.mktemp("moe_ep"))
    for i, arch in enumerate(ARCHS):
        cfg = JAX_REGISTRY[arch].reduced()
        specs = jax_moe.moe_param_specs(cfg, 1)
        params = jax.tree.map(lambda a: np.asarray(a)[0],
                              jax_init_params(jax.random.PRNGKey(i), specs))
        x = np.random.default_rng(i).standard_normal(X_SHAPE + (cfg.d_model,)).astype(np.float32)
        np.savez(os.path.join(d, arch + ".npz"), x=x, **{"p_" + k: v for k, v in params.items()})
    assert "JAX_OK" in _run(d, "jax_ep.py", JAX_SNIPPET, d, *ARCHS)
    assert "TORCH_OK" in _run(d, "torch_ep.py", TORCH_SNIPPET, d, str(_free_port()), *ARCHS)
    return (dict(np.load(os.path.join(d, "jax_out.npz"))),
            dict(np.load(os.path.join(d, "torch_out.npz"))), d)


def _dropped(d, arch) -> int:
    """Assignments past capacity at cf = 1.0, from the routing of each
    model shard's 64 tokens (the batch split over 2 data shards, then 4
    model shards)."""
    cfg = REGISTRY[arch].reduced()
    z = np.load(os.path.join(d, arch + ".npz"))
    x = torch.from_numpy(z["x"]).reshape(8, 64, cfg.d_model)
    router = torch.from_numpy(z["p_router"])
    return sum(moe.dropped_assignments(cfg, moe._route(cfg, router, xs)[1], 1.0) for xs in x)


@pytest.mark.parametrize("impl", ["ep", "ep2d"])
@pytest.mark.parametrize("arch", ARCHS)
def test_expert_parallel_matches_dense(runs, arch, impl):
    """No drops at cf = 8: EP and EP2D compute the dense path's function."""
    _, t, _ = runs
    err = np.max(np.abs(t[f"{arch}/{impl}/8.0/y"] - t[f"{arch}/dense/y"]))
    assert err < DENSE_TOL, (arch, impl, err)


@pytest.mark.parametrize("impl", ["ep", "ep2d"])
@pytest.mark.parametrize("arch", ARCHS)
def test_expert_parallel_drops_as_the_reference(runs, arch, impl):
    """At cf = 1.0 tokens drop, and the port's output and aux loss equal the
    JAX package's expert-parallel run on the same parameters."""
    j, t, d = runs
    assert _dropped(d, arch) > 0
    y, aux = t[f"{arch}/{impl}/1.0/y"], t[f"{arch}/{impl}/1.0/aux"]
    assert np.max(np.abs(y - t[f"{arch}/dense/y"])) > 1e-3  # drops change the output
    np.testing.assert_allclose(y, j[f"{arch}/{impl}/y"], rtol=0, atol=REF_TOL)
    np.testing.assert_allclose(aux, j[f"{arch}/{impl}/aux"], rtol=0, atol=REF_TOL)


def test_expert_parallel_needs_a_mesh():
    cfg = REGISTRY["qwen3-moe-235b-a22b"].reduced()
    specs = moe.moe_param_specs(cfg, 1)
    from repro_torch.models.layers import init_params

    p = {k: v[0] for k, v in init_params(specs, torch.Generator().manual_seed(0)).items()}
    x = torch.zeros((1, 4, cfg.d_model))
    for impl in moe.EXPERT_PARALLEL:
        with pytest.raises(ValueError, match="needs a mesh"):
            moe.moe_ffn(cfg, RunConfig(moe_impl=impl), None, p, x)
