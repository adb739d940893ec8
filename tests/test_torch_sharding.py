"""The port's sharding rules (``sharding/specs.py``) against the JAX
package's, for every registry architecture (reduced and full), every rule
set and three meshes: 16×16 and 2×16×16 (the production meshes) and 2×4.

The reference side runs in one subprocess with 512 forced host devices,
as its own dry run does: each parameter's ``PartitionSpec`` and
``NamedSharding.shard_shape``, ``batch_spec`` and each cache leaf's spec
from ``cache_shardings`` over ``abstract_cache``. The port side runs in
another, on a ``fake`` process group of 512 ranks: each spec over a real
``DeviceMesh``, and the local shape of each meta DTensor that
``distribute`` makes, which must be the reference's shard shape (a
sharded parameter is not replicated). Specs compare exactly.
"""
import json
import os
import subprocess
import sys

import pytest

from repro.sharding.specs import RULE_SETS as JAX_RULE_SETS
from repro_torch.configs.registry import REGISTRY
from repro_torch.sharding.specs import RULE_SETS, Spec, placements, spec_for_axes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": ((16, 16), ("data", "model")), "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}
BATCHES = (1, 2, 8, 32, 128, 256, 512)
CACHE = ((128, 64), (32, 256), (1, 48))  # (batch, slots)

JAX_SNIPPET = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
from repro.configs.registry import REGISTRY
from repro.models.transformer import abstract_cache, param_specs
from repro.sharding.specs import RULE_SETS, batch_spec, cache_shardings, param_shardings
MESHES, BATCHES, CACHE = json.loads(sys.argv[2])

def enc(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]

def flat(tree, f, pre=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat(v, f, pre + k + "/"))
        else:
            out[pre + k] = f(v)
    return out

devs = jax.devices()
out = {}
for mname, (shape, axes) in MESHES.items():
    n = 1
    for s in shape:
        n *= s
    mesh = jax.sharding.Mesh(__import__("numpy").array(devs[:n]).reshape(shape), axes)
    out[mname + "|batch"] = {str(b): enc(batch_spec(mesh, b)) for b in BATCHES}
    for arch, full in REGISTRY.items():
        for red in (False, True):
            cfg = full.reduced() if red else full
            specs = param_specs(cfg)
            for rules in RULE_SETS:
                shard = param_shardings(mesh, specs, rules)
                sp = flat(shard, lambda s: enc(s.spec))
                shapes = flat(specs, lambda s: s.shape)
                sh = flat(shard, lambda s: s)
                sh = {k: list(sh[k].shard_shape(shapes[k])) for k in sh}
                out[f"{mname}|{arch}|{red}|{rules}"] = {k: [sp[k], sh[k]] for k in sp}
            if not red:
                for b, w in CACHE:
                    cache = abstract_cache(cfg, b, w)
                    cs = cache_shardings(mesh, cfg, cache, b)
                    out[f"{mname}|{arch}|cache|{b}|{w}"] = flat(cs, lambda s: enc(s.spec))
json.dump(out, open(sys.argv[1], "w"))
print("JAX_OK")
"""

TORCH_SNIPPET = r"""
import sys, json
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.configs.registry import REGISTRY
from repro_torch.models.layers import abstract_params, tree_map_specs
from repro_torch.models.transformer import abstract_cache, param_specs
from repro_torch.sharding.specs import (RULE_SETS, batch_spec, cache_shardings, distribute_tree,
                                        param_shardings)
MESHES, BATCHES, CACHE = json.loads(sys.argv[2])
make_production_mesh(multi_pod=True)  # the fake group of 512 ranks

def enc(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]

def flat(tree, f, pre=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat(v, f, pre + k + "/"))
        else:
            out[pre + k] = f(v)
    return out

out = {}
for mname, (shape, axes) in MESHES.items():
    n = 1
    for s in shape:
        n *= s
    mesh = DeviceMesh("cpu", torch.arange(n).reshape(shape), mesh_dim_names=tuple(axes))
    out[mname + "|batch"] = {str(b): enc(batch_spec(mesh, b)) for b in BATCHES}
    for arch, full in REGISTRY.items():
        for red in (False, True):
            cfg = full.reduced() if red else full
            specs = param_specs(cfg)
            for rules in RULE_SETS:
                shard = param_shardings(mesh, specs, rules)
                params = distribute_tree(mesh, abstract_params(specs, torch.bfloat16), shard)
                sp = flat(shard, enc)
                sh = flat(params, lambda t: list(t.to_local().shape))
                out[f"{mname}|{arch}|{red}|{rules}"] = {k: [sp[k], sh[k]] for k in sp}
            if not red:
                for b, w in CACHE:
                    cache = abstract_cache(cfg, b, w)
                    out[f"{mname}|{arch}|cache|{b}|{w}"] = flat(cache_shardings(mesh, cfg, cache, b), enc)
json.dump(out, open(sys.argv[1], "w"))
print("TORCH_OK")
"""


def _run(tmp, name, snippet):
    path = os.path.join(tmp, name + ".json")
    env = {"PYTHONPATH": os.path.join(ROOT, "src"), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, "-c", snippet, path, json.dumps([MESHES, BATCHES, CACHE])],
                       capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("sharding"))
    return _run(tmp, "jax", JAX_SNIPPET), _run(tmp, "torch", TORCH_SNIPPET)


def test_rule_sets_are_the_references():
    assert RULE_SETS == JAX_RULE_SETS


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_param_specs_and_shard_shapes(both, arch, reduced):
    """Every parameter's spec and local shard shape, every rule set, every mesh."""
    j, t = both
    n = 0
    for mname in MESHES:
        for rules in RULE_SETS:
            key = f"{mname}|{arch}|{reduced}|{rules}"
            assert t[key] == j[key], key
            n += sum(1 for spec, _ in t[key].values() if any(spec))
    assert n > 0  # some parameter is sharded somewhere


def test_batch_specs(both):
    j, t = both
    for mname in MESHES:
        assert t[mname + "|batch"] == j[mname + "|batch"]


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_cache_specs(both, arch):
    """``cache_shardings`` over each arch's ``abstract_cache``."""
    j, t = both
    for mname in MESHES:
        for b, w in CACHE:
            key = f"{mname}|{arch}|cache|{b}|{w}"
            assert t[key] == j[key], key


class _DuckMesh:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


def test_spec_for_axes_cases():
    """The reference's own unit cases: divisible, indivisible, no reuse."""
    rules = RULE_SETS["megatron_fsdp"]
    assert tuple(spec_for_axes(_DuckMesh(), ("embed", "ff"), (4096, 14336), rules)) == ("data", "model")
    assert tuple(spec_for_axes(_DuckMesh(), ("embed", "kv_heads_flat"), (2048, 24), rules)) == ("data", None)
    assert tuple(spec_for_axes(_DuckMesh(), ("ff", "experts"), (1536, 160), rules)).count("model") == 1


def test_placements_of_a_pod_spec():
    """A dimension sharded over ("pod", "data") takes both mesh axes; the
    rest replicate."""
    from torch.distributed.tensor import Replicate, Shard

    class Pod:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 16, 16)

    assert placements(Pod(), Spec(("pod", "data"), None)) == (Shard(0), Shard(0), Replicate())
    assert placements(Pod(), Spec(None, "model")) == (Replicate(), Replicate(), Shard(1))
