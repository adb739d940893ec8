"""The port's launch layer (``configs/shapes.py``, ``launch/specs.py``,
``launch/hlo_analysis.py``, ``launch/dryrun.py``, ``launch/report.py``,
``launch/tune.py``, the model-side ``param_axes`` trees) against the JAX
package's.

Shapes, input specs and axis trees compare exactly. The cost model counts
2·n³ FLOPs per product of a loop of products, and a reduced dense model's
train step (``remat="none"``) on a 1×1 mesh within 5 % of 6·N·D: the
embedding lookup (no FLOPs, 15 % of N here) and attention's S² products
are the two departures, and at S = 128 they nearly cancel. Dry runs go
through subprocesses (a process holds one default process group): a 1×1
fake mesh, and a fake 2×4 mesh whose artifact must carry exactly the
reference's keys, whose ``argument_bytes`` must equal the local shards'
bytes, and whose megatron-rules step must all-reduce (and an MoE step
all-to-all). ``report``'s tables render byte for byte as the reference's
from the same artifacts, and ``tune`` returns the reference's ``coral``
and ``oracle`` blocks from the same artifact, floats at rel 1e-12.
"""
import ast
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs.registry import REGISTRY as JAX_REGISTRY
from repro.configs.runtime import RunConfig as JaxRunConfig
from repro.configs.shapes import SHAPES as JAX_SHAPES
from repro.launch import hlo_analysis as jax_hlo
from repro.launch import report as jax_report
from repro.launch import tune as jax_tune
from repro.launch.specs import input_specs as jax_input_specs
from repro.models import transformer as jax_transformer
from repro_torch.configs import shapes
from repro_torch.configs.registry import REGISTRY
from repro_torch.configs.runtime import RunConfig
from repro_torch.launch import hlo_analysis, report, tune
from repro_torch.launch.specs import input_specs
from repro_torch.models import transformer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DTYPES = {"int32": torch.int32, "bfloat16": torch.bfloat16, "float32": torch.float32}


def _flat(tree, pre=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, pre + k + "/"))
        else:
            out[pre + k] = v
    return out


def test_shapes_are_the_references():
    assert {k: dataclasses.astuple(v) for k, v in shapes.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JAX_SHAPES.items()}
    from repro.configs.shapes import LONG_CONTEXT_WINDOW

    assert shapes.LONG_CONTEXT_WINDOW == LONG_CONTEXT_WINDOW


def test_run_config_defaults_are_the_references():
    for name in ("sharding_rules", "capacity_factor", "decode_tp_over_data", "moe_impl",
                 "long_context_window", "remat", "param_dtype", "compute_dtype"):
        assert getattr(RunConfig(), name) == getattr(JaxRunConfig(), name), name


@pytest.mark.parametrize("shape", sorted(shapes.SHAPES))
@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_input_specs_match(arch, shape):
    """Every input leaf's shape and dtype, meta tensors against
    ``ShapeDtypeStruct``s."""
    t = _flat(input_specs(REGISTRY[arch], shapes.SHAPES[shape]))
    j = _flat(jax_input_specs(JAX_REGISTRY[arch], JAX_SHAPES[shape]))
    assert sorted(t) == sorted(j)
    for k in j:
        assert tuple(t[k].shape) == tuple(j[k].shape), k
        assert t[k].device.type == "meta"
        assert t[k].dtype == JAX_DTYPES[str(j[k].dtype)], k


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_param_axes_trees_match(arch):
    cfg = REGISTRY[arch]
    assert _flat(transformer.model_param_axes(cfg)) == _flat(
        jax_transformer.model_param_axes(JAX_REGISTRY[arch]))
    abstract = _flat(transformer.abstract_model_params(cfg, RunConfig()))
    ref = _flat(jax_transformer.abstract_model_params(JAX_REGISTRY[arch], JaxRunConfig()))
    assert {k: tuple(v.shape) for k, v in abstract.items()} == {k: tuple(v.shape) for k, v in ref.items()}
    assert all(v.device.type == "meta" and v.dtype == torch.float32 for v in abstract.values())


def test_cost_model_loop_multiplication():
    """A Python loop of products: every trip is counted (2·n³ each)."""
    n, trips = 64, 7
    x = torch.randn(n, n)
    with hlo_analysis.CostModel() as cm:
        y = x
        for _ in range(trips):
            y = y @ x
    assert cm.costs.flops == 2 * n**3 * trips
    # each product reads two (n, n) operands and writes one
    assert cm.costs.bytes == trips * 3 * n * n * 4


def test_cost_model_peak_and_kinds():
    """The peak of live bytes (a freed tensor no longer counts), and the
    reference's collective kinds."""
    assert hlo_analysis.Costs().collectives.keys() == jax_hlo.Costs().collectives.keys()
    with hlo_analysis.CostModel() as cm:
        a = torch.empty(1024, device="meta")
        b = torch.empty(2048, device="meta")
        assert cm.live == (1024 + 2048) * 4
        del a
        c = b * 2
        v = c.view(2, 1024)  # a view allocates nothing
    assert cm.peak == cm.live == 2 * 2048 * 4
    assert v.shape == (2, 1024)


def test_roofline_fields_are_the_references():
    kw = dict(flops_per_chip=3e12, bytes_per_chip=2e9,
              collective_per_chip={k: 1e8 for k in hlo_analysis.Costs().collectives}, n_chips=256)
    assert hlo_analysis.Roofline(**kw).as_dict() == jax_hlo.Roofline(**kw).as_dict()


def _reference_record_keys():
    """The keys of the reference's dry-run artifact, read from its source
    (``run_pair``: the ``rec`` literal and its later assignments)."""
    src = open(os.path.join(ROOT, "src/repro/launch/dryrun.py")).read()
    keys, memory = set(), set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "rec" \
                and isinstance(node.value, ast.Dict):
            for k, v in zip(node.value.keys, node.value.values):
                keys.add(k.value)
                if k.value == "memory":
                    memory = {mk.value for mk in v.keys}
        if isinstance(node, ast.Subscript) and getattr(node.value, "id", None) == "rec" \
                and isinstance(node.ctx, ast.Store):
            keys.add(node.slice.value)
    return keys, memory


DRYRUN_SNIPPET = r"""
import json, sys
import torch
from repro_torch.configs.registry import REGISTRY
from repro_torch.configs.runtime import RunConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_fake_mesh
shape, out = json.loads(sys.argv[1]), sys.argv[2]
mesh = make_fake_mesh(shape)
recs = {}
train = InputShape("train_4k", 128, 4 * mesh.size(0), "train")
for rules in ("megatron_fsdp", "megatron"):
    step, args = dryrun.build_step(REGISTRY["qwen2.5-3b"].reduced(), train, mesh,
                                   RunConfig(sharding_rules=rules, remat="none"))
    local = [t.to_local() if hasattr(t, "to_local") else t
             for t in torch.utils._pytree.tree_flatten(args)[0] if isinstance(t, torch.Tensor)]
    local = sum(t.numel() * t.element_size() for t in local)
    costs, memory, s = dryrun.count_step(step, args)
    rec = dryrun.record(REGISTRY["qwen2.5-3b"].reduced(), train, mesh, RunConfig(sharding_rules=rules),
                        costs, memory, s)
    rec["local_argument_bytes"] = local
    recs[rules] = rec
decode = InputShape("decode_32k", 64, 2 * mesh.size(0), "decode")
recs["moe"] = dryrun.run_on_mesh(REGISTRY["deepseek-v2-236b"].reduced(), decode, mesh, RunConfig(), out)
from repro_torch.launch.hlo_analysis import collective_bytes
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from torch.distributed import _functional_collectives as fc
x = torch.empty(1024, device="meta")
recs["collective_bytes"] = collective_bytes(
    lambda: fc.wait_tensor(fc.all_reduce(x, "sum", mesh.get_group("model"))))
recs["host_mesh"] = list(make_host_mesh(shape[1], device="cpu").shape)
try:
    make_production_mesh()
    recs["production_refused"] = False
except RuntimeError:
    recs["production_refused"] = True
json.dump(recs, open(out + "/recs.json", "w"))
print("DRY_OK")
"""


def _dry(tmp, shape):
    env = {"PYTHONPATH": os.path.join(ROOT, "src"), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, "-c", DRYRUN_SNIPPET, json.dumps(shape), tmp],
                       capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(os.path.join(tmp, "recs.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def dry_2x4(tmp_path_factory):
    return _dry(str(tmp_path_factory.mktemp("dry24")), [2, 4])


@pytest.fixture(scope="module")
def dry_1x1(tmp_path_factory):
    return _dry(str(tmp_path_factory.mktemp("dry11")), [1, 1])


def test_meshes_over_an_existing_group(dry_2x4):
    """``make_host_mesh`` spans the group that exists; the production mesh
    refuses a group of another size; ``collective_bytes`` counts an
    all-reduce's operand."""
    assert dry_2x4["host_mesh"] == [2, 4]
    assert dry_2x4["production_refused"] is True
    assert dry_2x4["collective_bytes"] == dict(hlo_analysis.Costs().collectives,
                                               **{"all-reduce": 4096.0})


def test_dryrun_artifact_keys(dry_2x4):
    keys, memory = _reference_record_keys()
    for name in ("megatron_fsdp", "megatron", "moe"):
        rec = dry_2x4[name]
        rec = dict(rec)
        rec.pop("local_argument_bytes", None)
        assert set(rec) == keys
        assert set(rec["memory"]) == memory
        assert set(rec["roofline"]) == set(jax_hlo.Roofline(0, 0, {}, 1).as_dict())
        assert rec["mesh"] == "2x4" and rec["n_chips"] == 8


def test_memoized_calls_count_as_run():
    """A memoized call's replay adds what running it adds: FLOPs, bytes
    and the peak over what is live, and returns its output's shape."""
    from repro_torch.models.attention import attention

    q = torch.empty(2, 2048, 4, 64, device="meta", dtype=torch.bfloat16)
    k = torch.empty(2, 2048, 2, 64, device="meta", dtype=torch.bfloat16)
    pos = torch.empty(2, 2048, device="meta", dtype=torch.int32)

    def run(memo):
        with hlo_analysis.CostModel() as cm:
            outs = []
            for _ in range(3):
                fn = (lambda *a: hlo_analysis.memoized("attn", lambda *b: attention(*b), *a)) \
                    if memo else (lambda *a: attention(*a))
                outs.append(fn(q, k, k, pos, pos))
        return cm, outs

    (a, oa), (b, ob) = run(True), run(False)
    assert (a.costs.flops, a.costs.bytes, a.peak) == (b.costs.flops, b.costs.bytes, b.peak)
    assert a.costs.flops > 0 and len(a.memo) == 1
    assert [o.shape for o in oa] == [o.shape for o in ob]


def test_dryrun_counts_on_a_2x4_mesh(dry_2x4):
    """Arguments are exactly the local shards; megatron rules all-reduce,
    fsdp gathers the weights and reduce-scatters their gradients, and the
    expert-parallel MoE exchanges tokens all-to-all."""
    for rules in ("megatron_fsdp", "megatron"):
        rec = dry_2x4[rules]
        assert rec["memory"]["argument_bytes"] == rec["local_argument_bytes"]
        assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"] > 0
        assert rec["roofline"]["collective_per_chip"]["all-reduce"] > 0
    assert dry_2x4["megatron_fsdp"]["roofline"]["collective_per_chip"]["reduce-scatter"] > 0
    assert dry_2x4["megatron_fsdp"]["memory"]["argument_bytes"] < \
        dry_2x4["megatron"]["memory"]["argument_bytes"]
    assert dry_2x4["moe"]["roofline"]["collective_per_chip"]["all-to-all"] > 0


def test_dryrun_train_flops_on_one_device(dry_1x1):
    """On a 1×1 mesh the counted FLOPs of a reduced dense model's train
    step are 6·N·D within 5 % (module note), and nothing is communicated."""
    rec = dry_1x1["megatron"]
    ratio = rec["roofline"]["flops_per_chip"] / rec["model_flops"]
    assert abs(ratio - 1.0) < 0.05, ratio
    assert sum(rec["roofline"]["collective_per_chip"].values()) == 0
    assert rec["memory"]["argument_bytes"] == rec["local_argument_bytes"]


def test_dryrun_refuses_the_kernels():
    with pytest.raises(ValueError, match="plain paths"):
        from repro_torch.launch import dryrun

        dryrun.build_step(REGISTRY["qwen2.5-3b"].reduced(), shapes.SHAPES["decode_32k"], None,
                          RunConfig(use_kernels=True))


def _artifacts(tmp):
    """Two artifacts per mesh, with the numbers of a dry run's record."""
    rng = np.random.default_rng(0)
    recs = []
    for mesh, n in (("16x16", 256), ("2x16x16", 512)):
        for arch, shape in (("qwen2.5-3b", "decode_32k"), ("mamba2-2.7b", "train_4k")):
            coll = {k: float(rng.uniform(0, 4e9)) for k in jax_hlo._COLLECTIVES}
            roof = jax_hlo.Roofline(float(rng.uniform(1e12, 1e15)), float(rng.uniform(1e9, 1e12)),
                                    coll, n)
            rec = {"arch": arch, "shape": shape, "mesh": mesh, "n_chips": n, "compile_seconds": 3.4,
                   "sharding_rules": "megatron_fsdp",
                   "memory": {"argument_bytes": 1, "output_bytes": 2, "temp_bytes": 3,
                              "peak_bytes": int(rng.integers(1 << 30, 1 << 36))},
                   "roofline": roof.as_dict()}
            with open(os.path.join(tmp, f"{arch}__{shape}__{mesh}.json"), "w") as f:
                json.dump(rec, f)
            recs.append(rec)
    return recs


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_report_tables_match(tmp_path, mesh):
    _artifacts(str(tmp_path))
    t, j = report.load(str(tmp_path), mesh), jax_report.load(str(tmp_path), mesh)
    assert t == j and len(t) == 2
    assert report.roofline_table(t) == jax_report.roofline_table(j)
    assert report.dryrun_table(t) == jax_report.dryrun_table(j)


def _close(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, float):
        assert a == pytest.approx(b, rel=1e-12, abs=0), (a, b)
    else:
        assert a == b, (a, b)


@pytest.mark.parametrize("arch,shape", [("qwen2.5-3b", "decode_32k"), ("mamba2-2.7b", "train_4k")])
def test_tune_matches_the_reference(tmp_path, arch, shape):
    _artifacts(str(tmp_path))
    t = tune.tune(arch, shape, dryrun_dir=str(tmp_path), verbose=False, device="cpu")
    j = jax_tune.tune(arch, shape, dryrun_dir=str(tmp_path), verbose=False)
    _close(t["coral"], j["coral"])
    _close(t["oracle"], j["oracle"])
    _close(t["tau_target"], j["tau_target"])
    _close(t["p_budget_kw"], j["p_budget_kw"])


def test_tune_without_an_artifact(tmp_path):
    with pytest.raises(FileNotFoundError, match="dryrun"):
        tune.tune("qwen2.5-3b", "decode_32k", dryrun_dir=str(tmp_path), verbose=False, device="cpu")
