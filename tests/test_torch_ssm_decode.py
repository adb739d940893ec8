"""Mamba2's decode state step (``kernels/ssm_decode``) on the CPU: its
plain version against the model's step as it was written before the
kernel (the lines below, ``_step_as_written``), the wrapper's checks, the
(hd, N) it is compiled for, and the model's cached decode with kernels on
and off, on one device and on DTensors over a 2×2 (data, model) mesh of
4 CPU ranks over ``gloo`` (in a subprocess). The kernel itself runs only
on the card (``tests/test_torch_kernels_gpu.py``).

Everything here is held bit for bit: the paths compute the same float32
operations in the same order, and round to bf16 at the same places. The
plain version writes the product dt·x·B as (B·dt)·x, the grouping of
``torch.einsum`` left to right, which the step as written is held to by
running its einsum without ``opt_einsum`` (with it, the einsum groups by
the shapes' sizes: (dt·x)·B at Mamba2-2.7B's N = 128, a float32 rounding
apart). The one exception is the one-device comparison of the mesh test,
where the prefill itself, on DTensors, sums in another order: logits
within 1e-3, as ``test_torch_mesh_model.py`` holds them.
"""
import json
import os
import socket
import subprocess
import sys

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs.registry import REGISTRY
from repro_torch.configs.runtime import RunConfig
from repro_torch.kernels import runtime
from repro_torch.kernels.ssm_decode import WIDTHS, ssm_decode, ssm_decode_ref, ssm_step_ref
from repro_torch.models import ssm
from repro_torch.models.transformer import ApplyCtx, decode_step, init_model_params, prefill

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SSM_ARCHS = sorted(name for name, cfg in REGISTRY.items() if cfg.ssm is not None)
MESH_DECODE_TOL = 1e-3


@pytest.fixture
def einsum_left_to_right(monkeypatch):
    """``torch.einsum`` without ``opt_einsum``: its operands multiplied
    left to right, the plain version's grouping of dt·x·B."""
    monkeypatch.setattr(torch.backends.opt_einsum, "enabled", False)


def _step_as_written(cfg, p, x, ssm_state, conv_state):
    """``ssm.mamba2_decode`` as the port wrote it before the kernel: its
    projection, convolution and state step, returning (y (B,nh,hd) before
    the gate, the new float32 state, the new conv state)."""
    s = cfg.ssm
    proj = x @ p["in_proj"].to(x.dtype)
    z, _, _, _, dt, di, nh = ssm._split_proj(cfg, proj)
    window = torch.cat([conv_state, ssm._xbc(cfg, proj)], dim=1)
    new_conv = window[:, 1:]
    conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"].to(x.dtype)) + p["conv_b"].to(x.dtype)
    xbc = F.silu(conv_out)[:, None, :]
    xi, Bm, Cm = xbc.split([di, s.d_state, s.d_state], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"].float())
    xh = xi.reshape(x.shape[0], nh, s.headdim)
    dt1 = dt[:, 0]
    dA = torch.exp(dt1 * A[None, :])
    dBx = torch.einsum("bn,bh,bhp->bhpn", Bm[:, 0].float(), dt1, xh.float())
    new_state = ssm_state * dA[:, :, None, None] + dBx
    y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].float(), new_state)
    y = y.to(x.dtype) + xh * p["D"].to(x.dtype)[None, :, None]
    return y, new_state, new_conv


def _layer(arch, dtype, b=3, seed=0, full_width=False):
    """One layer's parameters (A_log, dt_bias and D drawn per head), a
    normed input, and a bf16 cache of (state, conv state)."""
    cfg = REGISTRY[arch] if full_width else REGISTRY[arch].reduced()
    g = torch.Generator().manual_seed(seed)
    specs = ssm.ssm_param_specs(cfg, 1)
    p = {k: torch.randn(tuple(v.shape)[1:], generator=g) * 0.05 for k, v in specs.items()}
    nh = cfg.ssm.n_ssm_heads(cfg.d_model)
    p["A_log"] = torch.log(1 + 15 * torch.rand(nh, generator=g))
    p["dt_bias"] = -1 - 3 * torch.rand(nh, generator=g)
    p["D"] = 1 + torch.rand(nh, generator=g)
    p["norm_w"] = 1 + 0.1 * torch.randn(p["norm_w"].shape, generator=g)
    p = {k: v.to(dtype) if k in ("in_proj", "conv_w", "conv_b", "out_proj") else v
         for k, v in p.items()}
    x = torch.randn(b, 1, cfg.d_model, generator=g).to(dtype)
    conv_dim = cfg.ssm.inner(cfg.d_model) + 2 * cfg.ssm.d_state
    cache = {"ssm": torch.randn(b, nh, cfg.ssm.headdim, cfg.ssm.d_state, generator=g)
             .to(torch.bfloat16),
             "conv": torch.randn(b, cfg.ssm.d_conv - 1, conv_dim, generator=g).to(torch.bfloat16)}
    return cfg, p, x, cache


CASES = [(arch, dtype, False) for arch in SSM_ARCHS for dtype in (torch.float32, torch.bfloat16)]
CASES += [("mamba2-2.7b", torch.bfloat16, True), ("hymba-1.5b", torch.bfloat16, True)]


@pytest.mark.parametrize("arch,dtype,full_width", CASES)
def test_plain_step_is_the_step_as_written(einsum_left_to_right, arch, dtype, full_width):
    """The plain version, in place on the bf16 cache, gives the state the
    step as written gave (widened, stepped, ``copy_`` back) and its y, bit
    for bit; so does ``mamba2_decode`` on a float32 cache, kernels off."""
    cfg, p, x, cache = _layer(arch, dtype, b=2 if full_width else 3, full_width=full_width)
    conv = cache["conv"].to(dtype)
    want_y, want_state, want_conv = _step_as_written(cfg, p, x, cache["ssm"].float(), conv)
    want_cache = cache["ssm"].clone().copy_(want_state)

    z, xh, dt, Bm, Cm, new_conv = ssm._decode_in(cfg, p, x, conv)
    state = cache["ssm"].clone()
    y = ssm_decode_ref(state, *ssm._step_args(p, xh, dt, Bm, Cm))
    assert torch.equal(y, want_y) and y.dtype == dtype
    assert torch.equal(state, want_cache)
    assert torch.equal(new_conv, want_conv)

    y32, new32 = ssm_step_ref(cache["ssm"].float(), *ssm._step_args(p, xh, dt, Bm, Cm))
    assert torch.equal(y32, want_y) and torch.equal(new32, want_state)
    c32 = {"ssm": cache["ssm"].float(), "conv": conv.clone()}
    out = ssm.mamba2_decode(cfg, p, x, c32, RunConfig(use_kernels=False))
    assert torch.equal(c32["ssm"], want_state) and torch.equal(c32["conv"], want_conv)
    assert torch.equal(out, ssm._decode_out(cfg, p, x, want_y, z))


@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cached_decode_with_and_without_kernels(einsum_left_to_right, arch, dtype):
    """On CPU tensors the cached step takes the same plain lines with
    kernels on (through the wrapper) and off, and both equal the step as
    written with its ``copy_`` into the cache; nothing launches."""
    cfg, p, x, cache = _layer(arch, dtype)
    want_y, want_state, want_conv = _step_as_written(cfg, p, x, cache["ssm"].float(),
                                                     cache["conv"].to(dtype))
    runtime.reset_launch_counts()
    got = {}
    for kernels in (True, False):
        c = {k: v.clone() for k, v in cache.items()}
        out = ssm.mamba2_decode(cfg, p, x, c, RunConfig(use_kernels=kernels))
        got[kernels] = (out, c)
    assert runtime.launch_counts()["ssm_decode"] == 0
    (out_k, c_k), (out_p, c_p) = got[True], got[False]
    assert torch.equal(out_k, out_p)
    for name in ("ssm", "conv"):
        assert torch.equal(c_k[name], c_p[name]) and c_k[name].dtype == torch.bfloat16
    assert torch.equal(c_k["ssm"], cache["ssm"].clone().copy_(want_state))
    assert torch.equal(c_k["conv"], want_conv.to(torch.bfloat16))


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_decode_steps_with_and_without_kernels(arch):
    """Whole reduced models on the CPU: a prefill, then four decode steps
    with kernels on and four with kernels off, from one cache: logits and
    caches bitwise equal."""
    cfg = REGISTRY[arch].reduced()
    rcfg = RunConfig(compute_dtype="bfloat16")
    params = init_model_params(cfg, rcfg, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab, (2, 12), generator=g, dtype=torch.int32)
    feeds = torch.randint(0, cfg.vocab, (4, 2, 1), generator=g, dtype=torch.int32)
    cache, _ = prefill(ApplyCtx(cfg, rcfg), params, {"tokens": tok}, capacity=16)
    out = {}
    for kernels in (True, False):
        ctx = ApplyCtx(cfg, RunConfig(compute_dtype="bfloat16", use_kernels=kernels))
        c = {k: {n: t.clone() for n, t in v.items()} if isinstance(v, dict) else v.clone()
             for k, v in cache.items()}
        logits = []
        for f in feeds:
            c, lg = decode_step(ctx, params, c, f)
            logits.append(lg)
        out[kernels] = (logits, c)
    for a, b in zip(out[True][0], out[False][0]):
        assert torch.equal(a, b)
    for name, t in out[True][1]["main"].items():
        assert torch.equal(t, out[False][1]["main"][name]), name


@pytest.mark.parametrize("hd,n", WIDTHS)
@pytest.mark.parametrize("b", [1, 2, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_product_is_the_einsums_left_to_right(einsum_left_to_right, hd, n, b, dtype):
    """The plain version's new state, at every compiled (hd, N), is the
    step as written with its einsum taken left to right, bit for bit: the
    one grouping of dt·x·B, (B·dt)·x, that the kernel follows."""
    nh = 80 if n == 128 else 50
    g = torch.Generator().manual_seed(b)
    state = torch.randn(b, nh, hd, n, generator=g)
    x, bm, cm = (torch.randn(*shape, generator=g).to(dtype) for shape in
                 ((b, nh, hd), (b, n), (b, n)))
    dt_raw = torch.randn(b, nh, generator=g).to(dtype)
    dt_bias = -1 - 3 * torch.rand(nh, generator=g)
    a_log, d = torch.rand(nh, generator=g), torch.rand(nh, generator=g)
    dt = F.softplus(dt_raw.float() + dt_bias[None, :])
    dA = torch.exp(dt * -torch.exp(a_log)[None, :])
    want = state * dA[:, :, None, None] + torch.einsum("bn,bh,bhp->bhpn", bm.float(), dt,
                                                       x.float())
    _, got = ssm_step_ref(state, x, dt_raw, dt_bias, a_log, bm, cm, d)
    assert torch.equal(got, want)


def _args(b=2, nh=4, hd=64, n=16, dtype=torch.float32, device="cpu"):
    g = torch.Generator().manual_seed(0)
    state = torch.randn(b, nh, hd, n, generator=g).to(torch.bfloat16)
    x, dt = torch.randn(b, nh, hd, generator=g), torch.randn(b, nh, generator=g)
    bm, cm = torch.randn(b, n, generator=g), torch.randn(b, n, generator=g)
    heads = [torch.randn(nh, generator=g) for _ in range(3)]
    args = [state, x.to(dtype), dt.to(dtype), heads[0], heads[1], bm.to(dtype), cm.to(dtype),
            heads[2]]
    return [a.to(device) for a in args]


def test_wrapper_takes_the_plain_version_on_the_cpu():
    args = _args()
    want_state = args[0].clone()
    want = ssm_decode_ref(want_state, *args[1:])
    assert torch.equal(ssm_decode(*args), want) and torch.equal(args[0], want_state)


@pytest.mark.parametrize("case", ["mixed_device", "width", "strided_state", "state_dtype",
                                  "dtypes", "shape", "grad"])
def test_wrapper_raises(case):
    args = _args()
    err, match = ValueError, None
    if case == "mixed_device":
        args[1] = args[1].to("meta")
        match = "all lie on the CPU"
    elif case == "width":
        args = _args(hd=32, n=128)
        match = r"compiled for \(hd, N\)"
    elif case == "strided_state":
        args[0] = torch.zeros(2, 4, 16, 64, dtype=torch.bfloat16).transpose(2, 3)
        match = "contiguous"
    elif case == "state_dtype":
        args[0], err, match = args[0].float(), TypeError, "bf16 cache"
    elif case == "dtypes":
        args[5], err, match = args[5].to(torch.bfloat16), TypeError, "one dtype"
    elif case == "shape":
        args[6] = args[6][:, :8]
        match = "shape mismatch"
    else:
        args[1], err, match = args[1].clone().requires_grad_(True), RuntimeError, "no backward"
    state = args[0].clone() if args[0].is_contiguous() else args[0]
    with pytest.raises(err, match=match):
        ssm_decode(*args)
    assert torch.equal(args[0], state)  # nothing written before the raise
    if case == "grad":
        with torch.no_grad():
            ssm_decode(*args)


@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_every_ssm_configuration_has_an_instantiated_width(arch, reduced):
    """The kernel is compiled for each registry SSM's (hd, N), reduced too."""
    cfg = REGISTRY[arch].reduced() if reduced else REGISTRY[arch]
    assert (cfg.ssm.headdim, cfg.ssm.d_state) in WIDTHS


MESH_SNIPPET = r"""
import json, sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run(rank, port, out, archs):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=4)
    torch.set_num_threads(1)
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs.registry import REGISTRY
    from repro_torch.configs.runtime import RunConfig
    from repro_torch.models.transformer import (ApplyCtx, decode_step, init_model_params,
                                                param_specs, prefill)
    from repro_torch.sharding.specs import Spec, distribute, distribute_tree, param_shardings

    mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
    res = {}
    for arch in archs:
        cfg = REGISTRY[arch].reduced()
        rcfg = RunConfig(compute_dtype="float32")
        params = init_model_params(cfg, rcfg, torch.Generator().manual_seed(0))
        g = torch.Generator().manual_seed(1)
        tok = torch.randint(0, cfg.vocab, (4, 12), generator=g, dtype=torch.int32)
        nxt = torch.randint(0, cfg.vocab, (4, 1), generator=g, dtype=torch.int32)
        one = ApplyCtx(cfg, rcfg)
        cache, _ = prefill(one, params, {"tokens": tok}, capacity=16)
        _, want = decode_step(one, params, cache, nxt)
        sharded = distribute_tree(mesh, params, param_shardings(mesh, param_specs(cfg),
                                                                rcfg.sharding_rules))
        got = {}
        with implicit_replication():
            cache, _ = prefill(ApplyCtx(cfg, rcfg, mesh), sharded,
                               {"tokens": distribute(mesh, tok, Spec("data", None))}, capacity=16)
            for kernels in (True, False):
                ctx = ApplyCtx(cfg, RunConfig(compute_dtype="float32", use_kernels=kernels), mesh)
                c = {k: {n: t.clone() for n, t in v.items()} if isinstance(v, dict) else v
                     for k, v in cache.items()}
                _, lg = decode_step(ctx, sharded, c, distribute(mesh, nxt, Spec("data", None)))
                got[kernels] = (lg.full_tensor(), c["main"]["ssm"].full_tensor(),
                                str(c["main"]["ssm"].placements))
        (lk, sk, pk), (lp, sp, _) = got[True], got[False]
        res[arch] = {"logits_equal": bool(torch.equal(lk, lp)),
                     "state_equal": bool(torch.equal(sk, sp)),
                     "stepped": bool(not torch.equal(sk, cache["main"]["ssm"].full_tensor())),
                     "one_device": float((lk - want).abs().max()), "placements": pk}
    if rank == 0:
        json.dump(res, open(out, "w"))
    dist.destroy_process_group()


if __name__ == "__main__":
    port, out = int(sys.argv[1]), sys.argv[2]
    mp.spawn(run, args=(port, out, sys.argv[3:]), nprocs=4)
"""


@pytest.fixture(scope="module")
def mesh_results(tmp_path_factory):
    d = tmp_path_factory.mktemp("ssm_decode_mesh")
    script, out = d / "run.py", d / "out.json"
    script.write_text(MESH_SNIPPET)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {"PYTHONPATH": os.path.join(ROOT, "src"), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, str(script), str(port), str(out), *SSM_ARCHS],
                       capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_sharded_decode_steps_each_ranks_shard(mesh_results, arch):
    """On DTensors (rows over ``data``, heads over ``model``) the kernel
    path steps each rank's shard of the cache in place: its logits and
    state equal the plain DTensor path's bit for bit, and the one-device
    step's within the mesh test's bound."""
    r = mesh_results[arch]
    assert r["logits_equal"] and r["state_equal"] and r["stepped"], r
    assert "Shard(dim=1)" in r["placements"] and "Shard(dim=2)" in r["placements"], r
    assert r["one_device"] < MESH_DECODE_TOL, r
