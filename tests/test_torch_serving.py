"""The port's serving slice on reduced Qwen2.5-3B (and reduced Mamba2-2.7B,
Moonlight-16B-A3B and DeepSeek-V2-236B where named) against the JAX package, with the JAX model's weights carried over by ``params_from_jax``
so both run on the same numbers.

Tolerances. Float32 compute: rtol/atol 1e-4 — only summation order
differs, while the KV cache is bf16 in both, so K/V that round alike stay
alike. Bfloat16 compute: atol 0.1 on logits of magnitude ~1-3, i.e. a
few bf16 ulps (2^-8 relative) compounded over two layers and the head
where XLA and PyTorch round intermediate products at different places.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import REGISTRY as JAX_REGISTRY
from repro.configs.runtime import RunConfig as JaxRunConfig
from repro.models import ApplyCtx as JaxCtx
from repro.models import decode_step as jax_decode
from repro.models import init_model_params as jax_init
from repro.models import prefill as jax_prefill
from repro.serving import ServingEngine as JaxEngine
from repro.serving import workload as jax_workload
from repro_torch.configs.registry import REGISTRY
from repro_torch.configs.runtime import RunConfig
from repro_torch.launch.serve import serve
from repro_torch.models import ApplyCtx, decode_step, prefill
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import Request, ServingEngine, ServingRuntime, workload

ARCH = "qwen2.5-3b"
MAMBA = "mamba2-2.7b"
VOCAB = 512  # reduced() clamps the vocab of both to this


@pytest.fixture(scope="module")
def jax_params():
    cfg = JAX_REGISTRY[ARCH].reduced()
    params = jax_init(jax.random.PRNGKey(0), cfg, JaxRunConfig())
    return jax.tree.map(np.asarray, params)


def _ctxs(compute_dtype, kernels):
    jctx = JaxCtx(JAX_REGISTRY[ARCH].reduced(),
                  JaxRunConfig(remat="none", moe_impl="dense",
                               compute_dtype=compute_dtype, use_pallas=kernels))
    tctx = ApplyCtx(REGISTRY[ARCH].reduced(),
                    RunConfig(compute_dtype=compute_dtype, use_kernels=kernels))
    return jctx, tctx


def _run_both(jax_params, compute_dtype, kernels, n_steps, b=2, s=12, cap=24):
    """Prefill + ``n_steps`` decodes fed the same numpy-drawn tokens in both
    packages; returns the list of (jax logits, port logits) per step and
    the two prefill caches."""
    jctx, tctx = _ctxs(compute_dtype, kernels)
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, VOCAB, (b, s), dtype=np.int32)
    feeds = rng.integers(0, VOCAB, (n_steps, b, 1), dtype=np.int32)
    jp = jax.jit(functools.partial(jax_prefill, jctx, capacity=cap))
    jd = jax.jit(functools.partial(jax_decode, jctx))
    params = params_from_jax(jax_params, "cpu")
    jcache, jlog = jp(jax_params, {"tokens": prompt})
    with torch.inference_mode():
        tcache, tlog = prefill(tctx, params, {"tokens": torch.from_numpy(prompt)},
                               capacity=cap)
    caches = (jax.tree.map(np.asarray, jcache), tcache)
    pairs = [(np.asarray(jlog, np.float32), tlog.float().numpy())]
    for tok in feeds:
        jcache, jlog = jd(jax_params, jcache, tok)
        with torch.inference_mode():
            tcache, tlog = decode_step(tctx, params, tcache, torch.from_numpy(tok))
        pairs.append((np.asarray(jlog, np.float32), tlog.float().numpy()))
    return pairs, caches


@pytest.mark.parametrize("kernels", [False, True])
def test_prefill_and_decode_match_jax_fp32(jax_params, kernels):
    pairs, (jcache, tcache) = _run_both(jax_params, "float32", kernels, n_steps=5)
    assert tcache["length"] == int(jcache["length"]) == 12
    for name in ("k", "v"):  # bf16 cache in both, zero-padded to capacity
        assert tcache["main"][name].dtype == torch.bfloat16
        assert tcache["main"][name].shape == jcache["main"][name].shape
    for ref, out in pairs:
        assert out.shape == ref.shape == (2, 1, VOCAB)
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_prefill_and_decode_match_jax_bf16(jax_params):
    pairs, _ = _run_both(jax_params, "bfloat16", True, n_steps=3)
    for ref, out in pairs:
        assert np.isfinite(out).all()
        np.testing.assert_allclose(out, ref, atol=0.1)


def test_greedy_generation_matches_jax_engine(jax_params):
    """Float32 compute, so no near-tie of two logits can flip an argmax."""
    jctx, tctx = _ctxs("float32", False)
    prompt = np.random.default_rng(9).integers(0, VOCAB, (2, 8), dtype=np.int32)
    ref = JaxEngine(jctx, jax_params, batch_size=2, max_len=64).generate(prompt, 6)
    eng = ServingEngine(tctx, params_from_jax(jax_params, "cpu"), 2, 64)
    out = eng.generate(prompt, 6)
    assert out.dtype == np.int32 and out.shape == (2, 6)
    np.testing.assert_array_equal(out, np.asarray(ref))
    np.testing.assert_array_equal(eng.generate(prompt, 6), out)  # deterministic


def test_sampled_generation_is_seeded(jax_params):
    _, tctx = _ctxs("float32", False)
    eng = ServingEngine(tctx, params_from_jax(jax_params, "cpu"), 2, 64)
    prompt = np.zeros((2, 4), np.int32)
    a = eng.generate(prompt, 5, temperature=1.0, seed=3)
    np.testing.assert_array_equal(a, eng.generate(prompt, 5, temperature=1.0, seed=3))
    assert a.min() >= 0 and a.max() < VOCAB


def _mamba_np_params():
    """Reduced Mamba2 parameters as numpy, with A_log, dt_bias and norm_w
    drawn so that none of them is exact in bf16 (the JAX initialiser sets
    them to 1, 0 and 1, which a bf16 round trip would not change)."""
    cfg = JAX_REGISTRY[MAMBA].reduced()
    params = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(1), cfg, JaxRunConfig()))
    sp = params["layers"]["ssm"]
    rng = np.random.default_rng(1)
    sp["A_log"] = np.log(rng.uniform(1, 16, sp["A_log"].shape)).astype(np.float32)
    sp["dt_bias"] = rng.uniform(-4, -1, sp["dt_bias"].shape).astype(np.float32)
    sp["norm_w"] = rng.uniform(0.5, 1.5, sp["norm_w"].shape).astype(np.float32)
    return params


@pytest.mark.parametrize("arch", [ARCH, MAMBA])
def test_weights_cast_once_are_bit_identical(jax_params, arch):
    """The engine's load-time cast changes no bit against casting at use.
    For Mamba2 that holds only if A_log, dt_bias and norm_w stay float32."""
    np_params = jax_params if arch == ARCH else _mamba_np_params()
    tctx = ApplyCtx(REGISTRY[arch].reduced(),
                    RunConfig(compute_dtype="bfloat16", use_kernels=True))
    params = params_from_jax(np_params, "cpu")
    eng = ServingEngine(tctx, params, 2, 16)
    lp = eng.params["layers"]
    if arch == ARCH:
        assert lp["attn"]["wq"].dtype == torch.bfloat16
    else:
        assert lp["ssm"]["in_proj"].dtype == lp["ssm"]["D"].dtype == torch.bfloat16
        for name in ("A_log", "dt_bias", "norm_w"):
            assert lp["ssm"][name].dtype == torch.float32
    assert lp["ln1"].dtype == torch.float32
    prompt = np.arange(16, dtype=np.int32).reshape(2, 8)
    _, logits = eng.prefill(prompt)
    with torch.inference_mode():
        _, at_use = prefill(tctx, params, {"tokens": torch.from_numpy(prompt)},
                            capacity=16)
    assert torch.equal(logits, at_use)


def test_mamba2_greedy_generation_matches_jax_engine():
    """Reduced Mamba2, float32 compute, so no near-tie of two logits can
    flip an argmax: the tokens are identical."""
    np_params = _mamba_np_params()
    jctx = JaxCtx(JAX_REGISTRY[MAMBA].reduced(),
                  JaxRunConfig(remat="none", moe_impl="dense", compute_dtype="float32",
                               use_pallas=True))
    tctx = ApplyCtx(REGISTRY[MAMBA].reduced(),
                    RunConfig(compute_dtype="float32", use_kernels=True))
    prompt = np.random.default_rng(9).integers(0, VOCAB, (2, 11), dtype=np.int32)
    ref = JaxEngine(jctx, np_params, batch_size=2, max_len=64).generate(prompt, 6)
    out = ServingEngine(tctx, params_from_jax(np_params, "cpu"), 2, 64).generate(prompt, 6)
    assert out.dtype == np.int32 and out.shape == (2, 6)
    np.testing.assert_array_equal(out, np.asarray(ref))


@pytest.fixture(scope="module")
def engine(jax_params):
    _, tctx = _ctxs("bfloat16", True)
    return ServingEngine(tctx, params_from_jax(jax_params, "cpu"), 2, 64)


def test_runtime_drain_metrics(engine):
    rt = ServingRuntime(engine, batch_size=2, concurrency=2)
    rng = np.random.default_rng(0)
    for rid in range(4):
        rt.submit(Request(rid, rng.integers(0, VOCAB, 8, dtype=np.int32), 4))
    m = rt.drain()
    assert m["requests"] == 4 and m["queue_depth"] == 0
    assert m["throughput_tok_s"] > 0
    assert m["p99_latency_s"] >= m["p50_latency_s"]
    assert all(r.output.size == 4 for r in rt.done)


def test_runtime_partial_groups_and_equal_length_grouping(engine):
    rng = np.random.default_rng(1)
    long_prompt = rng.integers(0, VOCAB, 12, dtype=np.int32)
    solo = ServingRuntime(engine, concurrency=1)
    solo.submit(Request(0, long_prompt.copy(), 4))
    solo.drain()
    rt = ServingRuntime(engine, concurrency=2)
    rt.submit(Request(1, rng.integers(0, VOCAB, 8, dtype=np.int32), 3))
    rt.submit(Request(2, long_prompt.copy(), 4))  # behind a shorter prompt
    rt.submit(Request(3, rng.integers(0, VOCAB, 8, dtype=np.int32), 3))
    m = rt.drain()
    assert m["requests"] == 3
    got = next(r for r in rt.done if r.rid == 2).output
    np.testing.assert_array_equal(got, solo.done[0].output)


def test_runtime_tenants_and_power_attribution(engine):
    rt = ServingRuntime(engine, batch_size=2, concurrency=1)
    rt.add_tenant("b", slots=2)
    rng = np.random.default_rng(2)
    for rid in range(4):
        rt.submit(Request(rid, rng.integers(0, VOCAB, 8, dtype=np.int32), 3))
        rt.submit(Request(10 + rid, rng.integers(0, VOCAB, 8, dtype=np.int32), 3),
                  tenant="b")
    rt.set_slot_allocation({"default": 2, "b": 1})
    rt.drain()
    per = rt.tenant_metrics(window_s=60.0)
    assert per["default"]["requests"] == per["b"]["requests"] == 4
    shares = rt.attribute_power(30.0, window_s=60.0)
    assert sum(shares.values()) == 30.0


def test_measure_throughput_probe(engine):
    from repro_torch.serving import measure_concurrency_curve

    best, used = measure_concurrency_curve(
        engine, [1, 2], rounds=1, min_rounds=1, prompt_len=8, new_tokens=2,
        groups=2, vocab=VOCAB,
    )
    assert used == 1 and set(best) == {1, 2} and min(best.values()) > 0


def test_serve_reduced_on_cpu():
    m = serve(ARCH, requests=3, prompt_len=8, new_tokens=3, batch=2,
              concurrency=2, reduced=True, device="cpu")
    assert m["requests"] == 3 and m["throughput_tok_s"] > 0


def test_serve_mamba2_reduced_on_cpu():
    m = serve(MAMBA, requests=3, prompt_len=8, new_tokens=3, batch=2,
              concurrency=2, reduced=True, device="cpu")
    assert m["requests"] == 3 and m["throughput_tok_s"] > 0


MOE_MLA = ["moonshot-v1-16b-a3b", "deepseek-v2-236b"]


@pytest.mark.parametrize("arch", MOE_MLA)
def test_moe_and_mla_weights_cast_once_keep_what_is_read_in_float32(arch):
    """The engine casts the experts, the shared experts and MLA's
    projections to bf16 at load, and keeps the router (float32 routing
    logits), MLA's q_norm and kv_norm and the layer norms float32, so its
    prefill equals the model's on float32 weights cast at use, bit for
    bit. The norms are drawn, so that a bf16 round trip would show."""
    cfg = JAX_REGISTRY[arch].reduced()
    np_params = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(2), cfg, JaxRunConfig()))
    rng = np.random.default_rng(2)

    def drawn(w):
        return rng.uniform(0.5, 1.5, w.shape).astype(np.float32)

    for tree in (np_params["layers"], np_params["prologue"]):
        tree["ln1"] = drawn(tree["ln1"])
        for name in ("q_norm", "kv_norm"):
            if name in tree["attn"]:
                tree["attn"][name] = drawn(tree["attn"][name])
    tctx = ApplyCtx(REGISTRY[arch].reduced(),
                    RunConfig(compute_dtype="bfloat16", use_kernels=True))
    params = params_from_jax(np_params, "cpu")
    eng = ServingEngine(tctx, params, 2, 16)
    lp = eng.params["layers"]
    assert lp["ffn"]["router"].dtype == lp["ln1"].dtype == torch.float32
    assert lp["ffn"]["we_gate"].dtype == lp["ffn"]["ws_down"].dtype == torch.bfloat16
    assert eng.params["prologue"]["ffn"]["wg"].dtype == torch.bfloat16
    if cfg.mla is not None:
        assert lp["attn"]["kv_norm"].dtype == lp["attn"]["q_norm"].dtype == torch.float32
        assert lp["attn"]["wkv_b"].dtype == torch.bfloat16
    prompt = np.arange(16, dtype=np.int32).reshape(2, 8)
    _, logits = eng.prefill(prompt)
    with torch.inference_mode():
        _, at_use = prefill(tctx, params, {"tokens": torch.from_numpy(prompt)}, capacity=16)
    assert torch.equal(logits, at_use)


@pytest.mark.parametrize("arch", MOE_MLA)
def test_serve_moe_and_mla_reduced_on_cpu(arch):
    """The launcher's MoE and MLA arches; DeepSeek-V2 with its depth cut
    as the full-width card run cuts it (``layers=2``: the dense layer 0
    and one MoE layer)."""
    m = serve(arch, requests=3, prompt_len=8, new_tokens=3, batch=2, concurrency=2,
              reduced=True, layers=2, device="cpu")
    assert m["requests"] == 3 and m["throughput_tok_s"] > 0 and m["graph_captures"] == 0


def test_build_engine_cuts_depth_and_draws_bf16():
    from repro_torch.launch.serve import build_engine

    eng = build_engine("deepseek-v2-236b", 2, 8, reduced=True, layers=2, device="cpu")
    cfg = eng.ctx.cfg
    assert cfg.n_layers == 2 and cfg.moe.first_moe_layer == 1
    assert eng.params["layers"]["attn"]["wkv_a"].shape[0] == 1  # one MoE layer past the prologue
    assert eng.ctx.rcfg.pdtype == torch.bfloat16
    assert eng.params["layers"]["ffn"]["router"].dtype == torch.bfloat16  # drawn in bf16


@pytest.mark.parametrize(
    "gen,kw",
    [("steady", {}), ("bursty_poisson", {"burst_factor": 5.0}),
     ("diurnal", {"period_s": 2.0})],
)
def test_workload_generators_match_reference(gen, kw):
    args = dict(rate=50.0, duration_s=4.0, prompt_lens=(8, 12), new_tokens=(2, 6),
                vocab=128, seed=2, rid0=7, **kw)
    ref = getattr(jax_workload, gen)(**args)
    out = getattr(workload, gen)(**args)
    assert len(out) == len(ref) > 0
    for a, b in zip(out, ref):
        assert (a.rid, a.arrival_s, a.max_new_tokens) == (b.rid, b.arrival_s,
                                                          b.max_new_tokens)
        np.testing.assert_array_equal(a.prompt, b.prompt)
