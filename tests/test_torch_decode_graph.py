"""The capturable decode step on the CPU: ``make_serve_step`` with the
cache's ``length`` an int32 scalar tensor, run eagerly through the
engine's pool, against the JAX package's teacher-forced logits
(``tests/test_decode_multistep.py``'s property) for Qwen2.5-3B,
Mamba2-2.7B, Hymba-1.5B, DeepSeek-V2-236B (MLA's latent cache, MoE, a
dense prologue), Moonlight-16B-A3B (MoE with shared experts, a dense
prologue), Whisper-medium (the encoder's features, the cross-attention
cache) and Qwen2-VL-72B (M-RoPE, vision embeds over the first 8
positions) at reduced width; the step reads no device
value on the host; a pool entry reused by another group gives the
logits of a new cache.

Tolerances. The teacher-forced comparison is the reference test's own
(atol 0.15, rtol 0.08), in float32 compute in both packages: decode
reads the bf16 cache where the full forward keeps float32 activations.
In bf16 compute the two packages round their bf16 matmuls differently
(XLA's and PyTorch's CPU kernels), and the reference's tolerance is
sized for one package's rounding: there one logit of 1024 of the
reduced Mamba2-2.7B's step at position 22 lies 0.0018 past it (port
against JAX decode: 0.164 there, at most 0.045 elsewhere; ROADMAP queue
3). The pool and the step
functions against the engine's earlier path (a new cache per prompt, the
model's ``decode_step``): bitwise, the same operations on the same
values. The CUDA graph itself is held to the eager step, bitwise, on the
card (``tests/test_torch_kernels_gpu.py``).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import REGISTRY as JAX_REGISTRY
from repro.configs.runtime import RunConfig as JaxRunConfig
from repro.models import ApplyCtx as JaxCtx
from repro.models import forward_train as jax_forward
from repro.models import init_model_params as jax_init
from repro_torch.configs.registry import REGISTRY
from repro_torch.configs.runtime import RunConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import ApplyCtx, decode_step, prefill
from repro_torch.serving import ServingEngine, make_prefill_step, make_serve_step
from repro_torch.serving.engine import capture_counts, reset_capture_counts

ARCHS = ["qwen2.5-3b", "mamba2-2.7b", "hymba-1.5b", "deepseek-v2-236b", "moonshot-v1-16b-a3b",
         "whisper-medium", "qwen2-vl-72b"]
B, S, N_DEC = 2, 24, 4  # prefill S - N_DEC tokens, decode the last N_DEC


def _models(arch):
    """The JAX package's reduced model, its params as numpy, and the
    port's context and params over the same numbers."""
    jcfg = JAX_REGISTRY[arch].reduced()
    jctx = JaxCtx(jcfg, JaxRunConfig(remat="none", moe_impl="dense", compute_dtype="float32"),
                  None)
    np_params = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0), jcfg, jctx.rcfg))
    tctx = ApplyCtx(REGISTRY[arch].reduced(), RunConfig(compute_dtype="float32"))
    return jctx, np_params, tctx, params_from_jax(np_params, "cpu")


def _extras(cfg, seed=7):
    """A model's stub front-end inputs (numpy, normal draws): Whisper's
    encoder features, Qwen2-VL's vision embeds; none for the others."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.is_encoder_decoder:
        out["enc_feats"] = rng.normal(size=(B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    if cfg.n_vision_tokens:
        out["vision_embeds"] = rng.normal(size=(B, cfg.n_vision_tokens, cfg.d_model)).astype(
            np.float32)
    return out


def _batch(tokens, ex):
    return {"tokens": tokens, **{k: torch.from_numpy(v) for k, v in ex.items()}}


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_matches_teacher_forced_jax_logits(arch):
    jctx, np_params, tctx, params = _models(arch)
    tokens = np.random.default_rng(1).integers(0, tctx.cfg.vocab, (B, S), dtype=np.int32)
    ex = _extras(tctx.cfg)
    full, _ = jax.jit(lambda p, t, e: jax_forward(jctx, p, {"tokens": t, **e}))(np_params, tokens,
                                                                                 ex)
    full = np.asarray(full, np.float32)
    reset_capture_counts()
    eng = ServingEngine(tctx, params, B, S)
    assert not eng.graphs
    k = eng.acquire()
    cache, _ = eng.prefill(tokens[:, : S - N_DEC], ex, entry=k)
    length = cache["length"]
    assert length.dtype == torch.int32 and length.dim() == 0 and int(length) == S - N_DEC
    for i in range(S - N_DEC, S):
        cache, logits = eng.decode(cache, tokens[:, i : i + 1])
        np.testing.assert_allclose(logits[:, 0].float().numpy(), full[:, i], atol=0.15,
                                   rtol=0.08, err_msg=f"{arch}: decode step at {i} diverged")
    assert cache is eng.pool[k].cache and cache["length"] is length  # advanced in place
    assert int(length) == S
    assert capture_counts() == {}


@pytest.mark.parametrize("arch", ARCHS)
def test_step_functions_equal_the_model_path_bitwise(arch):
    """``make_prefill_step`` into a preallocated cache and ``make_serve_step``
    give the logits and cache of ``prefill`` into a new cache and the
    model's ``decode_step``, bit for bit."""
    _, _, tctx, params = _models(arch)
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, tctx.cfg.vocab, (B, 10), dtype=np.int32))
    feeds = torch.from_numpy(rng.integers(0, tctx.cfg.vocab, (5, B, 1), dtype=np.int32))
    batch = _batch(tokens, _extras(tctx.cfg))
    eng = ServingEngine(tctx, params, B, 16)
    with torch.inference_mode():
        ref_cache, ref_logits = prefill(tctx, eng.params, batch, capacity=16)
        ref = [ref_logits]
        for tok in feeds:
            ref_cache, lg = decode_step(tctx, eng.params, ref_cache, tok)
            ref.append(lg)
        k = eng.acquire()
        cache, lg = make_prefill_step(tctx, capacity=16)(eng.params, batch, out=eng.pool[k].cache)
        got = [lg]
        step = make_serve_step(tctx)
        for tok in feeds:
            cache, lg = step(eng.params, cache, tok)
            got.append(lg)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert int(cache["length"]) == int(ref_cache["length"]) == 15
    assert set(cache) - {"entry"} == set(ref_cache)
    for part in ("pro", "main"):
        for name, t in ref_cache.get(part, {}).items():
            assert torch.equal(cache[part][name], t), (part, name)


class _HostRead(AssertionError):
    pass


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_reads_no_device_value_on_the_host(arch, monkeypatch):
    """Every way a tensor's value reaches Python raises during the step:
    a CUDA graph could not capture such a read, and eagerly it would
    stall the host on the device queue."""
    _, _, tctx, params = _models(arch)
    eng = ServingEngine(tctx, params, B, 16)
    k = eng.acquire()
    prompt = np.random.default_rng(3).integers(0, tctx.cfg.vocab, (B, 8), dtype=np.int32)
    cache, _ = eng.prefill(prompt, _extras(tctx.cfg), entry=k)
    tok = torch.from_numpy(prompt[:, :1].copy())

    def refuse(self, *a, **kw):
        raise _HostRead("the decode step read a tensor's value on the host")

    for name in ("__int__", "__index__", "__float__", "__bool__", "item", "tolist",
                 "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    with pytest.raises(_HostRead):  # the patch is live
        int(torch.zeros((), dtype=torch.int32))
    cache, logits = eng.decode(cache, tok)
    cache, logits = eng.decode(cache, tok)
    monkeypatch.undo()
    assert logits.shape == (B, 1, tctx.cfg.vocab)
    assert int(cache["length"]) == 10


@pytest.mark.parametrize("arch", ARCHS)
def test_reused_pool_entry_equals_a_new_cache(arch):
    """A group prefilled into an entry a longer group used before gets
    the logits of a new cache: the K/V (or MLA latent and RoPE key) slots
    of every stack, prologue included, are zeroed, the states, the
    cross-attention cache (of other encoder features) and ``length``
    overwritten."""
    _, _, tctx, params = _models(arch)
    rng = np.random.default_rng(4)
    eng = ServingEngine(tctx, params, B, 20)
    long_prompt = rng.integers(0, tctx.cfg.vocab, (B, 14), dtype=np.int32)
    short = rng.integers(0, tctx.cfg.vocab, (B, max(6, tctx.cfg.n_vision_tokens + 2)),
                         dtype=np.int32)  # a vision prompt holds its vision span
    feeds = rng.integers(0, tctx.cfg.vocab, (4, B, 1), dtype=np.int32)
    ex_long, ex = _extras(tctx.cfg, seed=8), _extras(tctx.cfg, seed=9)

    def run(entry):
        cache, lg = eng.prefill(short, ex, entry=entry)
        out = [lg]
        for tok in feeds:
            cache, lg = eng.decode(cache, tok)
            out.append(lg)
        return out

    fresh = run(None)
    k = eng.acquire()
    cache, _ = eng.prefill(long_prompt, ex_long, entry=k)
    for tok in feeds:
        cache, _ = eng.decode(cache, tok)
    eng.release(k)
    assert eng.acquire() == k and len(eng.pool) == 1
    for a, b in zip(run(k), fresh):
        assert torch.equal(a, b)


def test_pool_grows_to_the_largest_concurrency_and_is_released():
    from repro_torch.serving import Request, ServingRuntime

    _, _, tctx, params = _models("qwen2.5-3b")
    eng = ServingEngine(tctx, params, B, 16)
    rng = np.random.default_rng(5)
    for c in (3, 1, 2):
        rt = ServingRuntime(eng, concurrency=c)
        for rid in range(8):
            rt.submit(Request(rid, rng.integers(0, tctx.cfg.vocab, 6, dtype=np.int32), 3))
        assert rt.drain()["requests"] == 8
    assert len(eng.pool) == 3 and not any(e.busy for e in eng.pool)
    assert [e.cache["entry"] for e in eng.pool] == [0, 1, 2]
    with pytest.raises(ValueError, match="overflows"):
        eng.prefill(np.zeros((B, 17), np.int32), entry=0)


def test_runtime_reserves_a_pool_entry_per_slot():
    """Every setting of the slots reserves the engine's pool up front: one
    entry per slot of the rings the engine serves (two tenants on one
    engine add up), made before any request is served, never taken back."""
    from repro_torch.serving import ServingRuntime

    _, _, tctx, params = _models("qwen2.5-3b")
    eng = ServingEngine(tctx, params, B, 16)
    rt = ServingRuntime(eng, concurrency=2)
    assert len(eng.pool) == 2
    rt.set_concurrency(3)
    assert len(eng.pool) == 3
    rt.add_tenant("b", slots=2)
    assert len(eng.pool) == 5
    rt.set_slot_allocation({"b": 1})
    assert len(eng.pool) == 5
    rt.concurrency = 6
    assert len(eng.pool) == 7 and not any(e.busy for e in eng.pool)


def test_graphs_need_the_card():
    _, _, tctx, params = _models("qwen2.5-3b")
    with pytest.raises(ValueError, match="on the card"):
        ServingEngine(tctx, params, B, 16, graphs=True)
    assert ServingEngine(tctx, params, B, 16).graphs is False
