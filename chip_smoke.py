#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU, from the root of a checkout:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. Environment: the card's name and power limit, torch and CUDA versions;
   every kernel built from its source in the checkout (one nvcc each,
   started together), with its build time and ptxas report.
2. Kernel check: ``flash_attention_bhsd`` against ``attention_ref`` on the
   card over the CPU tests' sweep and the serving shape (B=4, Hq=16,
   Hkv=2, S=512, D=128, causal, bf16), then the kernel's, the plain
   version's and SDPA's (``library_ms``) device times at the serving
   shape, each call back to back behind a spin kernel.
3. Slice check: (a) reduced Qwen2.5-3B in float32 on the card, through
   the kernel, against the same model on the CPU (plain path, which the
   CPU tests hold to the JAX package); (b) Qwen2.5-3B at full width, bf16,
   random weights from a seeded ``torch.Generator``: one prefill (B=4,
   prompt 512) through the kernel against the same prefill with the
   kernel's call site routed to ``attention_ref``.
4. Serve (the main path): ``serve()`` at full width, 16 requests, prompt
   512, 32 new tokens, batch 4, at concurrency 1, then 2, then 1 again,
   with launch counts reset just before and read just after; then the
   τ-vs-concurrency probe over c in {1, 2, 4}; then the retire-overlap
   check: the real runtime over a stand-in engine whose steps take 10 ms
   of host work and a 10 ms spin kernel must serve at c=2 at least 1.3×
   its c=1 rate, which holds only if retire waits on its own slot alone.
5. Profile (after the counts are read): where a full-width prefill
   (B=4, prompt 512) and a decode step (B=4) spend their time — wall time,
   device-busy time and kernel count from ``torch.profiler``, the idle
   share, and the heaviest kernels.
6. A ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}`` as
   the last line.

It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
ARCH = "qwen2.5-3b"
SERVE_SHAPE = dict(b=4, hq=16, hkv=2, s=512, d=128, dv=128, causal=True, window=None)
SWEEP = [  # the CPU tests' sweep (tests/test_torch_flash_attention.py)
    dict(b=1, hq=2, hkv=2, s=64, d=32, dv=32, causal=True, window=None),
    dict(b=2, hq=4, hkv=2, s=96, d=32, dv=32, causal=True, window=None),
    dict(b=1, hq=4, hkv=1, s=128, d=16, dv=16, causal=True, window=24),
    dict(b=2, hq=2, hkv=2, s=80, d=32, dv=32, causal=False, window=None),
    dict(b=1, hq=8, hkv=2, s=72, d=64, dv=64, causal=True, window=16),
    dict(b=1, hq=4, hkv=2, s=70, d=32, dv=32, causal=True, window=None),
    dict(b=2, hq=4, hkv=2, s=48, d=32, dv=64, causal=True, window=None),
]
# H100 SXM published peaks (dense): HBM bytes/s, bf16 tensor-core FLOP/s
PEAK_BYTES = 3.35e12
PEAK_BF16_FLOPS = 989e12
ATOL = {"float32": 2e-5, "bfloat16": 3e-2}
SPIN_CYCLES = 60_000_000  # >= 30 ms at the H100's top SM clock of 1.98 GHz
SPIN_MS_MIN = 30.0
PREFILL_REL_TOL = 5e-2  # full-width bf16 logits, relative to max |logit|
SLICE_FP32_TOL = 1e-4  # reduced fp32 logits, card vs CPU
OVERLAP_MIN = 1.3  # tau(c=2) / tau(c=1) when host and card take 10 ms each


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def device_ms(fn, reps: int = 10, rounds: int = 5) -> float:
    """Device time of one call of ``fn``: ``reps`` calls back to back between
    two CUDA events, median over ``rounds``. A spin kernel queued first keeps
    the card busy while the host enqueues the calls, so host launch overhead
    does not enter the time. Inputs stay warm in L2 between calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        t0 = time.perf_counter()
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        enqueue_s = time.perf_counter() - t0
        b.synchronize()
        if enqueue_s * 1e3 > SPIN_MS_MIN:
            fail(f"timing: the host took {enqueue_s * 1e3:.1f} ms to enqueue {reps} calls, "
                 "longer than the spin kernel covers")
        times.append(a.elapsed_time(b) / reps)
    times.sort()
    return times[len(times) // 2]


def attention_inputs(torch, dtype, b, hq, hkv, s, d, dv, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    return tuple(
        torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to("cuda", dtype)
        for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, dv))
    )


def phase_environment(torch):
    from repro_torch.kernels import runtime

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    say(smi.stdout.strip().splitlines()[0])
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    log = runtime.build()
    say(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for name, entry in log.items():
        say(f"  {name}: nvcc {entry['seconds']:.1f} s")
        for line in str(entry["log"]).splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                say(f"    {line.strip()}")


def phase_kernel_check(torch):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import attention_ref, flash_attention_bhsd

    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for i, shp in enumerate(SWEEP + [SERVE_SHAPE]):
            kw = {k: shp[k] for k in ("causal", "window")}
            dims = {k: shp[k] for k in ("b", "hq", "hkv", "s", "d", "dv")}
            q, k, v = attention_inputs(torch, dtype, **dims, seed=i)
            out = flash_attention_bhsd(q, k, v, **kw)
            ref = attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            if out.shape != ref.shape or out.dtype != ref.dtype:
                fail(f"flash kernel {shp} {dname}: shape/dtype {out.shape} {out.dtype}")
            err = (out.float() - ref.float()).abs().max().item()
            ok = err <= ATOL[dname]
            say(f"  flash {dname} {dims} {kw}: max_abs_err {err:.3g} "
                f"(tol {ATOL[dname]}) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"flash kernel disagrees with attention_ref at {shp} {dname}")
            worst[(dname, i)] = err

    # times at the serving shape, bf16
    s = SERVE_SHAPE
    q, k, v = attention_inputs(torch, torch.bfloat16, s["b"], s["hq"], s["hkv"], s["s"],
                               s["d"], s["dv"], seed=len(SWEEP))
    ms = device_ms(lambda: flash_attention_bhsd(q, k, v, causal=True))
    plain_ms = device_ms(lambda: attention_ref(q, k, v, causal=True))

    def sdpa():  # one library call computing the same function (GQA in SDPA)
        return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)

    library_ms = device_ms(sdpa)
    lib_err = (sdpa().float() - attention_ref(q, k, v).float()).abs().max().item()
    pairs = s["s"] * (s["s"] + 1) // 2  # causal (query, key) pairs per head
    flops = 2.0 * (s["d"] + s["dv"]) * pairs * s["b"] * s["hq"]
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + s["b"] * s["hq"] * s["s"] * s["dv"])
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    say(f"  flash at serving shape (bf16): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"SDPA {library_ms:.4f} ms (SDPA max_abs_err {lib_err:.3g}), bound {bound_ms:.5f} ms "
        f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
    return {
        "max_abs_err": worst[("bfloat16", len(SWEEP))],
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound_ms, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


def phase_slice_check(torch):
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.configs.runtime import RunConfig
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models.transformer import ApplyCtx, init_model_params, prefill
    from repro_torch.serving.engine import cast_for_compute

    # (a) reduced, float32: the card's path (kernel) against the CPU's
    cfg = get_config(ARCH).reduced()
    ctx = ApplyCtx(cfg, RunConfig(compute_dtype="float32", use_kernels=True))
    params = init_model_params(cfg, ctx.rcfg, torch.Generator().manual_seed(0), "cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 96), dtype=np.int32)
    with torch.inference_mode():
        _, cpu = prefill(ctx, params, {"tokens": torch.from_numpy(tokens)})
        card_params = _to(params, "cuda")
        _, card = prefill(ctx, card_params, {"tokens": torch.from_numpy(tokens).cuda()})
    err = (card.cpu() - cpu).abs().max().item()
    say(f"  reduced {ARCH} fp32 prefill, card vs CPU: max_abs_err {err:.3g} "
        f"(tol {SLICE_FP32_TOL})")
    if not err <= SLICE_FP32_TOL:
        fail("reduced fp32 prefill on the card disagrees with the CPU path")

    # (b) full width, bf16: through the kernel vs through attention_ref
    cfg = get_config(ARCH)
    ctx = ApplyCtx(cfg, RunConfig(compute_dtype="bfloat16", use_kernels=True))
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = cast_for_compute(init_model_params(cfg, ctx.rcfg, gen, "cuda"),
                              torch.bfloat16)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (4, 512), dtype=np.int32)
    tok = torch.from_numpy(tokens).cuda()
    with torch.inference_mode():
        _, via_kernel = prefill(ctx, params, {"tokens": tok})
        # comparison, not a fallback: the model's one call site of the
        # kernel is pointed at the kernel's plain version for this run
        with mock.patch.object(fa_ops, "flash_attention_bhsd", attention_ref):
            _, via_ref = prefill(ctx, params, {"tokens": tok})
    a, b = via_kernel.float(), via_ref.float()
    if a.shape != (4, 1, cfg.vocab) or not torch.isfinite(a).all():
        fail(f"full-width prefill logits: shape {tuple(a.shape)} or non-finite values")
    err = (a - b).abs().max().item()
    scale = b.abs().max().item()
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    say(f"  full-width {ARCH} bf16 prefill (4x512): max_abs_err {err:.4g} vs max|logit| "
        f"{scale:.4g} (rel tol {PREFILL_REL_TOL}), argmax agreement {agree:.2f}")
    if not err <= PREFILL_REL_TOL * scale:
        fail("full-width prefill through the kernel disagrees with attention_ref")
    del params, via_kernel, via_ref
    torch.cuda.empty_cache()


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def phase_serve(torch):
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import runtime
    from repro_torch.launch.serve import build_engine, serve
    from repro_torch.serving import measure_concurrency_curve

    requests, prompt_len, new_tokens, batch = 16, 512, 32, 4
    torch.cuda.reset_peak_memory_stats()
    runtime.reset_launch_counts()
    # c=1, then c=2, then c=1 again: the repeat separates the effect of c
    # from that of running second
    order = (1, 2, 1)
    metrics = [serve(ARCH, requests, prompt_len, new_tokens, batch, c, device="cuda")
               for c in order]
    counts = runtime.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for c, m in zip(order, metrics):
        say(f"  serve c={c}: {m['requests']} requests, {m['throughput_tok_s']:.2f} tok/s, "
            f"p50 {m['p50_latency_s']:.3f} s, p99 {m['p99_latency_s']:.3f} s")
        if m["requests"] != requests or m["queue_depth"] != 0:
            fail(f"serve c={c} finished {m['requests']} of {requests} requests")
    served = requests * len(metrics)
    say(f"  launches on the main path: {counts} ({counts['flash_attention'] / served:.2f} "
        f"flash launches per request), peak memory {peak_gb:.2f} GB")
    missing = [k for k, n in counts.items() if n == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")

    engine = build_engine(ARCH, batch, 64 + 16 + 1, device="cuda")
    best, used = measure_concurrency_curve(
        engine, [1, 2, 4], rounds=2, min_rounds=2, prompt_len=64, new_tokens=16,
        groups=8, batch_size=batch, vocab=get_config(ARCH).vocab,
    )
    say("  tau vs concurrency (decode tok/s, best of "
        f"{used} interleaved rounds): " + ", ".join(f"c={c}: {t:.2f}" for c, t in best.items()))
    retire_overlap_check(torch)
    return counts


class SpinEngine:
    """A stand-in engine whose every step is ``host_ms`` of host work (the
    eager launches) followed by a ``device_ms`` spin kernel on the card.
    Its logits travel to the host by the real engine's ``fetch_last``."""

    def __init__(self, torch, batch, vocab, host_ms, device_ms):
        from repro_torch.serving.engine import ServingEngine

        self.torch, self.batch, self.vocab = torch, batch, vocab
        self.host_s = host_ms / 1e3
        self.cycles = int(device_ms * 1.755e6)  # at the H100's base SM clock
        self.fetch_last = ServingEngine.fetch_last

    def _step(self):
        t_end = time.perf_counter() + self.host_s
        while time.perf_counter() < t_end:
            pass
        self.torch.cuda._sleep(self.cycles)
        return None, self.torch.zeros((self.batch, 1, self.vocab), device="cuda")

    def prefill(self, tokens):
        return self._step()

    def decode(self, cache, tokens):
        return self._step()


def retire_overlap_check(torch):
    """The runtime's retire waits on its own slot's logits only: with host
    and card time per step alike, two slots in flight overlap one slot's
    host work with the other's device work, so τ(c=2) approaches 2 τ(c=1).
    A retire that waited on the whole stream would give about 1."""
    from repro_torch.serving import measure_runtime_throughput

    eng = SpinEngine(torch, batch=4, vocab=1024, host_ms=10.0, device_ms=10.0)
    tau = {c: measure_runtime_throughput(eng, c, prompt_len=8, new_tokens=16, groups=4,
                                         batch_size=4, vocab=1024)
           for c in (1, 2)}
    ratio = tau[2] / tau[1]
    say(f"  retire overlap (10 ms host + 10 ms device per step): tau c=1 {tau[1]:.2f}, "
        f"c=2 {tau[2]:.2f} tok/s, ratio {ratio:.3f} (must be >= {OVERLAP_MIN})")
    if not ratio >= OVERLAP_MIN:
        fail("two decode slots do not overlap: retire waits on more than its own slot")


def profile_window(torch, label, fn, reps):
    """Wall and host-enqueue time of ``reps`` calls of ``fn`` (CUDA events,
    no profiler attached), then device-busy time, kernel count and the
    heaviest kernels from a second, profiled window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    b.record()
    b.synchronize()
    wall_ms = a.elapsed_time(b) / reps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / reps
    launches = sum(e.count for e in kern) / reps
    idle = 1.0 - busy_ms / wall_ms if busy_ms > 0 else float("nan")
    say(f"  {label}: wall {wall_ms:.3f} ms, host enqueue {host_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms, idle share {idle:.3f}, {launches:.0f} kernels per call")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:5]:
        say(f"    {e.self_device_time_total / 1e3 / reps:8.3f} ms  x{e.count // reps:<4d} "
            f"{e.key[:90]}")


def phase_profile(torch):
    import numpy as np

    from repro_torch.launch.serve import build_engine

    engine = build_engine(ARCH, 4, 512 + 16, device="cuda")
    prompt = np.random.default_rng(2).integers(0, 1000, (4, 512), dtype=np.int32)
    state = {}

    def prefill():
        state["cache"], _ = engine.prefill(prompt)

    profile_window(torch, "prefill 4x512", prefill, reps=3)
    tok = np.zeros((4, 1), np.int32)

    def decode():
        state["cache"]["length"] = 512  # re-decode the same slot: no cache growth
        engine.decode(state["cache"], tok)

    profile_window(torch, "decode step (B=4, cache 528)", decode, reps=5)


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        fail("src/repro_torch not found: run from the root of a checkout")
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: the port's kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    say("== phase 1: environment")
    phase_environment(torch)
    say("== phase 2: kernel check")
    kern = phase_kernel_check(torch)
    say("== phase 3: slice check")
    phase_slice_check(torch)
    say("== phase 4: serve")
    counts = phase_serve(torch)
    say("== phase 5: profile")
    phase_profile(torch)
    say(f"== done in {time.perf_counter() - t0:.1f} s")
    say(json.dumps({"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:26",
        "launches": counts["flash_attention"],
        **kern,
    }]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
