#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU, from the root of a checkout:

    python3 chip_smoke.py

Three main paths, each at full size through its kernel: Qwen2.5-3B served
at full width (prefill attention through ``flash_attention``), Mamba2-2.7B
served at full width (the SSD chunked scan through ``ssd_scan``), and the
CORAL loop over the 54-cell x 3-seed static grid (its windowed dCor
through ``dcov``). Phases, each of which exits non-zero on failure:

1. Environment: the card's name and power limit, torch and CUDA versions;
   every kernel built from its source in the checkout (one nvcc each,
   started together), with its build time and ptxas report.
2. Kernel check: each kernel against its plain version on the card over
   the CPU tests' sweep and its main path's shape, then the kernel's, the
   plain version's and (where one exists) a library call's device times
   at that shape, each call back to back behind a spin kernel.
   ``flash_attention_bhsd`` against ``attention_ref`` (B=4, Hq=16, Hkv=2,
   S=512, D=128, causal, bf16; library: SDPA); ``ssd_scan`` against
   ``ssd_ref`` in float32 and bfloat16, with a ragged tail and an initial
   state (B=4, S=512, NH=80, hd=64, N=128, chunk 256, bf16; no library
   call computes the scan); ``dcov``'s windows form against
   ``dcov_gram_windows_ref`` over B in {1, 3, 162, 1024}, W in {3, 10,
   64}, C in {2, 7, 8} with n_valid from {1, 2, 3, W-1, W}, constant
   columns and zero rows, and bitwise batch independence; its
   single-block form against ``dcov_gram_ref`` over n up to 4099 (times
   at the grid shape B=162, W=10, C=7 and at n=1600, C=7; no library call
   computes the Gram).
3. Slice check, per model: (a) the reduced model in float32 on the card,
   through the kernel, against the same model on the CPU (plain path,
   which the CPU tests hold to the JAX package); (b) the model at full
   width, random weights from a seeded ``torch.Generator``: one prefill
   (B=4, prompt 512) through the kernel against the same prefill with the
   model's call site of the kernel routed to its plain version. For
   Qwen2.5-3B in bf16, logits within 5e-2 × max|logit|. For Mamba2-2.7B,
   in bf16 every SSD launch of the prefill is held to ``ssd_ref`` on its
   own inputs and the logits are printed beside a control (the plain path
   with half the chunk); in float32 the logits are held within
   5e-2 × max|logit| (``ssm_full_width_check`` says why). Then the CORAL
   slice (the main path of ``dcov``): ``run_matrix`` over the 54 static
   cells x 3 seeds on the card as one batched call (10 dcov launches),
   each cell held to ``BENCH_matrix.json`` (configs, flags and counts
   exactly, floats at rel 1e-12) and its summary; the same cells through
   the scalar spec, records identical (one launch per ``correlations()``
   call with n >= 3); dCor of each cell's noise-free landscape through the
   single-block form, held to its plain version (54 launches).
4. Serve (the serving paths): ``serve()`` at full width, 16 requests,
   prompt 512, 32 new tokens, batch 4, at concurrency 1, then 2, with
   launch counts reset just before and read just after each model's runs;
   each model's kernel must have launched (``ssd_scan`` 64 times per
   prefill). For Qwen2.5-3B then the τ-vs-concurrency probe over c in
   {1, 2, 4} and the retire-overlap check: the real runtime over a
   stand-in engine whose steps take 10 ms of host work and a 10 ms spin
   kernel must serve at c=2 at least 1.3× its c=1 rate, which holds only
   if retire waits on its own slot alone.
5. Profile (after the counts are read): where a full-width prefill
   (B=4, prompt 512) and a decode step (B=4) of each model, and one
   batched static CORAL call over the grid, spend their time — wall time,
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
SSM_ARCH = "mamba2-2.7b"
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
# (b, s, nh, hd, n, chunk, initial state): the CPU tests' sweep
# (tests/test_torch_ssd_scan.py), a ragged tail, the reduced Mamba2, and
# full-width heads (hd 64, N 128, the tensor-core body in bf16), ragged
SSD_SWEEP = [
    (1, 32, 2, 16, 8, 8, False),
    (2, 64, 4, 16, 16, 16, False),
    (1, 48, 1, 8, 4, 16, False),
    (2, 45, 3, 16, 8, 16, False),
    (1, 5, 2, 8, 4, 8, False),
    (1, 32, 2, 16, 8, 8, True),
    (2, 45, 3, 16, 8, 16, True),
    (2, 93, 16, 16, 16, 8, True),
    (1, 300, 4, 64, 128, 256, True),
    (2, 200, 3, 64, 128, 64, False),
]
SSD_SERVE = (4, 512, 80, 64, 128, 256, False)  # Mamba2-2.7B prefill, B=4 x 512
# H100 SXM published peaks (dense): HBM bytes/s, bf16 tensor-core FLOP/s
PEAK_BYTES = 3.35e12
PEAK_BF16_FLOPS = 989e12
ATOL = {"float32": 2e-5, "bfloat16": 3e-2}
SPIN_CYCLES = 60_000_000  # >= 30 ms at the H100's top SM clock of 1.98 GHz
SPIN_MS_MIN = 30.0
PREFILL_REL_TOL = 5e-2  # full-width bf16 logits, relative to max |logit|
SLICE_FP32_TOL = 1e-4  # reduced fp32 logits, card vs CPU
OVERLAP_MIN = 1.3  # tau(c=2) / tau(c=1) when host and card take 10 ms each
SERVE = dict(requests=16, prompt_len=512, new_tokens=32, batch=4)
SERVE_ORDER = (1, 2)  # concurrency of the successive serve() runs of each model
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
# dcov: the windows form's sweep (B, W, C) and grid shape, the single-block
# form's (n, C) and ORACLE shape; column scales of a CORAL window (five knob
# values, then tau and p, an eighth for C = 8), as tests/test_torch_kernels_gpu.py
DCOV_WINDOWS = [(b, w, c) for b in (1, 3, 162, 1024) for w in (3, 10, 64) for c in (2, 7, 8)]
DCOV_GRID = (162, 10, 7)  # 54 cells x 3 seeds, window 10, 5 knobs + (tau, p)
DCOV_BLOCKS = [(n, c) for n in (30, 200, 512, 1440, 1600, 2160, 4099) for c in (2, 7, 8)]
DCOV_ORACLE = (1600, 7)
DCOV_SCALES = (1500.0, 4.0, 800.0, 2000.0, 3.0, 50.0, 5.0, 1.0)
DCOV_WINDOW_REL = 1e-6  # windows Gram, relative to each episode's max|G|
DCOV_GRAM_REL = 1e-4  # single-block Gram, relative to max|G| (float32, n^2 terms)
DCOV_DCOR_ATOL = 1e-3  # single-block dCor (sqrt of a ratio: 1e-6 near 0 is 1e-3)
MATRIX_RECORD = ROOT / "BENCH_matrix.json"  # the JAX package's committed static grid
RECORD_REL = 1e-12  # floats of a cell record against the committed one


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


def phase_flash_check(torch):
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


def ssd_inputs(torch, dtype, b, s, nh, hd, n, state, seed):
    """dt and A drawn as in tests/test_kernels.py; x, B, C in ``dtype``."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def t(a, dt=dtype):
        return torch.from_numpy(np.asarray(a, np.float32)).to("cuda", dt)

    args = (t(rng.normal(size=(b, s, nh, hd))), t(rng.uniform(0.01, 0.2, (b, s, nh)), torch.float32),
            t(-rng.uniform(0.5, 2, (nh,)), torch.float32), t(rng.normal(size=(b, s, n))),
            t(rng.normal(size=(b, s, n))))
    return args, (t(rng.normal(size=(b, nh, hd, n)), torch.float32) if state else None)


def ssd_tolerances(torch, y_ref, s_ref):
    """y: float32 max(1e-4, 1e-5 max|y|) (summation order only), bfloat16
    1e-2 max|y| (both sides round one float32 result, one bf16 ulp is 2^-7
    of the value); the float32 state 1e-4 max(1, max|S|)."""
    y_max = y_ref.float().abs().max().item()
    y_tol = max(1e-4, 1e-5 * y_max) if y_ref.dtype == torch.float32 else 1e-2 * y_max
    return y_tol, 1e-4 * max(1.0, s_ref.abs().max().item())


def ssd_work(b, s, nh, hd, n, chunk, x_bytes, state):
    """Bytes the scan must move (each input read once, each output written
    once) and the operations its data needs: per chunk of q positions the
    q(q+1)/2 causal pairs of C·Bᵀ (once per batch row: B and C are shared
    by every head) and of (C·Bᵀ ⊙ L)·(dt x), then C·Sᵀ and the state
    update, q·N·hd each, per head."""
    nbytes = (2 * b * s * nh * hd * x_bytes + 4 * b * s * nh + 4 * nh + 2 * b * s * n * x_bytes
              + 4 * b * nh * hd * n * (2 if state else 1))
    flops = 0
    for c0 in range(0, s, chunk):
        q = min(chunk, s - c0)
        pairs = q * (q + 1) // 2
        flops += 2 * b * pairs * n + 2 * b * nh * (pairs * hd + 2 * q * n * hd)
    return nbytes, flops


def phase_ssd_check(torch):
    from repro_torch.kernels.ssd_scan import ssd_ref, ssd_scan

    serve_err = None
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for i, case in enumerate(SSD_SWEEP + [SSD_SERVE]):
            b, s, nh, hd, n, chunk, state = case
            args, s0 = ssd_inputs(torch, dtype, b, s, nh, hd, n, state, seed=i)
            y, st = ssd_scan(*args, chunk=chunk, initial_state=s0)
            y_ref, s_ref = ssd_ref(*args, chunk, s0)
            torch.cuda.synchronize()
            if (y.shape != y_ref.shape or y.dtype != y_ref.dtype or st.shape != s_ref.shape
                    or st.dtype != torch.float32):
                fail(f"ssd kernel {case} {dname}: shape/dtype {y.shape} {y.dtype} {st.dtype}")
            y_err = (y.float() - y_ref.float()).abs().max().item()
            s_err = (st - s_ref).abs().max().item()
            y_tol, s_tol = ssd_tolerances(torch, y_ref, s_ref)
            ok = y_err <= y_tol and s_err <= s_tol
            say(f"  ssd {dname} (b, s, nh, hd, n, chunk, state)={case}: y max_abs_err "
                f"{y_err:.3g} (tol {y_tol:.3g}), state {s_err:.3g} (tol {s_tol:.3g}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"ssd kernel disagrees with ssd_ref at {case} {dname}")
            if case is SSD_SERVE and dtype == torch.bfloat16:
                serve_err = y_err

    # times at the serving shape, bf16
    b, s, nh, hd, n, chunk, state = SSD_SERVE
    args, _ = ssd_inputs(torch, torch.bfloat16, b, s, nh, hd, n, state, seed=len(SSD_SWEEP))
    ms = device_ms(lambda: ssd_scan(*args, chunk=chunk))
    plain_ms = device_ms(lambda: ssd_ref(*args, chunk))
    nbytes, flops = ssd_work(b, s, nh, hd, n, chunk, 2, state)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    say(f"  ssd at serving shape (bf16): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library: none, bound {bound_ms:.5f} ms ({nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.2f} GFLOP)")
    return {
        "max_abs_err": serve_err,
        "ms": ms, "plain_ms": plain_ms, "library_ms": None,
        "bound_ms": bound_ms, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


def dcov_windows_inputs(torch, b, w, c, seed):
    """B (W, C) windows at CORAL's column scales, n_valid drawn per episode
    from {1, 2, 3, W-1, W}, rows past n_valid zero, and in every third
    episode a constant first column."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, w, c)) * np.asarray(DCOV_SCALES[:c]) + np.asarray(DCOV_SCALES[:c])
    x[::3, :, 0] = DCOV_SCALES[0]
    n = rng.choice(sorted({1, 2, 3, max(w - 1, 1), w}), size=b).astype(np.int32)
    x[np.arange(w)[None, :] >= n[:, None]] = 0.0
    return torch.from_numpy(x.astype(np.float32)).cuda(), torch.from_numpy(n).cuda()


def dcov_pair_ops(c):
    """Operations per unordered (i, j) pair of one Gram with C columns: per
    column the distance (subtract, abs), its two row-sum adds and the
    centring (three), then a multiply and an add per (c <= c') product."""
    return 7 * c + c * (c + 1)


def dcov_bound(nbytes, ops):
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_dcov_check(torch):
    """The windows form and the single-block form against their plain
    versions over the sweep, batch independence, and the times at the
    grid shape (B=162, W=10, C=7) and at ORACLE scale (n=1600, C=7)."""
    import numpy as np

    from repro_torch.kernels.dcov import (
        dcov_gram,
        dcov_gram_ref,
        dcov_gram_windows,
        dcov_gram_windows_ref,
    )
    from repro_torch.kernels.dcov.ref import dcor_from_sums

    for i, (b, w, c) in enumerate(DCOV_WINDOWS):
        cols, n = dcov_windows_inputs(torch, b, w, c, seed=i)
        gram = dcov_gram_windows(cols, n)
        ref = dcov_gram_windows_ref(cols, n)
        torch.cuda.synchronize()
        if gram.shape != (b, c, c) or not torch.isfinite(gram).all():
            fail(f"dcov windows {(b, w, c)}: shape {tuple(gram.shape)} or non-finite values")
        scale = ref.abs().amax(dim=(1, 2)).clamp_min(1e-30)
        rel = ((gram - ref).abs().amax(dim=(1, 2)) / scale).max().item()
        err = (gram - ref).abs().max().item()
        say(f"  dcov windows (B, W, C)={(b, w, c)}: max_abs_err {err:.3g}, relative to each "
            f"episode's max|G| {rel:.3g} (tol {DCOV_WINDOW_REL}) {'ok' if rel <= DCOV_WINDOW_REL else 'FAIL'}")
        if not rel <= DCOV_WINDOW_REL:
            fail(f"dcov windows kernel disagrees with its plain version at {(b, w, c)}")
    cols, n = dcov_windows_inputs(torch, *DCOV_GRID, seed=len(DCOV_WINDOWS))
    batch = dcov_gram_windows(cols, n)
    grid_err = (batch - dcov_gram_windows_ref(cols, n)).abs().max().item()
    apart = sum(not torch.equal(dcov_gram_windows(cols[i:i + 1], n[i:i + 1])[0], batch[i])
                for i in range(DCOV_GRID[0]))
    say(f"  dcov windows batch independence: {DCOV_GRID[0] - apart} of {DCOV_GRID[0]} episodes "
        f"bitwise equal alone and inside B={DCOV_GRID[0]}")
    if apart:
        fail("dcov windows kernel: an episode's Gram depends on the batch")

    for n_rows, c in DCOV_BLOCKS:
        rng = np.random.default_rng(n_rows + c)
        x = rng.normal(size=(n_rows, c)) * np.asarray(DCOV_SCALES[:c]) + np.asarray(DCOV_SCALES[:c])
        x = torch.from_numpy(x.astype(np.float32)).cuda()
        gram, ref = dcov_gram(x), dcov_gram_ref(x)
        torch.cuda.synchronize()
        scale = ref.abs().max().item()
        err = (gram - ref).abs().max().item()
        d = c - 1

        def dcor_of(g):
            diag = torch.diagonal(g)
            return dcor_from_sums(g[:d, d:], diag[:d, None], diag[None, d:])

        corr_err = (dcor_of(gram) - dcor_of(ref)).abs().max().item()
        ok = err <= DCOV_GRAM_REL * scale and corr_err <= DCOV_DCOR_ATOL
        say(f"  dcov gram (n, C)={(n_rows, c)}: max_abs_err {err:.3g} at max|G| {scale:.3g} "
            f"(rel {err / scale:.3g}, tol {DCOV_GRAM_REL}), dCor {corr_err:.3g} "
            f"(tol {DCOV_DCOR_ATOL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"dcov single-block kernel disagrees with its plain version at {(n_rows, c)}")

    # times: the windows form at the grid shape (the main path's launch)
    b, w, c = DCOV_GRID
    ms = device_ms(lambda: dcov_gram_windows(cols, n))
    plain_ms = device_ms(lambda: dcov_gram_windows_ref(cols, n))
    pairs = sum(k * (k + 1) // 2 for k in n.tolist())
    nbytes = 4 * (b * w * c + b + b * c * c)
    bound_ms, bound_by = dcov_bound(nbytes, pairs * dcov_pair_ops(c))
    say(f"  dcov windows at the grid shape {DCOV_GRID}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, library: none, bound {bound_ms:.6f} ms ({bound_by}; {nbytes / 1e3:.1f} KB, "
        f"{pairs * dcov_pair_ops(c) / 1e6:.3f} MFLOP)")
    # the single-block form at ORACLE scale
    n_rows, c = DCOV_ORACLE
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=(n_rows, c)) * np.asarray(DCOV_SCALES[:c])
                          ).astype(np.float32)).cuda()
    o_ms = device_ms(lambda: dcov_gram(x))
    o_plain = device_ms(lambda: dcov_gram_ref(x), reps=3)
    o_ops = n_rows * (n_rows + 1) // 2 * dcov_pair_ops(c)
    o_bound, o_by = dcov_bound(4 * (n_rows * c + c * c), o_ops)
    say(f"  dcov gram at ORACLE scale (n, C)={DCOV_ORACLE}: kernel {o_ms:.4f} ms, plain "
        f"{o_plain:.4f} ms, library: none, bound {o_bound:.5f} ms ({o_by}; "
        f"{o_ops / 1e9:.3f} GFLOP)")
    return {
        "max_abs_err": grid_err,
        "ms": ms, "plain_ms": plain_ms, "library_ms": None,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def plain_route(arch):
    """A context in which the model's one call site of its kernel is
    pointed at the kernel's plain version: a comparison, not a fallback."""
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ssd_ref

    if arch == SSM_ARCH:
        return mock.patch.object(ssd_ops, "ssd_scan", ssd_ref)
    return mock.patch.object(fa_ops, "flash_attention_bhsd", attention_ref)


def phase_slice_check(torch, arch, reduced_len):
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.configs.runtime import RunConfig
    from repro_torch.models.transformer import ApplyCtx, init_model_params, prefill
    from repro_torch.serving.engine import cast_for_compute

    # (a) reduced, float32: the card's path (kernel) against the CPU's
    cfg = get_config(arch).reduced()
    ctx = ApplyCtx(cfg, RunConfig(compute_dtype="float32", use_kernels=True))
    params = init_model_params(cfg, ctx.rcfg, torch.Generator().manual_seed(0), "cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, reduced_len), dtype=np.int32)
    with torch.inference_mode():
        _, cpu = prefill(ctx, params, {"tokens": torch.from_numpy(tokens)})
        card_params = _to(params, "cuda")
        _, card = prefill(ctx, card_params, {"tokens": torch.from_numpy(tokens).cuda()})
    err = (card.cpu() - cpu).abs().max().item()
    say(f"  reduced {arch} fp32 prefill (2x{reduced_len}), card vs CPU: max_abs_err "
        f"{err:.3g} (tol {SLICE_FP32_TOL})")
    if not err <= SLICE_FP32_TOL:
        fail(f"reduced {arch} fp32 prefill on the card disagrees with the CPU path")

    if arch == SSM_ARCH:
        ssm_full_width_check(torch)
        return
    # (b) full width, bf16: through the kernel vs through its plain version
    cfg = get_config(arch)
    ctx = ApplyCtx(cfg, RunConfig(compute_dtype="bfloat16", use_kernels=True))
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = cast_for_compute(init_model_params(cfg, ctx.rcfg, gen, "cuda"),
                              torch.bfloat16)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (4, 512), dtype=np.int32)
    tok = torch.from_numpy(tokens).cuda()
    with torch.inference_mode():
        _, via_kernel = prefill(ctx, params, {"tokens": tok})
        with plain_route(arch):
            _, via_ref = prefill(ctx, params, {"tokens": tok})
    a, b = via_kernel.float(), via_ref.float()
    if a.shape != (4, 1, cfg.vocab) or not torch.isfinite(a).all():
        fail(f"full-width {arch} prefill logits: shape {tuple(a.shape)} or non-finite values")
    err = (a - b).abs().max().item()
    scale = b.abs().max().item()
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    say(f"  full-width {arch} bf16 prefill (4x512): max_abs_err {err:.4g} vs max|logit| "
        f"{scale:.4g} (rel tol {PREFILL_REL_TOL}), argmax agreement {agree:.2f}")
    if not err <= PREFILL_REL_TOL * scale:
        fail(f"full-width {arch} prefill through the kernel disagrees with its plain version")
    del params, via_kernel, via_ref
    torch.cuda.empty_cache()


def logits_gap(torch, a, b):
    """max |a - b|, max |b| and the share of rows whose argmax agrees."""
    a, b = a.float(), b.float()
    return ((a - b).abs().max().item(), b.abs().max().item(),
            (a.argmax(-1) == b.argmax(-1)).float().mean().item())


def ssm_full_width_check(torch):
    """Mamba2-2.7B at full width, random weights, one prefill (B=4, 512).

    bf16: the prefill through the kernel, each of its 64 launches held to
    ``ssd_ref`` on that launch's own inputs (the model's dt ~ 0.8 and
    A = -e, so cs falls to about -560 over a chunk) with the kernel's
    tolerances; its logits are printed beside the plain path's, and beside
    a control: the plain path against itself with half the chunk, the
    same function summed in another order. At this depth the bf16 model
    carries such rounding differences to the logits (the control alone
    moves them by about a third of max|logit|), so a bound on the bf16
    logits would gate the model, not the kernel. float32: the same prefill
    through the kernel and through its plain version, logits within
    PREFILL_REL_TOL of max|logit|."""
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.configs.runtime import RunConfig
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ssd_ref, ssd_scan
    from repro_torch.models.transformer import ApplyCtx, init_model_params, prefill
    from repro_torch.serving.engine import cast_for_compute

    cfg = get_config(SSM_ARCH)
    tok = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab, (4, 512), dtype=np.int32)).cuda()
    worst = []

    def held_to_plain(x, dt, A, Bm, Cm, *, chunk, initial_state=None):
        y, st = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, initial_state=initial_state)
        y_ref, s_ref = ssd_ref(x, dt, A, Bm, Cm, chunk, initial_state)
        y_tol, s_tol = ssd_tolerances(torch, y_ref, s_ref)
        worst.append(max((y.float() - y_ref.float()).abs().max().item() / y_tol,
                         (st - s_ref).abs().max().item() / s_tol))
        return y, st

    def half_chunk(x, dt, A, Bm, Cm, *, chunk, initial_state=None):
        return ssd_ref(x, dt, A, Bm, Cm, chunk // 2, initial_state)

    ctx = ApplyCtx(cfg, RunConfig(compute_dtype="bfloat16", use_kernels=True))
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = cast_for_compute(init_model_params(cfg, ctx.rcfg, gen, "cuda"), torch.bfloat16)
    with torch.inference_mode():
        with mock.patch.object(ssd_ops, "ssd_scan", held_to_plain):
            _, via_kernel = prefill(ctx, params, {"tokens": tok})
        with plain_route(SSM_ARCH):
            _, via_ref = prefill(ctx, params, {"tokens": tok})
        with mock.patch.object(ssd_ops, "ssd_scan", half_chunk):
            _, via_ref_half = prefill(ctx, params, {"tokens": tok})
    if via_kernel.shape != (4, 1, cfg.vocab) or not torch.isfinite(via_kernel).all():
        fail(f"full-width {SSM_ARCH} prefill logits: shape {tuple(via_kernel.shape)} "
             "or non-finite values")
    say(f"  full-width {SSM_ARCH} bf16 prefill (4x512): {len(worst)} ssd launches, each against "
        f"ssd_ref on its own inputs: worst error / tolerance {max(worst):.3g}")
    if len(worst) != cfg.n_layers or not max(worst) <= 1.0:
        fail(f"an ssd launch inside the full-width {SSM_ARCH} prefill disagrees with ssd_ref")
    err, scale, agree = logits_gap(torch, via_kernel, via_ref)
    c_err, _, c_agree = logits_gap(torch, via_ref_half, via_ref)
    say(f"  full-width {SSM_ARCH} bf16 logits: kernel vs plain max_abs_err {err:.4g} "
        f"(argmax agreement {agree:.2f}); control, plain with chunk 128 vs 256: {c_err:.4g} "
        f"({c_agree:.2f}); max|logit| {scale:.4g}")
    del params, via_kernel, via_ref, via_ref_half
    torch.cuda.empty_cache()

    ctx = ApplyCtx(cfg, RunConfig(compute_dtype="float32", use_kernels=True))
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_model_params(cfg, ctx.rcfg, gen, "cuda")
    with torch.inference_mode():
        _, via_kernel = prefill(ctx, params, {"tokens": tok})
        with plain_route(SSM_ARCH):
            _, via_ref = prefill(ctx, params, {"tokens": tok})
    if not torch.isfinite(via_kernel).all():
        fail(f"full-width {SSM_ARCH} fp32 prefill logits are not finite")
    err, scale, agree = logits_gap(torch, via_kernel, via_ref)
    say(f"  full-width {SSM_ARCH} fp32 prefill (4x512): max_abs_err {err:.4g} vs max|logit| "
        f"{scale:.4g} (rel tol {PREFILL_REL_TOL}), argmax agreement {agree:.2f}")
    if not err <= PREFILL_REL_TOL * scale:
        fail(f"full-width {SSM_ARCH} fp32 prefill through the kernel disagrees with ssd_ref")
    del params, via_kernel, via_ref
    torch.cuda.empty_cache()


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def serve_runs(torch, arch):
    """The main path of one model: ``serve()`` at full width at each
    concurrency of SERVE_ORDER, launch counts reset just before and read
    just after. Returns the counts."""
    from repro_torch.kernels import runtime
    from repro_torch.launch.serve import serve

    torch.cuda.reset_peak_memory_stats()
    runtime.reset_launch_counts()
    metrics = [serve(arch, **SERVE, concurrency=c, device="cuda") for c in SERVE_ORDER]
    counts = runtime.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for c, m in zip(SERVE_ORDER, metrics):
        say(f"  {arch} serve c={c}: {m['requests']} requests, {m['throughput_tok_s']:.2f} tok/s, "
            f"p50 {m['p50_latency_s']:.3f} s, p99 {m['p99_latency_s']:.3f} s")
        if m["requests"] != SERVE["requests"] or m["queue_depth"] != 0:
            fail(f"{arch} serve c={c} finished {m['requests']} of {SERVE['requests']} requests")
    prefills = len(metrics) * SERVE["requests"] // SERVE["batch"]
    say(f"  {arch} launches on its main path: {counts} over {prefills} prefills, "
        f"peak memory {peak_gb:.2f} GB")
    return counts, prefills


def phase_serve(torch):
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import build_engine
    from repro_torch.serving import measure_concurrency_curve

    flash_counts, _ = serve_runs(torch, ARCH)
    if flash_counts["flash_attention"] == 0:
        fail(f"flash_attention never launched on the {ARCH} main path")
    ssd_counts, prefills = serve_runs(torch, SSM_ARCH)
    per_prefill = get_config(SSM_ARCH).n_layers  # one launch per Mamba2 layer
    if ssd_counts["ssd_scan"] != per_prefill * prefills:
        fail(f"ssd_scan launched {ssd_counts['ssd_scan']} times on the {SSM_ARCH} main path, "
             f"not {per_prefill} per prefill over {prefills} prefills")
    missing = [k for k in ("flash_attention", "ssd_scan") if flash_counts[k] + ssd_counts[k] == 0]
    if missing:
        fail(f"kernels never launched on the serving paths: {missing}")

    batch = SERVE["batch"]
    engine = build_engine(ARCH, batch, 64 + 16 + 1, device="cuda")
    best, used = measure_concurrency_curve(
        engine, [1, 2, 4], rounds=2, min_rounds=2, prompt_len=64, new_tokens=16,
        groups=8, batch_size=batch, vocab=get_config(ARCH).vocab,
    )
    say(f"  {ARCH} tau vs concurrency (decode tok/s, best of "
        f"{used} interleaved rounds): " + ", ".join(f"c={c}: {t:.2f}" for c, t in best.items()))
    del engine
    retire_overlap_check(torch)
    return {"flash_attention": flash_counts["flash_attention"], "ssd_scan": ssd_counts["ssd_scan"]}


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
    return launches


def phase_profile(torch, arch):
    import numpy as np

    from repro_torch.launch.serve import build_engine

    engine = build_engine(arch, 4, 512 + 16, device="cuda")
    prompt = np.random.default_rng(2).integers(0, 1000, (4, 512), dtype=np.int32)
    state = {}

    def prefill():
        state["cache"], _ = engine.prefill(prompt)

    profile_window(torch, f"{arch} prefill 4x512", prefill, reps=3)
    tok = np.zeros((4, 1), np.int32)

    def decode():
        state["cache"]["length"] = 512  # re-decode the same slot: no cache growth
        engine.decode(state["cache"], tok)

    profile_window(torch, f"{arch} decode step (B=4, cache 528)", decode, reps=5)
    del engine, state
    torch.cuda.empty_cache()


def static_grid():
    from repro_torch.experiments import scenarios

    return scenarios.enumerate_cells(workloads=scenarios.FULL_MATRIX_WORKLOADS)


def held_to_record(rec, label):
    """Every cell of ``rec`` against the JAX package's committed record
    (configs, flags and counts exactly, floats at RECORD_REL), then the
    static summary."""
    from repro_torch.experiments import matrix

    want = json.loads(MATRIX_RECORD.read_text())
    if len(rec["cells"]) != len(want["cells"]):
        fail(f"{label}: {len(rec['cells'])} cells against {len(want['cells'])} in the record")
    diffs, apart = [], 0
    for got, ref in zip(rec["cells"], want["cells"]):
        d = matrix.diff_records(got, ref, rel=RECORD_REL)
        apart += bool(d)
        diffs += [f"{got['device']}/{got['model']}/{got['workload']}/{got['regime']}{x}" for x in d]
    diffs += ["summary" + x for x in matrix.diff_records(
        rec["summary"], {k: want["summary"][k] for k in rec["summary"]}, rel=RECORD_REL)]
    sm = rec["summary"]
    say(f"  {label}: {len(rec['cells']) - apart} of {len(rec['cells'])} cells equal "
        f"{MATRIX_RECORD.name} (floats at rel {RECORD_REL}); mean CORAL score "
        f"{sm['mean_coral_score']:.4f}, min single-target {sm['min_single_target_score']:.4f}, "
        f"dual power violations {sm['dual_power_violations']}, dual tau-miss cells "
        f"{sm['dual_tau_miss_cells']}")
    for x in diffs[:20]:
        say(f"    differs: {x}")
    if diffs:
        fail(f"{label}: the static grid does not reproduce {MATRIX_RECORD.name}")


def phase_coral_slice(torch):
    """(a) the 54 static cells x 3 seeds through ``run_matrix`` on the card,
    one batched call; (b) the same cells through the scalar spec, records
    identical to (a); (c) the ORACLE-scale analysis, dCor of the D knobs
    against (tau, p) over each cell's noise-free landscape, through the
    single-block kernel and held to its plain version. Launch counts are
    reset just before and read just after each part."""
    import numpy as np

    from repro_torch.core.coral import CORAL
    from repro_torch.experiments import matrix, scenarios
    from repro_torch.kernels import runtime
    from repro_torch.kernels.dcov import dcor_all_blocked, dcov_gram_ref
    from repro_torch.kernels.dcov.ref import dcor_from_sums

    cells = static_grid()
    iters = 10
    torch.cuda.synchronize()
    runtime.reset_launch_counts()
    t0 = time.perf_counter()
    batched = matrix.run_matrix(cells, iters=iters, device="cuda")
    wall = time.perf_counter() - t0
    counts = runtime.launch_counts()
    say(f"  (a) run_matrix, {len(cells)} cells x 3 seeds, batched on the card: {wall:.3f} s "
        f"(phases {json.dumps({k: round(v, 4) for k, v in batched['wall_clock_s'].items()})}), "
        f"launches {counts}")
    if counts["dcov"] != iters:
        fail(f"dcov launched {counts['dcov']} times in the batched call, not {iters} (one per step)")
    held_to_record(batched, "(a) batched")

    calls = [0]
    correlations = CORAL.correlations

    def counted(self):  # one launch per call with n >= 3 (the uniform branch launches none)
        calls[0] += min(self.epoch_n, self.window) >= 3
        return correlations(self)

    torch.cuda.synchronize()
    runtime.reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(CORAL, "correlations", counted):
        scalar = matrix.run_matrix(cells, iters=iters, engine="scalar", device="cuda")
    wall = time.perf_counter() - t0
    scalar_counts = runtime.launch_counts()
    apart = [d for a, b in zip(scalar["cells"], batched["cells"])
             for d in matrix.diff_records(a, b, rel=0.0)]
    say(f"  (b) run_matrix, scalar spec on the card: {wall:.3f} s, launches {scalar_counts} over "
        f"{calls[0]} correlations() calls with n >= 3; records equal to (a): {not apart}")
    if scalar_counts["dcov"] != calls[0] or calls[0] == 0:
        fail("the scalar spec's dcov launches do not match its correlations() calls")
    if apart:
        for x in apart[:20]:
            say(f"    differs: {x}")
        fail("the scalar spec's records differ from the batched engine's")

    torch.cuda.synchronize()
    runtime.reset_launch_counts()
    worst = 0.0
    for cell in cells:
        sim0 = scenarios.cell_simulator(cell, noise=0.0)
        land = np.stack(sim0.exact_all(), axis=1)
        knobs = torch.from_numpy(sim0.space.grid().astype(np.float32)).cuda()
        metrics = torch.from_numpy(land.astype(np.float32)).cuda()
        got = dcor_all_blocked(knobs, metrics)
        ref = dcov_gram_ref(torch.cat([knobs, metrics], dim=1))
        d = knobs.shape[1]
        diag = torch.diagonal(ref)
        want = dcor_from_sums(ref[:d, d:], diag[:d, None], diag[None, d:])
        if got.shape != (d, 2) or not torch.isfinite(got).all():
            fail(f"ORACLE-scale dCor of {cell}: shape {tuple(got.shape)} or non-finite values")
        worst = max(worst, (got - want).abs().max().item())
    oracle_counts = runtime.launch_counts()
    say(f"  (c) ORACLE-scale dCor over {len(cells)} landscapes (n = 1440 or 1600 rows, 5 knobs "
        f"against tau and p): max_abs_err {worst:.3g} against the plain version (tol "
        f"{DCOV_DCOR_ATOL}), launches {oracle_counts}")
    if not worst <= DCOV_DCOR_ATOL:
        fail("ORACLE-scale dCor through the kernel disagrees with its plain version")
    if oracle_counts["dcov"] != len(cells):
        fail(f"dcov launched {oracle_counts['dcov']} times in the ORACLE-scale analysis, "
             f"not {len(cells)}")
    return counts["dcov"]


def phase_coral_profile(torch):
    """One batched static call over the grid (tables built and moved, T
    steps on the card, float64 records on the host), and the single-block
    dcov form at ORACLE scale split into its three passes."""
    import numpy as np

    from repro_torch.core.episode import run_static_requests
    from repro_torch.experiments import matrix
    from repro_torch.kernels.dcov import dcov_gram

    reqs = [r for c in static_grid() for r in matrix._static_requests(matrix._prep_cell(c), (0, 1, 2))]
    launches = profile_window(
        torch, f"CORAL batched static call, {len(reqs)} episodes x 10 steps",
        lambda: run_static_requests(reqs, device="cuda"), reps=3)
    say(f"    {launches / 10:.1f} kernels per engine step")
    n_rows, c = DCOV_ORACLE
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=(n_rows, c)) * np.asarray(DCOV_SCALES[:c])
                          ).astype(np.float32)).cuda()
    profile_window(torch, f"dcov gram at ORACLE scale (n, C)={DCOV_ORACLE}",
                   lambda: dcov_gram(x), reps=20)


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
    kern = {"flash_attention": phase_flash_check(torch), "ssd_scan": phase_ssd_check(torch),
            "dcov": phase_dcov_check(torch)}
    say("== phase 3: slice check")
    phase_slice_check(torch, ARCH, 96)
    phase_slice_check(torch, SSM_ARCH, 93)
    counts = {"dcov": phase_coral_slice(torch)}
    say("== phase 4: serve")
    counts.update(phase_serve(torch))
    say("== phase 5: profile")
    phase_profile(torch, ARCH)
    phase_profile(torch, SSM_ARCH)
    phase_coral_profile(torch)
    say(f"== done in {time.perf_counter() - t0:.1f} s")
    sources = {
        "flash_attention": ("src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/flash_attention.py:26"),
        "ssd_scan": ("src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
                     "src/repro/kernels/ssd_scan/ssd_scan.py:28"),
        "dcov": ("src/repro_torch/kernels/dcov/csrc/dcov.cu",
                 "src/repro/kernels/dcov/dcov.py:67"),
    }
    unlaunched = [name for name in sources if counts[name] == 0]
    if unlaunched:
        fail(f"kernels never launched on their main paths: {unlaunched}")
    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": counts[name], **kern[name]}
        for name, (src, replaces) in sources.items()
    ]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
