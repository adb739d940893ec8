#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU, from the root of a checkout:

    python3 chip_smoke.py

Four main paths, each at full size through its kernels: Qwen2.5-3B served
at full width (prefill attention through ``flash_attention``), Mamba2-2.7B
served at full width (the SSD chunked scan through ``ssd_scan``), the
CORAL loop over the 54-cell x 3-seed static grid, the 6 drift cells and
the 6 fault cells (its windowed dCor through ``dcov``), and Hymba-1.5B
served at full width (attention and
Mamba2 heads side by side in every layer: ``flash_attention`` with a
1024-token window on 29 of its 32 layers and ``ssd_scan`` at N = 16).
Phases, each of which exits non-zero on failure:

1. Environment: the card's name and power limit, torch and CUDA versions;
   every kernel built from its source in the checkout (one nvcc each,
   started together), with its build time and ptxas report, and the full
   ptxas report (registers, shared memory, spills, warnings) of the flash
   kernel's wgmma body, of the SSD scan's three wgmma-body kernels (each
   at N = 128 and N = 16) and of
   the dcov single-block form's two kernels at C = 7 and 8 (a library
   built by an earlier run into build/ has no report to print).
2. Kernel check: each kernel against its plain version on the card over
   the CPU tests' sweep and its main path's shape, then the kernel's, the
   plain version's and (where one exists) a library call's device times
   at that shape, each call back to back behind a spin kernel.
   ``flash_attention_bhsd`` against ``attention_ref``, each case on the
   body ``body_for`` names (bf16 with D == Dv in {64, 128}: ``wgmma``),
   and timed at the serving shape (B=4, Hq=16, Hkv=2, S=512, D=128,
   causal, bf16; library: SDPA) on contiguous inputs and on the model's
   (B, S, H, D) views, at S=4096 (B=1) and at Hymba-1.5B's serving shape
   (B=4, Hq=25, Hkv=5, S=512, D=64), SDPA beside each as a yardstick;
   ``ssd_scan`` against
   ``ssd_ref`` in float32 and bfloat16, with a ragged tail, an initial
   state, 16 chunks at S=4096 and chunk 64 at S=1000, and the model's
   strided views at the full width, at N = 128 and at Hymba's N = 16
   (NH = 50, a ragged group of heads; 8 chunks at S=2048), each case on
   the body ``body_for`` names (bf16 at hd 64, N in {16, 128}: ``wgmma``;
   the bf16 error also in ulps of y), timed at the Mamba2 serving shape
   (B=4, S=512, NH=80, hd=64, N=128, chunk 256, bf16), at S=4096 (B=1)
   and at Hymba's (B=4, S=512, NH=50, N=16), there beside the simt body
   and with each of the wgmma body's three kernels' device time, the
   bound beside each (no library call computes the scan); ``dcov``'s
   windows form against
   ``dcov_gram_windows_ref`` over B in {1, 3, 162, 1024}, W in {3, 10,
   64}, C in {2, 7, 8} with n_valid from {1, 2, 3, W-1, W}, constant
   columns and zero rows, and bitwise batch independence; its
   single-block form against ``dcov_gram_ref`` over n up to 4099, and
   against its float64 version (normalised Gram within 1e-6 at every
   pair, dCor within 1e-4 where the float64 dCor is >= 1e-2) there and at
   n=16384, C=8 (float64 in row blocks), two runs bitwise equal (times at
   the grid shape B=162, W=10, C=7, with the windows kernel's own
   duration from the profiler, at n=1600, C=7 and at n=16384, C=8; no
   library call computes the Gram).
3. Slice check, per model: (a) the reduced model in float32 on the card,
   through the kernel, against the same model on the CPU (plain path,
   which the CPU tests hold to the JAX package); (b) the model at full
   width, random weights from a seeded ``torch.Generator``: one prefill
   (B=4, prompt 512) through the kernel against the same prefill with the
   model's call site of the kernel routed to its plain version. For
   Qwen2.5-3B in bf16, logits within 5e-2 × max|logit|, and all 36 flash
   launches of the prefill on the ``wgmma`` body. For Mamba2-2.7B,
   in bf16 every SSD launch of the prefill is held to ``ssd_ref`` on its
   own inputs and all 64 launches take the ``wgmma`` body, and the logits
   are printed beside a control (the plain path with half the chunk); in
   float32 the logits are held within
   5e-2 × max|logit| (``ssm_full_width_check`` says why). For Hymba-1.5B,
   (a) runs the reduced model with 4 layers (with ``reduced()``'s 2 both
   attend globally; with 4, one slides its window), and (b) a prefill of
   B=2 x 2048, the same way as Mamba2's: in bf16 each of its 32 SSD
   launches held to ``ssd_ref`` and each of its 32 flash launches to
   ``attention_ref`` on its own inputs, all on the ``wgmma`` bodies; in
   float32 the logits through both kernels against both call sites routed
   to the plain versions (``hybrid_full_width_check``). Then the CORAL
   slice (the main paths of ``dcov``): (a) ``run_matrix`` over the 54
   static cells x 3 seeds on the card as one batched call (10 dcov
   launches), each cell held to ``BENCH_matrix.json`` (configs, flags and
   counts exactly, floats at rel 1e-12) and its summary; (b) the same
   cells through the scalar spec, records identical (one launch per
   ``correlations()`` call with n >= 3); (c) dCor of each cell's
   noise-free landscape through the single-block form, held to its plain
   version and to its float64 version as in phase 2 (54 launches); (d)
   the 6 drift cells x 3 seeds x {adaptive, static} as one batched call
   (64 launches, one per interval) and (e) the 6 fault cells x 3 seeds x
   {hardened, ablation} as one batched call (40 launches; the ablation's
   windows hold NaN from dropped samples), each launch's Gram held bit
   for bit to the plain version on its own inputs, each cell to the
   record's ``drift_cells`` / ``fault_cells`` and the summary keys; (f)
   the 12 cells through the scalar spec, records identical to (d) and
   (e), launches equal to the counted ``correlations()`` calls.
4. Serve (the serving paths): ``serve()`` at full width, 16 requests,
   prompt 512, 32 new tokens, batch 4, at concurrency 1, then 2, with
   launch counts reset just before and read just after each model's runs;
   each model's kernels must have launched once per layer and prefill, on
   the ``wgmma`` bodies (Qwen2.5-3B: 36 flash; Mamba2-2.7B: 64 SSD;
   Hymba-1.5B: 32 flash and 32 SSD). For Qwen2.5-3B then the
   τ-vs-concurrency probe over c in
   {1, 2, 4} and the retire-overlap check: the real runtime over a
   stand-in engine whose steps take 10 ms of host work and a 10 ms spin
   kernel must serve at c=2 at least 1.3× its c=1 rate, which holds only
   if retire waits on its own slot alone.
5. Profile (after the counts are read): where a full-width prefill
   (B=4, prompt 512) and a decode step (B=4) of each model, and one
   batched CORAL call of each kind (static over the grid, drift over the
   6 drift cells, fault over the 6 fault cells), spend their time — wall
   time,
   device-busy time and kernel count from ``torch.profiler``, the idle
   share, and the heaviest kernels; every flash and SSD launch of the
   profiled prefills there on the ``wgmma`` bodies, one per layer (36 for
   Qwen, 64 for Mamba2, 32 of each for Hymba), with the device time of
   each of the SSD body's three kernels; the
   dcov single-block form at n=1600, C=7 and n=16384, C=8, with the
   device time of each of its two kernels, from a profiled window that
   holds every launch of both (redone up to PROFILE_TRIES times, else
   reported as not measured).
6. A ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}`` as
   the last line.

It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
ARCH = "qwen2.5-3b"
SSM_ARCH = "mamba2-2.7b"
HYBRID_ARCH = "hymba-1.5b"
HYBRID_REDUCED_LAYERS = 4  # reduced() has 2, both global; with 4, layer 1 slides a window
HYBRID_PREFILL = (2, 2048)  # the full-width check: windows of 1024 mask, 8 SSD chunks
SERVE_SHAPE = dict(b=4, hq=16, hkv=2, s=512, d=128, dv=128, causal=True, window=None)
SWEEP = [  # the card tests' sweep (tests/test_torch_kernels_gpu.py), then the serving shape
    dict(b=1, hq=2, hkv=2, s=64, d=32, dv=32, causal=True, window=None),
    dict(b=2, hq=4, hkv=2, s=96, d=32, dv=32, causal=True, window=None),
    dict(b=1, hq=4, hkv=1, s=128, d=16, dv=16, causal=True, window=24),
    dict(b=2, hq=2, hkv=2, s=80, d=32, dv=32, causal=False, window=None),
    dict(b=1, hq=8, hkv=2, s=72, d=64, dv=64, causal=True, window=16),
    dict(b=1, hq=4, hkv=2, s=70, d=32, dv=32, causal=True, window=None),
    dict(b=2, hq=4, hkv=2, s=48, d=32, dv=64, causal=True, window=None),
    dict(b=2, hq=16, hkv=2, s=300, d=128, dv=128, causal=True, window=None),
    dict(b=1, hq=25, hkv=5, s=1536, d=64, dv=64, causal=True, window=1024),
    dict(b=4, hq=25, hkv=5, s=512, d=64, dv=64, causal=True, window=1024),
    dict(b=2, hq=25, hkv=5, s=2048, d=64, dv=64, causal=True, window=1024),
    dict(b=1, hq=16, hkv=2, s=4096, d=128, dv=128, causal=True, window=None),
    dict(b=2, hq=4, hkv=2, s=200, d=128, dv=128, causal=False, window=None),
]
LONG_SHAPE = dict(b=1, hq=16, hkv=2, s=4096, d=128, dv=128, causal=True, window=None)
# Hymba-1.5B's prefill (B=4 x 512): its window of 1024 masks nothing at S = 512
HYMBA_FLASH = dict(b=4, hq=25, hkv=5, s=512, d=64, dv=64, causal=True, window=None)
# (b, s, nh, hd, n, chunk, initial state): the CPU tests' sweep
# (tests/test_torch_ssd_scan.py), a ragged tail, the reduced Mamba2,
# full-width heads (hd 64, N 128, the wgmma body in bf16), ragged, 16
# chunks at the full width (state passing), chunk 64 over 16 ragged chunks;
# then Hymba's N = 16: NH = 50 (a ragged group of two heads), two ragged
# chunks, chunk 64, 8 chunks with an initial state, 16 ragged chunks
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
    (1, 4096, 80, 64, 128, 256, True),
    (2, 1000, 8, 64, 128, 64, False),
    (4, 512, 50, 64, 16, 256, True),
    (1, 300, 4, 64, 16, 256, False),
    (2, 200, 3, 64, 16, 64, True),
    (1, 2048, 50, 64, 16, 256, True),
    (2, 1000, 50, 64, 16, 64, False),
]
SSD_SERVE = (4, 512, 80, 64, 128, 256, False)  # Mamba2-2.7B prefill, B=4 x 512
SSD_LONG = (1, 4096, 80, 64, 128, 256, False)  # a 4096-token Mamba2-2.7B prefill
SSD_HYMBA = (4, 512, 50, 64, 16, 256, False)  # Hymba-1.5B prefill, B=4 x 512
# the SSD wgmma body's kernels (ssd_scan.cu), in launch order
SSD_PHASES = ("ssd_chunk_states", "ssd_state_passing", "ssd_chunk_outputs")
# H100 SXM published peaks (dense): HBM bytes/s, bf16 tensor-core FLOP/s
PEAK_BYTES = 3.35e12
PEAK_BF16_FLOPS = 989e12
ATOL = {"float32": 2e-5, "bfloat16": 3e-2}
# a flash launch inside a model: the bf16 sweep's 3e-2 is for outputs of
# magnitude <= 2, so 1.5e-2 of max|out| where outputs are larger
FLASH_MODEL_REL = 1.5e-2
SPIN_CYCLES_PER_MS = 1_980_000  # >= 1 ms at the H100's top SM clock of 1.98 GHz
SPIN_MS_MIN = 30.0  # the shortest spin ahead of a timed round
SPIN_TRIES = 4  # rounds whose enqueue outran the spin, each redone with twice the spin
PROFILE_LEAD = 32  # spin kernels ahead of a profiled window's calls (see profiled_kernels)
PROFILE_PAUSE_S = 0.02  # host pause between the lead spins and a window's first call
PROFILE_TRIES = 3  # profiled windows, at most, until one holds every launch it must
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
# the single-block form against a float64 plain version: the normalised Gram
# <A_c,A_d> / sqrt(<A_c,A_c> <A_d,A_d>) (dCor^2 before the root) at every pair,
# and dCor wherever the float64 dCor is at least DCOV_DCOR_FLOOR. Near an exact
# zero dCor any float32 rounding of <A,B> shows under the square root (1e-8 in
# dCor^2 is 1e-4 in dCor), so there only the normalised Gram is held.
DCOV_NORM_ATOL = 1e-6
DCOV_DCOR64_ATOL = 1e-4
DCOV_DCOR_FLOOR = 1e-2
DCOV_ZERO = 1e-6  # a float64 dCor below this is an exact-zero pair
DCOV_LARGE = (16384, 8)  # timed beside DCOV_ORACLE; float64 plain version in row blocks
DCOV_PASSES = ("dcov_rowsum_kernel", "dcov_gram_kernel")  # the single-block form's kernels
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
    does not enter the time. The spin is sized from the host's own time to
    enqueue ``reps`` calls (hosts differ by up to 2x), and a round whose
    enqueue still outran it is redone with twice the spin; a time is kept
    only from a round the spin covered. Inputs stay warm in L2 between
    calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin_ms = max(SPIN_MS_MIN, 2.0 * host_ms)
    times = []
    for _ in range(rounds):
        for _ in range(SPIN_TRIES):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int(spin_ms * SPIN_CYCLES_PER_MS))
            t0 = time.perf_counter()
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            enqueue_ms = (time.perf_counter() - t0) * 1e3
            b.synchronize()
            if enqueue_ms <= spin_ms:
                break
            spin_ms *= 2.0
        else:
            fail(f"timing: the host took {enqueue_ms:.1f} ms to enqueue {reps} calls "
                 f"({host_ms:.1f} ms with no spin ahead), longer than a spin of "
                 f"{spin_ms / 2.0:.1f} ms covers, {SPIN_TRIES} times")
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
    for kernel, label, needles in (("flash_attention", "flash wgmma body", ("flash_fwd_wgmma",)),
                                   ("ssd_scan", "ssd wgmma body", SSD_PHASES),
                                   ("dcov", "dcov single-block form, C = 7 and 8",
                                    tuple(f"{k}ILi{c}E" for c in (7, 8) for k in DCOV_PASSES))):
        if kernel not in log:  # built by an earlier run into build/
            say(f"  {label}: library built by an earlier run, no ptxas report")
            continue
        say(f"  {label}, ptxas report:")
        for needle in needles:
            for line in ptxas_report(str(log[kernel]["log"]), needle):
                say(f"    {line}")


def ptxas_report(log, needle):
    """The ptxas lines of every entry function whose name holds ``needle``
    (from its "Compiling entry function" line to the next one), and every
    warning that names it."""
    out, inside = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            inside = needle in line
        if inside or ("warning" in line and needle in line):
            out.append(line.strip())
    return out


def flash_work(b, hq, hkv, s, d, dv, causal):
    """Bytes the function must move (q, k, v read once, the output written
    once, bf16) and its operations: 2 (D + Dv) per visible (query, key)
    pair, causal pairs only where causal."""
    pairs = s * (s + 1) // 2 if causal else s * s
    nbytes = 2 * (b * hq * s * d + b * hkv * s * (d + dv) + b * hq * s * dv)
    return nbytes, 2.0 * (d + dv) * pairs * b * hq


def flash_times(torch, q, k, v, label, causal=True):
    """The kernel's and SDPA's device times on the same (B, H, S, D) inputs,
    with the bound from their shapes; SDPA is a yardstick the port never
    calls."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import attention_ref, body_for, flash_attention_bhsd

    def sdpa():  # one library call computing the same function (GQA in SDPA)
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)

    ms = device_ms(lambda: flash_attention_bhsd(q, k, v, causal=causal))
    library_ms = device_ms(sdpa)
    lib_err = (sdpa().float() - attention_ref(q, k, v, causal=causal).float()).abs().max().item()
    b, hq, s, d = q.shape
    nbytes, flops = flash_work(b, hq, k.shape[1], s, d, v.shape[3], causal)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    say(f"  flash {label} ({body_for(q, k, v)} body): kernel {ms:.4f} ms, SDPA {library_ms:.4f} ms "
        f"(SDPA max_abs_err {lib_err:.3g}), bound {bound_ms:.5f} ms ({nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.2f} GFLOP), kernel / bound {ms / bound_ms:.2f}, kernel / SDPA "
        f"{ms / library_ms:.2f}")
    return {"ms": ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_flash_check(torch):
    from repro_torch.kernels.flash_attention import (
        attention_ref,
        body_for,
        body_launches,
        flash_attention_bhsd,
    )

    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for i, shp in enumerate(SWEEP + [SERVE_SHAPE]):
            kw = {k: shp[k] for k in ("causal", "window")}
            dims = {k: shp[k] for k in ("b", "hq", "hkv", "s", "d", "dv")}
            q, k, v = attention_inputs(torch, dtype, **dims, seed=i)
            body = body_for(q, k, v, kw["window"])
            want = ("simt" if dtype != torch.bfloat16 or dims["d"] != dims["dv"] else
                    "wgmma" if dims["d"] in (64, 128) else "mma")
            if body != want:
                fail(f"flash {shp} {dname}: body_for names {body}, not {want}")
            before = body_launches()[body]
            out = flash_attention_bhsd(q, k, v, **kw)
            ref = attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            if body_launches()[body] != before + 1:
                fail(f"flash kernel {shp} {dname}: the {body} body did not launch")
            if out.shape != ref.shape or out.dtype != ref.dtype:
                fail(f"flash kernel {shp} {dname}: shape/dtype {out.shape} {out.dtype}")
            err = (out.float() - ref.float()).abs().max().item()
            ok = err <= ATOL[dname]
            say(f"  flash {dname} {dims} {kw} ({body} body): max_abs_err {err:.3g} "
                f"(tol {ATOL[dname]}) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"flash kernel disagrees with attention_ref at {shp} {dname}")
            worst[(dname, i)] = err
            del q, k, v, out, ref
    torch.cuda.empty_cache()

    # times at the serving shape (bf16): contiguous, then the model's views
    s = SERVE_SHAPE
    dims = (s["b"], s["hq"], s["hkv"], s["s"], s["d"], s["dv"])
    q, k, v = attention_inputs(torch, torch.bfloat16, *dims, seed=len(SWEEP))
    plain_ms = device_ms(lambda: attention_ref(q, k, v, causal=True))
    say(f"  flash plain version at the serving shape: {plain_ms:.4f} ms")
    row = flash_times(torch, q, k, v, "serving shape, contiguous (B, H, S, D)")
    # the model's layout: (B, S, H, D) memory seen as (B, H, S, D)
    qm, km, vm = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    flash_times(torch, qm, km, vm, "serving shape, the model's (B, S, H, D) views")
    del q, k, v, qm, km, vm
    ls = LONG_SHAPE
    q, k, v = attention_inputs(torch, torch.bfloat16, ls["b"], ls["hq"], ls["hkv"], ls["s"],
                               ls["d"], ls["dv"], seed=len(SWEEP) + 1)
    flash_times(torch, q, k, v, f"S={ls['s']}, B={ls['b']}, contiguous")
    del q, k, v
    hs = HYMBA_FLASH
    q, k, v = attention_inputs(torch, torch.bfloat16, hs["b"], hs["hq"], hs["hkv"], hs["s"],
                               hs["d"], hs["dv"], seed=len(SWEEP) + 2)
    hymba_plain = device_ms(lambda: attention_ref(q, k, v, causal=True))
    say(f"  flash plain version at Hymba-1.5B's serving shape: {hymba_plain:.4f} ms")
    flash_times(torch, q, k, v, "Hymba-1.5B serving shape (B=4, Hq=25, Hkv=5, S=512, D=64; its "
                "window of 1024 masks nothing at S=512), contiguous")
    del q, k, v
    torch.cuda.empty_cache()
    return {"max_abs_err": worst[("bfloat16", len(SWEEP))], "plain_ms": plain_ms, **row}


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


def ssd_want_body(torch, x, Bm, Cm, chunk):
    """The body the SSD serving conditions call for: wgmma for bf16 at an
    (hd, N) the body is compiled for (``WGMMA_WIDTHS``), chunk % 64 == 0
    with 16-byte aligned rows, else simt."""
    from repro_torch.kernels.ssd_scan.ssd_scan import WGMMA_WIDTHS

    aligned = all(t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in t.stride()[:-1])
                  for t in (x, Bm, Cm))
    return ("wgmma" if x.dtype == torch.bfloat16 and (x.shape[-1], Bm.shape[-1]) in WGMMA_WIDTHS
            and chunk % 64 == 0 and aligned else "simt")


def bf16_ulps(torch, y, y_ref):
    """The bf16 values between y and y_ref, element by element: the
    distance of their bit patterns once mapped to a monotone integer
    scale (sign and magnitude to two's complement)."""
    def order(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return (order(y) - order(y_ref)).abs()


def ulps_note(torch, y, y_ref):
    """y's worst error in ulps of the bf16 y it lands on, at the element of
    the largest absolute error, and the share of elements more than one ulp
    apart (near zero an error that is small against max|y| spans many ulps,
    and a change of sign all the small values between)."""
    err = (y.float() - y_ref.float()).abs().flatten()
    at = err.argmax()
    ulps = bf16_ulps(torch, y, y_ref).flatten()
    return (f" = {ulps[at].item()} ulps of y at |y| {y_ref.float().abs().flatten()[at].item():.4g}"
            f" ({(ulps > 1).float().mean().item():.3%} of y more than 1 ulp apart)")


def ssd_held(torch, args, s0, chunk, label):
    """One ssd_scan call on the body body_for names, held to ssd_ref;
    returns y's max_abs_err. A bf16 y's error is also given in ulps."""
    from repro_torch.kernels.ssd_scan import ssd_ref, ssd_scan
    from repro_torch.kernels.ssd_scan.ssd_scan import body_for, body_launches

    x, _, _, Bm, Cm = args
    body = body_for(x, Bm, Cm, chunk)
    want = ssd_want_body(torch, x, Bm, Cm, chunk)
    if body != want:
        fail(f"ssd {label}: body_for names {body}, not {want}")
    before = body_launches()[body]
    y, st = ssd_scan(*args, chunk=chunk, initial_state=s0)
    y_ref, s_ref = ssd_ref(*args, chunk, s0)
    torch.cuda.synchronize()
    if body_launches()[body] != before + 1:
        fail(f"ssd kernel {label}: the {body} body did not launch")
    if (y.shape != y_ref.shape or y.dtype != y_ref.dtype or st.shape != s_ref.shape
            or st.dtype != torch.float32):
        fail(f"ssd kernel {label}: shape/dtype {y.shape} {y.dtype} {st.dtype}")
    y_err = (y.float() - y_ref.float()).abs().max().item()
    s_err = (st - s_ref).abs().max().item()
    y_tol, s_tol = ssd_tolerances(torch, y_ref, s_ref)
    ok = y_err <= y_tol and s_err <= s_tol
    ulps = ulps_note(torch, y, y_ref) if y.dtype == torch.bfloat16 else ""
    say(f"  ssd {label} ({body} body): y max_abs_err {y_err:.3g}{ulps} (tol {y_tol:.3g}), state "
        f"{s_err:.3g} (tol {s_tol:.3g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"ssd kernel disagrees with ssd_ref at {label}")
    return y_err


def ssd_views(torch, dtype, b, s, nh, hd, n, seed):
    """x, B and C as views of one (B, S, NH·hd + 2N) tensor, as the model's
    convolution output hands them in (row stride 5376 at Mamba2-2.7B's full
    width, 3232 at Hymba-1.5B's)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    di = nh * hd
    xbc = torch.from_numpy(rng.normal(size=(b, s, di + 2 * n)).astype(np.float32)).to("cuda", dtype)
    dt = torch.from_numpy(rng.uniform(0.01, 0.2, (b, s, nh)).astype(np.float32)).cuda()
    A = torch.from_numpy(-rng.uniform(0.5, 2, (nh,)).astype(np.float32)).cuda()
    return (xbc[..., :di].reshape(b, s, nh, hd), dt, A, xbc[..., di:di + n], xbc[..., di + n:])


def ssd_times(torch, args, chunk, label):
    """The kernel's and the plain version's device times, the bound from
    the shapes beside them."""
    from repro_torch.kernels.ssd_scan import ssd_ref, ssd_scan

    b, s, nh, hd = args[0].shape
    ms = device_ms(lambda: ssd_scan(*args, chunk=chunk))
    plain_ms = device_ms(lambda: ssd_ref(*args, chunk))
    nbytes, flops = ssd_work(b, s, nh, hd, args[3].shape[-1], chunk, 2, False)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    say(f"  ssd {label} (bf16): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library: none, "
        f"bound {bound_ms:.5f} ms ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), "
        f"kernel / bound {ms / bound_ms:.2f}")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_ssd_check(torch):
    serve_err = None
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for i, case in enumerate(SSD_SWEEP + [SSD_SERVE]):
            b, s, nh, hd, n, chunk, state = case
            args, s0 = ssd_inputs(torch, dtype, b, s, nh, hd, n, state, seed=i)
            err = ssd_held(torch, args, s0, chunk,
                           f"{dname} (b, s, nh, hd, n, chunk, state)={case}")
            if case is SSD_SERVE and dtype == torch.bfloat16:
                serve_err = err
            del args, s0
        # the models' strided views at the full width (row stride 5376, 3232)
        for case in (SSD_SERVE, SSD_HYMBA):
            b, s, nh, hd, n, chunk, _ = case
            ssd_held(torch, ssd_views(torch, dtype, 2, 300, nh, hd, n, seed=7), None, chunk,
                     f"{dname} model views (2, 300, {nh}, {hd}, {n}, {chunk})")
    torch.cuda.empty_cache()

    # times, bf16: the serving shape, its model views, and S = 4096
    b, s, nh, hd, n, chunk, state = SSD_SERVE
    args, _ = ssd_inputs(torch, torch.bfloat16, b, s, nh, hd, n, state, seed=len(SSD_SWEEP))
    row = ssd_times(torch, args, chunk, f"serving shape {SSD_SERVE[:6]}, contiguous")
    ssd_times(torch, ssd_views(torch, torch.bfloat16, b, s, nh, hd, n, seed=8), chunk,
              "serving shape, the model's views")
    del args
    b, s, nh, hd, n, chunk, state = SSD_LONG
    args, _ = ssd_inputs(torch, torch.bfloat16, b, s, nh, hd, n, state, seed=len(SSD_SWEEP) + 1)
    ssd_times(torch, args, chunk, f"S={s}, B={b}")
    del args
    ssd_hymba_times(torch)
    torch.cuda.empty_cache()
    return {"max_abs_err": serve_err, **row}


def ssd_hymba_times(torch):
    """At Hymba-1.5B's serving shape (N = 16), bf16: the kernel (wgmma
    body), its three kernels' own device times, the simt body on the same
    inputs (``body_for`` pointed at it), the plain version and the bound."""
    from repro_torch.kernels.ssd_scan import ssd_scan

    module = importlib.import_module("repro_torch.kernels.ssd_scan.ssd_scan")
    b, s, nh, hd, n, chunk, state = SSD_HYMBA
    args, _ = ssd_inputs(torch, torch.bfloat16, b, s, nh, hd, n, state, seed=len(SSD_SWEEP) + 2)
    row = ssd_times(torch, args, chunk, f"Hymba-1.5B serving shape {SSD_HYMBA[:6]}, contiguous "
                    f"({module.body_for(args[0], args[3], args[4], chunk)} body)")
    per = kernel_times(torch, lambda: ssd_scan(*args, chunk=chunk), SSD_PHASES)
    per = ("not measured" if per is None else
           ", ".join(f"{k} {t:.4f} ms" for k, t in sorted(per.items(), key=lambda kv: kv[0])))
    with mock.patch.object(module, "body_for", lambda *a: "simt"):
        simt_ms = device_ms(lambda: ssd_scan(*args, chunk=chunk))
    say(f"  ssd Hymba-1.5B serving shape: wgmma body {row['ms']:.4f} ms (its kernels: {per}), "
        f"simt body {simt_ms:.4f} ms, plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.5f} "
        f"ms; simt / wgmma {simt_ms / row['ms']:.2f}")
    b, s, nh, hd, n, chunk, _ = SSD_HYMBA
    ssd_times(torch, ssd_views(torch, torch.bfloat16, b, s, nh, hd, n, seed=9), chunk,
              "Hymba-1.5B serving shape, the model's views")


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


def dcov_block_inputs(torch, n_rows, c, seed):
    """An (n, C) block at CORAL's column scales."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_rows, c)) * np.asarray(DCOV_SCALES[:c]) + np.asarray(DCOV_SCALES[:c])
    return torch.from_numpy(x.astype(np.float32)).cuda()


def normalised_gram(torch, g, eps=1e-12):
    """<A_c,A_d> / sqrt(<A_c,A_c> <A_d,A_d>) in float64 (0 where a column is
    constant, as ``dcor_from_sums``): dCor^2 before the square root."""
    g = g.to(torch.float64)
    d = torch.diagonal(g).clamp_min(0.0).sqrt()
    den = d[:, None] * d[None, :]
    return torch.where(den < eps, 0.0, g / den.clamp_min(eps))


def dcov_against_f64(torch, gram, ref64, got_dcor=None, want_dcor=None):
    """The single-block Gram ``gram`` against its float64 plain version
    ``ref64``: the worst normalised-Gram gap over every pair, the worst dCor
    gap where the float64 dCor is at least DCOV_DCOR_FLOOR, and the largest
    dCor the kernel gives where the float64 dCor is below DCOV_ZERO, with
    the count of such pairs. dCor over every pair c != d of the Gram (the
    port's float32 ``dcor_from_sums`` on the kernel's Gram), or the given
    ``got_dcor`` against ``want_dcor``."""
    from repro_torch.kernels.dcov.ref import dcor_from_sums

    norm_err = (normalised_gram(torch, gram) - normalised_gram(torch, ref64)).abs().max().item()
    if got_dcor is None:
        def every_pair(g):
            diag = torch.diagonal(g)
            return dcor_from_sums(g, diag[:, None], diag[None, :])

        off = ~torch.eye(gram.shape[0], dtype=torch.bool, device=gram.device)
        got_dcor, want_dcor = every_pair(gram)[off], every_pair(ref64)[off]
    got_dcor = got_dcor.to(torch.float64)
    big, zero = want_dcor >= DCOV_DCOR_FLOOR, want_dcor < DCOV_ZERO
    dcor_err = (got_dcor - want_dcor).abs()[big].max().item() if big.any() else 0.0
    zero_worst = got_dcor[zero].max().item() if zero.any() else 0.0
    return norm_err, dcor_err, zero_worst, int(zero.sum().item())


def f64_ok(norm_err, dcor_err):
    return norm_err <= DCOV_NORM_ATOL and dcor_err <= DCOV_DCOR64_ATOL


def profiled_kernels(torch, fn, reps, per_call=None):
    """The device kernels of ``reps`` calls of ``fn`` under ``torch.profiler``,
    averaged by name (``key_averages``), the number of windows taken, and
    how many of the window's lead spin kernels the profiler kept. Late in a
    run of this script the profiler has kept none of a session's first few
    kernel records (up to ten, however long each was), so PROFILE_LEAD spin kernels go
    first and are left out of what is returned; the calls start
    PROFILE_PAUSE_S later. ``per_call`` maps a needle to the launches one
    call makes of each kernel whose name holds it: a window in which the
    profiler recorded another count of such a kernel is redone, up to
    PROFILE_TRIES windows. Returns None for the kernels if no window was
    complete."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for tries in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_LEAD):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAUSE_S)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        lead = sum(e.count for e in kern if "spin_kernel" in e.key)
        kern = [e for e in kern if "spin_kernel" not in e.key]
        if all(e.count == k * reps for needle, k in (per_call or {}).items()
               for e in kern if needle in e.key):
            return kern, tries, lead
    return None, PROFILE_TRIES, lead


def kernel_times(torch, fn, needles, reps=20):
    """Device ms per call of every kernel whose name holds one of
    ``needles`` (each launched once per call), keyed by the kernel's name,
    from ``torch.profiler``: the kernels' own durations, without the launch
    gaps that ``device_ms`` includes. None where no profiled window recorded
    every launch."""
    kern, _, _ = profiled_kernels(torch, fn, reps, per_call=dict.fromkeys(needles, 1))
    if kern is None:
        return None
    times = {}
    for e in kern:
        name = re.search("|".join(rf"\w*{re.escape(n)}\w*" for n in needles), e.key)
        if name:
            times[name[0]] = times.get(name[0], 0.0) + e.self_device_time_total / 1e3 / reps
    return times


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

    worst64 = [0.0, 0.0, 0.0]  # normalised Gram, dCor, dCor at the zero pairs
    for n_rows, c in DCOV_BLOCKS:
        x = dcov_block_inputs(torch, n_rows, c, seed=n_rows + c)
        gram, ref = dcov_gram(x), dcov_gram_ref(x)
        ref64 = dcov_gram_ref(x, dtype=torch.float64)
        torch.cuda.synchronize()
        scale = ref.abs().max().item()
        err = (gram - ref).abs().max().item()
        d = c - 1

        def dcor_of(g):
            diag = torch.diagonal(g)
            return dcor_from_sums(g[:d, d:], diag[:d, None], diag[None, d:])

        corr_err = (dcor_of(gram) - dcor_of(ref)).abs().max().item()
        norm_err, dcor_err, zero_worst, zeros = dcov_against_f64(torch, gram, ref64)
        worst64 = [max(a, b) for a, b in zip(worst64, (norm_err, dcor_err, zero_worst))]
        ok = err <= DCOV_GRAM_REL * scale and corr_err <= DCOV_DCOR_ATOL and f64_ok(norm_err, dcor_err)
        say(f"  dcov gram (n, C)={(n_rows, c)}: max_abs_err {err:.3g} at max|G| {scale:.3g} "
            f"(rel {err / scale:.3g}, tol {DCOV_GRAM_REL}), dCor {corr_err:.3g} "
            f"(tol {DCOV_DCOR_ATOL}); against float64: normalised Gram {norm_err:.3g} (tol "
            f"{DCOV_NORM_ATOL}), dCor {dcor_err:.3g} (tol {DCOV_DCOR64_ATOL} where >= "
            f"{DCOV_DCOR_FLOOR}), {zeros} zero pairs {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"dcov single-block kernel disagrees with its plain version at {(n_rows, c)}")
    say(f"  dcov gram over the sweep, against float64: worst normalised Gram {worst64[0]:.3g}, "
        f"worst dCor {worst64[1]:.3g} where the float64 dCor >= {DCOV_DCOR_FLOOR}, worst dCor "
        f"at the exact-zero pairs {worst64[2]:.3g}")

    # times: the windows form at the grid shape (the main path's launch)
    b, w, c = DCOV_GRID
    ms = device_ms(lambda: dcov_gram_windows(cols, n))
    own = kernel_times(torch, lambda: dcov_gram_windows(cols, n), ("dcov_windows_kernel",))
    own = "not measured" if own is None else f"{own['dcov_windows_kernel']:.4f} ms"
    plain_ms = device_ms(lambda: dcov_gram_windows_ref(cols, n))
    pairs = sum(k * (k + 1) // 2 for k in n.tolist())
    nbytes = 4 * (b * w * c + b + b * c * c)
    bound_ms, bound_by = dcov_bound(nbytes, pairs * dcov_pair_ops(c))
    say(f"  dcov windows at the grid shape {DCOV_GRID}: kernel {ms:.4f} ms (the kernel's own "
        f"duration in the profiler {own}), plain "
        f"{plain_ms:.4f} ms, library: none, bound {bound_ms:.6f} ms ({bound_by}; "
        f"{nbytes / 1e3:.1f} KB, {pairs * dcov_pair_ops(c) / 1e6:.3f} MFLOP)")
    # the single-block form at ORACLE scale, and at n = 16384 held to float64
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
    if not torch.equal(dcov_gram(x), dcov_gram(x)):
        fail(f"dcov single-block kernel at {DCOV_ORACLE}: two runs give different bits")
    n_rows, c = DCOV_LARGE
    x = dcov_block_inputs(torch, n_rows, c, seed=n_rows + c)
    gram = dcov_gram(x)
    again = dcov_gram(x)
    ref64 = dcov_gram_ref(x, dtype=torch.float64)
    norm_err, dcor_err, zero_worst, zeros = dcov_against_f64(torch, gram, ref64)
    same = torch.equal(gram, again)
    l_ms = device_ms(lambda: dcov_gram(x))
    l_ops = n_rows * (n_rows + 1) // 2 * dcov_pair_ops(c)
    l_bound, l_by = dcov_bound(4 * (n_rows * c + c * c), l_ops)
    ok = f64_ok(norm_err, dcor_err) and same and bool(torch.isfinite(gram).all())
    say(f"  dcov gram at (n, C)={DCOV_LARGE}: kernel {l_ms:.4f} ms, bound {l_bound:.5f} ms "
        f"({l_by}; {l_ops / 1e9:.3f} GFLOP), library: none; against float64: normalised Gram {norm_err:.3g} (tol {DCOV_NORM_ATOL}), dCor "
        f"{dcor_err:.3g} (tol {DCOV_DCOR64_ATOL}); two runs bitwise equal: {same} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"dcov single-block kernel at {DCOV_LARGE}: off its float64 plain version, "
             "non-finite, or not the same bits twice")
    del x, gram, again, ref64
    torch.cuda.empty_cache()
    return {
        "max_abs_err": grid_err,
        "ms": ms, "plain_ms": plain_ms, "library_ms": None,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def launches_per_prefill(arch):
    """(flash, SSD) launches one prefill of ``arch`` makes: one per
    attention layer and one per Mamba2 layer (a hybrid layer has both)."""
    from repro_torch.configs.registry import get_config

    cfg = get_config(arch)
    return (0 if cfg.arch_type == "ssm" else cfg.n_layers,
            cfg.n_layers if cfg.arch_type in ("ssm", "hybrid") else 0)


def plain_route(arch):
    """A context in which the model's call sites of its kernels (flash
    attention, the SSD scan, or both for a hybrid) are pointed at the
    kernels' plain versions: a comparison, not a fallback."""
    import contextlib

    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ssd_ref

    flash, ssd = launches_per_prefill(arch)
    stack = contextlib.ExitStack()
    if flash:
        stack.enter_context(mock.patch.object(fa_ops, "flash_attention_bhsd", attention_ref))
    if ssd:
        stack.enter_context(mock.patch.object(ssd_ops, "ssd_scan", ssd_ref))
    return stack


def reduced_config(arch):
    """The reduced model of ``arch`` the slice checks run: ``reduced()``,
    with HYBRID_REDUCED_LAYERS layers for the hybrid (module note)."""
    from repro_torch.configs.registry import get_config

    cfg = get_config(arch).reduced()
    if cfg.arch_type == "hybrid":
        cfg = dataclasses.replace(cfg, n_layers=HYBRID_REDUCED_LAYERS)
    return cfg


def phase_slice_check(torch, arch, reduced_len):
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.configs.runtime import RunConfig
    from repro_torch.kernels import runtime
    from repro_torch.models.transformer import ApplyCtx, init_model_params, prefill
    from repro_torch.serving.engine import cast_for_compute

    # (a) reduced, float32: the card's path (kernel) against the CPU's
    cfg = reduced_config(arch)
    ctx = ApplyCtx(cfg, RunConfig(compute_dtype="float32", use_kernels=True))
    params = init_model_params(cfg, ctx.rcfg, torch.Generator().manual_seed(0), "cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, reduced_len), dtype=np.int32)
    with torch.inference_mode():
        _, cpu = prefill(ctx, params, {"tokens": torch.from_numpy(tokens)})
        card_params = _to(params, "cuda")
        _, card = prefill(ctx, card_params, {"tokens": torch.from_numpy(tokens).cuda()})
    err = (card.cpu() - cpu).abs().max().item()
    say(f"  reduced {arch} ({cfg.n_layers} layers) fp32 prefill (2x{reduced_len}), card vs CPU: "
        f"max_abs_err {err:.3g} (tol {SLICE_FP32_TOL})")
    if not err <= SLICE_FP32_TOL:
        fail(f"reduced {arch} fp32 prefill on the card disagrees with the CPU path")

    if arch == SSM_ARCH:
        ssm_full_width_check(torch)
        return
    if arch == HYBRID_ARCH:
        hybrid_full_width_check(torch)
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
        runtime.reset_launch_counts()
        _, via_kernel = prefill(ctx, params, {"tokens": tok})
        check_bodies(arch, 1, f"the full-width {arch} prefill")
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


def check_bodies(arch, prefills, what):
    """Since the counts were reset, flash attention and the SSD scan each
    launched as often as ``prefills`` prefills of ``arch`` make
    (``launches_per_prefill``), every launch on its wgmma body."""
    from repro_torch.kernels import runtime
    from repro_torch.kernels.flash_attention import body_launches as flash_bodies
    from repro_torch.kernels.ssd_scan.ssd_scan import body_launches as ssd_bodies

    counts = runtime.launch_counts()
    for name, per, bodies in zip(("flash_attention", "ssd_scan"), launches_per_prefill(arch),
                                 (flash_bodies(), ssd_bodies())):
        want = per * prefills
        say(f"  {name} launches in {what}: {counts[name]} over {prefills} prefills, by body "
            f"{bodies}")
        if not counts[name] == bodies["wgmma"] == want:
            fail(f"{what}: {counts[name]} {name} launches, {bodies['wgmma']} on the wgmma body; "
                 f"want {want}, all on the wgmma body")


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
    from repro_torch.kernels import runtime
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
        runtime.reset_launch_counts()
        with mock.patch.object(ssd_ops, "ssd_scan", held_to_plain):
            _, via_kernel = prefill(ctx, params, {"tokens": tok})
        check_bodies(SSM_ARCH, 1, f"the full-width {SSM_ARCH} bf16 prefill")
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


def hybrid_full_width_check(torch):
    """Hymba-1.5B at full width, random weights, one prefill of
    HYBRID_PREFILL (B=2 x 2048: the 29 windowed layers mask keys older than
    1024, and the scan carries its state over 8 chunks of 256).

    bf16: the prefill through both kernels, each of its 32 SSD launches
    held to ``ssd_ref`` and each of its 32 flash launches to
    ``attention_ref`` on that launch's own inputs (flash within
    max(3e-2, FLASH_MODEL_REL x max|out|)), every launch on its wgmma
    body; the logits printed beside the plain route's and beside a
    control, the plain route with the SSD chunk halved. The bf16 model
    carries rounding differences to its logits as Mamba2's does
    (``ssm_full_width_check``), so the logits are held in float32: the
    same prefill through both kernels and through both call sites routed
    to the plain versions, within PREFILL_REL_TOL of max|logit|."""
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.configs.runtime import RunConfig
    from repro_torch.kernels import runtime
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention_bhsd
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ssd_ref, ssd_scan
    from repro_torch.models.transformer import ApplyCtx, init_model_params, prefill
    from repro_torch.serving.engine import cast_for_compute

    cfg = get_config(HYBRID_ARCH)
    b, s = HYBRID_PREFILL
    tok = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab, (b, s), dtype=np.int32)).cuda()
    ssd_worst, flash_worst, windows = [], [], []

    def ssd_held_to_plain(x, dt, A, Bm, Cm, *, chunk, initial_state=None):
        y, st = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, initial_state=initial_state)
        y_ref, s_ref = ssd_ref(x, dt, A, Bm, Cm, chunk, initial_state)
        y_tol, s_tol = ssd_tolerances(torch, y_ref, s_ref)
        ssd_worst.append(max((y.float() - y_ref.float()).abs().max().item() / y_tol,
                             (st - s_ref).abs().max().item() / s_tol))
        return y, st

    def flash_held_to_plain(q, k, v, *, causal=True, window=None):
        out = flash_attention_bhsd(q, k, v, causal=causal, window=window)
        ref = attention_ref(q, k, v, causal=causal, window=window).float()
        tol = max(ATOL["bfloat16"], FLASH_MODEL_REL * ref.abs().max().item())
        flash_worst.append((out.float() - ref).abs().max().item() / tol)
        windows.append(window)
        return out

    def half_chunk(x, dt, A, Bm, Cm, *, chunk, initial_state=None):
        return ssd_ref(x, dt, A, Bm, Cm, chunk // 2, initial_state)

    ctx = ApplyCtx(cfg, RunConfig(compute_dtype="bfloat16", use_kernels=True))
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = cast_for_compute(init_model_params(cfg, ctx.rcfg, gen, "cuda"), torch.bfloat16)
    with torch.inference_mode():
        runtime.reset_launch_counts()
        with mock.patch.object(ssd_ops, "ssd_scan", ssd_held_to_plain), \
                mock.patch.object(fa_ops, "flash_attention_bhsd", flash_held_to_plain):
            _, via_kernel = prefill(ctx, params, {"tokens": tok})
        check_bodies(HYBRID_ARCH, 1, f"the full-width {HYBRID_ARCH} bf16 prefill")
        with plain_route(HYBRID_ARCH):
            _, via_ref = prefill(ctx, params, {"tokens": tok})
            with mock.patch.object(ssd_ops, "ssd_scan", half_chunk):
                _, via_ref_half = prefill(ctx, params, {"tokens": tok})
    if via_kernel.shape != (b, 1, cfg.vocab) or not torch.isfinite(via_kernel).all():
        fail(f"full-width {HYBRID_ARCH} prefill logits: shape {tuple(via_kernel.shape)} "
             "or non-finite values")
    say(f"  full-width {HYBRID_ARCH} bf16 prefill ({b}x{s}): {len(ssd_worst)} ssd launches against "
        f"ssd_ref, worst error / tolerance {max(ssd_worst):.3g}; {len(flash_worst)} flash launches "
        f"({sum(w is not None for w in windows)} with window {cfg.sliding_window}) against "
        f"attention_ref, worst error / tolerance {max(flash_worst):.3g}")
    if len(ssd_worst) != cfg.n_layers or not max(ssd_worst) <= 1.0:
        fail(f"an ssd launch inside the full-width {HYBRID_ARCH} prefill disagrees with ssd_ref")
    if len(flash_worst) != cfg.n_layers or not max(flash_worst) <= 1.0:
        fail(f"a flash launch inside the full-width {HYBRID_ARCH} prefill disagrees with "
             "attention_ref")
    err, scale, agree = logits_gap(torch, via_kernel, via_ref)
    c_err, _, c_agree = logits_gap(torch, via_ref_half, via_ref)
    say(f"  full-width {HYBRID_ARCH} bf16 logits: kernels vs plain max_abs_err {err:.4g} "
        f"(argmax agreement {agree:.2f}); control, plain with SSD chunk "
        f"{cfg.ssm.chunk_size // 2} vs {cfg.ssm.chunk_size}: {c_err:.4g} "
        f"({c_agree:.2f}); max|logit| {scale:.4g}")
    del params, via_kernel, via_ref, via_ref_half
    torch.cuda.empty_cache()

    ctx = ApplyCtx(cfg, RunConfig(compute_dtype="float32", use_kernels=True))
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_model_params(cfg, ctx.rcfg, gen, "cuda")
    with torch.inference_mode():
        _, via_kernel = prefill(ctx, params, {"tokens": tok})
        with plain_route(HYBRID_ARCH):
            _, via_ref = prefill(ctx, params, {"tokens": tok})
    if not torch.isfinite(via_kernel).all():
        fail(f"full-width {HYBRID_ARCH} fp32 prefill logits are not finite")
    err, scale, agree = logits_gap(torch, via_kernel, via_ref)
    say(f"  full-width {HYBRID_ARCH} fp32 prefill ({b}x{s}): max_abs_err {err:.4g} vs max|logit| "
        f"{scale:.4g} (rel tol {PREFILL_REL_TOL}), argmax agreement {agree:.2f}")
    if not err <= PREFILL_REL_TOL * scale:
        fail(f"full-width {HYBRID_ARCH} fp32 prefill through the kernels disagrees with their "
             "plain versions")
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

    totals = dict.fromkeys(("flash_attention", "ssd_scan"), 0)
    for arch in (ARCH, SSM_ARCH, HYBRID_ARCH):
        counts, prefills = serve_runs(torch, arch)
        check_bodies(arch, prefills, f"the {arch} serve() runs")
        for name in totals:
            totals[name] += counts[name]
    missing = [k for k, n in totals.items() if n == 0]
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
    return totals


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


def profile_window(torch, label, fn, reps, named=(), per_call=None):
    """Wall and host-enqueue time of ``reps`` calls of ``fn`` (CUDA events,
    no profiler attached), then device-busy time, kernel count and the
    heaviest kernels from a second, profiled window (``profiled_kernels``:
    with ``per_call``, redone until it holds every launch of those kernels),
    and the device time per call of every kernel whose name holds one of
    ``named``."""
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
    kern, tries, lead = profiled_kernels(torch, fn, reps, per_call)
    kept = f"the profiler kept {lead} of its {PROFILE_LEAD} lead spin kernels"
    if kern is None:
        say(f"  {label}: wall {wall_ms:.3f} ms, host enqueue {host_ms:.3f} ms; device busy not "
            f"measured: none of {tries} profiled windows recorded every launch of {per_call} "
            f"({kept} in the last)")
        return float("nan")
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / reps
    launches = sum(e.count for e in kern) / reps
    idle = 1.0 - busy_ms / wall_ms if busy_ms > 0 else float("nan")
    say(f"  {label}: wall {wall_ms:.3f} ms, host enqueue {host_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms, idle share {idle:.3f}, {launches:.0f} kernels per call"
        + (f" (profiled window {tries} of at most {PROFILE_TRIES}: the first with every launch "
           f"of {per_call})" if per_call else "") + f"; {kept}")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:5]:
        say(f"    {e.self_device_time_total / 1e3 / reps:8.3f} ms  x{e.count / reps:<5.4g} "
            f"{e.key[:90]}")
    for needle in named:
        for e in kern:
            if needle in e.key:
                say(f"    {needle}: {e.self_device_time_total / 1e3 / reps:.4f} ms per call, "
                    f"{e.count / reps:.4g} launches per call, "
                    f"{e.self_device_time_total / max(e.count, 1):.2f} us each")
    return launches


def phase_profile(torch, arch):
    import numpy as np

    from repro_torch.kernels import runtime
    from repro_torch.launch.serve import build_engine

    engine = build_engine(arch, 4, 512 + 16, device="cuda")
    prompt = np.random.default_rng(2).integers(0, 1000, (4, 512), dtype=np.int32)
    state = {"prefills": 0}

    def prefill():
        state["cache"], _ = engine.prefill(prompt)
        state["prefills"] += 1

    runtime.reset_launch_counts()
    profile_window(torch, f"{arch} prefill 4x512", prefill, reps=3,
                   named=SSD_PHASES if launches_per_prefill(arch)[1] else ())
    check_bodies(arch, state["prefills"], f"the profiled {arch} prefills")
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


# the record's arrays the port runs, each with its summary keys
RECORD_FAMILIES = {
    "cells": ("n_cells", "mean_coral_score", "min_single_target_score",
              "dual_power_violations", "dual_tau_miss_cells"),
    "drift_cells": ("n_drift_cells", "min_drift_adaptive_score", "max_drift_static_score",
                    "min_drift_separation"),
    "fault_cells": ("n_fault_cells", "min_fault_hardened_score", "fault_power_violations",
                    "fault_feasible_ablations"),
}


def held_to_record(rec, label, family="cells"):
    """Every cell of ``rec[family]`` ("cells", "drift_cells" or
    "fault_cells") against the JAX package's committed record (configs,
    flags and counts exactly, floats at RECORD_REL), then that family's
    summary keys."""
    from repro_torch.experiments import matrix

    want = json.loads(MATRIX_RECORD.read_text())
    got_cells, want_cells = rec[family], want[family]
    if len(got_cells) != len(want_cells):
        fail(f"{label}: {len(got_cells)} {family} against {len(want_cells)} in the record")
    diffs, apart = [], 0
    for got, ref in zip(got_cells, want_cells):
        d = matrix.diff_records(got, ref, rel=RECORD_REL)
        apart += bool(d)
        diffs += [f"{got['device']}/{got['model']}/{got['workload']}/{got['regime']}{x}" for x in d]
    keys = RECORD_FAMILIES[family]
    summary = {k: rec["summary"][k] for k in keys}
    diffs += ["summary" + x for x in matrix.diff_records(
        summary, {k: want["summary"][k] for k in keys}, rel=RECORD_REL)]
    say(f"  {label}: {len(got_cells) - apart} of {len(got_cells)} {family} equal "
        f"{MATRIX_RECORD.name} (floats at rel {RECORD_REL}); summary {json.dumps(summary)}")
    for x in diffs[:20]:
        say(f"    differs: {x}")
    if diffs:
        fail(f"{label}: the port does not reproduce {MATRIX_RECORD.name} {family}")


def held_per_launch(torch, fn, label):
    """Run ``fn`` with every launch of the dcov windows kernel kept, then
    hold each launch's Gram against the plain version on its own inputs,
    bit for bit with NaN at the same places (the comparison launches no
    kernel of ours). Returns fn's result, the launches and whether a
    window held NaN in a valid row."""
    from repro_torch.core import dcov as core_dcov
    from repro_torch.kernels.dcov import dcov_gram_windows_ref

    kept, gram = [], core_dcov.dcov_gram_windows

    def keep(cols, n_valid):
        out = gram(cols, n_valid)
        kept.append((cols.clone(), n_valid.clone(), out))
        return out

    with mock.patch.object(core_dcov, "dcov_gram_windows", keep):
        out = fn()
    apart, nan_windows = 0, 0
    for cols, n_valid, got in kept:
        ref = dcov_gram_windows_ref(cols, n_valid)
        nan = torch.isnan(ref)
        apart += not (torch.equal(torch.isnan(got), nan) and torch.equal(got[~nan], ref[~nan]))
        rows = torch.arange(cols.shape[1], device=cols.device)[None, :] < n_valid[:, None]
        nan_windows += int((torch.isnan(cols).any(dim=2) & rows).any(dim=1).sum())
    shape = tuple(kept[0][0].shape) if kept else None
    say(f"  {label}: {len(kept)} windows-kernel launches at (B, W, C) = {shape}, "
        f"{len(kept) - apart} bitwise equal to the plain version on their own inputs "
        f"(NaN at the same places); {nan_windows} episode windows held NaN in a valid row")
    if apart:
        fail(f"{label}: {apart} dcov windows launches differ from the plain version")
    return out, len(kept), nan_windows


def phase_coral_slice(torch):
    """(a) the 54 static cells x 3 seeds through ``run_matrix`` on the card,
    one batched call; (b) the same cells through the scalar spec, records
    identical to (a); (c) the ORACLE-scale analysis, dCor of the D knobs
    against (tau, p) over each cell's noise-free landscape, through the
    single-block kernel and held to its plain version; (d) the 6 drift
    cells x 3 seeds x {adaptive, static}, one batched call of 64 steps;
    (e) the 6 fault cells x 3 seeds x {hardened, ablation}, one batched
    call of 40 steps; (f) the 12 cells of (d) and (e) through the scalar
    spec, records identical to theirs. Launch counts are reset just before
    and read just after each part; (d) and (e) hold every windows-kernel
    launch to its plain version on its own inputs. Returns the dcov
    launches of the three batched main paths, (a), (d) and (e)."""
    import numpy as np

    from repro_torch.core.coral import CORAL
    from repro_torch.experiments import matrix, scenarios
    from repro_torch.kernels import runtime
    from repro_torch.kernels.dcov import dcor_all_blocked, dcov_gram_ref
    from repro_torch.kernels.dcov import ops as dcov_ops
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

    grams, launch = [], dcov_ops.dcov_gram

    def kept(cols):  # the Gram of dcor_all_blocked's one launch, for the float64 checks
        grams.append(launch(cols))
        return grams[-1]

    torch.cuda.synchronize()
    runtime.reset_launch_counts()
    worst, worst64, zero_pairs = 0.0, [0.0, 0.0, 0.0], 0
    for cell in cells:
        sim0 = scenarios.cell_simulator(cell, noise=0.0)
        land = np.stack(sim0.exact_all(), axis=1)
        knobs = torch.from_numpy(sim0.space.grid().astype(np.float32)).cuda()
        metrics = torch.from_numpy(land.astype(np.float32)).cuda()
        with mock.patch.object(dcov_ops, "dcov_gram", kept):
            got = dcor_all_blocked(knobs, metrics)
        cols = torch.cat([knobs, metrics], dim=1)
        ref = dcov_gram_ref(cols)
        d = knobs.shape[1]
        diag = torch.diagonal(ref)
        want = dcor_from_sums(ref[:d, d:], diag[:d, None], diag[None, d:])
        if got.shape != (d, 2) or not torch.isfinite(got).all():
            fail(f"ORACLE-scale dCor of {cell}: shape {tuple(got.shape)} or non-finite values")
        worst = max(worst, (got - want).abs().max().item())
        ref64 = dcov_gram_ref(cols, dtype=torch.float64)
        diag64 = torch.diagonal(ref64)
        want64 = dcor_from_sums(ref64[:d, d:], diag64[:d, None], diag64[None, d:])
        norm_err, dcor_err, zero_worst, zeros = dcov_against_f64(
            torch, grams[-1], ref64, got.flatten(), want64.flatten())
        worst64 = [max(a, b) for a, b in zip(worst64, (norm_err, dcor_err, zero_worst))]
        zero_pairs += zeros
    oracle_counts = runtime.launch_counts()
    say(f"  (c) ORACLE-scale dCor over {len(cells)} landscapes (n = 1440 or 1600 rows, 5 knobs "
        f"against tau and p): max_abs_err {worst:.3g} against the plain version (tol "
        f"{DCOV_DCOR_ATOL}), launches {oracle_counts}; against float64: worst normalised Gram "
        f"{worst64[0]:.3g} over every pair (tol {DCOV_NORM_ATOL}), worst dCor {worst64[1]:.3g} "
        f"where the float64 dCor >= {DCOV_DCOR_FLOOR} (tol {DCOV_DCOR64_ATOL}), worst dCor "
        f"{worst64[2]:.3g} at the {zero_pairs} exact-zero pairs (float64 dCor < {DCOV_ZERO})")
    if not worst <= DCOV_DCOR_ATOL:
        fail("ORACLE-scale dCor through the kernel disagrees with its plain version")
    if not f64_ok(worst64[0], worst64[1]):
        fail("ORACLE-scale dCor through the kernel is off its float64 plain version")
    if oracle_counts["dcov"] != len(cells) or len(grams) != len(cells):
        fail(f"dcov launched {oracle_counts['dcov']} times in the ORACLE-scale analysis, "
             f"not {len(cells)}")

    main = {"static": counts["dcov"]}
    for part, family, steps, kw in (
        ("d", "drift_cells", scenarios.DRIFT_INTERVALS, dict(cells=list(scenarios.MATRIX_DRIFT_CELLS))),
        ("e", "fault_cells", scenarios.FAULT_INTERVALS,
         dict(cells=[], fault_cells=scenarios.MATRIX_FAULT_CELLS)),
    ):
        torch.cuda.synchronize()
        runtime.reset_launch_counts()
        t0 = time.perf_counter()
        rec, kept, nan_windows = held_per_launch(
            torch, lambda: matrix.run_matrix(**kw, device="cuda"), f"({part}) {family}")
        wall = time.perf_counter() - t0
        part_counts = runtime.launch_counts()
        n_eps = 6 * len(rec["seeds"]) * 2
        say(f"  ({part}) run_matrix, {len(rec[family])} {family} x 3 seeds x 2 variants "
            f"({n_eps} episodes), batched on the card: {wall:.3f} s (phases "
            f"{json.dumps({k: round(v, 4) for k, v in rec['wall_clock_s'].items() if v > 1e-3})}), "
            f"launches {part_counts}")
        if part_counts["dcov"] != steps or kept != steps:
            fail(f"dcov launched {part_counts['dcov']} times in the batched {family} call, "
                 f"not {steps} (one per step)")
        if family == "fault_cells" and nan_windows == 0:
            fail("no fault ablation window held NaN: the NaN path was not driven")
        held_to_record(rec, f"({part}) batched", family)
        main[family] = (part_counts["dcov"], rec)

    calls[0] = 0
    torch.cuda.synchronize()
    runtime.reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(CORAL, "correlations", counted):
        scalar = matrix.run_matrix(list(scenarios.MATRIX_DRIFT_CELLS),
                                   fault_cells=scenarios.MATRIX_FAULT_CELLS,
                                   engine="scalar", device="cuda")
    wall = time.perf_counter() - t0
    scalar_counts = runtime.launch_counts()
    apart = [f"{family}{d}" for family in ("drift_cells", "fault_cells")
             for d in matrix.diff_records(scalar[family], main[family][1][family], rel=0.0)]
    say(f"  (f) run_matrix, the 12 drift and fault cells through the scalar spec on the card: "
        f"{wall:.3f} s, launches {scalar_counts} over {calls[0]} correlations() calls with "
        f"n >= 3; records equal to (d) and (e): {not apart}")
    if scalar_counts["dcov"] != calls[0] or calls[0] == 0:
        fail("the scalar spec's dcov launches do not match its correlations() calls")
    if apart:
        for x in apart[:20]:
            say(f"    differs: {x}")
        fail("the scalar spec's drift and fault records differ from the batched engine's")
    total = main["static"] + main["drift_cells"][0] + main["fault_cells"][0]
    say(f"  dcov launches on the main paths: {total} (static {main['static']}, drift "
        f"{main['drift_cells'][0]}, fault {main['fault_cells'][0]})")
    return total


def phase_coral_profile(torch):
    """One batched static call over the grid, one batched drift call over
    the 6 drift cells and one batched fault call over the 6 fault cells
    (tables built and moved, T steps on the card, float64 records on the
    host), and the single-block dcov form at ORACLE scale and at n =
    16384, split into its two kernels."""
    import numpy as np

    from repro_torch.core.episode import (
        run_drift_requests,
        run_fault_requests,
        run_static_requests,
    )
    from repro_torch.experiments import matrix, scenarios
    from repro_torch.kernels.dcov import dcov_gram

    reqs = [r for c in static_grid() for r in matrix._static_requests(matrix._prep_cell(c), (0, 1, 2))]
    launches = profile_window(
        torch, f"CORAL batched static call, {len(reqs)} episodes x 10 steps",
        lambda: run_static_requests(reqs, device="cuda"), reps=3)
    say(f"    {launches / 10:.1f} kernels per engine step")
    seeds, steps = (0, 1, 2), scenarios.DRIFT_INTERVALS
    reqs = [r for c in scenarios.MATRIX_DRIFT_CELLS for a in (True, False)
            for r in matrix._drift_requests(matrix._prep_drift_cell(c, steps), seeds, a)]
    launches = profile_window(
        torch, f"CORAL batched drift call, {len(reqs)} episodes x {steps} steps",
        lambda: run_drift_requests(reqs, intervals=steps, device="cuda"), reps=3)
    say(f"    {launches / steps:.1f} kernels per engine step")
    steps = scenarios.FAULT_INTERVALS
    reqs = [r for c in scenarios.MATRIX_FAULT_CELLS for h in (True, False)
            for r in matrix._fault_requests(matrix._prep_fault_cell(c, steps, seeds), seeds, h)]
    launches = profile_window(
        torch, f"CORAL batched fault call, {len(reqs)} episodes x {steps} steps",
        lambda: run_fault_requests(reqs, iters=steps, device="cuda"), reps=3)
    say(f"    {launches / steps:.1f} kernels per engine step")
    n_rows, c = DCOV_ORACLE
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=(n_rows, c)) * np.asarray(DCOV_SCALES[:c])
                          ).astype(np.float32)).cuda()
    passes = dict.fromkeys(DCOV_PASSES, 1)
    profile_window(torch, f"dcov gram at ORACLE scale (n, C)={DCOV_ORACLE}",
                   lambda: dcov_gram(x), reps=100, named=DCOV_PASSES, per_call=passes)
    x = dcov_block_inputs(torch, *DCOV_LARGE, seed=sum(DCOV_LARGE))
    profile_window(torch, f"dcov gram at (n, C)={DCOV_LARGE}", lambda: dcov_gram(x), reps=20,
                   named=DCOV_PASSES, per_call=passes)


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
    phase_slice_check(torch, HYBRID_ARCH, 40)
    counts = {"dcov": phase_coral_slice(torch)}
    say("== phase 4: serve")
    counts.update(phase_serve(torch))
    say("== phase 5: profile")
    phase_profile(torch, ARCH)
    phase_profile(torch, SSM_ARCH)
    phase_profile(torch, HYBRID_ARCH)
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
