#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU, from the root of a checkout:

    python3 chip_smoke.py

Seven main paths, each at full size through its kernels (the fifth is
the serving control loop, CORAL tuning live Qwen2.5-3B traffic, phase 6;
the sixth, Moonlight-16B-A3B served at full width and depth and
DeepSeek-V2's MLA at full width, its depth cut to 2 layers, phases 3 and
4; the seventh, Whisper-medium's encoder-decoder path at full width and
depth through ``ServingEngine.generate`` with its encoder features, and
Qwen2-VL-72B's M-RoPE at full width, its depth cut to 8 layers, served
text-only by ``serve()``, phases 2–5):
Qwen2.5-3B served at full width (prefill attention through
``flash_attention``), Mamba2-2.7B
served at full width (the SSD chunked scan through ``ssd_scan``), the
CORAL loop over the 54-cell x 3-seed static grid, the 6 drift cells, the
6 fault cells, the 4 offload and 4 cotenant cells, and the 1024-twin fleet
of ``BENCH_fleet.json`` (its windowed dCor through ``dcov``), and Hymba-1.5B
served at full width (attention and
Mamba2 heads side by side in every layer: ``flash_attention`` with a
1024-token window on 29 of its 32 layers and ``ssd_scan`` at N = 16).
Moonlight's bf16 weights take 56.8 GB of the card's 80 (one tree at a
time: ``free_card`` checks before each is drawn), so the script needs a
card with ~60 GB free.
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
   body ``body_for`` names (bf16 with (D, Dv) in {(64, 64), (128, 128),
   (192, 128)}: ``wgmma``; MLA's widths also at S = 8, 32, 300, 2048,
   bidirectional and GQA), and timed at the serving shape (B=4, Hq=16,
   Hkv=2, S=512, D=128, causal, bf16; library: SDPA) on contiguous inputs
   and on the model's (B, S, H, D) views, at S=4096 (B=1), at
   Hymba-1.5B's serving shape (B=4, Hq=25, Hkv=5, S=512, D=64) and at
   DeepSeek-V2's MLA shape (B=4, H=128, S=512, D=192, Dv=128; contiguous
   and as the model's strided views, v the Dv half of the expanded
   latent, row stride H * 256: the ``wgmma`` and ``simt`` bodies each
   held to ``attention_ref``, then timed in turns), at Whisper-medium's
   encoder (B=4, H=16, S=1500, D=64, bidirectional), its cross attention
   (Sq=128 over Sk=1500, non-causal; Sq in {1, 64, 128, 200} at D = 64
   and 128 held to ``attention_ref`` first) and Qwen2-VL-72B's prefill
   (B=4, Hq=64, Hkv=8, S=512, D=128), SDPA beside each as a yardstick;
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
   columns and zero rows (then the offload and cotenant calls' (12, 10, 7)
   and the fleet's (1024, 12, 7) and (256, 12, 7)), and bitwise batch
   independence; its
   single-block form against ``dcov_gram_ref`` over n up to 4099, and
   against its float64 version (normalised Gram within 1e-6 at every
   pair, dCor within 1e-4 where the float64 dCor is >= 1e-2) there and at
   n=16384, C=8 (float64 in row blocks), two runs bitwise equal (times at
   the grid shape B=162, W=10, C=7, with the windows kernel's own
   duration from the profiler, at the joint grids' B=12 and the fleet's
   (1024, 12, 7), at n=1600, C=7 and at n=16384, C=8; no library call
   computes the Gram).
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
   to the plain versions (``hybrid_full_width_check``). Moonlight-16B-A3B
   (48 layers, the dense layer 0 and 47 MoE layers of 64 experts, top-6,
   2 shared) and DeepSeek-V2 (``DEPTH_CUT``: 2 layers, the dense layer 0
   and one MoE layer of 160 experts, MLA) as Qwen2.5-3B, weights drawn in
   bf16: (a) reduced in float32 card against CPU, (b) one 4 x 512 bf16
   prefill, every flash launch held to ``attention_ref`` on its own inputs
   (48 for Moonlight, 2 for DeepSeek-V2, all on the ``wgmma`` body, which
   ``flash_body`` must find ``body_for`` naming), logits within 5e-2 × max|logit| of
   the plain route (Qwen2.5-3B's prefill is held the same way, and so are
   Whisper-medium's, 4 x 128 with 1500 encoder frames of ``enc_feats``:
   72 launches, encoder, self and cross attention, and Qwen2-VL-72B's at
   8 layers, 4 x 512 with the first 256 positions ``vision_embeds``: 8
   launches; the stub inputs drawn at EXTRAS_STD); Moonlight
   over four prompts (``LOGIT_SEEDS``), each within ``LOGIT_REL_TOL`` ×
   max|logit| and their mean gap within ``CONTROL_RATIO`` × that of the
   plain route summed in other orders (the controls), and in float32
   compute within 5e-2 × max|logit| as well. Then the CORAL
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
   (e), launches equal to the counted ``correlations()`` calls; (g)-(i)
   the 4 offload and 4 cotenant cells the same way (24 and 40 launches);
   (j) the fleet: ``run_fleet`` over 1024 twins at ``BENCH_fleet.json``'s
   settings (30 steps, window 12) with the steady probe, exactly 30
   launches in each of its cold (B = 1024), steady (1024) and warm (256)
   calls, each held bit for bit to the plain version on its own inputs,
   the results block equal to the record's (on a mismatch, the keys and
   the first twin and step where the card's wave leaves the CPU's), and
   the engine block printed beside the card's name and power limit; (k)
   the lanes on the card: with ``REPRO_CONTRACTS=1`` and
   ``REPRO_CHECKIFY=1`` set in the process, the static grid, the drift
   cells, the offload and the cotenant cells (one batched call each) and
   the fleet's cold and warm calls at 1024 twins again, each record equal
   to the lane-off one of (a), (d), (g), (h) and (j) exactly, with the same
   dcov launches, each launch held bit for bit to the plain version; a
   fault cell and a static call over a NaN landscape (2 seeds, 9 steps)
   must raise ``SanitizeError``; then each batched call's wall time and
   kernels per step with the lanes off and on, in turns (off, on, on,
   off); the flags are unset afterwards; (l) the build-count guard: a
   second static call over the grid with other seeds builds nothing
   (``count_builds``: no staging, no nvcc, no capture); (m) the records:
   the card's matrix record, (a) with the families of (d), (e), (g) and
   (h) merged in, passes ``validate_matrix_record``, its
   ``markdown_report`` equals the committed ``BENCH_matrix.md`` byte for
   byte and its ``score_floors`` those of ``BENCH_matrix.json``; the fleet
   record of (j), wrapped as the reference's fleet bench wraps it, passes
   ``validate_fleet_record``.
4. Serve (the serving paths): ``serve()`` at full width, 16 requests,
   prompt 512, 32 new tokens, batch 4, at concurrency 1, then 2, with
   launch counts reset just before and read just after each model's runs;
   each model's kernels must have launched once per layer and prefill, on
   the bodies their shapes take (Qwen2.5-3B: 36 flash; Mamba2-2.7B: 64 SSD;
   Hymba-1.5B: 32 flash and 32 SSD; Moonlight-16B-A3B: 48 flash;
   Qwen2-VL-72B at 8 layers, text-only: 8 flash; all ``wgmma``), and
   each decode must have gone
   through the engine's CUDA graphs, one capture per pool entry (c entries
   at concurrency c), not one per step, counted by the build-count guard
   (``count_builds``'s ``capture:<model>``). Whisper-medium, which the runtime
   does not serve (it takes no encoder features, as the reference's does
   not), runs ``ServingEngine.generate`` (4 x 128, 32 new tokens, its
   ``enc_feats``) with its counts reset before and read after: 72 flash
   launches, one capture. Then, per model at full width (DeepSeek-V2 too,
   at 2 layers, Qwen2-VL-72B at 8), 16 greedy decode steps after one 4 x
   512 prefill (Whisper: 4 x 128) through the graph and through the eager
   step over the same weights: logits bitwise equal; for Whisper and
   Qwen2-VL with their stub inputs, and ``generate`` with them on both
   engines giving the same greedy tokens; the prefills' launches counted
   and checked by body.
   For Qwen2.5-3B then the τ-vs-concurrency probe over c in 1 ... 5
   (``tpu_pod_space``'s values), graphed and eager engines in turns,
   after one prefill at its prompt length (64) with every flash launch
   held to ``attention_ref``, and
   the retire-overlap check: the real runtime over a
   stand-in engine whose steps take 10 ms of host work and a 10 ms spin
   kernel must serve at c=2 at least 1.3× its c=1 rate, which holds only
   if retire waits on its own slot alone.
5. Profile (after the counts are read): where a full-width prefill
   (B=4, prompt 512) and a decode step (B=4; eager, then a replay of its
   CUDA graph) of each model, and one
   batched CORAL call of each kind (static over the grid, drift over the
   6 drift cells, fault over the 6 fault cells, offload and cotenant over
   their 4 cells, the fleet's cold call over 1024 twins), spend their
   time — wall time,
   device-busy time and kernel count from ``torch.profiler``, the idle
   share, and the heaviest kernels; every flash and SSD launch of the
   profiled prefills there on the ``wgmma`` bodies, one per layer (36 for
   Qwen, 64 for Mamba2, 32 of each for Hymba), with the device time of
   each of the SSD body's three kernels; Qwen2-VL-72B's (8 layers, its
   vision embeds) and Whisper-medium's (4 x 128, the encoder's 1500
   frames included) likewise; for Moonlight-16B-A3B the
   compute-all expert GEMMs (``moe._experts``) named by their kernels and
   timed per layer at 4 and 2048 tokens, and the decode step's
   weight-read bound; DeepSeek-V2's 2-layer prefill (4 x 512) under each
   flash body in turns (wgmma, simt, simt, wgmma: ``body_for`` pointed at
   simt for the simt turns), each turn's 2 launches a prefill on its
   body; the
   dcov single-block form at n=1600, C=7 and n=16384, C=8, with the
   device time of each of its two kernels, from a profiled window that
   holds every launch of both (redone up to PROFILE_TRIES times, else
   reported as not measured).
6. Control loop (``phase_control_loop``): full-width Qwen2.5-3B, decode
   through its graphs; ``run_coral`` over ``WalltimeDevice`` (the measured
   decode rate per concurrency level), then 10 intervals of 0.5 s of
   ``ServingController`` on a bursty trace at 0.6 x the measured capacity,
   every ``IntervalRecord`` printed, after one prefill at each of the
   phase's prompt lengths (8 and 32) with every flash launch held to
   ``attention_ref``; fails if an interval that starts with requests
   waiting admits no group, one that starts with a group in flight
   decodes no token (a group's latency is close to 0.5 s, so an interval
   may complete none), a released request is not served in full, or
   flash attention or dcov never launched in the phase. Power there is the reference's
   analytical model on its TPU v5e constants, not the H100's.
7. A ``{"kernels": [...]}`` line (launches: the main paths', the graph
   checks' prefills and the control loop's), then ``{"ok": true,
   "device": ...}`` as the last line.

It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import os
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
MOE_ARCH = "moonshot-v1-16b-a3b"  # 28.4 B parameters, 56.8 GB in bf16: full width and depth
MLA_ARCH = "deepseek-v2-236b"  # 471 GB in bf16: full width, depth cut (DEPTH_CUT)
VLM_ARCH = "qwen2-vl-72b"  # M-RoPE; 145 GB in bf16: full width, depth cut (DEPTH_CUT)
AUDIO_ARCH = "whisper-medium"  # encoder-decoder, 0.81 B parameters: full width and depth
# DeepSeek-V2: the dense layer 0 and one MoE layer of 160 experts, 5.4 B parameters;
# Qwen2-VL-72B: 8 of its 80 layers, 9.5 B parameters (0.878 B a layer, 2.49 B embedding + head)
DEPTH_CUT = {MLA_ARCH: 2, VLM_ARCH: 8}
# the decoder prompt of each model's full-width checks (Whisper's decoder context is 448)
PROMPT_LEN = {AUDIO_ARCH: 128}
# the stub front ends' inputs (``multimodal_extras``) at normal(0, 1): the reference's
# 0.02 would leave Whisper's encoder rows near-identical (its sinusoidal positions are the
# same in every row), and a kernel that mixed rows up would not show
EXTRAS_STD = 1.0
FULL_TREE_GB = 56.8  # one full-width Moonlight parameter tree in bf16; two do not fit the card
HYBRID_REDUCED_LAYERS = 4  # reduced() has 2, both global; with 4, layer 1 slides a window
HYBRID_PREFILL = (2, 2048)  # the full-width check: windows of 1024 mask, 8 SSD chunks
SERVE_SHAPE = dict(b=4, hq=16, hkv=2, s=512, d=128, dv=128, causal=True, window=None)
# DeepSeek-V2's MLA prefill (B=4 x 512): D = 128 + 64, Dv = 128, the wgmma body
MLA_FLASH = dict(b=4, hq=128, hkv=128, s=512, d=192, dv=128, causal=True, window=None)
# Whisper-medium's encoder (B=4 x 1500 frames, MHA, bidirectional: a 92-row tail in
# the query and the key tiles) and Qwen2-VL-72B's prefill (B=4 x 512, group 8)
WHISPER_FLASH = dict(b=4, hq=16, hkv=16, s=1500, d=64, dv=64, causal=False, window=None)
QWEN_VL_FLASH = dict(b=4, hq=64, hkv=8, s=512, d=128, dv=128, causal=True, window=None)
# Whisper's cross attention: the decoder's Sq queries over Sk = 1500 encoder frames,
# non-causal, Sq < Sk; (b, h, sq, sk, d): the card tests' cases, then the serving shape
CROSS_SWEEP = [(2, 16, sq, 1500, d) for sq in (1, 64, 128, 200) for d in (64, 128)]
WHISPER_CROSS = (4, 16, 128, 1500, 64)
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
    # Qwen2.5-3B at the prompts of the control loop's trace, of WalltimeDevice's
    # probe and of the tau probe: one query and one key tile (128) hold the prompt
    dict(b=4, hq=16, hkv=2, s=8, d=128, dv=128, causal=True, window=None),
    dict(b=4, hq=16, hkv=2, s=32, d=128, dv=128, causal=True, window=None),
    dict(b=4, hq=16, hkv=2, s=64, d=128, dv=128, causal=True, window=None),
    MLA_FLASH,
    # the MLA widths: one tile, mostly empty; ragged; bidirectional; 16 key
    # tiles through the ring of two stages; GQA
    dict(b=2, hq=8, hkv=8, s=8, d=192, dv=128, causal=True, window=None),
    dict(b=2, hq=8, hkv=8, s=32, d=192, dv=128, causal=True, window=None),
    dict(b=2, hq=8, hkv=8, s=300, d=192, dv=128, causal=True, window=None),
    dict(b=2, hq=8, hkv=8, s=200, d=192, dv=128, causal=False, window=None),
    dict(b=1, hq=8, hkv=8, s=2048, d=192, dv=128, causal=True, window=None),
    dict(b=2, hq=16, hkv=2, s=256, d=192, dv=128, causal=True, window=None),
    WHISPER_FLASH,
    QWEN_VL_FLASH,
]
# (D, Dv) pairs of the flash kernel's tensor-core bodies in bf16, with
# 16-byte aligned rows (flash_attention.py::body_for); the rest is simt
FLASH_WGMMA_DIMS = {(64, 64), (128, 128), (192, 128)}
FLASH_MMA_DIMS = {(16, 16), (32, 32)}
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
# Moonlight's full-width bf16 logits: 47 layers of top-6 routing turn a bf16
# rounding anywhere into a flipped expert, so a change of summation order
# alone (the controls, blocked_bhsd over CONTROL_TILES) moves its logits by
# up to a fifth of max|logit|. tools/moe_logit_spread.py read 3 weight x 4
# prompt seeds twice on an H100 (PERF.md section 6): the kernel's gap to the
# plain route 0.083-0.227 of max|logit|, the controls' 0.073-0.189, the
# kernel's mean over a weight seed's four prompts 1.13-1.27x the controls'.
# So its bf16 prefills run over LOGIT_SEEDS prompts, each held at
# LOGIT_REL_TOL x max|logit|, and their mean gap at CONTROL_RATIO x the
# controls' mean; each flash launch is held to attention_ref on its own
# inputs, and F32_LOGITS models are held at PREFILL_REL_TOL in float32
# compute as well
LOGIT_SEEDS = {MOE_ARCH: (1, 2, 3, 4)}
LOGIT_REL_TOL = {MOE_ARCH: 0.3}
CONTROL_TILES = (64, 128)
CONTROL_RATIO = 2.0
F32_LOGITS = (MOE_ARCH,)
SLICE_FP32_TOL = 1e-4  # reduced fp32 logits, card vs CPU
OVERLAP_MIN = 1.3  # tau(c=2) / tau(c=1) when host and card take 10 ms each
SERVE = dict(requests=16, prompt_len=512, new_tokens=32, batch=4)
SERVE_ORDER = (1, 2)  # concurrency of the successive serve() runs of each model
GRAPH_STEPS = 16  # greedy decode steps held bitwise, graphed against eager
# the tau-vs-concurrency probe (graphed and eager engines in turns): rounds, and
# each probe's workload (groups >= 2 x the largest c, the same at every c)
CURVE_ROUNDS = 2
CURVE_PROBE = dict(prompt_len=64, new_tokens=16, groups=10)
# the control-loop phase (examples/tune_serving.py's set-up): WalltimeDevice's
# probe, the run_coral iterations (tests/test_training_serving.py), and the
# controller's trace and intervals
LOOP_PROBE = dict(prompt_len=32, steps=8)
LOOP_CORAL_ITERS = 6
LOOP_INTERVALS, LOOP_INTERVAL_S, LOOP_PROMPT, LOOP_NEW_TOKENS = 10, 0.5, 8, 8
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
# dcov: the windows form's sweep (B, W, C) and grid shape, the single-block
# form's (n, C) and ORACLE shape; column scales of a CORAL window (five knob
# values, then tau and p, an eighth for C = 8), as tests/test_torch_kernels_gpu.py
DCOV_WINDOWS = [(b, w, c) for b in (1, 3, 162, 1024) for w in (3, 10, 64) for c in (2, 7, 8)]
DCOV_GRID = (162, 10, 7)  # 54 cells x 3 seeds, window 10, 5 knobs + (tau, p)
DCOV_JOINT = (12, 10, 7)  # 4 offload (or cotenant) cells x 3 seeds on their joint grids
DCOV_FLEET = (1024, 12, 7)  # the fleet's cold call: 1024 twins, window 12
DCOV_FLEET_WARM = (256, 12, 7)  # its warm call: every 4th twin
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
FLEET_RECORD = ROOT / "BENCH_fleet.json"  # the JAX package's committed fleet record
FLEET_RUN = dict(n_twins=1024, seed=0, iters=30, window=12)  # BENCH_fleet.json's settings
FLEET_CALLS = (("cold", 1024), ("steady", 1024), ("warm", 256))  # run_fleet's engine calls
LANES = ("REPRO_CONTRACTS", "REPRO_CHECKIFY")  # the engine's contract and NaN lanes
LANE_TURNS = (False, True, True, False)  # lanes off and on, in turns
NAN_CALL = dict(seeds=(0, 1), iters=9, window=6)  # the static call over a NaN landscape
FLEET_REGENERATE = ("PYTHONPATH=src python -c 'from repro_torch.experiments.fleet import "
                    "run_fleet; print(run_fleet(1024, seed=0, iters=30, window=12))'")


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


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def phase_environment(torch):
    from repro_torch.kernels import runtime

    say(card_line())
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


def flash_work(b, hq, hkv, s, d, dv, causal, sk=None):
    """Bytes the function must move (q, k, v read once, the output written
    once, bf16) and its operations: 2 (D + Dv) per visible (query, key)
    pair, causal pairs only where causal; ``sk`` keys (``s`` by default)
    for the ``s`` queries."""
    sk = s if sk is None else sk
    pairs = s * (s + 1) // 2 if causal else s * sk
    nbytes = 2 * (b * hq * s * d + b * hkv * sk * (d + dv) + b * hq * s * dv)
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
    nbytes, flops = flash_work(b, hq, k.shape[1], s, d, v.shape[3], causal, sk=k.shape[2])
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    say(f"  flash {label} ({body_for(q, k, v)} body): kernel {ms:.4f} ms, SDPA {library_ms:.4f} ms "
        f"(SDPA max_abs_err {lib_err:.3g}), bound {bound_ms:.5f} ms ({nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.2f} GFLOP), kernel / bound {ms / bound_ms:.2f}, kernel / SDPA "
        f"{ms / library_ms:.2f}")
    return {"ms": ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "body": body_for(q, k, v)}


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
            pair = (dims["d"], dims["dv"])
            want = ("simt" if dtype != torch.bfloat16 else "wgmma" if pair in FLASH_WGMMA_DIMS
                    else "mma" if pair in FLASH_MMA_DIMS else "simt")
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
    mla = mla_flash_times(torch)
    new_rows = {"whisper_encoder": shape_times(
                    torch, WHISPER_FLASH, len(SWEEP) + 5,
                    "Whisper-medium encoder (B=4, H=16, S=1500, D=64, bidirectional)"),
                "whisper_cross": cross_flash_check(torch),
                "qwen2_vl": shape_times(torch, QWEN_VL_FLASH, len(SWEEP) + 6,
                                        "Qwen2-VL-72B (B=4, Hq=64, Hkv=8, S=512, D=128)")}
    torch.cuda.empty_cache()
    return {"max_abs_err": worst[("bfloat16", len(SWEEP))], "plain_ms": plain_ms, **row,
            "mla": mla, **new_rows}


def shape_times(torch, shp, seed, label):
    """The plain version's, the kernel's and SDPA's device times at one
    (B, H, S, D) shape in bf16, contiguous, with the bound."""
    from repro_torch.kernels.flash_attention import attention_ref

    q, k, v = attention_inputs(torch, torch.bfloat16, shp["b"], shp["hq"], shp["hkv"], shp["s"],
                               shp["d"], shp["dv"], seed=seed)
    plain_ms = device_ms(lambda: attention_ref(q, k, v, causal=shp["causal"]))
    say(f"  flash plain version at the {label} shape: {plain_ms:.4f} ms")
    row = flash_times(torch, q, k, v, f"{label}, contiguous", causal=shp["causal"])
    return {**row, "plain_ms": plain_ms}


def cross_flash_check(torch):
    """Whisper's cross attention, non-causal with Sq < Sk = 1500: each
    CROSS_SWEEP case and the serving shape WHISPER_CROSS on the wgmma body
    against ``attention_ref``, then the times at the serving shape."""
    import numpy as np

    from repro_torch.kernels.flash_attention import (
        attention_ref,
        body_for,
        body_launches,
        flash_attention_bhsd,
    )

    for i, (b, h, sq, sk, d) in enumerate(CROSS_SWEEP + [WHISPER_CROSS]):
        rng = np.random.default_rng(100 + i)
        q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                   .to("cuda", torch.bfloat16)
                   for shape in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d)))
        body = body_for(q, k, v)
        before = body_launches()["wgmma"]
        out = flash_attention_bhsd(q, k, v, causal=False)
        torch.cuda.synchronize()
        err = (out.float() - attention_ref(q, k, v, causal=False).float()).abs().max().item()
        ok = body == "wgmma" and body_launches()["wgmma"] == before + 1 and \
            err <= ATOL["bfloat16"]
        say(f"  flash bf16 cross attention (B={b}, H={h}, Sq={sq}, Sk={sk}, D={d}, non-causal, "
            f"{body} body): max_abs_err {err:.3g} (tol {ATOL['bfloat16']}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"flash cross attention at Sq={sq}, Sk={sk}, D={d}: not on the wgmma body, no "
                 f"launch, or max_abs_err {err:.3g} against attention_ref")
    plain_ms = device_ms(lambda: attention_ref(q, k, v, causal=False))
    label = f"Whisper-medium cross attention (B={b}, H={h}, Sq={sq}, Sk={sk}, D={d})"
    say(f"  flash plain version at the {label} shape: {plain_ms:.4f} ms")
    row = flash_times(torch, q, k, v, f"{label}, contiguous", causal=False)
    return {**row, "plain_ms": plain_ms}


def mla_flash_times(torch):
    """DeepSeek-V2's MLA prefill shape (B=4, H=128, S=512, D=192, Dv=128,
    bf16, causal), on contiguous inputs and on the model's strided views
    (q and k concatenated, v the Dv half of the expanded (B, S, H, 256)
    latent, row stride H * 256): the wgmma body that ``body_for`` names
    and the simt body (``body_for`` pointed at it) each against
    ``attention_ref``, then the plain version's, SDPA's and the two
    bodies' times, the bodies in turns. Returns the contiguous row."""
    import numpy as np

    from repro_torch.kernels.flash_attention import (
        attention_ref,
        body_for,
        body_launches,
        flash_attention_bhsd,
    )

    module = importlib.import_module("repro_torch.kernels.flash_attention.flash_attention")
    m = MLA_FLASH
    b, h, s, d, dv = m["b"], m["hq"], m["s"], m["d"], m["dv"]
    q, k, v = attention_inputs(torch, torch.bfloat16, b, h, h, s, d, dv, seed=len(SWEEP) + 3)
    rng = np.random.default_rng(len(SWEEP) + 4)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to("cuda", torch.bfloat16)

    dr = 64  # qk_rope_head_dim: D = qk_nope (128) + dr
    kv = t(b, s, h, d - dr + dv)  # the expanded latent: k_nope and v per head
    k_nope, vm = kv.split([d - dr, dv], dim=-1)
    qm = t(b, s, h, d)
    km = torch.cat([k_nope, t(b, s, 1, dr).expand(b, s, h, dr)], dim=-1)
    qm, km, vm = (x.transpose(1, 2) for x in (qm, km, vm))
    for label, (x, y, z) in (("contiguous", (q, k, v)),
                             (f"the model's strided views (v row stride {vm.stride(2)})",
                              (qm, km, vm))):
        if body_for(x, y, z) != "wgmma":
            fail(f"flash at the MLA shape, {label}: body_for names {body_for(x, y, z)}, not wgmma")
        ref = attention_ref(x, y, z, causal=True).float()
        for body in ("wgmma", "simt"):
            with mock.patch.object(module, "body_for", lambda *a, _b=body: _b):
                before = body_launches()[body]
                out = flash_attention_bhsd(x, y, z, causal=True)
                torch.cuda.synchronize()
            err = (out.float() - ref).abs().max().item()
            ok = err <= ATOL["bfloat16"] and body_launches()[body] == before + 1
            say(f"  flash bf16 at the MLA shape, {label}, {body} body: max_abs_err {err:.3g} "
                f"(tol {ATOL['bfloat16']}) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"flash at the MLA shape, {label}: the {body} body did not launch or "
                     f"disagrees with attention_ref (max_abs_err {err:.3g})")
        del out, ref
    plain_ms = device_ms(lambda: attention_ref(q, k, v, causal=True))
    say(f"  flash plain version at DeepSeek-V2's MLA shape: {plain_ms:.4f} ms")
    row = flash_times(torch, q, k, v, "DeepSeek-V2 MLA shape (B=4, H=128, S=512, D=192, Dv=128), "
                      "contiguous")
    turns = bodies_in_turns(torch, module, q, k, v, "DeepSeek-V2 MLA shape, contiguous",
                            row["bound_ms"])
    flash_times(torch, qm, km, vm, "DeepSeek-V2 MLA shape, the model's strided views")
    bodies_in_turns(torch, module, qm, km, vm, "DeepSeek-V2 MLA shape, the model's strided views",
                    row["bound_ms"])
    del q, k, v, qm, km, vm, kv
    return {**row, "plain_ms": plain_ms, "simt_ms": min(turns["simt"])}


def bodies_in_turns(torch, module, q, k, v, label, bound_ms):
    """Device times of the flash kernel's wgmma and simt bodies on the same
    inputs, in turns (wgmma, simt, simt, wgmma), each launch on the body
    asked for; returns {body: [ms, ms]}."""
    from repro_torch.kernels.flash_attention import body_launches, flash_attention_bhsd

    times = {"wgmma": [], "simt": []}
    for body in ("wgmma", "simt", "simt", "wgmma"):
        with mock.patch.object(module, "body_for", lambda *a, _b=body: _b):
            before = body_launches()[body]
            times[body].append(device_ms(lambda: flash_attention_bhsd(q, k, v, causal=True)))
            if body_launches()[body] == before:
                fail(f"flash {label}: the {body} body did not launch")
    w, si = min(times["wgmma"]), min(times["simt"])
    say(f"  flash {label}, bodies in turns (wgmma, simt, simt, wgmma): wgmma "
        + " / ".join(f"{x:.4f}" for x in times["wgmma"]) + " ms, simt "
        + " / ".join(f"{x:.4f}" for x in times["simt"]) + f" ms; simt / wgmma {si / w:.1f}, "
        f"wgmma / bound {w / bound_ms:.2f}; {card_line()}")
    return times


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
    body = importlib.import_module("repro_torch.kernels.ssd_scan.ssd_scan").body_for(
        args[0], args[3], args[4], chunk)
    ssd_times(torch, ssd_views(torch, torch.bfloat16, b, s, nh, hd, n, seed=8), chunk,
              "serving shape, the model's views")
    del args
    b, s, nh, hd, n, chunk, state = SSD_LONG
    args, _ = ssd_inputs(torch, torch.bfloat16, b, s, nh, hd, n, state, seed=len(SSD_SWEEP) + 1)
    ssd_times(torch, args, chunk, f"S={s}, B={b}")
    del args
    ssd_hymba_times(torch)
    torch.cuda.empty_cache()
    return {"max_abs_err": serve_err, **row, "body": body}


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
    grid shape (B=162, W=10, C=7), at the joint grids' shape (B=12) and
    at ORACLE scale (n=1600, C=7)."""
    import numpy as np

    from repro_torch.kernels.dcov import (
        dcov_gram,
        dcov_gram_ref,
        dcov_gram_windows,
        dcov_gram_windows_ref,
    )
    from repro_torch.kernels.dcov.ref import dcor_from_sums

    # the joint grids' and the fleet's shapes last
    for i, (b, w, c) in enumerate(DCOV_WINDOWS + [DCOV_JOINT, DCOV_FLEET, DCOV_FLEET_WARM]):
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
    # and at the offload and cotenant calls' shape and the fleet's cold call's
    for k, (label, shape) in enumerate((("the joint grids' shape", DCOV_JOINT),
                                         ("the fleet's shape", DCOV_FLEET))):
        sb, sw, sc = shape
        scols, sn = dcov_windows_inputs(torch, sb, sw, sc, seed=len(DCOV_WINDOWS) + 1 + k)
        s_ms = device_ms(lambda: dcov_gram_windows(scols, sn))
        s_plain = device_ms(lambda: dcov_gram_windows_ref(scols, sn))
        s_ops = sum(v * (v + 1) // 2 for v in sn.tolist()) * dcov_pair_ops(sc)
        s_bytes = 4 * (sb * sw * sc + sb + sb * sc * sc)
        s_bound, s_by = dcov_bound(s_bytes, s_ops)
        say(f"  dcov windows at {label} {shape}: kernel {s_ms:.4f} ms, plain {s_plain:.4f} ms, "
            f"library: none, bound {s_bound:.6f} ms ({s_by}; {s_bytes / 1e3:.2f} KB, "
            f"{s_ops / 1e6:.4f} MFLOP)")
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
        "bound_ms": bound_ms, "bound_by": bound_by, "body": "windows form",
    }


def full_config(arch):
    """The full-width configuration of ``arch`` this script runs: every
    model at full depth but DeepSeek-V2 and Qwen2-VL-72B, cut to
    DEPTH_CUT layers."""
    from repro_torch.configs.registry import get_config

    cfg = get_config(arch)
    if arch in DEPTH_CUT:
        cfg = dataclasses.replace(cfg, n_layers=DEPTH_CUT[arch])
    return cfg


def launches_per_prefill(arch):
    """(flash, SSD) launches one prefill of ``arch`` (``full_config``) makes:
    one per attention layer, prologue included, and one per Mamba2 layer
    (a hybrid layer has both); an encoder-decoder model's encoder layers
    one each, its decoder layers two (self and cross attention)."""
    cfg = full_config(arch)
    flash = 0 if cfg.arch_type == "ssm" else cfg.n_layers
    if cfg.is_encoder_decoder:
        flash = 2 * cfg.n_layers + cfg.n_encoder_layers
    return flash, cfg.n_layers if cfg.arch_type in ("ssm", "hybrid") else 0


def prompt_len(arch):
    """The prompt of ``arch``'s full-width prefill checks (PROMPT_LEN)."""
    return PROMPT_LEN.get(arch, 512)


def model_batch(torch, cfg, seed, b, s, device="cuda"):
    """A prefill batch of ``cfg``'s model: (b, s) tokens from a numpy
    seed and the model's stub front-end inputs (``multimodal_extras`` at
    EXTRAS_STD, the same seed): Whisper's encoder features, Qwen2-VL's
    vision embeds, nothing for the others."""
    import numpy as np

    from repro_torch.launch.serve import multimodal_extras

    tok = np.random.default_rng(seed).integers(0, cfg.vocab, (b, s), dtype=np.int32)
    batch = {"tokens": torch.from_numpy(tok)}
    for name, a in multimodal_extras(cfg, b, seed, EXTRAS_STD).items():
        batch[name] = torch.from_numpy(a)
    return {name: t.to(device) for name, t in batch.items()}


def extras_of(batch):
    """The front-end inputs of a ``model_batch``, for an engine's
    ``prefill`` / ``generate``."""
    return {k: v for k, v in batch.items() if k != "tokens"} or None


def flash_body(torch, arch):
    """The flash body a bf16 prefill of ``arch`` (``full_config``) takes:
    ``body_for`` on empty tensors of its heads and head widths, laid out as
    the model's (B, S, H, D) views (MLA: H key heads, D = qk_nope + rope,
    Dv = v)."""
    from repro_torch.kernels.flash_attention import body_for

    cfg = full_config(arch)
    if cfg.mla is not None:
        hq = hkv = cfg.n_heads
        d, dv = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim, cfg.mla.v_head_dim
    else:
        hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        dv = d

    def view(h, width):
        return torch.empty(1, 1, h, width, dtype=torch.bfloat16, device="cuda").transpose(1, 2)

    return body_for(view(hq, d), view(hkv, d), view(hkv, dv))


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
    from repro_torch.configs.runtime import RunConfig
    from repro_torch.kernels import runtime
    from repro_torch.models.transformer import ApplyCtx, init_model_params, prefill
    from repro_torch.serving.engine import cast_for_compute

    # (a) reduced, float32: the card's path (kernel) against the CPU's
    cfg = reduced_config(arch)
    ctx = ApplyCtx(cfg, RunConfig(compute_dtype="float32", use_kernels=True))
    params = init_model_params(cfg, ctx.rcfg, torch.Generator().manual_seed(0), "cpu")
    batch = model_batch(torch, cfg, 0, 2, reduced_len, "cpu")
    with torch.inference_mode():
        _, cpu = prefill(ctx, params, batch)
        card_params = _to(params, "cuda")
        _, card = prefill(ctx, card_params, _to(batch, "cuda"))
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
    # (b) full width, bf16: through the kernel vs through its plain version;
    # the weights drawn in bf16 (Moonlight would take 113.6 GB in float32)
    cfg = full_config(arch)
    ctx = ApplyCtx(cfg, RunConfig(param_dtype="bfloat16", compute_dtype="bfloat16",
                                  use_kernels=True))
    gen = torch.Generator(device="cuda").manual_seed(0)
    free_card(torch, f"the full-width {arch} weights")
    params = cast_for_compute(init_model_params(cfg, ctx.rcfg, gen, "cuda"),
                              torch.bfloat16)
    seeds = LOGIT_SEEDS.get(arch, (1,))
    tol = LOGIT_REL_TOL.get(arch, PREFILL_REL_TOL)
    worst = []
    runtime.reset_launch_counts()
    reads, logits = bf16_logit_readings(torch, ctx, params, seeds, worst)
    check_bodies(arch, len(seeds), f"the full-width {arch} prefills")
    if logits.shape != (4, 1, cfg.vocab) or not torch.isfinite(logits).all():
        fail(f"full-width {arch} prefill logits: shape {tuple(logits.shape)} or non-finite values")
    s = prompt_len(arch)
    say(f"  full-width {arch} ({cfg.n_layers} layers{', depth cut' if arch in DEPTH_CUT else ''}) "
        f"bf16 prefills (4x{s}, prompt seeds {list(seeds)}{extras_note(cfg)}): {len(worst)} flash "
        f"launches on the {flash_body(torch, arch)} body, each against attention_ref on its own "
        f"inputs: worst error / tolerance {max(worst):.3g}")
    if len(worst) != launches_per_prefill(arch)[0] * len(seeds) or not max(worst) <= 1.0:
        fail(f"a flash launch inside the full-width {arch} prefill disagrees with attention_ref")
    for r in reads:
        say(f"  full-width {arch} bf16 prefill (4x{s}, prompt seed {r['seed']}): max_abs_err "
            f"{r['kernel']:.4g} vs max|logit| {r['scale']:.4g} (rel tol {tol}), argmax agreement "
            f"{r['agree']:.2f}; controls, the plain route summed in key tiles (blocked_bhsd): "
            + ", ".join(f"{t}: {e:.4g} ({g:.2f})" for t, (e, g) in r["controls"].items()))
    over = [r["seed"] for r in reads if not r["kernel"] <= tol * r["scale"]]
    if over:
        fail(f"full-width {arch} prefill through the kernel disagrees with its plain version "
             f"(prompt seeds {over})")
    if len(seeds) > 1:
        gap = sum(r["kernel"] / r["scale"] for r in reads) / len(reads)
        ctl = sum(e / r["scale"] for r in reads for e, _ in r["controls"].values()) / (
            len(reads) * len(CONTROL_TILES))
        say(f"  full-width {arch} bf16 prefills: mean gap {gap:.4g} of max|logit| through the "
            f"kernel, {ctl:.4g} through the controls (ratio {gap / ctl:.3g}, at most "
            f"{CONTROL_RATIO})")
        if not gap <= CONTROL_RATIO * ctl:
            fail(f"full-width {arch} prefills through the kernel move the logits {gap / ctl:.3g}x "
                 f"as far as a change of summation order does (at most {CONTROL_RATIO})")
    del logits
    if arch in F32_LOGITS:  # float32 compute over the same bf16 weights, widened at use
        ctx = ApplyCtx(cfg, RunConfig(param_dtype="bfloat16", compute_dtype="float32",
                                      use_kernels=True))
        batch = model_batch(torch, cfg, seeds[0], 4, s)
        with torch.inference_mode():
            _, via_kernel = prefill(ctx, params, batch)
            with plain_route(arch):
                _, via_ref = prefill(ctx, params, batch)
        if not torch.isfinite(via_kernel).all():
            fail(f"full-width {arch} fp32 prefill logits are not finite")
        err, scale, agree = logits_gap(torch, via_kernel, via_ref)
        say(f"  full-width {arch} fp32 prefill (4x{s}, bf16 weights): max_abs_err {err:.4g} vs "
            f"max|logit| {scale:.4g} (rel tol {PREFILL_REL_TOL}), argmax agreement {agree:.2f}")
        if not err <= PREFILL_REL_TOL * scale:
            fail(f"full-width {arch} fp32 prefill through the kernel disagrees with its plain "
                 "version")
        del via_kernel, via_ref
    del params
    torch.cuda.empty_cache()


def extras_note(cfg):
    """What a model's prefill takes beside its tokens, for the log."""
    if cfg.is_encoder_decoder:
        return f", enc_feats of {cfg.encoder_seq_len} frames through {cfg.n_encoder_layers} " \
               "encoder layers"
    if cfg.n_vision_tokens:
        return f", the first {cfg.n_vision_tokens} positions vision_embeds"
    return ""


def bf16_logit_readings(torch, ctx, params, seeds, worst):
    """One 4 x ``prompt_len`` prefill of ``ctx``'s model (full width, on
    the card; with its stub front-end inputs) per prompt seed: through the
    kernel, each flash launch held to
    ``attention_ref`` on its own inputs (its error / tolerance to
    ``worst``); through its plain version (``plain_route``); and through
    the plain route summed in key tiles of each of CONTROL_TILES
    (``blocked_bhsd``: the same function in other summation orders, a
    control for how far the model moves its logits on such a change
    alone). Returns, per seed, the kernel's max |logit gap| to the plain
    version, max|logit|, argmax agreement and each control's (gap,
    agreement); and the first seed's logits through the kernel."""
    import functools

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models.transformer import prefill

    reads, first = [], None
    for seed in seeds:
        batch = model_batch(torch, ctx.cfg, seed, 4, prompt_len(ctx.cfg.name))
        with torch.inference_mode():
            with mock.patch.object(fa_ops, "flash_attention_bhsd",
                                   flash_held_to_plain(torch, worst, [])):
                _, via_kernel = prefill(ctx, params, batch)
            with plain_route(ctx.cfg.name):
                _, via_ref = prefill(ctx, params, batch)
            controls = {}
            for tile in CONTROL_TILES:
                with mock.patch.object(fa_ops, "flash_attention_bhsd",
                                       functools.partial(blocked_bhsd, tile=tile)):
                    _, via_ctl = prefill(ctx, params, batch)
                err, _, agree = logits_gap(torch, via_ctl, via_ref)
                controls[tile] = (err, agree)
        err, scale, agree = logits_gap(torch, via_kernel, via_ref)
        reads.append({"seed": seed, "kernel": err, "scale": scale, "agree": agree,
                      "controls": controls})
        if first is None:
            first = via_kernel.float()
    return reads, first


def blocked_bhsd(q, k, v, *, causal=True, window=None, tile=128):
    """``attention_ref``'s function on (B, H, S, D) inputs summed in another
    order: the port's plain online-softmax path (``attention._blocked``)
    over ``tile``-key tiles. A control for the full-width logits: how far the
    bf16 model moves its logits for a change of summation order alone."""
    import math

    import torch

    from repro_torch.models import attention

    b, hq, s, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qg = q.transpose(1, 2).reshape(b, s, hkv, hq // hkv, d)
    q_pos = torch.arange(s, dtype=torch.int32, device=q.device).expand(b, s)
    kv_pos = torch.arange(sk, dtype=torch.int32, device=q.device).expand(b, sk)
    out = attention._blocked(qg, k.transpose(1, 2), v.transpose(1, 2), q_pos, kv_pos, causal,
                             window, 1.0 / math.sqrt(d), tile, tile)
    return out.reshape(b, s, hq, v.shape[-1]).transpose(1, 2)


def check_bodies(arch, prefills, what):
    """Since the counts were reset, flash attention and the SSD scan each
    launched as often as ``prefills`` prefills of ``arch`` make
    (``launches_per_prefill``), every launch on the wgmma body, which
    ``flash_body`` must name for the model's flash shapes (DeepSeek-V2's
    MLA at D = 192, Dv = 128 included)."""
    import torch

    from repro_torch.kernels import runtime
    from repro_torch.kernels.flash_attention import body_launches as flash_bodies
    from repro_torch.kernels.ssd_scan.ssd_scan import body_launches as ssd_bodies

    counts = runtime.launch_counts()
    for name, per, bodies, body in zip(("flash_attention", "ssd_scan"), launches_per_prefill(arch),
                                       (flash_bodies(), ssd_bodies()),
                                       (flash_body(torch, arch), "wgmma")):
        if per and body != "wgmma":
            fail(f"{what}: body_for names the {body} body for {arch}'s {name} launches; every "
                 "model's prefill takes the wgmma body")
        want = per * prefills
        say(f"  {name} launches in {what}: {counts[name]} over {prefills} prefills, by body "
            f"{bodies}")
        if not counts[name] == bodies[body] == want:
            fail(f"{what}: {counts[name]} {name} launches, {bodies[body]} on the {body} body; "
                 f"want {want}, all on the {body} body")


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


def flash_held_to_plain(torch, worst, windows):
    """A stand-in for ``flash_attention_bhsd`` inside a model: it launches
    the kernel and holds the output to ``attention_ref`` on the launch's
    own inputs, within max(3e-2, FLASH_MODEL_REL x max|out|); each
    launch's error / tolerance goes to ``worst``, its window to
    ``windows``."""
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention_bhsd

    def held(q, k, v, *, causal=True, window=None):
        out = flash_attention_bhsd(q, k, v, causal=causal, window=window)
        ref = attention_ref(q, k, v, causal=causal, window=window).float()
        tol = max(ATOL["bfloat16"], FLASH_MODEL_REL * ref.abs().max().item())
        worst.append((out.float() - ref).abs().max().item() / tol)
        windows.append(window)
        return out

    return held


def engine_prefills_held(torch, engine, prompt_lens, label):
    """One prefill of ``engine`` (full width, on the card) at each prompt
    length, every flash launch held to ``attention_ref`` on its own inputs
    (``flash_held_to_plain``): the shapes that ``label`` then launches the
    kernel at, uncounted. Fails on a mismatch or a missing launch."""
    import numpy as np

    from repro_torch.kernels.flash_attention import ops as fa_ops

    cfg = engine.ctx.cfg
    rng = np.random.default_rng(sum(prompt_lens))
    for s in prompt_lens:
        worst, windows = [], []
        prompt = rng.integers(0, cfg.vocab, (engine.batch, s), dtype=np.int32)
        with mock.patch.object(fa_ops, "flash_attention_bhsd",
                               flash_held_to_plain(torch, worst, windows)):
            engine.prefill(prompt)
        say(f"  {cfg.name} {engine.batch}x{s} prefill ({label}): {len(worst)} flash launches "
            f"against attention_ref, worst error / tolerance {max(worst, default=0):.3g}")
        if len(worst) != launches_per_prefill(cfg.name)[0] or not max(worst) <= 1.0:
            fail(f"a flash launch of a {engine.batch}x{s} {cfg.name} prefill ({label}) "
                 "disagrees with attention_ref, or one is missing")


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

    def half_chunk(x, dt, A, Bm, Cm, *, chunk, initial_state=None):
        return ssd_ref(x, dt, A, Bm, Cm, chunk // 2, initial_state)

    ctx = ApplyCtx(cfg, RunConfig(compute_dtype="bfloat16", use_kernels=True))
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = cast_for_compute(init_model_params(cfg, ctx.rcfg, gen, "cuda"), torch.bfloat16)
    with torch.inference_mode():
        runtime.reset_launch_counts()
        with mock.patch.object(ssd_ops, "ssd_scan", ssd_held_to_plain), \
                mock.patch.object(fa_ops, "flash_attention_bhsd",
                                  flash_held_to_plain(torch, flash_worst, windows)):
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


def free_card(torch, what):
    """Collect what earlier phases left (an engine in a reference cycle
    holds its weights until a collection) and check that no full-width
    parameter tree is still alive before ``what`` is made: two Moonlight
    trees (2 x FULL_TREE_GB) do not fit the card."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 1e9
    if held > FULL_TREE_GB / 2:
        fail(f"{held:.1f} GB still allocated on the card before {what}: an earlier "
             "parameter tree is alive")


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def captures_of(built):
    """The CUDA graph captures the build-count guard counted, all models."""
    return sum(1 for name in built.names if name.startswith("capture:"))


def serve_runs(torch, arch):
    """The main path of one model: ``serve()`` at full width at each
    concurrency of SERVE_ORDER, launch counts reset just before and read
    just after. Returns the counts."""
    from repro_torch.core.sanitize import count_builds
    from repro_torch.kernels import runtime
    from repro_torch.launch.serve import serve

    torch.cuda.reset_peak_memory_stats()
    runtime.reset_launch_counts()
    metrics = []
    with count_builds() as built:
        for c in SERVE_ORDER:
            free_card(torch, f"the {arch} serve() run at c={c}")
            metrics.append(serve(arch, **SERVE, concurrency=c, layers=DEPTH_CUT.get(arch),
                                 device="cuda"))
    counts = runtime.launch_counts()
    captures = captures_of(built)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for c, m in zip(SERVE_ORDER, metrics):
        say(f"  {arch} serve c={c}: {m['requests']} requests, {m['throughput_tok_s']:.2f} tok/s, "
            f"p50 {m['p50_latency_s']:.3f} s, p99 {m['p99_latency_s']:.3f} s; decode through "
            f"{m['graph_captures']} CUDA graph captures over {m['pool_entries']} pool entries")
        if m["requests"] != SERVE["requests"] or m["queue_depth"] != 0:
            fail(f"{arch} serve c={c} finished {m['requests']} of {SERVE['requests']} requests")
        if not m["graph_captures"] == m["pool_entries"] == c:
            fail(f"{arch} serve c={c}: {m['graph_captures']} graph captures over "
                 f"{m['pool_entries']} pool entries; want one capture per entry, {c} entries")
    if captures != sum(SERVE_ORDER):
        fail(f"{arch}: {captures} graph captures counted, want {sum(SERVE_ORDER)}")
    prefills = len(metrics) * SERVE["requests"] // SERVE["batch"]
    say(f"  {arch} launches on its main path: {counts} over {prefills} prefills, "
        f"peak memory {peak_gb:.2f} GB")
    return counts, prefills


def phase_serve(torch):
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import build_engine
    from repro_torch.serving import measure_concurrency_curve

    totals = dict.fromkeys(("flash_attention", "ssd_scan"), 0)
    for arch in (ARCH, SSM_ARCH, HYBRID_ARCH, MOE_ARCH, VLM_ARCH):
        counts, prefills = serve_runs(torch, arch)
        check_bodies(arch, prefills, f"the {arch} serve() runs")
        for name in totals:
            totals[name] += counts[name]
    counts = generate_run(torch, AUDIO_ARCH)
    for name in totals:
        totals[name] += counts[name]
    missing = [k for k, n in totals.items() if n == 0]
    if missing:
        fail(f"kernels never launched on the serving paths: {missing}")
    for arch in (ARCH, SSM_ARCH, HYBRID_ARCH, MOE_ARCH, MLA_ARCH, VLM_ARCH, AUDIO_ARCH):
        counts = graph_bitwise_check(torch, arch)
        for name in totals:
            totals[name] += counts[name]

    batch = SERVE["batch"]
    c_values = concurrency_values()
    engine = build_engine(ARCH, batch, CURVE_PROBE["prompt_len"] + CURVE_PROBE["new_tokens"] + 1,
                          device="cuda")
    engine_prefills_held(torch, engine, [CURVE_PROBE["prompt_len"]], "the tau probe")
    engines = {"graphed": engine, "eager": eager_twin(engine)}
    best = {name: dict.fromkeys(c_values, 0.0) for name in engines}
    t0 = time.perf_counter()
    for _ in range(CURVE_ROUNDS):  # graphed and eager in turns, each level once a round
        for name, eng in engines.items():
            curve, _ = measure_concurrency_curve(
                eng, c_values, rounds=1, min_rounds=1, batch_size=batch,
                vocab=get_config(ARCH).vocab, **CURVE_PROBE)
            best[name] = {c: max(best[name][c], curve[c]) for c in c_values}
    say(f"  {ARCH} tau vs concurrency (decode tok/s, B={batch}, prompt "
        f"{CURVE_PROBE['prompt_len']}, {CURVE_PROBE['new_tokens']} new tokens, "
        f"{CURVE_PROBE['groups']} groups; best of {CURVE_ROUNDS} rounds, graphed and eager in "
        f"turns; {time.perf_counter() - t0:.1f} s; {card_line()}):")
    for name, curve in best.items():
        say(f"    {name}: " + ", ".join(f"c={c}: {t:.2f}" for c, t in curve.items())
            + "; tau(c)/tau(1): " + ", ".join(f"{curve[c] / curve[c_values[0]]:.3f}"
                                               for c in c_values))
    say(json.dumps({"tau_vs_concurrency": {"concurrency": c_values, **{
        name: [curve[c] for c in c_values] for name, curve in best.items()}}}))
    del engine, engines
    torch.cuda.empty_cache()
    retire_overlap_check(torch)
    return totals


def generate_run(torch, arch):
    """The main path of an encoder-decoder model, which the runtime does
    not serve (it takes no encoder features): ``ServingEngine.generate``
    at full width, one 4 x PROMPT_LEN prompt with its encoder features,
    SERVE's new tokens, decode through the engine's CUDA graph; launch
    and capture counts reset just before and read just after. Returns
    the counts."""
    from repro_torch.core.sanitize import count_builds
    from repro_torch.kernels import runtime
    from repro_torch.launch.serve import build_engine

    free_card(torch, f"the {arch} generate() run")
    s, n = prompt_len(arch), SERVE["new_tokens"]
    engine = build_engine(arch, SERVE["batch"], s + n + 1, layers=DEPTH_CUT.get(arch),
                          device="cuda")
    batch = model_batch(torch, engine.ctx.cfg, 5, SERVE["batch"], s)
    torch.cuda.synchronize()
    runtime.reset_launch_counts()
    t0 = time.perf_counter()
    with count_builds() as built:
        out = engine.generate(batch["tokens"], n, extras_of(batch))
    wall = time.perf_counter() - t0
    counts = runtime.launch_counts()
    captures = captures_of(built)
    say(f"  {arch} generate (B={SERVE['batch']}, prompt {s}{extras_note(engine.ctx.cfg)}, {n} new "
        f"tokens): {wall:.3f} s, {out.size / wall:.2f} tok/s (the first call: the pool entry and "
        f"its graph capture included); {captures} capture over {len(engine.pool)} pool entry; "
        f"launches {counts}; {card_line()}")
    if out.shape != (SERVE["batch"], n) or not ((out >= 0) & (out < engine.ctx.cfg.vocab)).all():
        fail(f"{arch} generate returned {out.shape} tokens or ids out of the vocabulary")
    if not captures == len(engine.pool) == 1:
        fail(f"{arch} generate: {captures} graph captures over {len(engine.pool)} pool entries")
    check_bodies(arch, 1, f"the {arch} generate() run")
    del engine
    torch.cuda.empty_cache()
    return counts


def concurrency_values():
    """The concurrency knob's values in ``tpu_pod_space`` (1 ... 5)."""
    from repro_torch.core.space import tpu_pod_space

    space = tpu_pod_space()
    return [int(v) for v in space.dims[space.index("concurrency")].values]


def eager_twin(engine):
    """An engine over ``engine``'s weights whose decode step runs eagerly
    (no CUDA graph): the comparison, not a fallback."""
    from repro_torch.serving import ServingEngine

    return ServingEngine(engine.ctx, engine.params, engine.batch, engine.max_len, graphs=False)


def graph_bitwise_check(torch, arch):
    """``arch`` at full width (``full_config``): one prompt (B=4 x
    ``prompt_len``, with the model's stub front-end inputs) prefilled into
    a pool entry, then GRAPH_STEPS greedy decode steps through the
    engine's CUDA graph and through the eager step over the same weights
    (one parameter tree). The same kernels run in the same order, so every
    step's logits must be equal bit for bit, and the graphed engine must
    capture once. A model with front-end inputs then runs
    ``ServingEngine.generate`` with them on both engines, which must give
    the greedy tokens of those steps. The prefills go through the engine's
    entry point: their launches, counted from 0 and checked by body, are
    returned."""
    import numpy as np

    from repro_torch.core.sanitize import count_builds
    from repro_torch.kernels import runtime
    from repro_torch.launch.serve import build_engine

    free_card(torch, f"the {arch} graph check")
    with count_builds() as built:
        s = prompt_len(arch)
        graphed = build_engine(arch, 4, s + GRAPH_STEPS + 1, layers=DEPTH_CUT.get(arch),
                               device="cuda")
        eager = eager_twin(graphed)
        runtime.reset_launch_counts()
        batch = model_batch(torch, graphed.ctx.cfg, 4, 4, s)
        extras = extras_of(batch)
        steps, greedy = {}, {}
        for name, eng in (("eager", eager), ("graphed", graphed)):
            k = eng.acquire()
            cache, logits = eng.prefill(batch["tokens"], extras, entry=k)
            out, toks = [], []
            for _ in range(GRAPH_STEPS):
                tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
                toks.append(tok)
                cache, logits = eng.decode(cache, tok)
                out.append(logits.float())
            eng.release(k)
            steps[name] = torch.stack(out)
            greedy[name] = torch.cat(toks, dim=1).cpu().numpy()
        prefills = 2
        if extras:
            for name, eng in (("eager", eager), ("graphed", graphed)):
                gen = eng.generate(batch["tokens"], GRAPH_STEPS, extras)
                prefills += 1
                if not np.array_equal(gen, greedy[name]):
                    fail(f"{arch}: ServingEngine.generate ({name}) with {sorted(extras)} "
                         "gives other tokens than the same greedy steps taken one by one")
            say(f"  {arch} ServingEngine.generate with {sorted(extras)}, graphed and eager: the "
                f"{GRAPH_STEPS} greedy tokens of the step-by-step decode")
    counts = runtime.launch_counts()
    check_bodies(arch, prefills, f"the {arch} graph check's prefills")
    a, b = steps["graphed"], steps["eager"]
    if not torch.isfinite(b).all():
        fail(f"{arch}: the eager decode steps' logits are not finite")
    same = torch.equal(a, b)
    captures = captures_of(built)
    say(f"  {arch} decode, {GRAPH_STEPS} greedy steps after a 4x{s} prefill: graphed vs eager "
        f"logits bitwise equal: {same} (max |diff| {(a - b).abs().max().item():.3g}), "
        f"{captures} capture over {len(graphed.pool)} pool entry")
    if not (same and captures == len(graphed.pool) == 1):
        fail(f"{arch}: the graphed decode step differs from the eager one, or captured "
             f"{captures} graphs for {len(graphed.pool)} pool entries")
    del graphed, eager, steps
    torch.cuda.empty_cache()
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

    def reserve(self, n):
        pass

    def acquire(self):
        return 0

    def release(self, entry):
        pass

    def prefill(self, tokens, entry=None):
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

    from repro_torch.launch.serve import multimodal_extras

    free_card(torch, f"the {arch} profile")
    s = prompt_len(arch)
    engine = build_engine(arch, 4, s + 16, layers=DEPTH_CUT.get(arch), device="cuda")
    prompt = np.random.default_rng(2).integers(0, 1000, (4, s), dtype=np.int32)
    extras = multimodal_extras(engine.ctx.cfg, 4, 2, EXTRAS_STD) or None
    state = {"prefills": 0}

    def prefill():
        state["cache"], _ = engine.prefill(prompt, extras)
        state["prefills"] += 1

    runtime.reset_launch_counts()
    profile_window(torch, f"{arch} prefill 4x{s}{extras_note(engine.ctx.cfg)}", prefill, reps=3,
                   named=SSD_PHASES if launches_per_prefill(arch)[1] else ())
    check_bodies(arch, state["prefills"], f"the profiled {arch} prefills")
    tok = np.zeros((4, 1), np.int32)
    for name, eng in (("eager", eager_twin(engine)), ("graphed", engine)):
        k = eng.acquire()
        cache, _ = eng.prefill(prompt, extras, entry=k)

        def decode():
            with torch.inference_mode():  # re-decode the same slot: no cache growth
                cache["length"].fill_(s)  # on the card, no host read
            eng.decode(cache, tok)

        profile_window(torch, f"{arch} decode step {name} (B=4, cache {s + 16})", decode, reps=5)
        eng.release(k)
    if engine.ctx.cfg.moe is not None:
        moe_step_costs(torch, engine)
    del engine, state
    torch.cuda.empty_cache()


def phase_profile_mla_bodies(torch):
    """DeepSeek-V2 (``DEPTH_CUT`` layers) 4 x 512 bf16 prefill under each
    flash body, in turns (wgmma, simt, simt, wgmma): wall, host enqueue,
    device busy, idle share and kernels per call (``profile_window``).
    The wgmma turns take the body ``body_for`` names; the simt turns point
    ``body_for`` at the simt body. Fails unless every flash launch of a
    turn, one a layer and prefill, is on its body."""
    import contextlib

    import numpy as np

    from repro_torch.kernels import runtime
    from repro_torch.kernels.flash_attention import body_launches
    from repro_torch.launch.serve import build_engine

    module = importlib.import_module("repro_torch.kernels.flash_attention.flash_attention")
    free_card(torch, f"the {MLA_ARCH} prefill profile")
    engine = build_engine(MLA_ARCH, 4, 512 + 16, layers=DEPTH_CUT[MLA_ARCH], device="cuda")
    prompt = np.random.default_rng(2).integers(0, 1000, (4, 512), dtype=np.int32)
    state = {"prefills": 0}

    def prefill():
        engine.prefill(prompt)
        state["prefills"] += 1

    per = launches_per_prefill(MLA_ARCH)[0]
    for body in ("wgmma", "simt", "simt", "wgmma"):
        runtime.reset_launch_counts()
        state["prefills"] = 0
        forced = (mock.patch.object(module, "body_for", lambda *a: "simt") if body == "simt"
                  else contextlib.nullcontext())
        with forced:
            profile_window(torch, f"{MLA_ARCH} prefill 4x512, flash {body} body", prefill, reps=3)
        n, on = runtime.launch_counts()["flash_attention"], body_launches()[body]
        if not n == on == per * state["prefills"]:
            fail(f"{MLA_ARCH} prefills on the {body} body: {n} flash launches, {on} on that "
                 f"body; want {per * state['prefills']}")
    say(f"  {MLA_ARCH} prefills: every flash launch on the body of its turn; {card_line()}")
    del engine, state
    torch.cuda.empty_cache()


def moe_step_costs(torch, engine):
    """Where an MoE model's time goes beside the profile: the compute-all
    expert GEMMs (``models/moe.py::_experts``: gate, up and down over every
    expert for every token) named by their kernels, their device time per
    layer at the decode step's 4 tokens and at the prefill's 4 x 512, over
    all MoE layers; and the decode step's least time, the bytes of every
    weight it reads (all but the embedding table, of which it reads 4
    rows) over the card's memory rate, the experts' share apart."""
    import numpy as np

    from repro_torch.models import moe

    cfg = engine.ctx.cfg
    lp = {k: v[0] for k, v in engine.params["layers"]["ffn"].items()}
    n_moe = cfg.n_layers - cfg.moe.first_moe_layer
    rng = np.random.default_rng(3)
    for label, t in (("decode step, 4 tokens", 4), ("prefill, 4 x 512 tokens", 2048)):
        xt = torch.from_numpy(rng.normal(size=(t, cfg.d_model)).astype(np.float32)).to(
            "cuda", torch.bfloat16)
        ms = device_ms(lambda: moe._experts(lp, xt))
        kern, _, _ = profiled_kernels(torch, lambda: moe._experts(lp, xt), reps=3)
        names = sorted({e.key[:60] for e in kern or []})
        say(f"  {cfg.name} compute-all expert GEMMs ({label}): {ms:.4f} ms a layer, "
            f"{ms * n_moe:.3f} ms over {n_moe} MoE layers; kernels {names}")
    leaves = []

    def walk(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v)
            else:
                leaves.append((k, v))

    walk(engine.params)
    expert = sum(v.numel() * v.element_size() for k, v in leaves if k.startswith("we_"))
    read = sum(v.numel() * v.element_size() for k, v in leaves if k != "embed")
    read += 4 * cfg.d_model * engine.params["embed"].element_size()
    say(f"  {cfg.name} decode step's weight-read bound: {read / 1e9:.2f} GB at "
        f"{PEAK_BYTES / 1e12:.2f} TB/s = {read / PEAK_BYTES * 1e3:.3f} ms (the expert weights "
        f"alone: {expert / 1e9:.2f} GB, {expert / PEAK_BYTES * 1e3:.3f} ms); {card_line()}")


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
    "offload_cells": ("n_offload_cells", "min_offload_score", "offload_power_violations",
                      "offload_feasible_baselines"),
    "cotenant_cells": ("n_cotenant_cells", "min_cotenant_score", "cotenant_power_violations",
                       "cotenant_feasible_baselines"),
}


def held_to_record(rec, label, family="cells"):
    """Every cell of ``rec[family]`` (a key of RECORD_FAMILIES) against
    the JAX package's committed record (configs, flags and counts
    exactly, floats at RECORD_REL), then that family's summary keys."""
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
    shapes = ", ".join(str(s) for s in sorted({tuple(k[0].shape) for k in kept}, reverse=True))
    say(f"  {label}: {len(kept)} windows-kernel launches at (B, W, C) = {shapes or None}, "
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
    spec, records identical to theirs; (g) the 4 offload cells x 3 seeds,
    one batched call of 24 steps on the joint edge-pod grids; (h) the 4
    cotenant cells x 3 seeds, one batched call of 40 steps on the joint
    slots x shared-DVFS grids; (i) the 8 cells of (g) and (h) through the
    scalar spec, records identical to theirs. Launch counts are reset just
    before and read just after each part; (d), (e), (g) and (h) hold every
    windows-kernel launch to its plain version on its own inputs. Returns
    the dcov launches of the five batched main paths, (a), (d), (e), (g)
    and (h), and their records: (a)'s under ``cells``, the others' under
    their family's name."""
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
    drift, fault = list(scenarios.MATRIX_DRIFT_CELLS), scenarios.MATRIX_FAULT_CELLS
    offload, cotenant = scenarios.MATRIX_OFFLOAD_CELLS, scenarios.MATRIX_COTENANT_CELLS
    groups = (  # batched parts (part, family, steps, variants, run_matrix arguments), then
        # the scalar spec over the whole group
        ([("d", "drift_cells", scenarios.DRIFT_INTERVALS, 2, dict(cells=drift)),
          ("e", "fault_cells", scenarios.FAULT_INTERVALS, 2, dict(cells=[], fault_cells=fault))],
         "f", "drift and fault", dict(cells=drift, fault_cells=fault)),
        ([("g", "offload_cells", matrix.OFFLOAD_ITERS, 1, dict(cells=[], offload_cells=offload)),
          ("h", "cotenant_cells", matrix.COTENANT_ITERS, 1,
           dict(cells=[], cotenant_cells=cotenant))],
         "i", "offload and cotenant", dict(cells=[], offload_cells=offload,
                                           cotenant_cells=cotenant)),
    )
    for parts, scalar_part, what, scalar_kw in groups:
        for part, family, steps, variants, kw in parts:
            main[family] = batched_family(torch, part, family, steps, variants, kw)
        families = [family for _, family, _, _, _ in parts]
        calls[0] = 0
        torch.cuda.synchronize()
        runtime.reset_launch_counts()
        t0 = time.perf_counter()
        with mock.patch.object(CORAL, "correlations", counted):
            scalar = matrix.run_matrix(**scalar_kw, engine="scalar", device="cuda")
        wall = time.perf_counter() - t0
        scalar_counts = runtime.launch_counts()
        apart = [f"{family}{d}" for family in families
                 for d in matrix.diff_records(scalar[family], main[family][1][family], rel=0.0)]
        n_cells = sum(len(scalar[family]) for family in families)
        say(f"  ({scalar_part}) run_matrix, the {n_cells} {what} cells through the scalar spec "
            f"on the card: {wall:.3f} s, launches {scalar_counts} over {calls[0]} "
            f"correlations() calls with n >= 3; records equal to the batched engine's: "
            f"{not apart}")
        if scalar_counts["dcov"] != calls[0] or calls[0] == 0:
            fail("the scalar spec's dcov launches do not match its correlations() calls")
        if apart:
            for x in apart[:20]:
                say(f"    differs: {x}")
            fail(f"the scalar spec's {what} records differ from the batched engine's")
    total = main["static"] + sum(main[f][0] for f in main if f != "static")
    say(f"  dcov launches on the main paths: {total} (" + ", ".join(
        f"{f} {main[f] if f == 'static' else main[f][0]}" for f in main) + ")")
    records = {"cells": batched, **{f: main[f][1] for f in main if f != "static"}}
    return total, records


def batched_family(torch, part, family, steps, variants, kw):
    """One family of the record through ``run_matrix`` on the card, one
    batched call of ``steps`` engine steps (``variants`` episodes per cell
    and seed): launch counts reset just before and read just after, every
    windows-kernel launch held to its plain version on its own inputs, the
    records held to the committed ones. Returns (dcov launches, record)."""
    from repro_torch.experiments import matrix
    from repro_torch.kernels import runtime

    torch.cuda.synchronize()
    runtime.reset_launch_counts()
    t0 = time.perf_counter()
    rec, kept, nan_windows = held_per_launch(
        torch, lambda: matrix.run_matrix(**kw, device="cuda"), f"({part}) {family}")
    wall = time.perf_counter() - t0
    part_counts = runtime.launch_counts()
    n_cells = len(rec[family])
    n_eps = n_cells * len(rec["seeds"]) * variants
    say(f"  ({part}) run_matrix, {n_cells} {family} x 3 seeds"
        + (f" x {variants} variants" if variants > 1 else "")
        + f" ({n_eps} episodes x {steps} steps), batched on the card: {wall:.3f} s (phases "
        f"{json.dumps({k: round(v, 4) for k, v in rec['wall_clock_s'].items() if v > 1e-3})}), "
        f"launches {part_counts}")
    if part_counts["dcov"] != steps or kept != steps:
        fail(f"dcov launched {part_counts['dcov']} times in the batched {family} call, "
             f"not {steps} (one per step)")
    if family == "fault_cells" and nan_windows == 0:
        fail("no fault ablation window held NaN: the NaN path was not driven")
    held_to_record(rec, f"({part}) batched", family)
    return part_counts["dcov"], rec


def phase_fleet(torch):
    """(j) The fleet at ``BENCH_fleet.json``'s settings on the card:
    ``run_fleet`` over 1024 twins with the steady probe, three engine calls
    of 30 steps (cold at B = 1024, steady at 1024, warm at 256), exactly one
    windows-kernel launch per step of each, every launch held bit for bit to
    the plain version on its own inputs, and the results block equal to the
    record's. On a mismatch: the keys that differ, then the first twin and
    step where the card's cold or warm wave leaves the same requests run on
    the CPU. Returns the dcov launches, the record and the engine calls
    (batch, launches, requests, results), in FLEET_CALLS' order."""
    import numpy as np

    from repro_torch.experiments import fleet
    from repro_torch.kernels import runtime

    calls, engine = [], fleet.run_fleet_requests

    def counted(reqs, *args, **kw):  # each engine call's batch, launches and results
        before = runtime.launch_counts()["dcov"]
        out = engine(reqs, *args, **kw)
        calls.append((len(reqs), runtime.launch_counts()["dcov"] - before, reqs, out))
        return out

    torch.cuda.synchronize()
    runtime.reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(fleet, "run_fleet_requests", counted):
        rec, kept, _ = held_per_launch(
            torch, lambda: fleet.run_fleet(**FLEET_RUN, probe_steady=True, device="cuda"),
            "(j) fleet")
    wall = time.perf_counter() - t0
    counts = runtime.launch_counts()
    iters = FLEET_RUN["iters"]
    say(f"  (j) run_fleet, {FLEET_RUN['n_twins']} twins x {iters} steps, cold, steady and warm "
        f"on the card: {wall:.3f} s, launches {counts}; engine calls: " + ", ".join(
            f"{name} B={b}: {n} dcov launches" for (name, _), (b, n, _, _) in
            zip(FLEET_CALLS, calls)))
    say(f"  (j) engine block on {card_line()}: {json.dumps(rec['engine'])}")
    if [(b, n) for b, n, _, _ in calls] != [(b, iters) for _, b in FLEET_CALLS]:
        fail(f"the fleet's engine calls launched dcov {[(b, n) for b, n, _, _ in calls]} times "
             f"(batch, launches), not {iters} per call at {[b for _, b in FLEET_CALLS]}")
    if counts["dcov"] != kept or kept != iters * len(FLEET_CALLS):
        fail(f"dcov launched {counts['dcov']} times in the fleet, not {iters * len(FLEET_CALLS)}")
    want = json.loads(FLEET_RECORD.read_text())["results"]
    got = rec["results"]
    same = json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    say(f"  (j) results block equal to {FLEET_RECORD.name}'s: {same} (feasible_rate "
        f"{got['feasible_rate']}, mean_m2f_cold {got['mean_m2f_cold']}, mean_score "
        f"{got['mean_score']}, warm_gain {got['warm_gain']} over {got['warm_matched']} pairs)")
    if same:
        return counts["dcov"], rec, calls
    keys = [k for k in sorted(set(got) | set(want))
            if json.dumps(got.get(k), sort_keys=True) != json.dumps(want.get(k), sort_keys=True)]
    say(f"    keys that differ: {keys}")
    for (name, _), (_, _, reqs, out) in zip(FLEET_CALLS, calls):
        if name == "steady":
            continue
        on_cpu = engine(reqs, iters, FLEET_RUN["window"], device="cpu")
        for i, (a, b) in enumerate(zip(out, on_cpu)):
            steps = np.flatnonzero(a["idx"] != b["idx"])
            if steps.size:
                t = int(steps[0])
                say(f"    {name} wave: twin {i} first leaves the CPU's trace at step {t} "
                    f"(row {a['idx'][t]} on the card, {b['idx'][t]} on the CPU)")
                break
        else:
            say(f"    {name} wave: every row trace equals the CPU's")
    fail(f"the port's fleet does not reproduce {FLEET_RECORD.name}")


def set_lanes(on):
    """Turn the engine's contract and NaN lanes on or off in this process
    (both read at call time)."""
    for name in LANES:
        if on:
            os.environ[name] = "1"
        else:
            os.environ.pop(name, None)


def same_waves(got, want):
    """Two fleet engine calls' per-twin results equal exactly."""
    import numpy as np

    return len(got) == len(want) and all(
        a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
        for a, b in zip(got, want))


def phase_lanes(torch, records, fleet_calls):
    """(k) The lanes on the card: with both flags set, the static grid, the
    drift cells, the offload and the cotenant cells through ``run_matrix``
    (one batched call each) and the fleet's cold and warm engine calls of
    (j) on (j)'s requests, each record equal to its lane-off one exactly,
    with as many dcov launches (one per step), each launch held bit for bit
    to its plain version; a fault cell and a static call over a NaN
    landscape must raise ``SanitizeError``; then ``lane_costs``. The flags
    are unset on the way out. Returns the lane-on calls' dcov launches."""
    import numpy as np

    from repro_torch.core.episode import run_coral_batch
    from repro_torch.core.evaluate import RegimeTargets
    from repro_torch.core.sanitize import SanitizeError
    from repro_torch.core.space import jetson_like_space
    from repro_torch.device import jetson_like_simulator
    from repro_torch.experiments import fleet, matrix, scenarios
    from repro_torch.kernels import runtime

    launches = 0
    set_lanes(True)
    try:
        for part, family, steps, kw in (
            ("a", "cells", 10, dict(cells=static_grid())),
            ("d", "drift_cells", scenarios.DRIFT_INTERVALS,
             dict(cells=list(scenarios.MATRIX_DRIFT_CELLS))),
            ("g", "offload_cells", matrix.OFFLOAD_ITERS,
             dict(cells=[], offload_cells=scenarios.MATRIX_OFFLOAD_CELLS)),
            ("h", "cotenant_cells", matrix.COTENANT_ITERS,
             dict(cells=[], cotenant_cells=scenarios.MATRIX_COTENANT_CELLS)),
        ):
            torch.cuda.synchronize()
            runtime.reset_launch_counts()
            t0 = time.perf_counter()
            rec, kept, _ = held_per_launch(
                torch, lambda kw=kw: matrix.run_matrix(**kw, device="cuda"),
                f"(k) lanes on, {family}")
            wall = time.perf_counter() - t0
            n = runtime.launch_counts()["dcov"]
            off = records[family]
            keys = RECORD_FAMILIES[family]
            apart = matrix.diff_records(rec[family], off[family], rel=0.0) + [
                "summary" + d for d in matrix.diff_records(
                    {k: rec["summary"][k] for k in keys},
                    {k: off["summary"][k] for k in keys}, rel=0.0)]
            say(f"  (k) lanes on, ({part})'s {len(rec[family])} {family} in one batched call: "
                f"{wall:.3f} s, {n} dcov launches (lanes off: {steps}); record equal to "
                f"({part})'s: {not apart}")
            for x in apart[:20]:
                say(f"    differs: {x}")
            if n != steps or kept != steps:
                fail(f"(k) the lane-on {family} call launched dcov {n} times, not {steps}")
            if apart:
                fail(f"(k) the lanes change the {family} record")
            launches += n
        for (name, _), (b, n_off, reqs, out_off) in zip(FLEET_CALLS, fleet_calls):
            if name == "steady":
                continue
            torch.cuda.synchronize()
            runtime.reset_launch_counts()
            t0 = time.perf_counter()
            out, kept, _ = held_per_launch(
                torch, lambda reqs=reqs: fleet.run_fleet_requests(
                    reqs, FLEET_RUN["iters"], FLEET_RUN["window"], device="cuda"),
                f"(k) lanes on, fleet {name} call")
            wall = time.perf_counter() - t0
            n = runtime.launch_counts()["dcov"]
            same = same_waves(out, out_off)
            say(f"  (k) lanes on, the fleet's {name} call (B={b}): {wall:.3f} s, {n} dcov "
                f"launches (lanes off: {n_off}); every twin's results equal (j)'s: {same}")
            if n != n_off or kept != n_off:
                fail(f"(k) the lane-on fleet {name} call launched dcov {n} times, not {n_off}")
            if not same:
                fail(f"(k) the lanes change the fleet's {name} wave")
            launches += n

        space = jetson_like_space()
        land_tau, land_p = jetson_like_simulator(space).exact_all()
        targets = RegimeTargets(mode="dual", tau_target=float(np.percentile(land_tau, 70)),
                                p_budget=float(np.percentile(land_p, 60)))
        for label, call in (
            (f"a fault cell ({scenarios.MATRIX_FAULT_CELLS[0].regime}, 3 seeds x "
             "{hardened, ablation})",
             lambda: matrix.run_matrix([], fault_cells=scenarios.MATRIX_FAULT_CELLS[:1],
                                       device="cuda")),
            (f"a static call over a NaN landscape ({NAN_CALL})",
             lambda: run_coral_batch(space, np.full_like(land_tau, np.nan), land_p, targets,
                                     **NAN_CALL, device="cuda")),
        ):
            try:
                call()
            except SanitizeError as e:
                say(f"  (k) lanes on, {label}: SanitizeError, as the reference raises: {e}")
            else:
                fail(f"(k) {label} ran clean under REPRO_CHECKIFY=1")
        lane_costs(torch)
    finally:
        set_lanes(False)
    say(f"  (k) dcov launches of the lane-on calls: {launches}")
    return launches


def kernels_per_call(torch, fn):
    """The device kernels one call of ``fn`` launches, from a
    ``torch.profiler`` window that traces the card alone (no host events to
    reduce), behind PROFILE_LEAD spin kernels as in ``profiled_kernels``
    (the profiler may drop a window's first records); the spins are not
    counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_LEAD):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAUSE_S)
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.key)


def lane_costs(torch):
    """Each batched engine call (``engine_calls``) with the lanes off and
    on: the kernels of one call each way (``kernels_per_call``, which also
    warms each way up), then the host clock around one call (which ends
    reading its results) in turns, LANE_TURNS. A lane-on fault call raises
    ``SanitizeError`` after its last step, as it must; its time is the
    lanes' cost all the same."""
    from repro_torch.core.sanitize import SanitizeError

    say(f"  (k) the engine's calls with the lanes off and on, in turns ({card_line()}):")
    for label, call, steps in engine_calls():
        raises = "fault" in label

        def run(on, call=call, raises=raises):
            set_lanes(on)
            try:
                call()
            except SanitizeError:
                if not (on and raises):
                    raise
                return
            if on and raises:
                fail(f"(k) the lane-on {label} ran clean")

        per_step = {on: kernels_per_call(torch, lambda on=on: run(on)) / steps
                    for on in (False, True)}
        turns = []
        for on in LANE_TURNS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(on)
            turns.append(f"{'on' if on else 'off'} {(time.perf_counter() - t0) * 1e3:.3f}")
        say(f"    {label}: wall ms in turns " + ", ".join(turns) + f"; kernels per step off "
            f"{per_step[False]:.1f}, on {per_step[True]:.1f} "
            f"(+{per_step[True] - per_step[False]:.1f})")
    set_lanes(False)


def phase_guard(torch):
    """(l) The build-count guard: a second static call over the grid with
    other seeds stages nothing, builds no kernel and captures nothing."""
    from repro_torch.core.sanitize import count_builds
    from repro_torch.experiments import matrix

    t0 = time.perf_counter()
    with count_builds() as built:
        rec = matrix.run_matrix(static_grid(), seeds=(3, 4, 5), device="cuda")
    say(f"  (l) run_matrix over the {len(rec['cells'])} static cells with seeds (3, 4, 5): "
        f"{time.perf_counter() - t0:.3f} s, builds counted by count_builds: {built.total} "
        f"{built.names}")
    if built.total:
        fail(f"(l) the same static spec with other seeds built {built.names}")


def phase_records(records, fleet_rec):
    """(m) The card's records in the reference's schema: the matrix record
    of (a) with the families of (d), (e), (g) and (h) merged in (grid and
    wall clock joined, summary recomputed) passes ``validate_matrix_record``,
    renders the committed BENCH_matrix.md byte for byte and gives the
    committed record's ``score_floors``; the fleet record of (j), wrapped
    as the reference's fleet bench wraps it, passes
    ``validate_fleet_record``."""
    import copy

    from repro_torch.experiments import (
        markdown_report,
        matrix,
        score_floors,
        validate_fleet_record,
        validate_matrix_record,
    )

    parts = list(records.values())
    rec = copy.deepcopy(records["cells"])
    for family in RECORD_FAMILIES:
        if family != "cells":
            rec[family] = records[family][family]
    rec["grid"] = {k: sorted(set().union(*(r["grid"][k] for r in parts))) for k in rec["grid"]}
    rec["wall_clock_s"] = {k: round(sum(r["wall_clock_s"][k] for r in parts), 4)
                           for k in rec["wall_clock_s"]}
    rec["summary"] = matrix._summarize(rec["cells"], rec["drift_cells"], rec["offload_cells"],
                                       rec["cotenant_cells"], rec["fault_cells"])
    payload = {"schema_version": 1, "regenerate": FLEET_REGENERATE, "quick": False,
               "results": fleet_rec["results"], "engine": fleet_rec["engine"]}
    for what, validate, record in (("matrix", validate_matrix_record, rec),
                                   ("fleet", validate_fleet_record, payload)):
        try:
            validate(record)
        except ValueError as e:
            fail(f"(m) the card's {what} record does not validate: {e}")
    md, want = markdown_report(rec), (ROOT / "BENCH_matrix.md").read_text()
    committed = json.loads(MATRIX_RECORD.read_text())
    floors = score_floors(rec) == score_floors(committed)
    say(f"  (m) the card's matrix record ({sum(len(rec[f]) for f in RECORD_FAMILIES)} cells, "
        f"engine {rec['engine']!r}) validates; its markdown_report equals BENCH_matrix.md byte "
        f"for byte: {md == want}; its score_floors equal the committed record's: {floors}; the "
        f"fleet record validates")
    if md != want:
        lines = [(i, a, b) for i, (a, b) in enumerate(zip(md.splitlines(), want.splitlines()))
                 if a != b]
        for i, a, b in lines[:5]:
            say(f"    line {i + 1}: card {a!r}, committed {b!r}")
        fail("(m) the card's markdown report differs from BENCH_matrix.md")
    if not floors:
        fail("(m) the card's score floors differ from the committed record's")


def engine_calls():
    """The batched engine's six calls at the record's cells, each as
    (label, call, steps): static over the grid, drift over the 6 drift
    cells, fault over the 6 fault cells, offload and cotenant over their 4
    cells each, and the fleet's cold call (1024 twins). The requests are
    built once; a call moves its tables to the card, runs its T steps and
    reads its results on the host."""
    from repro_torch.core.episode import (
        run_drift_requests,
        run_fault_requests,
        run_fleet_requests,
        run_static_requests,
    )
    from repro_torch.experiments import fleet, matrix, scenarios

    seeds = (0, 1, 2)
    reqs = [r for c in static_grid() for r in matrix._static_requests(matrix._prep_cell(c), seeds)]
    calls = [(f"CORAL batched static call, {len(reqs)} episodes x 10 steps",
              lambda reqs=reqs: run_static_requests(reqs, device="cuda"), 10)]
    steps = scenarios.DRIFT_INTERVALS
    reqs = [r for c in scenarios.MATRIX_DRIFT_CELLS for a in (True, False)
            for r in matrix._drift_requests(matrix._prep_drift_cell(c, steps), seeds, a)]
    calls.append((f"CORAL batched drift call, {len(reqs)} episodes x {steps} steps",
                   lambda reqs=reqs, steps=steps: run_drift_requests(
                       reqs, intervals=steps, device="cuda"), steps))
    steps = scenarios.FAULT_INTERVALS
    reqs = [r for c in scenarios.MATRIX_FAULT_CELLS for h in (True, False)
            for r in matrix._fault_requests(matrix._prep_fault_cell(c, steps, seeds), seeds, h)]
    calls.append((f"CORAL batched fault call, {len(reqs)} episodes x {steps} steps",
                   lambda reqs=reqs, steps=steps: run_fault_requests(
                       reqs, iters=steps, device="cuda"), steps))
    for family, cells, prep, steps in (
        ("offload", scenarios.MATRIX_OFFLOAD_CELLS, matrix._prep_offload_cell,
         matrix.OFFLOAD_ITERS),
        ("cotenant", scenarios.MATRIX_COTENANT_CELLS, matrix._prep_cotenant_cell,
         matrix.COTENANT_ITERS),
    ):
        reqs = [r for c in cells for r in matrix._static_requests(prep(c), seeds)]
        calls.append((f"CORAL batched {family} call, {len(reqs)} episodes x {steps} steps",
                       lambda reqs=reqs, steps=steps: run_static_requests(
                           reqs, iters=steps, device="cuda"), steps))
    steps, window = FLEET_RUN["iters"], FLEET_RUN["window"]
    reqs = [fleet._request(t) for t in fleet.build_fleet(FLEET_RUN["n_twins"], FLEET_RUN["seed"])]
    calls.append((f"CORAL fleet cold call, {len(reqs)} twins x {steps} steps",
                   lambda reqs=reqs: run_fleet_requests(reqs, steps, window, device="cuda"),
                   steps))
    return calls


def phase_coral_profile(torch):
    """One batched static call over the grid, one batched drift call over
    the 6 drift cells, one batched fault call over the 6 fault cells, and
    one batched offload and one batched cotenant call over their 4 cells
    each (tables built and moved, T steps on the card, float64 records on
    the host), the fleet's cold call (1024 twins, 30 steps), and the
    single-block dcov form at ORACLE scale and at n = 16384, split into its
    two kernels."""
    import numpy as np

    from repro_torch.kernels.dcov import dcov_gram

    for label, call, steps in engine_calls():
        launches = profile_window(torch, label, call, reps=3)
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


def phase_control_loop(torch):
    """The paper's loop on live traffic of full-width Qwen2.5-3B (decode
    through its CUDA graphs): (i) ``run_coral`` over ``WalltimeDevice``,
    which measures the runtime's decode rate once per concurrency level, as
    tests/test_training_serving.py does it; (ii) ``ServingController`` as
    examples/tune_serving.py sets it up: a bursty Poisson trace at 0.6 x the
    measured capacity, a tau target of 0.45 x capacity, a budget of 0.8 x
    the analytical max-power preset's power, LOOP_INTERVALS intervals of
    LOOP_INTERVAL_S. Power is the reference's analytical model on its TPU
    v5e constants, not the H100's. First one prefill at each of the
    phase's prompt lengths holds every flash launch to ``attention_ref``.
    Fails if an interval that starts with a request waiting (arrived, not
    admitted) admits no group, if one that starts with a group in flight
    decodes no token, if a released request is not served in full by the
    end, or if flash attention or dcov never launched. A request that
    arrives during an interval and is not admitted in it is its next
    interval's waiting work; an interval that starts with neither (a gap
    of the bursty trace) is reported. Returns the phase's launches."""
    from repro_torch.core.evaluate import run_coral
    from repro_torch.core.space import tpu_pod_space
    from repro_torch.device.measure import WalltimeDevice, analytic_scale_and_power
    from repro_torch.kernels import runtime
    from repro_torch.launch.serve import build_engine
    from repro_torch.serving import (
        ServingController,
        ServingRuntime,
        build_serving_record,
        workload,
    )

    t0 = time.perf_counter()
    max_len = max(LOOP_PROBE["prompt_len"] + LOOP_PROBE["steps"], LOOP_PROMPT + LOOP_NEW_TOKENS) + 1
    engine = build_engine(ARCH, 4, max_len, device="cuda")
    engine_prefills_held(torch, engine, [LOOP_PROMPT, LOOP_PROBE["prompt_len"]],
                         "the control loop")
    runtime.reset_launch_counts()
    vocab = engine.ctx.cfg.vocab
    space = tpu_pod_space()
    dev = WalltimeDevice(space, engine, **LOOP_PROBE)
    tau0, p0 = dev.measure(space.preset("default"))
    out, trace = run_coral(space, dev, tau_target=tau0 * 0.5, iters=LOOP_CORAL_ITERS,
                           device="cuda")
    rates = {c: dev._measured_rate(c) for c in concurrency_values()}  # every level, once
    say(f"  (i) run_coral over WalltimeDevice ({ARCH}, B=4, prompt {LOOP_PROBE['prompt_len']}, "
        f"{LOOP_PROBE['steps']} steps, {dev.groups} groups a probe; {card_line()}): measured "
        f"decode tok/s by concurrency " + ", ".join(f"c={c}: {t:.2f}" for c, t in rates.items())
        + f"; default preset tau {tau0:.2f} tok/s, p {p0:.1f} W (analytical TPU v5e model, "
        f"not the H100's)")
    say(f"      CORAL pick {out.config}: tau {out.tau:.2f} tok/s, p {out.power:.1f} W "
        f"(analytical) after {dev.n_measurements} measurements, target {tau0 * 0.5:.2f}")
    if out.config is None or not out.tau > 0:
        fail("run_coral over WalltimeDevice found no configuration")

    cap = max(rates.values())
    duration = LOOP_INTERVALS * LOOP_INTERVAL_S + 2.0
    trace = workload.bursty_poisson(rate=0.6 * cap / LOOP_NEW_TOKENS, duration_s=duration,
                                    prompt_lens=LOOP_PROMPT, new_tokens=LOOP_NEW_TOKENS, vocab=vocab,
                                    seed=1)
    tau_target = 0.45 * cap
    p_budget = analytic_scale_and_power(space.names, space.preset("max_power"))[1] * 0.8
    rt = ServingRuntime(engine, concurrency=1)
    released = []
    submit = rt.submit

    def counted_submit(req, tenant=None):
        released.append(req)
        submit(req, tenant)

    rt.submit = counted_submit
    admitted = []  # groups each interval's run_for started (prefilled)
    decoded = []  # tokens each interval's run_for decoded
    work = []  # (requests arrived and waiting, groups in flight) at each interval's start
    run_for = rt.run_for

    def counted_run_for(seconds, idle_wait=False):
        now, rings = rt.now(), list(rt.tenants.values())
        work.append((sum(r.arrival_s is None or r.arrival_s <= now
                         for ring in rings for r in ring.waiting),
                     sum(s.group is not None for ring in rings for s in ring.slots)))
        n, tokens = rt.prefills, sum(ring._tokens_total for ring in rings)
        m = run_for(seconds, idle_wait=idle_wait)
        admitted.append(rt.prefills - n)
        decoded.append(sum(ring._tokens_total for ring in rings) - tokens)
        return m

    rt.run_for = counted_run_for
    ctl = ServingController(rt, space, trace, tau_target=tau_target, p_budget=p_budget,
                            interval_s=LOOP_INTERVAL_S, device="cuda")
    outcome, records = ctl.run(LOOP_INTERVALS)
    say(f"  (ii) ServingController: bursty Poisson trace at 0.6 x {cap:.2f} tok/s, target "
        f">= {tau_target:.2f} tok/s, budget <= {p_budget:.1f} W (analytical), "
        f"{LOOP_INTERVALS} intervals of {LOOP_INTERVAL_S} s:")
    for k, r in enumerate(records):
        say(f"    [{k}] {json.dumps(dataclasses.asdict(r))}")
    say(f"      groups admitted in each interval: {admitted}; tokens decoded: {decoded}; "
        f"(requests waiting, groups in flight) at each interval's start: {work}")
    feasible = outcome.feasible(tau_target, p_budget)
    say(f"      CORAL found {outcome.config}: tau {outcome.tau:.2f} tok/s, p {outcome.power:.1f} W "
        f"(analytical), feasible {feasible}")
    rt.drain()
    done = {id(r) for r in rt.done}
    lost = [r.rid for r in released if id(r) not in done]
    short = [r.rid for r in rt.done if len(r.tokens) != r.max_new_tokens]
    counts = runtime.launch_counts()
    say(f"      {len(released)} requests released, {len(rt.done)} served after the drain, "
        f"lost {lost}, short {short}; launches over the phase {counts}; "
        f"{time.perf_counter() - t0:.1f} s")
    record = build_serving_record(
        "python3 chip_smoke.py", concurrency_values(), rates, 1, batch_size=4,
        iters=LOOP_INTERVALS, interval_s=LOOP_INTERVAL_S, tau_target=tau_target,
        p_budget=p_budget, outcome=outcome, records=records, include_intervals=True)
    say(json.dumps({"serving_record": record}, sort_keys=True))
    # each interval is held to the work it starts with: waiting requests
    # must be admitted, groups in flight must decode; whether a request
    # also completes inside the 0.5 s depends on the groups' ~0.4 s latency
    unadmitted = [k for k in range(len(records)) if work[k][0] and not admitted[k]]
    undecoded = [k for k in range(len(records)) if work[k][1] and not decoded[k]]
    gaps = [k for k in range(len(records)) if not any(work[k])]
    say(f"      intervals that start with no request waiting and no group in flight (trace "
        f"gaps): {gaps}")
    if len(admitted) != len(records) or unadmitted or undecoded:
        fail(f"control intervals {unadmitted} started with requests waiting and admitted no "
             f"group, or {undecoded} started with a group in flight and decoded no token "
             f"(groups admitted {admitted}, tokens decoded {decoded}, work {work})")
    if lost or short:
        fail(f"the control loop lost requests {lost} or cut {short} short")
    for name in ("flash_attention", "dcov"):
        if counts[name] == 0:
            fail(f"the control-loop phase never launched {name}")
    del engine, rt, ctl, dev
    torch.cuda.empty_cache()
    return counts


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
    phase_slice_check(torch, MOE_ARCH, 96)
    phase_slice_check(torch, MLA_ARCH, 96)
    phase_slice_check(torch, VLM_ARCH, 96)
    phase_slice_check(torch, AUDIO_ARCH, 96)
    dcov, records = phase_coral_slice(torch)
    fleet_dcov, fleet_rec, fleet_calls = phase_fleet(torch)
    counts = {"dcov": dcov + fleet_dcov + phase_lanes(torch, records, fleet_calls)}
    phase_guard(torch)
    phase_records(records, fleet_rec)
    say(f"  dcov launches on the main paths, the fleet's and the lane-on calls' included: "
        f"{counts['dcov']}")
    say("== phase 4: serve")
    counts.update(phase_serve(torch))
    say("== phase 5: profile")
    phase_profile(torch, ARCH)
    phase_profile(torch, SSM_ARCH)
    phase_profile(torch, HYBRID_ARCH)
    phase_profile(torch, MOE_ARCH)
    phase_profile_mla_bodies(torch)
    phase_profile(torch, VLM_ARCH)
    phase_profile(torch, AUDIO_ARCH)
    phase_coral_profile(torch)
    say("== phase 6: control loop")
    for name, n in phase_control_loop(torch).items():
        counts[name] = counts.get(name, 0) + n
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
