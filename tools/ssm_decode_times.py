"""Mamba2's decode state step on the card: the whole graphed decode step
with the ``ssm_decode`` kernel and with the plain state step. (The kernel
alone, against its byte bound and its plain version, is timed by
``chip_smoke.py``'s phase 2.)

Run from the repository root on a machine with an NVIDIA H100 (it builds
the kernel with ``nvcc`` and fails without a card):

    python3 tools/ssm_decode_times.py

Full-width, full-depth Mamba2-2.7B and Hymba-1.5B with random bf16
weights, served as the benchmark serves them (``ServingEngine``, CUDA
graphs, B 32, 1,025 slots, a prompt of 128 tokens), with
``use_kernels=True`` and ``False`` (a decode step reaches no other kernel:
decode attention takes its plain path either way), in turns: the device ms
of a graph replay (CUDA events around ``REPLAYS`` replays), and from the
profiler the kernels a replay launches and the device ops that take the
most of its time. One JSON line per measurement.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("mamba2-2.7b", "hymba-1.5b")
REPLAYS = 20
ROUNDS = 2


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def emit(**row) -> None:
    print(json.dumps(row), flush=True)


def step_times(torch) -> None:
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import get_config
    from repro_torch.configs.runtime import RunConfig
    from repro_torch.models.transformer import ApplyCtx, init_model_params
    from repro_torch.serving import ServingEngine

    for arch in ARCHS:
        cfg = get_config(arch)
        params = init_model_params(cfg, RunConfig(param_dtype="bfloat16"),
                                   torch.Generator(device="cuda").manual_seed(0), "cuda")
        prompt = np.random.default_rng(0).integers(0, cfg.vocab, (32, 128), dtype=np.int32)
        tok = np.zeros((32, 1), np.int32)
        engines = {}
        for path in ("kernel", "plain"):
            rcfg = RunConfig(param_dtype="bfloat16", compute_dtype="bfloat16",
                             use_kernels=path == "kernel")
            eng = ServingEngine(ApplyCtx(cfg, rcfg), params, 32, 1025)
            k = eng.acquire()
            cache, _ = eng.prefill(prompt, entry=k)
            engines[path] = (eng, cache)
        for _ in range(ROUNDS):
            for path in ("kernel", "plain", "plain", "kernel"):
                eng, cache = engines[path]
                for _ in range(3):
                    eng.decode(cache, tok)
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(REPLAYS):
                    eng.decode(cache, tok)
                b.record()
                b.synchronize()
                emit(what="graphed decode step", arch=arch, path=path,
                     ms=round(a.elapsed_time(b) / REPLAYS, 4))
        for path, (eng, cache) in engines.items():
            eng.decode(cache, tok)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    eng.decode(cache, tok)
                torch.cuda.synchronize()
            kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
            top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
            emit(what="graphed decode step, profiler", arch=arch, path=path,
                 kernels_per_step=round(sum(e.count for e in kern) / 3, 1),
                 device_ms_per_step=round(sum(e.self_device_time_total for e in kern) / 3e3, 4),
                 top=[[e.key[:64], round(e.self_device_time_total / 3e3, 4), e.count // 3]
                      for e in top])
        del engines, params
        torch.cuda.empty_cache()


def main() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        sys.exit("ssm_decode_times: no CUDA device: the tool times the decode step on the card")
    print(smi(), flush=True)
    step_times(torch)


if __name__ == "__main__":
    main()
