"""The one build and dispatch point for every hand-written kernel.

Counterpart of ``repro/kernels/runtime.py``, which decides in one place
whether a Pallas kernel is compiled for the TPU or interpreted. Here the
decision is the device of the tensors a wrapper is given:

* a CPU tensor takes the kernel's plain PyTorch version (the CPU tests);
* a CUDA tensor launches the kernel, or the wrapper raises. There is no
  fallback from the card to the plain version.

Kernels are CUDA C++ sources under ``kernels/*/csrc/*.cu`` with a plain C
interface. On first use each is compiled by ``nvcc`` for ``sm_90a`` into
a shared library under ``build/`` at the repository root (listed in
``.gitignore``), named by a digest of its source and flags so an edited
source is rebuilt, and loaded with ``ctypes``. ``build()`` starts one
``nvcc`` per missing library, all at once.

Every wrapper calls :func:`count_launch` where it launches its kernel and
nowhere else, so a run can show that its main path went through the
kernels (:func:`launch_counts`, :func:`reset_launch_counts`).

No kernel has a backward. A wrapper fills its output through a C call,
so on the card an input that requires grad would give an output with no
``grad_fn`` and the gradient would be lost without an error. Every
wrapper therefore calls :func:`refuse_grad` at entry, on both devices:
with grad mode on, an input that requires grad raises. The JAX package
never differentiates a Pallas kernel either (it trains with
``use_pallas=False``); the port trains on the models' plain paths
(``use_kernels=False``) and reaches the kernels in its eval step, under
``torch.no_grad()``.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

_KERNELS_DIR = Path(__file__).resolve().parent
REPO_ROOT = _KERNELS_DIR.parents[2]
BUILD_DIR = REPO_ROOT / "build"

# kernel name -> CUDA source, relative to this package
SOURCES: Dict[str, Path] = {
    "flash_attention": _KERNELS_DIR / "flash_attention" / "csrc" / "flash_attention.cu",
    "ssd_scan": _KERNELS_DIR / "ssd_scan" / "csrc" / "ssd_scan.cu",
    "dcov": _KERNELS_DIR / "dcov" / "csrc" / "dcov.cu",
    "ssm_decode": _KERNELS_DIR / "ssm_decode" / "csrc" / "ssm_decode.cu",
    "selective_scan": _KERNELS_DIR / "selective_scan" / "csrc" / "selective_scan.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills into the build log
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# kernel name -> {"seconds": build time, "log": nvcc/ptxas output}
BUILD_LOG: Dict[str, Dict[str, object]] = {}
_LAUNCHES: collections.Counter = collections.Counter()
_BODY_LAUNCHES: collections.Counter = collections.Counter()  # (kernel, body) -> launches


# ---------------------------------------------------------------- dispatch
def on_card(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on a CUDA device (launch the kernel),
    False when every one lies on the CPU (take the plain version). Any
    other mix or device raises: a wrapper never moves data to decide."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        if len({t.device for t in tensors}) != 1:
            raise ValueError("kernel inputs lie on different CUDA devices")
        return True
    raise ValueError(
        f"kernel inputs must all lie on the CPU or all on one CUDA device, got {kinds}"
    )


def refuse_grad(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise ``RuntimeError`` when grad mode is on and any of ``tensors``
    (None entries skipped) requires grad: kernel ``name`` has no backward
    (module note)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, and the kernel has no backward. The JAX "
            "package trains without its kernels (use_pallas=False): train with "
            "RunConfig(use_kernels=False), or call the kernel under torch.no_grad()"
        )


def count_launch(name: str, body: Optional[str] = None) -> None:
    """Record one launch of kernel ``name`` (called only where it launches),
    and of its ``body`` where the kernel has more than one."""
    _LAUNCHES[name] += 1
    if body is not None:
        _BODY_LAUNCHES[(name, body)] += 1


def launch_counts() -> Dict[str, int]:
    """Launches per kernel since the last :func:`reset_launch_counts`."""
    return {name: _LAUNCHES[name] for name in SOURCES}


def body_launch_counts(name: str, bodies: Iterable[str]) -> Dict[str, int]:
    """Launches of each of kernel ``name``'s ``bodies`` since the last
    :func:`reset_launch_counts`."""
    return {body: _BODY_LAUNCHES[(name, body)] for body in bodies}


def reset_launch_counts() -> None:
    """Set every kernel's launch count, and each body's, to 0."""
    _LAUNCHES.clear()
    _BODY_LAUNCHES.clear()


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a kernel's C entry returned a CUDA error code."""
    if rc != 0:
        msg = lib.repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device``, as a C pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    """A tensor's data pointer, as a C pointer (never a 32-bit int)."""
    return ctypes.c_void_p(t.data_ptr())


# ------------------------------------------------------------------- build
def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the hand-written kernels build only where the CUDA "
        "toolkit is installed (CPU tensors take the plain versions)"
    )


def library_path(name: str) -> Path:
    """Where kernel ``name``'s shared library lives once built."""
    src = SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def nvcc_command(name: str, out: Path) -> list:
    """The nvcc command line that builds kernel ``name`` into ``out``."""
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(SOURCES[name])]


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Dict[str, object]]:
    """Build every missing library among ``names`` (default: all), one
    ``nvcc`` per source, all started together. Raises with the compiler's
    output if any build fails. Returns :data:`BUILD_LOG`."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if not library_path(n).is_file()]
    if not todo:
        return BUILD_LOG
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (
            subprocess.Popen(
                nvcc_command(n, tmp),
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp,
            time.perf_counter(),
        )
    failed = []
    for n, (proc, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[n] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{n}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(n))
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    return BUILD_LOG


def library(name: str) -> ctypes.CDLL:
    """Kernel ``name``'s loaded library, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib
