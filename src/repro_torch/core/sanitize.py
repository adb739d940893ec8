"""Runtime sanitizer lanes for the batched episode engine.

The port of ``repro.core.sanitize``. Two independent tools, both free
when off:

- **NaN lane** (``REPRO_CHECKIFY=1``, read at call time). PyTorch has no
  ``checkify``, so the engine's ``_run`` keeps a :class:`NanWatch`: one
  device flag per checked value — the carry's float fields and each
  step's float outputs (the measured τ and p) — holding the first step at
  which that value held a NaN. The flags are written on the device, with
  no host read inside the loop; after the last step one read raises
  :class:`SanitizeError` if any is set, naming the fields and steps. The
  lane reads the engine's values and writes none of them, so lane on and
  lane off give identical records and the same dcov launches.

  It gives the reference's verdict per cell family. A NaN measurement
  (the poisoned landscape, or a fault cell's dropped telemetry, NaN by
  design in its tables) raises, as the reference's ``checkify`` does
  ("nan generated by primitive: sub"); static, drift, offload, cotenant
  and fleet episodes run clean. An infinity is not an error (``best_r``
  starts at ``-inf`` by design); a NaN is.

  ``checkify.div_checks`` has nothing to check here: the only integer
  division in the step kinds is ``core/faults.py::mad_reject_batch``'s
  lower-median index ``(n_valid - 1) // 2``, whose divisor is the
  constant 2.

- **Build-count guard** (:func:`count_builds`), the port's counterpart
  of ``count_compiles``. What the port builds per spec or model is
  counted by name: ``stage`` — a spec's constants packed on the host and
  staged on a device (misses of ``core/episode.py``'s ``_packed_consts``
  and ``_device_consts`` caches, the larger of the two, so a cold spec on
  a cold device stages once); ``nvcc:<kernel>`` — a kernel library built
  (a new entry of ``kernels/runtime.py``'s ``BUILD_LOG``); and
  ``capture:<model>`` — a CUDA graph captured by the serving engine (a
  rise of ``serving/engine.py::capture_counts``). A cold run of a fresh
  spec stages once; the same spec with fresh seeds builds nothing.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Iterator, List

import torch

from repro_torch.envflags import env_flag


class SanitizeError(RuntimeError):
    """A checked engine value held a NaN."""


def checkify_enabled() -> bool:
    """The REPRO_CHECKIFY=1 lane (single parser: envflags)."""
    return env_flag("REPRO_CHECKIFY")


class NanWatch:
    """The first step at which each checked value held a NaN, kept on the
    device: ``observe`` once per step (the same names every step), then
    ``check`` once, after the last step."""

    def __init__(self) -> None:
        self.names: List[str] = []
        self.first = None  # (F,) int32 on the device, -1 while clean

    def observe(self, step: int, values: Dict[str, torch.Tensor]) -> None:
        """Record ``step`` for every float value that holds a NaN now and
        held none before."""
        floats = {name: v for name, v in values.items() if v.is_floating_point()}
        if self.first is None:
            self.names = list(floats)
            dev = next(iter(floats.values())).device
            self.first = torch.full((len(floats),), -1, dtype=torch.int32, device=dev)
        nan = torch.stack([torch.isnan(floats[name]).any() for name in self.names])
        self.first = torch.where(nan & (self.first < 0), step, self.first)

    def check(self) -> None:
        """One host read: raise :class:`SanitizeError` if any value held a
        NaN, naming each such value and its first step."""
        if self.first is None:
            return
        steps = self.first.cpu().tolist()
        bad = sorted((t, name) for name, t in zip(self.names, steps) if t >= 0)
        if bad:
            raise SanitizeError(
                "nan generated in the episode engine: "
                + ", ".join(f"{name} at step {t}" for t, name in bad)
            )


class BuildLog:
    """Builds counted by :func:`count_builds`: ``total`` across all names,
    ``count(name)`` per name. Filled when the block exits."""

    def __init__(self) -> None:
        self.names: List[str] = []

    @property
    def total(self) -> int:
        return len(self.names)

    def count(self, name: str) -> int:
        return sum(1 for n in self.names if n == name)


@contextmanager
def count_builds() -> Iterator[BuildLog]:
    """Count what the block builds::

        with count_builds() as cold:
            run_coral_batch(space, lt, lp, targets, seeds=(0, 1), iters=13)
        assert cold.count("stage") == 1   # the spec's constants, once
        with count_builds() as warm:
            run_coral_batch(space, lt, lp, targets, seeds=(2, 3), iters=13)
        assert warm.total == 0            # same spec, fresh data

    Counters reset inside the block (``reset_capture_counts``) count what
    was captured after the reset."""
    from repro_torch.core import episode
    from repro_torch.kernels import runtime
    from repro_torch.serving import engine

    log = BuildLog()
    packed0 = episode._packed_consts.cache_info().misses
    staged0 = episode._device_consts.cache_info().misses
    built0 = set(runtime.BUILD_LOG)
    captured0 = engine.capture_counts()
    try:
        yield log
    finally:
        packed = episode._packed_consts.cache_info().misses - packed0
        staged = episode._device_consts.cache_info().misses - staged0
        log.names += ["stage"] * max(packed, staged, 0)
        log.names += [f"nvcc:{name}" for name in runtime.BUILD_LOG if name not in built0]
        for model, n in sorted(engine.capture_counts().items()):
            before = captured0.get(model, 0)
            log.names += [f"capture:{model}"] * (n - before if n >= before else n)
