"""The card's own power, sampled by ``nvidia-smi`` beside the window, and
its name, power limit and clocks.

``nvidia-smi --query-gpu=timestamp,<field> -lms 100`` runs as a child
of the benchmark's process for as long as the sampler is open. Its
output goes to a pseudo-terminal, so that it writes each line as it
reads it (into a pipe it would hold them in a block until it exits, and
a terminated child loses the block), and a thread reads the lines; each
reading keeps nvidia-smi's own timestamp (wall clock, ms), moved onto
the host's monotonic clock. The field is ``power.draw.instant`` where
nvidia-smi offers it, else ``power.draw``. The energy over an interval is
the trapezoidal integral of the readings, cut at the interval's ends.
Nothing is written to disk.
"""
from __future__ import annotations

import os
import pty
import shutil
import subprocess
import threading
import time
from datetime import datetime
from typing import List, Optional, Tuple

FIELDS = ("power.draw.instant", "power.draw")


def _gpu_index() -> str:
    """The nvidia-smi index of the process's first visible card."""
    vis = os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")[0].strip()
    return vis or "0"


def _query(fields: str) -> Optional[List[str]]:
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    out = subprocess.run([exe, f"--query-gpu={fields}", "--format=csv,noheader,nounits",
                          "-i", _gpu_index()], capture_output=True, text=True, timeout=30)
    if out.returncode != 0:
        return None
    return [v.strip() for v in out.stdout.strip().splitlines()[0].split(",")]


def card() -> dict:
    """Name, power limit (W) and SM clocks (MHz) of the card."""
    vals = _query("name,power.limit,clocks.sm,clocks.max.sm")
    if vals is None:
        raise RuntimeError("nvidia-smi cannot read the card")
    name, limit, sm, sm_max = vals

    def num(v):
        try:
            return float(v)
        except ValueError:
            return None

    return {"name": name, "power_limit_w": num(limit), "sm_clock_mhz": num(sm),
            "sm_clock_max_mhz": num(sm_max)}


class PowerSampler:
    def __init__(self, interval_ms: int = 100):
        self.interval_ms = interval_ms
        self.field: Optional[str] = None
        self.samples: List[Tuple[float, float]] = []
        self._proc: Optional[subprocess.Popen] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        for field in FIELDS:
            vals = _query(field)
            if vals is not None:
                try:
                    float(vals[0])
                except ValueError:
                    continue
                self.field = field
                break
        if self.field is None:
            raise RuntimeError("nvidia-smi reads no power field of the card")
        self._fd, child = pty.openpty()
        self._proc = subprocess.Popen(
            [shutil.which("nvidia-smi"), f"--query-gpu=timestamp,{self.field}",
             "--format=csv,noheader,nounits", "-i", _gpu_index(), f"-lms={self.interval_ms}"],
            stdout=child, stderr=subprocess.DEVNULL, stdin=subprocess.DEVNULL)
        os.close(child)
        self._thread = threading.Thread(target=self._read, daemon=True)
        self._thread.start()

    def _read(self) -> None:
        offset = time.time() - time.monotonic()
        for line in self._lines():
            try:
                stamp, watts = (v.strip() for v in line.split(","))
                wall = datetime.strptime(stamp, "%Y/%m/%d %H:%M:%S.%f").timestamp()
                self.samples.append((wall - offset, float(watts)))
            except ValueError:
                continue

    def wait_past(self, t: float, timeout_s: float = 10.0) -> None:
        """Block until a reading stamped at or after host time ``t`` has
        arrived (raises after ``timeout_s``)."""
        end = time.monotonic() + timeout_s
        while not (self.samples and self.samples[-1][0] >= t):
            if time.monotonic() > end:
                raise RuntimeError(f"nvidia-smi gave no power reading past t = {t:.3f} "
                                   f"within {timeout_s} s")
            time.sleep(0.02)

    def _lines(self):
        buf = b""
        while True:
            try:
                chunk = os.read(self._fd, 4096)
            except OSError:  # the child has exited and the terminal is closed
                return
            if not chunk:
                return
            buf += chunk
            *lines, buf = buf.split(b"\n")
            for line in lines:
                yield line.decode(errors="replace").strip()

    def stop(self) -> None:
        if self._proc is None:
            return
        self._proc.terminate()
        try:
            self._proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait()
        self._thread.join(timeout=10)
        os.close(self._fd)
        self._proc = None

    def energy_j(self, t0: float, t1: float) -> Optional[float]:
        """Joules between host times t0 and t1, or None with fewer than two
        readings around the interval."""
        pts = self.samples
        if len(pts) < 2 or pts[0][0] > t0 or pts[-1][0] < t1:
            return None

        def at(t):
            for (ta, pa), (tb, pb) in zip(pts, pts[1:]):
                if ta <= t <= tb:
                    return pa + (pb - pa) * (t - ta) / max(tb - ta, 1e-12)
            return pts[-1][1]

        inner = [(t0, at(t0))] + [p for p in pts if t0 < p[0] < t1] + [(t1, at(t1))]
        return sum((tb - ta) * (pa + pb) / 2.0 for (ta, pa), (tb, pb) in zip(inner, inner[1:]))
