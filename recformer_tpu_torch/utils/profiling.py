"""Profiling hooks: a ``torch.profiler`` trace around a span of work, and a
host-side step timer.

Counterpart of ``recformer_tpu/utils/profiling.py``. :func:`trace` records
the host and, on a CUDA device, the card's kernels, synchronises the device
before it stops (so the trace holds every kernel the span launched), and
writes one Chrome-trace JSON, ``trace_<pid>_<ns>.json``, into ``log_dir``.
:class:`StepTimer` is the JAX package's.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str], device=None):
    """Record a ``torch.profiler`` trace of the enclosed work into
    ``log_dir`` (a Chrome-trace JSON); nothing when ``log_dir`` is empty.
    ``device`` is the torch device the work runs on: a CUDA one adds the
    card's activity, and the device is synchronised before the trace
    stops."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device(device) if device is not None else torch.device("cpu")
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield
        finally:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    name = f"trace_{os.getpid()}_{time.time_ns()}.json"
    prof.export_chrome_trace(os.path.join(log_dir, name))


class StepTimer:
    """Wall-clock step timing with EMA and examples/s accounting."""

    def __init__(self, ema: float = 0.9):
        self._ema = ema
        self._avg = None
        self._last = None
        self._count = 0

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self._avg = dt if self._avg is None else self._ema * self._avg + (1 - self._ema) * dt
            self._count += 1
        self._last = now

    @property
    def avg_step_seconds(self) -> Optional[float]:
        return self._avg

    def throughput(self, batch_size: int) -> Optional[float]:
        if not self._avg:
            return None
        return batch_size / self._avg

    def summary(self, batch_size: int) -> Dict[str, float]:
        return {
            "avg_step_ms": (self._avg or 0.0) * 1e3,
            "examples_per_sec": self.throughput(batch_size) or 0.0,
            "steps_timed": self._count,
        }
