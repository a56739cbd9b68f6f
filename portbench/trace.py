"""A profiled stretch of a cell's units, read from ``torch.profiler``: the
device's busy time (the union of kernel intervals, as
``recformer_tpu_torch/utils/timing.busy_ms`` takes it), the stretch's own
wall time, each kernel's device time by name, the kernels launched, and
the breakdown the result line carries (the device operations that took
most time, the longest idle gaps by the host operation under them)."""

from __future__ import annotations

import bisect
import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch


@dataclass
class Stretch:
    units: int
    window_s: float
    busy_s: float
    kernels: int
    kernel_s: Dict[str, float] = field(default_factory=dict)  # summed by name
    idle_by_host: Dict[str, float] = field(default_factory=dict)

    def seconds_matching(self, pattern: str) -> float:
        """Device seconds of the kernels whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(s for n, s in self.kernel_s.items() if rx.search(n))

    def breakdown(self) -> dict:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:160], v] for k, v in ops],
                "idle_gaps": [[k[:160], v] for k, v in gaps]}


def _union(spans: List[Tuple[float, float]]):
    """Merged [start, end) intervals, sorted."""
    out: List[List[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile(unit, units: int) -> Stretch:
    """Run ``unit`` ``units`` times under the profiler (CPU and CUDA
    activities) and read the stretch."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(units):
            unit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    by_name: Dict[str, float] = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e6
    busy = _union([(e.time_range.start, e.time_range.end) for e in dev])
    busy_s = sum(e - s for s, e in busy) / 1e6
    return Stretch(units=units, window_s=wall, busy_s=busy_s, kernels=len(dev),
                   kernel_s=by_name, idle_by_host=_label_gaps(busy, host))


def _label_gaps(busy, host, keep: int = 200) -> Dict[str, float]:
    """The ``keep`` longest gaps between busy intervals, summed by the
    innermost host operation that spans each gap's middle."""
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:keep]
    spans = sorted(((e.time_range.start, e.time_range.end, e.name) for e in host),
                   key=lambda t: t[0])
    starts = [t[0] for t in spans]
    out: Dict[str, float] = {}
    for s, e in gaps:
        mid = (s + e) / 2
        label = "(no host operation)"
        # host operations nest: the latest-starting one that spans the
        # middle is the innermost
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(-1, i - 20000), -1):
            if spans[j][1] >= mid:
                label = spans[j][2]
                break
        out[label] = out.get(label, 0.0) + (e - s) / 1e6
    return out
