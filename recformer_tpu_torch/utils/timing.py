"""Timing on the card: device time per call from a CUDA graph, host time
per call, the device's busy time in a profiler trace, and the card's name
and power limit. Used by the probes' entry points, ``chip_smoke.py`` and
the profile scripts."""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0]


def capture(fn, n: int = 1, stream=None):
    """A CUDA graph of ``n`` calls of ``fn``, captured on ``stream`` (a fresh
    side stream by default) after one warm-up call there, and the output of
    the last captured call. An autograd backward whose forward ran on that
    stream launches there, so it is captured too."""
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(n):
            out = fn()
    return graph, out


def graph_launch_ms(fn, n: int = 25, stream=None) -> float:
    """Device time per call: ``n`` calls captured in one CUDA graph and
    replayed (median of 5 replays), so the host's launch overhead between
    calls is left out."""
    graph, _ = capture(fn, n, stream)
    graph.replay()
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    del graph
    return float(np.median(times))


def host_ms(fn, n: int = 25, warmup: int = 3) -> float:
    """Host time per call: ``n`` back-to-back calls between two
    ``synchronize()``s on the host's clock, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def busy_ms(kernels) -> float:
    """Union of the device kernels' [start, end) intervals (``torch.profiler``
    events), in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3  # us -> ms
