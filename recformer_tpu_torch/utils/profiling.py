"""Profiling hooks: a ``torch.profiler`` trace around a span of work, the
program's spans at its layer boundaries, and its counters.

Counterpart of ``recformer_tpu/utils/profiling.py``. :func:`trace` records
the host and, on a CUDA device, the card's kernels, synchronises the device
before it stops (so the trace holds every kernel the span launched), and
writes one Chrome-trace JSON, ``trace_<pid>_<ns>.json``, into ``log_dir``.

Spans (:func:`span`, :func:`spanned`) record only while a ``torch.profiler``
session is recording; otherwise :func:`span` returns one shared no-op
object and records nothing. A recording span enters
``torch.profiler.record_function(name)``, so its range sits on the
profiler's clock beside the kernels it launched, and adds its host
duration, its self time (the duration less the part its child spans cover)
and its count to an in-memory registry keyed by name. Each thread keeps its
own stack of open spans; a span opened on a thread with none open becomes a
child of the innermost span open on the main thread (autograd's device
threads run the kernels' backward wrappers while the main thread waits in
``backward``). Nested spans of one name (``batch`` inside ``batch``) add
their self times to the whole.

The names, at the layer boundaries of ``PERF.md`` §3: ``batch`` (device-side
batch assembly, pairs and whole-word MLM), ``forward`` (a training step's
model call through the loss), ``forward.encoder`` (the backbone),
``backward`` (with the gradient reduction under a mesh), ``optimizer``,
``score`` (similarity against the catalog), ``launch.kernel1`` ..
``launch.kernel5`` and ``launch.add_layernorm`` (the hand-written kernels'
host wrappers) and ``launch.global_attn`` (the full-attention op's wrapper,
``ops/full_attention.py``).

Counters (:func:`count`) are host integers and always on: the kernels'
launches, ``kernel<N>.launches``, ``kernel1.tensor_core`` and
``kernel2.tensor_core`` (those on the tensor cores), ``ablation.launches``
and ``headpair.launches``; ``add_layernorm.launches`` and
``add_layernorm.residual`` (those with a residual sum,
``ops/add_layernorm.py``); the full-attention op's ``global_attn.launches``
and ``global_attn.fused`` (those on a fused backend); the CUDA graphs'
(``utils/graphs.py``), the backbone's for serving ``serve_graph.captures``,
``serve_graph.replays`` and ``serve_graph.eager``, and the training
micro-step's ``train_graph.captures``, ``train_graph.replays`` and
``train_graph.eager``. A replayed graph adds the launch counts its capture
recorded.
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading
import time
from typing import Dict, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

_lock = threading.Lock()
_spans: Dict[str, list] = {}  # name -> [seconds, self seconds, count]
_root = [0.0]  # summed duration of spans without a parent
_counters: Dict[str, int] = {}
_main_stack: list = []  # the main thread's open spans
_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _main_stack if threading.current_thread() is threading.main_thread() else []
        _local.stack = stack
    return stack


class _Off:
    """The shared span of a process with no profiler recording."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "parent", "children_s", "range", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        if stack:
            self.parent = stack[-1]
        elif stack is not _main_stack and _main_stack:
            self.parent = _main_stack[-1]
        else:
            self.parent = None
        stack.append(self)
        self.children_s = 0.0
        self.range = _autograd_profiler.record_function(self.name)
        self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        elapsed = time.perf_counter() - self.t0
        self.range.__exit__(*exc)
        _stack().pop()
        with _lock:
            entry = _spans.get(self.name)
            if entry is None:
                entry = _spans[self.name] = [0.0, 0.0, 0]
            entry[0] += elapsed
            entry[1] += elapsed - self.children_s
            entry[2] += 1
            if self.parent is None:
                _root[0] += elapsed
            else:
                self.parent.children_s += elapsed
        return False


def span(name: str):
    """A context manager over the enclosed work as span ``name``: the shared
    no-op unless a ``torch.profiler`` session is recording."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def spanned(name: str):
    """The decorator form of :func:`span`: each call of the function is one
    span ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _autograd_profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def seconds() -> Dict[str, float]:
    """Each span name's summed host duration since the last reset."""
    with _lock:
        return {k: v[0] for k, v in _spans.items()}


def self_seconds() -> Dict[str, float]:
    """Each span name's summed self time: its durations less the parts
    their child spans cover."""
    with _lock:
        return {k: v[1] for k, v in _spans.items()}


def span_counts() -> Dict[str, int]:
    """How many times each span name closed since the last reset."""
    with _lock:
        return {k: v[2] for k, v in _spans.items()}


def root_seconds() -> float:
    """The summed duration of the spans that had no parent; it equals the
    sum of every span's self time."""
    with _lock:
        return _root[0]


def reset() -> None:
    """Empty the span registry (the counters stay)."""
    with _lock:
        _spans.clear()
        _root[0] = 0.0


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> Dict[str, int]:
    """Every counter since the last :func:`reset_counters`."""
    with _lock:
        return dict(_counters)


def reset_counters() -> None:
    with _lock:
        _counters.clear()


@contextlib.contextmanager
def trace(log_dir: Optional[str], device=None):
    """Record a ``torch.profiler`` trace of the enclosed work into
    ``log_dir`` (a Chrome-trace JSON, the program's spans among its host
    ranges); nothing when ``log_dir`` is empty. ``device`` is the torch
    device the work runs on: a CUDA one adds the card's activity, and the
    device is synchronised before the trace stops. The span registry is
    emptied first, so it holds the traced work alone."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device(device) if device is not None else torch.device("cpu")
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset()
    with profile(activities=activities) as prof:
        try:
            yield
        finally:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    name = f"trace_{os.getpid()}_{time.time_ns()}.json"
    prof.export_chrome_trace(os.path.join(log_dir, name))
