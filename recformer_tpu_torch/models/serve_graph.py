"""CUDA-graph replay of the backbone's forward for serving.

``RecformerModel.forward`` hands every call made without gradients and
without dropout to the model's :class:`ServeGraphs`, which replays a CUDA
graph of the forward where the call allows it (either backbone's,
``models/recformer.Backbone``). Eagerly, the forward is a
chain of about 155 small launches a layer (the dense products' casts, the
float32 LayerNorm chain, the global rows, kernel 1 through ctypes on the
current stream), each launched from Python, and at the serving shapes the
card waits on the host for about half of every call. A graph records one
call's launches; a replay sends them all from one host call. It runs the
same kernels in the same order on the same inputs, so its outputs equal the
eager forward's bit for bit.

A call goes through a graph only when the model has seen its inputs'
signature before and all of these hold, each observable in the call:

- gradients are off and there is no dropout (checked by the model);
- the inputs lie on a CUDA device;
- no stream capture is running on the current stream (an outer graph
  records the eager forward instead);
- no module of the model carries a mesh (``tp`` or ``sp``): collectives do
  not belong in the graph. The pipeline and sequence-parallel paths run the
  embeddings and the encoder themselves and never reach this forward.

A graph's key is every input's shape and dtype (``None`` for an absent
one), the device, and whether inference mode is on: a tensor made in
inference mode cannot be written outside it, so a ``no_grad`` caller never
gets one. A key's first call runs eagerly, so a shape seen once (a last
partial batch) costs no capture. Its second call runs the forward eagerly on
a side stream, which is the warm-up PyTorch's recipe asks for and gives the
call its answer, then captures the same forward on that stream, from static
copies of the inputs, into the model's one memory pool. Later calls copy
their inputs into the static buffers, replay, and return clones of the
static outputs, so a later replay never overwrites a tensor a caller holds.

The graph reads the parameters through their storage: an update in place
(AdamW between the epochs that re-encode the catalog) is seen by the next
replay. When any parameter's storage changes (``param.data = ...``,
``.to()``), the model's graphs, sightings and pool are dropped. The
parameters are listed at the first call that reaches the graphs.

Counters (``utils/profiling.count``): ``serve_graph.captures``,
``serve_graph.replays`` and ``serve_graph.eager`` (calls without gradients
or dropout that ran eagerly: first sightings and calls that did not
qualify). The kernels' wrappers run only while a graph is captured, where
nothing reaches the card: the counts a capture records
(``kernel1.launches``, ``kernel1.tensor_core``, ``global_attn.launches``,
...) are taken back after it and added again at each replay, so every counter counts launches on the
card. The ``launch.kernel<N>`` spans record only in eager and capturing
calls.

Not thread-safe: one caller at a time per model.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..utils.profiling import count, counters


class CudaGraphs:
    """The capture and replay primitive, ``torch.cuda.CUDAGraph``. Tests
    swap in a stand-in with the same four methods."""

    def __init__(self):
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}

    def usable(self, device: torch.device) -> bool:
        return device.type == "cuda" and not torch.cuda.is_current_stream_capturing()

    def new_pool(self, device: torch.device):
        return torch.cuda.graph_pool_handle()

    @contextlib.contextmanager
    def side_stream(self, device: torch.device):
        """The enclosed work on the device's side stream, after the work
        queued on the current stream and before what is queued next."""
        side = self._streams.get(device)
        if side is None:
            side = self._streams[device] = torch.cuda.Stream(device)
        current = torch.cuda.current_stream(device)
        side.wait_stream(current)
        try:
            with torch.cuda.stream(side):
                yield
        finally:
            current.wait_stream(side)

    def capture(self, fn: Callable, args: tuple, pool, device: torch.device):
        """``fn(*args)`` captured on the side stream into ``pool``: returns
        (replay, the static outputs)."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool, stream=self._streams[device]):
            out = fn(*args)
        return graph.replay, out


@contextlib.contextmanager
def taken_back(recorded: Dict[str, int]):
    """The counts made inside, left in ``recorded`` and taken back as the
    block ends: a capture's launches reach no card, and each replay adds
    them again."""
    before = counters()
    yield recorded
    after = counters()
    recorded.update({k: n - before.get(k, 0) for k, n in after.items()
                     if n != before.get(k, 0)})
    for k, n in recorded.items():
        count(k, -n)


class ModelWatch:
    """What a model's graphs depend on beyond their inputs: the storage of
    its parameters, listed at the first look, and whether a module carries a
    mesh (``tp`` or ``sp``)."""

    def __init__(self):
        self._params: Optional[list] = None
        self._meshable: Optional[list] = None
        self._ptrs: Optional[list] = None

    def moved(self, model: torch.nn.Module) -> bool:
        """Whether any parameter's storage changed since the last look (True
        at the first)."""
        if self._params is None:
            self._params = list(model.parameters())
        ptrs = [p.data_ptr() for p in self._params]
        moved, self._ptrs = ptrs != self._ptrs, ptrs
        return moved

    def meshed(self, model: torch.nn.Module) -> bool:
        if self._meshable is None:
            self._meshable = [m for m in model.modules() if hasattr(m, "tp") or hasattr(m, "sp")]
        return any(getattr(m, "tp", None) is not None or getattr(m, "sp", None) is not None
                   for m in self._meshable)


class _Graph(NamedTuple):
    replay: Callable
    inputs: tuple  # the static buffers
    outputs: tuple  # the static (hidden, pooled)
    counts: Dict[str, int]  # what the capture counted


class ServeGraphs:
    """One model's graphs, keyed by the inputs' signature (see the module's
    docstring)."""

    def __init__(self, primitive=None):
        self.primitive = primitive if primitive is not None else CudaGraphs()
        self._watch = ModelWatch()
        self._clear()

    def __reduce__(self):  # a copy or a pickle of the model starts with no graphs
        return type(self), ()

    def _clear(self):
        self._graphs: Dict[tuple, _Graph] = {}
        self._seen: set = set()
        self._pool = None

    def __len__(self) -> int:
        return len(self._graphs)

    def __call__(self, model: torch.nn.Module, forward: Callable, inputs: Tuple) -> tuple:
        """``forward(*inputs)``, a call of ``model``'s backbone without
        gradients or dropout, through a graph where the call qualifies."""
        device = inputs[0].device
        if not self.primitive.usable(device) or self._watch.meshed(model):
            count("serve_graph.eager")
            return forward(*inputs)
        if self._watch.moved(model):
            self._clear()
        key = (device, torch.is_inference_mode_enabled(),
               tuple(None if x is None else (tuple(x.shape), x.dtype) for x in inputs))
        graph = self._graphs.get(key)
        if graph is not None:
            return self._replay(graph, inputs)
        if key not in self._seen:
            self._seen.add(key)
            count("serve_graph.eager")
            return forward(*inputs)
        return self._capture(key, forward, inputs, device)

    def _capture(self, key, forward, inputs, device) -> tuple:
        prim = self.primitive
        if self._pool is None:
            self._pool = prim.new_pool(device)
        with prim.side_stream(device):
            out = forward(*inputs)  # the warm-up, and this call's answer
            static = tuple(None if x is None else x.clone() for x in inputs)
            with taken_back({}) as recorded:
                replay, static_out = prim.capture(forward, static, self._pool, device)
        self._graphs[key] = _Graph(replay, static, static_out, recorded)
        count("serve_graph.captures")
        return out

    def _replay(self, graph: _Graph, inputs) -> tuple:
        for buf, x in zip(graph.inputs, inputs):
            if buf is not None:
                buf.copy_(x)
        graph.replay()
        for k, n in graph.counts.items():
            count(k, n)
        count("serve_graph.replays")
        return tuple(o.clone() for o in graph.outputs)
