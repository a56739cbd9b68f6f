"""CUDA-graph replay of a model's repeated calls: the serving forward and
the training micro-step.

Eagerly, a Recformer-base forward is a chain of about 155 small launches a
layer (the dense products' casts, the float32 LayerNorm chain, the global
rows, kernel 1 through ctypes on the current stream) and a pretraining
micro-step about 9,900 launches, each sent from Python by the forward or by
autograd's per-node work: at the benchmark's shapes the card waits on the
host for most of every call. A graph records one call's launches; a replay
sends them all from one host call. It runs the same kernels in the same
order on the same inputs, so its outputs equal the eager call's bit for bit.

Two owners hand their calls to a :class:`Graphs`, each deciding per call
whether the call may replay (``graphed``):

- ``models/recformer.Backbone.forward``, every call without gradients and
  without dropout (counters ``serve_graph.*``); the pipeline and
  sequence-parallel paths run the embeddings and the encoder themselves and
  never reach it;
- ``training/steps.py``'s pretraining and fraud steps, their micro-step
  (the batch built on the device, the towers' forward with dropout, the
  loss and ``loss.backward()``) when gradients are on and there is no data
  mesh, no activation recomputation and no gradient held
  (``training/steps.StepGraphs``, counters ``train_graph.*``). The
  optimizer's step stays eager after it (its accumulation divisor and
  learning rate change every call).

Beyond ``graphed``, a call goes through a graph only when its inputs lie on
a CUDA device, no stream capture is running on the current stream (an outer
graph records the eager call instead) and no module of the model carries a
mesh (``tp`` or ``sp``): collectives do not belong in a graph.

A graph's key is the device, whether inference mode is on (a tensor made in
inference mode cannot be written outside it, so a ``no_grad`` caller never
gets one), and every input's shape and dtype (``None`` for an absent one, a
dict's entries by name). A key's first call runs eagerly, so a shape seen
once (a last partial batch) costs no capture. Its second call runs eagerly
on a side stream, which is the warm-up PyTorch's recipe asks for and gives
the call its answer, then is captured on that stream, from static copies of
the inputs, into the owner's one memory pool. Later calls copy their inputs
into the static buffers, replay, and return clones of the static outputs,
so a later replay never overwrites a tensor a caller holds.

The graph reads the parameters through their storage: an update in place
(the optimizer's, or AdamW's between the epochs that re-encode the catalog)
is seen by the next replay. When any parameter's storage changes
(``param.data = ...``, ``.to()``), the owner's graphs, sightings and pool
are dropped. The parameters are listed at the first call that reaches the
graphs.

Counters (``utils/profiling.count``, always on): ``<prefix>.captures``,
``<prefix>.replays`` and ``<prefix>.eager`` (calls handed over that ran
eagerly: first sightings and calls that did not qualify). The kernels'
wrappers run only while a graph is captured, where nothing reaches the
card: the counts a capture records (``kernel1.launches``,
``kernel1.tensor_core``, ``global_attn.launches``, ...) are taken back
after it and added again at each replay, so every counter counts launches
on the card. The spans inside the call (``batch``, ``forward``,
``forward.encoder``, ``backward``, ``launch.*``) record only in eager and
capturing calls.

Not thread-safe: one caller at a time per owner.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, NamedTuple, Optional

import torch

from .profiling import count, counters


class CudaGraphs:
    """The capture and replay primitive, ``torch.cuda.CUDAGraph``. Tests
    swap in a stand-in with the same five methods."""

    def __init__(self):
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}

    def usable(self, device: torch.device) -> bool:
        return device.type == "cuda" and not torch.cuda.is_current_stream_capturing()

    def new_pool(self, device: torch.device):
        return torch.cuda.graph_pool_handle()

    def new_generator(self, device: torch.device) -> torch.Generator:
        return torch.Generator(device)

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

    def capture(self, fn: Callable, args: tuple, pool, device: torch.device,
                generator: Optional[torch.Generator] = None):
        """``fn(*args)`` captured on the side stream into ``pool``, its
        device draws from ``generator`` where one is given: returns
        (replay, the static outputs)."""
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
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


def _flatten(inputs) -> tuple:
    """(the tensors of ``inputs``, each a tensor, None or a dict of tensors,
    in order; the layout: each dict's names, None for the rest)."""
    flat, layout = [], []
    for x in inputs:
        if isinstance(x, dict):
            layout.append(tuple(x))
            flat.extend(x.values())
        else:
            layout.append(None)
            flat.append(x)
    return flat, tuple(layout)


def _unflatten(flat, layout) -> list:
    it = iter(flat)
    return [next(it) if names is None else {n: next(it) for n in names} for names in layout]


class _Graph(NamedTuple):
    replay: Callable
    inputs: list  # the static buffers, flattened (None for an absent input)
    outputs: tuple  # the static outputs
    counts: Dict[str, int]  # what the capture counted
    kept: object  # what the owner's replays need beside them


class Graphs:
    """One owner's graphs over a model, keyed by the inputs' signature and
    counted under ``prefix`` (see the module's docstring). An owner whose
    call does more than return its outputs adds to the capture
    (:meth:`_capturing`) and the replay (:meth:`_replayed`)."""

    def __init__(self, prefix: str, primitive=None):
        self.prefix = prefix
        self.primitive = primitive if primitive is not None else CudaGraphs()
        self._watch = ModelWatch()
        self._generator: Optional[torch.Generator] = None  # registered with every capture
        self._clear()

    def __reduce__(self):  # a copy or a pickle of the model starts with no graphs
        return type(self), (self.prefix,)

    def _clear(self):
        self._graphs: Dict[tuple, _Graph] = {}
        self._seen: set = set()
        self._pool = None

    def __len__(self) -> int:
        return len(self._graphs)

    def __call__(self, model: torch.nn.Module, fn: Callable, inputs: tuple, *args,
                 graphed: bool = True):
        """``fn(*args, *inputs)``, a call over ``model``, through a graph
        where ``graphed`` holds and the call qualifies. Each input is a
        tensor, None or a dict of tensors; ``args`` (a training step's
        ``rng``) are no part of the key."""
        flat, layout = _flatten(inputs)
        device = flat[0].device
        if not (graphed and self.primitive.usable(device)) or self._watch.meshed(model):
            count(self.prefix + ".eager")
            return fn(*args, *inputs)
        if self._watch.moved(model):
            self._clear()
        key = (device, torch.is_inference_mode_enabled(), layout,
               tuple(None if x is None else (tuple(x.shape), x.dtype) for x in flat))
        graph = self._graphs.get(key)
        if graph is not None:
            for buf, x in zip(graph.inputs, flat):
                if buf is not None:
                    buf.copy_(x)
            answer = self._replayed(graph, args)
            for k, n in graph.counts.items():
                count(k, n)
            count(self.prefix + ".replays")
            return answer
        if key not in self._seen:
            self._seen.add(key)
            count(self.prefix + ".eager")
            return fn(*args, *inputs)
        prim = self.primitive
        if self._pool is None:
            self._pool = prim.new_pool(device)
        with prim.side_stream(device), \
                self._capturing(model, fn, args, inputs, device) as (answer, run, kept):
            static = [None if x is None else x.clone() for x in flat]
            with taken_back({}) as recorded:
                replay, out = prim.capture(lambda *xs: run(*_unflatten(xs, layout)),
                                           tuple(static), self._pool, device, self._generator)
        self._graphs[key] = _Graph(replay, static, out, recorded, kept)
        count(self.prefix + ".captures")
        return answer

    @contextlib.contextmanager
    def _capturing(self, model, fn, args, inputs, device):
        """Around a capture, on the side stream: runs the warm-up and yields
        (its answer, the function of the inputs to capture, what the
        replays keep beside the graph)."""
        yield fn(*args, *inputs), functools.partial(fn, *args), None

    def _replayed(self, graph: _Graph, args) -> tuple:
        """Replays ``graph`` for a call with ``args``: the call's answer."""
        graph.replay()
        return tuple(o.clone() for o in graph.outputs)
