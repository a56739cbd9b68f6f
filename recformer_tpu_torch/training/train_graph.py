"""CUDA-graph replay of a single-device training micro-step.

``training/steps.py``'s pretraining and fraud steps hand their micro-step to
a :class:`TrainGraphs`: the batch built on the device (pair sampling and
whole-word MLM, or the fraud batch's assembly), the towers' forward with
dropout, the loss and ``loss.backward()``. Eagerly that is about 9,900
launches a pretraining micro-step and 4,800 a fraud step, each sent from
Python by the forward or by autograd's per-node work, and the card waits on
the host for most of every step. A graph records one micro-step's launches;
a replay sends them all from one host call. The optimizer's step stays
eager after it (its accumulation divisor and learning rate change every
call).

A replay draws what the eager micro-step draws, value for value:

- the device draws (pairs, MLM, each dropout mask) come from one persistent
  generator of the card, registered with every graph. Before a replay it
  takes the seed and offset at which the step's ``rng.device`` stands, and
  the replay gives each drawing operation the offset its eager call would
  have had (PyTorch's graph-safe Philox state); after it, ``rng.device``
  moves on by the graph's whole increment;
- the attention kernels' seeds are drawn on the host as before, with
  ``ops.window_attention.draw_seed`` from ``rng.host``, as many and in the
  order the eager micro-step draws them (the capture counts them). They
  reach the kernels through a small device buffer (:class:`SeedSlots`),
  refilled before each replay by a non-blocking copy from pinned memory.

A call goes through a graph only when all of these hold, each observable in
the call:

- gradients are on and the inputs lie on a CUDA device;
- no stream capture is running (an outer graph records the eager step);
- no module of the model carries a mesh (``tp`` or ``sp``); the steps'
  own ``mesh`` sends the data-parallel paths down their eager code, so no
  collective goes into a graph;
- the model does not recompute activations (``config.remat``: the
  recomputation re-sets the generators inside the backward);
- no parameter holds a gradient (a graph writes its gradients; it does not
  add to them);
- the call's signature has been seen before.

The key is every input tensor's shape and dtype, the entries of the dict
inputs, and the device. A key's first call runs eagerly, so a shape seen
once costs no capture. Its second call runs the micro-step eagerly on a side
stream, which is the warm-up PyTorch's recipe asks for and gives the call
its answer, then captures it on that stream from static copies of the
inputs into one memory pool, its seeds read from the slots and its device
draws from the persistent generator: the capture leaves the step's
generators where the warm-up left them. Later calls copy their inputs into
the static buffers, load the seeds, replay, point every trained parameter's
``.grad`` at the graph's static gradient (the optimizer sets ``.grad`` to
None after each step) and return clones of the static metrics, so a later
replay never overwrites a tensor a caller holds.

The graph reads the parameters through their storage, so the optimizer's
updates in place are seen by the next replay. When any parameter's storage
changes, the graphs, sightings and pool are dropped.

Counters (``utils/profiling.count``, always on): ``train_graph.captures``,
``train_graph.replays`` and ``train_graph.eager`` (calls that ran eagerly:
first sightings and calls that did not qualify). As with the serving graphs
(``models/serve_graph.py``), the kernels' counts a capture records are taken
back after it and added again at each replay. The spans inside the
micro-step (``batch``, ``forward``, ``forward.encoder``, ``backward``,
``launch.kernel1``, ``launch.kernel2``) record only in eager and capturing
calls.

Not thread-safe: one caller at a time per step.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Sequence

import torch

from ..models import serve_graph
from ..models.serve_graph import ModelWatch, taken_back
from ..ops.window_attention import draw_seed
from ..utils.profiling import count


class CudaGraphs(serve_graph.CudaGraphs):
    """The serving graphs' primitive, whose capture also registers the
    generator the micro-step draws from. Tests swap in a stand-in."""

    def new_generator(self, device: torch.device) -> torch.Generator:
        return torch.Generator(device)

    def capture(self, fn: Callable, args: tuple, pool, device: torch.device,
                generator: torch.Generator):
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(generator)
        with torch.cuda.graph(graph, pool=pool, stream=self._streams[device]):
            out = fn(*args)
        return graph.replay, out


class SeedRecord:
    """Kernel seeds drawn from ``generator`` as :func:`draw_seed` draws them,
    each kept: the warm-up counts the micro-step's seeds."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.drawn: List[int] = []

    def draw_seed(self) -> int:
        seed = draw_seed(self.generator)
        self.drawn.append(seed)
        return seed


class SeedSlots:
    """One graph's kernel seeds in device memory: ``draw_seed()`` hands out
    the slots in turn (the captured launches read them as they run) and
    :meth:`load` fills them for the next run, which takes them from the
    first."""

    def __init__(self, n: int, device: torch.device):
        self.values = torch.zeros(n, dtype=torch.int32, device=device)
        self.taken = 0

    def __len__(self) -> int:
        return len(self.values)

    def draw_seed(self) -> torch.Tensor:
        i = self.taken
        self.taken += 1
        return self.values[i:i + 1]

    def load(self, seeds: Sequence[int]) -> None:
        host = torch.tensor(seeds, dtype=torch.int32, pin_memory=self.values.is_cuda)
        self.values.copy_(host, non_blocking=True)
        self.taken = 0


class _Streams(NamedTuple):
    """A micro-step's generators, in the shape of a ``StepRNG``."""
    seed: int
    host: object  # a torch.Generator, SeedRecord or SeedSlots
    device: torch.Generator


class _Graph(NamedTuple):
    replay: Callable
    inputs: list  # the static buffers, flattened
    names: tuple  # the metrics' names
    metrics: tuple  # the static metrics
    params: list  # the trained parameters
    grads: list  # the static gradient of each, or None where it takes none
    seeds: SeedSlots
    counts: Dict[str, int]  # what the capture counted


def _flatten(inputs) -> tuple:
    """(the tensors of ``inputs``, a tensor or a dict of them each, in
    order; the layout)."""
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


class TrainGraphs:
    """One step's graphs over ``model``, keyed by the inputs' signature (see
    the module's docstring)."""

    def __init__(self, model: torch.nn.Module, primitive=None):
        self.model = model
        self.primitive = primitive if primitive is not None else CudaGraphs()
        self._watch = ModelWatch()
        self._generator = None
        self._clear()

    def _clear(self):
        self._graphs: Dict[tuple, _Graph] = {}
        self._seen: set = set()
        self._pool = None

    def __len__(self) -> int:
        return len(self._graphs)

    def __call__(self, micro: Callable, rng, inputs: tuple) -> Dict[str, torch.Tensor]:
        """``micro(rng, *inputs)``: a micro-step that leaves its gradients in
        the parameters' ``.grad`` and returns its metrics, run through a
        graph where the call qualifies. ``rng`` is a ``StepRNG``; each input
        is a tensor or a dict of them."""
        flat, layout = _flatten(inputs)
        device = flat[0].device
        if not self._qualifies(device):
            count("train_graph.eager")
            return micro(rng, *inputs)
        if self._watch.moved(self.model):
            self._clear()
        key = (device, layout, tuple((tuple(x.shape), x.dtype) for x in flat))
        graph = self._graphs.get(key)
        if graph is not None:
            return self._replay(graph, rng, flat)
        if key not in self._seen:
            self._seen.add(key)
            count("train_graph.eager")
            return micro(rng, *inputs)
        return self._capture(key, micro, rng, flat, layout, device)

    def _qualifies(self, device) -> bool:
        model = self.model
        return (torch.is_grad_enabled() and self.primitive.usable(device)
                and not self._watch.meshed(model) and not model.config.remat
                and all(p.grad is None for p in model.parameters()))

    def _capture(self, key, micro, rng, flat, layout, device) -> Dict[str, torch.Tensor]:
        prim = self.primitive
        if self._pool is None:
            self._pool = prim.new_pool(device)
        if self._generator is None:
            self._generator = prim.new_generator(device)
        params = [p for p in self.model.parameters() if p.requires_grad]
        with prim.side_stream(device):
            record = SeedRecord(rng.host)
            # the warm-up, and this call's answer
            metrics = micro(_Streams(rng.seed, record, rng.device), *_unflatten(flat, layout))
            answer = [p.grad for p in params]
            for p in params:
                p.grad = None
            static = [x.clone() for x in flat]
            seeds = SeedSlots(len(record.drawn), device)
            streams = _Streams(rng.seed, seeds, self._generator)
            names = tuple(metrics)

            def run(*inputs):
                out = micro(streams, *_unflatten(inputs, layout))
                return tuple(out[n] for n in names) + tuple(p.grad for p in params)

            with taken_back({}) as recorded:
                replay, out = prim.capture(run, tuple(static), self._pool, device,
                                           self._generator)
            for p, g in zip(params, answer):
                p.grad = g
        if seeds.taken != len(seeds):
            raise RuntimeError(f"the captured micro-step drew {seeds.taken} kernel seeds, "
                               f"the eager one {len(seeds)}")
        self._graphs[key] = _Graph(replay, static, names, out[:len(names)], params,
                                   list(out[len(names):]), seeds, recorded)
        count("train_graph.captures")
        return metrics

    def _replay(self, graph: _Graph, rng, flat) -> Dict[str, torch.Tensor]:
        for buf, x in zip(graph.inputs, flat):
            buf.copy_(x)
        if len(graph.seeds):
            graph.seeds.load([draw_seed(rng.host) for _ in range(len(graph.seeds))])
        gen = self._generator
        gen.set_state(rng.device.get_state())
        graph.replay()
        rng.device.set_state(gen.get_state())
        for p, g in zip(graph.params, graph.grads):
            p.grad = g
        for k, n in graph.counts.items():
            count(k, n)
        count("train_graph.replays")
        return {n: m.clone() for n, m in zip(graph.names, graph.metrics)}
