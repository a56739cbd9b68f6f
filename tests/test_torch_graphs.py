"""The CUDA graphs' lifecycle (``utils/graphs.py``), once for each owner:
the backbone's forward for serving and the pretraining step. A call on the
CPU runs eagerly; a signature's first call runs eagerly, its second
captures, later ones replay; a change of parameter storage drops the graphs;
what a replay returns is its own. On the CPU the primitive is
``graph_harness.FakeGraphs``.
"""

import pytest
import torch
from graph_harness import FakeGraphs, Serving, Training, assert_bitwise, graph_counts
from graph_harness import clean_counters  # noqa: F401  (autouse)

from recformer_tpu_torch.utils import profiling
from recformer_tpu_torch.utils.graphs import CudaGraphs, Graphs

OWNERS = pytest.mark.parametrize("owner", [Serving, Training], ids=["serve", "train"])


def counts(owner, eager, captures=0, replays=0) -> dict:
    p = owner.prefix
    return {f"{p}.eager": eager, **({f"{p}.captures": captures} if captures else {}),
            **({f"{p}.replays": replays} if replays else {})}


@OWNERS
def test_cpu_tensors_run_eagerly(owner):
    """The real primitive takes no CPU tensors: every call runs eagerly."""
    run = owner(CudaGraphs())
    for k in range(3):
        run(k)
    assert graph_counts(owner.prefix) == counts(owner, 3)
    assert len(run.graphs) == 0
    assert not CudaGraphs().usable(torch.device("cpu"))


@OWNERS
def test_first_sight_eager_then_capture_then_replay(owner):
    run = owner(FakeGraphs())
    for k, (captures, replays) in enumerate(((0, 0), (1, 0), (1, 1))):
        run(k)
        assert graph_counts(owner.prefix) == counts(owner, 1, captures, replays)
    run(3, which=1)  # the same key, other inputs
    assert graph_counts(owner.prefix) == counts(owner, 1, 1, 2)
    assert len(run.graphs) == 1


@OWNERS
def test_a_change_of_parameter_storage_drops_the_graphs(owner):
    run = owner(FakeGraphs())
    for k in range(3):
        run(k)
    assert len(run.graphs) == 1
    w = run.model.longformer.encoder.layer[0].attention.self.query.weight
    w.data = w.data * 2.0
    run(3)  # a first sighting again
    assert len(run.graphs) == 0
    assert graph_counts(owner.prefix) == counts(owner, 2, 1, 1)
    run(4)
    run(5)
    assert graph_counts(owner.prefix) == counts(owner, 2, 2, 2)


@OWNERS
def test_returned_tensors_are_not_aliased_across_calls(owner):
    run = owner(FakeGraphs())
    run(0)
    run(1)
    got_a = run(2)
    got_b = run(3, which=1)
    (graph,) = run.graphs._graphs.values()
    static = {t.data_ptr() for t in graph.outputs if t is not None}
    for t in got_a + got_b:
        assert t.data_ptr() not in static
    assert got_a[0].data_ptr() != got_b[0].data_ptr()
    assert not torch.equal(got_a[0], got_b[0])


class _Stub(torch.nn.Module):
    """A backbone stand-in whose forward counts two launches of kernel 1,
    one of them on the tensor cores, as the kernel's wrapper would."""

    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(4, 4)

    def forward_eager(self, x, y):
        profiling.count("kernel1.launches", 2)
        profiling.count("kernel1.tensor_core", 1)
        h = self.lin(x) + y
        return h, h.sum(-1)


def test_replays_add_the_counts_their_capture_recorded():
    stub, graphs = _Stub(), Graphs("serve_graph", FakeGraphs())
    x, y = torch.randn(3, 4), torch.randn(3, 4)
    with torch.no_grad():
        want = stub.forward_eager(x, y)
        profiling.reset_counters()
        for _ in range(4):
            assert_bitwise(graphs(stub, stub.forward_eager, (x, y)), want)
    assert profiling.counters() == {
        "kernel1.launches": 8, "kernel1.tensor_core": 4, "serve_graph.eager": 1,
        "serve_graph.captures": 1, "serve_graph.replays": 2}
