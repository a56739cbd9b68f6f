"""The backbone's dispatch to its CUDA graphs for serving
(``models/recformer.Backbone.forward``, ``utils/graphs.py``): which calls
bypass the graphs, the graphs' keys, and what an update of the weights does.
The lifecycle both owners share is ``test_torch_graphs.py``'s.

On the CPU the capture and replay primitive is ``graph_harness.FakeGraphs``.
The cases marked ``chip`` hold the real graphs to the eager forward on a
CUDA card and skip without one; this file imports no JAX, so they run there
without the suite's conftest:

    python -m pytest --noconftest -m chip tests/test_torch_serve_graph.py
"""

import copy
from types import SimpleNamespace

import pytest
import torch
from graph_harness import FakeGraphs, assert_bitwise, backbone, eager, make_batch, tiny_model
from graph_harness import clean_counters  # noqa: F401  (autouse)
from graph_harness import graph_counts as _graph_counts

from recformer_tpu_torch.utils import profiling
from recformer_tpu_torch.utils.graphs import CudaGraphs
from recformer_tpu_torch.utils.rng import StepRNG


def graph_counts() -> dict:
    return _graph_counts("serve_graph")


def fake_model(**kw):
    return tiny_model(primitive=FakeGraphs(), **kw)


# ---------------------------------------------------------------------------
# when the dispatch bypasses the graphs
# ---------------------------------------------------------------------------

def test_grad_enabled_bypasses_and_counts_nothing():
    model = fake_model()
    batch = make_batch(model.config, 1)
    for _ in range(3):
        hidden, _ = backbone(model, batch)
    assert hidden.requires_grad
    assert graph_counts() == {}
    assert len(model.longformer.serve_graphs) == 0


def test_dropout_bypasses_and_counts_nothing():
    model = fake_model()
    batch = make_batch(model.config, 1)
    with torch.no_grad():
        for i in range(3):
            backbone(model, batch, deterministic=False, rng=StepRNG(i))
    assert graph_counts() == {}
    assert len(model.longformer.serve_graphs) == 0


@pytest.mark.parametrize("axis", ["tp", "sp"])
def test_a_mesh_bypasses(axis):
    """A mesh on the attention cores (one model rank, so the eager forward
    runs alone) keeps every call eager."""
    model = fake_model()
    mesh = SimpleNamespace(model_group=None, n_model=1, model_rank=0)
    for layer in model.longformer.encoder.layer:
        setattr(layer.attention.self, axis, mesh)
    batch = make_batch(model.config, 1)
    want = eager(model, batch)
    with torch.no_grad():
        for _ in range(3):
            assert_bitwise(backbone(model, batch), want)
    assert graph_counts() == {"serve_graph.eager": 3}
    assert len(model.longformer.serve_graphs) == 0


# ---------------------------------------------------------------------------
# the keys and the weights
# ---------------------------------------------------------------------------

def _vary(kind, model, batch):
    """A call of the backbone whose key differs from a no_grad call on
    ``batch`` in one part: the shape, an input's dtype or inference mode."""
    if kind == "shape":
        small = {k: v[:2] for k, v in batch.items()}
        return torch.no_grad, small
    if kind == "dtype":
        return torch.no_grad, {k: v.long() for k, v in batch.items()}
    return torch.inference_mode, batch


@pytest.mark.parametrize("kind", ["shape", "dtype", "inference_mode"])
def test_each_part_of_the_key_makes_its_own_graph(kind):
    model = fake_model()
    batch = make_batch(model.config, 1)
    mode, other = _vary(kind, model, batch)
    want = eager(model, other)
    with torch.no_grad():
        backbone(model, batch)
        backbone(model, batch)
    assert graph_counts() == {"serve_graph.eager": 1, "serve_graph.captures": 1}
    for n_eager, n_captures, n_replays in ((2, 1, 0), (2, 2, 0), (2, 2, 1)):
        with mode():
            got = backbone(model, other)
        assert_bitwise(got, want)
        assert graph_counts() == {"serve_graph.eager": n_eager,
                                  "serve_graph.captures": n_captures,
                                  **({"serve_graph.replays": n_replays} if n_replays else {})}
    assert len(model.longformer.serve_graphs) == 2
    with torch.no_grad():
        hidden, pooled = backbone(model, batch)
    assert not hidden.is_inference() and not pooled.is_inference()


def test_an_update_in_place_keeps_the_graphs():
    model = fake_model()
    batch = make_batch(model.config, 1)
    with torch.no_grad():
        backbone(model, batch)
        backbone(model, batch)
        before = backbone(model, batch)
        model.longformer.encoder.layer[1].output.dense.weight.add_(0.05)
        want = eager(model, batch)
        got = backbone(model, batch)
    assert_bitwise(got, want)
    assert not torch.equal(got[1], before[1])
    assert graph_counts() == {"serve_graph.eager": 1, "serve_graph.captures": 1,
                              "serve_graph.replays": 2}


def test_a_copy_of_the_model_starts_without_graphs():
    model = fake_model()
    batch = make_batch(model.config, 1)
    with torch.no_grad():
        backbone(model, batch)
        backbone(model, batch)
    twin = copy.deepcopy(model)
    assert len(model.longformer.serve_graphs) == 1
    assert len(twin.longformer.serve_graphs) == 0
    assert isinstance(twin.longformer.serve_graphs.primitive, CudaGraphs)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


CARD_CONFIGS = {
    # float32: kernel 1's CUDA-core version
    "float32": dict(),
    # bf16 at D = W = 64: kernel 1's tensor-core version, as at Recformer-base
    "bfloat16": dict(dtype="bfloat16", hidden_size=128, num_attention_heads=2,
                     intermediate_size=256, attention_window=(64, 64), item_seq_len=64),
}


def card_model(card, name):
    return tiny_model(card, **CARD_CONFIGS[name])


@pytest.mark.chip
@pytest.mark.parametrize("name", sorted(CARD_CONFIGS))
def test_chip_replay_equals_eager_bitwise(card, name):
    model = card_model(card, name)
    n_layers = model.config.num_hidden_layers
    a, b = (make_batch(model.config, s, B=4, out_len=128, device=card) for s in (1, 2))
    want_a, want_b = eager(model, a), eager(model, b)
    with torch.no_grad():
        for _ in range(3):
            assert_bitwise(backbone(model, a), want_a)
        before = profiling.counters()["kernel1.launches"]
        assert_bitwise(backbone(model, b), want_b)
    assert profiling.counters()["kernel1.launches"] - before == n_layers
    assert graph_counts() == {"serve_graph.eager": 1, "serve_graph.captures": 1,
                              "serve_graph.replays": 2}


@pytest.mark.chip
def test_chip_an_update_in_place_is_seen_by_the_next_replay(card):
    model = card_model(card, "bfloat16")
    batch = make_batch(model.config, 1, B=4, out_len=128, device=card)
    with torch.no_grad():
        for _ in range(3):
            before = backbone(model, batch)
        model.longformer.encoder.layer[0].intermediate.dense.weight.mul_(1.5)
        want = eager(model, batch)
        got = backbone(model, batch)
    assert_bitwise(got, want)
    assert not torch.equal(got[1], before[1])
    assert graph_counts()["serve_graph.replays"] == 2


@pytest.mark.chip
def test_chip_returned_tensors_are_not_aliased(card):
    model = card_model(card, "bfloat16")
    a, b = (make_batch(model.config, s, B=4, out_len=128, device=card) for s in (1, 2))
    want_a = eager(model, a)
    with torch.inference_mode():
        backbone(model, a)
        backbone(model, a)
        got_a = backbone(model, a)
        got_b = backbone(model, b)
        torch.cuda.synchronize()
    assert_bitwise(got_a, want_a)
    assert not torch.equal(got_a[1], got_b[1])


@pytest.mark.chip
def test_chip_inside_an_outer_capture_the_forward_runs_eagerly(card):
    model = card_model(card, "bfloat16")
    batch = make_batch(model.config, 1, B=4, out_len=128, device=card)
    want = eager(model, batch)
    outer = torch.cuda.CUDAGraph()
    with torch.no_grad():
        with torch.cuda.graph(outer):
            got = backbone(model, batch)
        outer.replay()
        torch.cuda.synchronize()
    assert_bitwise(got, want)
    assert graph_counts() == {"serve_graph.eager": 1}
