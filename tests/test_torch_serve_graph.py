"""The backbone's CUDA-graph dispatch for serving (``models/serve_graph.py``):
when ``RecformerModel.forward`` goes through a graph and when it runs
eagerly, the graphs' keys, the counters, and what a replay returns.

On the CPU the capture and replay primitive is swapped for ``FakeGraphs``:
its capture runs the forward on the static inputs, its replay runs it again
into the static outputs (and, as a graph runs no Python, takes back what
the forward's wrappers counted). The cases marked ``chip`` hold the real
graphs to the eager forward on a CUDA card and skip without one; this file
imports no JAX, so they run there without the suite's conftest:

    python -m pytest --noconftest -m chip tests/test_torch_serve_graph.py
"""

import contextlib
import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from recformer_tpu_torch.config import RecformerConfig
from recformer_tpu_torch.data.device_pipeline import assemble_for_config
from recformer_tpu_torch.models.heads import RecformerForSeqRec
from recformer_tpu_torch.models.recformer import init_weights
from recformer_tpu_torch.models.serve_graph import CudaGraphs, ServeGraphs
from recformer_tpu_torch.utils import profiling
from recformer_tpu_torch.utils.rng import StepRNG

BATCH_KEYS = ("input_ids", "attention_mask", "global_attention_mask", "token_type_ids",
              "item_position_ids")


class FakeGraphs:
    """The primitive's stand-in on the CPU."""

    def usable(self, device):
        return True

    def new_pool(self, device):
        return object()

    def side_stream(self, device):
        return contextlib.nullcontext()

    def capture(self, fn, args, pool, device):
        out = fn(*args)

        def replay():
            before = profiling.counters()
            for o, n in zip(out, fn(*args)):
                o.copy_(n)
            for k, n in profiling.counters().items():
                profiling.count(k, before.get(k, 0) - n)

        return replay, out


@pytest.fixture(autouse=True)
def _clean_counters():
    profiling.reset_counters()
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    profiling.reset_counters()


def graph_counts() -> dict:
    return {k: v for k, v in profiling.counters().items() if k.startswith("serve_graph.")}


def tiny_model(device="cpu", fake=True, **kw):
    cfg = RecformerConfig.tiny(**{"attention_impl": "pallas", "hidden_act": "gelu_tanh",
                                  "dtype": "float32", **kw})
    model = RecformerForSeqRec(cfg)
    init_weights(model, cfg, torch.Generator().manual_seed(0))
    model = model.to(device).eval()
    if fake:
        model.longformer.serve_graphs = ServeGraphs(FakeGraphs())
    return model


def make_batch(cfg, seed, B=3, out_len=32, device="cpu") -> dict:
    """An assembled batch over a random 30-item table: histories of 1-4
    items, so some rows end in padding."""
    rng = np.random.default_rng(seed)
    M = cfg.max_item_token_len
    lengths = rng.integers(3, M + 1, size=31).astype(np.int32)
    lengths[-1] = 0
    table = {
        "token_ids": rng.integers(4, cfg.vocab_size - 1, size=(31, M)).astype(np.int32),
        "token_types": np.tile(np.where(np.arange(M) % 8 < 2, 1, 2).astype(np.int32), (31, 1)),
        "word_begin": rng.integers(0, 2, size=(31, M)).astype(np.int32),
        "lengths": lengths,
    }
    table = {k: torch.from_numpy(v).to(device) for k, v in table.items()}
    ids = torch.from_numpy(rng.integers(0, 30, size=(B, 4)).astype(np.int32)).to(device)
    lens = torch.from_numpy(rng.integers(1, 5, size=B).astype(np.int32)).to(device)
    b = assemble_for_config(table, ids, lens, cfg, out_len=out_len)
    return {k: b[k] for k in BATCH_KEYS}


def backbone(model, batch, **kw):
    return model.longformer(**batch, **kw)


def eager(model, batch):
    with torch.no_grad():
        return model.longformer.forward_eager(*(batch[k] for k in BATCH_KEYS))


def assert_bitwise(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# when the dispatch bypasses the graphs
# ---------------------------------------------------------------------------

def test_cpu_tensors_run_eagerly():
    """The real primitive takes no CPU tensors: every call runs eagerly."""
    model = tiny_model(fake=False)
    batch = make_batch(model.config, 1)
    want = eager(model, batch)
    with torch.no_grad():
        for _ in range(3):
            assert_bitwise(backbone(model, batch), want)
    assert graph_counts() == {"serve_graph.eager": 3}
    assert len(model.longformer.serve_graphs) == 0
    assert not CudaGraphs().usable(torch.device("cpu"))


def test_grad_enabled_bypasses_and_counts_nothing():
    model = tiny_model()
    batch = make_batch(model.config, 1)
    for _ in range(3):
        hidden, _ = backbone(model, batch)
    assert hidden.requires_grad
    assert graph_counts() == {}
    assert len(model.longformer.serve_graphs) == 0


def test_dropout_bypasses_and_counts_nothing():
    model = tiny_model()
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
    model = tiny_model()
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
# the keys
# ---------------------------------------------------------------------------

def test_first_sight_eager_then_capture_then_replay():
    model = tiny_model()
    a, b = make_batch(model.config, 1), make_batch(model.config, 2)
    want_a, want_b = eager(model, a), eager(model, b)
    expected = [{"serve_graph.eager": 1},
                {"serve_graph.eager": 1, "serve_graph.captures": 1},
                {"serve_graph.eager": 1, "serve_graph.captures": 1, "serve_graph.replays": 1}]
    with torch.no_grad():
        for counts in expected:
            assert_bitwise(backbone(model, a), want_a)
            assert graph_counts() == counts
        assert_bitwise(backbone(model, b), want_b)  # the same key, other inputs
    assert graph_counts()["serve_graph.replays"] == 2
    assert len(model.longformer.serve_graphs) == 1


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
    model = tiny_model()
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


def test_a_change_of_parameter_storage_drops_the_graphs():
    model = tiny_model()
    batch = make_batch(model.config, 1)
    with torch.no_grad():
        for _ in range(3):
            backbone(model, batch)
        assert len(model.longformer.serve_graphs) == 1
        w = model.longformer.encoder.layer[0].attention.self.query.weight
        w.data = w.data * 2.0
        want = eager(model, batch)
        assert_bitwise(backbone(model, batch), want)  # a first sighting again
        assert len(model.longformer.serve_graphs) == 0
        assert graph_counts() == {"serve_graph.eager": 2, "serve_graph.captures": 1,
                                  "serve_graph.replays": 1}
        assert_bitwise(backbone(model, batch), want)
        assert_bitwise(backbone(model, batch), want)
    assert graph_counts() == {"serve_graph.eager": 2, "serve_graph.captures": 2,
                              "serve_graph.replays": 2}


def test_an_update_in_place_keeps_the_graphs():
    model = tiny_model()
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
    model = tiny_model()
    batch = make_batch(model.config, 1)
    with torch.no_grad():
        backbone(model, batch)
        backbone(model, batch)
    twin = copy.deepcopy(model)
    assert len(model.longformer.serve_graphs) == 1
    assert len(twin.longformer.serve_graphs) == 0
    assert isinstance(twin.longformer.serve_graphs.primitive, CudaGraphs)


# ---------------------------------------------------------------------------
# counters and what a replay returns
# ---------------------------------------------------------------------------

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
    stub, graphs = _Stub(), ServeGraphs(FakeGraphs())
    x, y = torch.randn(3, 4), torch.randn(3, 4)
    with torch.no_grad():
        want = stub.forward_eager(x, y)
        profiling.reset_counters()
        for _ in range(4):
            assert_bitwise(graphs(stub, stub.forward_eager, (x, y)), want)
    assert profiling.counters() == {
        "kernel1.launches": 8, "kernel1.tensor_core": 4, "serve_graph.eager": 1,
        "serve_graph.captures": 1, "serve_graph.replays": 2}


def test_returned_tensors_are_not_aliased_across_calls():
    model = tiny_model()
    a, b = make_batch(model.config, 1), make_batch(model.config, 2)
    want_a = eager(model, a)
    with torch.no_grad():
        backbone(model, a)
        backbone(model, a)
        got_a = backbone(model, a)
        got_b = backbone(model, b)
    assert_bitwise(got_a, want_a)
    static = model.longformer.serve_graphs._graphs
    (graph,) = static.values()
    ptrs = {t.data_ptr() for t in graph.outputs}
    for t in got_a + got_b:
        assert t.data_ptr() not in ptrs
    assert got_a[0].data_ptr() != got_b[0].data_ptr()


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
    return tiny_model(card, fake=False, **CARD_CONFIGS[name])


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
