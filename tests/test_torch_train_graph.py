"""The training micro-step's CUDA graphs (``training/train_graph.py``): when
the pretraining and fraud steps go through a graph and when they run
eagerly, the graphs' keys, the counters, the draws a replay makes and what
it returns.

On the CPU the capture and replay primitive is swapped for ``FakeGraphs``:
its capture runs the micro-step on the static inputs, its replay runs it
again into the static outputs (and, as a graph runs no Python, takes back
what the micro-step's wrappers counted). On the CPU a ``StepRNG``'s two
generators are one, so these tests give the device draws a generator of
their own, as on a card. The cases marked ``chip`` hold the real graphs to
the eager step on a CUDA card, bit for bit, and skip without one; this file
imports no JAX, so they run there without the suite's conftest:

    python -m pytest --noconftest -m chip tests/test_torch_train_graph.py
"""

import contextlib
import copy

import numpy as np
import pytest
import torch

from recformer_tpu_torch.config import RecformerConfig
from recformer_tpu_torch.models.heads import RecformerForFraudDetection, RecformerForPretraining
from recformer_tpu_torch.models.recformer import init_weights
from recformer_tpu_torch.ops import window_attention as wa
from recformer_tpu_torch.training import steps
from recformer_tpu_torch.training.optimizer import create_optimizer
from recformer_tpu_torch.training.train_graph import CudaGraphs, SeedRecord, SeedSlots
from recformer_tpu_torch.utils import profiling
from recformer_tpu_torch.utils.rng import StepRNG, fold_in


class FakeGraphs:
    """The primitive's stand-in on the CPU; ``outer_capture`` plays a
    stream capture running around the call."""

    outer_capture = False

    def usable(self, device):
        return not self.outer_capture

    def new_pool(self, device):
        return object()

    def new_generator(self, device):
        return torch.Generator(device)

    def side_stream(self, device):
        return contextlib.nullcontext()

    def capture(self, fn, args, pool, device, generator):
        out = fn(*args)

        def replay():
            before = profiling.counters()
            for o, n in zip(out, fn(*args)):
                if o is not None:
                    o.copy_(n)
            for k, n in profiling.counters().items():
                profiling.count(k, before.get(k, 0) - n)

        return replay, out


class Eager(CudaGraphs):
    """The real primitive, refusing every call: the step runs eagerly."""

    def usable(self, device):
        return False


class SplitRNG(StepRNG):
    """A ``StepRNG`` whose device draws come from a generator of their own,
    as on a card (on the CPU its two generators are one)."""

    def __init__(self, seed, device="cpu"):
        super().__init__(seed, device)
        if self.device is self.host:
            self.device = torch.Generator().manual_seed(fold_in(seed, 1))


@pytest.fixture(autouse=True)
def _clean_counters():
    profiling.reset_counters()
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    profiling.reset_counters()


def graph_counts() -> dict:
    return {k: v for k, v in profiling.counters().items() if k.startswith("train_graph.")}


def tiny_config(**kw):
    return RecformerConfig.tiny(**{"attention_impl": "pallas", "hidden_act": "gelu_tanh",
                                   "dtype": "float32", **kw})


def make_table(cfg, n_items=30, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    M = cfg.max_item_token_len
    lengths = rng.integers(3, M + 1, size=n_items + 1).astype(np.int32)
    lengths[-1] = 0
    table = {
        "token_ids": rng.integers(4, cfg.vocab_size - 1, size=(n_items + 1, M)).astype(np.int32),
        "token_types": np.tile(np.where(np.arange(M) % 8 < 2, 1, 2).astype(np.int32),
                               (n_items + 1, 1)),
        "word_begin": rng.integers(0, 2, size=(n_items + 1, M)).astype(np.int32),
        "lengths": lengths,
    }
    return {k: torch.from_numpy(v).to(device) for k, v in table.items()}


def histories(seed, B=4, S=10, n_items=30, device="cpu"):
    """(item ids, lengths, fraud labels) of B rows of 2-S items."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n_items, size=(B, S)).astype(np.int32)
    lens = rng.integers(2, S + 1, size=B).astype(np.int32)
    labels = (np.arange(B) % 2).astype(np.int32)
    return tuple(torch.from_numpy(a).to(device) for a in (ids, lens, labels))


class Run:
    """One task's model, optimizer and step, and a record of what each
    optimizer step received and left: the gradients it was handed, the
    parameters after it."""

    def __init__(self, task, cfg, device="cpu", primitive=None, accum=2, seed=0):
        cls = RecformerForPretraining if task == "pretrain" else RecformerForFraudDetection
        torch.manual_seed(seed)
        model = cls(cfg)
        init_weights(model, cfg, torch.Generator().manual_seed(seed))
        self.model = model.to(device)
        self.task, self.device = task, device
        self.opt = create_optimizer(self.model, learning_rate=1e-3, warmup_steps=0,
                                    total_steps=1000, grad_accum_steps=accum if task == "pretrain"
                                    else 1)
        make = steps.make_pretrain_step if task == "pretrain" else steps.make_fraud_train_step
        self.step = make(cfg, self.model, self.opt)
        if primitive is not None:
            self.step.graphs.primitive = primitive
        self.grads, self.params = [], []
        real = self.opt.step

        def recorded():
            self.grads.append([None if p.grad is None else p.grad.detach().clone()
                               for p in self.model.parameters()])
            took = real()
            if took:
                self.params.append([p.detach().clone() for p in self.model.parameters()])
            return took

        self.opt.step = recorded

    def __call__(self, k, table, ids, lens, labels, rng_cls=SplitRNG):
        if self.task == "pretrain":
            return self.step(rng_cls(fold_in(7, k), self.device), table, ids, lens)
        valid = torch.ones(ids.shape[0], dtype=torch.bool, device=ids.device)
        return self.step(7, table, ids, lens, labels, valid)


def equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(equal(x, y) for x, y in zip(a, b))
    if a is None or b is None:
        return a is b
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.fixture
def split_fraud_rng(monkeypatch):
    """The fraud step makes its own ``StepRNG``: give it the split one."""
    monkeypatch.setattr(steps, "StepRNG", SplitRNG)


# ---------------------------------------------------------------------------
# when the step bypasses the graphs
# ---------------------------------------------------------------------------

def test_cpu_tensors_run_eagerly():
    """The real primitive takes no CPU tensors: every call runs eagerly."""
    cfg = tiny_config()
    run = Run("pretrain", cfg)
    table, (ids, lens, labels) = make_table(cfg), histories(1)
    for k in range(3):
        run(k, table, ids, lens, labels)
    assert graph_counts() == {"train_graph.eager": 3}
    assert len(run.step.graphs) == 0
    assert not CudaGraphs().usable(torch.device("cpu"))


def _bypassed(kind):
    """A pretraining run on the stand-in whose calls do not qualify, for
    one reason: a mesh on a module, activation recomputation, an outer
    capture or a gradient already held."""
    cfg = tiny_config(remat=(kind == "remat"))
    run = Run("pretrain", cfg, primitive=FakeGraphs())
    if kind == "mesh":
        run.model.longformer.encoder.layer[0].attention.self.sp = object()
    if kind == "outer_capture":
        run.step.graphs.primitive.outer_capture = True
    if kind == "gradient_held":
        w = run.model.longformer.embeddings.word_embeddings.weight
        w.grad = torch.zeros_like(w)
        run.opt.step = lambda: False  # nothing clears it
    return run


@pytest.mark.parametrize("kind", ["mesh", "remat", "outer_capture", "gradient_held"])
def test_a_call_that_does_not_qualify_runs_eagerly(kind):
    run = _bypassed(kind)
    cfg = run.model.config
    table, (ids, lens, labels) = make_table(cfg), histories(1)
    for k in range(3):
        run(k, table, ids, lens, labels)
    assert graph_counts() == {"train_graph.eager": 3}
    assert len(run.step.graphs) == 0


# ---------------------------------------------------------------------------
# the sequence of calls, and what a replay computes
# ---------------------------------------------------------------------------

def _twins(task, **kw):
    cfg = tiny_config(**kw)
    return cfg, Run(task, cfg, primitive=FakeGraphs()), Run(task, cfg, primitive=Eager())


@pytest.mark.parametrize("task", ["pretrain", "fraud"])
def test_replay_equals_the_eager_step(task, split_fraud_rng):
    """Every call's metrics, the gradients each optimizer step gets and the
    parameters after each update equal the eager step's, bit for bit,
    through the eager call, the capture and the replays (three updates)."""
    cfg, graphed, eager = _twins(task)
    table, (ids, lens, labels) = make_table(cfg), histories(1)
    n = 6 if task == "pretrain" else 4
    for k in range(n):
        assert equal(graphed(k, table, ids, lens, labels), eager(k, table, ids, lens, labels))
    assert equal(graphed.grads, eager.grads) and len(graphed.grads) == n
    assert equal(graphed.params, eager.params) and len(graphed.params) == (3 if n == 6 else 4)
    assert graph_counts() == {"train_graph.eager": 1 + n, "train_graph.captures": 1,
                              "train_graph.replays": n - 2}


def test_first_sight_eager_then_capture_then_replay():
    cfg = tiny_config()
    run = Run("pretrain", cfg, primitive=FakeGraphs())
    table, (ids, lens, labels) = make_table(cfg), histories(1)
    expected = [{"train_graph.eager": 1},
                {"train_graph.eager": 1, "train_graph.captures": 1},
                {"train_graph.eager": 1, "train_graph.captures": 1, "train_graph.replays": 1},
                {"train_graph.eager": 1, "train_graph.captures": 1, "train_graph.replays": 2}]
    for k, counts in enumerate(expected):
        run(k, table, ids, lens, labels)
        assert graph_counts() == counts
    assert len(run.step.graphs) == 1


def test_a_new_signature_makes_a_new_graph():
    cfg = tiny_config()
    run = Run("pretrain", cfg, primitive=FakeGraphs())
    table = make_table(cfg)
    wide, narrow = histories(1, B=4), histories(2, B=2)
    for k in range(3):
        run(k, table, *wide)
    for k, (n_eager, n_captures, n_replays) in enumerate(((2, 1, 1), (2, 2, 1), (2, 2, 2))):
        run(3 + k, table, *narrow)
        assert graph_counts() == {"train_graph.eager": n_eager,
                                  "train_graph.captures": n_captures,
                                  "train_graph.replays": n_replays}
    assert len(run.step.graphs) == 2


def test_a_change_of_parameter_storage_drops_the_graphs():
    cfg = tiny_config()
    run = Run("pretrain", cfg, primitive=FakeGraphs())
    table, (ids, lens, labels) = make_table(cfg), histories(1)
    for k in range(3):
        run(k, table, ids, lens, labels)
    assert len(run.step.graphs) == 1
    w = run.model.longformer.encoder.layer[0].attention.self.query.weight
    w.data = w.data.clone()
    run(3, table, ids, lens, labels)  # a first sighting again
    assert len(run.step.graphs) == 0
    assert graph_counts() == {"train_graph.eager": 2, "train_graph.captures": 1,
                              "train_graph.replays": 1}


def test_a_replay_draws_the_eager_steps_seeds_and_moves_its_generators_alike():
    """The kernel seeds a replay loads are the values, in order and in
    number (two layers, two towers), that the eager step draws from the same
    ``StepRNG``; after the replay both of its generators stand where the
    eager step leaves them."""
    cfg, graphed, eager = _twins("pretrain")
    table, (ids, lens, labels) = make_table(cfg), histories(1)
    for k in range(2):
        graphed(k, table, ids, lens, labels)
        eager(k, table, ids, lens, labels)
    mine, theirs = SplitRNG(fold_in(7, 2)), SplitRNG(fold_in(7, 2))
    graphed.step(mine, table, ids, lens)
    record = SeedRecord(theirs.host)
    eager.step(_with_host(theirs, record), table, ids, lens)
    (graph,) = graphed.step.graphs._graphs.values()
    assert graph_counts()["train_graph.replays"] == 1
    assert len(record.drawn) == 2 * cfg.num_hidden_layers
    assert graph.seeds.values.tolist() == record.drawn
    assert torch.equal(mine.host.get_state(), theirs.host.get_state())
    assert torch.equal(mine.device.get_state(), theirs.device.get_state())


def _with_host(rng, host):
    """``rng`` drawing its kernel seeds through ``host`` (a SeedRecord)."""
    twin = copy.copy(rng)
    twin.host = host
    return twin


def test_seed_slots_hand_out_views_of_their_buffer():
    slots = SeedSlots(3, torch.device("cpu"))
    slots.load([5, 6, 7])
    got = [wa.draw_seed(slots) for _ in range(3)]
    assert [int(s) for s in got] == [5, 6, 7]
    assert all(s.data_ptr() == slots.values[i:i + 1].data_ptr() for i, s in enumerate(got))
    slots.load([8, 9, 10])
    assert int(wa.draw_seed(slots)) == 8 and int(got[2]) == 10


def test_returned_metrics_are_not_aliased_across_calls():
    cfg = tiny_config()
    run = Run("pretrain", cfg, primitive=FakeGraphs())
    table, (ids, lens, labels) = make_table(cfg), histories(1)
    got = [run(k, table, ids, lens, labels) for k in range(4)]
    (graph,) = run.step.graphs._graphs.values()
    static = {t.data_ptr() for t in graph.metrics}
    for m in got:
        assert not any(t.data_ptr() in static for t in m.values())
    assert got[2]["loss"].data_ptr() != got[3]["loss"].data_ptr()
    assert not torch.equal(got[2]["loss"], got[3]["loss"])  # other draws, other losses


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def card_config():
    """bf16 at D = W = 64: kernels 1-2 on the tensor cores, as at
    Recformer-base; dropout 0.1."""
    return tiny_config(dtype="bfloat16", hidden_size=128, num_attention_heads=2,
                       intermediate_size=256, attention_window=(64, 64), item_seq_len=64)


@pytest.mark.chip
@pytest.mark.parametrize("task", ["pretrain", "fraud"])
def test_chip_replay_equals_eager_bitwise(card, task):
    """Pretraining over 24 micro-steps at accumulation 8 (three updates),
    fraud training over 5 steps: every loss, every gradient the optimizer
    gets and every parameter after each update equal the eager step's."""
    cfg = card_config()
    accum = 8
    graphed = Run(task, cfg, card, accum=accum)
    eager = Run(task, cfg, card, primitive=Eager(), accum=accum)
    table = make_table(cfg, device=card)
    batches = [histories(s, B=4, device=card) for s in range(3)]
    n = 3 * accum if task == "pretrain" else 5
    for k in range(n):
        got = graphed(k, table, *batches[k % 3], rng_cls=StepRNG)
        want = eager(k, table, *batches[k % 3], rng_cls=StepRNG)
        assert equal(got, want), k
    torch.cuda.synchronize()
    assert equal(graphed.grads, eager.grads)
    assert equal(graphed.params, eager.params)
    assert len(graphed.params) == (3 if task == "pretrain" else n)
    assert graph_counts() == {"train_graph.eager": 1 + n, "train_graph.captures": 1,
                              "train_graph.replays": n - 2}


@pytest.mark.chip
def test_chip_a_seed_in_device_memory_gives_the_seed_s_mask(card):
    """Kernels 1-2 with the seed read from device memory equal the same
    launches with the seed passed as an int, forward and backward."""
    g = torch.Generator(device=card).manual_seed(0)
    B, L, H, D, W = 2, 256, 2, 64, 64
    x = [(torch.randn(B, L, H * D, generator=g, device=card) * 0.5).to(torch.bfloat16)
         for _ in range(3)]
    mask = torch.ones(B, L, dtype=torch.int32, device=card)
    mask[:, 0] = 2
    mask[1, 200:] = 0
    q = x[0].view(B, L, H, D)
    k, v = x[1].view(B, L, H, D), x[2].view(B, L, H, D)
    _, ops = wa.prepare_band_inputs(q, k, v, mask)
    gout = torch.zeros(B, 1, H * D, dtype=torch.bfloat16, device=card)
    dout = (torch.randn(B, L, H * D, generator=g, device=card) * 0.5).to(torch.bfloat16)
    common = dict(num_heads=H, window=W, fuse_epilogue=True, dropout_rate=0.1)
    slot = torch.tensor([1234567], dtype=torch.int32, device=card)
    with torch.no_grad():
        want = wa.band_attention(**ops, gout=gout, seed=1234567, **common)
        got = wa.band_attention(**ops, gout=gout, seed=slot, **common)
        other = wa.band_attention(**ops, gout=gout, seed=7654321, **common)
    want_bwd = wa.band_attention_bwd(**ops, gout=gout, dout=dout, seed=1234567, **common)
    got_bwd = wa.band_attention_bwd(**ops, gout=gout, dout=dout, seed=slot, **common)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and not torch.equal(got, other)
    assert equal(list(got_bwd), list(want_bwd))
