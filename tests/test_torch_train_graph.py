"""The training steps' CUDA graphs (``training/steps.py``'s
``StepGraphs`` over ``utils/graphs.py``): which calls run eagerly, what a
replay computes and draws, and the kernels' seeds in device memory. The
lifecycle both owners share is ``test_torch_graphs.py``'s.

On the CPU the capture and replay primitive is ``graph_harness.FakeGraphs``.
The cases marked ``chip`` hold the real graphs to the eager step on a CUDA
card, bit for bit, and skip without one; this file imports no JAX, so they
run there without the suite's conftest:

    python -m pytest --noconftest -m chip tests/test_torch_train_graph.py
"""

import copy

import pytest
import torch
from graph_harness import (Eager, FakeGraphs, Run, SplitRNG, histories, make_table,
                           tiny_config)
from graph_harness import clean_counters  # noqa: F401  (autouse)
from graph_harness import graph_counts as _graph_counts

from recformer_tpu_torch.ops import window_attention as wa
from recformer_tpu_torch.training import steps
from recformer_tpu_torch.training.steps import SeedRecord, SeedSlots
from recformer_tpu_torch.utils.rng import StepRNG, fold_in


def graph_counts() -> dict:
    return _graph_counts("train_graph")


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
    assert graph.kept.seeds.values.tolist() == record.drawn
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
