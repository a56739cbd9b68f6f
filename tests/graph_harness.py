"""What the CUDA-graph tests share (``utils/graphs.py``): the capture and
replay primitive's stand-in on the CPU, and the two owners of graphs, the
backbone's forward for serving and the training steps, at a tiny size.

``FakeGraphs``' capture runs the function on the static inputs, its replay
runs it again into the static outputs (and, as a graph runs no Python,
takes back what the function's wrappers counted). On the CPU a
``StepRNG``'s two generators are one, so the training tests give the device
draws a generator of their own (``SplitRNG``), as on a card. This module
imports no JAX: the tests' ``chip`` cases run on the card without the
suite's conftest.
"""

import contextlib

import numpy as np
import pytest
import torch

from recformer_tpu_torch.config import RecformerConfig
from recformer_tpu_torch.data.device_pipeline import assemble_for_config
from recformer_tpu_torch.models.heads import (RecformerForFraudDetection,
                                              RecformerForPretraining, RecformerForSeqRec)
from recformer_tpu_torch.models.recformer import init_weights
from recformer_tpu_torch.training import steps
from recformer_tpu_torch.training.optimizer import create_optimizer
from recformer_tpu_torch.utils import profiling
from recformer_tpu_torch.utils.graphs import CudaGraphs, Graphs
from recformer_tpu_torch.utils.rng import StepRNG, fold_in

BATCH_KEYS = ("input_ids", "attention_mask", "global_attention_mask", "token_type_ids",
              "item_position_ids")


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

    def capture(self, fn, args, pool, device, generator=None):
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
    """The real primitive, refusing every call: the owner runs eagerly."""

    def usable(self, device):
        return False


@pytest.fixture(autouse=True)
def clean_counters():
    profiling.reset_counters()
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    profiling.reset_counters()


def graph_counts(prefix) -> dict:
    return {k: v for k, v in profiling.counters().items() if k.startswith(prefix + ".")}


def tiny_config(**kw):
    return RecformerConfig.tiny(**{"attention_impl": "pallas", "hidden_act": "gelu_tanh",
                                   "dtype": "float32", **kw})


# ---------------------------------------------------------------------------
# serving: the backbone's forward
# ---------------------------------------------------------------------------

def tiny_model(device="cpu", primitive=None, **kw):
    cfg = tiny_config(**kw)
    model = RecformerForSeqRec(cfg)
    init_weights(model, cfg, torch.Generator().manual_seed(0))
    model = model.to(device).eval()
    if primitive is not None:
        model.longformer.serve_graphs = Graphs("serve_graph", primitive)
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


class Serving:
    """The backbone's forward under ``no_grad`` on two batches of one
    signature, each call held to the eager forward bit for bit."""

    prefix = "serve_graph"

    def __init__(self, primitive):
        self.model = tiny_model(primitive=primitive)
        self.batches = [make_batch(self.model.config, s) for s in (1, 2)]
        self.graphs = self.model.longformer.serve_graphs

    def __call__(self, k, which=0) -> list:
        """Call ``k`` on batch ``which``: the tensors it returns."""
        batch = self.batches[which]
        with torch.no_grad():
            got = backbone(self.model, batch)
        assert_bitwise(got, eager(self.model, batch))
        return list(got)


# ---------------------------------------------------------------------------
# training: the pretraining and fraud steps
# ---------------------------------------------------------------------------

class SplitRNG(StepRNG):
    """A ``StepRNG`` whose device draws come from a generator of their own,
    as on a card (on the CPU its two generators are one)."""

    def __init__(self, seed, device="cpu"):
        super().__init__(seed, device)
        if self.device is self.host:
            self.device = torch.Generator().manual_seed(fold_in(seed, 1))


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


class Training:
    """The pretraining step on two batches of one signature."""

    prefix = "train_graph"

    def __init__(self, primitive):
        cfg = tiny_config()
        self.run = Run("pretrain", cfg, primitive=primitive)
        self.model = self.run.model
        self.table = make_table(cfg)
        self.batches = [histories(s) for s in (1, 2)]
        self.graphs = self.run.step.graphs

    def __call__(self, k, which=0) -> list:
        """Call ``k`` on batch ``which``: the metrics it returns."""
        return list(self.run(k, self.table, *self.batches[which]).values())
