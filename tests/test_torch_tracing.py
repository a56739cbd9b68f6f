"""The port's spans and counters (``recformer_tpu_torch/utils/profiling.py``):
off without a profiler, user-annotation ranges and self times under one,
parents across threads, the training steps' spans every micro-step."""

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from recformer_tpu_torch.config import RecformerConfig
from recformer_tpu_torch.models.heads import RecformerForFraudDetection, RecformerForPretraining
from recformer_tpu_torch.models.recformer import init_weights
from recformer_tpu_torch.training.optimizer import create_optimizer
from recformer_tpu_torch.training.steps import make_fraud_train_step, make_pretrain_step
from recformer_tpu_torch.utils import profiling
from recformer_tpu_torch.utils.rng import StepRNG

STEP_SPANS = ("batch", "forward", "forward.encoder", "backward", "optimizer")


@pytest.fixture(autouse=True)
def _clean():
    profiling.reset()
    profiling.reset_counters()
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    profiling.reset()
    profiling.reset_counters()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_off_returns_the_shared_no_op_and_records_nothing():
    @profiling.spanned("wrapped")
    def f(x):
        return x + 1

    a, b = profiling.span("a"), profiling.span("b")
    assert a is b
    with a:
        with profiling.span("c"):
            assert f(1) == 2
    assert f.__name__ == "f"
    assert profiling.seconds() == {} and profiling.self_seconds() == {}
    assert profiling.span_counts() == {} and profiling.root_seconds() == 0.0


def test_nested_spans_are_annotations_with_self_times():
    @profiling.spanned("child")
    def child():
        time.sleep(0.030)

    with cpu_profile() as prof:
        with profiling.span("parent"):
            time.sleep(0.010)
            child()
            time.sleep(0.010)
    names = [e.name for e in prof.events() if getattr(e, "is_user_annotation", False)]
    assert "parent" in names and "child" in names
    own, whole = profiling.self_seconds(), profiling.seconds()
    # counted with its child, the parent's own time would be 0.050 or more
    assert 0.020 <= own["parent"] < 0.045
    assert 0.030 <= own["child"] < 0.060
    assert whole["child"] == own["child"]
    assert whole["parent"] - own["parent"] == pytest.approx(whole["child"], rel=1e-9)
    assert profiling.root_seconds() == whole["parent"]
    assert profiling.span_counts() == {"parent": 1, "child": 1}


def test_a_worker_threads_span_is_a_child_of_the_main_threads_open_span():
    def worker():
        with profiling.span("worker"):
            time.sleep(0.010)

    with cpu_profile():
        with profiling.span("main"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
        # with no span open on the main thread, the worker's span is a root
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    whole, own = profiling.seconds(), profiling.self_seconds()
    assert profiling.span_counts() == {"main": 1, "worker": 2}
    assert whole["main"] - own["main"] > 0.010
    # the first worker span counts inside "main", the second as a root
    assert profiling.root_seconds() == pytest.approx(
        whole["main"] + whole["worker"] - (whole["main"] - own["main"]), rel=1e-9)
    assert profiling.root_seconds() == pytest.approx(sum(own.values()), rel=1e-9)


def test_trace_empties_the_registry_first(tmp_path):
    with cpu_profile():
        with profiling.span("before"):
            pass
    assert "before" in profiling.seconds()
    with profiling.trace(str(tmp_path)):
        with profiling.span("inside"):
            pass
    assert set(profiling.seconds()) == {"inside"}
    assert len(list(tmp_path.glob("trace_*.json"))) == 1


def _table(cfg, n_items, seed=0):
    rng = np.random.default_rng(seed)
    M = cfg.max_item_token_len
    ids = rng.integers(4, cfg.vocab_size - 1, size=(n_items + 1, M)).astype(np.int32)
    types = np.tile(np.where(np.arange(M) % 8 < 2, 1, 2).astype(np.int32), (n_items + 1, 1))
    begin = rng.integers(0, 2, size=(n_items + 1, M)).astype(np.int32)
    lengths = rng.integers(3, M + 1, size=n_items + 1).astype(np.int32)
    ids[-1] = cfg.pad_token_id
    lengths[-1] = 0
    return {k: torch.from_numpy(v) for k, v in (("token_ids", ids), ("token_types", types),
                                                 ("word_begin", begin), ("lengths", lengths))}


def _histories(cfg, n_items, B, seed=1):
    rng = np.random.default_rng(seed)
    S = cfg.max_item_embeddings - 1
    ids = torch.from_numpy(rng.integers(0, n_items, size=(B, S)).astype(np.int32))
    lens = torch.from_numpy(rng.integers(2, S + 1, size=B).astype(np.int32))
    return ids, lens


def _pretrain_micro_step(cfg, n_items=30):
    model = RecformerForPretraining(cfg)
    init_weights(model, cfg, torch.Generator().manual_seed(0))
    opt = create_optimizer(model, learning_rate=1e-3, grad_accum_steps=2)
    step = make_pretrain_step(cfg, model, opt)
    table = _table(cfg, n_items)
    ids, lens = _histories(cfg, n_items, B=4)
    return lambda i: step(StepRNG(100 + i), table, ids, lens)


def _fraud_step(cfg, n_items=30):
    model = RecformerForFraudDetection(cfg)
    init_weights(model, cfg, torch.Generator().manual_seed(0))
    step = make_fraud_train_step(cfg, model, create_optimizer(model, learning_rate=1e-3))
    table = _table(cfg, n_items)
    ids, lens = _histories(cfg, n_items, B=4)
    labels = torch.tensor([0.0, 1.0, 0.0, 1.0])
    valid = torch.ones(4, dtype=torch.bool)
    return lambda i: step(7, table, ids, lens, labels, valid)


@pytest.mark.parametrize("task", ["pretrain", "fraud"])
def test_training_steps_record_every_layer_every_micro_step(task):
    cfg = RecformerConfig.tiny(max_token_num=64, item_seq_len=16, max_item_embeddings=6,
                               dtype="float32", pos_weight=2.0)
    run = (_pretrain_micro_step if task == "pretrain" else _fraud_step)(cfg)
    run(0)  # outside the profiler: records nothing
    assert profiling.seconds() == {}
    n = 3
    with cpu_profile() as prof:
        for i in range(n):
            run(i + 1)
    counts = profiling.span_counts()
    # pretraining: both towers, and three assemblies (the pair's batch and
    # its two views) a micro-step; fraud: one of each
    per_step = ({"batch": 3, "forward": 1, "forward.encoder": 2, "backward": 1, "optimizer": 1}
                if task == "pretrain" else {name: 1 for name in STEP_SPANS})
    assert counts == {k: v * n for k, v in per_step.items()}
    own = profiling.self_seconds()
    assert all(own[k] > 0 for k in STEP_SPANS)
    assert profiling.root_seconds() == pytest.approx(sum(own.values()), rel=1e-6)
    annotated = {e.name for e in prof.events() if getattr(e, "is_user_annotation", False)}
    assert set(STEP_SPANS) <= annotated


def test_counters_count_and_reset():
    profiling.count("kernel1.launches")
    profiling.count("kernel1.launches", 3)
    profiling.count("kernel1.tensor_core", 0)
    assert profiling.counters() == {"kernel1.launches": 4, "kernel1.tensor_core": 0}
    got = profiling.counters()
    got["kernel1.launches"] = 99  # a copy
    assert profiling.counters()["kernel1.launches"] == 4
    profiling.reset_counters()
    assert profiling.counters() == {}


def test_no_launch_counter_globals_are_left():
    from recformer_tpu_torch.ops import band_probes, embed_layernorm, layernorm, window_attention

    for mod in (band_probes, embed_layernorm, layernorm, window_attention):
        assert not [n for n in vars(mod) if n.endswith("LAUNCHES")], mod.__name__
