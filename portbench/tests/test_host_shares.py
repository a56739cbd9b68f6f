"""The readers of the program's spans (``host_*_pct``): shares of the
profiled stretch's wall from the span registry, None where it holds
nothing or the program has none."""

import pytest

from portbench import manifest, trace
from portbench.run import TraceContext
from recformer_tpu_torch.utils import profiling

READERS = ("host_batch_pct.train", "host_forward_pct.rank", "host_backward_pct.train",
           "host_optimizer_pct.train", "host_score_pct.rank", "host_kernel_wrapper_pct.encode",
           "host_outside_pct.train")


def ctx(window_s=2.0):
    s = trace.Stretch(units=8, window_s=window_s, busy_s=0.5, kernels=800)
    return TraceContext(stretch=s, window_flops=0.0, window_wall_s=10.0, kernel_work={})


def test_shares_from_a_registry_filled_by_hand(monkeypatch):
    own = {"batch": 0.1, "forward": 0.2, "forward.encoder": 0.4, "backward": 0.5,
           "optimizer": 0.06, "score": 0.04, "launch.kernel1": 0.08, "launch.kernel2": 0.02,
           "forwarding": 1.0}  # neither "forward" nor "forward.*"
    monkeypatch.setattr(profiling, "self_seconds", lambda: dict(own))
    monkeypatch.setattr(profiling, "root_seconds", lambda: 1.4)
    c = ctx(window_s=2.0)
    got = {name: manifest.metric_reader(name)(c) for name in READERS}
    assert got == pytest.approx({
        "host_batch_pct.train": 5.0, "host_forward_pct.rank": 30.0,
        "host_backward_pct.train": 25.0, "host_optimizer_pct.train": 3.0,
        "host_score_pct.rank": 2.0, "host_kernel_wrapper_pct.encode": 5.0,
        "host_outside_pct.train": 30.0})
    # the spans outside the stray name add up to the roots: the shares to 100
    assert sum(got.values()) == pytest.approx(100.0)


def test_an_empty_registry_or_a_program_without_one_reads_nothing(monkeypatch):
    profiling.reset()
    for name in READERS:
        assert manifest.metric_reader(name)(ctx()) is None
    monkeypatch.delattr(profiling, "self_seconds")
    for name in READERS:
        assert manifest.metric_reader(name)(ctx()) is None
