"""The per-layer readers on a stretch made by hand, and the trace's
interval arithmetic."""

import pytest

from portbench import flops, manifest, trace
from portbench.run import TraceContext


def ctx(**kw):
    s = trace.Stretch(units=4, window_s=2.0, busy_s=0.5, kernels=400,
                      kernel_s={"band_attention_fwd_tc_kernel": 0.010,
                                "band_bwd_query_tc_kernel": 0.020,
                                "band_bwd_key_tc_kernel": 0.015,
                                "band_bwd_reduce_kernel": 0.005, "gemm": 0.4})
    base = dict(stretch=s, window_flops=989e12 * 0.1, window_wall_s=10.0,
                kernel_work={"attn_fwd": [(0.0, 3.35e12 * 0.004)],
                             "attn_bwd": [(989e12 * 0.01, 0.0)]})
    base.update(kw)
    return TraceContext(**base)


def test_readers():
    c = ctx()
    assert manifest.metric_reader("mfu.train")(c) == pytest.approx(1.0)
    assert manifest.metric_reader("attn_fwd_roofline_pct.rank")(c) == pytest.approx(40.0)
    assert manifest.metric_reader("attn_bwd_roofline_pct.train")(c) == pytest.approx(25.0)
    assert manifest.metric_reader("device_idle_pct.encode")(c) == pytest.approx(75.0)
    assert manifest.metric_reader("device_kernels.rank")(c) == pytest.approx(100.0)


def test_readers_find_nothing():
    c = ctx(kernel_work={}, window_flops=0.0)
    assert manifest.metric_reader("mfu.train")(c) is None
    assert manifest.metric_reader("attn_fwd_roofline_pct.train")(c) is None
    assert manifest.metric_reader("attn_bwd_roofline_pct.train")(c) is None


def test_union_and_gaps():
    assert trace._union([(0, 2), (1, 3), (5, 6)]) == [[0, 3], [5, 6]]

    class E:
        def __init__(self, s, e, name):
            self.time_range = type("R", (), {"start": s, "end": e})()
            self.name = name

    host = [E(0, 100, "outer"), E(3, 5, "inner"), E(7, 9, "late")]
    gaps = trace._label_gaps([[0, 3], [5, 6], [10, 12]], host)
    # gap (6, 10): middle 8 under "late"; gap (3, 5): middle 4 under "inner"
    assert gaps == pytest.approx({"late": 4e-6, "inner": 2e-6})
    assert flops.PEAK_BF16_FLOPS == 989e12
