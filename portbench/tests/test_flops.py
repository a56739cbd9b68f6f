"""The counts of ``portbench/flops.py`` against hand-worked values for a
small shape with padding."""

import numpy as np
import pytest

from portbench import flops
from portbench.tests.tiny import tiny_cell


def brute_pairs(n, window):
    """(local query, key) pairs by enumeration: local tokens 1..n-1, keys
    the local tokens within window/2, and the global token."""
    half = window // 2
    return sum(1 + sum(1 for j in range(1, n) if abs(i - j) <= half) for i in range(1, n))


@pytest.mark.parametrize("n", [1, 2, 3, 9, 17, 40, 300])
@pytest.mark.parametrize("window", [4, 16, 64])
def test_local_pairs(n, window):
    assert int(flops.local_pairs(np.array([n]), window)[0]) == brute_pairs(n, window)


def test_hand_worked_small_shape():
    # window 4 (half 2), rows of 5 and 2 valid tokens (padded to any length):
    # row 1: local tokens 1..4, band pairs 3+4+4+3 = 14, +4 global = 18
    # row 2: one local token, 1 band pair + 1 global = 2
    assert flops.local_pairs(np.array([5, 2]), 4).tolist() == [18, 2]
    cfg = tiny_cell("recformer-base.encode").config.replace(attention_window=(4, 4))
    hs, ff, nh = cfg.hidden_size, cfg.intermediate_size, cfg.num_attention_heads
    n = np.array([5, 2])
    per_layer = 7 * (8 * hs * hs + 4 * hs * ff + 4 * hs * nh) + 2 * 6 * hs * hs + 4 * hs * 20
    assert flops.encoder_forward(cfg, n) == 2 * per_layer
    ops, nbytes = flops.attn_fwd_work(cfg, n, 4)
    assert ops == 4 * hs * 20
    # bf16: q, k, v of the 4 + 1 local rows, every valid row's output, the
    # global key, value and row; two int32 masks a valid token; the flag
    assert nbytes == 2 * hs * (3 * 5 + 7 + 2 * 3) + 8 * 7 + 2 * 4
    ops, nbytes = flops.attn_bwd_work(cfg, n, 4)
    assert ops == 10 * hs * 20
    assert nbytes == 2 * hs * (3 * 5 + 7 + 2 * 3 + 3 * 5) + 2 * 12 * hs + 8 * 7 + 2 * 4


def test_valid_tokens_newest_items_cut():
    lengths = np.array([3, 5, 7, 0])
    ids = np.array([[0, 1, 2], [2, 2, 0]])
    lens = np.array([3, 1])
    # row 0: <s> + 7 + 5 (newest two of at most 2 items) = 13, cut at 10
    assert flops.valid_tokens(lengths, ids, lens, 10, 2).tolist() == [10, 8]


def test_least_time_is_the_larger_bound():
    assert flops.least_seconds(989e12, 0) == pytest.approx(1.0)
    assert flops.least_seconds(0, 3.35e12) == pytest.approx(1.0)
