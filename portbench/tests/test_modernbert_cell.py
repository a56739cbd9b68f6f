"""The ``recformer-modernbert-large.rank8k`` cell's driver on the CPU at a
tiny ModernBERT size (3 layers, layer 0 global, hidden 64, window 16,
256-token histories): in float32 the program reads rounding against the
reference and is correct; the control (the reference in fp8) reads apart;
an altered answer is not correct. ``tiny.py``'s cells carry Longformer's
sizes and special ids, so this cell has its own."""

import pytest
import torch

from portbench import manifest, run
from portbench.tests.tiny import TINY_CORPUS, tiny_traffic

BENCH = manifest.load_manifest()
CELL = "recformer-modernbert-large.rank8k"
TINY = dict(vocab_size=1024, hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
            intermediate_size=96, max_position_embeddings=256, attention_window=(16,) * 3,
            local_attention=16, max_token_num=256, max_item_embeddings=11, max_attr_num=3,
            max_attr_length=8, item_seq_len=32, pad_token_id=1, bos_token_id=0, eos_token_id=2,
            sep_token_id=2, mask_token_id=1023)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run_tiny(dtype="float32", seed=4321):
    cell = manifest.find_cell(BENCH, CELL, seed, "cpu")
    cell.config = cell.config.replace(**TINY, dtype=dtype)
    cell.traffic = tiny_traffic(cell.traffic)
    assert cell.traffic["corpus"]["n_items"] == TINY_CORPUS["n_items"]
    return run.run_cell(cell, BENCH, 0.2, False)


def test_float32_program_reads_rounding_and_is_correct():
    out = run_tiny()
    for name, c in out["checks"].items():
        assert c["value"] < 1e-4, (name, c)
    assert out["correct"] and out["attempted"] >= 1 and 0 < out["valid_share"] <= 1


def test_control_reads_apart_and_an_altered_answer_is_not_correct(monkeypatch):
    out = run_tiny(dtype="bfloat16")
    program = {k: c["value"] for k, c in out["checks"].items()}
    control = out["driver"].control()
    assert any(control[k] >= 3 * program[k] for k in program), (program, control)
    from recformer_tpu_torch.models import heads

    scores = heads.similarity_scores

    def altered(pooled, items, temp):
        s = scores(pooled, items, temp)
        s[:, 3] = s.max() + 1.0
        return s

    monkeypatch.setattr(heads, "similarity_scores", altered)
    assert not run_tiny()["correct"]


def test_counts_and_kernel_work():
    from portbench import flops_modernbert as fm

    cfg = manifest.find_cell(BENCH, CELL, 1, "cpu").config
    n = [1, 2, 65, 200]
    brute = sum(sum(1 for i in range(k) for j in range(k) if abs(i - j) <= 64) for k in n)
    assert int(fm.band_pairs(n, 128).sum()) == brute
    hs, ff = cfg.hidden_size, cfg.intermediate_size
    want = (28 * sum(n) * 2 * (4 * hs * hs + 3 * hs * ff) + 10 * 4 * hs * sum(k * k for k in n)
            + 18 * 4 * hs * brute)
    assert fm.encoder_forward(cfg, n) == want
    assert fm.global_attn_work(cfg, [3]) == (4.0 * hs * 9, 2.0 * hs * 4 * 3 + 3)
    assert fm.local_attn_work(cfg, [3]) == (4.0 * hs * 9, 2.0 * hs * 4 * 3 + 24)
