"""Each cell's driver on the CPU at the tiny size, held to the reference:
in float32 the program's readings are rounding (the reference draws what
the program draws, dropout included), and with the cell's own limits a
sound run is correct; with the timed path broken underneath, or with the
control (the reference in fp8) in the program's place, it is not."""

import numpy as np
import pytest
import torch

from portbench import manifest, run
from portbench.tests.tiny import tiny_cell

BENCH = manifest.load_manifest()
CELLS = [w["name"] for w in BENCH["workloads"]]
TRAINING = [w["name"] for w in BENCH["workloads"]
            if manifest.load_traffic(w["traffic"])["driver"] in ("pretrain", "fraud")]
SERVING = [c for c in CELLS if c not in TRAINING]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run_tiny(workload, seed=4321, dtype="float32"):
    cell = tiny_cell(workload, seed)
    cell.config = cell.config.replace(dtype=dtype)
    return run.run_cell(cell, BENCH, 0.2, False)


@pytest.mark.parametrize("workload", CELLS)
def test_float32_program_reads_rounding_and_is_correct(workload):
    out = run_tiny(workload)
    for name, c in out["checks"].items():
        assert c["value"] < 1e-4, (name, c)
    assert out["correct"]
    assert out["attempted"] >= 1 and 0 < out["valid_share"] < 1


@pytest.mark.parametrize("workload", CELLS)
def test_control_reads_apart_from_the_program(workload):
    """At the tiny size the control (the reference computed in fp8 in the
    program's place) reads at least three times what the program in bf16
    reads on one of the cell's numbers, so a limit lies between them; at
    the cells' own sizes it fails their limits (``test_chip.py``)."""
    out = run_tiny(workload, dtype="bfloat16")
    program = {k: c["value"] for k, c in out["checks"].items()}
    control = out["driver"].control()
    assert any(control[k] >= 3 * program[k] for k in program), (program, control)


def _correct_with(monkeypatch, workload, patch):
    patch(monkeypatch)
    return run_tiny(workload)["correct"]


def _state_unchanged(monkeypatch):
    from recformer_tpu_torch.training.optimizer import AdamWSchedule

    def step(self):
        self._zero_grad()
        return False

    monkeypatch.setattr(AdamWSchedule, "step", step)


def _half_batch(monkeypatch):
    from recformer_tpu_torch.training import steps

    loss_p, loss_f = steps.pretrain_loss, steps.fraud_loss

    def pretrain_loss(config, out, batch_a, batch_b, *a, **k):
        h = out.z1.shape[0] // 2
        out = out._replace(z1=out.z1[:h], z2=out.z2[:h], mlm_logits_a=out.mlm_logits_a[:h],
                           mlm_logits_b=out.mlm_logits_b[:h])
        cut = [{n: v[:h] for n, v in b.items()} for b in (batch_a, batch_b)]
        return loss_p(config, out, *cut, *a, **k)

    def fraud_loss(config, logits, labels, valid):
        h = logits.shape[0] // 2
        return loss_f(config, logits[:h], labels[:h], valid[:h])

    monkeypatch.setattr(steps, "pretrain_loss", pretrain_loss)
    monkeypatch.setattr(steps, "fraud_loss", fraud_loss)


def _answer_altered(monkeypatch):
    from recformer_tpu_torch.models import heads
    from recformer_tpu_torch.training import steps

    scores = heads.similarity_scores

    def altered_scores(pooled, items, temp):
        s = scores(pooled, items, temp)
        s[:, 3] = s.max() + 1.0  # item 3 always ranked first
        return s

    encode = steps.make_encode_items_step

    def altered_encode(config, model):
        step = encode(config, model)

        def run_step(table, chunk):
            out = step(table, chunk).clone()
            out[5::8] = -out[5::8]  # some items' embeddings flipped where produced
            return out

        return run_step

    monkeypatch.setattr(heads, "similarity_scores", altered_scores)
    monkeypatch.setattr(steps, "make_encode_items_step", altered_encode)


@pytest.mark.parametrize("workload", TRAINING)
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch])
def test_training_fault_is_not_correct(monkeypatch, workload, fault):
    assert not _correct_with(monkeypatch, workload, fault)


@pytest.mark.parametrize("workload", SERVING)
def test_altered_answer_is_not_correct(monkeypatch, workload):
    assert not _correct_with(monkeypatch, workload, _answer_altered)


def test_training_readings_by_worst_leaf():
    from portbench.drivers.common import train_readings

    ref = {"loss": [2.0, 1.0], "grad": {"a": 1.0, "b": 2.0, "c": 1e-9},
           "change": {"a": 0.5, "b": 1.0, "c": 0.3}}
    got = {"loss": [2.0, 1.1], "grad": {"a": 1.0, "b": 1.0, "c": 0.5},
           "change": {"a": 0.5, "b": 0.0, "c": 9.0}}
    r = train_readings(got, ref)
    assert r["loss_gap"] == pytest.approx(0.1)
    # c's gradient is nought to rounding: measured against the median leaf's
    assert r["grad_gap"] == pytest.approx(0.5)
    # and c is left out of the change; b has not moved: it reads 1
    assert r["change_gap"] == pytest.approx(1.0)
    assert np.isfinite(r["grad_gap"])
