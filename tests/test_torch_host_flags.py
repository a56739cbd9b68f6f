"""The training CLIs' host-side flags: ``cli.pretrain``'s metric rows
(``--log_dir``, ``--mirror_file``) at the JAX CLI's step numbers with its
keys, under ``--steps_per_call`` and ``--remat``; its ``--profile_dir``
trace; and ``--remat``/``--remat_policy`` reaching the model in
``cli.finetune`` and ``cli.finetune_classification``. Tiny model, CPU."""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from recformer_tpu.cli import pretrain as jax_pretrain
from recformer_tpu_torch.cli import finetune, finetune_classification
from recformer_tpu_torch.cli import pretrain as torch_pretrain
from recformer_tpu_torch.examples.synthetic_end_to_end import generate_data
from recformer_tpu_torch.models import encoder

# 110 histories at batch 2 and 2 steps a call: 27 calls (54 steps) an epoch,
# so a dev row at step 40 and the loss row at step 50 are written
FLAGS = ["--model_size", "tiny", "--num_train_epochs", "1", "--batch_size", "2",
         "--gradient_accumulation_steps", "2", "--warmup_steps", "2",
         "--valid_step_interval", "40", "--valid_batches", "1", "--save_top_k", "1",
         "--remat", "--remat_policy", "dots_attn", "--steps_per_call", "2"]


def write_pretrain_corpus(root, n_items=20, n_users=110, seed=0):
    rng = np.random.default_rng(seed)
    meta = {f"I{i}": {"title": f"item {i % 7}", "brand": str(i % 3)} for i in range(n_items)}
    smap = {f"I{i}": i for i in range(n_items)}
    seqs = [[f"I{j}" for j in rng.integers(0, n_items, rng.integers(2, 5))]
            for _ in range(n_users)]
    os.makedirs(root, exist_ok=True)
    for name, obj in (("meta_data", meta), ("smap", smap), ("train", seqs), ("dev", seqs[:4])):
        with open(os.path.join(root, f"{name}.json"), "w") as f:
            json.dump(obj, f)
    return str(root)


def read_rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def pretrain_runs(tmp_path_factory):
    """Both CLIs on one corpus with the same flags, the port also with
    ``--profile_dir``; the port's step metrics recorded per step. The JAX
    CLI sees one device (its single-device path: the global batch is
    ``--batch_size``, as the port's). Without the TensorBoard writer (its
    import costs seconds; the rows are the subject)."""
    root = tmp_path_factory.mktemp("pretrain_cli")
    data = write_pretrain_corpus(root / "data")
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "torch.utils.tensorboard", None)
    per_step = []
    make_step = torch_pretrain.make_pretrain_step

    def recording(*a, **kw):
        step = make_step(*a, **kw)

        def run(*args):
            m = step(*args)
            per_step.append(float(m["loss"]))
            return m

        return run

    mp.setattr(torch_pretrain, "make_pretrain_step", recording)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = root / "torch"
        res = torch_pretrain.main(
            ["--data_path", data, "--output_dir", str(out), "--log_dir", str(out / "logs"),
             "--mirror_file", str(out / "mirror.jsonl"), "--profile_dir", str(out / "prof"),
             "--device", "cpu"] + FLAGS)
        mp.setattr(jax, "device_count", lambda *a, **kw: 1)
        jax_pretrain.main(["--data_path", data, "--output_dir", str(root / "jax"),
                           "--mirror_file", str(root / "jax" / "mirror.jsonl")] + FLAGS)
    finally:
        torch.set_num_threads(threads)
        mp.undo()
    return res, out, root / "jax", per_step


def test_pretrain_cli_rows_match_the_jax_cli(pretrain_runs):
    res, out, jax_out, per_step = pretrain_runs
    assert res["steps"] == 54 and len(per_step) == 54
    rows = read_rows(out / "logs" / "metrics.jsonl")
    jax_rows = read_rows(jax_out / "logs" / "metrics.jsonl")
    shape = [(r["step"], sorted(r)) for r in rows]
    assert shape == [(r["step"], sorted(r)) for r in jax_rows]
    assert [s for s, _ in shape] == [40, 50]
    assert {"loss", "accuracy", "examples_per_sec", "step", "time"} <= set(rows[1])
    assert set(rows[0]) == {"dev_accuracy", "step", "time"}
    # --mirror_file repeats every row; a row holds the mean of its call's steps
    assert read_rows(out / "mirror.jsonl") == rows
    assert rows[1]["loss"] == pytest.approx(np.mean(per_step[48:50]), rel=1e-6)


def test_pretrain_cli_profile_dir_writes_a_trace(pretrain_runs):
    _, out, _, _ = pretrain_runs
    traces = os.listdir(out / "prof")
    assert len(traces) == 1 and traces[0].endswith(".json")
    with open(out / "prof" / traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("backward" in str(e.get("name", "")).lower() for e in events)


@pytest.mark.parametrize("task", ["finetune", "fraud"])
def test_finetune_clis_take_remat(task, tmp_path, monkeypatch):
    """``--remat --remat_policy save_attention`` reaches the model: each
    training forward checkpoints every layer, the config records it."""
    ft, _, fraud = generate_data(str(tmp_path / "data"))
    checkpointed = []
    layer = encoder.remat_layer

    def counting(*a, **kw):
        checkpointed.append(a[-1])
        return layer(*a, **kw)

    monkeypatch.setattr(encoder, "remat_layer", counting)
    out = tmp_path / "out"
    common = ["--model_size", "tiny", "--batch_size", "8", "--eval_batch_size", "8",
              "--num_train_epochs", "1", "--device", "cpu", "--output_dir", str(out),
              "--remat", "--remat_policy", "save_attention"]
    if task == "finetune":
        metrics = finetune.main(["--data_path", ft, "--encode_batch_size", "8",
                                 "--finetune_negative_sample_size", "5",
                                 "--gradient_accumulation_steps", "1"] + common)
        cfg_path = out / "finetune" / "config.json"
    else:
        metrics = finetune_classification.main(["--data_path", fraud] + common)
        cfg_path = out / "fraud" / "config.json"
    assert all(np.isfinite(v) for k, v in metrics.items() if isinstance(v, float))
    assert checkpointed and set(checkpointed) == {"save_attention"}
    with open(cfg_path) as f:
        cfg = json.load(f)
    assert cfg["remat"] is True and cfg["remat_policy"] == "save_attention"
