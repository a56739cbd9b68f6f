"""The port's parallel entry points on the CPU, under torchrun with ``gloo``
ranks (``--device cpu``, tiny model; every parallel CLI command runs in one
world of 2, one after another):

- ``cli.pretrain`` refuses the flag combinations the JAX CLI refuses
  (``tests/test_cli_parallel.py``'s), with the same ``SystemExit``s;
- ``cli.pretrain --tensor_parallel 2`` writes whole tensors: a one-rank
  model loads its parameters, a one-rank optimizer its train state;
- ``cli.pretrain --sequence_parallel 2 --attention_impl sequence_parallel``
  and ``--pipeline 2 --scan_layers --microbatches 2`` write whole
  checkpoints; the pipelined run, stopped by a SIGTERM on rank 1 alone,
  resumes with ``--resume``;
- data-parallel ``cli.pretrain``, stopped by a SIGTERM that reaches one rank
  only (both stop at the same step), resumed under ``--zero``;
- ``cli.evaluate_seq --sharded_eval 2`` against the JAX CLI's sharded
  evaluation (float32, within 1e-5);
- ``cli.serve`` on 2 ranks against one rank: the same ids;
- the dry run (``parallel/dryrun.py``) at world 4.
"""

import dataclasses
import json
import os
import signal

import numpy as np
import pytest
import torch

from recformer_tpu.cli import evaluate_seq as jax_eval_cli
from recformer_tpu_torch.cli import pretrain
from recformer_tpu_torch.cli import serve
from recformer_tpu_torch.config import RecformerConfig
from recformer_tpu_torch.models.heads import RecformerForPretraining, RecformerForSeqRec
from recformer_tpu_torch.models.recformer import init_weights
from recformer_tpu_torch.training.checkpoint import restore_train_state
from recformer_tpu_torch.training.optimizer import create_optimizer
from test_torch_cli_offline import write_corpus
from torch_parallel_worker import run_cli_world, run_torchrun


def write_pretrain_corpus(root):
    """tests/test_cli_parallel.py's corpus: 25 items, 24 sequences."""
    rng = np.random.default_rng(3)
    words = ["red", "blue", "bolt", "nut", "gear", "led", "cap", "fan"]
    meta = {f"I{i:03d}": {"make": words[i % len(words)], "hue": words[(i * 3 + 1) % len(words)]}
            for i in range(25)}
    smap = {f"I{i:03d}": i for i in range(25)}
    seqs = [[int(x) for x in rng.integers(0, 25, size=rng.integers(3, 8))] for _ in range(24)]
    os.makedirs(root, exist_ok=True)
    for name, obj in (("train", seqs), ("dev", seqs[:8]), ("meta_data", meta), ("smap", smap)):
        with open(os.path.join(root, f"{name}.json"), "w") as f:
            json.dump(obj, f)
    return str(root)


def pretrain_args(data, out, *extra):
    return ["--data_path", data, "--output_dir", str(out), "--model_size", "tiny",
            "--num_train_epochs", "1", "--batch_size", "2", "--gradient_accumulation_steps",
            "1", "--warmup_steps", "2", "--valid_step_interval", "2", "--device", "cpu", *extra]


def test_pretrain_cli_mode_validation(tmp_path):
    base = ["--data_path", write_pretrain_corpus(tmp_path / "d"), "--output_dir",
            str(tmp_path / "x"), "--model_size", "tiny", "--device", "cpu"]
    with pytest.raises(SystemExit):
        pretrain.main(base + ["--tensor_parallel", "2", "--pipeline", "2"])
    with pytest.raises(SystemExit):  # PP needs stacked layers
        pretrain.main(base + ["--pipeline", "2"])
    with pytest.raises(SystemExit):  # SP impl and axis size go together
        pretrain.main(base + ["--attention_impl", "sequence_parallel"])
    with pytest.raises(SystemExit):  # zero composes with plain DP only
        pretrain.main(base + ["--tensor_parallel", "2", "--zero"])
    assert not os.path.exists(tmp_path / "x")


def test_resolve_parallelism_refuses_pp_and_sp_after_validating():
    """Every refusal of the JAX CLI's ``_resolve_parallelism`` (pipeline
    without stacked layers, a world or a global batch that the axis or the
    microbatches do not divide), after which pp and sp resolve to (config,
    axis size, mode), sp with the full-length global projections."""
    cfg = RecformerConfig.tiny()
    args = pretrain.parse_args(["--data_path", "d", "--pipeline", "2", "--scan_layers"])
    with pytest.raises(SystemExit, match="--pipeline requires --scan_layers"):
        pretrain._resolve_parallelism(args, cfg, 4)
    with pytest.raises(SystemExit, match="world size 3 not divisible by 2"):
        pretrain._resolve_parallelism(args, cfg.replace(scan_layers=True), 3)
    args3 = pretrain.parse_args(["--data_path", "d", "--pipeline", "2", "--scan_layers",
                                 "--batch_size", "3", "--microbatches", "2"])
    with pytest.raises(SystemExit, match="global batch 3 must be divisible by --microbatches 2"):
        pretrain._resolve_parallelism(args3, cfg.replace(scan_layers=True), 2)
    pp_cfg, n_model, mode = pretrain._resolve_parallelism(args, cfg.replace(scan_layers=True), 4)
    assert (n_model, mode, pp_cfg.scan_layers) == (2, "pp", True)
    args = pretrain.parse_args(["--data_path", "d", "--sequence_parallel", "2",
                                "--attention_impl", "sequence_parallel"])
    sp_cfg, n_model, mode = pretrain._resolve_parallelism(
        args, cfg.replace(attention_impl="sequence_parallel"), 4)
    assert (n_model, mode, sp_cfg.global_kv_mode) == (2, "sp", "full")
    assert sp_cfg.attention_impl == "sequence_parallel"
    for flags in (["--pipeline", "2", "--scan_layers"], ["--sequence_parallel", "2",
                                                         "--attention_impl",
                                                         "sequence_parallel"]):
        args = pretrain.parse_args(["--data_path", "d", "--zero", *flags])
        with pytest.raises(SystemExit, match="--zero composes with plain data parallelism"):
            pretrain._resolve_parallelism(args, cfg, 4)
    args = pretrain.parse_args(["--data_path", "d", "--tensor_parallel", "2"])
    with pytest.raises(SystemExit, match="not divisible"):
        pretrain._resolve_parallelism(args, cfg, 3)
    tp_cfg, n_model, mode = pretrain._resolve_parallelism(args, cfg, 4)
    assert (n_model, mode, tp_cfg.attention_head_shard_axis) == (2, "tp", "model")


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    cfg = RecformerConfig.tiny(initializer_range=0.5)
    model = RecformerForSeqRec(cfg)
    init_weights(model, cfg, torch.Generator().manual_seed(7))
    path = str(tmp_path_factory.mktemp("ckpt") / "model.bin")
    torch.save(model.state_dict(), path)
    return path


COMMON = ["--model_size", "tiny", "--attention_impl", "pallas"]


@pytest.fixture(scope="module")
def world(tmp_path_factory, checkpoint):
    """One world of 2 ranks runs every parallel CLI command of this file, one
    after another (each CLI joins the world and leaves it up): data-parallel
    pretraining stopped by a SIGTERM on rank 1 alone at its 2nd step
    boundary, its ``--zero --resume``, ``evaluate_seq --sharded_eval 2`` in
    float32, ``serve``, ``pretrain --tensor_parallel 2``, ``--sequence_parallel
    2``, and ``--pipeline 2`` stopped like the first and resumed."""
    root = tmp_path_factory.mktemp("parallel_clis")
    pre = write_pretrain_corpus(root / "pretrain")
    eval_data = write_corpus(root / "eval")
    serve_data = write_corpus(root / "serve")
    words = ["red", "blue", "bolt", "nut", "gear", "led", "cap", "fan"]
    # no two items share their attributes (write_corpus's repeat every 8, and
    # their equal scores would tie in any order)
    with open(os.path.join(serve_data, "meta_data.json"), "w") as f:
        json.dump({f"I{i:03d}": {"make": words[i % 8], "hue": words[i // 8]} for i in range(25)},
                  f)
    seqs = {f"u{i}": [int(x) for x in np.random.default_rng(i).integers(0, 25, size=5)]
            for i in range(11)}
    with open(root / "seqs.json", "w") as f:
        json.dump(seqs, f)
    serve_args = ["--data_path", serve_data, "--sequences", str(root / "seqs.json"), "--ckpt",
                  checkpoint, "--top_k", "7", "--batch_size", "4", "--device", "cpu"] + COMMON
    eval_args = COMMON + ["--ckpt", checkpoint, "--batch_size", "8", "--encode_batch_size", "8",
                          "--sharded_eval", "2"]
    dp_out, tp_out, sp_out, pp_out = root / "dp", root / "tp", root / "sp", root / "pp"
    pp_args = pretrain_args(pre, pp_out, "--batch_size", "4", "--pipeline", "2", "--scan_layers",
                            "--microbatches", "2")
    plan = [
        dict(name="dp", module="pretrain", args=pretrain_args(pre, dp_out), preempt="1:2"),
        dict(name="zero", module="pretrain",
             args=pretrain_args(pre, dp_out, "--zero", "--resume")),
        dict(name="evaluate_seq", module="evaluate_seq", float32=True,
             args=["--data_path", eval_data, "--device", "cpu", *eval_args]),
        dict(name="serve", module="serve", args=serve_args + ["--output", str(root / "two.jsonl")]),
        dict(name="tp", module="pretrain",
             args=pretrain_args(pre, tp_out, "--batch_size", "4", "--tensor_parallel", "2")),
        dict(name="sp", module="pretrain",
             args=pretrain_args(pre, sp_out, "--batch_size", "4", "--sequence_parallel", "2",
                                "--attention_impl", "sequence_parallel")),
        dict(name="pp", module="pretrain", args=pp_args, preempt="1:2"),
        dict(name="pp_resume", module="pretrain", args=pp_args + ["--resume"]),
    ]
    ranks = run_cli_world(2, plan, root)
    return dict(ranks=ranks, root=root, dp_out=dp_out, tp_out=tp_out, sp_out=sp_out,
                pp_out=pp_out, serve_args=serve_args, eval_args=eval_args)


def test_pretrain_cli_tensor_parallel_writes_whole_tensors(world):
    out = world["tp_out"]
    assert [r["tp"]["steps"] for r in world["ranks"]] == [6, 6]
    with open(out / "logs" / "metrics.jsonl") as f:
        rows = [json.loads(l) for l in f]
    accs = [r["dev_accuracy"] for r in rows if "dev_accuracy" in r]
    assert accs and all(np.isfinite(a) for a in accs)
    cfg = RecformerConfig.load(str(out / "config.json"))
    assert cfg.attention_head_shard_axis == "model"
    whole = RecformerForPretraining(RecformerConfig.tiny())
    for name in ("best.pt", "last.pt"):
        whole.load_state_dict(torch.load(out / name, weights_only=True), strict=True)
    # the train state is whole too: a one-rank model and optimizer take it
    model = RecformerForPretraining(RecformerConfig.tiny())
    opt = create_optimizer(model)
    pos = restore_train_state(str(out / "state.pt"), model, opt)
    assert pos["global_step"] == 6 and opt.micro_steps == 6
    moments = opt.optimizer.state_dict()["state"]
    assert [tuple(m["exp_avg"].shape) for m in moments.values()] == [
        tuple(p.shape) for g in opt.optimizer.param_groups for p in g["params"]]


def test_pretrain_cli_data_parallel_preemption_and_zero_resume(world):
    """Two data ranks (global batch 4, 6 steps an epoch); rank 1 alone gets
    a SIGTERM at its 2nd step boundary: both stop at step 2. Then ``--zero
    --resume`` re-shards the whole optimizer state and runs to the end."""
    first = [r["dp"] for r in world["ranks"]]
    second = [r["zero"] for r in world["ranks"]]
    assert [r["steps"] for r in first] == [2, 2]
    assert all(r["preempted"] == signal.SIGTERM for r in first)
    # the interrupted epoch restarts at step 2
    assert [r["steps"] for r in second] == [8, 8]
    assert all("preempted" not in r for r in second)
    state = torch.load(world["dp_out"] / "state.pt", weights_only=True)
    model = RecformerForPretraining(RecformerConfig.tiny())
    model.load_state_dict(state["params"], strict=True)
    moments = state["optimizer"]["optimizer"]["state"]
    shapes = [p.shape for p in model.parameters()]
    assert sorted(tuple(m["exp_avg"].shape) for m in moments.values()) == sorted(
        tuple(s) for s in shapes)


def whole_checkpoints(out, global_step, **config):
    """``best.pt`` and ``last.pt`` load into a one-rank model, strictly, and
    ``state.pt`` into a one-rank model and optimizer, every AdamW moment of
    its parameter's shape; the saved config has ``config``'s values; the dev
    accuracies are finite."""
    cfg = RecformerConfig.load(str(out / "config.json"))
    assert all(getattr(cfg, k) == v for k, v in config.items()), cfg
    whole = RecformerForPretraining(RecformerConfig.tiny())
    for name in ("best.pt", "last.pt"):
        whole.load_state_dict(torch.load(out / name, weights_only=True), strict=True)
    model = RecformerForPretraining(RecformerConfig.tiny())
    opt = create_optimizer(model)
    pos = restore_train_state(str(out / "state.pt"), model, opt)
    assert pos["global_step"] == global_step and opt.micro_steps == global_step
    moments = opt.optimizer.state_dict()["state"]
    assert [tuple(m["exp_avg"].shape) for m in moments.values()] == [
        tuple(p.shape) for g in opt.optimizer.param_groups for p in g["params"]]
    with open(out / "logs" / "metrics.jsonl") as f:
        accs = [r["dev_accuracy"] for r in map(json.loads, f) if "dev_accuracy" in r]
    assert accs and all(np.isfinite(a) for a in accs)


def test_pretrain_cli_sequence_parallel_writes_whole_checkpoints(world):
    assert [r["sp"]["steps"] for r in world["ranks"]] == [6, 6]
    whole_checkpoints(world["sp_out"], 6, attention_impl="sequence_parallel",
                      global_kv_mode="full")


def test_pretrain_cli_pipeline_preemption_and_resume(world):
    """Pipe 2, 2 microbatches, 6 steps an epoch; rank 1 alone gets a SIGTERM
    at its 2nd step boundary: both stages stop at step 2, and ``--resume``
    restarts the interrupted epoch and runs to its end."""
    first = [r["pp"] for r in world["ranks"]]
    assert [r["steps"] for r in first] == [2, 2]
    assert all(r["preempted"] == signal.SIGTERM for r in first)
    second = [r["pp_resume"] for r in world["ranks"]]
    assert [r["steps"] for r in second] == [8, 8]
    assert all("preempted" not in r for r in second)
    whole_checkpoints(world["pp_out"], 8, scan_layers=True)


def test_evaluate_seq_sharded_matches_jax(world, tmp_path, monkeypatch):
    """Test-split metrics against a catalog row-sharded over 2 ranks (25
    items: one padding row), float32, within 1e-5 of the JAX CLI's
    ``--sharded_eval 2`` (its 8 CPU devices: data 4 x model 2)."""
    build = jax_eval_cli.build_config
    monkeypatch.setattr(jax_eval_cli, "build_config", lambda a, item_num=0: dataclasses.replace(
        build(a, item_num=item_num), dtype="float32"))
    ref = jax_eval_cli.main(["--data_path", write_corpus(tmp_path / "j")] + world["eval_args"])
    for r in world["ranks"]:
        out = r["evaluate_seq"]
        assert set(out) == set(ref) and "NDCG@10" in out
        for k in ref:
            assert out[k] == pytest.approx(ref[k], abs=1e-5), k


def test_serve_on_two_ranks_matches_one(world):
    root = world["root"]
    serve.main(world["serve_args"] + ["--output", str(root / "one.jsonl")])
    rows = []
    for name in ("one", "two"):
        with open(root / f"{name}.jsonl") as f:
            rows.append([json.loads(l) for l in f])
    assert len(rows[0]) == len(rows[1]) == 11
    for a, b in zip(*rows):
        assert a["user"] == b["user"] and a["items"] == b["items"]
        np.testing.assert_allclose(a["scores"], b["scores"], atol=2e-4)


def test_dryrun_world_4():
    out = run_torchrun(4, ["-m", "recformer_tpu_torch.parallel.dryrun", "--device", "cpu"])
    assert "backend=gloo world=4 data=2 model=2" in out
    for name in ("pretrain", "finetune_sampled", "finetune_full", "zero", "tensor_parallel",
                 "local", "sequence_parallel_forward", "sequence_parallel", "pipeline_forward",
                 "pipeline_parallel"):
        assert f"[dryrun] {name} " in out, out[-3000:]
