"""The port's checkpoints and the entry points that write them, on the CPU:
``TopKCheckpointManager``, ``cli.finetune`` end to end (outputs that
``cli.evaluate_seq`` reproduces, a stale ``loop_state/``, ``--remat``,
``--fix_word_embedding``, the default device), a finetuned ``best_model.pt``
carried into the JAX package's flax tree, ``cli.pretrain``'s preemption
checkpoint, ``--resume`` and ``--save_top_k``, and a pretraining ``best.pt``
as ``cli.finetune``'s starting point. ``tiny()`` sizes."""

import json
import os
import signal

import jax
import numpy as np
import pytest
import torch

from recformer_tpu.cli.common import init_model_params as jax_init_params
from recformer_tpu.config import RecformerConfig as JaxConfig
from recformer_tpu.models.heads import RecformerForSeqRec as JaxSeqRec
from recformer_tpu.training.checkpoint import import_torch_state_dict
from recformer_tpu_torch.cli import evaluate_seq, finetune, pretrain
from recformer_tpu_torch.cli.common import init_model_params
from recformer_tpu_torch.config import RecformerConfig
from recformer_tpu_torch.models.heads import RecformerForPretraining, RecformerForSeqRec
from recformer_tpu_torch.training.checkpoint import (
    TopKCheckpointManager,
    restore_params,
    restore_train_state,
    save_params,
)
from recformer_tpu_torch.training.optimizer import create_optimizer
from recformer_tpu_torch.weights import to_flax_params

N_ITEMS, N_USERS = 25, 20
TINY = RecformerConfig.tiny(item_num=N_ITEMS)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Tiny models gain nothing from many intra-op threads, and beside other
    test processes on the same cores they lose much to contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def write_corpus(root):
    """The tests/test_cli.py corpus: 25 items, 20 users, train/val/test;
    for ``cli.pretrain`` also ``pretrain.json`` (12 of the train histories)
    and ``dev.json`` (8)."""
    rng = np.random.default_rng(0)
    words = ["red", "blue", "bolt", "nut", "gear", "led", "cap", "fan"]
    meta = {f"I{i:03d}": {"make": words[i % len(words)], "hue": words[(i * 3 + 1) % len(words)]}
            for i in range(N_ITEMS)}
    smap = {f"I{i:03d}": i for i in range(N_ITEMS)}
    train, val, test = {}, {}, {}
    for u in range(N_USERS):
        seq = list(rng.integers(0, N_ITEMS, size=rng.integers(4, 9)))
        train[u] = [int(x) for x in seq[:-2]]
        val[u] = [int(seq[-2])]
        test[u] = [int(seq[-1])]
    os.makedirs(root, exist_ok=True)
    for name, obj in (("train", train), ("val", val), ("test", test), ("meta_data", meta),
                      ("smap", smap), ("pretrain", list(train.values())[:12]),
                      ("dev", list(train.values())[:8])):
        with open(os.path.join(root, f"{name}.json"), "w") as f:
            json.dump(obj, f)
    return str(root)


FT = ["--model_size", "tiny", "--num_train_epochs", "2", "--batch_size", "8",
      "--eval_batch_size", "8", "--encode_batch_size", "8", "--verbose", "1",
      "--gradient_accumulation_steps", "1", "--finetune_negative_sample_size", "5",
      "--device", "cpu"]


def test_topk_checkpoint_manager(tmp_path):
    small = {"w": torch.ones(3)}
    root = str(tmp_path / "topk")
    mgr = TopKCheckpointManager(root, k=2, mode="max")
    assert mgr.save(small, 1, 0.5) is not None
    assert mgr.save(small, 2, 0.7) is not None
    assert mgr.save(small, 3, 0.3) is None  # worse than both, at capacity
    assert mgr.save(small, 4, 0.9) is not None
    kept = sorted(os.listdir(root))
    assert kept == ["step2_m0.700000", "step4_m0.900000"]
    assert mgr.best_path().endswith("step4_m0.900000")
    assert torch.equal(restore_params(mgr.best_path())["w"], small["w"])
    # a directory written before is read back
    mgr2 = TopKCheckpointManager(root, k=2, mode="max")
    assert mgr2.best_path().endswith("step4_m0.900000")
    assert mgr2.save(small, 5, 0.6) is None
    low = TopKCheckpointManager(str(tmp_path / "low"), k=1, mode="min")
    low.save(small, 1, 0.5)
    low.save(small, 2, 0.2)
    assert os.listdir(str(tmp_path / "low")) == ["step2_m0.200000"]


@pytest.fixture(scope="module")
def finetuned(tmp_path_factory):
    """One ``cli.finetune`` run (learning rate 1e-3) with its outputs."""
    root = tmp_path_factory.mktemp("ft")
    data = write_corpus(root / "data")
    out = root / "out"
    metrics = finetune.main(["--data_path", data, "--output_dir", str(out),
                             "--learning_rate", "1e-3"] + FT)
    return data, out / "data", metrics


def test_finetune_cli_outputs_reproduce_through_evaluate_seq(finetuned):
    """``best_model.pt`` and ``item_embeddings.npy`` give ``test_metrics.json``
    again through ``cli.evaluate_seq --ckpt --item_embeddings`` (1e-6); the
    run moved the parameters; ``loop_state/`` is gone."""
    data, out, metrics = finetuned
    assert sorted(os.listdir(out)) == ["best_model.pt", "config.json", "item_embeddings.npy",
                                       "test_metrics.json"]
    with open(out / "test_metrics.json") as f:
        saved = json.load(f)
    assert saved == metrics and "NDCG@10" in metrics
    emb = np.load(out / "item_embeddings.npy")
    assert emb.dtype == np.float32 and emb.shape == (N_ITEMS, 64)
    again = evaluate_seq.main(["--data_path", data, "--ckpt", str(out / "best_model.pt"),
                               "--item_embeddings", str(out / "item_embeddings.npy"),
                               "--model_size", "tiny", "--batch_size", "8", "--device", "cpu"])
    assert set(again) == set(metrics)
    for k in metrics:
        assert again[k] == pytest.approx(metrics[k], abs=1e-6), k
    fresh = init_model_params(RecformerForSeqRec(TINY), TINY, device="cpu")
    best = restore_params(str(out / "best_model.pt"))
    assert any(not torch.equal(best[k], v) for k, v in fresh.state_dict().items())


def test_finetuned_model_carries_into_the_jax_tree(finetuned):
    """Every tensor of ``best_model.pt`` maps to a leaf of the JAX
    ``RecformerForSeqRec`` tree and back, unchanged."""
    _, out, _ = finetuned
    sd = {k: v.numpy() for k, v in torch.load(out / "best_model.pt",
                                              weights_only=True).items()}
    jcfg = JaxConfig.tiny(item_num=N_ITEMS)
    params = jax_init_params(JaxSeqRec(jcfg), jcfg)
    new, copied, skipped = import_torch_state_dict(sd, params, strict=True, verbose=False)
    assert skipped == [] and len(copied) == len(sd)
    leaves = jax.tree_util.tree_leaves_with_path(new["params"])
    assert len(leaves) == len(sd)
    back = to_flax_params({k: torch.from_numpy(v) for k, v in sd.items()})
    theirs = dict(jax.tree_util.tree_leaves_with_path(new["params"]))
    for path, leaf in jax.tree_util.tree_leaves_with_path(back):
        np.testing.assert_array_equal(leaf, np.asarray(theirs[path]))


def test_finetune_cli_refusals(tmp_path):
    """A stale ``loop_state/`` without ``--resume`` exits; without
    ``--device`` and without CUDA the command raises."""
    data = write_corpus(tmp_path / "data")
    out = tmp_path / "out"
    os.makedirs(out / "data" / "loop_state")
    (out / "data" / "loop_state" / "loop.json").write_text("{}")
    with pytest.raises(SystemExit, match="--resume"):
        finetune.main(["--data_path", data, "--output_dir", str(out)] + FT)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            finetune.main(["--data_path", data, "--model_size", "tiny",
                           "--output_dir", str(tmp_path / "o3")])


def test_finetune_fix_word_embedding_keeps_the_table(tmp_path):
    """``--fix_word_embedding``: the word table stays bit-equal to its
    initial value while the rest moves."""
    data = write_corpus(tmp_path / "data")
    out = tmp_path / "out"
    finetune.main(["--data_path", data, "--output_dir", str(out), "--learning_rate", "1e-2",
                   "--fix_word_embedding", "--seed", "7"] + FT)
    saved = restore_params(str(out / "data" / "best_model.pt"))
    fresh = init_model_params(RecformerForSeqRec(TINY), TINY, device="cpu").state_dict()
    name = "longformer.embeddings.word_embeddings.weight"
    assert torch.equal(saved[name], fresh[name])
    pos = "longformer.embeddings.item_position_embeddings.weight"
    assert not torch.equal(saved[pos], fresh[pos])


# ---------------------------------------------------------------------------
# cli.pretrain: preemption, resume, top-k; its best.pt into cli.finetune
# ---------------------------------------------------------------------------

class TripAfter(dict):
    """Reads as un-signalled for the first ``n`` step-boundary checks."""

    def __init__(self, n):
        super().__init__(signal=0)
        self.reads = 0
        self.n = n

    def __getitem__(self, k):
        self.reads += 1
        return signal.SIGTERM if self.reads > self.n else 0


def test_pretrain_preemption_handler_latches_sigterm():
    old = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        flag = pretrain._install_preemption_handler()
        assert flag["signal"] == 0
        os.kill(os.getpid(), signal.SIGTERM)
        assert flag["signal"] == signal.SIGTERM
    finally:
        for s, h in old.items():
            signal.signal(s, h)


def test_pretrain_preemption_resume_and_top_k(tmp_path, monkeypatch):
    """12 histories at batch 4: 3 steps an epoch. A trip after the 4th step
    boundary saves ``state.pt`` and ``last.pt`` at step 5 (in epoch 1) and
    returns; ``--resume`` restores step 5, restarts epoch 1 from its first
    batch and runs to the end; ``--save_top_k 2`` leaves two of the three
    epoch-end validations; the handlers in place before the run are back
    after it."""
    data = write_corpus(tmp_path / "data")
    out = tmp_path / "out"
    common = ["--data_path", data, "--train_file", "pretrain.json", "--output_dir", str(out),
              "--model_size", "tiny", "--batch_size", "4", "--gradient_accumulation_steps", "2",
              "--warmup_steps", "1", "--num_train_epochs", "3", "--save_top_k", "2",
              "--device", "cpu"]
    before = signal.getsignal(signal.SIGTERM)
    monkeypatch.setattr(pretrain, "_install_preemption_handler", lambda: TripAfter(4))
    res = pretrain.main(common)
    assert res["steps"] == 5 and res["preempted"] == signal.SIGTERM
    assert {"state.pt", "last.pt"} <= set(os.listdir(out))
    assert not (out / "config.json").exists()
    model = init_model_params(RecformerForPretraining(TINY), TINY, device="cpu")
    opt = create_optimizer(model, grad_accum_steps=2)
    pos = restore_train_state(str(out / "state.pt"), model, opt)
    assert pos["epoch"] == 1 and pos["global_step"] == 5 and opt.micro_steps == 5
    assert (opt.updates, opt.mini_step) == (2, 1)
    assert torch.equal(restore_params(str(out / "last.pt"))["lm_head.bias"],
                       model.state_dict()["lm_head.bias"])

    monkeypatch.setattr(pretrain, "_install_preemption_handler", lambda: {"signal": 0})
    res = pretrain.main(common + ["--resume"])
    assert res["steps"] == 5 + 2 * 3 and "preempted" not in res
    assert (out / "config.json").exists()
    assert len(os.listdir(out / "topk")) == 2
    assert signal.getsignal(signal.SIGTERM) == before


def test_pretrain_best_loads_into_finetune(tmp_path):
    """``cli.pretrain``'s ``best.pt`` as ``cli.finetune --pretrain_ckpt``:
    with no epoch to train, ``best_model.pt`` holds every backbone tensor of
    ``best.pt`` exactly and no MLM-head tensor."""
    data = write_corpus(tmp_path / "data")
    pre = tmp_path / "pre"
    pretrain.main(["--data_path", data, "--output_dir", str(pre), "--model_size", "tiny",
                   "--num_train_epochs", "1", "--batch_size", "4", "--warmup_steps", "1",
                   "--gradient_accumulation_steps", "1", "--learning_rate", "1e-2",
                   "--device", "cpu"])
    out = tmp_path / "out"
    finetune.main(["--data_path", data, "--output_dir", str(out), "--pretrain_ckpt",
                   str(pre / "best.pt"), "--model_size", "tiny", "--num_train_epochs", "0",
                   "--encode_batch_size", "8", "--eval_batch_size", "8", "--device", "cpu"])
    best = restore_params(str(pre / "best.pt"))
    got = restore_params(str(out / "data" / "best_model.pt"))
    backbone = {k for k in best if k.startswith("longformer.")}
    assert set(got) == backbone and any(k.startswith("lm_head.") for k in best)
    for k in backbone:
        assert torch.equal(got[k], best[k]), k
    fresh = init_model_params(RecformerForSeqRec(TINY), TINY, device="cpu").state_dict()
    assert not all(torch.equal(got[k], fresh[k]) for k in got)  # pretraining moved them


def test_save_params_is_atomic_and_cpu(tmp_path):
    """The file holds CPU tensors equal to the model's, and no temporary file
    is left beside it."""
    model = init_model_params(RecformerForSeqRec(TINY), TINY, device="cpu")
    path = str(tmp_path / "p" / "m.pt")
    save_params(path, model)
    assert os.listdir(tmp_path / "p") == ["m.pt"]
    sd = restore_params(path)
    RecformerForSeqRec(TINY).load_state_dict(sd, strict=True)
    assert all(v.device.type == "cpu" for v in sd.values())
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v)
