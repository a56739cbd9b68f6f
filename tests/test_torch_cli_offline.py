"""The port's offline forward CLIs (``cli.encode_items``, ``cli.evaluate_seq``)
against the JAX package's on one corpus with one checkpoint, the stacked
``scan_layers`` weight layout, and the pretraining CLI's new flags.

The corpus is ``tests/test_cli.py``'s (25 items, 20 users); the checkpoint
is a ``.bin`` written from the port's state dict with a wide initializer,
so the catalog is spread (at the default 0.02 every cosine is within 1e-5
of 1). The CLIs have no dtype flag: the float32 comparisons wrap each CLI's
``build_config`` to set ``dtype='float32'``, which keeps bf16 near-ties
from flipping a rank.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recformer_tpu.cli import encode_items as jax_encode_cli
from recformer_tpu.cli import evaluate_seq as jax_eval_cli
from recformer_tpu.config import RecformerConfig as JaxConfig
from recformer_tpu.models.heads import RecformerForSeqRec as JaxSeqRec
from recformer_tpu.training.checkpoint import stack_layer_params as jax_stack
from recformer_tpu.training.checkpoint import unstack_layer_params as jax_unstack
from recformer_tpu_torch import weights
from recformer_tpu_torch.cli import encode_items as torch_encode_cli
from recformer_tpu_torch.cli import evaluate_seq as torch_eval_cli
from recformer_tpu_torch.config import RecformerConfig
from recformer_tpu_torch.models.heads import RecformerForSeqRec
from recformer_tpu_torch.models.recformer import init_weights

N_ITEMS, N_USERS = 25, 20


def write_corpus(root):
    """The tests/test_cli.py corpus: 25 items, 20 users, train/val/test."""
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
                      ("smap", smap)):
        with open(os.path.join(root, f"{name}.json"), "w") as f:
            json.dump(obj, f)
    return str(root)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    cfg = RecformerConfig.tiny(initializer_range=0.5)
    model = RecformerForSeqRec(cfg)
    init_weights(model, cfg, torch.Generator().manual_seed(7))
    path = str(tmp_path_factory.mktemp("ckpt") / "model.bin")
    torch.save(model.state_dict(), path)
    return path


def in_float32(monkeypatch, *cli_modules):
    for mod in cli_modules:
        build = mod.build_config
        monkeypatch.setattr(mod, "build_config", lambda args, item_num=0, _b=build:
                            dataclasses.replace(_b(args, item_num=item_num), dtype="float32"))


def corpus(tmp_path, name):
    """A fresh copy of the corpus per run: each CLI caches its tokenized
    table and its catalog under ``<data>/preprocess``."""
    return write_corpus(tmp_path / name)


COMMON = ["--model_size", "tiny", "--attention_impl", "pallas"]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_encode_items_cli_matches_jax(tmp_path, checkpoint, monkeypatch, dtype):
    """Both CLIs write the (25, 64) catalog from one .bin. float32 within
    1e-4; bf16 within 3% of max|ref| (two layers of bf16 activations whose
    rounding points differ between the stacks; 1.6% measured)."""
    if dtype == "float32":
        in_float32(monkeypatch, jax_encode_cli, torch_encode_cli)
    common = COMMON + ["--ckpt", checkpoint, "--batch_size", "8"]
    jax_encode_cli.main(["--data_path", corpus(tmp_path, "j"),
                         "--output", str(tmp_path / "jax.npy")] + common)
    out = torch_encode_cli.main(["--data_path", corpus(tmp_path, "t"),
                                 "--output", str(tmp_path / "torch.npy"), "--device", "cpu"]
                                + common)
    ref = np.load(tmp_path / "jax.npy")
    if dtype == "bfloat16":  # JAX saves bf16, which numpy reads as raw 2-byte records
        ref = ref.view(jnp.bfloat16)
    ref = ref.astype(np.float32)
    saved = np.load(tmp_path / "torch.npy")
    assert saved.dtype == np.float32 and saved.shape == (N_ITEMS, 64)
    np.testing.assert_array_equal(saved, out)
    tol = 1e-4 if dtype == "float32" else 0.03 * np.abs(ref).max()
    assert np.abs(saved - ref).max() <= tol


def test_evaluate_seq_cli_matches_jax(tmp_path, checkpoint, monkeypatch):
    """Full-catalog ranked metrics of the test split, float32, within 1e-5."""
    in_float32(monkeypatch, jax_eval_cli, torch_eval_cli)
    common = COMMON + ["--ckpt", checkpoint, "--batch_size", "8", "--encode_batch_size", "8"]
    ref = jax_eval_cli.main(["--data_path", corpus(tmp_path, "j")] + common)
    out = torch_eval_cli.main(["--data_path", corpus(tmp_path, "t"), "--device", "cpu",
                               "--output_file", str(tmp_path / "metrics.json")] + common)
    assert set(out) == set(ref) and "NDCG@10" in out
    for k in ref:
        assert out[k] == pytest.approx(ref[k], abs=1e-5), k
    with open(tmp_path / "metrics.json") as f:
        assert json.load(f) == out


def test_evaluate_seq_reads_a_saved_catalog(tmp_path, checkpoint):
    """``--item_embeddings`` with the catalog ``cli.encode_items`` saved gives
    the metrics of a fresh encode (bf16, the default); the scan and remat
    flags are taken and change no forward pass; the fresh encode leaves the
    fingerprint-keyed catalog cache behind."""
    data = corpus(tmp_path, "t")
    common = COMMON + ["--ckpt", checkpoint, "--device", "cpu"]
    emb = str(tmp_path / "catalog.npy")
    torch_encode_cli.main(["--data_path", data, "--output", emb, "--batch_size", "8"] + common)
    eval_common = common + ["--batch_size", "8", "--encode_batch_size", "8"]
    fresh = torch_eval_cli.main(["--data_path", data] + eval_common)
    assert os.path.exists(os.path.join(data, "preprocess", "item_emb_t.npz"))
    saved = torch_eval_cli.main(["--data_path", data, "--item_embeddings", emb] + eval_common)
    assert saved == fresh
    flagged = torch_eval_cli.main(["--data_path", data, "--item_embeddings", emb, "--scan_layers",
                                   "--scan_unroll", "2", "--remat", "--remat_policy", "dots"]
                                  + eval_common)
    assert flagged == fresh


def test_evaluate_seq_refuses_sharded_eval(tmp_path):
    with pytest.raises(SystemExit, match="sharded_eval 2"):
        torch_eval_cli.main(["--data_path", corpus(tmp_path, "t"), "--ckpt", "",
                             "--model_size", "tiny", "--device", "cpu", "--sharded_eval", "2"])


@pytest.mark.parametrize("cli", [torch_encode_cli, torch_eval_cli],
                         ids=["encode_items", "evaluate_seq"])
def test_offline_clis_default_to_cuda(tmp_path, cli):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--data_path", corpus(tmp_path, "t"), "--ckpt", "", "--model_size", "tiny"])


def jax_params():
    jcfg = JaxConfig.tiny()
    dummy = {k: jnp.zeros((1, jcfg.item_seq_len), jnp.int32)
             for k in ("input_ids", "attention_mask", "global_attention_mask",
                       "token_type_ids", "item_position_ids")}
    params = JaxSeqRec(jcfg).init(jax.random.PRNGKey(3), dummy)
    return jax.tree.map(np.asarray, params)["params"]


def flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


def test_stacked_layer_layout_loads_and_writes():
    """``from_flax_params`` reads the stacked ``scan_layers`` tree as the
    unrolled one; ``to_flax_params(..., stacked=True)`` writes what JAX's
    ``stack_layer_params`` makes of the unrolled tree, and JAX's
    ``unstack_layer_params`` reads it back; the port's own stack/unstack
    agree with JAX's on the JAX tree."""
    tree = jax_params()
    stacked = jax_stack(tree)
    assert "layers" in stacked["longformer"]["encoder"]
    sd = weights.from_flax_params(tree)
    sd_stacked = weights.from_flax_params({"params": stacked})
    assert set(sd_stacked) == set(sd)
    for k in sd:
        assert torch.equal(sd_stacked[k], sd[k]), k
    RecformerForSeqRec(RecformerConfig.tiny()).load_state_dict(sd_stacked, strict=True)

    written = flat(weights.to_flax_params(sd, stacked=True))
    expected = flat(jax_stack(weights.to_flax_params(sd)))
    assert set(written) == set(expected)
    for k in expected:
        np.testing.assert_array_equal(written[k], expected[k], err_msg="/".join(k))
    back = flat(jax_unstack(weights.to_flax_params(sd, stacked=True)))
    for k, v in flat(tree).items():
        np.testing.assert_array_equal(back[k], v, err_msg="/".join(k))
    ours = flat(weights.stack_layer_params(tree))
    assert set(ours) == set(flat(stacked))
    for k, v in flat(stacked).items():
        np.testing.assert_array_equal(ours[k], v)
    assert flat(weights.unstack_layer_params(stacked)).keys() == flat(tree).keys()


def test_pretrain_takes_scan_flags_and_a_local_tokenizer(tmp_path, monkeypatch):
    """``--scan_layers``/``--scan_unroll`` reach the config the run saves;
    ``--hf_tokenizer`` reaches ``make_tokenizer`` (a local path)."""
    from recformer_tpu_torch.cli import pretrain
    from recformer_tpu_torch.config import RecformerConfig as Cfg

    data = write_corpus(tmp_path / "data")
    seqs = json.load(open(os.path.join(data, "train.json")))
    with open(os.path.join(data, "train.json"), "w") as f:  # pretraining takes a list of sequences
        json.dump([s + [i % N_ITEMS] for i, s in enumerate(seqs.values())], f)
    out_dir = tmp_path / "out"
    res = pretrain.main(["--data_path", data, "--output_dir", str(out_dir), "--model_size", "tiny",
                         "--num_train_epochs", "1", "--batch_size", "4",
                         "--gradient_accumulation_steps", "1", "--warmup_steps", "1",
                         "--scan_layers", "--scan_unroll", "2", "--device", "cpu"])
    assert res["steps"] >= 1
    cfg = Cfg.load(os.path.join(out_dir, "config.json"))
    assert cfg.scan_layers is True and cfg.scan_unroll == 2

    seen = {}

    class Stop(Exception):
        pass

    def fake_tokenizer(config, path=None):
        seen["path"] = path
        raise Stop  # end the run once the tokenizer is asked for

    monkeypatch.setattr(pretrain, "make_tokenizer", fake_tokenizer)
    with pytest.raises(Stop):
        pretrain.main(["--data_path", data, "--output_dir", str(out_dir), "--model_size", "tiny",
                       "--hf_tokenizer", str(tmp_path / "tok"), "--device", "cpu"])
    assert seen["path"] == str(tmp_path / "tok")
