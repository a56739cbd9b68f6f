"""The port's clustering CLI (``recformer_tpu_torch/cli/cluster.py``) against
the JAX package's on one corpus with one checkpoint, its cache-hit rerun,
and the synthetic corpus generator (``pipelines/synthetic.py``).

The corpus is ``tests/test_cli.py``'s ``artifacts`` at 60 users (one with an
empty training history, whose row is dropped); the checkpoint is a ``.bin``
written from the port's state dict with a wide initializer, so the
embeddings are spread (at the default 0.02 a random model's pooled outputs
are nearly parallel). Both CLIs run in float32 (their ``build_config``
wrapped to set ``dtype='float32'``).
"""

import dataclasses
import filecmp
import json
import os
import shutil

import numpy as np
import pytest
import torch

from recformer_tpu.cli import cluster as jax_cluster_cli
from recformer_tpu.pipelines import synthetic as jax_synthetic
from recformer_tpu_torch.cli import cluster as torch_cluster_cli
from recformer_tpu_torch.config import RecformerConfig
from recformer_tpu_torch.models.heads import RecformerForSeqRec
from recformer_tpu_torch.models.recformer import init_weights
from recformer_tpu_torch.pipelines import synthetic as torch_synthetic

N_ITEMS, N_USERS = 25, 60
OUTPUTS = ("cluster_labels.npy", "cluster_centers.npy", "cluster_stats.json", "k_sweep.json",
           "pca_2d.npy", "sequence_embeddings.npy", "top1_predictions.npy")


def write_corpus(root):
    rng = np.random.default_rng(0)
    words = ["red", "blue", "bolt", "nut", "gear", "led", "cap", "fan"]
    meta = {f"I{i:03d}": {"make": words[i % len(words)], "hue": words[(i * 3 + 1) % len(words)]}
            for i in range(N_ITEMS)}
    smap = {f"I{i:03d}": i for i in range(N_ITEMS)}
    train, val, test = {}, {}, {}
    for u in range(N_USERS):
        seq = [int(x) for x in rng.integers(0, N_ITEMS, size=rng.integers(4, 9))]
        train[u], val[u], test[u] = seq[:-2], [seq[-2]], [seq[-1]]
    train[17] = []  # an invalid row: dropped from the embeddings
    os.makedirs(root, exist_ok=True)
    for name, obj in (("train", train), ("val", val), ("test", test), ("meta_data", meta),
                      ("smap", smap)):
        with open(os.path.join(root, f"{name}.json"), "w") as f:
            json.dump(obj, f)
    return str(root)


def in_float32(mp):
    for mod in (jax_cluster_cli, torch_cluster_cli):
        build = mod.build_config
        mp.setattr(mod, "build_config", lambda args, item_num=0, _b=build:
                   dataclasses.replace(_b(args, item_num=item_num), dtype="float32"))


def common(ckpt):
    return ["--model_size", "tiny", "--attention_impl", "pallas", "--ckpt", ckpt,
            "--batch_size", "8"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs with the k sweep (2-5) and PCA, each on its own copy of the
    corpus (each caches its tokenized table under ``<data>/preprocess``).
    Returns (root, checkpoint path)."""
    root = tmp_path_factory.mktemp("cluster")
    cfg = RecformerConfig.tiny(initializer_range=0.5)
    model = RecformerForSeqRec(cfg)
    init_weights(model, cfg, torch.Generator().manual_seed(7))
    ckpt = str(root / "model.bin")
    torch.save(model.state_dict(), ckpt)
    sweep = ["--min_clusters", "2", "--max_clusters", "5"]
    with pytest.MonkeyPatch.context() as mp:
        in_float32(mp)
        jax_cluster_cli.main(["--data_path", write_corpus(root / "jdata"),
                              "--output_dir", str(root / "jax")] + common(ckpt) + sweep)
        torch_cluster_cli.main(["--data_path", write_corpus(root / "tdata"), "--output_dir",
                                str(root / "torch"), "--device", "cpu"] + common(ckpt) + sweep)
    return root, ckpt


def load(root, stack, name):
    path = os.path.join(root, stack, name)
    if name.endswith(".npy"):
        return np.load(path)
    with open(path) as f:
        return json.load(f)


def assert_stats_close(got, want, tol):
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        if isinstance(w, dict):
            assert_stats_close(g, w, tol)
        else:
            assert g == pytest.approx(w, rel=tol, abs=tol), key


def test_embeddings_and_top1_match_jax(runs):
    root, _ = runs
    emb, ref = load(root, "torch", "sequence_embeddings.npy"), load(root, "jax",
                                                                   "sequence_embeddings.npy")
    assert emb.dtype == np.float32 and emb.shape == ref.shape == (N_USERS - 1, 64)
    assert np.abs(emb - ref).max() <= 1e-4
    top1, ref_top1 = load(root, "torch", "top1_predictions.npy"), load(root, "jax",
                                                                      "top1_predictions.npy")
    assert top1.dtype == ref_top1.dtype == np.int32
    np.testing.assert_array_equal(top1, ref_top1)


def test_sweep_labels_stats_and_projection_match_jax(runs):
    root, _ = runs
    sweep, ref = load(root, "torch", "k_sweep.json"), load(root, "jax", "k_sweep.json")
    assert sweep["optimal_k"] == ref["optimal_k"]
    assert sweep["sweep"].keys() == ref["sweep"].keys() == {"2", "3", "4", "5"}
    for k, row in ref["sweep"].items():
        assert sweep["sweep"][k]["inertia"] == pytest.approx(row["inertia"], rel=1e-4)
        assert sweep["sweep"][k]["silhouette"] == pytest.approx(row["silhouette"], abs=1e-4)
    labels = load(root, "torch", "cluster_labels.npy")
    assert labels.dtype == np.int32
    np.testing.assert_array_equal(labels, load(root, "jax", "cluster_labels.npy"))
    stats = load(root, "torch", "cluster_stats.json")
    assert stats["k"] == sweep["optimal_k"] == len(stats["clusters"])
    assert_stats_close(stats, load(root, "jax", "cluster_stats.json"), 1e-6)
    proj, ref_proj = load(root, "torch", "pca_2d.npy"), load(root, "jax", "pca_2d.npy")
    signs = np.sign((proj * ref_proj).sum(0))  # each principal axis up to its sign
    assert np.abs(proj * signs - ref_proj).max() <= 1e-4


def test_fraud_overlay_and_n_clusters_match_jax(runs, tmp_path):
    """``--n_clusters 3 --fraud_labels`` from each stack's saved embeddings
    (the cache-hit path): the same per-cluster stats, ``mean_fraud`` in
    each, and no sweep."""
    root, ckpt = runs
    flags = {u: int(u % 4 == 0) for u in range(N_USERS)}
    with open(tmp_path / "fraud.json", "w") as f:
        json.dump(flags, f)
    out = {}
    for stack, cli, extra in (("jax", jax_cluster_cli, []),
                              ("torch", torch_cluster_cli, ["--device", "cpu"])):
        out[stack] = tmp_path / stack
        os.makedirs(out[stack])
        for name in ("sequence_embeddings.npy", "top1_predictions.npy"):
            shutil.copy(os.path.join(root, stack, name), out[stack])
        cli.main(["--data_path", os.path.join(root, stack[0] + "data"), "--output_dir",
                  str(out[stack]), "--n_clusters", "3", "--fraud_labels",
                  str(tmp_path / "fraud.json")] + common(ckpt) + extra)
    stats = load(tmp_path, "torch", "cluster_stats.json")
    assert stats["k"] == 3 and all("mean_fraud" in c for c in stats["clusters"].values())
    assert_stats_close(stats, load(tmp_path, "jax", "cluster_stats.json"), 1e-6)
    assert not os.path.exists(out["torch"] / "k_sweep.json")
    assert os.path.exists(out["torch"] / "fraud_overlay_2d.png")


def test_cache_hit_rerun_is_byte_equal(runs, tmp_path, monkeypatch, capsys):
    """A rerun into the same output directory encodes nothing and rewrites
    the same bytes."""
    root, ckpt = runs
    out = tmp_path / "rerun"
    shutil.copytree(os.path.join(root, "torch"), out)

    def no_encoding(*a, **k):
        raise AssertionError("a cache hit encodes nothing")

    monkeypatch.setattr(torch_cluster_cli, "encode_all_items", no_encoding)
    monkeypatch.setattr(torch_cluster_cli, "extract_embeddings", no_encoding)
    torch_cluster_cli.main(["--data_path", os.path.join(root, "tdata"), "--output_dir", str(out),
                            "--device", "cpu", "--min_clusters", "2", "--max_clusters", "5"]
                           + common(ckpt))
    assert "[cluster] cache hit" in capsys.readouterr().out
    for name in OUTPUTS:
        assert filecmp.cmp(out / name, os.path.join(root, "torch", name), shallow=False), name


def test_describe_clusters_matches_jax(runs):
    """The description tail with an injected completer: the same prompts,
    one per cluster."""
    root, _ = runs
    data = os.path.join(root, "tdata")
    with open(os.path.join(data, "meta_data.json")) as f:
        meta = json.load(f)
    id2item = {i: f"I{i:03d}" for i in range(N_ITEMS)}
    labels, preds = (load(root, "torch", n) for n in ("cluster_labels.npy",
                                                      "top1_predictions.npy"))
    prompts = {"jax": [], "torch": []}
    for stack, cli in (("jax", jax_cluster_cli), ("torch", torch_cluster_cli)):
        got = cli.describe_clusters(labels, preds, meta, id2item,
                                    completer=lambda s, t, _p=prompts[stack]: _p.append(t) or
                                    f"cluster {len(_p)}")
        assert got == {int(c): f"cluster {i + 1}" for i, c in enumerate(np.unique(labels))}
    assert prompts["torch"] == prompts["jax"] and len(prompts["torch"]) == len(np.unique(labels))


def test_device_cuda_without_a_gpu_raises(runs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the request is valid")
    root, ckpt = runs
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_cluster_cli.main(["--data_path", os.path.join(root, "tdata"), "--output_dir",
                                str(tmp_path / "out")] + common(ckpt))
    assert not os.path.exists(tmp_path / "out")


def test_synthetic_tiny_corpus_is_byte_equal_to_jax(tmp_path):
    jax_synthetic.main(["--out", str(tmp_path / "jax"), "--scale", "tiny", "--seed", "3"])
    torch_synthetic.main(["--out", str(tmp_path / "torch"), "--scale", "tiny", "--seed", "3"])
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "jax")
                   for d, _, fs in os.walk(tmp_path / "jax") for f in fs)
    assert len(files) == 10 and "stats.json" in files
    for name in files:
        assert filecmp.cmp(tmp_path / "jax" / name, tmp_path / "torch" / name,
                           shallow=False), name
