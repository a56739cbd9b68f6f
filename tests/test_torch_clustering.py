"""The port's clustering analytics (``recformer_tpu_torch/utils/clustering.py``)
against the JAX package's: the Lloyd step and k-means (torch on the CPU here,
float32, against the jit'd JAX step), the sweep and the optimal k, and the
numpy functions the port copies (silhouette, projections, grouping,
descriptions, stats, plots), which must give the same results bit for bit
on the same input."""

import os
import sys

import numpy as np
import pytest
import torch

from recformer_tpu.utils import clustering as jc
from recformer_tpu_torch.utils import clustering as tc


def blobs(seed, n=240, d=16, k=4, spread=0.3, scale=1.5, offset=0.0):
    """``k`` Gaussian blobs in ``d`` dimensions, float32: centres drawn at
    ``scale`` around ``offset`` in every coordinate, points at ``spread``
    around them."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(0, scale, size=(k, d))
    labels = rng.integers(0, k, size=n)
    return (offset + centres[labels] + rng.normal(0, spread, size=(n, d))).astype(np.float32)


def step_case(case):
    x = blobs(0, n=200, spread=1.5)
    rng = np.random.default_rng(1)
    centres = x[rng.choice(len(x), 5, replace=False)].copy()
    if case == "empty_cluster":  # nothing is nearest to a far centre: it keeps its place
        centres[2] = 1e3
    elif case == "tied_centres":  # equal distances: the first index wins in both stacks
        centres[3] = centres[1]
    return x, centres


@pytest.mark.parametrize("case", ["random", "empty_cluster", "tied_centres"])
def test_lloyd_step_matches_jax(case):
    x, centres = step_case(case)
    want_assign, want_centres, want_inertia = (np.asarray(a) for a in jc._lloyd_step(
        x, centres, k=len(centres)))
    assign, new, inertia = tc._lloyd_step(torch.from_numpy(x), torch.from_numpy(centres))
    np.testing.assert_array_equal(assign.numpy(), want_assign)
    np.testing.assert_allclose(new.numpy(), want_centres, rtol=0, atol=1e-5)
    assert float(inertia) == pytest.approx(float(want_inertia), rel=1e-5)
    if case == "empty_cluster":
        assert not (assign.numpy() == 2).any()
        np.testing.assert_array_equal(new.numpy()[2], centres[2])
    if case == "tied_centres":
        assert not (assign.numpy() == 3).any()


@pytest.mark.parametrize("k", [2, 4, 6])
def test_kmeans_matches_jax(k):
    x = blobs(2)
    labels, centres, inertia = tc.kmeans(x, k, device="cpu")
    want_labels, want_centres, want_inertia = jc.kmeans(x, k)
    assert labels.dtype == np.int32 and centres.dtype == np.float32
    np.testing.assert_array_equal(labels, want_labels)
    np.testing.assert_allclose(centres, want_centres, rtol=0, atol=1e-5)
    assert inertia == pytest.approx(want_inertia, rel=1e-5)


def test_lloyd_float32_holds_float64_far_from_the_origin():
    """Tight clusters far from the origin, like a random model's pooled
    embeddings: from the same centres, the port's float32 loop (data
    shifted by its mean) gives the float64 loop's labels and its inertia
    within 1e-5; the JAX step's unshifted float32 expansion, with the same
    labels, is more than 1e-3 off (the divergence by design)."""
    x = blobs(3, spread=0.02, scale=0.2, offset=5.0)
    init = jc._kmeans_pp_init(x, 4, np.random.default_rng(42))
    a32, c32, i32 = tc.lloyd(torch.from_numpy(x), torch.from_numpy(init))
    a64, c64, i64 = tc.lloyd(torch.from_numpy(x).double(), torch.from_numpy(init).double())
    assert c32.dtype == torch.float32 and c64.dtype == torch.float64
    np.testing.assert_array_equal(a32.numpy(), a64.numpy())
    np.testing.assert_allclose(c32.numpy(), c64.numpy(), rtol=0, atol=1e-5)
    assert i32 == pytest.approx(i64, rel=1e-5)
    jax_labels, _, jax_inertia = jc.kmeans(x, 4)  # the same k-means++ draws (seed 42)
    np.testing.assert_array_equal(jax_labels, a64.numpy())
    assert abs(jax_inertia - i64) > 1e-3 * i64


def test_kmeans_sweep_and_optimal_k_match_jax():
    x = blobs(4, k=3)
    got, want = tc.kmeans_sweep(x, 2, 6, device="cpu"), jc.kmeans_sweep(x, 2, 6)
    assert sorted(got) == sorted(want) == [2, 3, 4, 5, 6]
    for k in want:
        assert got[k]["inertia"] == pytest.approx(want[k]["inertia"], rel=1e-5)
        assert got[k]["silhouette"] == pytest.approx(want[k]["silhouette"], abs=1e-6)
    assert tc.pick_optimal_k(got) == jc.pick_optimal_k(want) == 3
    flat = {k: {"inertia": float(100 - k ** 1.5 * 9), "silhouette": 0.5} for k in range(2, 7)}
    assert tc.pick_optimal_k(flat) == jc.pick_optimal_k(flat)
    with pytest.raises(ValueError):
        tc.pick_optimal_k({})


def test_kmeans_on_cuda_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the request is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tc.kmeans(blobs(0), 2)


NUMPY_FUNCTIONS = {
    "silhouette_score": lambda m, x, lab: m.silhouette_score(x, lab, max_samples=50, seed=3),
    "silhouette_all": lambda m, x, lab: m.silhouette_score(x, lab),
    "silhouette_one_cluster": lambda m, x, lab: m.silhouette_score(x, np.zeros_like(lab)),
    "pca_project": lambda m, x, lab: m.pca_project(x, 2),
    "tsne_project": lambda m, x, lab: m.tsne_project(x, 2, n_iter=300),
    "umap_project": lambda m, x, lab: m.umap_project(x, 2, n_epochs=120),
    "umap_tiny_input": lambda m, x, lab: m.umap_project(x[:3], 2),
    "cluster_stats": lambda m, x, lab: m.cluster_stats(
        lab, {"fraud": (x[:, 0] > 0).astype(np.float32), "top1_item": x[:, 1]}),
    "predictions_per_cluster": lambda m, x, lab: m.predictions_per_cluster(
        lab, list(range(100, 100 + len(lab)))),
    "sequence_ids_per_cluster": lambda m, x, lab: m.sequence_ids_per_cluster(
        lab, [f"u{i}" for i in range(len(lab))]),
    "cluster_description_prompt": lambda m, x, lab: m.cluster_description_prompt(
        3, [f"title {i}" for i in range(25)], {"size": 12, "fraction": 0.125}),
}


@pytest.mark.parametrize("name", sorted(NUMPY_FUNCTIONS))
def test_numpy_functions_equal_jax(name):
    """The port's copies give the JAX package's results bit for bit."""
    x = blobs(5, n=90, k=3)
    labels = jc.kmeans(x, 3)[0]
    fn = NUMPY_FUNCTIONS[name]
    got, want = fn(tc, x, labels), fn(jc, x, labels)
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def test_prediction_metadata_per_cluster():
    id2item = {0: "itemA", 1: "itemB"}
    meta = {"itemA": {"title": "A"}, "itemB": {"title": "B"}}
    per_cluster = {0: [0, 1], 1: [1]}
    got = tc.prediction_metadata_per_cluster(per_cluster, meta, id2item)
    assert got == jc.prediction_metadata_per_cluster(per_cluster, meta, id2item)
    assert got[1] == {0: ["itemA", "itemB"], 1: ["itemB"]}
    with pytest.raises(ValueError):
        tc.predictions_per_cluster(np.array([0, 1]), [1, 2, 3])


@pytest.mark.parametrize("n_items", [2, 50, 51])
def test_cluster_description_prompt_and_elision(n_items):
    """The injected completer sees the JAX package's prompts; past 50 items
    the list is cut with a note."""
    items = [{"title": f"LP {i}"} for i in range(n_items)]
    seen = {}

    def completer(system, task):
        seen.setdefault("calls", []).append((system, task))
        return "  A cluster of vinyl collectors.  "

    assert tc.get_cluster_description(items, completer=completer) == \
        "A cluster of vinyl collectors."
    jc.get_cluster_description(items, completer=completer)
    (ours, ref) = seen["calls"]
    assert ours == ref
    assert ("[Note: Showing first 50 of 51 items]" in ours[1]) == (n_items > 50)
    assert f"LP {min(n_items, 50) - 1}" in ours[1] and "LP 50" not in ours[1]


def test_cluster_description_errors(monkeypatch):
    with pytest.raises(ValueError, match="cannot be empty"):
        tc.get_cluster_description([], completer=lambda s, t: "x")
    with pytest.raises(RuntimeError, match="Failed to generate"):
        tc.get_cluster_description([{"t": 1}], completer=lambda s, t: "   ")
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    with pytest.raises(ValueError, match="OPENAI_API_KEY"):
        tc.get_cluster_description([{"t": 1}])


def test_save_cluster_plots_file_names(tmp_path, monkeypatch, capsys):
    """The JAX package's file names; without matplotlib nothing is written,
    the skip is said on stderr, and ``[]`` comes back."""
    x = blobs(6, n=40, k=2)
    labels = jc.kmeans(x, 2)[0]
    proj = tc.pca_project(x)
    sweep = {2: {"inertia": 5.0, "silhouette": 0.4}, 3: {"inertia": 3.0, "silhouette": 0.3}}
    kw = dict(sweep=sweep, optimal_k=2, overlay=(x[:, 0] > 0).astype(np.float32))
    for sub in ("t", "j", "none"):
        os.makedirs(tmp_path / sub)
    ours = tc.save_cluster_plots(str(tmp_path / "t"), proj, labels, **kw)
    ref = jc.save_cluster_plots(str(tmp_path / "j"), proj, labels, **kw)
    assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in ref] == [
        "k_sweep.png", "clusters_2d.png", "fraud_overlay_2d.png"]
    assert all(os.path.exists(p) for p in ours)

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    capsys.readouterr()
    assert tc.save_cluster_plots(str(tmp_path / "none"), proj, labels, **kw) == []
    assert "plots skipped: matplotlib not installed" in capsys.readouterr().err
    assert os.listdir(tmp_path / "none") == []
