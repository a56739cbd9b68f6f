"""Embedding clustering analytics: k-means on the device, silhouette,
elbow-based k selection, PCA / t-SNE / UMAP projections, per-cluster stats
and the cluster-description helpers.

The port's counterpart of ``recformer_tpu/utils/clustering.py``, with the
same split between device and host. On the device (what JAX ran under
``jit``): the Lloyd step, in torch on the embeddings' device, float32 with
TF32 off, on data shifted by its mean (:func:`lloyd` says why). On the host in numpy (what JAX ran in numpy, copied here): the
k-means++ initialisation from ``np.random.default_rng(seed)``, the
tolerance loop, the silhouette on a subsample, the projections and the
helpers. No sklearn or umap dependency; matplotlib is optional (the plots
are skipped without it).
"""

from __future__ import annotations

import contextlib
import os
import sys
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .device import resolve_device


@contextlib.contextmanager
def _full_fp32_matmul():
    """TF32 off for the duration: the squared distances take the same
    expansion as the JAX step, in full float32."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _lloyd_step(x: torch.Tensor, centers: torch.Tensor):
    """One assign + update step on ``x``'s device and dtype. ``x``: (N, D),
    ``centers``: (k, D). Returns (assign (N,), new centers, inertia): the
    first centre of least squared distance (``argmin`` takes the first on
    ties, as ``jnp.argmin``), the members' mean by a one-hot product, an
    empty cluster keeping its old centre, and the clipped distances'
    sum."""
    k = centers.shape[0]
    d2 = ((x * x).sum(1, keepdim=True) - 2.0 * x @ centers.T
          + (centers * centers).sum(1)[None, :])  # (N, k)
    assign = torch.argmin(d2, dim=1)
    one_hot = F.one_hot(assign, k).to(x.dtype)  # (N, k)
    counts = one_hot.sum(0)[:, None]  # (k, 1)
    sums = one_hot.T @ x  # (k, D)
    new_centers = torch.where(counts > 0, sums / counts.clamp_min(1), centers)
    inertia = d2.min(dim=1).values.clamp_min(0).sum()
    return assign, new_centers, inertia


def lloyd(x: torch.Tensor, centers: torch.Tensor, max_iters: int = 100,
          tol: float = 1e-4) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """Lloyd iterations from ``centers`` on ``x``'s device and dtype, until
    the inertia falls by less than ``tol`` of itself (at most
    ``max_iters``). Returns (assign (N,), centers (k, D), inertia) with the
    tensors on the device.

    ``x`` and the centres are shifted by ``x``'s mean first (the centres
    come back in ``x``'s frame). Distances do not change, but the
    expansion ``|x|^2 - 2 x.c + |c|^2`` then cancels far less: on tight
    clusters far from the origin (``tests/test_torch_clustering.py``), the
    JAX step's unshifted float32 expansion puts the inertia more than 1e-3
    off its float64 value, the shifted loop within 1e-5."""
    mean = x.mean(dim=0)
    x, centers = x - mean, centers - mean
    prev_inertia = np.inf
    assign, inertia = None, np.inf
    with torch.inference_mode(), _full_fp32_matmul():
        for _ in range(max_iters):
            assign, centers, inertia = _lloyd_step(x, centers)
            inertia = float(inertia)
            if prev_inertia - inertia < tol * max(abs(prev_inertia), 1.0):
                break
            prev_inertia = inertia
    return assign, centers + mean, inertia


def _kmeans_pp_init(x: np.ndarray, k: int, rng: np.random.Generator) -> np.ndarray:
    n = x.shape[0]
    centers = [x[rng.integers(n)]]
    d2 = np.full(n, np.inf)
    for _ in range(k - 1):
        d2 = np.minimum(d2, ((x - centers[-1]) ** 2).sum(1))
        probs = d2 / max(d2.sum(), 1e-12)
        centers.append(x[rng.choice(n, p=probs)])
    return np.stack(centers)


def kmeans(
    embeddings: np.ndarray, k: int, max_iters: int = 100, tol: float = 1e-4,
    seed: int = 42, device="cuda",
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Returns (labels (N,) int32, centers (k, D) float32, inertia): the
    k-means++ initialisation on the host, then :func:`lloyd` on ``device``
    in float32."""
    dev = resolve_device(device)
    x_np = np.ascontiguousarray(embeddings, np.float32)
    init = _kmeans_pp_init(x_np, k, np.random.default_rng(seed))
    assign, centers, inertia = lloyd(torch.from_numpy(x_np).to(dev),
                                     torch.from_numpy(init).to(dev), max_iters, tol)
    return (assign.cpu().numpy().astype(np.int32), centers.cpu().numpy(), float(inertia))


def silhouette_score(embeddings: np.ndarray, labels: np.ndarray,
                     max_samples: int = 2000, seed: int = 0) -> float:
    """Mean silhouette coefficient, exact on a subsample."""
    n = embeddings.shape[0]
    if len(np.unique(labels)) < 2:
        return 0.0
    rng = np.random.default_rng(seed)
    idx = rng.choice(n, size=min(n, max_samples), replace=False)
    x = embeddings[idx].astype(np.float32)
    y = labels[idx]
    # pairwise distances sample -> all points
    d = np.sqrt(np.maximum(
        (x * x).sum(1)[:, None] - 2 * x @ embeddings.T.astype(np.float32)
        + (embeddings.astype(np.float32) ** 2).sum(1)[None, :], 0))
    scores = []
    uniq = np.unique(labels)
    for i in range(len(idx)):
        own = labels == y[i]
        own_count = own.sum() - 1
        if own_count <= 0:
            scores.append(0.0)
            continue
        a = (d[i][own].sum() - 0.0) / own_count
        b = min(d[i][labels == c].mean() for c in uniq if c != y[i])
        scores.append((b - a) / max(a, b, 1e-12))
    return float(np.mean(scores))


def kmeans_sweep(embeddings: np.ndarray, k_min: int = 2, k_max: int = 10,
                 seed: int = 42, device="cuda") -> Dict[int, Dict[str, float]]:
    """Inertia + silhouette for k in [k_min, k_max]
    (``cluster.py:84-106``); k-means on ``device``."""
    out = {}
    for k in range(k_min, min(k_max, embeddings.shape[0] - 1) + 1):
        labels, centers, inertia = kmeans(embeddings, k, seed=seed, device=device)
        out[k] = {
            "inertia": inertia,
            "silhouette": silhouette_score(embeddings, labels, seed=seed),
        }
    return out


def pick_optimal_k(sweep: Dict[int, Dict[str, float]]) -> int:
    """Combine the elbow criterion (max second difference of inertia) with the
    max-silhouette pick (``cluster.py:108-142``): prefer the silhouette
    winner, fall back to the elbow when silhouettes are flat."""
    ks = sorted(sweep)
    if not ks:
        raise ValueError("empty sweep")
    sil = {k: sweep[k]["silhouette"] for k in ks}
    best_sil = max(ks, key=lambda k: sil[k])
    if max(sil.values()) - min(sil.values()) > 1e-3:
        return best_sil
    if len(ks) >= 3:
        inertias = np.array([sweep[k]["inertia"] for k in ks])
        second_diff = inertias[:-2] - 2 * inertias[1:-1] + inertias[2:]
        return ks[int(np.argmax(second_diff)) + 1]
    return best_sil


def pca_project(embeddings: np.ndarray, dims: int = 2) -> np.ndarray:
    x = embeddings.astype(np.float64)
    x = x - x.mean(0)
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    return (x @ vt[:dims].T).astype(np.float32)


def tsne_project(embeddings: np.ndarray, dims: int = 2, perplexity: float = 30.0,
                 n_iter: int = 500, learning_rate: Optional[float] = None,
                 seed: int = 0) -> np.ndarray:
    """Exact (O(N^2)) t-SNE, the reference's second 2-D projection option
    (``cluster.py:144-181`` uses sklearn TSNE). Standard formulation:
    per-point Gaussian bandwidths binary-searched to the target perplexity,
    symmetrized affinities, early exaggeration, momentum gradient descent on
    the Student-t low-dim similarities. Intended for the analytics regime
    (<= a few thousand points); PCA-initialized for determinism."""
    x = embeddings.astype(np.float64)
    n = x.shape[0]
    if n <= dims + 1:
        return pca_project(embeddings, dims)
    perplexity = min(perplexity, (n - 1) / 3.0)
    d2 = np.maximum((x * x).sum(1)[:, None] - 2 * x @ x.T + (x * x).sum(1)[None, :], 0)
    np.fill_diagonal(d2, np.inf)

    # binary-search per-point precision beta to hit log(perplexity) entropy
    target = np.log(perplexity)
    p = np.zeros((n, n))
    for i in range(n):
        beta, lo, hi = 1.0, 0.0, np.inf
        row = d2[i]
        fin = np.isfinite(row)
        for _ in range(50):
            e = np.where(fin, np.exp(-row * beta), 0.0)
            s = max(e.sum(), 1e-12)
            h = np.log(s) + beta * float((row[fin] * e[fin]).sum()) / s
            if abs(h - target) < 1e-5:
                break
            if h > target:
                lo = beta
                beta = beta * 2 if hi == np.inf else (beta + hi) / 2
            else:
                hi = beta
                beta = (beta + lo) / 2
        p[i] = e / s
    p = (p + p.T) / (2.0 * n)
    p = np.maximum(p, 1e-12)

    exaggeration = 12.0
    if learning_rate is None:
        # sklearn's 'auto' rule: n / exaggeration / 4, floored at 50
        learning_rate = max(n / exaggeration / 4.0, 50.0)
    y = pca_project(embeddings, dims).astype(np.float64)
    y = y / max(np.std(y), 1e-12) * 1e-4  # standard small-variance init
    y += np.random.default_rng(seed).normal(0, 1e-6, y.shape)
    vel = np.zeros_like(y)
    exag_iters = min(250, n_iter // 2)
    for it in range(n_iter):
        pe = p * exaggeration if it < exag_iters else p
        momentum = 0.5 if it < exag_iters else 0.8
        yd2 = np.maximum((y * y).sum(1)[:, None] - 2 * y @ y.T + (y * y).sum(1)[None, :], 0)
        num = 1.0 / (1.0 + yd2)
        np.fill_diagonal(num, 0.0)
        q = np.maximum(num / max(num.sum(), 1e-12), 1e-12)
        w = (pe - q) * num  # (N, N)
        grad = 4.0 * ((np.diag(w.sum(1)) - w) @ y)
        vel = momentum * vel - learning_rate * grad
        y = y + vel
        y = y - y.mean(0)
    return y.astype(np.float32)


def umap_project(embeddings: np.ndarray, dims: int = 2, n_neighbors: int = 15,
                 min_dist: float = 0.1, n_epochs: int = 300,
                 seed: int = 0) -> np.ndarray:
    """Dependency-free UMAP: the reference's third 2-D projection option
    (``reference/cluster.py:144-181`` uses ``umap-learn``). Standard
    formulation (McInnes et al. 2018): exact kNN graph, per-point bandwidths
    binary-searched so the smoothed neighbor cardinality is ``log2(k)``,
    fuzzy-union symmetrization, then SGD on the fuzzy cross-entropy with the
    ``1/(1 + a d^{2b})`` low-dim kernel — edges sampled by membership
    strength, ``m`` uniform negatives per positive, linearly decaying step.
    PCA-initialized and fully seeded for determinism. Exact-kNN is O(N^2)
    like :func:`tsne_project` — the analytics regime (<= a few thousand
    points) this module targets."""
    x = embeddings.astype(np.float32)
    n = x.shape[0]
    if n <= dims + 1:
        return pca_project(embeddings, dims)
    rng = np.random.default_rng(seed)
    k = int(min(n_neighbors, n - 1))

    d2 = np.maximum((x * x).sum(1)[:, None] - 2 * x @ x.T + (x * x).sum(1)[None, :], 0)
    np.fill_diagonal(d2, np.inf)
    nbr = np.argpartition(d2, k - 1, axis=1)[:, :k]  # (N, k) neighbor ids
    nd = np.sqrt(np.take_along_axis(d2, nbr, axis=1))  # neighbor distances

    # smooth-kNN calibration: rho = nearest distance; sigma s.t.
    # sum_j exp(-(d_ij - rho)/sigma) = log2(k)
    rho = nd.min(axis=1)
    target = np.log2(k)
    sigma = np.ones(n, np.float64)
    for i in range(n):
        lo, hi, s = 0.0, np.inf, 1.0
        gap = np.maximum(nd[i] - rho[i], 0.0)
        for _ in range(64):
            val = float(np.exp(-gap / max(s, 1e-12)).sum())
            if abs(val - target) < 1e-5:
                break
            if val > target:
                hi = s
                s = (s + lo) / 2
            else:
                lo = s
                s = s * 2 if hi == np.inf else (s + hi) / 2
        sigma[i] = max(s, 1e-12)
    w = np.exp(-np.maximum(nd - rho[:, None], 0.0) / sigma[:, None])  # (N, k)

    # fuzzy union P = P + P^T - P o P^T on the sparse kNN edges
    heads = np.repeat(np.arange(n), k)
    tails = nbr.ravel()
    dense = np.zeros((n, n), np.float32)
    dense[heads, tails] = w.ravel().astype(np.float32)
    sym = dense + dense.T - dense * dense.T
    ei, ej = np.nonzero(np.triu(sym, 1))
    ew = sym[ei, ej]
    keep = ew > ew.max() / float(n_epochs)  # umap's negligible-edge cutoff
    ei, ej, ew = ei[keep], ej[keep], ew[keep]
    p_edge = (ew / ew.max()).astype(np.float64)  # per-epoch sampling prob

    # curve constants fitted to (min_dist=0.1, spread=1.0), the umap-learn
    # defaults (find_ab_params output)
    a, b = 1.576943, 0.895061
    m_neg = 5

    y = pca_project(embeddings, dims).astype(np.float64)
    y = 10.0 * y / max(np.abs(y).max(), 1e-12)  # umap-scale init box

    for epoch in range(n_epochs):
        alpha = 1.0 - epoch / float(n_epochs)
        mask = rng.random(len(ei)) < p_edge
        ii, jj = ei[mask], ej[mask]
        if len(ii) == 0:
            continue
        diff = y[ii] - y[jj]
        dist2 = (diff * diff).sum(1)
        # attractive gradient of the CE wrt d^2, standard umap form
        g_att = (-2.0 * a * b * dist2 ** (b - 1.0)) / (a * dist2 ** b + 1.0)
        g_att = np.where(dist2 > 0, g_att, 0.0)
        upd = np.clip(g_att[:, None] * diff, -4.0, 4.0) * alpha
        np.add.at(y, ii, upd)
        np.add.at(y, jj, -upd)
        for _ in range(m_neg):
            kk = rng.integers(0, n, size=len(ii))
            diff = y[ii] - y[kk]
            dist2 = (diff * diff).sum(1)
            g_rep = (2.0 * b) / ((0.001 + dist2) * (a * dist2 ** b + 1.0))
            g_rep = np.where(kk == ii, 0.0, g_rep)
            upd = np.clip(g_rep[:, None] * diff, -4.0, 4.0) * alpha
            np.add.at(y, ii, upd)
    return (y - y.mean(0)).astype(np.float32)


def predictions_per_cluster(labels: np.ndarray, prediction_ids) -> Dict[int, list]:
    """Group per-user predicted item ids by cluster label
    (``cluster.py:428-438`` ``get_predictions_per_cluster``)."""
    labels = np.asarray(labels)
    if len(labels) != len(prediction_ids):
        raise ValueError(
            f"labels ({len(labels)}) and prediction_ids ({len(prediction_ids)}) "
            "must align")
    return {int(c): [p for p, l in zip(prediction_ids, labels) if l == c]
            for c in np.unique(labels)}


def sequence_ids_per_cluster(labels: np.ndarray, sequence_ids) -> Dict[int, list]:
    """Group user/sequence ids by cluster label
    (``cluster.py:440-451`` ``get_sequence_ids_per_cluster_label``)."""
    return predictions_per_cluster(labels, sequence_ids)


def prediction_metadata_per_cluster(
    preds_per_cluster: Dict[int, list],
    item_meta: Dict,
    id2item: Dict,
) -> tuple:
    """Resolve predicted item ids to (metadata, item-name) lists per cluster
    (``cluster.py:396-426`` ``get_prediction_metadata_per_cluster``)."""
    meta_per_cluster, names_per_cluster = {}, {}
    for cluster, pred_ids in preds_per_cluster.items():
        names = [id2item[i] for i in pred_ids]
        meta_per_cluster[cluster] = [item_meta[n] for n in names]
        names_per_cluster[cluster] = names
    return meta_per_cluster, names_per_cluster


def get_cluster_description(
    items_in_cluster: list,
    completer=None,
    model: str = "gpt-4",
    temperature: float = 0.7,
    max_tokens: int = 200,
    timeout: int = 30,
) -> str:
    """LLM-generated natural-language cluster description
    (``cluster.py:290-394`` ``get_cluster_description``; the reference's call
    site is commented out there, the helper is part of its public analytics
    surface).

    ``completer`` is a pluggable ``fn(system_prompt, user_prompt) -> str``.
    When ``None``, an OpenAI chat-completions client is constructed exactly
    like the reference (requires the optional ``openai`` package and the
    ``OPENAI_API_KEY`` env var — both absent in air-gapped environments, in
    which case a clear ``ValueError``/``ImportError`` is raised instead of a
    network hang). Items beyond the first 50 are elided with a note, matching
    the reference's token-limit guard."""
    if not items_in_cluster:
        raise ValueError("Items list cannot be empty")

    max_items = 50
    display = items_in_cluster[:max_items]
    note = (f"\n\n[Note: Showing first {max_items} of "
            f"{len(items_in_cluster)} items]"
            if len(items_in_cluster) > max_items else "")
    system = ("You are an expert data analyst specializing in user behavior "
              "clustering and persona generation.")
    task = (
        "You are an expert in analyzing item clusters and generating "
        "descriptive summaries.\n\n"
        "You are given a list of items from users in the same cluster. Each "
        "item is described by a set of characteristics, such as item name, "
        "category, and other attributes.\n\nYour task is to:\n"
        "1. Analyze the common patterns across all items\n"
        "2. Identify shared characteristics and themes among the items\n"
        "3. Generate a concise cluster description (2-3 sentences) that "
        "captures the essence of the grouped items\n"
        "4. Focus on what makes this cluster unique and distinguishable from "
        "other item groups\n\n"
        f"Items in Cluster:\n{display}{note}\n\n"
        "Please provide only the cluster description without additional "
        "explanation."
    )

    if completer is None:
        api_key = os.getenv("OPENAI_API_KEY")
        if not api_key:
            raise ValueError("OPENAI_API_KEY environment variable is required")
        import openai  # optional dependency, like the reference

        kwargs = {"api_key": api_key}
        if os.getenv("OPENAI_BASE_URL"):
            kwargs["base_url"] = os.getenv("OPENAI_BASE_URL")
        client = openai.OpenAI(**kwargs)

        def completer(sys_msg, user_msg):
            resp = client.chat.completions.create(
                model=model,
                messages=[{"role": "system", "content": sys_msg},
                          {"role": "user", "content": user_msg}],
                temperature=temperature, max_tokens=max_tokens, top_p=0.9,
                timeout=timeout)
            if not resp.choices or not resp.choices[0].message.content:
                raise RuntimeError("No valid response generated from API")
            return resp.choices[0].message.content

    description = completer(system, task)
    if not description or not str(description).strip():
        raise RuntimeError("Failed to generate cluster description")
    return str(description).strip()


def cluster_description_prompt(cluster_id: int, item_titles: list, stats: Dict) -> str:
    """Build the natural-language cluster-description prompt (the reference
    optionally sends this to GPT-4, ``cluster.py:290-394`` — the call site is
    commented out there; here the prompt is built and any LLM call
    is left to the caller)."""
    sample = "\n".join(f"- {t}" for t in item_titles[:20])
    return (
        f"You are analyzing clusters of users from a sequential recommendation "
        f"model.\nCluster {cluster_id} contains {stats.get('size', '?')} users "
        f"({100 * stats.get('fraction', 0):.1f}% of the population).\n"
        f"Representative items interacted with by this cluster:\n{sample}\n\n"
        f"Describe in 2-3 sentences what characterizes this user cluster."
    )


def save_cluster_plots(output_dir: str, proj: np.ndarray, labels: np.ndarray,
                       sweep: Optional[Dict[int, Dict[str, float]]] = None,
                       optimal_k: Optional[int] = None,
                       overlay: Optional[np.ndarray] = None,
                       overlay_name: str = "fraud") -> list:
    """Export the reference's analytics figures (``cluster.py:108-181``):
    elbow+silhouette curves from the k sweep, a 2-D scatter colored by cluster,
    and (optionally) the same scatter colored by an overlay signal such as
    fraud labels (``cluster.py:766-774``). Headless (Agg); returns the written
    paths. Without matplotlib (an optional dependency of the port) it writes
    nothing, says so on stderr and returns ``[]``."""
    try:
        import matplotlib
    except ImportError:
        print("plots skipped: matplotlib not installed", file=sys.stderr)
        return []

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    written = []
    if sweep:
        ks = sorted(sweep)
        fig, ax1 = plt.subplots(figsize=(7, 4))
        ax1.plot(ks, [sweep[k]["inertia"] for k in ks], "o-", color="tab:blue",
                 label="inertia")
        ax1.set_xlabel("k")
        ax1.set_ylabel("inertia", color="tab:blue")
        ax2 = ax1.twinx()
        ax2.plot(ks, [sweep[k]["silhouette"] for k in ks], "s--",
                 color="tab:orange", label="silhouette")
        ax2.set_ylabel("silhouette", color="tab:orange")
        if optimal_k is not None:
            ax1.axvline(optimal_k, color="gray", ls=":", label=f"optimal k={optimal_k}")
        ax1.set_title("KMeans sweep: elbow + silhouette")
        fig.tight_layout()
        path = os.path.join(output_dir, "k_sweep.png")
        fig.savefig(path, dpi=120)
        plt.close(fig)
        written.append(path)

    fig, ax = plt.subplots(figsize=(6, 5))
    sc = ax.scatter(proj[:, 0], proj[:, 1], c=labels, cmap="tab10", s=12)
    ax.set_title(f"user-sequence embeddings ({len(np.unique(labels))} clusters)")
    fig.colorbar(sc, ax=ax, label="cluster")
    fig.tight_layout()
    path = os.path.join(output_dir, "clusters_2d.png")
    fig.savefig(path, dpi=120)
    plt.close(fig)
    written.append(path)

    if overlay is not None:
        fig, ax = plt.subplots(figsize=(6, 5))
        sc = ax.scatter(proj[:, 0], proj[:, 1], c=overlay, cmap="coolwarm", s=12)
        ax.set_title(f"{overlay_name} overlay")
        fig.colorbar(sc, ax=ax, label=overlay_name)
        fig.tight_layout()
        path = os.path.join(output_dir, f"{overlay_name}_overlay_2d.png")
        fig.savefig(path, dpi=120)
        plt.close(fig)
        written.append(path)
    return written


def cluster_stats(labels: np.ndarray, extra: Optional[Dict[str, np.ndarray]] = None) -> Dict:
    """Per-cluster sizes plus means of any extra per-point arrays (e.g. a
    fraud-label overlay — ``cluster.py:609-635``)."""
    out = {}
    for c in np.unique(labels):
        member = labels == c
        stats = {"size": int(member.sum()), "fraction": float(member.mean())}
        if extra:
            for name, arr in extra.items():
                stats[f"mean_{name}"] = float(np.asarray(arr)[member].mean())
        out[int(c)] = stats
    return out
