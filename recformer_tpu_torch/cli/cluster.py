"""Clustering analytics: encode user sequences, cluster the embeddings, pick
the optimal k, export per-cluster stats (with an optional fraud overlay and
the top-1 predictions), a 2-D projection and its plots.

Counterpart of ``recformer_tpu/cli/cluster.py`` with the same flags and
outputs, plus ``--embed_ln_impl`` and ``--device`` (default ``cuda``;
without a GPU the command raises unless ``--device cpu`` is given).
``--ckpt`` is a torch state dict with HF Longformer names, loaded through
``maybe_load_pretrained``. The catalog is encoded in chunks of 256 items,
then the training histories run batch after batch through the sequence
tower, each pooled output in float32 scored against the float32 catalog;
invalid rows are dropped. k-means runs on ``--device``; the silhouette, the
projection and the plots run on the host. Outputs in ``--output_dir``:
``sequence_embeddings.npy`` and ``top1_predictions.npy`` (a cache: when
both exist, nothing is encoded), ``k_sweep.json`` (without
``--n_clusters``), ``cluster_labels.npy``, ``cluster_centers.npy``,
``<projection>_2d.npy``, ``cluster_stats.json``, the plots (skipped without
matplotlib) and, with ``--describe_clusters``, ``cluster_descriptions.json``.

    python -m recformer_tpu_torch.cli.cluster --data_path DIR [--ckpt M.pt] \\
        --output_dir OUT --device cuda
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..data.datasets import SequenceDataset
from ..data.device_pipeline import assemble_for_config
from ..models.heads import RecformerForSeqRec, similarity_scores
from ..training.loops import encode_all_items
from ..utils.clustering import (
    cluster_stats,
    get_cluster_description,
    kmeans,
    kmeans_sweep,
    pca_project,
    pick_optimal_k,
    prediction_metadata_per_cluster,
    predictions_per_cluster,
    save_cluster_plots,
    tsne_project,
    umap_project,
)
from ..utils.device import resolve_device
from ..utils.io import load_finetune_artifacts, read_json
from .common import (
    build_config,
    init_model_params,
    make_tokenizer,
    maybe_load_pretrained,
    table_to_device,
    tokenize_corpus_cached,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_path", type=str, required=True)
    p.add_argument("--ckpt", type=str, default=None,
                   help="torch .bin/.pt state dict with HF Longformer names")
    p.add_argument("--hf_tokenizer", type=str, default=None)
    p.add_argument("--model_size", choices=["base", "tiny"], default="base")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--min_clusters", type=int, default=2)
    p.add_argument("--max_clusters", type=int, default=10)
    p.add_argument("--n_clusters", type=int, default=None,
                   help="skip the sweep and use this k")
    p.add_argument("--output_dir", type=str, default="cluster_out")
    p.add_argument("--fraud_labels", type=str, default=None,
                   help="optional JSON: user -> 0/1 fraud flag overlay")
    p.add_argument("--attention_impl", choices=["dense", "chunked", "pallas"], default=None)
    p.add_argument("--hidden_act", choices=["gelu", "gelu_tanh", "relu"], default=None,
                   help="override activation: 'gelu' (exact erf) restores HF parity "
                        "for imported checkpoints; base() defaults to gelu_tanh")
    p.add_argument("--projection", choices=["pca", "tsne", "umap"], default="pca",
                   help="2-D projection for the scatter export "
                        "(reference cluster.py:144-181 offers t-SNE/PCA/UMAP)")
    p.add_argument("--describe_clusters", action="store_true",
                   help="LLM cluster descriptions via get_cluster_description "
                        "(reference cluster.py:290-394; needs OPENAI_API_KEY, "
                        "the call site is commented out in the reference too)")
    p.add_argument("--describe_model", type=str, default="gpt-4")
    p.add_argument("--embed_ln_impl", choices=["xla", "pallas"], default=None,
                   help="embedding sum + LayerNorm: plain (default) or the fused kernel")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' (default) raises without a GPU")
    return p.parse_args(argv)


def describe_clusters(labels, preds, meta, id2item, model="gpt-4", completer=None):
    """Per-cluster LLM descriptions from the predicted items' metadata —
    the reference's (commented-out) analytics tail: group predictions by
    cluster (``cluster.py:428-438``), resolve metadata (``:396-426``), prompt
    the LLM per cluster (``:290-394``). Returns {cluster: description}."""
    per_cluster = predictions_per_cluster(labels, list(preds))
    metas, _ = prediction_metadata_per_cluster(per_cluster, meta, id2item)
    return {c: get_cluster_description(items, completer=completer, model=model)
            for c, items in metas.items() if items}


@torch.inference_mode()
def extract_embeddings(model, table, dataset: SequenceDataset, config, batch_size: int,
                       item_embeddings: torch.Tensor):
    """Per-user sequence embedding (float32) and top-1 predicted item (int32)
    over ``dataset``'s rows in order, invalid rows dropped
    (``cluster.py:452-542``). Batches run back to back; results stay on the
    device until the end."""
    dev = next(model.parameters()).device
    catalog = item_embeddings.float()
    embs, preds, valid = [], [], []
    for b in dataset.batches(batch_size):
        batch = assemble_for_config(table, torch.from_numpy(b.item_ids).to(dev),
                                    torch.from_numpy(b.seq_lens).to(dev), config)
        pooled = model(batch).float()
        embs.append(pooled)
        preds.append(similarity_scores(pooled, catalog, config.temp).argmax(dim=1))
        valid.append(b.valid)
    keep = np.concatenate(valid)
    return (torch.cat(embs).cpu().numpy()[keep],
            torch.cat(preds).to(torch.int32).cpu().numpy()[keep])


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    train, val, test, meta, item2id, id2item = load_finetune_artifacts(args.data_path)
    config = build_config(args, item_num=len(item2id))
    tokenizer = make_tokenizer(config, args.hf_tokenizer)
    name = os.path.basename(os.path.normpath(args.data_path))
    table_np = tokenize_corpus_cached(
        tokenizer, meta, item2id, os.path.join(args.data_path, "preprocess"), name
    )
    table = table_to_device(table_np, device)

    model = init_model_params(RecformerForSeqRec(config), config, device)
    model = maybe_load_pretrained(model, args.ckpt)

    emb_cache = os.path.join(args.output_dir, "sequence_embeddings.npy")
    pred_cache = os.path.join(args.output_dir, "top1_predictions.npy")
    max_items = max(len(s) for s in train.values())
    ds = SequenceDataset(train, max_items=max_items)
    if os.path.exists(emb_cache) and os.path.exists(pred_cache):
        embeddings = np.load(emb_cache)
        preds = np.load(pred_cache)
        print(f"[cluster] cache hit: {emb_cache}")
    else:
        item_embeddings = encode_all_items(model, table, config)
        embeddings, preds = extract_embeddings(model, table, ds, config, args.batch_size,
                                               item_embeddings)
        np.save(emb_cache, embeddings)
        np.save(pred_cache, preds)

    sweep = None
    if args.n_clusters is None:
        sweep = kmeans_sweep(embeddings, args.min_clusters, args.max_clusters, device=device)
        k = pick_optimal_k(sweep)
        print(f"[cluster] sweep: {json.dumps(sweep)}")
        print(f"[cluster] optimal k = {k}")
        with open(os.path.join(args.output_dir, "k_sweep.json"), "w") as f:
            json.dump({"sweep": sweep, "optimal_k": k}, f, indent=2)
    else:
        k = args.n_clusters

    labels, centers, inertia = kmeans(embeddings, k, device=device)
    if args.projection == "tsne":
        proj = tsne_project(embeddings, 2)
    elif args.projection == "umap":
        proj = umap_project(embeddings, 2)
    else:
        proj = pca_project(embeddings, 2)

    extra = {"top1_item": preds.astype(np.float32)}
    if args.fraud_labels:
        fraud = read_json(args.fraud_labels, as_int=True)
        extra["fraud"] = np.asarray([float(fraud.get(u, 0)) for u in ds.users], np.float32)[
            : len(labels)
        ]
    stats = cluster_stats(labels, extra)

    np.save(os.path.join(args.output_dir, "cluster_labels.npy"), labels)
    np.save(os.path.join(args.output_dir, "cluster_centers.npy"), centers)
    np.save(os.path.join(args.output_dir, f"{args.projection}_2d.npy"), proj)
    plots = save_cluster_plots(args.output_dir, proj, labels, sweep=sweep,
                               optimal_k=k, overlay=extra.get("fraud"))
    print(f"[cluster] plots: {plots}")
    with open(os.path.join(args.output_dir, "cluster_stats.json"), "w") as f:
        json.dump({"k": int(k), "inertia": inertia, "clusters": stats}, f, indent=2)
    print(f"[cluster] k={k} inertia={inertia:.2f} stats={stats}")

    if args.describe_clusters:
        descriptions = describe_clusters(labels, preds, meta, id2item,
                                         model=args.describe_model)
        with open(os.path.join(args.output_dir, "cluster_descriptions.json"), "w") as f:
            json.dump({str(c): d for c, d in descriptions.items()}, f, indent=2)
        print(f"[cluster] descriptions: {descriptions}")
    return stats


if __name__ == "__main__":
    main()
