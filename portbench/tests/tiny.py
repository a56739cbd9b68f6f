"""Cells at a size a CPU test holds: the manifest's cells with the tiny
model (2 layers, hidden 64, window 16, 256-token histories) and corpora
cut to a few hundred items and users, run on the CPU."""

from __future__ import annotations

import copy

from portbench import manifest

TINY_MODEL = dict(vocab_size=1024, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                  intermediate_size=128, max_position_embeddings=520, attention_window=(16, 16),
                  max_token_num=256, max_item_embeddings=11, max_attr_num=3, max_attr_length=8,
                  item_seq_len=32, mask_token_id=1023)
TINY_CORPUS = dict(n_items=150, n_users=300, n_categories=8, n_brands=16)


def tiny_traffic(traffic: dict) -> dict:
    t = copy.deepcopy(traffic)
    for c in [t.get("corpus")] + list(t.get("catalogs", {}).values()):
        if c is None:
            continue
        if c["kind"] == "seqrec":
            c.update({k: v for k, v in TINY_CORPUS.items() if k in c and c[k]})
        else:
            c.update(n_cards=60, test_cards=20, n_merchants=12)
    for k, v in dict(batch_size=4, check_requests=2, check_items=64, chunk=32,
                     grad_accum_steps=2, total_steps=100).items():
        if k in t:
            t[k] = v
    return t


def tiny_cell(workload: str, seed: int = 1234, limits=None) -> manifest.Cell:
    bench = manifest.load_manifest()
    cell = manifest.find_cell(bench, workload, seed, "cpu")
    cell.config = cell.config.replace(**TINY_MODEL)
    cell.traffic = tiny_traffic(cell.traffic)
    if limits is not None:
        cell.limits = limits
    return cell
