"""Credit-card transaction pipeline: raw CSV -> Recformer artifacts.

The port's own copy of ``recformer_tpu/pipelines/transactional.py``: the
same seed and CSVs give the same JSON artifacts. Offline host tooling with
the behavior of the reference's ``transactional_data_process/``, but
dependency-light (stdlib csv + numpy, no pandas/sklearn):

- amount binning into 1000 [left, right) bins over [0, 10000] with a final
  open-ended bin (``load_data.py:18-56``);
- transaction signature = ``amtbin_merchant_year_month_day_dow``
  (``load_data.py:211-213``);
- a global label encoding over train+test signatures (sorted-unique order,
  matching sklearn's LabelEncoder) mapped to ``TRANSACTION_{id}``
  (``load_data.py:233-234``);
- per-transaction-type metadata {amount, merchant, year, month, day, weekday}
  from the first occurrence (``meta_data_process.py:12-37``);
- four interaction variants (``transactional_data_process/*/``):
  * pretrain: per-card time-sorted sequences, 85/15 list split;
  * finetune: leave-one-out (last = test, second-to-last = val);
  * classification: per-card sequence + any-fraud flag, 80/10/10 card split;
  * classification_single: one row per transaction (history prefix up to and
    including it) labeled with that transaction's fraud flag.
"""

from __future__ import annotations

import csv
import datetime as dt
import os
import random
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..utils.io import write_json


# ---------------------------------------------------------------------------
# Binning + signatures
# ---------------------------------------------------------------------------

def make_amount_bins(number_bins: int = 1000, min_amt: int = 0, max_amt: int = 10000):
    """Returns (edges, labels): unique rounded integer edges + open tail."""
    edges = np.linspace(min_amt, max_amt, number_bins + 1)
    edges = np.unique(np.round(edges).astype(int)).astype(float)
    edges = np.append(edges, np.inf)
    labels = []
    for i in range(1, len(edges)):
        left = int(edges[i - 1])
        labels.append(f"{left}-inf" if np.isinf(edges[i]) else f"{left}-{int(edges[i])}")
    return edges, labels


def amount_bin_label(amt: float, edges: np.ndarray, labels: List[str]) -> str:
    """[left, right) binning of |amt| (``pd.cut(..., right=False)``)."""
    idx = int(np.searchsorted(edges, abs(amt), side="right")) - 1
    idx = min(max(idx, 0), len(labels) - 1)
    return labels[idx]


def parse_row(row: Dict[str, str], edges, labels) -> Optional[Dict[str, str]]:
    """One CSV row -> signature fields; None if required fields missing."""
    ts_raw = row.get("trans_date_trans_time")
    amt_raw = row.get("amt")
    merchant = row.get("merchant")
    if not ts_raw or not amt_raw or not merchant:
        return None
    try:
        ts = dt.datetime.fromisoformat(ts_raw)
        amt = float(amt_raw)
    except ValueError:
        return None
    fields = {
        "amt_bin": amount_bin_label(amt, edges, labels),
        "merchant": merchant,
        "year": str(ts.year),
        "month": str(ts.month),
        "day": str(ts.day),
        "day_of_week": str(ts.weekday()),  # Monday=0, matches pandas dayofweek
        "hour": str(ts.hour),
        "cc_num": row.get("cc_num", ""),
        "is_fraud": row.get("is_fraud", "0"),
        "timestamp": ts.isoformat(),
    }
    fields["transaction_signature"] = "_".join(
        fields[k] for k in ("amt_bin", "merchant", "year", "month", "day", "day_of_week")
    )
    return fields


def read_transactions(paths: Iterable[str], edges, labels) -> List[Dict[str, str]]:
    rows = []
    for path in paths:
        with open(path, newline="", encoding="utf-8") as f:
            for row in csv.DictReader(f):
                parsed = parse_row(row, edges, labels)
                if parsed is not None:
                    rows.append(parsed)
    return rows


def fit_signature_encoder(rows: List[Dict[str, str]]) -> Dict[str, str]:
    """signature -> TRANSACTION_{id}; ids follow sorted-unique order (sklearn
    LabelEncoder semantics)."""
    uniq = sorted({r["transaction_signature"] for r in rows})
    return {sig: f"TRANSACTION_{i}" for i, sig in enumerate(uniq)}


def extract_metadata(rows: List[Dict[str, str]], encoder: Dict[str, str],
                     number_items: Optional[int] = 20000) -> Dict[str, Dict[str, str]]:
    """First-occurrence attributes per transaction type
    (``meta_data_process.py:28-37``)."""
    meta: Dict[str, Dict[str, str]] = {}
    for r in rows:
        tid = encoder[r["transaction_signature"]]
        if tid not in meta:
            meta[tid] = {
                "amount": r["amt_bin"],
                "merchant": r["merchant"],
                "year": r["year"],
                "month": r["month"],
                "day": r["day"],
                "weekday": r["day_of_week"],
            }
    if number_items:
        meta = dict(list(meta.items())[:number_items])
    return meta


def extract_card_sequences(rows: List[Dict[str, str]], encoder: Dict[str, str],
                           meta: Dict[str, Dict]) -> Dict[str, Tuple[List[str], int]]:
    """card -> (time-sorted transaction-type ids, any-fraud flag); cards with
    fewer than 2 valid transactions dropped
    (``classification_data/interaction_data_process.py:26-55``)."""
    per_card: Dict[str, List[Tuple[str, str, int]]] = defaultdict(list)
    for r in rows:
        tid = encoder[r["transaction_signature"]]
        if tid in meta:
            per_card[r["cc_num"]].append(
                (r["timestamp"], tid, int(float(r["is_fraud"] or 0)))
            )
    out = {}
    for card, items in per_card.items():
        items.sort()
        if len(items) > 1:
            out[card] = ([t for _, t, _ in items], int(any(f for _, _, f in items)))
    return out


# ---------------------------------------------------------------------------
# Variant builders
# ---------------------------------------------------------------------------

def _encode_items(seq: List[str], smap: Dict[str, int]) -> List[int]:
    return [smap[t] for t in seq if t in smap]


def build_all(
    train_csvs: List[str],
    test_csvs: List[str],
    out_root: str,
    number_items: Optional[int] = 20000,
    seed: int = 42,
) -> None:
    edges, labels = make_amount_bins()
    train_rows = read_transactions(train_csvs, edges, labels)
    test_rows = read_transactions(test_csvs, edges, labels) if test_csvs else []
    all_rows = train_rows + test_rows
    encoder = fit_signature_encoder(all_rows)
    meta = extract_metadata(all_rows, encoder, number_items)
    smap = {tid: i for i, tid in enumerate(meta)}
    print(f"[txn] {len(all_rows)} transactions, {len(encoder)} signatures, "
          f"{len(meta)} kept transaction types")

    os.makedirs(out_root, exist_ok=True)
    write_json(meta, os.path.join(out_root, "meta_data.json"))
    write_json(smap, os.path.join(out_root, "smap.json"))
    write_json({label: tid for label, tid in
                zip(labels, (f"amt_bin_{i}" for i in range(len(labels))))},
               os.path.join(out_root, "amt_bins.json"))

    train_cards = extract_card_sequences(train_rows, encoder, meta)
    test_cards = extract_card_sequences(test_rows, encoder, meta) if test_rows else {}
    rng = random.Random(seed)

    # ---- pretrain: 85/15 split of per-card sequences --------------------
    seqs = [_encode_items(s, smap) for s, _ in train_cards.values()]
    seqs = [s for s in seqs if len(s) > 1]
    rng.shuffle(seqs)
    cut = int(len(seqs) * 0.85)
    pre_dir = os.path.join(out_root, "pretrain_data")
    write_json(seqs[:cut], os.path.join(pre_dir, "train.json"))
    write_json(seqs[cut:], os.path.join(pre_dir, "dev.json"))
    write_json(meta, os.path.join(pre_dir, "meta_data.json"))
    write_json(smap, os.path.join(pre_dir, "smap.json"))

    # ---- finetune: leave-one-out ---------------------------------------
    ft_dir = os.path.join(out_root, "finetune_data")
    tr, va, te = {}, {}, {}
    for i, (card, (seq, _)) in enumerate(sorted(train_cards.items())):
        ids = _encode_items(seq, smap)
        if len(ids) < 3:
            if ids:
                tr[i] = ids
        else:
            tr[i] = ids[:-2]
            va[i] = [ids[-2]]
            te[i] = [ids[-1]]
    write_json(tr, os.path.join(ft_dir, "train.json"))
    write_json(va, os.path.join(ft_dir, "val.json"))
    write_json(te, os.path.join(ft_dir, "test.json"))
    write_json(meta, os.path.join(ft_dir, "meta_data.json"))
    write_json(smap, os.path.join(ft_dir, "smap.json"))

    # ---- classification: per-card fraud flag, 80/10/10 ------------------
    cls_dir = os.path.join(out_root, "classification_data")
    cards = sorted(train_cards)
    rng.shuffle(cards)
    n = len(cards)
    splits = {
        "train": cards[: int(n * 0.8)],
        "val": cards[int(n * 0.8): int(n * 0.9)],
        "test": cards[int(n * 0.9):],
    }
    for split, members in splits.items():
        data = {}
        for i, card in enumerate(members):
            seq, flag = train_cards[card]
            ids = _encode_items(seq, smap)
            if len(ids) > 1:
                data[i] = [ids, [flag]]
        write_json(data, os.path.join(cls_dir, f"{split}.json"))
    write_json(meta, os.path.join(cls_dir, "meta_data.json"))
    write_json(smap, os.path.join(cls_dir, "smap.json"))

    # ---- classification_single: per-transaction rows --------------------
    single_dir = os.path.join(out_root, "classification_data_single")
    per_card_rows: Dict[str, List[Tuple[str, str, int]]] = defaultdict(list)
    for r in train_rows:
        tid = encoder[r["transaction_signature"]]
        if tid in meta:
            per_card_rows[r["cc_num"]].append(
                (r["timestamp"], tid, int(float(r["is_fraud"] or 0)))
            )
    singles = []
    for card, items in per_card_rows.items():
        items.sort()
        ids = [smap[t] for _, t, _ in items]
        flags = [f for _, _, f in items]
        for i in range(1, len(ids)):
            singles.append([ids[: i + 1], [flags[i]]])
    rng.shuffle(singles)
    n = len(singles)
    for split, lo, hi in (("train", 0, 0.8), ("val", 0.8, 0.9), ("test", 0.9, 1.0)):
        chunk = {i: row for i, row in enumerate(singles[int(n * lo): int(n * hi)])}
        write_json(chunk, os.path.join(single_dir, f"{split}.json"))
    write_json(meta, os.path.join(single_dir, "meta_data.json"))
    write_json(smap, os.path.join(single_dir, "smap.json"))
    print(f"[txn] wrote pretrain/finetune/classification/classification_single -> {out_root}")
