"""Synthetic credit-card transaction stream — the offline stand-in for the
fraud track's data (the reference's ``finetune_classification.py`` trains on
the Kaggle credit-card CSVs fetched by
``transactional_data_process/load_data.py:18-56``). The port's own copy of
``recformer_tpu/pipelines/synthetic_transactions.py``: the same seed gives
the same CSVs, byte for byte.

    python -m recformer_tpu_torch.pipelines.synthetic_transactions \
        --out DIR --scale small --build

Emits raw CSVs in the exact schema ``pipelines.transactional.parse_row``
consumes (``trans_date_trans_time, amt, merchant, cc_num, is_fraud``), with a
*planted, text-learnable* fraud signal: a fraction of cards receive a short
burst of fraudulent transactions drawn from a distinct joint regime — high
amounts (top amount bins) at a small pool of fraud-prone merchants at night.
Because the downstream model sees each transaction type only through its
attribute text ({amount-bin, merchant, date parts} —
``transactional/meta_data_process.py:12-37`` semantics), the per-card fraud
flag is predictable from text alone, which is exactly the capability the
reference's fraud head measures. Legitimate traffic also touches the
fraud-prone merchants (at normal amounts), so merchant identity alone is NOT
separating — the signal lives in the (merchant, amount, hour) interaction.

Most transaction signatures occur once (amt-bin × merchant × date), matching
the real data's regime: generalization must come from attribute text, not
memorized item ids.
"""

from __future__ import annotations

import csv
import datetime as dt
import os

import numpy as np

_SYLLA = ["mar", "ket", "ven", "dor", "plo", "sha", "gri", "tob", "lun",
          "fex", "cor", "dan", "rilo", "pas", "quo", "zen", "bik", "hom"]


def _merchant_name(i: int) -> str:
    parts, k = [], int(i)
    for _ in range(2):
        parts.append(_SYLLA[k % len(_SYLLA)])
        k //= len(_SYLLA)
    return "shop_" + "".join(parts) + str(i)


def generate_stream(out_dir: str, n_cards: int = 3000, test_cards: int = 800,
                    n_merchants: int = 100, fraud_card_rate: float = 0.08,
                    seed: int = 11):
    """Write ``txn_train_raw.csv`` / ``txn_test_raw.csv`` under ``out_dir``.

    Returns summary stats (cards, transactions, fraud rates)."""
    rng = np.random.default_rng(seed)
    merchants = [_merchant_name(i) for i in range(n_merchants)]
    # fraud-prone pool: 10 merchants that ALSO carry legitimate traffic
    fraud_pool = rng.choice(n_merchants, size=10, replace=False)
    merchant_probs = 1.0 / np.arange(1, n_merchants + 1) ** 1.05
    merchant_probs /= merchant_probs.sum()

    start = dt.datetime(2019, 1, 1)
    horizon_days = 540

    def card_rows(card_id: int, rng) -> tuple[list, int]:
        # per-card habits: 4-8 home merchants, lognormal amount regime
        n_home = int(rng.integers(4, 9))
        home = rng.choice(n_merchants, size=n_home, replace=False,
                          p=merchant_probs)
        amt_mu = rng.uniform(np.log(8), np.log(180))
        n_txn = int(np.clip(np.round(rng.lognormal(np.log(16), 0.45)), 5, 60))
        days = np.sort(rng.uniform(0, horizon_days, size=n_txn))
        rows = []
        for d in days:
            ts = start + dt.timedelta(days=float(d),
                                      hours=float(rng.uniform(8, 21)),
                                      minutes=float(rng.integers(0, 60)))
            m = int(home[rng.integers(n_home)]) if rng.random() < 0.85 \
                else int(rng.choice(n_merchants, p=merchant_probs))
            amt = float(np.clip(rng.lognormal(amt_mu, 0.6), 1.0, 9999.0))
            rows.append((ts, amt, merchants[m], 0))
        is_fraud_card = int(rng.random() < fraud_card_rate)
        if is_fraud_card:
            # burst: 2-5 high-amount night transactions at fraud-prone
            # merchants within a 2-day window
            burst_at = rng.uniform(0, horizon_days - 2)
            for _ in range(int(rng.integers(2, 6))):
                ts = start + dt.timedelta(
                    days=float(burst_at + rng.uniform(0, 2)),
                    hours=float(rng.uniform(0, 5)),
                    minutes=float(rng.integers(0, 60)))
                m = int(fraud_pool[rng.integers(len(fraud_pool))])
                # amounts clearly outside legit reach: legit draws are
                # lognormal(mu<=log 180, 0.6) whose +3 sigma tail is ~$1090,
                # so the $1200+ bins occur only in bursts — the separating
                # feature is textual (amount-bin token), as intended
                amt = float(np.clip(rng.lognormal(np.log(3000), 0.4),
                                    1200.0, 9999.0))
                rows.append((ts, amt, merchants[m], 1))
        rows.sort(key=lambda r: r[0])
        return rows, is_fraud_card

    os.makedirs(out_dir, exist_ok=True)
    stats = {"fraud_cards": 0, "cards": 0, "transactions": 0, "fraud_txns": 0}
    for fname, first, count in (("txn_train_raw.csv", 0, n_cards),
                                ("txn_test_raw.csv", n_cards, test_cards)):
        with open(os.path.join(out_dir, fname), "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=[
                "trans_date_trans_time", "amt", "merchant", "cc_num",
                "is_fraud"])
            w.writeheader()
            for c in range(first, first + count):
                rows, flagged = card_rows(c, rng)
                stats["cards"] += 1
                stats["fraud_cards"] += flagged
                for ts, amt, merchant, fraud in rows:
                    stats["transactions"] += 1
                    stats["fraud_txns"] += fraud
                    w.writerow({
                        "trans_date_trans_time": ts.isoformat(sep=" ",
                                                              timespec="seconds"),
                        "amt": f"{amt:.2f}",
                        "merchant": merchant,
                        "cc_num": f"4{c:015d}",
                        "is_fraud": fraud,
                    })
    return stats


def main(argv=None):
    import argparse
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--scale", choices=["paper", "small", "tiny"],
                    default="paper")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--build", action="store_true",
                    help="also run transactional.build_all on the CSVs")
    args = ap.parse_args(argv)
    scales = {
        "paper": dict(),
        "small": dict(n_cards=400, test_cards=100, n_merchants=40),
        "tiny": dict(n_cards=60, test_cards=20, n_merchants=12),
    }
    stats = generate_stream(args.out, seed=args.seed, **scales[args.scale])
    print(json.dumps(stats))
    if args.build:
        from .transactional import build_all

        build_all([os.path.join(args.out, "txn_train_raw.csv")],
                  [os.path.join(args.out, "txn_test_raw.csv")],
                  os.path.join(args.out, "artifacts"), number_items=None)
    with open(os.path.join(args.out, "stats.json"), "w") as f:
        json.dump(stats, f)


if __name__ == "__main__":
    main()
