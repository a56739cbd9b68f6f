"""The traffic generator makes the same corpus from the same seed (its
recorded digests), and the distributions its files state."""

import numpy as np

from portbench.tests.tiny import tiny_traffic
from portbench.traffic.generate import (HashTokenizer, digest, load_traffic, pack_table,
                                        pad_histories, seqrec_corpus, transaction_corpus)

SEQREC_DIGEST = "ce903c8f3bce1043b94307b9bffc5b36ab33daddd3279c67cbf5ea91c0a2fd9c"
TXN_DIGEST = "c2dd570a401f2d3b153c2b57d9f7619162c91b6cd75ed4742bbd6219a3f20aff"


def test_seqrec_digest():
    t = tiny_traffic(load_traffic("pretrain"))
    attrs, users = seqrec_corpus(7, "pretrain", t["corpus"])
    tab = pack_table(attrs, HashTokenizer(1024), 3, 8)
    ids, lens = pad_histories(users, 40)
    assert digest({**tab, "ids": ids, "lens": lens}) == SEQREC_DIGEST


def test_transaction_digest():
    t = tiny_traffic(load_traffic("train"))
    attrs, seqs, labels = transaction_corpus(7, "transactions", t["corpus"])
    tab = pack_table(attrs, HashTokenizer(1024), 3, 8)
    ids, lens = pad_histories(seqs, 70)
    assert digest({**tab, "ids": ids, "lens": lens, "labels": labels}) == TXN_DIGEST


def test_seqrec_lengths_and_large_seed():
    p = load_traffic("rank")["corpus"]
    attrs, users = seqrec_corpus(2 ** 31 + 12345, "finetune", dict(p, n_items=400, n_users=3000,
                                                                   n_categories=20))
    lens = np.array([len(u) for u in users])
    assert lens.min() >= 5 and lens.max() <= 40 and abs(np.median(lens) - 9) <= 1
    assert all(0 <= i < 400 for u in users for i in u)
    tab = pack_table(attrs, HashTokenizer(50265), 3, 32)
    assert tab["token_ids"].shape == (401, 96) and tab["lengths"][-1] == 0
    assert tab["token_ids"].max() < 50264 and (tab["token_types"][:-1, 0] == 1).all()


def test_transactions_cards():
    p = load_traffic("train")["corpus"]
    attrs, seqs, labels = transaction_corpus(3, "transactions", dict(p, n_cards=300, test_cards=50))
    assert len(seqs) == len(labels) == 240 and 0 < labels.mean() < 0.3
    lens = np.array([len(s) for s in seqs])
    assert lens.min() >= 5 and lens.max() <= 65
    assert all(a[0][0] == "amount" and a[1][1].startswith("shop_") for a in attrs[:20])
