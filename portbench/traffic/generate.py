"""The benchmark's one traffic generator: it reads a traffic file
(``traffic/<name>.json``) and makes, from the run's seed, the corpus that
the cell's driver feeds to the program.

Two kinds of corpus, frozen copies of the port's own generators in their
distributions (vectorised with numpy, so a run's set-up stays short; the
port's generators may change, this one does not):

- ``seqrec``: the synthetic Amazon-like corpus of
  ``recformer_tpu_torch/pipelines/synthetic.py`` (the smallest paper
  category's scale): items whose title, brand and category text is drawn
  from category-conditional vocabularies, and user histories that are
  Markov walks over 1-3 preferred categories with a co-item successor
  kernel, lognormal lengths of median 9 clipped to 5-40;
- ``transactions``: the card transaction stream of
  ``pipelines/synthetic_transactions.py`` (cards with 4-8 home merchants,
  lognormal amounts, 5-60 transactions over 540 days, 8% of cards with a
  burst of 2-5 large night-time transactions at fraud-prone merchants),
  turned into transaction types and per-card histories as
  ``pipelines/transactional.py`` does (amount bins, the signature, the
  first occurrence's attributes, the 80/10/10 card split).

Items become the packed item table the port's device pipeline reads
(``token_ids``, ``token_types``, ``word_begin``, ``lengths``; row N the
empty item), tokenized as the port's hash vocabulary tokenizes text: each
whitespace word cut into 4-character pieces, each piece's id from its md5.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Sequence

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

PAD_ID, BOS_ID, EOS_ID = 1, 0, 2
_RESERVED = 4
_CHUNK = 4


def load_traffic(name: str) -> dict:
    with open(os.path.join(HERE, f"{name}.json")) as f:
        return json.load(f)


def stream_seed(seed: int, stream: str) -> int:
    """A seed for one named stream of a run: the run's seed and the
    stream's name hashed together, so streams are independent."""
    h = hashlib.sha256(f"{int(seed)}/{stream}".encode()).digest()
    return int.from_bytes(h[:8], "little")


# ---------------------------------------------------------------------------
# tokenization (the hash vocabulary's rule)
# ---------------------------------------------------------------------------

class HashTokenizer:
    """Whitespace words in 4-character pieces, each piece's id
    ``4 + md5(piece)[:4] % (vocab - 5)``; a word's first piece begins a
    word. Pieces are cached, since corpora reuse a small vocabulary."""

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size
        self._words: Dict[str, tuple] = {}

    def _piece(self, piece: str) -> int:
        h = int.from_bytes(hashlib.md5(piece.encode("utf-8")).digest()[:4], "little")
        return _RESERVED + h % (self.vocab_size - 1 - _RESERVED)

    def word(self, w: str) -> tuple:
        got = self._words.get(w)
        if got is None:
            ids = [self._piece(w[j:j + _CHUNK]) for j in range(0, len(w), _CHUNK)]
            got = (ids, [1] + [0] * (len(ids) - 1))
            self._words[w] = got
        return got

    def text(self, s: str):
        ids, begin = [], []
        for w in s.split():
            i, b = self.word(w)
            ids += i
            begin += b
        return ids, begin


def pack_table(items: Sequence[Sequence[tuple]], tok: HashTokenizer, max_attr_num: int,
               max_attr_length: int) -> Dict[str, np.ndarray]:
    """Items (each a list of (key, value) attributes) -> the packed table:
    key tokens (type 1) then value tokens (type 2) per attribute, cut to
    ``max_attr_length``, at most ``max_attr_num`` attributes; row N empty."""
    n, m = len(items), max_attr_num * max_attr_length
    ids = np.full((n + 1, m), PAD_ID, np.int32)
    types = np.full((n + 1, m), 3, np.int32)
    begin = np.zeros((n + 1, m), np.int32)
    lengths = np.zeros(n + 1, np.int32)
    for r, attrs in enumerate(items):
        row_i: List[int] = []
        row_t: List[int] = []
        row_b: List[int] = []
        for key, value in list(attrs)[:max_attr_num]:
            ki, kb = tok.text(key)
            vi, vb = tok.text(value)
            row_i += (ki + vi)[:max_attr_length]
            row_t += ([1] * len(ki) + [2] * len(vi))[:max_attr_length]
            row_b += (kb + vb)[:max_attr_length]
        k = len(row_i)
        ids[r, :k], types[r, :k], begin[r, :k], lengths[r] = row_i, row_t, row_b, k
    return {"token_ids": ids, "token_types": types, "word_begin": begin, "lengths": lengths}


# ---------------------------------------------------------------------------
# the seqrec corpus
# ---------------------------------------------------------------------------

_SYLLA = ["ta", "ri", "mo", "ke", "lu", "san", "der", "pex", "vol", "qui",
          "bra", "sto", "nel", "fim", "gar", "hyd", "zor", "pla", "cre", "wix"]


def _word(idx: int) -> str:
    i, parts = int(idx), []
    for _ in range(2 + i % 2):
        parts.append(_SYLLA[i % len(_SYLLA)])
        i //= len(_SYLLA)
    return "".join(parts) + str(idx % 7)


def _zipf(n: int, a: float) -> np.ndarray:
    p = 1.0 / np.arange(1, n + 1) ** a
    return p / p.sum()


def _choose_without_replacement(rng, p: np.ndarray, rows: int, k: int) -> np.ndarray:
    """``rows`` draws of k distinct indices with weights ``p`` each (the
    Gumbel top-k form of sequential sampling without replacement)."""
    keys = np.log(p)[None, :] + rng.gumbel(size=(rows, len(p)))
    return np.argsort(-keys, axis=1)[:, :k]


def seqrec_catalog(rng, n_items: int, n_categories: int, n_brands: int, vocab_words: int,
                   words_per_cat: int, title_words: Sequence[int]):
    """Items with category-conditional text. Returns (attributes per item,
    item category, within-category popularity, 5 co-items per item)."""
    pool = rng.permutation(vocab_words)
    cat_words = pool[:n_categories * words_per_cat].reshape(n_categories, words_per_cat)
    common = pool[n_categories * words_per_cat:n_categories * words_per_cat + 200]
    cat_of_brand = rng.integers(0, n_categories, size=n_brands)
    item_cat = rng.choice(n_categories, size=n_items, p=_zipf(n_categories, 1.05))

    # brands mostly inside the item's category, else any brand
    by_brand_cat = np.argsort(cat_of_brand, kind="stable")
    b_start = np.searchsorted(cat_of_brand[by_brand_cat], np.arange(n_categories + 1))
    n_own = b_start[item_cat + 1] - b_start[item_cat]
    own = by_brand_cat[np.minimum(b_start[item_cat] + (rng.random(n_items) * np.maximum(n_own, 1))
                                  .astype(np.int64), len(by_brand_cat) - 1)]
    item_brand = np.where((n_own > 0) & (rng.random(n_items) < 0.9), own,
                          rng.integers(0, n_brands, size=n_items))

    n_title = rng.integers(title_words[0], title_words[1] + 1, size=n_items)
    title_own = cat_words[item_cat[:, None],
                          rng.integers(0, words_per_cat, size=(n_items, title_words[1]))]
    title_mix = common[rng.integers(0, len(common), size=n_items)]
    attrs = []
    for i in range(n_items):
        words = [_word(w) for w in title_own[i, :n_title[i] - 1]] + [_word(title_mix[i])]
        attrs.append((("title", " ".join(words)),
                      ("brand", f"brand_{_word(1000 + int(item_brand[i]))}"),
                      ("category", f"cat_{_word(3000 + int(item_cat[i]))}")))

    # within-category popularity: Zipf over a random rank in the category
    order = np.argsort(item_cat, kind="stable")
    c_start = np.searchsorted(item_cat[order], np.arange(n_categories + 1))
    item_pop = np.empty(n_items)
    for k in range(n_categories):
        idx = order[c_start[k]:c_start[k + 1]]
        if len(idx):
            item_pop[idx] = _zipf(len(idx), 1.1)[rng.permutation(len(idx))]
    # 5 co-items from the item's own category (any item in a small one)
    size = (c_start[1:] - c_start[:-1])[item_cat]
    pick = (rng.random((n_items, 5)) * size[:, None]).astype(np.int64)
    same = order[c_start[item_cat][:, None] + pick]
    co_items = np.where((size >= 6)[:, None], same, rng.integers(0, n_items, size=(n_items, 5)))
    return attrs, item_cat, item_pop, co_items


def seqrec_histories(rng, n_users: int, item_cat, item_pop, co_items, lengths: dict,
                     p_stay: float, p_co: float) -> List[np.ndarray]:
    """Markov walks: a user starts in one of 1-3 preferred categories, takes
    a co-item of the last item with probability ``p_co``, else an item of
    the current category by popularity, moving to another preferred
    category with probability ``1 - p_stay``."""
    n_categories = int(item_cat.max()) + 1
    order = np.argsort(item_cat, kind="stable")
    cats = item_cat[order]
    c_start = np.searchsorted(cats, np.arange(n_categories + 1))
    counts = (c_start[1:] - c_start[:-1]).astype(float)
    # one increasing array: category k's items' popularity CDF in (k, k+1]
    w = item_pop[order]
    csum = np.cumsum(w)
    base = np.concatenate([[0.0], csum])[c_start[:-1]]
    mass = np.where(counts > 0, np.concatenate([[0.0], csum])[c_start[1:]] - base, 1.0)
    cdf = cats + (csum - base[cats]) / mass[cats]

    lens = np.clip(np.round(rng.lognormal(np.log(lengths["median"]), lengths["sigma"],
                                          size=n_users)), lengths["min"], lengths["max"])
    lens = lens.astype(np.int64)
    cat_p = counts / counts.sum()
    n_pref = rng.integers(1, 4, size=n_users)
    prefs = _choose_without_replacement(rng, np.maximum(cat_p, 1e-300), n_users, 3)
    u = np.arange(n_users)

    def a_pref():
        return prefs[u, (rng.random(n_users) * n_pref).astype(np.int64)]

    cur = a_pref()
    seq = np.zeros((n_users, int(lens.max())), np.int64)
    prev = None
    for t in range(seq.shape[1]):
        switch = rng.random(n_users) >= p_stay
        cur = np.where(switch, a_pref(), cur)
        r = np.minimum(cur + rng.random(n_users), cur + 1 - 1e-12)
        by_pop = order[np.clip(np.searchsorted(cdf, r, side="right"), c_start[cur],
                               c_start[cur + 1] - 1)]
        nxt = by_pop
        if prev is not None:
            co = rng.random(n_users) < p_co
            nxt = np.where(co, co_items[prev, rng.integers(0, 5, size=n_users)], by_pop)
        seq[:, t] = nxt
        prev = nxt
        cur = item_cat[nxt]
    return [seq[i, :lens[i]] for i in range(n_users)]


def seqrec_corpus(seed: int, stream: str, p: dict):
    """(item attributes, histories) of one universe of the corpus."""
    rng = np.random.default_rng(stream_seed(seed, stream))
    attrs, cat, pop, co = seqrec_catalog(rng, p["n_items"], p["n_categories"], p["n_brands"],
                                         p["vocab_words"], p["words_per_category"],
                                         p["title_words"])
    users = seqrec_histories(rng, p["n_users"], cat, pop, co, p["history_length"],
                             p["p_stay"], p["p_co"]) if p.get("n_users") else []
    return attrs, users


# ---------------------------------------------------------------------------
# the transaction stream
# ---------------------------------------------------------------------------

_MSYLLA = ["mar", "ket", "ven", "dor", "plo", "sha", "gri", "tob", "lun",
           "fex", "cor", "dan", "rilo", "pas", "quo", "zen", "bik", "hom"]


def _merchant_name(i: int) -> str:
    parts, k = [], int(i)
    for _ in range(2):
        parts.append(_MSYLLA[k % len(_MSYLLA)])
        k //= len(_MSYLLA)
    return "shop_" + "".join(parts) + str(i)


def _amount_bins(number_bins: int = 1000, max_amt: int = 10000):
    edges = np.unique(np.round(np.linspace(0, max_amt, number_bins + 1)).astype(int)).astype(float)
    edges = np.append(edges, np.inf)
    labels = [f"{int(edges[i - 1])}-inf" if np.isinf(edges[i])
              else f"{int(edges[i - 1])}-{int(edges[i])}" for i in range(1, len(edges))]
    return edges, labels


def transaction_stream(rng, n_cards: int, n_merchants: int, fraud_card_rate: float,
                       horizon_days: int = 540):
    """Every transaction of ``n_cards`` cards: (card, time in seconds from
    2019-01-01, amount, merchant, fraud flag), and each card's flag."""
    fraud_pool = rng.choice(n_merchants, size=10, replace=False)
    mp = _zipf(n_merchants, 1.05)
    n_home = rng.integers(4, 9, size=n_cards)
    home = _choose_without_replacement(rng, mp, n_cards, 8)
    amt_mu = rng.uniform(np.log(8), np.log(180), size=n_cards)
    n_txn = np.clip(np.round(rng.lognormal(np.log(16), 0.45, size=n_cards)), 5, 60).astype(np.int64)
    card = np.repeat(np.arange(n_cards), n_txn)
    t = len(card)
    day = rng.uniform(0, horizon_days, size=t)
    secs = (day * 86400 + rng.uniform(8, 21, size=t) * 3600
            + rng.integers(0, 60, size=t) * 60)
    at_home = rng.random(t) < 0.85
    merchant = np.where(at_home, home[card, (rng.random(t) * n_home[card]).astype(np.int64)],
                        rng.choice(n_merchants, size=t, p=mp))
    amount = np.clip(rng.lognormal(amt_mu[card], 0.6), 1.0, 9999.0)
    fraud_card = rng.random(n_cards) < fraud_card_rate
    # bursts: 2-5 large night transactions at fraud-prone merchants in 2 days
    fc = np.flatnonzero(fraud_card)
    n_burst = rng.integers(2, 6, size=len(fc))
    burst_at = rng.uniform(0, horizon_days - 2, size=len(fc))
    b_card = np.repeat(fc, n_burst)
    nb = len(b_card)
    b_day = np.repeat(burst_at, n_burst) + rng.uniform(0, 2, size=nb)
    b_secs = b_day * 86400 + rng.uniform(0, 5, size=nb) * 3600 + rng.integers(0, 60, size=nb) * 60
    b_merchant = fraud_pool[rng.integers(0, 10, size=nb)]
    b_amount = np.clip(rng.lognormal(np.log(3000), 0.4, size=nb), 1200.0, 9999.0)
    return (np.concatenate([card, b_card]), np.concatenate([secs, b_secs]),
            np.concatenate([amount, b_amount]), np.concatenate([merchant, b_merchant]),
            np.concatenate([np.zeros(t, bool), np.ones(nb, bool)]), fraud_card)


def transaction_corpus(seed: int, stream: str, p: dict):
    """Transaction types as items and the training split's cards:
    (attributes per type, [type ids of each card, time-sorted], labels)."""
    rng = np.random.default_rng(stream_seed(seed, stream))
    n_cards = p["n_cards"] + p["test_cards"]
    card, secs, amount, merchant, _, fraud_card = transaction_stream(
        rng, n_cards, p["n_merchants"], p["fraud_card_rate"])
    secs = np.floor(secs).astype(np.int64)  # the CSV's whole seconds
    stamp = np.datetime64("2019-01-01T00:00:00", "s") + secs.astype("timedelta64[s]")
    days = stamp.astype("datetime64[D]")
    year = days.astype("datetime64[Y]").astype(int) + 1970
    month = days.astype("datetime64[M]").astype(int) % 12 + 1
    day = (days - days.astype("datetime64[M]")).astype(int) + 1
    dow = (days.astype(int) + 3) % 7  # 1970-01-01 was a Thursday; Monday = 0
    edges, labels = _amount_bins()
    amt = np.round(amount, 2)
    abin = np.clip(np.searchsorted(edges, np.abs(amt), side="right") - 1, 0, len(labels) - 1)
    # the signature (amount bin, merchant, date): one transaction type each
    sig = np.stack([abin, merchant, year, month, day, dow], axis=1)
    uniq, first, type_of = np.unique(sig, axis=0, return_index=True, return_inverse=True)
    type_of = type_of.reshape(-1)
    attrs = [(("amount", labels[int(uniq[i, 0])]), ("merchant", _merchant_name(int(uniq[i, 1]))),
              ("year", str(int(uniq[i, 2]))), ("month", str(int(uniq[i, 3]))),
              ("day", str(int(uniq[i, 4]))), ("weekday", str(int(uniq[i, 5]))))
             for i in range(len(uniq))]
    # the training cards, time-sorted; the 80% training share of a shuffled
    # card split (the validation and test shares are not run)
    o = np.lexsort((secs, card))
    card_s, type_s = card[o], type_of[o]
    starts = np.searchsorted(card_s, np.arange(n_cards + 1))
    train_cards = rng.permutation(p["n_cards"])[:int(p["n_cards"] * p["train_share"])]
    seqs, flags = [], []
    for c in np.sort(train_cards):
        s = type_s[starts[c]:starts[c + 1]]
        if len(s) > 1:
            seqs.append(s)
            flags.append(int(fraud_card[c]))
    return attrs, seqs, np.asarray(flags, np.float32)


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------

def pad_histories(seqs: Sequence[np.ndarray], max_items: int):
    """(N, max_items) int32 ids (the newest ``max_items`` of each, left
    aligned) and (N,) lengths."""
    ids = np.zeros((len(seqs), max_items), np.int32)
    lens = np.zeros(len(seqs), np.int32)
    for i, s in enumerate(seqs):
        s = np.asarray(s)[-max_items:]
        ids[i, :len(s)] = s
        lens[i] = len(s)
    return ids, lens


def digest(arrays: Dict[str, np.ndarray]) -> str:
    """A sha256 over arrays by name: the tests' record of a corpus."""
    h = hashlib.sha256()
    for k in sorted(arrays):
        a = np.ascontiguousarray(arrays[k])
        h.update(k.encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()
