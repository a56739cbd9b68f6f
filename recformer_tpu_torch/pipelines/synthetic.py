"""Structured synthetic Amazon-like benchmark corpus (the port's copy of
``recformer_tpu/pipelines/synthetic.py``: the same seed writes the same
JSON files, byte for byte).

    python -m recformer_tpu_torch.pipelines.synthetic --out DIR [--scale paper|small|tiny]

The reference's purpose is text-transfer sequential recommendation: pretrain
on seven Amazon categories, finetune on six *disjoint* ones, rank the full
catalog leave-one-out (``reference/README.md:111-135``,
``finetune_data/process.py:97-108``). Without the real dumps, this module
generates a corpus with the same *shape* and — unlike iid-random synthetic
data — learnable structure on both axes the model uses:

- **text -> latent**: each item has one latent category and one brand; its
  title/brand/category attributes are drawn from category-conditional
  vocabularies, so item text predicts the latent factor. Pretrain and
  finetune item universes are DISJOINT (different item ids, same language),
  matching the paper's zero-shot-transfer setting.
- **sequence -> latent**: user histories are Markov walks over the user's
  1-3 preferred categories; item choice within a category is popularity-Zipf
  with an item->co-item successor kernel, so the last-item target is
  predictable from the history well above popularity.

Default scale mirrors the smallest paper category
(Industrial_and_Scientific: ~5.3k items / ~11k users); ``--scale small``
and ``tiny`` generate test-sized corpora. Emits the artifact layout the CLIs
consume: finetune ``train/val/test/meta_data/smap.json`` (leave-one-out)
and pretrain ``train/dev/meta_data/smap.json`` (sequence lists), plus
``stats.json`` with the popularity baseline.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.io import read_json, write_json

_SYLLA = ["ta", "ri", "mo", "ke", "lu", "san", "der", "pex", "vol", "qui",
          "bra", "sto", "nel", "fim", "gar", "hyd", "zor", "pla", "cre", "wix"]


def _word(rng_or_idx: int) -> str:
    """Deterministic pronounceable pseudo-word for vocab index i."""
    i = int(rng_or_idx)
    parts = []
    for _ in range(2 + i % 2):
        parts.append(_SYLLA[i % len(_SYLLA)])
        i //= len(_SYLLA)
    return "".join(parts) + str(rng_or_idx % 7)


def _zipf_probs(n: int, a: float = 1.1) -> np.ndarray:
    p = 1.0 / np.arange(1, n + 1) ** a
    return p / p.sum()


def make_shared_kernel(rng, n_categories: int, n_brands: int,
                       vocab_words: int = 2000, words_per_cat: int = 30):
    """Universe-invariant structure for the shared-kernel corpus variant
    (the mechanism experiment): the parts of the generative
    process that carry *transferable* signal, drawn ONCE and reused for both
    the pretrain and finetune item universes.

    - ``cat_words`` / ``common_words``: category-conditional vocabularies —
      the same words mean the same latent category in both universes (the
      default generator re-permutes the pool per universe, so pretrained
      word->category associations were untransferable by construction).
    - ``cat_of_brand``: brand->category mapping.
    - ``cat_trans``: an explicit row-stochastic category->category transition
      kernel: heavy self-loop + 3 preferred successor categories per row.
      History generation and item successor (co-item) draws follow it in both
      universes, so the *sequence dynamics* the encoder learns in pretraining
      are the dynamics of the finetune corpus (the reference's transfer
      premise, ``reference/finetune.py:298-353``).
    """
    cat_word_pool = rng.permutation(vocab_words)
    cat_words = cat_word_pool[: n_categories * words_per_cat].reshape(
        n_categories, words_per_cat)
    common_words = cat_word_pool[n_categories * words_per_cat:
                                 n_categories * words_per_cat + 200]
    cat_of_brand = rng.integers(0, n_categories, size=n_brands)
    cat_trans = np.full((n_categories, n_categories),
                        0.1 / max(1, n_categories - 1))
    np.fill_diagonal(cat_trans, 0.0)
    for k in range(n_categories):
        succ = rng.choice([c for c in range(n_categories) if c != k],
                          size=min(3, n_categories - 1), replace=False)
        cat_trans[k, succ] += 0.30 / len(succ)
        cat_trans[k, k] = 0.60
    cat_trans /= cat_trans.sum(axis=1, keepdims=True)
    return {"cat_words": cat_words, "common_words": common_words,
            "cat_of_brand": cat_of_brand, "cat_trans": cat_trans}


def make_catalog(rng, n_items: int, n_categories: int, n_brands: int,
                 vocab_words: int = 2000, words_per_cat: int = 30,
                 id_prefix: str = "I", shared: dict | None = None):
    """Items with category-conditional attribute text.

    With ``shared`` (see :func:`make_shared_kernel`), the category
    vocabularies, brand->category map, and successor-category draws come from
    the shared kernel instead of this universe's own rng — only the item
    identities, their category assignment, popularity, and exact word choices
    stay universe-specific.

    Returns (meta: {asin: attrs}, smap: {asin: dense id}, item_cat (n,),
    item_pop (n,) within-category popularity weight, co_items (n, 5))."""
    if shared is None:
        cat_word_pool = rng.permutation(vocab_words)
        cat_words = cat_word_pool[: n_categories * words_per_cat].reshape(
            n_categories, words_per_cat)
        common_words = cat_word_pool[n_categories * words_per_cat:
                                     n_categories * words_per_cat + 200]
        cat_of_brand = rng.integers(0, n_categories, size=n_brands)
        cat_trans = None
    else:
        cat_words = shared["cat_words"]
        common_words = shared["common_words"]
        cat_of_brand = shared["cat_of_brand"]
        cat_trans = shared["cat_trans"]

    cat_probs = _zipf_probs(n_categories, 1.05)
    item_cat = rng.choice(n_categories, size=n_items, p=cat_probs)
    item_brand = np.empty(n_items, np.int64)
    for i in range(n_items):
        k = item_cat[i]
        own = np.flatnonzero(cat_of_brand == k)
        # brands mostly live inside one category; fall back to any brand
        if len(own) and rng.random() < 0.9:
            item_brand[i] = rng.choice(own)
        else:
            item_brand[i] = rng.integers(0, n_brands)

    meta, smap = {}, {}
    for i in range(n_items):
        k = item_cat[i]
        n_title = rng.integers(4, 9)
        own = rng.choice(cat_words[k], size=n_title - 1)
        mix = rng.choice(common_words, size=1)
        title = " ".join(_word(w) for w in np.concatenate([own, mix]))
        asin = f"{id_prefix}{i:06d}"
        meta[asin] = {
            "title": title,
            "brand": f"brand_{_word(1000 + int(item_brand[i]))}",
            "category": f"cat_{_word(3000 + int(k))}",
        }
        smap[asin] = i

    # within-category popularity: Zipf by per-category rank
    item_pop = np.empty(n_items)
    for k in range(n_categories):
        idx = np.flatnonzero(item_cat == k)
        if len(idx):
            item_pop[idx] = _zipf_probs(len(idx))[rng.permutation(len(idx))]
    # successor kernel: 5 co-items per item. Same-category by default; under
    # a shared kernel the successor's CATEGORY is drawn from cat_trans so the
    # item-level dynamics express the universe-invariant category kernel.
    by_cat = [np.flatnonzero(item_cat == k) for k in range(n_categories)]
    co_items = np.empty((n_items, 5), np.int64)
    for k in range(n_categories):
        idx = by_cat[k]
        for i in idx:
            if cat_trans is not None:
                cats = rng.choice(n_categories, size=5, p=cat_trans[k])
                co_items[i] = [
                    int(rng.choice(by_cat[c])) if len(by_cat[c])
                    else int(rng.integers(0, n_items)) for c in cats]
            else:
                pool = idx if len(idx) >= 6 else np.arange(n_items)
                co_items[i] = rng.choice(pool, size=5)
    return meta, smap, item_cat, item_pop, co_items


def make_histories(rng, n_users: int, item_cat, item_pop, co_items,
                   min_len: int = 5, max_len: int = 40,
                   p_stay: float = 0.75, p_co: float = 0.35,
                   cat_trans=None):
    """Markov user walks: preferred categories + co-item successor kernel.

    With ``cat_trans`` (shared-kernel variant) the category path is a Markov
    chain under the universe-invariant kernel — user preferences pick only
    the starting category; stay/switch behavior is encoded in the kernel's
    self-loop mass."""
    n_items = len(item_cat)
    n_categories = int(item_cat.max()) + 1
    by_cat = [np.flatnonzero(item_cat == k) for k in range(n_categories)]
    cat_item_probs = []
    for k in range(n_categories):
        w = item_pop[by_cat[k]]
        cat_item_probs.append(w / w.sum() if len(w) else None)
    cat_probs = np.array([len(b) for b in by_cat], float)
    cat_probs /= cat_probs.sum()

    users = []
    lens = np.clip(np.round(rng.lognormal(np.log(9), 0.5, size=n_users)),
                   min_len, max_len).astype(int)
    for u in range(n_users):
        n_pref = rng.integers(1, 4)
        prefs = rng.choice(n_categories, size=n_pref, replace=False,
                           p=cat_probs)
        prefs = [k for k in prefs if len(by_cat[k])] or \
            [int(np.argmax(cat_probs))]
        cur_cat = int(rng.choice(prefs))
        seq = []
        prev = None
        for _ in range(lens[u]):
            if prev is not None and rng.random() < p_co:
                nxt = int(rng.choice(co_items[prev]))
            else:
                if cat_trans is not None:
                    nc = int(rng.choice(n_categories, p=cat_trans[cur_cat]))
                    if len(by_cat[nc]):
                        cur_cat = nc
                elif rng.random() >= p_stay:
                    cur_cat = int(rng.choice(prefs))
                pool = by_cat[cur_cat]
                nxt = int(rng.choice(pool, p=cat_item_probs[cur_cat]))
            seq.append(nxt)
            prev = nxt
            cur_cat = int(item_cat[nxt])
        users.append(seq)
    return users


def generate_benchmark(out_dir: str, n_items: int = 5300,
                       n_users: int = 11000, n_categories: int = 60,
                       n_brands: int = 300, pretrain_items: int = 8000,
                       pretrain_users: int = 16000, seed: int = 7,
                       shared_kernel: bool = False):
    """Write the full two-corpus benchmark under ``out_dir``:

    - ``finetune/``: leave-one-out artifacts on item universe F
    - ``pretrain/``: sequence-list artifacts on DISJOINT item universe P
      (same vocabulary/language — the transfer the paper measures)

    ``shared_kernel=True`` is the mechanism-experiment variant: the two
    universes share the category vocabularies, brand->category map, and the
    category co-occurrence kernel (:func:`make_shared_kernel`), so the
    transferable structure the reference's headline claim depends on
    actually exists in the corpus. Items stay disjoint.
    """
    rng = np.random.default_rng(seed)
    ft = os.path.join(out_dir, "finetune")
    pre = os.path.join(out_dir, "pretrain")
    shared = None
    cat_trans = None
    if shared_kernel:
        shared = make_shared_kernel(np.random.default_rng(seed + 100),
                                    n_categories, n_brands)
        cat_trans = shared["cat_trans"]

    meta_f, smap_f, cat_f, pop_f, co_f = make_catalog(
        rng, n_items, n_categories, n_brands, id_prefix="F", shared=shared)
    users = make_histories(rng, n_users, cat_f, pop_f, co_f,
                           cat_trans=cat_trans)
    train, val, test = {}, {}, {}
    kept = 0
    for seq in users:
        if len(seq) < 5:
            continue
        u = str(kept)
        train[u], val[u], test[u] = seq[:-2], [seq[-2]], [seq[-1]]
        kept += 1
    for name, obj in (("train.json", train), ("val.json", val),
                      ("test.json", test), ("meta_data.json", meta_f),
                      ("smap.json", smap_f)):
        write_json(obj, os.path.join(ft, name))

    rng_p = np.random.default_rng(seed + 1)
    meta_p, smap_p, cat_p, pop_p, co_p = make_catalog(
        rng_p, pretrain_items, n_categories, n_brands, id_prefix="P",
        shared=shared)
    pusers = make_histories(rng_p, pretrain_users, cat_p, pop_p, co_p,
                            cat_trans=cat_trans)
    n_dev = min(max(64, pretrain_users // 20), pretrain_users // 2)
    write_json(pusers[n_dev:], os.path.join(pre, "train.json"))
    write_json(pusers[:n_dev], os.path.join(pre, "dev.json"))
    write_json(meta_p, os.path.join(pre, "meta_data.json"))
    write_json(smap_p, os.path.join(pre, "smap.json"))
    return {"finetune_users": kept, "finetune_items": n_items,
            "pretrain_users": pretrain_users,
            "pretrain_items": pretrain_items,
            "shared_kernel": shared_kernel}


def popularity_baseline(train: dict, test: dict, n_items: int, k: int = 10):
    """NDCG@k / Recall@k of the global-popularity ranker — the floor any
    learned model must clear."""
    counts = np.zeros(n_items)
    for seq in train.values():
        for i in seq:
            counts[i] += 1
    order = np.argsort(-counts)
    rank_of = np.empty(n_items, np.int64)
    rank_of[order] = np.arange(n_items)
    ndcg = recall = 0.0
    n = 0
    for u, targets in test.items():
        t = targets[0]
        r = rank_of[t]
        n += 1
        if r < k:
            recall += 1.0
            ndcg += 1.0 / np.log2(r + 2)
    return {"NDCG@10": ndcg / max(n, 1), "Recall@10": recall / max(n, 1)}


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--scale", choices=["paper", "small", "tiny"],
                    default="paper")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--shared_kernel", action="store_true",
                    help="pretrain/finetune universes share category "
                         "vocabularies + co-occurrence kernel (mechanism "
                         "experiment; items stay disjoint)")
    args = ap.parse_args(argv)
    scales = {
        "paper": dict(),
        "small": dict(n_items=800, n_users=2000, n_categories=20,
                      n_brands=60, pretrain_items=1200, pretrain_users=3000),
        "tiny": dict(n_items=120, n_users=200, n_categories=8, n_brands=16,
                     pretrain_items=150, pretrain_users=300),
    }
    stats = generate_benchmark(args.out, seed=args.seed,
                               shared_kernel=args.shared_kernel,
                               **scales[args.scale])
    ft = os.path.join(args.out, "finetune")
    base = popularity_baseline(read_json(os.path.join(ft, "train.json")),
                               read_json(os.path.join(ft, "test.json")),
                               stats["finetune_items"])
    stats["popularity_baseline"] = base
    write_json(stats, os.path.join(args.out, "stats.json"))
    print(stats)


if __name__ == "__main__":
    main()
