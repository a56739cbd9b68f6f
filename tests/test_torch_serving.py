"""The port's serving path against the JAX package's: catalog encoding,
ranked-eval metric sums, top-k ids, and the serve CLI of both packages on
one corpus with one checkpoint."""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recformer_tpu.config import RecformerConfig as JaxConfig
from recformer_tpu.models.heads import RecformerForSeqRec as JaxSeqRec
from recformer_tpu.models.heads import similarity_scores as jax_scores
from recformer_tpu.training.loops import encode_all_items as jax_encode
from recformer_tpu.training.steps import make_eval_step as jax_eval_step
from recformer_tpu_torch.config import RecformerConfig
from recformer_tpu_torch.models.heads import RecformerForSeqRec, similarity_scores
from recformer_tpu_torch.models.recformer import init_weights
from recformer_tpu_torch.training.loops import encode_all_items, evaluate_seqrec
from recformer_tpu_torch.training.steps import make_eval_step
from recformer_tpu_torch.weights import from_flax_params

N_ITEMS = 25


@pytest.fixture(scope="module")
def stacks():
    """fp32 tiny config with the kernel path; the same weights in both. The
    wide initializer spreads the catalog: at the default 0.02 every cosine is
    within 1e-5 of 1 and the ranking is decided by rounding."""
    kw = dict(attention_impl="pallas", hidden_act="gelu_tanh", dtype="float32",
              initializer_range=0.5)
    jcfg, tcfg = JaxConfig.tiny(**kw), RecformerConfig.tiny(**kw)
    rng = np.random.default_rng(0)
    M = jcfg.max_item_token_len
    table = {
        "token_ids": rng.integers(4, jcfg.vocab_size - 1, size=(N_ITEMS + 1, M)).astype(np.int32),
        "token_types": np.tile(np.where(np.arange(M) % 8 < 2, 1, 2).astype(np.int32),
                               (N_ITEMS + 1, 1)),
        "word_begin": rng.integers(0, 2, size=(N_ITEMS + 1, M)).astype(np.int32),
        "lengths": rng.integers(3, M + 1, size=N_ITEMS + 1).astype(np.int32),
    }
    table["lengths"][-1] = 0
    jmodel = JaxSeqRec(jcfg)
    dummy = {k: jnp.zeros((1, jcfg.item_seq_len), jnp.int32)
             for k in ("input_ids", "attention_mask", "global_attention_mask",
                       "token_type_ids", "item_position_ids")}
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(1), dummy))
    tmodel = RecformerForSeqRec(tcfg).eval()
    tmodel.load_state_dict(from_flax_params(params), strict=True)
    jtable = {k: jnp.asarray(v) for k, v in table.items()}
    ttable = {k: torch.from_numpy(v) for k, v in table.items()}
    return dict(jcfg=jcfg, tcfg=tcfg, jmodel=jmodel, params=params, tmodel=tmodel,
                jtable=jtable, ttable=ttable)


@pytest.fixture(scope="module")
def catalogs(stacks):
    s = stacks
    j = np.asarray(jax_encode(s["params"], s["jmodel"], s["jtable"], s["jcfg"], batch_size=8))
    t = encode_all_items(s["tmodel"], s["ttable"], s["tcfg"], batch_size=8)
    return j, t


def eval_batch(seed, B=6, S_in=7):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, N_ITEMS, size=(B, S_in)).astype(np.int32)
    lens = rng.integers(1, S_in + 1, size=B).astype(np.int32)
    labels = rng.integers(0, N_ITEMS, size=B).astype(np.int32)
    valid = np.ones(B, bool)
    valid[-1] = False
    return ids, lens, labels, valid


def test_encode_all_items_matches_jax(catalogs, tmp_path, stacks):
    j, t = catalogs
    assert t.shape == (N_ITEMS, stacks["tcfg"].hidden_size)  # 25 items, batch 8: tail padded
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-4, atol=1e-4)
    # the npz cache: a miss writes it, a hit returns the same catalog
    s = stacks
    path = str(tmp_path / "emb.npz")
    first = encode_all_items(s["tmodel"], s["ttable"], s["tcfg"], 8, cache_path=path)
    again = encode_all_items(s["tmodel"], s["ttable"], s["tcfg"], 8, cache_path=path)
    assert os.path.exists(path)
    np.testing.assert_array_equal(again.numpy(), first.numpy())
    assert again.dtype == first.dtype


def test_eval_step_sums_match_jax(stacks, catalogs):
    s = stacks
    emb_j, emb_t = catalogs
    ids, lens, labels, valid = eval_batch(2)
    ref = jax_eval_step(s["jcfg"], s["jmodel"])(
        s["params"], s["jtable"], jnp.asarray(ids), jnp.asarray(lens), jnp.asarray(labels),
        jnp.asarray(valid), jnp.asarray(emb_j))
    out = make_eval_step(s["tcfg"], s["tmodel"])(
        s["ttable"], *(torch.from_numpy(a) for a in (ids, lens, labels, valid)), emb_t)
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    assert float(out["count"]) == valid.sum()


def test_evaluate_seqrec_streams_batches(stacks, catalogs):
    """Two batches with a padded tail: the streamed means equal the sums of
    the per-batch steps over the valid count."""
    from recformer_tpu_torch.data.datasets import EvalDataset

    s = stacks
    _, emb_t = catalogs
    rng = np.random.default_rng(3)
    train = {u: [int(x) for x in rng.integers(0, N_ITEMS, size=rng.integers(1, 6))]
             for u in range(5)}
    val = {u: [int(rng.integers(0, N_ITEMS))] for u in range(5)}
    ds = EvalDataset(train, val, val, "val", max_items=10)
    metrics = evaluate_seqrec(s["tmodel"], s["ttable"], ds, emb_t, s["tcfg"], batch_size=3)
    step = make_eval_step(s["tcfg"], s["tmodel"])
    sums = None
    for b in ds.batches(3):
        out = step(s["ttable"], *(torch.from_numpy(a) for a in (
            b.item_ids, b.seq_lens, b.labels, b.valid)), emb_t)
        sums = out if sums is None else {k: sums[k] + v for k, v in out.items()}
    count = float(sums.pop("count"))
    assert count == 5
    for k, v in sums.items():
        assert metrics[k] == pytest.approx(float(v) / count, rel=1e-6)


def test_topk_ids_match_jax(stacks, catalogs):
    s = stacks
    emb_j, emb_t = catalogs
    ids, lens, _, _ = eval_batch(4)
    from recformer_tpu.data.device_pipeline import assemble_for_config as jax_assemble
    from recformer_tpu_torch.data.device_pipeline import assemble_for_config

    jb = jax_assemble(s["jtable"], jnp.asarray(ids), jnp.asarray(lens), s["jcfg"])
    jp = s["jmodel"].apply(s["params"], jb).astype(jnp.float32)
    _, jk = jax.lax.top_k(jax_scores(jp, jnp.asarray(emb_j), s["jcfg"].temp), 5)
    with torch.no_grad():
        tb = assemble_for_config(s["ttable"], torch.from_numpy(ids), torch.from_numpy(lens),
                                 s["tcfg"])
        tp = s["tmodel"](tb).float()
        _, tk = torch.topk(similarity_scores(tp, emb_t.float(), s["tcfg"].temp), 5)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


def write_corpus(root):
    """The tests/test_cli.py corpus: 25 items, 20 users."""
    rng = np.random.default_rng(0)
    n_items, n_users = 25, 20
    words = ["red", "blue", "bolt", "nut", "gear", "led", "cap", "fan"]
    meta = {f"I{i:03d}": {"make": words[i % len(words)], "hue": words[(i * 3 + 1) % len(words)]}
            for i in range(n_items)}
    smap = {f"I{i:03d}": i for i in range(n_items)}
    train, val, test = {}, {}, {}
    for u in range(n_users):
        seq = list(rng.integers(0, n_items, size=rng.integers(4, 9)))
        train[u] = [int(x) for x in seq[:-2]]
        val[u] = [int(seq[-2])]
        test[u] = [int(seq[-1])]
    os.makedirs(root, exist_ok=True)
    for name, obj in (("train", train), ("val", val), ("test", test), ("meta_data", meta),
                      ("smap", smap)):
        with open(os.path.join(root, f"{name}.json"), "w") as f:
            json.dump(obj, f)


def test_serve_cli_matches_jax(tmp_path):
    """Both serve CLIs (tiny, bf16 compute, --attention_impl pallas) load one
    .bin written from the port's state dict. A score is a cosine over
    temp=0.05, so bf16 rounding bounds it at 0.25; ranked ids must agree
    wherever neighbouring scores are more than 0.5 apart."""
    from recformer_tpu.cli.serve import main as jax_serve
    from recformer_tpu_torch.cli.serve import main as torch_serve

    write_corpus(str(tmp_path / "corpus_jax"))
    shutil.copytree(tmp_path / "corpus_jax", tmp_path / "corpus_torch")
    cfg = RecformerConfig.tiny(initializer_range=0.5)  # a spread catalog, as above
    model = RecformerForSeqRec(cfg)
    init_weights(model, cfg, torch.Generator().manual_seed(7))
    ckpt = str(tmp_path / "model.bin")
    torch.save(model.state_dict(), ckpt)
    rng = np.random.default_rng(5)
    seqs = {f"u{i}": [int(x) for x in rng.integers(0, 25, size=5)] for i in range(6)}
    with open(tmp_path / "sequences.json", "w") as f:
        json.dump(seqs, f)
    common = ["--sequences", str(tmp_path / "sequences.json"), "--model_size", "tiny",
              "--attention_impl", "pallas", "--ckpt", ckpt, "--batch_size", "4",
              "--encode_batch_size", "8"]
    assert jax_serve(["--data_path", str(tmp_path / "corpus_jax"), "--top_k", "10",
                      "--output", str(tmp_path / "jax.jsonl")] + common) == 6
    # the port ranks the whole catalog, so its score of every JAX top-k id is known
    assert torch_serve(["--data_path", str(tmp_path / "corpus_torch"), "--top_k", "25",
                        "--output", str(tmp_path / "torch.jsonl"), "--device", "cpu"]
                       + common) == 6
    rows_j = [json.loads(line) for line in open(tmp_path / "jax.jsonl")]
    rows_t = [json.loads(line) for line in open(tmp_path / "torch.jsonl")]
    assert [r["user"] for r in rows_t] == [r["user"] for r in rows_j]
    n_ranked = 0
    for rj, rt in zip(rows_j, rows_t):
        score_t = dict(zip(rt["items"], rt["scores"]))
        for item, sj in zip(rj["items"], rj["scores"]):
            assert abs(score_t[item] - sj) <= 0.25, (rj["user"], item)
        # items with the same text tie exactly, so the ids are compared as the
        # sets above each cut where JAX's neighbouring scores differ by > 0.5
        sc = rj["scores"]
        for k in range(1, len(sc)):
            if sc[k - 1] - sc[k] > 0.5:
                assert set(rt["items"][:k]) == set(rj["items"][:k]), (rj["user"], k)
                n_ranked += 1
    assert n_ranked >= 6
