"""The port's fraud-detection path against the JAX package's, on the CPU:
the fraud head's logits with weights carried by ``from_flax_params``
(1e-4) and the fraud tree carried both ways (exact, unrolled and stacked),
the BCE and focal losses (1e-6), the valid-weighted fraud loss and every
gradient (1e-4), the step's seeded dropout and the MLP's keep rate, the
evaluation's probabilities (1e-5) and its host metrics (exact, under
hypothesis), ``cli.finetune_classification`` against the JAX CLI at zero
learning rate (1e-5), its refusals and its exact resume, and the
transaction pipelines (byte for byte). fp32, ``tiny()`` sizes, inputs from
seeded numpy generators."""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from recformer_tpu.cli import finetune_classification as jax_fraud_cli
from recformer_tpu.config import RecformerConfig as JaxConfig
from recformer_tpu.data import device_pipeline as jdp
from recformer_tpu.data.datasets import FraudDataset as JaxFraudDataset
from recformer_tpu.models.heads import RecformerForFraudDetection as JaxFraud
from recformer_tpu.pipelines import synthetic_transactions as jax_synth
from recformer_tpu.training import loops as jloops
from recformer_tpu.training import losses as jlosses
from recformer_tpu.training.steps import make_fraud_eval_step as jax_fraud_eval_step
from recformer_tpu_torch.cli import finetune_classification as torch_fraud_cli
from recformer_tpu_torch.config import RecformerConfig
from recformer_tpu_torch.data.datasets import FraudDataset
from recformer_tpu_torch.models import heads
from recformer_tpu_torch.models.heads import RecformerForFraudDetection
from recformer_tpu_torch.models.recformer import init_weights
from recformer_tpu_torch.pipelines import synthetic_transactions as torch_synth
from recformer_tpu_torch.training import loops as tloops
from recformer_tpu_torch.training import losses as tlosses
from recformer_tpu_torch.training.checkpoint import restore_params
from recformer_tpu_torch.training.optimizer import create_optimizer
from recformer_tpu_torch.training.steps import fraud_loss, make_fraud_train_step
from recformer_tpu_torch.weights import from_flax_params, to_flax_params, torch_name_to_flax_path

TOL = dict(rtol=1e-4, atol=1e-4)
TIGHT = dict(rtol=1e-6, atol=1e-6)
BATCH_KEYS = ("input_ids", "attention_mask", "global_attention_mask", "token_type_ids",
              "item_position_ids")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Tiny models gain nothing from many intra-op threads, and beside other
    test processes on the same cores they lose much to contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def synthetic_table(cfg, n_items, seed=0):
    rng = np.random.default_rng(seed)
    M = cfg.max_item_token_len
    ids = rng.integers(4, cfg.vocab_size - 1, size=(n_items + 1, M)).astype(np.int32)
    types = np.tile(np.where(np.arange(M) % 8 < 2, 1, 2).astype(np.int32), (n_items + 1, 1))
    begin = rng.integers(0, 2, size=(n_items + 1, M)).astype(np.int32)
    lengths = rng.integers(3, M + 1, size=n_items + 1).astype(np.int32)
    ids[-1] = cfg.pad_token_id
    lengths[-1] = 0
    return {"token_ids": ids, "token_types": types, "word_begin": begin, "lengths": lengths}


def configs(**kw):
    kw = dict(hidden_act="gelu_tanh", dtype="float32", **kw)
    return JaxConfig.tiny(**kw), RecformerConfig.tiny(**kw)


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def fraud_world(jcfg, seed, B=6, S=10, n_items=30):
    """A table, histories (one of a single item), labels with both classes
    and a valid mask with two padding rows, and the JAX-assembled batch."""
    table_np = synthetic_table(jcfg, n_items, seed)
    rng = np.random.default_rng(seed)
    item_ids = rng.integers(0, n_items, size=(B, S)).astype(np.int32)
    seq_lens = rng.integers(1, S + 1, size=B).astype(np.int32)
    seq_lens[0] = 1
    labels = np.array([1, 0] * (B // 2), np.float32)
    valid = np.ones(B, bool)
    valid[-2:] = False
    table = {k: jnp.asarray(v) for k, v in table_np.items()}
    batch = jdp.assemble_for_config(table, jnp.asarray(item_ids), jnp.asarray(seq_lens), jcfg)
    return table_np, item_ids, seq_lens, labels, valid, {k: np.asarray(batch[k])
                                                         for k in BATCH_KEYS}


def jax_fraud(jcfg, batch, seed):
    model = JaxFraud(jcfg)
    return model, jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(seed), batch))


def port_fraud(tcfg, params):
    model = RecformerForFraudDetection(tcfg)
    model.load_state_dict(from_flax_params(params), strict=True)
    return model


# ---------------------------------------------------------------------------
# the head and its weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["pallas", "chunked"])
@pytest.mark.parametrize("pooler", ["cls", "avg"])
def test_fraud_head_logits_match_jax(impl, pooler):
    """Deterministic logits of the whole model, the port's attention through
    the band core's autograd function (its plain version here) or the
    chunked twin, JAX's through its chunked attention; within 1e-4."""
    jcfg, tcfg = configs(initializer_range=0.1, pooler_type=pooler)
    *_, batch = fraud_world(jcfg, 1)
    jmodel, params = jax_fraud(jcfg, batch, 2)
    logits_j = np.asarray(jmodel.apply(params, batch, deterministic=True))
    model = port_fraud(tcfg.replace(attention_impl=impl), params)
    with torch.no_grad():
        logits_t = model(to_torch(batch)).numpy()
    assert logits_t.shape == logits_j.shape == (batch["input_ids"].shape[0],)
    assert np.ptp(logits_j) > 1e-2  # the rows are told apart
    np.testing.assert_allclose(logits_t, logits_j, **TOL)


@pytest.mark.parametrize("stacked", [False, True], ids=["unrolled", "scan_layers"])
def test_fraud_tree_round_trips_leaf_for_leaf(stacked):
    """``from_flax_params`` takes every leaf of the JAX fraud tree (the head's
    ``fc1``-``fc3`` included) and ``to_flax_params`` gives the same tree back,
    in either encoder layout."""
    jcfg, tcfg = configs(scan_layers=stacked)
    *_, batch = fraud_world(jcfg, 0)
    _, params = jax_fraud(jcfg, batch, 3)
    sd = from_flax_params(params)
    assert {f"fc{i}.{w}" for i in (1, 2, 3) for w in ("weight", "bias")} <= set(sd)
    RecformerForFraudDetection(tcfg).load_state_dict(sd, strict=True)
    back = to_flax_params(sd, stacked=stacked)
    flat = {tuple(getattr(k, "key", k) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(params["params"])}
    flat_back = {tuple(getattr(k, "key", k) for k in path): leaf
                 for path, leaf in jax.tree_util.tree_leaves_with_path(back)}
    assert set(flat_back) == set(flat)
    for path, leaf in flat.items():
        np.testing.assert_array_equal(flat_back[path], leaf, err_msg="/".join(path))
    assert torch_name_to_flax_path("fc1.weight") == (("fc1", "kernel"), True)
    assert torch_name_to_flax_path("fc3.bias") == (("fc3", "bias"), False)


# ---------------------------------------------------------------------------
# losses and gradients
# ---------------------------------------------------------------------------

LOSS_CASES = {
    "bce": ("bce", dict()),
    "bce_pos_weight": ("bce", dict(pos_weight=3.5)),
    "focal": ("focal", dict()),
    "focal_alpha": ("focal", dict(alpha=0.25)),
    "focal_no_alpha": ("focal", dict(alpha=None)),
    "focal_pos_weight": ("focal", dict(pos_weight=2.0, gamma=1.5)),
    "focal_alpha_pos_weight": ("focal", dict(alpha=0.75, pos_weight=4.0, gamma=3.0)),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_fraud_losses_and_logit_grads_match_jax(case):
    """BCE-with-logits and focal loss (with and without ``pos_weight`` and
    ``alpha``) and their gradients with respect to the logits, on logits from
    -30 to 30 (softplus without a cut-off), within 1e-6."""
    kind, kw = LOSS_CASES[case]
    rng = np.random.default_rng(len(case))
    x = np.concatenate([rng.normal(0, 3, 29), [-30.0, 30.0, 0.0]]).astype(np.float32)
    y = (rng.random(x.shape) < 0.4).astype(np.float32)
    jfn = jlosses.bce_with_logits_loss if kind == "bce" else jlosses.focal_loss
    tfn = tlosses.bce_with_logits_loss if kind == "bce" else tlosses.focal_loss
    loss_j, grad_j = jax.value_and_grad(lambda v: jfn(v, jnp.asarray(y), **kw))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    loss_t = tfn(xt, torch.from_numpy(y), **kw)
    loss_t.backward()
    assert loss_t.dtype == torch.float32
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), **TIGHT)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(grad_j), **TIGHT)
    # a bf16 input is computed in float32
    bf = tfn(torch.from_numpy(x).bfloat16(), torch.from_numpy(y), **kw)
    assert bf.dtype == torch.float32


def _jax_fraud_loss(jmodel, jcfg, batch, labels, valid):
    """The JAX fraud step's ``loss_fn`` (``training/steps.py``) with a
    deterministic forward: its own is hard-wired to ``deterministic=False``."""

    def loss_fn(params):
        x = jmodel.apply(params, batch, deterministic=True).astype(jnp.float32)
        y = jnp.asarray(labels)
        per = jcfg.pos_weight * y * jax.nn.softplus(-x) + (1.0 - y) * jax.nn.softplus(x)
        w = jnp.asarray(valid).astype(jnp.float32)
        return jnp.sum(per * w) / jnp.maximum(jnp.sum(w), 1.0)

    return loss_fn


@pytest.mark.parametrize("impl", ["pallas", "chunked"])
def test_fraud_loss_and_every_gradient_match_jax(impl):
    """The valid-weighted fraud loss with ``pos_weight`` 2.5 over a batch with
    two padding rows, through both stacks from one set of weights; the loss
    and every parameter's gradient (the head's and the backbone's) within
    1e-4."""
    jcfg, tcfg = configs(initializer_range=0.1, pos_weight=2.5)
    _, _, _, labels, valid, batch = fraud_world(jcfg, 4)
    jmodel, params = jax_fraud(jcfg, batch, 5)
    loss_j, grads_j = jax.value_and_grad(_jax_fraud_loss(jmodel, jcfg, batch, labels,
                                                         valid))(params)
    model = port_fraud(tcfg.replace(attention_impl=impl), params)
    loss_t = fraud_loss(tcfg, model(to_torch(batch)), torch.from_numpy(labels),
                        torch.from_numpy(valid))
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-5)
    flat = {tuple(getattr(k, "key", k) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(grads_j["params"])}
    names = []
    for name, p in model.named_parameters():
        path, transpose = torch_name_to_flax_path(name)
        got = p.grad.numpy()
        np.testing.assert_allclose(got.T if transpose else got, np.asarray(flat[path]),
                                   err_msg=name, **TOL)
        names.append(name)
    assert len(names) == len(flat) and "fc3.weight" in names
    # the padding rows do not move the loss
    logits = model(to_torch(batch)).detach()
    other = torch.from_numpy(np.where(valid, labels, 1.0 - labels))
    assert torch.equal(fraud_loss(tcfg, logits, other, torch.from_numpy(valid)),
                       fraud_loss(tcfg, logits, torch.from_numpy(labels),
                                  torch.from_numpy(valid)))


def _step_losses(tcfg, table, world, calls):
    """Losses of ``calls`` = [(seed, ...)] through one model's fraud step at
    learning rate 0 (the parameters stay), micro-steps 0, 1, ..."""
    _, item_ids, seq_lens, labels, valid, _ = world
    model = RecformerForFraudDetection(tcfg)
    init_weights(model, tcfg, torch.Generator().manual_seed(0))
    step = make_fraud_train_step(tcfg, model, create_optimizer(model, learning_rate=0.0))
    args = [torch.from_numpy(a) for a in (item_ids, seq_lens, labels, valid)]
    return [step(seed, table, *args)["loss"] for seed in calls]


def test_fraud_step_dropout_is_seeded_by_seed_and_step():
    """The step's draws (the backbone's dropout, the attention kernels' and
    the head's) come from ``fold_in(seed, micro-step)``: the same seed and
    step give the same loss, another seed or the next step another."""
    jcfg, tcfg = configs(initializer_range=0.1)
    world = fraud_world(jcfg, 6)
    table = to_torch(world[0])
    a = _step_losses(tcfg, table, world, [7, 7])
    b = _step_losses(tcfg, table, world, [7, 8])
    assert torch.equal(a[0], b[0])  # seed 7, step 0 in both
    assert not torch.equal(a[0], a[1])  # step 1
    assert not torch.equal(a[1], b[1])  # seed 8 at step 1
    model = RecformerForFraudDetection(tcfg)
    init_weights(model, tcfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        clean = fraud_loss(tcfg, model({k: torch.from_numpy(v) for k, v in world[5].items()}),
                           torch.from_numpy(world[3]), torch.from_numpy(world[4]))
    assert not torch.equal(a[0], clean)


def test_fraud_mlp_dropout_keeps_80_percent_and_rescales(monkeypatch):
    """The head draws ``hidden_dropout_prob`` on the pooled output, then 0.2
    after each hidden layer: over 256 rows the MLP's keep rate is 0.8 within
    five standard errors, and every kept value is scaled by 1/0.8. A
    deterministic forward draws nothing."""
    jcfg, tcfg = configs(initializer_range=0.1, attention_probs_dropout_prob=0.0)
    calls = []
    real = heads.dropout

    def recording(x, rate, rng):
        y = real(x, rate, rng)
        calls.append((rate, x.detach(), y.detach(), rng is not None))
        return y

    monkeypatch.setattr(heads, "dropout", recording)
    model = RecformerForFraudDetection(tcfg)
    init_weights(model, tcfg, torch.Generator().manual_seed(1))
    table, item_ids, seq_lens, *_ = fraud_world(jcfg, 8, B=256)
    batch = jdp.assemble_for_config({k: jnp.asarray(v) for k, v in table.items()},
                                    jnp.asarray(item_ids), jnp.asarray(seq_lens), jcfg)
    batch = to_torch({k: batch[k] for k in BATCH_KEYS})
    from recformer_tpu_torch.utils.rng import StepRNG

    with torch.no_grad():
        model(batch, deterministic=False, rng=StepRNG(3))
    assert [c[0] for c in calls] == [tcfg.hidden_dropout_prob, 0.2, 0.2]
    assert all(c[3] for c in calls)
    kept = n = 0
    for rate, x, y, _ in calls[1:]:
        live = x != 0  # ReLU zeros carry no draw that can be seen
        kept += int((y[live] != 0).sum())
        n += int(live.sum())
        np.testing.assert_allclose(y[live & (y != 0)].numpy(),
                                   (x[live & (y != 0)] / 0.8).numpy(), rtol=1e-6)
    assert n > 2000
    assert abs(kept / n - 0.8) < 5 * np.sqrt(0.8 * 0.2 / n), kept / n
    calls.clear()
    with torch.no_grad():
        model(batch)
    assert [c[3] for c in calls] == [False, False, False]


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

def _fraud_users(seed, n, n_items=30):
    rng = np.random.default_rng(seed)
    return {u: [[int(x) for x in rng.integers(0, n_items, size=rng.integers(1, 9))],
                [int(rng.random() < 0.35)]] for u in range(n)}


def test_fraud_probabilities_and_sweep_match_jax():
    """23 users in batches of 8 (a padded last batch): the port's
    probabilities of the valid rows against the JAX eval step's within 1e-5,
    in the same order, and ``evaluate_fraud``'s selected metrics against
    the JAX one's within 1e-5 (the JAX side through its scanned groups)."""
    jcfg, tcfg = configs(initializer_range=0.3)
    table_np = synthetic_table(jcfg, 30, 9)
    users = _fraud_users(9, 23)
    jds, tds = JaxFraudDataset(users, max_items=10), FraudDataset(users, max_items=10)
    batch = {k: jnp.zeros((1, jcfg.max_token_num), jnp.int32) for k in BATCH_KEYS}
    jmodel, params = jax_fraud(jcfg, batch, 10)
    table_j = {k: jnp.asarray(v) for k, v in table_np.items()}
    jstep = jax_fraud_eval_step(jcfg, jmodel)
    probs_j = np.concatenate([
        np.asarray(jstep(params, table_j, jnp.asarray(b.item_ids),
                         jnp.asarray(b.seq_lens)))[b.valid] for b in jds.batches(8)])
    model = port_fraud(tcfg.replace(attention_impl="pallas"), params)
    probs_t, labels_t = tloops.fraud_probabilities(model, to_torch(table_np), tds, tcfg, 8)
    assert probs_t.dtype == np.float32 and probs_t.shape == (23,)
    np.testing.assert_allclose(probs_t, probs_j, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(labels_t, [users[u][1][0] for u in sorted(users)])
    # no probability within 1e-4 of a threshold or of another: the sweep and
    # the ranks cannot turn on rounding
    grid = np.arange(0.1, 0.91, 0.1)
    assert np.abs(probs_j[:, None] - grid[None]).min() > 1e-4
    assert np.diff(np.sort(probs_j)).min() > 1e-4
    got = tloops.evaluate_fraud(model, to_torch(table_np), tds, tcfg, batch_size=8)
    want = jloops.evaluate_fraud(params, jmodel, table_j, jds, jcfg, batch_size=8)
    assert set(got) == set(want)
    assert got["confusion"] == want["confusion"] and got["threshold"] == want["threshold"]
    for k in set(want) - {"confusion"}:
        assert got[k] == pytest.approx(want[k], abs=1e-5), k


probs_strategy = st.lists(st.sampled_from([0.0, 0.05, 0.1, 0.3, 0.5, 0.50001, 0.7, 0.9, 1.0]),
                          min_size=1, max_size=40)


@settings(max_examples=150, deadline=None)
@given(probs=probs_strategy, data=st.data())
def test_binary_metrics_and_auc_equal_jax_exactly(probs, data):
    """On the same numpy inputs, with ties (a small grid of values) and
    single-class splits, every threshold's metrics and the AUC equal the JAX
    package's exactly."""
    p = np.asarray(probs, np.float32)
    y = np.asarray(data.draw(st.lists(st.integers(0, 1), min_size=len(p), max_size=len(p))),
                   np.float32)
    for t in np.arange(0.1, 0.91, 0.1):
        assert tloops.binary_classification_metrics(p, y, float(t)) == \
            jloops.binary_classification_metrics(p, y, float(t))
    assert tloops.roc_auc(p, y) == jloops.roc_auc(p, y)
    if y.min() == y.max():
        assert tloops.roc_auc(p, y) == 0.5


def test_roc_auc_known_values_and_ties():
    probs = np.array([0.9, 0.8, 0.7, 0.6, 0.5, 0.4])
    assert tloops.roc_auc(probs, np.array([1, 1, 1, 0, 0, 0])) == 1.0
    assert tloops.roc_auc(probs, np.array([0, 0, 0, 1, 1, 1])) == 0.0
    assert tloops.roc_auc(np.full(6, 0.5), np.array([1, 1, 1, 0, 0, 0])) == 0.5
    # one positive tied with one of two negatives: (0.5 + 1) / 2
    assert tloops.roc_auc(np.array([0.4, 0.4, 0.2]), np.array([1, 0, 0])) == 0.75


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def write_fraud_corpus(root, seed=11):
    """The synthetic transaction stream at ``--scale tiny``, built; returns
    its ``classification_data/`` (48 / 6 / 6 cards, histories of 5-65
    transactions)."""
    torch_synth.main(["--out", str(root), "--scale", "tiny", "--seed", str(seed), "--build"])
    return os.path.join(str(root), "artifacts", "classification_data")


COMMON = ["--model_size", "tiny", "--num_train_epochs", "2", "--batch_size", "8",
          "--eval_batch_size", "8"]


@pytest.fixture(scope="module")
def fraud_corpus(tmp_path_factory):
    return write_fraud_corpus(tmp_path_factory.mktemp("txn"))


def _copy_corpus(src, dst):
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("preprocess"))
    return str(dst)


@pytest.fixture(scope="module")
def zero_lr_runs(tmp_path_factory, fraud_corpus):
    """Both CLIs at learning rate 0 (head included) from one weight set made
    by the port, in float32 (each CLI's ``build_config`` wrapped): the port
    reads it with ``--pretrain_ckpt``; the JAX CLI, whose importer skips the
    head's ``fc*``, is given it as its initial tree (``init_model_params``
    patched, the tree built by ``to_flax_params``). The port runs the
    attention kernel's wrapper (its plain version here), JAX its chunked
    attention. A wide initializer spreads the probabilities away from the
    thresholds. Returns {stack: (mirror rows, test metrics)}."""
    root = tmp_path_factory.mktemp("fraud_zero_lr")
    cfg = RecformerConfig.tiny(initializer_range=0.3)
    model = RecformerForFraudDetection(cfg)
    init_weights(model, cfg, torch.Generator().manual_seed(5))
    ckpt = str(root / "M.pt")
    torch.save(model.state_dict(), ckpt)
    tree = jax.tree.map(jnp.asarray, to_flax_params(model.state_dict()))
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for stack, cli, impl in (("jax", jax_fraud_cli, "chunked"),
                                 ("torch", torch_fraud_cli, "pallas")):
            build = cli.build_config
            mp.setattr(cli, "build_config", lambda args, item_num=0, _b=build:
                       dataclasses.replace(_b(args, item_num=item_num), dtype="float32"))
            extra = ["--device", "cpu", "--pretrain_ckpt", ckpt] if stack == "torch" else []
            if stack == "jax":
                mp.setattr(cli, "init_model_params", lambda *a, **k: {"params": tree})
            mirror = str(root / f"{stack}.jsonl")
            data = _copy_corpus(fraud_corpus, root / stack / "classification_data")
            cli.main(["--data_path", data, "--output_dir", str(root / stack / "out"),
                      "--learning_rate", "0", "--head_lr", "0", "--attention_impl", impl,
                      "--mirror_file", mirror] + COMMON + extra)
            with open(mirror) as f:
                rows = [json.loads(line) for line in f]
            with open(root / stack / "out" / "classification_data" / "test_metrics.json") as f:
                out[stack] = (rows, json.load(f))
    finally:
        mp.undo()
    return out


def test_fraud_cli_matches_jax_cli_at_zero_learning_rate(zero_lr_runs):
    """At learning rate 0 both models keep the one weight set, so every dev
    row (threshold, F1, accuracy, precision, recall, AUC) and the test
    metrics agree within 1e-5, the confusion counts exactly; the rows'
    ``loss`` depends on the dropout draws and is not compared."""
    (rows_j, test_j), (rows_t, test_t) = zero_lr_runs["jax"], zero_lr_runs["torch"]
    assert [(r["event"], r.get("epoch")) for r in rows_t] == \
        [(r["event"], r.get("epoch")) for r in rows_j] == \
        [("dev", 0), ("dev", 1), ("test", None)]
    for rj, rt in zip(rows_j, rows_t):
        metrics = set(rj) - {"event", "epoch", "loss"}
        assert metrics == set(rt) - {"event", "epoch", "loss"} and "f1" in metrics
        for k in metrics:
            assert rt[k] == pytest.approx(rj[k], abs=1e-5), (rj["event"], k)
    assert set(test_t) == set(test_j)
    assert test_t["confusion"] == test_j["confusion"]
    for k in set(test_j) - {"confusion"}:
        assert test_t[k] == pytest.approx(test_j[k], abs=1e-5), k
    assert rows_t[-1] == {"event": "test", **{k: v for k, v in test_t.items()
                                              if k != "confusion"}}


def test_fraud_cli_refuses_stale_state_changed_recipe_and_remat(tmp_path, fraud_corpus):
    """A leftover ``loop_state/`` without ``--resume`` and a resume under
    another optimizer recipe each exit before any training."""
    data = _copy_corpus(fraud_corpus, tmp_path / "classification_data")
    out = tmp_path / "out"
    loop_dir = out / "classification_data" / "loop_state"
    os.makedirs(loop_dir)
    with open(loop_dir / "loop.json", "w") as f:
        json.dump({"epoch": 0, "best_f1": 0.0, "patience": 3,
                   "recipe": {"learning_rate": 5e-5, "head_lr": None},
                   "epoch_metrics": []}, f)
    args = ["--data_path", data, "--output_dir", str(out), "--device", "cpu"] + COMMON
    with pytest.raises(SystemExit, match="--resume"):
        torch_fraud_cli.main(args)
    with pytest.raises(SystemExit, match="recipe"):
        torch_fraud_cli.main(args + ["--resume", "--head_lr", "1e-3"])


def test_fraud_cli_resume_is_exact(tmp_path, fraud_corpus, monkeypatch):
    """With dropout and a head rate of its own: a run that dies at its second
    dev evaluation (after epoch 0 was checkpointed) and is continued with
    ``--resume`` writes the uninterrupted run's best parameters bit for bit,
    its test metrics and its epoch metrics, and removes ``loop_state/``."""
    data = _copy_corpus(fraud_corpus, tmp_path / "classification_data")
    args = ["--data_path", data, "--device", "cpu", "--head_lr", "1e-3",
            "--learning_rate", "1e-3", "--warmup_steps", "2", "--seed", "3"] + COMMON
    ref = torch_fraud_cli.main(args + ["--output_dir", str(tmp_path / "ref")])

    real_eval = torch_fraud_cli.evaluate_fraud
    calls = {"n": 0}

    def failing_eval(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("simulated preemption")
        return real_eval(*a, **kw)

    out = tmp_path / "out"
    monkeypatch.setattr(torch_fraud_cli, "evaluate_fraud", failing_eval)
    with pytest.raises(RuntimeError):
        torch_fraud_cli.main(args + ["--output_dir", str(out)])
    loop_dir = out / "classification_data" / "loop_state"
    assert sorted(os.listdir(loop_dir)) in (["best_params.pt", "loop.json", "state.pt"],
                                            ["loop.json", "state.pt"])
    monkeypatch.setattr(torch_fraud_cli, "evaluate_fraud", real_eval)
    with pytest.raises(SystemExit):
        torch_fraud_cli.main(args + ["--output_dir", str(out)])
    resumed = torch_fraud_cli.main(args + ["--output_dir", str(out), "--resume"])
    assert resumed == ref
    assert not loop_dir.exists()
    a = restore_params(str(out / "classification_data" / "best_model.pt"))
    b = restore_params(str(tmp_path / "ref" / "classification_data" / "best_model.pt"))
    assert set(a) == set(b) and "fc1.weight" in a
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for name in ("epoch_metrics.json", "test_metrics.json"):
        with open(out / "classification_data" / name) as f, \
                open(tmp_path / "ref" / "classification_data" / name) as g:
            assert json.load(f) == json.load(g), name


def test_pos_weight_matches_jax():
    for labels in ([0] * 9 + [1], [0, 1], [0, 0, 0], [1] * 5 + [0] * 95):
        users = {u: [[1, 2], [y]] for u, y in enumerate(labels)}
        assert torch_fraud_cli.calculate_pos_weight(FraudDataset(users, 4)) == \
            jax_fraud_cli.calculate_pos_weight(JaxFraudDataset(users, 4))


# ---------------------------------------------------------------------------
# the transaction pipelines
# ---------------------------------------------------------------------------

def _tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("seed", [11, 4])
def test_transaction_pipelines_match_jax(tmp_path, seed):
    """``synthetic_transactions --scale tiny --build`` in both packages from
    one seed: the same files, the CSVs byte for byte, every JSON artifact
    (pretrain, finetune, classification, classification_single) equal."""
    for stack, mod in (("jax", jax_synth), ("torch", torch_synth)):
        mod.main(["--out", str(tmp_path / stack), "--scale", "tiny", "--seed", str(seed),
                  "--build"])
    files = _tree_files(tmp_path / "jax")
    assert files == _tree_files(tmp_path / "torch")
    assert {"txn_train_raw.csv", "txn_test_raw.csv", "stats.json",
            "artifacts/classification_data/train.json",
            "artifacts/classification_data_single/test.json",
            "artifacts/pretrain_data/dev.json", "artifacts/finetune_data/val.json"} <= set(files)
    for rel in files:
        with open(tmp_path / "jax" / rel, "rb") as f, open(tmp_path / "torch" / rel, "rb") as g:
            a, b = f.read(), g.read()
        if rel.endswith(".csv"):
            assert a == b, rel
        else:
            assert json.loads(a) == json.loads(b), rel
