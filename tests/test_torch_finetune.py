"""The port's seq-rec finetune path against the JAX package's, on the CPU:
target sampling and the prefix batch given the JAX draws (exact), the full
and sampled softmax losses (1e-6), the finetune loss and every parameter
gradient with weights carried by ``from_flax_params`` (1e-4), two
accumulated micro-steps and their AdamW update against optax (1e-6), the
two-stage loop's exact resume, and ``cli.finetune`` against
``recformer_tpu.cli.finetune`` at zero learning rate (1e-5). fp32,
``tiny()`` sizes, inputs from seeded numpy generators."""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from recformer_tpu.cli import finetune as jax_finetune_cli
from recformer_tpu.config import RecformerConfig as JaxConfig
from recformer_tpu.data import device_pipeline as jdp
from recformer_tpu.models.heads import RecformerForSeqRec as JaxSeqRec
from recformer_tpu.training import losses as jlosses
from recformer_tpu.training.optimizer import create_optimizer as jax_create_optimizer
from recformer_tpu_torch.cli import finetune as torch_finetune_cli
from recformer_tpu_torch.config import RecformerConfig
from recformer_tpu_torch.data import device_pipeline as tdp
from recformer_tpu_torch.data.datasets import EvalDataset, SequenceDataset
from recformer_tpu_torch.models.heads import RecformerForSeqRec
from recformer_tpu_torch.models.recformer import init_weights
from recformer_tpu_torch.training import losses as tlosses
from recformer_tpu_torch.training.checkpoint import restore_train_state, save_train_state
from recformer_tpu_torch.training.loops import finetune_two_stage
from recformer_tpu_torch.training.optimizer import create_optimizer
from recformer_tpu_torch.training.steps import finetune_loss, make_finetune_step
from recformer_tpu_torch.weights import from_flax_params, torch_name_to_flax_path

GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
TIGHT = dict(rtol=1e-6, atol=1e-6)


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


# ---------------------------------------------------------------------------
# batches and losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_finetune_batch_matches_jax_given_its_draws(seed):
    """Targets uniform over the whole sequence (position 0, an empty history,
    included), labels and the prefix batch, with rows of length 1."""
    jcfg, tcfg = configs()
    table_np = synthetic_table(jcfg, 30, seed)
    rng = np.random.default_rng(seed)
    B, S = 64, 10
    item_ids = rng.integers(0, 30, size=(B, S)).astype(np.int32)
    seq_lens = rng.integers(1, S + 1, size=B).astype(np.int32)
    seq_lens[:3] = 1
    key = jax.random.PRNGKey(seed)
    table_j = {k: jnp.asarray(v) for k, v in table_np.items()}
    batch_j, labels_j = jdp.make_finetune_batch(key, table_j, jnp.asarray(item_ids),
                                                jnp.asarray(seq_lens), jcfg)
    u = jax.random.uniform(key, seq_lens.shape)
    target = tdp.finetune_targets_from_draws(torch.from_numpy(np.asarray(u)),
                                             torch.from_numpy(seq_lens))
    np.testing.assert_array_equal(
        target.numpy(), np.asarray(jdp.sample_finetune_targets(key, jnp.asarray(seq_lens))))
    assert (target.numpy()[seq_lens > 1] == 0).any()  # an empty history on a longer row
    batch_t, labels_t = tdp.finetune_batch_from_targets(
        to_torch(table_np), torch.from_numpy(item_ids), target, tcfg)
    np.testing.assert_array_equal(labels_t.numpy(), np.asarray(labels_j))
    assert set(batch_t) == set(batch_j)
    for k in batch_j:
        np.testing.assert_array_equal(batch_t[k].numpy(), np.asarray(batch_j[k]), err_msg=k)
    # the sampling form draws from a generator into the same function
    gen = torch.Generator().manual_seed(seed)
    b, lab = tdp.make_finetune_batch(gen, to_torch(table_np), torch.from_numpy(item_ids),
                                     torch.from_numpy(seq_lens), tcfg)
    t2 = tdp.finetune_targets_from_draws(torch.rand(B, generator=torch.Generator().manual_seed(
        seed)), torch.from_numpy(seq_lens))
    np.testing.assert_array_equal(lab.numpy(), item_ids[np.arange(B), t2.numpy()])


def _loss_inputs(seed, n_items=12, B=5, H=16):
    rng = np.random.default_rng(seed)
    pooled = rng.standard_normal((B, H)).astype(np.float32)
    emb = rng.standard_normal((n_items, H)).astype(np.float32)
    labels = rng.integers(0, n_items, size=B).astype(np.int32)
    return pooled, emb, labels


@pytest.mark.parametrize("seed", [0, 1])
def test_seqrec_losses_and_pooled_grads_match_jax(seed):
    """Both forms and their gradient with respect to ``pooled``; the sampled
    form with JAX's negatives, 20 over a 12-item catalog, so collisions with
    the label are certain."""
    pooled, emb, labels = _loss_inputs(seed)
    n = 20
    key = jax.random.PRNGKey(seed)
    negatives = jax.random.randint(key, (labels.shape[0], n), 0, emb.shape[0])
    assert (np.asarray(negatives) == labels[:, None]).any()
    full_j = jax.value_and_grad(lambda p: jlosses.seqrec_full_softmax_loss(
        p, jnp.asarray(emb), jnp.asarray(labels), 0.05))(jnp.asarray(pooled))
    samp_j = jax.value_and_grad(lambda p: jlosses.seqrec_sampled_softmax_loss(
        p, jnp.asarray(emb), jnp.asarray(labels), 0.05, n, key))(jnp.asarray(pooled))
    for (loss_j, grad_j), fn in ((full_j, lambda p: tlosses.seqrec_full_softmax_loss(
            p, torch.from_numpy(emb), torch.from_numpy(labels), 0.05)),
            (samp_j, lambda p: tlosses.seqrec_sampled_softmax_loss_from_negatives(
                p, torch.from_numpy(emb), torch.from_numpy(labels), 0.05,
                torch.from_numpy(np.asarray(negatives))))):
        p = torch.from_numpy(pooled).requires_grad_(True)
        loss = fn(p)
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(loss_j), **TIGHT)
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(grad_j), **TIGHT)
    # the drawing form takes its negatives from the generator given
    gen = torch.Generator().manual_seed(3)
    negs = torch.randint(0, emb.shape[0], (labels.shape[0], n),
                         generator=torch.Generator().manual_seed(3))
    a = tlosses.seqrec_sampled_softmax_loss(torch.from_numpy(pooled), torch.from_numpy(emb),
                                            torch.from_numpy(labels), 0.05, n, gen)
    b = tlosses.seqrec_sampled_softmax_loss_from_negatives(
        torch.from_numpy(pooled), torch.from_numpy(emb), torch.from_numpy(labels), 0.05, negs)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the finetune loss, its gradients and the update
# ---------------------------------------------------------------------------

def _jax_world(jcfg, seed, B=4, S=10, n_items=30):
    table = {k: jnp.asarray(v) for k, v in synthetic_table(jcfg, n_items, seed).items()}
    rng = np.random.default_rng(seed)
    item_ids = rng.integers(0, n_items, size=(B, S)).astype(np.int32)
    seq_lens = rng.integers(1, S + 1, size=B).astype(np.int32)
    seq_lens[0] = S
    emb = rng.standard_normal((n_items, jcfg.hidden_size)).astype(np.float32)
    return table, item_ids, seq_lens, emb


def _jax_loss_fn(jmodel, jcfg, batch, labels, emb, rng_neg):
    """The JAX finetune step's ``loss_fn`` (``training/steps.py``) with a
    deterministic forward."""

    def loss_fn(params):
        pooled = jmodel.apply(params, batch, deterministic=True)
        if jcfg.finetune_negative_sample_size > 0:
            return jlosses.seqrec_sampled_softmax_loss(
                pooled, emb, labels, jcfg.temp, jcfg.finetune_negative_sample_size, rng_neg)
        return jlosses.seqrec_full_softmax_loss(pooled, emb, labels, jcfg.temp)

    return loss_fn


def _port_loss(tcfg, model, batch, labels, emb, negatives):
    pooled = model(to_torch(batch))
    if tcfg.finetune_negative_sample_size > 0:
        return tlosses.seqrec_sampled_softmax_loss_from_negatives(
            pooled, torch.from_numpy(emb), torch.from_numpy(np.asarray(labels)), tcfg.temp,
            torch.from_numpy(np.asarray(negatives)))
    return finetune_loss(tcfg, pooled, torch.from_numpy(emb),
                         torch.from_numpy(np.asarray(labels)), None)


def _jax_batch(jcfg, table, item_ids, seq_lens, emb, key):
    rng_target, rng_neg = jax.random.split(key)
    batch, labels = jdp.make_finetune_batch(rng_target, table, jnp.asarray(item_ids),
                                            jnp.asarray(seq_lens), jcfg)
    negatives = jax.random.randint(rng_neg, (item_ids.shape[0],
                                             jcfg.finetune_negative_sample_size), 0,
                                   emb.shape[0])
    return batch, labels, rng_neg, negatives


@pytest.mark.parametrize("impl", ["pallas", "chunked"])
@pytest.mark.parametrize("negatives", [0, 40], ids=["full", "sampled"])
def test_finetune_loss_and_grads_match_jax(impl, negatives):
    """One deterministic finetune loss through both stacks from one set of
    weights and one JAX-built batch: the port through the band core's
    autograd function (its plain backward on the CPU) or the chunked twin,
    JAX through its chunked attention. Every parameter's gradient within
    1e-4."""
    jcfg, tcfg = configs(initializer_range=0.1, finetune_negative_sample_size=negatives)
    tcfg = tcfg.replace(attention_impl=impl)
    table, item_ids, seq_lens, emb = _jax_world(jcfg, 3)
    batch, labels, rng_neg, negs = _jax_batch(jcfg, table, item_ids, seq_lens, emb,
                                              jax.random.PRNGKey(4))
    jmodel = JaxSeqRec(jcfg)
    params = jmodel.init(jax.random.PRNGKey(5), batch)
    loss_j, grads_j = jax.value_and_grad(_jax_loss_fn(jmodel, jcfg, batch, labels,
                                                      jnp.asarray(emb), rng_neg))(params)
    model = RecformerForSeqRec(tcfg)
    model.load_state_dict(from_flax_params(jax.tree.map(np.asarray, params)), strict=True)
    loss_t = _port_loss(tcfg, model, batch, labels, emb, negs)
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-5)
    flat = {tuple(getattr(k, "key", k) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(grads_j["params"])}
    n = 0
    for name, p in model.named_parameters():
        path, transpose = torch_name_to_flax_path(name)
        got = p.grad.numpy()
        np.testing.assert_allclose(got.T if transpose else got, np.asarray(flat[path]),
                                   err_msg=name, **GRAD_TOL)
        n += 1
    assert n == len(flat)


def test_two_accumulated_micro_steps_match_optax():
    """Accumulation k = 2: two micro-steps on two JAX-built batches (full
    softmax, deterministic forward), then the AdamW update with warmup done,
    weight decay and the clip; the port's gradients through its optimizer
    against JAX's through the JAX package's ``create_optimizer`` chain.
    Every parameter after the update within 1e-6. Both take Adam's eps at
    1e-3: at the default 1e-8 the first update is about ``lr * sign(g)``,
    so on an element whose gradient is zero up to rounding (the key biases:
    softmax is shift-invariant) a rounding-level difference between the
    stacks' gradients becomes a step of order ``lr``; at 1e-3 the update is
    smooth in the gradient."""
    jcfg, tcfg = configs(initializer_range=0.1)
    tcfg = tcfg.replace(attention_impl="pallas")
    table, item_ids, seq_lens, emb = _jax_world(jcfg, 6)
    jmodel = JaxSeqRec(jcfg)
    kw = dict(learning_rate=1e-3, weight_decay=0.1, warmup_steps=0, total_steps=10,
              grad_clip=1.0, grad_accum_steps=2, eps=1e-3)
    batches = [_jax_batch(jcfg, table, item_ids, seq_lens, emb, jax.random.PRNGKey(10 + i))
               for i in range(2)]
    params = jmodel.init(jax.random.PRNGKey(7), batches[0][0])
    model = RecformerForSeqRec(tcfg)
    model.load_state_dict(from_flax_params(jax.tree.map(np.asarray, params)), strict=True)
    tx = jax_create_optimizer(**kw)
    opt_state = tx.init(params)
    opt = create_optimizer(model, **kw)
    taken = []
    for batch, labels, rng_neg, negs in batches:
        grads = jax.grad(_jax_loss_fn(jmodel, jcfg, batch, labels, jnp.asarray(emb),
                                      rng_neg))(params)
        upd, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, upd)
        _port_loss(tcfg, model, batch, labels, emb, negs).backward()
        taken.append(opt.step())
    assert taken == [False, True] and opt.micro_steps == 2 and opt.updates == 1
    theirs = from_flax_params(jax.tree.map(np.asarray, params))
    assert len(theirs) == len(list(model.parameters()))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), theirs[name].numpy(), err_msg=name,
                                   **TIGHT)


# ---------------------------------------------------------------------------
# exact resume
# ---------------------------------------------------------------------------

def _port_world(cfg, n_items=20, n_users=20, seed=0):
    table = {k: torch.from_numpy(v) for k, v in synthetic_table(cfg, n_items, seed).items()}
    rng = np.random.default_rng(seed)
    train = {u: [int(x) for x in rng.integers(0, n_items, size=rng.integers(3, 9))]
             for u in range(n_users)}
    val = {u: [int(rng.integers(0, n_items))] for u in range(n_users)}
    test = {u: [int(rng.integers(0, n_items))] for u in range(n_users)}
    datasets = (SequenceDataset(train, max_items=10), EvalDataset(train, val, test, "val", 10),
                EvalDataset(train, val, test, "test", 10))
    return table, datasets


def _fresh(cfg, k=3, lr=1e-3):
    model = RecformerForSeqRec(cfg)
    init_weights(model, cfg, torch.Generator().manual_seed(0))
    return model, create_optimizer(model, learning_rate=lr, warmup_steps=2, total_steps=200,
                                   grad_accum_steps=k)


class Interrupt(Exception):
    pass


def _interrupting_log(msg):
    if "[stage2]" in str(msg):
        raise Interrupt  # die mid-stage-2, before that epoch's checkpoint


def test_two_stage_resume_is_exact_and_the_mirror_keeps_every_row(tmp_path):
    """Dropout on, sampled negatives, accumulation 3 (a cycle spans epochs):
    interrupt the loop in stage 2, delete the rolling checkpoint's directory
    (the mirror file must still hold the stage-1 rows), put it back, resume;
    the test metrics, every mirror row and the final parameters equal the
    uninterrupted run's bit for bit."""
    cfg = RecformerConfig.tiny(dtype="float32", finetune_negative_sample_size=7,
                               attention_impl="pallas", initializer_range=0.1)
    table, (train_ds, val_ds, test_ds) = _port_world(cfg)
    kw = dict(num_epochs=2, batch_size=8, eval_batch_size=8, encode_batch_size=8, verbose=1,
              seed=11)

    ref_mirror = str(tmp_path / "ref.jsonl")
    model_ref, opt_ref = _fresh(cfg)
    model_ref, emb_ref, ref = finetune_two_stage(model_ref, opt_ref, table, cfg, train_ds,
                                                 val_ds, test_ds, mirror_path=ref_mirror,
                                                 log=lambda *a: None, **kw)

    rdir, mirror = str(tmp_path / "run" / "loop_state"), str(tmp_path / "durable.jsonl")
    model, opt = _fresh(cfg)
    with pytest.raises(Interrupt):
        finetune_two_stage(model, opt, table, cfg, train_ds, val_ds, test_ds, resume_dir=rdir,
                           mirror_path=mirror, log=_interrupting_log, **kw)
    assert sorted(os.listdir(rdir)) == ["best_emb.npy", "best_params.pt", "frozen_emb.npy",
                                        "loop.json", "state.pt"]
    shutil.copytree(rdir, str(tmp_path / "kept"))
    shutil.rmtree(str(tmp_path / "run"))  # the machine is recycled
    with open(mirror) as f:
        rows = [json.loads(line) for line in f]
    assert [(r["event"], r["stage"], r["epoch"]) for r in rows] == [("dev", 1, 0), ("dev", 1, 1)]
    shutil.copytree(str(tmp_path / "kept"), rdir)

    logs = []
    model, opt = _fresh(cfg)
    model, emb, resumed = finetune_two_stage(model, opt, table, cfg, train_ds, val_ds, test_ds,
                                             resume_dir=rdir, mirror_path=mirror,
                                             log=logs.append, **kw)
    assert any("resumed at stage 2 epoch 0" in str(m) for m in logs)
    assert resumed == ref
    assert torch.equal(emb, emb_ref)
    for (n, a), b in zip(model.state_dict().items(), model_ref.state_dict().values()):
        assert torch.equal(a, b), n
    with open(mirror) as f, open(ref_mirror) as g:
        assert [json.loads(x) for x in f] == [json.loads(x) for x in g]


def test_train_state_round_trip_mid_accumulation_cycle(tmp_path):
    """Save after micro-step 3 of an accumulation cycle of 2 (the running
    mean holds one gradient), restore into fresh objects: the next three
    steps' losses and the parameters equal the uninterrupted run's bit for
    bit."""
    cfg = RecformerConfig.tiny(dtype="float32", finetune_negative_sample_size=5,
                               attention_impl="pallas")
    table, (train_ds, _, _) = _port_world(cfg)
    batches = list(train_ds.batches(8, shuffle=True, seed=0)) * 3
    emb = torch.from_numpy(np.random.default_rng(1).standard_normal((20, 64)).astype(np.float32))

    def run(model, opt, bs):
        step = make_finetune_step(cfg, model, opt)
        return [step(5, table, torch.from_numpy(b.item_ids), torch.from_numpy(b.seq_lens),
                     emb)["loss"] for b in bs]

    model_ref, opt_ref = _fresh(cfg, k=2)
    ref = run(model_ref, opt_ref, batches[:6])
    model, opt = _fresh(cfg, k=2)
    run(model, opt, batches[:3])
    assert opt.mini_step == 1 and opt.updates == 1
    path = str(tmp_path / "state.pt")
    save_train_state(path, model, opt, epoch=3)
    model2, opt2 = _fresh(cfg, k=2)
    assert restore_train_state(path, model2, opt2) == {"epoch": 3}
    assert (opt2.micro_steps, opt2.mini_step, opt2.updates) == (3, 1, 1)
    out = run(model2, opt2, batches[3:6])
    for a, b in zip(out, ref[3:]):
        assert torch.equal(a, b)
    for (n, a), b in zip(model2.state_dict().items(), model_ref.state_dict().values()):
        assert torch.equal(a, b), n


# ---------------------------------------------------------------------------
# the CLI against the JAX CLI
# ---------------------------------------------------------------------------

N_ITEMS, N_USERS = 25, 20


def write_corpus(root):
    """The tests/test_cli.py corpus: 25 items, 20 users, train/val/test."""
    rng = np.random.default_rng(0)
    words = ["red", "blue", "bolt", "nut", "gear", "led", "cap", "fan"]
    meta = {f"I{i:03d}": {"make": words[i % len(words)], "hue": words[(i * 3 + 1) % len(words)]}
            for i in range(N_ITEMS)}
    smap = {f"I{i:03d}": i for i in range(N_ITEMS)}
    train, val, test = {}, {}, {}
    for u in range(N_USERS):
        seq = list(rng.integers(0, N_ITEMS, size=rng.integers(4, 9)))
        train[u] = [int(x) for x in seq[:-2]]
        val[u] = [int(seq[-2])]
        test[u] = [int(seq[-1])]
    os.makedirs(root, exist_ok=True)
    for name, obj in (("train", train), ("val", val), ("test", test), ("meta_data", meta),
                      ("smap", smap)):
        with open(os.path.join(root, f"{name}.json"), "w") as f:
            json.dump(obj, f)
    return str(root)


COMMON = ["--model_size", "tiny", "--num_train_epochs", "2", "--batch_size", "8",
          "--eval_batch_size", "8", "--encode_batch_size", "8", "--verbose", "1",
          "--gradient_accumulation_steps", "2", "--finetune_negative_sample_size", "5"]


@pytest.fixture(scope="module")
def zero_lr_runs(tmp_path_factory):
    """Both CLIs at learning rate 0 from one checkpoint (a wide initializer:
    at 0.02 every catalog cosine is within 1e-5 of 1), in float32 (each
    CLI's ``build_config`` wrapped). The port runs the attention kernel's
    wrapper (its plain version on the CPU), JAX its chunked attention.
    Returns {stack: (mirror rows, test metrics)}."""
    root = tmp_path_factory.mktemp("zero_lr")
    cfg = RecformerConfig.tiny(initializer_range=0.5)
    model = RecformerForSeqRec(cfg)
    init_weights(model, cfg, torch.Generator().manual_seed(7))
    ckpt = str(root / "M.bin")
    torch.save(model.state_dict(), ckpt)
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for stack, cli, impl in (("jax", jax_finetune_cli, "chunked"),
                                 ("torch", torch_finetune_cli, "pallas")):
            build = cli.build_config
            mp.setattr(cli, "build_config", lambda args, item_num=0, _b=build:
                       dataclasses.replace(_b(args, item_num=item_num), dtype="float32"))
            mirror = str(root / f"{stack}.jsonl")
            extra = ["--device", "cpu"] if stack == "torch" else []
            cli.main(["--data_path", write_corpus(root / stack / "data"), "--output_dir",
                      str(root / stack / "out"), "--pretrain_ckpt", ckpt, "--learning_rate",
                      "0", "--attention_impl", impl, "--mirror_file", mirror] + COMMON + extra)
            with open(mirror) as f:
                rows = [json.loads(line) for line in f]
            with open(root / stack / "out" / "data" / "test_metrics.json") as f:
                out[stack] = (rows, json.load(f))
    finally:
        mp.undo()
    return out


def test_finetune_cli_matches_jax_cli_at_zero_learning_rate(zero_lr_runs):
    """At learning rate 0 both models stay at the checkpoint's weights, so
    every dev row and the test metrics agree whatever the batch order and the
    random draws: the schedule (re-encodes, the stage switch, the frozen
    catalog, the test on the selected catalog) is the JAX CLI's. The rows'
    ``loss`` is the training loss, which depends on the draws, and is not
    compared. Within 1e-5."""
    (rows_j, test_j), (rows_t, test_t) = zero_lr_runs["jax"], zero_lr_runs["torch"]
    assert [(r["event"], r.get("stage"), r.get("epoch")) for r in rows_t] == \
        [(r["event"], r.get("stage"), r.get("epoch")) for r in rows_j] == \
        [("dev", 1, 0), ("dev", 1, 1), ("dev", 2, 0), ("dev", 2, 1), ("test", None, None)]
    for rj, rt in zip(rows_j, rows_t):
        metrics = set(rj) - {"event", "stage", "epoch", "loss"}
        assert metrics == set(rt) - {"event", "stage", "epoch", "loss"} and "NDCG@10" in metrics
        for k in metrics:
            assert rt[k] == pytest.approx(rj[k], abs=1e-5), (rj["event"], k)
    assert set(test_t) == set(test_j)
    for k in test_j:
        assert test_t[k] == pytest.approx(test_j[k], abs=1e-5), k
    assert rows_t[-1] == {"event": "test", **test_t}
