"""The port's pretraining path against the JAX package's, on the CPU: pair
sampling and whole-word MLM given the JAX draws (exact), the losses (1e-6),
one optimizer update against optax (1e-6), the pretraining loss and every
parameter gradient with weights carried by ``from_flax_params`` (1e-4), the
weights' round trip, and the ``cli.pretrain`` entry point. fp32, ``tiny()``
sizes, inputs from seeded numpy generators."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from recformer_tpu.config import RecformerConfig as JaxConfig
from recformer_tpu.data import device_pipeline as jdp
from recformer_tpu.models.heads import RecformerForPretraining as JaxPretrain
from recformer_tpu.training import losses as jlosses
from recformer_tpu.training.checkpoint import import_torch_state_dict
from recformer_tpu.training.optimizer import create_optimizer as jax_create_optimizer
from recformer_tpu_torch.config import RecformerConfig
from recformer_tpu_torch.data import device_pipeline as tdp
from recformer_tpu_torch.models.heads import RecformerForPretraining
from recformer_tpu_torch.models.recformer import init_weights
from recformer_tpu_torch.training import losses as tlosses
from recformer_tpu_torch.training.optimizer import create_optimizer
from recformer_tpu_torch.training.steps import pretrain_loss
from recformer_tpu_torch.weights import from_flax_params, to_flax_params, torch_name_to_flax_path

GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
TIGHT = dict(rtol=1e-6, atol=1e-6)


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


def history(seed, B=4, S=10, n_items=30):
    rng = np.random.default_rng(seed)
    item_ids = rng.integers(0, n_items, size=(B, S)).astype(np.int32)
    seq_lens = rng.integers(1, S + 1, size=B).astype(np.int32)
    seq_lens[0] = S
    return item_ids, seq_lens


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# batch construction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pretrain_pairs_match_jax_given_its_draws(seed):
    rng = jax.random.PRNGKey(seed)
    seq_lens = np.random.default_rng(seed).integers(1, 40, size=64).astype(np.int32)
    prefix_j, target_j = jdp.sample_pretrain_pairs(rng, jnp.asarray(seq_lens))
    u = jax.random.uniform(rng, seq_lens.shape)
    prefix_t, target_t = tdp.pretrain_pairs_from_draws(torch.from_numpy(np.asarray(u)),
                                                       torch.from_numpy(seq_lens))
    np.testing.assert_array_equal(prefix_t.numpy(), np.asarray(prefix_j))
    np.testing.assert_array_equal(target_t.numpy(), np.asarray(target_j))


@pytest.mark.parametrize("out_len", [32, 256])
@pytest.mark.parametrize("seed", [0, 1])
def test_whole_word_mlm_matches_jax_given_its_draws(seed, out_len):
    jcfg, _ = configs()
    table = {k: jnp.asarray(v) for k, v in synthetic_table(jcfg, 30, seed).items()}
    item_ids, seq_lens = history(seed)
    batch = jdp.assemble_for_config(table, jnp.asarray(item_ids), jnp.asarray(seq_lens), jcfg,
                                    out_len=out_len)
    rng = jax.random.PRNGKey(10 + seed)
    ref = jdp.mlm_for_config(rng, batch, jcfg)
    P = ref["mlm_positions"].shape[1]
    B, L = batch["input_ids"].shape
    rng_prio, rng_corrupt, rng_rand = jax.random.split(rng, 3)
    draws = (jax.random.uniform(rng_prio, (B, L + 1)), jax.random.uniform(rng_corrupt, (B, L)),
             jax.random.randint(rng_rand, (B, L), 0, jcfg.vocab_size))
    out = tdp.whole_word_mlm_from_draws(
        to_torch(batch), *[torch.from_numpy(np.asarray(d)) for d in draws],
        mlm_probability=jcfg.mlm_probability, max_predictions=P,
        mask_token_id=jcfg.mask_token_id, bos_token_id=jcfg.bos_token_id,
        eos_token_id=jcfg.eos_token_id, pad_token_id=jcfg.pad_token_id)
    for k in ("mlm_input_ids", "mlm_positions", "mlm_labels"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]), err_msg=k)
    assert (np.asarray(ref["mlm_labels"]) != tdp.IGNORE_INDEX).any()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_greedy_word_selection_matches_jax_scan(seed):
    """The prefix scan of the port against the JAX package's sequential
    scan, with oversized words that must be skipped while the walk goes on."""
    rng = np.random.default_rng(seed)
    B, N, P = 8, 257, 40
    sizes = rng.integers(0, 6, size=(B, N)).astype(np.int32)
    sizes[:, rng.integers(0, N, 20)] = 25  # larger than most budgets' remainder
    sizes[:, 0] = 0
    budget = rng.integers(1, P + 1, size=B).astype(np.int32)
    prio = rng.random((B, N)).astype(np.float32)
    ref = jax.vmap(jdp._select_words_greedy)(jnp.asarray(prio), jnp.asarray(sizes),
                                             jnp.asarray(budget))
    out = tdp._select_words_greedy(torch.from_numpy(prio), torch.from_numpy(sizes),
                                   torch.from_numpy(budget), P)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref).astype(bool))


# ---------------------------------------------------------------------------
# losses and the optimizer
# ---------------------------------------------------------------------------

def test_info_nce_loss_matches_jax():
    rng = np.random.default_rng(0)
    z1, z2 = (rng.standard_normal((6, 16)).astype(np.float32) for _ in range(2))
    z2[2] = z1[2]  # one confident pair
    ref = jlosses.info_nce_loss(jnp.asarray(z1), jnp.asarray(z2), 0.05)
    out = tlosses.info_nce_loss(torch.from_numpy(z1), torch.from_numpy(z2), 0.05)
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TIGHT)


def test_mlm_loss_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 8, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, size=(3, 8)).astype(np.int32)
    labels[rng.random((3, 8)) < 0.4] = tlosses.IGNORE_INDEX
    ref = jlosses.mlm_loss(jnp.asarray(logits), jnp.asarray(labels))
    out = tlosses.mlm_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TIGHT)
    none = tlosses.mlm_loss(torch.from_numpy(logits), torch.full((3, 8), tlosses.IGNORE_INDEX))
    assert float(none) == 0.0


@pytest.mark.parametrize("head_lr", [None, 3e-3])
def test_optimizer_update_matches_optax(head_lr):
    """Two updates of four micro-steps (accumulation k = 2), warmup, linear
    decay, weight decay with its mask and a global-norm clip that fires,
    against optax."""
    _, tcfg = configs()
    model = RecformerForPretraining(tcfg)
    init_weights(model, tcfg, torch.Generator().manual_seed(0))
    params = to_flax_params(model.state_dict())
    kw = dict(learning_rate=1e-2, weight_decay=0.1, warmup_steps=1, total_steps=4,
              grad_clip=1.0, grad_accum_steps=2, head_lr=head_lr)
    tx = jax_create_optimizer(**kw)
    state = tx.init(params)
    opt = create_optimizer(model, **kw)
    rng = np.random.default_rng(1)
    updates_taken = []
    for _ in range(4):
        grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32) * 0.05,
                             params)
        upd, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, upd)
        tgrads = from_flax_params(grads)
        for name, p in model.named_parameters():
            p.grad = tgrads[name].clone()
        updates_taken.append(opt.step())
    assert updates_taken == [False, True, False, True]
    ours = to_flax_params({k: v.detach() for k, v in model.state_dict().items()})
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ours),
                            jax.tree_util.tree_leaves(params)):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=jax.tree_util.keystr(path),
                                   **TIGHT)


# ---------------------------------------------------------------------------
# the pretraining loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ln_impl,embed_ln_impl", [("xla", "xla"), ("pallas_bwd", "pallas"),
                                                   ("split_bwd", "xla")],
                         ids=["xla", "pallas_bwd-embed_pallas", "split_bwd"])
def test_pretrain_loss_and_grads_match_jax(ln_impl, embed_ln_impl):
    """One deterministic pretraining loss through both stacks: the port with
    the kernel path (the band core's autograd function with its plain
    backward), JAX with its chunked attention; the same weights and the same
    JAX-built batch (pairs and MLM). Both run the same ``ln_impl`` (JAX's
    Pallas LayerNorm backward in interpret mode). The port's
    ``embed_ln_impl='pallas'`` is held to JAX's ``'xla'``: JAX's model cannot
    run its embedding kernel on the CPU, and in fp32 the two sums are the
    same float32 additions."""
    jcfg, tcfg = configs(initializer_range=0.1, ln_impl=ln_impl)
    jcfg = jcfg.replace(attention_impl="chunked")
    tcfg = tcfg.replace(attention_impl="pallas", embed_ln_impl=embed_ln_impl)
    table = {k: jnp.asarray(v) for k, v in synthetic_table(jcfg, 30, 3).items()}
    item_ids, seq_lens = history(3, B=3, S=12)
    batch_a, batch_b = jdp.make_pretrain_batch(jax.random.PRNGKey(4), table,
                                               jnp.asarray(item_ids), jnp.asarray(seq_lens),
                                               jcfg)
    jmodel = JaxPretrain(jcfg)
    params = jmodel.init(jax.random.PRNGKey(5), batch_a, batch_b)

    def loss_fn(p):
        out = jmodel.apply(p, batch_a, batch_b, deterministic=True)
        cl, _, _ = jlosses.info_nce_loss(out.z1, out.z2, jcfg.temp)
        return (cl + jcfg.mlm_weight * jlosses.mlm_loss(out.mlm_logits_a, batch_a["mlm_labels"])
                + jcfg.mlm_weight * jlosses.mlm_loss(out.mlm_logits_b, batch_b["mlm_labels"]))

    loss_j, grads_j = jax.value_and_grad(loss_fn)(params)
    model = RecformerForPretraining(tcfg)
    model.load_state_dict(from_flax_params(jax.tree.map(np.asarray, params)), strict=True)
    out = model(to_torch(batch_a), to_torch(batch_b))
    loss_t, metrics = pretrain_loss(tcfg, out, to_torch(batch_a), to_torch(batch_b))
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-5)
    flat = {tuple(getattr(k, "key", k) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(grads_j["params"])}
    n = 0
    for name, p in model.named_parameters():
        path, transpose = torch_name_to_flax_path(name)
        want = np.asarray(flat[path])
        got = p.grad.numpy()
        np.testing.assert_allclose(got.T if transpose else got, want, err_msg=name, **GRAD_TOL)
        n += 1
    assert n == len(flat)


def test_pretraining_weights_round_trip_through_flax():
    """A RecformerForPretraining flax tree (backbone and lm_head) carries
    into the port and back unchanged, and the JAX package's importer takes
    the port's state dict strictly."""
    jcfg, tcfg = configs()
    z = jnp.zeros((1, 32), jnp.int32)
    batch = {k: z for k in ("input_ids", "attention_mask", "global_attention_mask",
                            "token_type_ids", "item_position_ids", "mlm_input_ids")}
    batch["mlm_positions"] = jnp.zeros((1, 8), jnp.int32)
    params = jax.tree.map(np.asarray, JaxPretrain(jcfg).init(jax.random.PRNGKey(0), batch, batch))
    model = RecformerForPretraining(tcfg)
    model.load_state_dict(from_flax_params(params), strict=True)
    back = to_flax_params(model.state_dict())
    theirs = dict(jax.tree_util.tree_leaves_with_path(params["params"]))
    ours = jax.tree_util.tree_leaves_with_path(back)
    assert len(ours) == len(theirs)
    for path, leaf in ours:
        np.testing.assert_array_equal(leaf, theirs[path])
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    _, copied, skipped = import_torch_state_dict(sd, params, strict=True, verbose=False)
    assert skipped == [] and len(copied) == len(sd)


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

def write_corpus(root, n_items=30, n_users=12, seed=0):
    rng = np.random.default_rng(seed)
    words = ["red", "blue", "bolt", "nut", "gear", "led", "cap"]
    meta = {f"I{i}": {"title": " ".join(rng.choice(words, 3)), "brand": str(i)}
            for i in range(n_items)}
    smap = {f"I{i}": i for i in range(n_items)}
    seqs = [[f"I{j}" for j in rng.integers(0, n_items, rng.integers(3, 9))]
            for _ in range(n_users)]
    for name, obj in (("meta_data", meta), ("smap", smap), ("train", seqs), ("dev", seqs[:8])):
        with open(root / f"{name}.json", "w") as f:
            json.dump(obj, f)


def test_cli_pretrain_runs_on_cpu_and_writes_parameters(tmp_path):
    from recformer_tpu_torch.cli import pretrain
    from recformer_tpu_torch.cli.common import maybe_load_pretrained

    write_corpus(tmp_path)
    out_dir = tmp_path / "out"
    res = pretrain.main(["--data_path", str(tmp_path), "--output_dir", str(out_dir),
                         "--model_size", "tiny", "--num_train_epochs", "1",
                         "--batch_size", "4", "--gradient_accumulation_steps", "2",
                         "--warmup_steps", "1", "--valid_step_interval", "2",
                         "--device", "cpu"])
    assert res["steps"] == 3 and res["updates"] == 1
    assert 0.0 <= res["best_dev_accuracy"] <= 1.0
    for name in ("best.pt", "last.pt", "config.json"):
        assert (out_dir / name).exists()
    _, tcfg = configs()
    model = maybe_load_pretrained(RecformerForPretraining(RecformerConfig.tiny()),
                                  str(out_dir / "last.pt"))
    saved = torch.load(out_dir / "last.pt", weights_only=True)
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved[k])


def test_cli_pretrain_takes_ln_impl(tmp_path):
    """``--ln_impl pallas_bwd`` reaches the model: the saved config carries
    it, and the run takes its steps and saves its parameters."""
    from recformer_tpu_torch.cli import pretrain

    write_corpus(tmp_path)
    out_dir = tmp_path / "out"
    res = pretrain.main(["--data_path", str(tmp_path), "--output_dir", str(out_dir),
                         "--model_size", "tiny", "--num_train_epochs", "1",
                         "--batch_size", "4", "--gradient_accumulation_steps", "1",
                         "--warmup_steps", "1", "--ln_impl", "pallas_bwd", "--device", "cpu"])
    assert res["steps"] == 3 and res["updates"] == 3
    assert RecformerConfig.load(str(out_dir / "config.json")).ln_impl == "pallas_bwd"
    assert (out_dir / "last.pt").exists()


def test_cli_pretrain_refuses_missing_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    from recformer_tpu_torch.cli import pretrain

    write_corpus(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        pretrain.main(["--data_path", str(tmp_path), "--model_size", "tiny",
                       "--output_dir", str(tmp_path / "out")])
