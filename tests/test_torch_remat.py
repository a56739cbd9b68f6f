"""Activation recomputation (``config.remat``): every policy is a schedule,
not new math. With dropout on, the gradients under each policy equal the
no-remat step's at the same ``StepRNG`` seed, both generators end where the
no-remat step leaves them, and the band core's forward runs again only
under the policies that do not keep its output; a recompute that redraws
(plain ``torch.utils.checkpoint``) fails that gate. Deterministically, the
remat gradients match ``jax.grad`` of the JAX package's no-remat step, as
the JAX package's own ``test_remat_policy_grads_match_no_remat`` makes the
no-remat step the reference. Tiny config, float32, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recformer_tpu.config import RecformerConfig as JaxConfig
from recformer_tpu.data import device_pipeline as jdp
from recformer_tpu.models.heads import RecformerForPretraining as JaxPretrain
from recformer_tpu.training import losses as jlosses
from recformer_tpu_torch.config import RecformerConfig
from recformer_tpu_torch.data.device_pipeline import (assemble_for_config,
                                                      make_finetune_batch,
                                                      make_pretrain_batch)
from recformer_tpu_torch.models import encoder
from recformer_tpu_torch.models.heads import (RecformerForFraudDetection,
                                              RecformerForPretraining, RecformerForSeqRec)
from recformer_tpu_torch.models.recformer import init_weights
from recformer_tpu_torch.ops import window_attention as wa
from recformer_tpu_torch.training.steps import finetune_loss, fraud_loss, pretrain_loss
from recformer_tpu_torch.utils.rng import StepRNG
from recformer_tpu_torch.weights import from_flax_params, torch_name_to_flax_path

POLICIES = ("full", "save_attention", "dots", "dots_attn")
GATE = 1e-6  # max|err| / max|ref| of each gradient tensor against no remat
JAX_TOL = dict(rtol=1e-4, atol=1e-4)
# the band core's forward runs per layer and pass: once, or again in the
# recomputation when the policy does not keep its output
CORE_RUNS = {None: 1, "full": 2, "save_attention": 1, "dots": 2, "dots_attn": 1}


@pytest.fixture(autouse=True)
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


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


def history(seed, B=3, S=10, n_items=30):
    rng = np.random.default_rng(seed)
    item_ids = rng.integers(0, n_items, size=(B, S)).astype(np.int32)
    seq_lens = rng.integers(2, S + 1, size=B).astype(np.int32)
    seq_lens[0] = S
    return torch.from_numpy(item_ids), torch.from_numpy(seq_lens)


def tiny(**kw):
    return RecformerConfig.tiny(dtype="float32", hidden_act="gelu_tanh",
                                attention_impl="pallas", **kw)


@pytest.fixture
def core_runs(monkeypatch):
    """Counts the band core's plain forward (kernel 1's plain version)."""
    runs = [0]
    plain = wa.window_attention_plain

    def counted(*a, **kw):
        runs[0] += 1
        return plain(*a, **kw)

    monkeypatch.setattr(wa, "window_attention_plain", counted)
    return runs


def pretrain_grads(cfg, seed=7):
    """One pretraining loss with dropout (StepRNG ``seed``) and its
    backward. Returns the gradients, the generator's final state and the
    loss."""
    table = {k: torch.from_numpy(v) for k, v in synthetic_table(cfg, 30).items()}
    item_ids, seq_lens = history(1)
    model = RecformerForPretraining(cfg)
    init_weights(model, cfg, torch.Generator().manual_seed(0))
    rng = StepRNG(seed)
    batch_a, batch_b = make_pretrain_batch(rng.device, table, item_ids, seq_lens, cfg)
    out = model(batch_a, batch_b, deterministic=False, rng=rng)
    loss, _ = pretrain_loss(cfg, out, batch_a, batch_b)
    loss.backward()
    return ({n: p.grad for n, p in model.named_parameters()}, rng.host.get_state(),
            float(loss.detach()))


def worst(grads, ref):
    assert grads.keys() == ref.keys()
    return max(float((grads[n] - ref[n]).abs().max() / ref[n].abs().max().clamp_min(1e-30))
               for n in ref)


@pytest.mark.parametrize("policy,flags", [
    *[(p, {}) for p in POLICIES],
    ("full", {"scan_layers": True}),
    ("full", {"ln_impl": "pallas_bwd", "embed_ln_impl": "pallas"}),
    ("save_attention", {"ln_impl": "pallas_bwd", "embed_ln_impl": "pallas"}),
], ids=[*POLICIES, "full-scan_layers", "full-ln_kernels", "save_attention-ln_kernels"])
def test_remat_pretraining_grads_equal_no_remat_under_dropout(policy, flags, core_runs):
    base = tiny(**flags)
    ref, state_ref, loss_ref = pretrain_grads(base)
    assert core_runs[0] == 4 * CORE_RUNS[None]  # two towers of two layers
    core_runs[0] = 0
    grads, state, loss = pretrain_grads(base.replace(remat=True, remat_policy=policy))
    assert core_runs[0] == 4 * CORE_RUNS[policy]
    assert loss == loss_ref
    assert worst(grads, ref) <= GATE
    assert torch.equal(state, state_ref)


def test_plain_checkpoint_redraws_and_fails_the_gate(monkeypatch):
    """The control: a recomputation that does not replay the generators
    (what ``torch.utils.checkpoint`` alone does with them) draws other masks
    and another kernel seed, so its gradients miss the gate, and it leaves
    the generators past where the no-remat step left them."""
    ref, state_ref, _ = pretrain_grads(tiny())
    monkeypatch.setattr(encoder, "replay", lambda state, fn, *args: fn(*args))
    grads, state, _ = pretrain_grads(tiny(remat=True, remat_policy="full"))
    assert worst(grads, ref) > 1e-2
    assert not torch.equal(state, state_ref)


@pytest.mark.parametrize("task", ["finetune", "fraud"])
def test_remat_finetune_and_fraud_grads_equal_no_remat(task, core_runs):
    def grads(cfg):
        table = {k: torch.from_numpy(v) for k, v in synthetic_table(cfg, 30).items()}
        item_ids, seq_lens = history(2, B=4)
        rng = StepRNG(11)
        if task == "finetune":
            model = RecformerForSeqRec(cfg)
            init_weights(model, cfg, torch.Generator().manual_seed(0))
            batch, labels = make_finetune_batch(rng.device, table, item_ids, seq_lens, cfg)
            catalog = torch.randn(30, cfg.hidden_size, generator=torch.Generator().manual_seed(1))
            loss = finetune_loss(cfg, model(batch, deterministic=False, rng=rng), catalog,
                                 labels, rng.device)
        else:
            model = RecformerForFraudDetection(cfg)
            init_weights(model, cfg, torch.Generator().manual_seed(0))
            batch = assemble_for_config(table, item_ids, seq_lens, cfg)
            labels = torch.tensor([1.0, 0.0, 1.0, 0.0])
            loss = fraud_loss(cfg, model(batch, deterministic=False, rng=rng), labels,
                              torch.ones(4, dtype=torch.bool))
        loss.backward()
        return {n: p.grad for n, p in model.named_parameters()}, rng.host.get_state()

    cfg = tiny(item_num=30, finetune_negative_sample_size=5)
    ref, state_ref = grads(cfg)
    assert core_runs[0] == 2
    core_runs[0] = 0
    got, state = grads(cfg.replace(remat=True, remat_policy="dots_attn"))
    assert core_runs[0] == 2
    assert worst(got, ref) <= GATE
    assert torch.equal(state, state_ref)


@pytest.fixture(scope="module")
def jax_reference():
    """``jax.grad`` of one deterministic pretraining loss of the JAX
    package's no-remat model (chunked attention), its parameters and its
    batch; computed once for every policy."""
    jcfg = JaxConfig.tiny(hidden_act="gelu_tanh", dtype="float32", initializer_range=0.1,
                          attention_impl="chunked")
    table = {k: jnp.asarray(v) for k, v in synthetic_table(jcfg, 30, 3).items()}
    item_ids, seq_lens = history(3)
    batch_a, batch_b = jdp.make_pretrain_batch(jax.random.PRNGKey(4), table,
                                               jnp.asarray(item_ids.numpy()),
                                               jnp.asarray(seq_lens.numpy()), jcfg)
    jmodel = JaxPretrain(jcfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(5), batch_a, batch_b)

    def loss_fn(p):
        out = jmodel.apply(p, batch_a, batch_b, deterministic=True)
        cl, _, _ = jlosses.info_nce_loss(out.z1, out.z2, jcfg.temp)
        return (cl + jcfg.mlm_weight * jlosses.mlm_loss(out.mlm_logits_a, batch_a["mlm_labels"])
                + jcfg.mlm_weight * jlosses.mlm_loss(out.mlm_logits_b, batch_b["mlm_labels"]))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    flat = {tuple(getattr(k, "key", k) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(grads["params"])}
    to_np = {k: np.asarray(v) for k, v in batch_a.items()}, {k: np.asarray(v)
                                                            for k, v in batch_b.items()}
    return jax.tree.map(np.asarray, params), to_np, float(loss), flat


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_grads_match_jax_no_remat(policy, jax_reference):
    params, (batch_a, batch_b), loss_j, grads_j = jax_reference
    cfg = tiny(initializer_range=0.1, remat=True, remat_policy=policy)
    model = RecformerForPretraining(cfg)
    model.load_state_dict(from_flax_params(params), strict=True)
    ta = {k: torch.from_numpy(v) for k, v in batch_a.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch_b.items()}
    loss, _ = pretrain_loss(cfg, model(ta, tb), ta, tb)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), loss_j, rtol=1e-5)
    n = 0
    for name, p in model.named_parameters():
        path, transpose = torch_name_to_flax_path(name)
        got = p.grad.numpy()
        np.testing.assert_allclose(got.T if transpose else got, grads_j[path], err_msg=name,
                                   **JAX_TOL)
        n += 1
    assert n == len(grads_j)


def test_unknown_policy_raises_and_no_grad_checkpoints_nothing(monkeypatch):
    with pytest.raises(ValueError, match="remat_policy"):
        tiny(remat=True, remat_policy="bogus")
    with pytest.raises(ValueError, match="remat_policy"):
        encoder.LayerTape("bogus")
    # encoding and evaluation (no grad) run the plain layer loop
    cfg = tiny(remat=True, remat_policy="save_attention", item_num=30)
    model = RecformerForSeqRec(cfg)
    init_weights(model, cfg, torch.Generator().manual_seed(0))
    table = {k: torch.from_numpy(v) for k, v in synthetic_table(cfg, 30).items()}
    batch = assemble_for_config(table, *history(4), cfg)
    with torch.no_grad():
        want = model(batch)
    monkeypatch.setattr(encoder, "remat_layer", pytest.fail)
    with torch.no_grad():
        assert torch.equal(model(batch), want)
