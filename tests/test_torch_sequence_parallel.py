"""The port's sequence parallelism against the JAX package, on the CPU: one
world of 4 ``gloo`` ranks (``--device cpu``) fed the JAX weights
(``from_flax_params``) and the JAX batches, against JAX on the 8-device CPU
mesh of ``conftest.py``, at ``tests/test_sequence_parallel.py``'s tiny fp32
shapes and tolerances:

- the op (``parallel/sequence.py``) against ``make_sequence_parallel_attention``
  over 4 shards (seq 4) and 2 (data 2 x seq 2), windows 16 and 32, a padded
  row, the CLS global on shard 0, and a window whose half is a whole shard;
  its gradients against ``jax.grad``;
- the backbone against ``make_sequence_parallel_forward``;
- the data 2 x seq 2 step against ``make_sp_pretrain_step`` at dropout 0,
  one SGD update (rtol 2e-4, atol 2e-5); with ``create_optimizer`` and the
  gradient clipped, two AdamW updates against the one-rank step's, the
  second by a one-rank optimizer restored from the SP one's whole state;
- the dropout streams: deterministic per seed, distinct across shards,
  unbiased (the mean over seeds near the clean output), keep fraction;
- remat (``full``, ``save_attention``) equal to no remat, with dropout on;
- the validation errors, with JAX's messages.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from __graft_entry__ import _synthetic_table
from recformer_tpu.config import RecformerConfig as JaxConfig
from recformer_tpu.data.device_pipeline import assemble_for_config, make_pretrain_batch
from recformer_tpu.models.heads import RecformerForPretraining as JaxPretrain
from recformer_tpu.models.recformer import RecformerModel as JaxModel
from recformer_tpu.ops.attention import dense_attention as jax_dense
from recformer_tpu.parallel.sequence import (make_sequence_parallel_attention,
                                             make_sequence_parallel_forward,
                                             make_sp_pretrain_step)
from recformer_tpu.training.steps import TrainState
from recformer_tpu_torch.config import RecformerConfig
from recformer_tpu_torch.models.heads import RecformerForPretraining
from recformer_tpu_torch.parallel import sequence as tseq
from recformer_tpu_torch.weights import from_flax_params
from torch_parallel_worker import assert_adamw_matches_one_rank, run_world

OP_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-4)
STEP_TOL = dict(rtol=2e-4, atol=2e-5)
ADAMW_CLIP = 0.05
# (shards, window): windows 16 and 32, and one whose half is a whole shard
OP_CASES = {4: (16, 32, 128), 2: (16, 32, 256)}
L_OP = 256
STEP_KW = dict(max_token_num=64, item_seq_len=32, max_item_embeddings=6,
               attention_window=(16, 16), hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0, dtype="float32")


def t(x):
    return torch.from_numpy(np.array(x))


def op_inputs(seed, L=L_OP, B=2, H=2, D=8, n_pad=(0, 37)):
    rng = np.random.default_rng(seed)
    xs = [(rng.standard_normal((B, L, H, D)) * 0.5).astype(np.float32) for _ in range(6)]
    mask = np.ones((B, L), np.int32)
    for b, p in enumerate(n_pad[:B]):
        if p:
            mask[b, L - p:] = 0
    mask[:, 0] = 2  # the CLS global, on shard 0
    return xs, mask


def jax_op(xs, mask, n, window):
    """JAX's op over n shards, its output and the gradients of sum(out^2)
    in q, k, v, k_g, v_g."""
    fn = make_sequence_parallel_attention(Mesh(np.array(jax.devices()[:n]), ("seq",)), window)
    q, k, v, qg, kg, vg = map(jnp.asarray, xs)
    m = jnp.asarray(mask)

    def loss(q, k, v, kg, vg):
        return jnp.sum(fn(q, k, v, qg, kg, vg, m) ** 2)

    grads = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(q, k, v, kg, vg)
    return np.asarray(fn(q, k, v, qg, kg, vg, m)), [np.asarray(g) for g in grads]


def backbone_setup():
    cfg = JaxConfig.tiny(attention_impl="sequence_parallel", hidden_dropout_prob=0.0,
                         attention_probs_dropout_prob=0.0, dtype="float32")
    table = _synthetic_table(cfg, 12)
    rng = np.random.default_rng(1)
    item_ids = jnp.asarray(rng.integers(0, 12, size=(2, 10)).astype(np.int32))
    seq_lens = jnp.asarray(np.array([10, 3], np.int32))
    batch = assemble_for_config(table, item_ids, seq_lens, cfg)
    batch = {k: batch[k] for k in ("input_ids", "attention_mask", "global_attention_mask",
                                   "token_type_ids", "item_position_ids")}
    params = JaxModel(cfg.replace(attention_impl="chunked")).init(jax.random.PRNGKey(0),
                                                                  **batch)
    return cfg, params, batch


def step_setup():
    cfg_ref = JaxConfig.tiny(attention_impl="chunked", **STEP_KW)
    cfg_sp = JaxConfig.tiny(attention_impl="sequence_parallel", global_kv_mode="full",
                            **STEP_KW)
    table = _synthetic_table(cfg_ref, 12)
    rng = np.random.default_rng(0)
    item_ids = jnp.asarray(rng.integers(0, 12, size=(8, 6)).astype(np.int32))
    seq_lens = jnp.asarray(rng.integers(2, 7, size=8).astype(np.int32))
    ba, bb = make_pretrain_batch(jax.random.PRNGKey(0), table, item_ids, seq_lens, cfg_ref)
    params = JaxPretrain(cfg_ref).init(jax.random.PRNGKey(0), ba, bb)
    return cfg_sp, params, table, item_ids, seq_lens


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One world of 4 ranks: the op at 4 and 2 shards, its dropout, the
    backbone at 4 shards and the data 2 x seq 2 step."""
    op = {}
    for n, windows in OP_CASES.items():
        xs, mask = op_inputs(n)
        op[n] = dict(xs=xs, mask=mask, windows=windows)
    dxs, dmask = op_inputs(5, L=128)
    bcfg, bparams, bbatch = backbone_setup()
    scfg, sparams, table, item_ids, seq_lens = step_setup()
    rng_data, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(1), 0))
    ba, bb = make_pretrain_batch(rng_data, table, item_ids, seq_lens, scfg)
    lr = 1e-2
    inputs = {
        "scenarios": {"sp_attention@4": (4, "seq"), "sp_attention@2": (2, "seq"),
                      "sp_dropout": (4, "seq"), "sp_backbone": (4, "seq"),
                      "sp_step": (2, "seq"), "model_axis_remat": (2, "seq"),
                      "model_axis_adamw": (2, "seq")},
        "sp_dropout": dict(inputs=[t(x) for x in dxs], mask=t(dmask), window=16, rate=0.3,
                           seeds=64),
        "sp_backbone": dict(cfg=dict(attention_impl="sequence_parallel", hidden_dropout_prob=0.1,
                                     attention_probs_dropout_prob=0.1, dtype="float32"),
                            state=from_flax_params(jax.tree.map(np.asarray, bparams)),
                            batch={k: t(v) for k, v in bbatch.items()}),
        "sp_step": dict(cfg=dict(STEP_KW, attention_impl="sequence_parallel",
                                 global_kv_mode="full"),
                        state=from_flax_params(jax.tree.map(np.asarray, sparams)),
                        batch_a={k: t(v) for k, v in ba.items()},
                        batch_b={k: t(v) for k, v in bb.items()}, lr=lr),
        "model_axis_remat": dict(kind="sp", cfg=dict(STEP_KW, attention_impl="sequence_parallel",
                                                     global_kv_mode="full",
                                                     hidden_dropout_prob=0.1,
                                                     attention_probs_dropout_prob=0.1),
                                 state=from_flax_params(jax.tree.map(np.asarray, sparams)),
                                 batch_a={k: t(v) for k, v in ba.items()},
                                 batch_b={k: t(v) for k, v in bb.items()}),
        "model_axis_adamw": dict(kind="sp", cfg=dict(STEP_KW, attention_impl="sequence_parallel",
                                                     global_kv_mode="full"),
                                 one_cfg=dict(STEP_KW, attention_impl="chunked",
                                              global_kv_mode="full"),
                                 state=from_flax_params(jax.tree.map(np.asarray, sparams)),
                                 batch_a={k: t(v) for k, v in ba.items()},
                                 batch_b={k: t(v) for k, v in bb.items()}, clip=ADAMW_CLIP),
    }
    for n, d in op.items():
        inputs[f"sp_attention@{n}"] = [dict(inputs=[t(x) for x in d["xs"]], mask=t(d["mask"]),
                                            window=w) for w in d["windows"]]
    ranks = run_world(4, inputs, tmp_path_factory.mktemp("sp_world"))
    return dict(ranks=ranks, op=op, backbone=(bcfg, bparams, bbatch),
                step=(scfg, sparams, table, item_ids, seq_lens, lr),
                dropout=inputs["sp_dropout"])


@pytest.mark.parametrize("n,i", [(n, i) for n in OP_CASES for i in range(3)])
def test_op_matches_jax(world, n, i):
    d = world["op"][n]
    window = d["windows"][i]
    want, grads = jax_op(d["xs"], d["mask"], n, window)
    for r in world["ranks"]:
        got = r[f"sp_attention@{n}"][i]
        np.testing.assert_allclose(got["out"].numpy(), want, **OP_TOL)
        np.testing.assert_array_equal(got["out"][1, -37:].numpy(), 0.0)  # padding rows
        for name, g, w in zip(("q", "k", "v", "k_g", "v_g"), got["grads"], grads):
            np.testing.assert_allclose(g.numpy(), w, err_msg=f"{name} (window {window})",
                                       **GRAD_TOL)


def test_op_matches_the_dense_oracle_on_the_cls_row(world):
    """The CLS row merges per-shard partial softmaxes (pmax, psum)."""
    d = world["op"][4]
    want = np.asarray(jax_dense(*map(jnp.asarray, d["xs"]), jnp.asarray(d["mask"]), 16))
    got = world["ranks"][0]["sp_attention@4"][0]["out"].numpy()
    np.testing.assert_allclose(got[:, 0], want[:, 0], **OP_TOL)
    np.testing.assert_allclose(got, want, **OP_TOL)


def test_dropout_streams(world):
    """Deterministic per seed; another seed draws other masks; each shard
    its own stream; the mean over 64 seeds near the clean output; the
    changed share of the output near the drop rate's effect."""
    got = [r["sp_dropout"] for r in world["ranks"]]
    for g in got:
        assert torch.equal(g["a"], g["b"])
        assert not torch.equal(g["a"], g["c"])
        assert not torch.allclose(g["a"], g["clean"])
        np.testing.assert_allclose(g["mean"].numpy(), g["clean"].numpy(), atol=0.15)
        assert torch.equal(g["a"], got[0]["a"])  # the output is whole on every rank
    assert len({g["seed"] for g in got}) == 4
    # keep fraction: a dropped probability leaves a row's output different;
    # at rate 0.3 over a 17-key band and the CLS column nearly every row is
    mask = world["dropout"]["mask"]
    rows = (mask == 1)
    changed = ((got[0]["a"] - got[0]["clean"]).abs().amax(dim=(2, 3)) > 0)[rows]
    assert changed.float().mean() > 0.95


def test_backbone_matches_jax(world):
    cfg, params, batch = world["backbone"]
    mesh = Mesh(np.array(jax.devices()[:4]), ("seq",))
    hidden, pooled = make_sequence_parallel_forward(JaxModel(cfg), mesh)(params, batch)
    for r in world["ranks"]:
        got = r["sp_backbone"]
        np.testing.assert_allclose(got["hidden"].numpy(), np.asarray(hidden), rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(got["pooled"].numpy(), np.asarray(pooled), rtol=2e-4,
                                   atol=2e-4)
        a, b, c = got["train"]
        assert torch.equal(a, b) and not torch.allclose(a, c)
        assert not torch.allclose(a, got["pooled"])


def test_data2_seq2_step_matches_jax(world):
    cfg, params, table, item_ids, seq_lens, lr = world["step"]
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "seq"))
    model = JaxPretrain(cfg)
    s = TrainState.create(apply_fn=model.apply, params=params, tx=optax.sgd(lr))
    s, m = make_sp_pretrain_step(cfg, model, mesh)(s, jax.random.PRNGKey(1), table, item_ids,
                                                   seq_lens)
    want = from_flax_params(jax.tree.map(np.asarray, s.params))
    ranks = [r["sp_step"] for r in world["ranks"]]
    for r in ranks:
        np.testing.assert_allclose(float(r["loss"]), float(m["loss"]), rtol=2e-5)
        for name, w in want.items():
            np.testing.assert_allclose(r["params"][name].numpy(), w.numpy(), err_msg=name,
                                       **STEP_TOL)
    for name in want:  # every rank holds the same parameters after the update
        assert all(torch.equal(r["params"][name], ranks[0]["params"][name]) for r in ranks)


def test_data2_seq2_adamw_step_matches_one_rank(world):
    """``create_optimizer`` with the gradient clipped: every rank holds every
    parameter whole, so its global norm, update and whole AdamW state are the
    one-rank step's (chunked attention on the whole batch), and a one-rank
    optimizer restored from that state takes the next update as the one-rank
    run does."""
    assert_adamw_matches_one_rank([r["model_axis_adamw"] for r in world["ranks"]], ADAMW_CLIP,
                                  STEP_TOL)


@pytest.mark.parametrize("policy", ["full", "save_attention"])
def test_remat_under_sequence_parallelism_equals_no_remat(world, policy):
    """With dropout on, a recomputed layer runs its halo exchange and
    gathers again and draws what it drew: the gradients equal no remat's,
    and the step's generator ends alike."""
    for r in world["ranks"]:
        ref, got = r["model_axis_remat"]["None"], r["model_axis_remat"][policy]
        assert got["after"] == ref["after"]
        for name, g in ref["grads"].items():
            np.testing.assert_allclose(got["grads"][name].numpy(), g.numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=name)


def test_sp_step_validation():
    """The JAX step's refusals, before any collective."""
    kw = dict(STEP_KW, global_kv_mode="full")
    ok = RecformerConfig.tiny(attention_impl="sequence_parallel", **kw)
    wide = ok.replace(attention_window=(32, 32))

    def mesh(n):
        return types.SimpleNamespace(n_model=n, axis="seq")

    cases = [
        (ok.replace(attention_impl="chunked"), 2, "needs attention_impl='sequence_parallel'"),
        (ok.replace(global_kv_mode="thin"), 2, "set global_kv_mode='full'"),
        (ok, 3, r"max_token_num=64 over 3 seq shards leaves <8 \(window/2\)"),
        (wide, 8, r"max_token_num=64 over 8 seq shards leaves <16 \(window/2\)"),
    ]
    for cfg, n, msg in cases:
        with pytest.raises(ValueError, match=msg):
            tseq.make_sp_pretrain_step(cfg, RecformerForPretraining(cfg), None, mesh(n))
    # the op refuses shards shorter than window/2
    x = torch.zeros(1, 4, 1, 2)
    with pytest.raises(ValueError, match="shard length 4 must be >= window/2=8"):
        tseq.sequence_parallel_attention(x, x, x, x, x, x, torch.ones(1, 4, dtype=torch.int64),
                                         16, group=None)


def test_sp_attention_needs_the_mesh():
    cfg = RecformerConfig.tiny(attention_impl="sequence_parallel", dtype="float32")
    from recformer_tpu_torch.models.recformer import RecformerModel

    model = RecformerModel(cfg)
    ids = torch.full((1, cfg.max_token_num), 5)
    with pytest.raises(ValueError, match="rank's slice of the tokens"):
        model(ids, torch.ones_like(ids), torch.zeros_like(ids), torch.zeros_like(ids),
              torch.zeros_like(ids))


def test_with_attention_impl_shares_the_parameters():
    cfg = RecformerConfig.tiny(attention_impl="sequence_parallel", global_kv_mode="full")
    model = RecformerForPretraining(cfg)
    twin = tseq.with_attention_impl(model, "chunked")
    assert twin.config.attention_impl == "chunked" and twin.config.global_kv_mode == "full"
    mine = dict(model.named_parameters())
    for name, p in twin.named_parameters():
        assert p is mine[name], name
    assert twin.longformer.encoder.layer[0].attention.self.config.attention_impl == "chunked"
