"""The port's data parallelism and row-sharded catalog against the JAX
package, on the CPU: worlds of 2 and 4 ``gloo`` ranks (``--device cpu``)
fed the JAX weights (``from_flax_params``) and the JAX draws, against JAX on
the 8-device CPU mesh of ``conftest.py``. fp32, the JAX tests' tiny shapes
and tolerances (``tests/test_parallel.py``):

- ``parallel/catalog.py`` against ``make_sharded_{rank,topk,full_softmax_
  loss}_fn`` at model sizes 2 and 4 (the loss's gradients too), padding at
  21 rows over 4 against the dense results, and users whose every score is
  negative, where JAX's top-k returns a padding row and the port's does not;
- the ``'full'`` data-parallel step against JAX's mesh step and ``'local'``
  against JAX's ``_local_grad_pretrain_step`` given its per-shard draws
  (one SGD update each, rtol 1e-4, atol 1e-5);
- ZeRO bit-equal to the replicated AdamW update, its moments half the
  size, its whole state equal and restorable;
- the pretraining eval step under data parallelism: each rank forwards its
  rows only, and the values equal the one-rank step's on the global batch;
- the dropout streams under tensor parallelism:
  head groups draw different attention seeds, the step generator stays in
  step and the hidden dropout leaves the group's outputs equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from __graft_entry__ import _synthetic_table
from recformer_tpu.config import RecformerConfig as JaxConfig
from recformer_tpu.data.device_pipeline import make_pretrain_batch
from recformer_tpu.models.heads import RecformerForPretraining as JaxPretrain
from recformer_tpu.models.heads import similarity_scores as jax_scores
from recformer_tpu.parallel.catalog import (make_sharded_full_softmax_loss_fn,
                                            make_sharded_rank_fn, make_sharded_topk_fn)
from recformer_tpu.parallel.mesh import make_mesh, pad_rows_to_multiple
from recformer_tpu.training.losses import seqrec_full_softmax_loss
from recformer_tpu.training.steps import TrainState, make_pretrain_step
from recformer_tpu_torch.ops.window_attention import dropout_keep
from recformer_tpu_torch.parallel import mesh as tmesh
from recformer_tpu_torch.weights import from_flax_params
from torch_parallel_worker import run_world

TEMP = 0.05
K = 5
STEP_TOL = dict(rtol=1e-4, atol=1e-5)
CFG = dict(max_token_num=32, item_seq_len=16, max_item_embeddings=4, attention_window=(8, 8),
           hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0, dtype="float32")


def t(x):
    return torch.from_numpy(np.array(x))


def catalog_case(seed, n, all_negative=False):
    rng = np.random.default_rng(seed)
    B, H = 8, 16
    pooled = rng.standard_normal((B, H)).astype(np.float32)
    emb = rng.standard_normal((n, H)).astype(np.float32)
    if all_negative:  # every user's every score below 0
        pooled = np.abs(pooled) + 0.1
        emb = -np.abs(emb) - 0.1
    labels = rng.integers(0, n, size=B).astype(np.int32)
    return dict(pooled=pooled, emb=emb, labels=labels)


def dense_reference(case):
    pooled, emb, labels = case["pooled"], case["emb"], case["labels"]
    scores = np.asarray(jax_scores(jnp.asarray(pooled), jnp.asarray(emb), TEMP))
    label_scores = scores[np.arange(len(labels)), labels]
    rank = (scores > label_scores[:, None]).sum(1)
    ids = np.argsort(-scores, axis=1, kind="stable")[:, :K]
    loss, (g_pooled, g_emb) = jax.value_and_grad(seqrec_full_softmax_loss, argnums=(0, 1))(
        jnp.asarray(pooled), jnp.asarray(emb), jnp.asarray(labels), TEMP)
    return dict(rank=rank, valid=np.full(len(labels), emb.shape[0]), ids=ids,
                scores=np.take_along_axis(scores, ids, 1), loss=float(loss),
                g_pooled=np.asarray(g_pooled), g_emb=np.asarray(g_emb))


def jax_sharded(case, n_model):
    """The JAX package's sharded functions on a model axis of ``n_model``
    (the catalog padded as its CLIs pad it)."""
    mesh = make_mesh(n_data=1, n_model=n_model, devices=jax.devices()[:n_model])
    padded, _ = pad_rows_to_multiple(case["emb"], n_model)
    emb = jax.device_put(jnp.asarray(padded), NamedSharding(mesh, P("model", None)))
    pooled, labels = jnp.asarray(case["pooled"]), jnp.asarray(case["labels"])
    rank, valid = make_sharded_rank_fn(mesh, TEMP)(pooled, emb, labels)
    scores, ids = make_sharded_topk_fn(mesh, TEMP, K)(pooled, emb)
    loss_fn = jax.jit(make_sharded_full_softmax_loss_fn(mesh, TEMP))
    loss, (g_pooled, g_emb) = jax.value_and_grad(loss_fn, argnums=(0, 1))(pooled, emb, labels)
    return dict(rank=np.asarray(rank), valid=np.asarray(valid), scores=np.asarray(scores),
                ids=np.asarray(ids), loss=float(loss), g_pooled=np.asarray(g_pooled),
                g_emb=np.asarray(g_emb)[:case["emb"].shape[0]])


def check_catalog(got, ref, exact_ids=True):
    np.testing.assert_array_equal(got["rank"].numpy(), ref["rank"])
    np.testing.assert_array_equal(got["valid"].numpy(), ref["valid"])
    if exact_ids:
        np.testing.assert_array_equal(got["ids"].numpy(), ref["ids"])
    np.testing.assert_allclose(got["scores"].numpy(), ref["scores"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(got["loss"]), ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["g_pooled"].numpy(), ref["g_pooled"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got["g_emb"].numpy(), ref["g_emb"], rtol=1e-4, atol=1e-6)


def tcase(case):
    return dict(pooled=t(case["pooled"]), emb=t(case["emb"]), labels=t(case["labels"]),
                temp=TEMP, k=K)


# ---------------------------------------------------------------------------
# JAX side of the pretraining steps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pretrain_setup():
    jcfg = JaxConfig.tiny(**CFG)
    table = _synthetic_table(jcfg, 12)
    rng = np.random.default_rng(0)
    item_ids = jnp.asarray(rng.integers(0, 12, size=(8, 6)).astype(np.int32))
    seq_lens = jnp.asarray(rng.integers(2, 7, size=8).astype(np.int32))
    model = JaxPretrain(jcfg)
    ba, bb = make_pretrain_batch(jax.random.PRNGKey(0), table, item_ids, seq_lens, jcfg)
    params = model.init(jax.random.PRNGKey(0), ba, bb)
    state = {k: v.clone() for k, v in from_flax_params(jax.tree.map(np.asarray, params)).items()}
    return jcfg, model, params, state, table, item_ids, seq_lens


def to_torch_batch(batch):
    return {k: t(v) for k, v in batch.items()}


def jax_step(cfg, model, params, table, item_ids, seq_lens, mesh, lr):
    s = TrainState.create(apply_fn=model.apply, params=params, tx=optax.sgd(lr))
    step = make_pretrain_step(cfg, model, mesh=mesh)
    with mesh:
        s, m = step(s, jax.random.PRNGKey(1), table, item_ids, seq_lens)
    return from_flax_params(jax.tree.map(np.asarray, s.params)), float(m["loss"])


@pytest.fixture(scope="module")
def world2(pretrain_setup, tmp_path_factory):
    """One world of 2 ranks: the catalog at model size 2, the 'full' and
    'local' steps, ZeRO and the dropout streams."""
    jcfg, model, params, state, table, item_ids, seq_lens = pretrain_setup
    lr = 1e-2
    rng_data, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(1), 0))
    ba, bb = make_pretrain_batch(rng_data, table, item_ids, seq_lens, jcfg)
    per_shard = []
    for r in range(2):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(1), 0), r)
        rd, _ = jax.random.split(key)
        rows = slice(4 * r, 4 * r + 4)
        a, b = make_pretrain_batch(rd, table, item_ids[rows], seq_lens[rows], jcfg)
        per_shard.append((to_torch_batch(a), to_torch_batch(b)))
    cases = [catalog_case(0, 32), catalog_case(1, 21, all_negative=True)]
    port_cfg = dict(CFG, attention_impl="pallas")
    seq_state = {k: v for k, v in state.items() if k.startswith("longformer.")}
    ttable = {k: t(v) for k, v in table.items()}
    tp_batch = to_torch_batch({k: v for k, v in ba.items() if not k.startswith("mlm")})
    inputs = dict(
        scenarios={"catalog": 2, "dp_full": 1, "local": 1, "dp_eval": 1, "zero": 1,
                   "dropout_streams": 2},
        catalog=[tcase(c) for c in cases],
        dp_full=dict(cfg=port_cfg, state=state, batch_a=to_torch_batch(ba),
                     batch_b=to_torch_batch(bb), lr=lr),
        local=dict(cfg=dict(port_cfg, contrastive_gradient="local"), state=state,
                   batches=per_shard, lr=lr),
        dp_eval=dict(cfg=port_cfg, state=state, table=ttable, item_ids=t(item_ids),
                     seq_lens=t(seq_lens), seed=3),
        zero=dict(cfg=dict(port_cfg, hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1),
                  state=state, table=ttable, item_ids=t(item_ids), seq_lens=t(seq_lens)),
        dropout_streams=dict(cfg=dict(port_cfg, hidden_dropout_prob=0.1,
                                      attention_probs_dropout_prob=0.1,
                                      attention_head_shard_axis="model"),
                             state=seq_state, batch=tp_batch),
    )
    ranks = run_world(2, inputs, tmp_path_factory.mktemp("world2"))
    return dict(ranks=ranks, cases=cases, lr=lr, port_cfg=port_cfg, state=state,
                dp_eval=inputs["dp_eval"])


def test_sharded_catalog_matches_jax_at_model_size_2(world2):
    case = world2["cases"][0]
    ref = jax_sharded(case, 2)
    for r in world2["ranks"]:
        check_catalog(r["catalog"][0], ref)
    check_catalog(world2["ranks"][0]["catalog"][0], dense_reference(case))


def test_sharded_topk_masks_padding_where_jax_does_not(world2):
    """21 rows over 2 ranks (one padding row, score 0) and users whose real
    scores are all negative: JAX's top-k ranks the padding row first, the
    port's returns only real items and equals the dense top-k."""
    case = world2["cases"][1]
    ref = jax_sharded(case, 2)
    n = case["emb"].shape[0]
    assert (ref["ids"] >= n).any(), "JAX's sharded top-k should return a padding row here"
    got = world2["ranks"][0]["catalog"][1]
    assert (got["ids"].numpy() < n).all()
    check_catalog(got, dense_reference(case))


def test_dp_full_step_matches_jax_mesh_step(world2, pretrain_setup):
    jcfg, model, params, _, table, item_ids, seq_lens = pretrain_setup
    mesh = make_mesh(n_data=2, n_model=1, devices=jax.devices()[:2])
    want, loss = jax_step(jcfg, model, params, table, item_ids, seq_lens, mesh, world2["lr"])
    ranks = [r["dp_full"] for r in world2["ranks"]]
    for r in ranks:
        np.testing.assert_allclose(float(r["loss"]), loss, rtol=1e-5)
        for name, w in want.items():
            np.testing.assert_allclose(r["params"][name].numpy(), w.numpy(), err_msg=name,
                                       **STEP_TOL)
    # the updated parameters are replicated exactly
    for name in want:
        assert torch.equal(ranks[0]["params"][name], ranks[1]["params"][name]), name


def test_local_step_matches_jax_local_step(world2, pretrain_setup):
    jcfg, model, params, _, table, item_ids, seq_lens = pretrain_setup
    mesh = make_mesh(n_data=2, n_model=1, devices=jax.devices()[:2])
    want, loss = jax_step(jcfg.replace(contrastive_gradient="local"), model, params, table,
                          item_ids, seq_lens, mesh, world2["lr"])
    for r in world2["ranks"]:
        got = r["local"]
        assert float(got["cl_total"]) == 8  # the gathered batch
        np.testing.assert_allclose(float(got["loss"]), loss, rtol=1e-5)
        for name, w in want.items():
            np.testing.assert_allclose(got["params"][name].numpy(), w.numpy(), err_msg=name,
                                       **STEP_TOL)


def test_dp_eval_step_shards_rows_and_equals_one_rank(world2):
    """Validation under data parallelism: each rank's forward sees its 4 rows
    of the global 8, and the contrastive counts (over the gathered batch)
    and the loss equal the one-rank eval step's on the whole batch. The
    preemption flag's host group is gloo and reduces CPU tensors."""
    from recformer_tpu_torch.config import RecformerConfig as PortConfig
    from recformer_tpu_torch.models.heads import RecformerForPretraining as PortPretrain
    from recformer_tpu_torch.training.steps import make_pretrain_eval_step

    d = world2["dp_eval"]
    cfg = PortConfig.tiny(**world2["port_cfg"])
    model = PortPretrain(cfg)
    model.load_state_dict(world2["state"], strict=True)
    want = make_pretrain_eval_step(cfg, model)(torch.Generator().manual_seed(d["seed"]),
                                               d["table"], d["item_ids"], d["seq_lens"])
    for r in world2["ranks"]:
        got = r["dp_eval"]
        assert got["rows"] == [4]
        assert float(got["metrics"]["cl_total"]) == float(want["cl_total"]) == 8
        assert float(got["metrics"]["cl_correct"]) == float(want["cl_correct"])
        np.testing.assert_allclose(float(got["metrics"]["val_loss"]), float(want["val_loss"]),
                                   rtol=1e-5)
        assert got["host_backend"] == "gloo" and got["flag"] == 3


def test_zero_is_bit_equal_to_the_replicated_update(world2):
    for r in world2["ranks"]:
        z = r["zero"]
        rep, zero = z["replicated"], z["zero"]
        for name, p in rep["params"].items():
            assert torch.equal(p, zero["params"][name]), name
        # about half the moments on each of 2 ranks (small tensors stay whole)
        assert 0.45 < zero["bytes"] / rep["bytes"] < 0.55, (zero["bytes"], rep["bytes"])
        # the gathered state is the replicated layout, moment for moment
        a, b = rep["state"]["optimizer"]["state"], zero["state"]["optimizer"]["state"]
        assert a.keys() == b.keys()
        for j in a:
            for k in a[j]:
                assert torch.equal(a[j][k], b[j][k]), (j, k)
        # a ZeRO optimizer restored from the replicated state steps alike
        third = z["third"]
        for name, p in third["replicated"].items():
            assert torch.equal(p, third["restored"][name]), name
        # six calls under a mesh, each run eagerly through the steps' graphs
        assert z["eager"] == 6 and z["graphs"] == 0


def test_tensor_parallel_dropout_streams(world2):
    """A tensor-parallel group's head groups draw different attention
    dropout (their seeds, and so the kernel's keep masks at the same local
    (b, h, i, c), differ), while the step's generators stay in step and the
    hidden dropout keeps the group's outputs bit-equal."""
    got = [r["dropout_streams"] for r in world2["ranks"]]
    assert got[0]["seed"] != got[1]["seed"]
    assert got[0]["after"] == got[1]["after"]
    b, h, i, c = (torch.arange(n).view(*s) for n, s in (
        (2, (2, 1, 1, 1)), (2, (1, 2, 1, 1)), (32, (1, 1, 32, 1)), (9, (1, 1, 1, 9))))
    masks = [dropout_keep(g["seed"], 0.1, b, h, i, c) for g in got]
    assert not torch.equal(masks[0], masks[1])
    assert torch.equal(got[0]["pooled"], got[1]["pooled"])


def test_sharded_catalog_at_model_size_4_with_padding(tmp_path):
    """Model size 4: 32 rows against JAX; 21 rows (3 padding rows) and the
    all-negative users against the dense results."""
    cases = [catalog_case(2, 32), catalog_case(3, 21), catalog_case(4, 21, all_negative=True)]
    ranks = run_world(4, dict(scenarios={"catalog": 4}, catalog=[tcase(c) for c in cases]),
                      tmp_path)
    ref = jax_sharded(cases[0], 4)
    for r in ranks:
        check_catalog(r["catalog"][0], ref)
        assert r["catalog"][1]["n_local"] == 6
        for got, case in zip(r["catalog"][1:], cases[1:]):
            assert (got["ids"].numpy() < 21).all()
            check_catalog(got, dense_reference(case))


def test_backend_rule():
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    assert tmesh.choose_backend(cpu, 4, 0) == "gloo"
    assert tmesh.choose_backend(cuda, 2, 1) == "gloo"  # two ranks share the card
    assert tmesh.choose_backend(cuda, 4, 4) == "nccl"
    assert tmesh.choose_backend(cuda, 1, 8) == "nccl"


def test_zero_rule_and_padding_helpers():
    assert tmesh.zero_shardable(torch.zeros(64, 16), 2)
    assert not tmesh.zero_shardable(torch.zeros(63, 32), 2)  # rows not divisible
    assert not tmesh.zero_shardable(torch.zeros(64, 8), 2)  # under 1,024 elements
    x = np.arange(10).reshape(5, 2)
    padded, n = tmesh.pad_rows_to_multiple(x, 4)
    assert padded.shape == (8, 2) and n == 5
    np.testing.assert_array_equal(padded[:5], x)
